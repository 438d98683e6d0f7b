#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fdbm_tpu_torch/ops/csrc`` with nvcc
and drives the port's paths at the full width of two TF-GridNets:

* ``tfgridnet_5l32c100`` (5 blocks, C=32, H=100), inside the fused RNN
  kernels' gate. Serving: each serving kernel against its plain PyTorch
  version at the shapes of the path (the RNN path with its plan and its two
  stages), the backbone against its all-plain
  route, three files through ``fdbm_tpu_torch.infer_single``, one profiled
  request. Training: each training kernel (the summed fold, the stashing
  forward and its backward; the last two with their plans and stages, the
  backward checked for equal bits in two calls) against its plain version
  at the shapes of a step (B=2, 256 frames), one training step's loss and
  gradients against
  the all-plain route, ``fdbm_tpu_torch.train`` on a synthetic dataset
  (train, resume, then serve the ``last`` slot), and the training rate of
  steady steps with one profiled step.
* ``TFGridNet()`` at its class defaults (6 blocks, C=48, H=200; called
  6l48c200 here; no registered name), outside the gate, through the
  generic RNN path and the LSTM kernels of ``ops/lstm.py``. Each LSTM
  kernel against its plain version and beside cuDNN's LSTM (with its plan
  and the time of its forward recurrence alone; the backward with its
  stages and checked for equal bits in two calls), the backbone
  against the all-plain route, a 2-step serve against the plain route, one
  4 s request through ``FDBM.enhance_audio`` (profiled once more), one
  training step against the all-plain route, the training rate of steady
  ``FDBM.train_step`` steps with one profiled step, and one
  ``FDBM.valid_step``.

Launch counts are set to 0 just before each path runs and read just after.
Every phase prints one JSON line; any failure exits non-zero. The last
lines are the card's ``nvidia-smi`` name and power limit, the per-kernel
summary and ``{"ok": true, "device": {...}}``.

fp32 throughout with TF32 off. Tolerances (relative L2): 1e-4 for the RNN
paths, the LSTMs and the attention (long fp32 accumulation chains, summed
in another order than the plain version), 1e-5 for the norm (a few terms
per group), 1e-4 for the backbones and the 2-step serves against the plain
route; 1e-3 norm-relative for each gradient of the training kernels and for
every parameter's gradient of 5l32c100's training step (the JAX package's
model-level gate, tests/test_gridrnn_train.py), 1e-5 for the step's loss.
6l48c200's step is held to the same loss gate; its gradients (where fp32
rounding alone exceeds 1e-3) are held against float64 leaf by leaf and its
LSTM calls one by one against the plain version (``float64_gate``), and its
2-step serve (where it alone exceeds 1e-4) against a float64 network
(``wide_serve_check``); the fp32-vs-fp32 readings are printed beside.

    python3 chip_smoke.py --probe-seeds 4 --probe-out readings.json

reads only the 6l48c200 checks over four seeds, the readings the float64
gate's limits come from, and

    python3 chip_smoke.py --probe-kernels readings.json

only times the six cluster kernels (frame_attention, the LSTM recurrence,
kernel 1's fused recurrence, kernel 5's (the same with its stash), kernel
6's reverse sweep, kernel 9's reverse sweep) with one part of their work
switched off at a time.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
# The card's published peaks (NVIDIA H100 SXM data sheet): fp32 outside the
# tensor cores and HBM3 bandwidth; the kernels run fp32 on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SERVE_REQUESTS = ((2.0, "sde_ei", 30), (3.0, "ode_ei", 5), (4.0, "sde_ei", 30))
_TRAIN_CU = "fdbm_tpu_torch/ops/csrc/gridrnn_train.cu"
_LSTM_CU = "fdbm_tpu_torch/ops/csrc/lstm.cu"
REPLACES = {
    "grid_rnn_seq1_pair": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu", "fdbm_tpu/ops/gridrnn.py:434"),
    "flat_group_norm": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:180"),
    "frame_attention": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:324"),
    "grid_bilstm_fold": (_TRAIN_CU, "fdbm_tpu/ops/gridrnn.py:217"),
    "grid_fold_train_pair": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu",
                             "fdbm_tpu/ops/gridrnn_train.py:217"),
    "grid_fold_train_pair_bwd": (_TRAIN_CU, "fdbm_tpu/ops/gridrnn_train.py:508"),
    "bilstm_fused_forward": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:537"),
    "lstm_core": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:298"),
    "lstm_core_bwd": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:354"),
    "lstm_forward": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:108"),
}
SERVE_KERNELS = ("grid_rnn_seq1_pair", "flat_group_norm", "frame_attention")
TRAIN_KERNELS = ("grid_bilstm_fold", "grid_fold_train_pair", "grid_fold_train_pair_bwd")
# The training operating point of configs/config.yaml: batch 2, 256 frames.
TRAIN_BATCH, TRAIN_FRAMES = 2, 256
TRAIN_STEPS, RESUME_STEPS = 8, 2
RNN_PATHS = 10  # 5 blocks x (intra, inter)
# TFGridNet() at its class defaults, the JAX package's and the reference's.
WIDE = "6l48c200"
WIDE_C, WIDE_H, WIDE_PATHS = 48, 200, 12  # 6 blocks x (intra, inter)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def agreement(pairs):
    """Largest relative L2 and absolute error over (kernel, plain) pairs."""
    return (max(rel_err(g, w) for g, w in pairs),
            max(float((g - w).abs().max()) for g, w in pairs))


def timed_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_kernels(prof):
    """The profiler's device kernels, without the user annotations it also
    records on the device (``Optimizer.step#Adam.step`` spans kernels that
    are counted on their own)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def profile_request(fdbm, noisy: str, phase: str = "profile") -> dict:
    """Device time by kernel for one N=30 sde_ei request (the last serve
    file), from torch.profiler, and the device's idle share of its wall."""
    from torch.profiler import ProfilerActivity, profile

    from fdbm_tpu_torch.infer import BUCKET_FRAMES, bucket_length, pad_to
    from fdbm_tpu_torch.utils.audio import read_wav

    audio = read_wav(noisy)[0][0]
    blen = bucket_length(len(audio), fdbm.cfg.hop_length, BUCKET_FRAMES)
    batch = torch.as_tensor(pad_to(audio / np.abs(audio).max(), blen)[None], device="cuda")
    run = lambda: fdbm.enhance_batch(batch, torch.Generator(device="cuda").manual_seed(SEED),
                                     sampler_type="sde_ei", N=30)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        return {"phase": phase, "wall_ms": wall_ms, "note": "no device time recorded"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    return {"phase": phase, "request": "4 s, sde_ei, N=30, B=1", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3,
                             "share_of_busy": e.self_device_time_total / 1e3 / busy_ms}
                            for e in top]}


def grad_rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """Norm-relative difference, the denominator floored at ``floor``."""
    return float((got - want).norm() / max(float(want.norm()), floor))


def rnn_flops(lines: int, length: int, c: int, hidden: int) -> dict:
    """fp32 operations of the RNN path's products over both directions:
    input projection, recurrence, deconv (forward); the backward has each
    twice (activations and weight gradients)."""
    per = 2 * lines * length * 2
    fwd = per * (4 * c * 4 * hidden + hidden * 4 * hidden + hidden * 4 * c)
    return {"forward": fwd, "backward": 2 * fwd}


# The stages of kernels 5 and 6 by the names of their kernels: those of the
# cluster design and those of the three-stage design it replaced (PRs 6-9),
# so that this script also reads the parent commit's kernels (run from its
# checkout) for a before/after on one card; a stage that launched nothing
# is left out of a row.
TRAIN_FWD_STAGES = {"projection": "window_proj_kernel",
                    "recurrence": ("gridrnn_rec_kernel", "gridrnn_fused_kernel"),
                    "fold": "fold_kernel"}
TRAIN_BWD_STAGES = {"dh": "window_proj_kernel",
                    "sweep": ("gridrnn_rec_bwd_kernel", "train_sweep_kernel"),
                    "dx": ("fold_kernel", "train_dx_kernel"),
                    "wgrad": "wgrad_kernel", "dwd": "train_dwd_kernel",
                    "column_sums": "bias_kernel", "reduce": "reduce_kernel"}


def train_kernel_phase(rand, dev, summary) -> None:
    """Kernels 4-6 at the shapes of one training step: the intra path's
    [S=263, 524 lines] and the inter path's [S=262, 526 lines], C=32,
    H=100. Each is held against its plain version: forward values on the
    crop [3, L-1], gradients under a cotangent supported on the crop."""
    from fdbm_tpu_torch.ops import gridrnn, gridrnn_train

    c, hidden = 32, 100
    q_bins, frames = 257, TRAIN_FRAMES
    shapes = {"intra": (q_bins + 6, TRAIN_BATCH * (frames + 6)),
              "inter": (frames + 6, TRAIN_BATCH * (q_bins + 6))}
    rows = {k: [] for k in TRAIN_KERNELS}
    for path, (s_len, lines) in shapes.items():
        length = s_len - 3
        x = rand(s_len, lines, c, s=0.5)
        w = (rand(2, 4 * c, 4 * hidden, s=0.1), rand(2, hidden, 4 * hidden, s=0.1),
             rand(2, 4 * hidden, s=0.1), rand(2 * hidden, 4 * c, s=0.1))
        cot = torch.zeros(2, s_len, lines, c, device=dev)
        cot[:, 3:length] = rand(2, length - 3, lines, c)
        crop = slice(3, length)
        flops = rnn_flops(lines, length, c, hidden)
        io = 4 * (x.numel() + sum(t.numel() for t in w))  # inputs read once
        n_pos = 2 * lines * length
        stash = 4 * n_pos * 6 * hidden  # gates, h and c written for the backward
        grads = 4 * sum(t.numel() for t in w)

        with torch.no_grad():
            want_f, want_b = gridrnn_train.grid_fold_train_pair_plain(x, *w)
            got = gridrnn.grid_bilstm_fold(x, *w)
            err, abs_err = agreement([(got[crop], (want_f + want_b)[crop])])
            rows["grid_bilstm_fold"].append(dict(
                path=path, shape=[s_len, lines, c], rel_err=err, max_abs_err=abs_err,
                ms=timed_ms(lambda: gridrnn.grid_bilstm_fold(x, *w)),
                plain_ms=timed_ms(lambda: gridrnn_train.grid_fold_train_pair_plain(x, *w), 3),
                bound=bound(flops["forward"], io + 4 * x.numel())))

            outf, outb, st = gridrnn_train.grid_fold_train_pair_fwd(x, *w)
            err, abs_err = agreement([(outf[crop], want_f[crop]), (outb[crop], want_b[crop])])
            stages = kernel_times(lambda: gridrnn_train.grid_fold_train_pair_fwd(x, *w),
                                  TRAIN_FWD_STAGES)
            rows["grid_fold_train_pair"].append(dict(
                path=path, shape=[s_len, lines, c], rel_err=err, max_abs_err=abs_err,
                **train_plans(gridrnn_train, "fwd", lines, c, hidden), stages_ms=stages,
                recurrence_us_per_step=stages["recurrence"] / length * 1e3,
                ms=timed_ms(lambda: gridrnn_train.grid_fold_train_pair_fwd(x, *w)),
                plain_ms=timed_ms(lambda: gridrnn_train.grid_fold_train_pair_plain(x, *w), 3),
                bound=bound(flops["forward"], io + 8 * x.numel() + stash)))
        del want_f, want_b, got

        bwd = lambda: gridrnn_train.grid_fold_train_pair_bwd(x, *w, cot[0], cot[1], stash=st)
        plain_bwd = lambda: gridrnn_train.grid_fold_train_pair_bwd_plain(x, *w, cot[0], cot[1])
        got, again = bwd(), bwd()
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = plain_bwd()
        names = ("dx", "dw_ih", "dw_hh", "dbias", "dwd")
        errs = {n: grad_rel(g, r) for n, g, r in zip(names, got, want)}
        stages = kernel_times(bwd, TRAIN_BWD_STAGES)
        rows["grid_fold_train_pair_bwd"].append(dict(
            path=path, shape=[s_len, lines, c], rel_err=max(errs.values()), grad_rel=errs,
            max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, want)),
            deterministic=deterministic, **train_plans(gridrnn_train, "bwd", lines, c, hidden),
            stages_ms=stages, sweep_us_per_step=stages["sweep"] / length * 1e3,
            ms=timed_ms(bwd), plain_ms=timed_ms(plain_bwd, 3),
            bound=bound(flops["backward"], io + 8 * x.numel() + stash + 4 * x.numel() + grads)))
        del got, want, st
        torch.cuda.empty_cache()

    for name, tol in (("grid_bilstm_fold", 1e-4), ("grid_fold_train_pair", 1e-4),
                      ("grid_fold_train_pair_bwd", 1e-3)):
        for r in rows[name]:
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            emit({"phase": "kernel", "name": name, "tol": tol, **r})
            if not r["rel_err"] < tol:
                fail(f"{name} ({r['path']}) disagrees with its plain version: rel "
                     f"{r['rel_err']} >= {tol}")
            if r.get("deterministic") is False:
                fail(f"{name} ({r['path']}): two calls on the same inputs gave different bits")
        # Per call, the mean of one intra and one inter call (a step makes
        # five of each).
        mean = lambda key: sum(r[key] for r in rows[name]) / len(rows[name])
        summary[name] = dict(
            rel_err=max(r["rel_err"] for r in rows[name]), tol=tol,
            max_abs_err=max(r["max_abs_err"] for r in rows[name]), ms=mean("ms"),
            plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=rows[name][0]["bound_by"], library_ms=None,
            calls="mean of one intra and one inter call of a B=2, 256-frame step")


def train_plans(module, which: str, lines: int, c: int, hidden: int) -> dict:
    """The cluster plan of kernel 5 (``which`` "fwd") or 6 ("bwd") at this
    shape, with the waves its grid takes, and the card's count of clusters
    at once of every plan that fits a block (blocks x lines: count; the H100
    counts of tests/test_torch_cluster_plans.py)."""
    from fdbm_tpu_torch.ops import gridrnn

    if not hasattr(module, "train_sweep_plan"):  # the three-stage design plans nothing
        return {}
    plan = (module.train_fwd_plan if which == "fwd" else module.train_sweep_plan)(lines, c, hidden)
    if which == "fwd":
        tiles, layout = gridrnn.FUSED_LINES, lambda cs, t: gridrnn.fused_layout(c, hidden, cs, t)
    else:
        tiles, layout = module.SWEEP_LINES, lambda cs, t: module.train_sweep_layout(c, hidden,
                                                                                    cs, t)
    counts = {f"{cs}x{t}": module._card_max_clusters(torch.cuda.current_device(), which, c,
                                                     hidden, cs, t)
              for cs in gridrnn.CLUSTERS for t in tiles if layout(cs, t)}
    return {"plan": {**plan._asdict(), "waves": -(-plan.clusters // plan.max_clusters)},
            "max_clusters_by_plan": counts}


def kernel_times(fn, names: dict, calls: int = 3) -> dict:
    """Device time per call of ``fn`` in each of its stages, from
    torch.profiler: ``names`` maps a stage to a substring of its kernels'
    names, or to a tuple of such substrings. A stage's time is the mean over
    the launches the profiler recorded (it may miss one) times its launches
    per call; a stage that launched nothing is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    times = {}
    for stage, subs in names.items():
        subs = (subs,) if isinstance(subs, str) else subs
        hits = [e for e in kernels if any(sub in e.key for sub in subs)]
        launches = sum(e.count for e in hits)
        if launches:
            per_call = max(1, round(launches / calls))
            times[stage] = sum(e.self_device_time_total for e in hits) / 1e3 / launches * per_call
    return times


def recurrence_time(fn, steps: int, calls: int = 3) -> dict:
    """Device time per call of ``fn`` spent in the forward recurrence
    (``lstm_rec_kernel``), and per step of it."""
    ms = kernel_times(fn, {"rec": "lstm_rec_kernel"}, calls)["rec"]
    return {"recurrence_ms": ms, "recurrence_us_per_step": ms / steps * 1e3}


def cudnn_lstm(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor, dev):
    """``torch.nn.LSTM`` (cuDNN) computing what the LSTM kernels compute from
    the JAX packing ``w_ih [dirs, D, 4H]``, ``w_hh [dirs, H, 4H]``,
    ``bias [dirs, 4H]``: the same gate order, ``bias_ih = bias`` and
    ``bias_hh = 0``. The yardstick of the LSTM rows; the port never calls it."""
    dirs, d, n4 = w_ih.shape
    lstm = torch.nn.LSTM(d, n4 // 4, bidirectional=dirs == 2).to(dev)
    with torch.no_grad():
        for z, sfx in enumerate(("", "_reverse")[:dirs]):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih[z].t())
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh[z].t())
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(bias[z])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    return lstm


def lstm_kernel_phase(rand, dev, summary, n_frames: int) -> None:
    """Kernels 7-10 at the shapes of 6l48c200's intra path: the 4 s request
    (B=1, ``n_frames`` frames: n_frames + 6 lines of L=260 windows,
    D=4C=192, H=200) for kernels 7 and 10, a B=2, 256-frame training step
    (524 lines) for kernels 8 and 9. Each is held against its plain version
    and timed beside cuDNN's LSTM on the same inputs."""
    from fdbm_tpu_torch.ops import gridrnn, lstm as lstm_ops

    d, hidden = 4 * WIDE_C, WIDE_H
    length = 257 + 6 - 3
    scale = hidden ** -0.5
    weights = lambda *dirs: (rand(*dirs, d, 4 * hidden, s=scale),
                             rand(*dirs, hidden, 4 * hidden, s=scale),
                             rand(*dirs, 4 * hidden, s=scale))
    # fp32 operations of one direction at one position: projection + recurrence.
    per_pos = 2 * d * 4 * hidden + 2 * hidden * 4 * hidden
    nbytes = lambda *ts: 4 * sum(t.numel() for t in ts)
    rows = {}

    x = rand(length, n_frames + 6, d)
    w2 = weights(2)
    n = x.shape[0] * x.shape[1]
    with torch.no_grad():
        want = lstm_ops.bilstm_fused_forward_plain(x, *w2)
        err, abs_err = agreement(list(zip(lstm_ops.bilstm_fused_forward(x, *w2), want)))
        lib = cudnn_lstm(*w2, dev)
        rows["bilstm_fused_forward"] = dict(
            shape=list(x.shape), rel_err=err, tol=1e-4, max_abs_err=abs_err,
            plan=lstm_ops.recurrence_plan(x.shape[1], 2, hidden)._asdict(),
            ms=timed_ms(lambda: lstm_ops.bilstm_fused_forward(x, *w2)),
            plain_ms=timed_ms(lambda: lstm_ops.bilstm_fused_forward_plain(x, *w2), 3),
            bound=bound(2 * n * per_pos, nbytes(x, *w2) + 4 * 2 * n * hidden),
            library_ms=timed_ms(lambda: lib(x)),
            library_rel_err=rel_err(lib(x)[0], torch.cat(want, dim=-1)),
            **recurrence_time(lambda: lstm_ops.bilstm_fused_forward(x, *w2), length),
            calls="one intra path of a 4 s request (B=1)")
        w1 = tuple(w[0] for w in w2)
        want = gridrnn.lstm_plain(x, *w1)
        err, abs_err = agreement([(lstm_ops.lstm_forward(x, *w1), want)])
        lib = cudnn_lstm(*(w[:1] for w in w2), dev)
        rows["lstm_forward"] = dict(
            shape=list(x.shape), rel_err=err, tol=1e-4, max_abs_err=abs_err,
            plan=lstm_ops.recurrence_plan(x.shape[1], 1, hidden)._asdict(),
            ms=timed_ms(lambda: lstm_ops.lstm_forward(x, *w1)),
            plain_ms=timed_ms(lambda: gridrnn.lstm_plain(x, *w1), 3),
            bound=bound(n * per_pos, nbytes(x, *w1) + 4 * n * hidden),
            library_ms=timed_ms(lambda: lib(x)), library_rel_err=rel_err(lib(x)[0], want),
            **recurrence_time(lambda: lstm_ops.lstm_forward(x, *w1), length),
            calls="one direction of one intra path of a 4 s request (B=1)")
    del x, want, lib

    x = rand(length, TRAIN_BATCH * (TRAIN_FRAMES + 6), d)
    w1 = weights()
    n = x.shape[0] * x.shape[1]
    cot = rand(length, x.shape[1], hidden)
    stash_bytes = 4 * n * 6 * hidden  # gates, h and c
    with torch.no_grad():
        h, stash = lstm_ops.lstm_core_fwd(x, *w1)
        want = gridrnn.lstm_plain(x, *w1)
        err, abs_err = agreement([(h, want)])
    lib = cudnn_lstm(*(w[None] for w in w1), dev)
    xl = x.clone().requires_grad_(True)
    lib_out = lib(xl)[0]
    lib_args = [xl, *lib.parameters()]
    rows["lstm_core"] = dict(
        shape=list(x.shape), rel_err=err, tol=1e-4, max_abs_err=abs_err,
        plan=lstm_ops.recurrence_plan(x.shape[1], 1, hidden, stash=True)._asdict(),
        ms=timed_ms(lambda: lstm_ops.lstm_core_fwd(x, *w1)),
        plain_ms=timed_ms(lambda: gridrnn.lstm_plain(x, *w1), 3),
        bound=bound(n * per_pos, nbytes(x, *w1) + stash_bytes),
        library_ms=timed_ms(lambda: lib(xl)), library_rel_err=rel_err(lib_out.detach(), want),
        **recurrence_time(lambda: lstm_ops.lstm_core_fwd(x, *w1), length),
        calls="one direction of one intra path of a B=2, 256-frame step, with its stash")
    got = lstm_ops.lstm_core_bwd(x, *w1, cot, stash=stash)
    again = lstm_ops.lstm_core_bwd(x, *w1, cot, stash=stash)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = lstm_ops.lstm_core_bwd_plain(x, *w1, cot)
    errs = {nm: grad_rel(g, r) for nm, g, r in zip(("dx", "dw_ih", "dw_hh", "dbias"), got, want)}
    lib_bwd = lambda: torch.autograd.grad(lib_out, lib_args, cot, retain_graph=True)
    lib_dx = lib_bwd()[0]
    bwd = lambda: lstm_ops.lstm_core_bwd(x, *w1, cot, stash=stash)
    # Its three stages: the reverse sweep, dx, and dW_ih / dW_hh / db as one
    # product (its split sums added by reduce_kernel).
    stages = kernel_times(bwd, {"sweep": "lstm_sweep_kernel", "dx": "lstm_dx_kernel",
                                "wgrad": "lstm_wgrad_kernel",
                                "wgrad_reduce": "namespace)::reduce_kernel"})
    wgrad_ms = stages["wgrad"] + stages["wgrad_reduce"]
    wgrad_flops = 2 * n * (d + hidden) * 4 * hidden + n * 4 * hidden
    rows["lstm_core_bwd"] = dict(
        shape=list(x.shape), rel_err=max(errs.values()), grad_rel=errs, tol=1e-3,
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, want)),
        deterministic=deterministic,
        plan=lstm_ops.sweep_plan(x.shape[1], hidden)._asdict(),
        ms=timed_ms(bwd),
        plain_ms=timed_ms(lambda: lstm_ops.lstm_core_bwd_plain(x, *w1, cot), 3),
        bound=bound(2 * n * per_pos, nbytes(x, cot, *w1) + stash_bytes + nbytes(x, *w1)),
        library_ms=timed_ms(lib_bwd), library_rel_err=grad_rel(lib_dx, want[0]),
        stages_ms=stages, sweep_us_per_step=stages["sweep"] / length * 1e3,
        wgrad_ms=wgrad_ms, wgrad_tflops=wgrad_flops / wgrad_ms / 1e9,
        dx_tflops=2 * n * 4 * hidden * d / stages["dx"] / 1e9,
        calls="the backward of one lstm_core call (plain: its forward + autograd)")
    rows["lstm_core_bwd"]["below_library"] = (rows["lstm_core_bwd"]["ms"]
                                              < rows["lstm_core_bwd"]["library_ms"])
    del x, h, stash, got, want, lib, xl, lib_out, lib_args
    torch.cuda.empty_cache()

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        emit({"phase": "kernel", "name": name, **r})
        if not r["rel_err"] < r["tol"]:
            fail(f"{name} disagrees with its plain version: rel {r['rel_err']} >= {r['tol']}")
        if r.get("deterministic") is False:
            fail(f"{name}: two calls on the same inputs gave different bits")
        summary[name] = r


def wide_backbone_phase(rand, dev) -> None:
    """6l48c200 in eval mode, kernels against the all-plain route, at a
    B=2, 256-frame spectrogram; launches of one forward."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    torch.manual_seed(SEED)
    net = TFGridNet().to(dev).eval()
    ref = TFGridNet(use_kernels=False).to(dev).eval()
    ref.load_state_dict(net.state_dict())
    shape = (2, 1, 257, 256)
    xs, ys = (torch.complex(rand(*shape), rand(*shape)) for _ in range(2))
    ts = torch.tensor([0.5, 0.9], device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        out = net(xs, ys, ts)
        torch.cuda.synchronize()
        per_forward = ops.launch_counts()
        err = rel_err(out, ref(xs, ys, ts))
        fwd_ms = timed_ms(lambda: net(xs, ys, ts), 3)
    expected = {"bilstm_fused_forward": WIDE_PATHS, "frame_attention": 6, "flat_group_norm": 0,
                "grid_rnn_seq1_pair": 0}
    emit({"phase": f"backbone_{WIDE}", "shape": list(shape), "rel_err": err, "tol": 1e-4,
          "finite": bool(torch.isfinite(torch.view_as_real(out)).all()),
          "launches_per_forward": per_forward, "expected": expected, "forward_ms": fwd_ms})
    if not err < 1e-4 or any(per_forward[k] != v for k, v in expected.items()):
        fail(f"backbone {WIDE}: rel {err}, launches {per_forward}, expected {expected}")


class Float64Backbone(torch.nn.Module):
    """A backbone run in float64 inside the fp32 sampler. The sampler's own
    arithmetic is the same in every route, so a serve through this differs
    from the fp32 routes' only by their networks' rounding."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net.double()

    def forward(self, x, y, t):
        return self.net(x.to(torch.complex128), y.to(torch.complex128),
                        t.to(torch.float64)).to(x.dtype)


def wide_serve_check(rng, dev, seed: int = SEED):
    """A 2-step sde_ei serve of 6l48c200 (weights and noise from ``seed``,
    1 s of audio from ``rng``) through the kernel route, the plain route,
    the plain route with TF32 on and the plain network in float64. The
    kernel route must be within max(1e-4, F64_K x the plain route's error)
    of the float64 serve, and the TF32 control must miss that. Returns the
    record, whether it passes, and the kernel route's FDBM."""
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    torch.manual_seed(seed)
    fdbm = fdbm_with(TFGridNet, dev)
    plain = fdbm_with(TFGridNet, dev, use_kernels=False)
    plain.dnn.load_state_dict(fdbm.dnn.state_dict())
    f64 = fdbm_with(TFGridNet, dev, use_kernels=False)
    f64.dnn.load_state_dict(fdbm.dnn.state_dict())
    f64.dnn = Float64Backbone(f64.dnn).eval()
    audio = torch.as_tensor(rng.standard_normal((1, 16000)).astype(np.float32) * 0.3, device=dev)
    serve = lambda f: f.enhance_batch(audio, torch.Generator(device=dev).manual_seed(seed),
                                      sampler_type="sde_ei", N=2)
    out_k, out_p, out_64 = serve(fdbm), serve(plain), serve(f64)
    with tf32_on():
        out_tf32 = serve(plain)
    del plain, f64
    errs = {"kernel": rel_err(out_k, out_64), "plain": rel_err(out_p, out_64),
            "plain_tf32": rel_err(out_tf32, out_64)}
    limit = max(1e-4, F64_K * errs["plain"])
    record = {"seed": seed, "sampler": "sde_ei", "N": 2, "samples": audio.shape[-1],
              "rel_err": rel_err(out_k, out_p), "tol": 1e-4,
              "gate_met": rel_err(out_k, out_p) < 1e-4,
              "float64": {"rel_err": errs, "limit": limit}}
    return record, errs["kernel"] <= limit and not errs["plain_tf32"] <= limit, fdbm


def wide_serve_phase(rng, dev, noisy: str) -> dict:
    """6l48c200 serving: a 2-step sde_ei serve against the plain route, then
    the main path, one 4 s sde_ei N=30 request through FDBM.enhance_audio,
    and that request once more under the profiler. Returns the request's
    launches."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.utils.audio import read_wav

    record, ok, fdbm = wide_serve_check(rng, dev)
    emit({"phase": f"serve_check_{WIDE}", **record})
    if not ok:
        fail(f"{WIDE} serve with kernels disagrees with the float64 serve: {record}")
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

    wav, sr = read_wav(noisy)
    y = wav[0]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    enhanced = fdbm.enhance_audio(y, gen(), sampler_type="sde_ei", N=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    seconds = len(y) / sr
    forwards = counts["frame_attention"] // 6
    ok = (enhanced.shape == y.shape and bool(np.isfinite(enhanced).all()) and forwards > 0
          and counts["bilstm_fused_forward"] == WIDE_PATHS * forwards
          and counts["grid_rnn_seq1_pair"] == 0 and counts["flat_group_norm"] == 0)
    emit({"phase": f"serve_{WIDE}", "sampler": "sde_ei", "N": 30, "audio_seconds": seconds,
          "samples": int(enhanced.shape[-1]), "wall_seconds": wall,
          "audio_seconds_per_second": seconds / wall, "launches": counts,
          "finite": bool(np.isfinite(enhanced).all())})
    if not ok:
        fail(f"{WIDE} serve: shape {enhanced.shape}, launches {counts}")
    prof = profile_request(fdbm, noisy, f"profile_{WIDE}")
    emit(prof)
    # The forward recurrence on its own: every path of the request runs
    # S = 260 steps (257 bins + 6 - 3 windows on the intra path, as many
    # frames on the inter path of a 257-frame request).
    rec = [k for k in prof.get("top_kernels", ()) if "lstm_rec_kernel" in k["name"]]
    if not rec:
        fail(f"{WIDE} request: no lstm_rec_kernel in the profile")
    calls, ms = sum(k["calls"] for k in rec), sum(k["ms"] for k in rec)
    steps = 257 + 6 - 3
    emit({"phase": f"recurrence_{WIDE}", "kernels": [k["name"] for k in rec], "calls": calls,
          "ms": ms, "ms_per_call": ms / calls, "steps_per_call": steps,
          "us_per_step": ms / calls / steps * 1e3, "share_of_busy": ms / prof["device_busy_ms"]})
    return counts


def wide_train_phase(rng, dev, smi: str) -> dict:
    """6l48c200 training: one step against the all-plain route, the rate of
    steady steps, and one valid_step. Returns the launches of the main
    path: the steady steps' (kernels 8 and 9) and the validation's
    (kernel 10)."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    per_step = {"lstm_core": 2 * WIDE_PATHS, "lstm_core_bwd": 2 * WIDE_PATHS,
                "grid_fold_train_pair": 0, "grid_fold_train_pair_bwd": 0}
    train_grad_phase(rng, dev, TFGridNet, per_step, f"train_grad_{WIDE}", float64=True)
    fdbm, state, batch, counts = train_rate_phase(rng, dev, smi, TFGridNet, f"train_rate_{WIDE}")
    steps = counts["lstm_core"] // per_step["lstm_core"]
    ops.reset_launch_counts()
    valid_loss = fdbm.valid_step(state, batch, torch.Generator(device=dev).manual_seed(SEED))
    valid = ops.launch_counts()
    emit({"phase": f"valid_{WIDE}", "valid_loss": valid_loss, "launches": valid})
    if any(counts[k] != steps * v for k, v in per_step.items()) or steps < 1:
        fail(f"{WIDE} train steps launched {counts}, expected {per_step} per step")
    if not math.isfinite(valid_loss) or valid["lstm_forward"] != 2 * WIDE_PATHS \
            or valid["lstm_core"] != 0:
        fail(f"{WIDE} valid_step: loss {valid_loss}, launches {valid}")
    return {"lstm_core": counts["lstm_core"], "lstm_core_bwd": counts["lstm_core_bwd"],
            "lstm_forward": valid["lstm_forward"]}


def synthetic_batch(rng, dev):
    """(x, y) audio [2, 255 * 256]: the crops of one training batch."""
    n = (TRAIN_FRAMES - 1) * 256
    x = 0.3 * np.sin(np.arange(n) * 0.05)[None] * rng.uniform(0.5, 1.0, (TRAIN_BATCH, 1))
    y = x + 0.05 * rng.standard_normal((TRAIN_BATCH, n))
    return tuple(torch.as_tensor(a.astype(np.float32), device=dev) for a in (x, y))


def fdbm_with(backbone, dev, **kw):
    """An FDBM of the default config whose backbone is ``backbone(**kw)``."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig

    fdbm = FDBM(FDBMConfig(), device="cuda")
    fdbm.dnn = backbone(**kw).to(dev).eval()
    return fdbm


# 6l48c200's checks against float64 (float64_gate, wide_serve_check). At
# this width fp32 rounding alone moves some gradients by more than 1e-3 and
# the 2-step serve by more than 1e-4 (PERF.md §6), in the plain route as
# much as in the kernel route, so each fp32 route is held against the same
# computation in float64. The serve, and the worst leaf of each group of
# leaves (leaf_group), of the kernel route must be within F64_FLOOR (1e-4
# for the serve), or within F64_K times the plain fp32 route's own error
# there. Leaves of one group share their rounding noise (the attention's
# q/k near-ties of that block and the blocks after it), which one small
# leaf estimates badly: leaf by leaf the kernel route read up to 6.5 times
# the plain route's, by group up to 2.3 times (--probe-seeds readings and
# the smoke run's). The plain route with TF32 on must miss the limits (a
# control), and the LSTM calls are also checked one by one.
RNN_LEAF = (".intra.", ".inter.")
F64_FLOOR, F64_K = 1e-3, 3.0
LSTM_CALL_TOL = {"out": 1e-4, "dx": 1e-3, "dw_ih": 1e-3, "dw_hh": 1e-3, "dbias": 1e-3}


@contextlib.contextmanager
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lstm_call_recorder(net):
    """Forward hooks on every BiLSTM of ``net`` keeping, per call, its input
    windows and output and, in the backward, the cotangent of its output
    and the gradient of its input. Returns ``(records, remove_hooks)``."""
    from fdbm_tpu_torch.models.layers import BiLSTM

    records, handles = [], []

    def hook(name, args, out):
        rec = {"name": name, "x": args[0].detach(), "out": out.detach()}
        args[0].register_hook(lambda g: rec.update(dx=g.detach()))
        out.register_hook(lambda g: rec.update(dout=g.detach()))
        records.append(rec)

    for name, mod in net.named_modules():
        if isinstance(mod, BiLSTM):
            handles.append(mod.register_forward_hook(
                lambda m, args, out, name=name: hook(name, args, out)))
    return records, lambda: [h.remove() for h in handles]


def lstm_call_check(records, net, grads) -> dict:
    """Kernels 8 and 9 on every BiLSTM call of the kernel route's backward,
    held against the plain version on the call's own inputs and cotangent
    (``LSTM_CALL_TOL``, the kernel rows' gates); ``grads`` are the route's
    parameter gradients, each BiLSTM's weights getting theirs from its one
    call. The control: the call's weight gradients without the share of
    one line (the plain backward with that line's cotangent zeroed: lines
    are independent sequences, so this is exactly a reduction that misses
    the line) must miss the gate. Returns the readings and, per call, that
    fault as a change of the weight gradients."""
    from fdbm_tpu_torch.ops.lstm import bilstm_fused_forward_plain

    mods = dict(net.named_modules())
    names = tuple(LSTM_CALL_TOL)
    worst = dict.fromkeys(names, 0.0)
    faults, control = {}, []
    for rec in records:
        mod = mods[rec["name"]]
        w = [p.detach().requires_grad_(True) for p in (mod.w_ih, mod.w_hh, mod.bias)]
        x = rec["x"].clone().requires_grad_(True)
        out = torch.cat(bilstm_fused_forward_plain(x, *w), dim=-1)
        want = torch.autograd.grad(out, [x, *w], rec["dout"], retain_graph=True)
        leaves = [f"{rec['name']}.{p}" for p in ("w_ih", "w_hh", "bias")]
        got = (rec["dx"], *(grads[n] for n in leaves))
        errs = [rel_err(rec["out"], out.detach())] + [grad_rel(g, r) for g, r in zip(got, want)]
        for n, e in zip(names, errs):
            worst[n] = max(worst[n], e)
        dout = rec["dout"].clone()
        dout[:, dout.shape[1] // 4] = 0  # a real line (frame or bin) of batch item 0
        faulty = torch.autograd.grad(out, w, dout)
        control.append(max(grad_rel(f, r) for f, r in zip(faulty, want[1:])))
        faults[rec["name"]] = {n: (f - r).double() for n, f, r in zip(leaves, faulty, want[1:])}
        del out, want, faulty, dout, x
    dropped = {"rel_min": min(control), "rel_max": max(control),
               "flagged": sum(e >= LSTM_CALL_TOL["dw_ih"] for e in control)}
    return {"calls": len(records), "worst": worst, "tol": LSTM_CALL_TOL,
            "ok": len(records) > 0 and all(worst[n] < LSTM_CALL_TOL[n] for n in names),
            "control_dropped_line": dropped}, faults


def leaf_group(name: str) -> str:
    """``blocks.<i>.intra`` / ``.inter`` / ``.attn`` (every other leaf of
    the block), or ``stem`` for the leaves outside the blocks."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "stem"
    return ".".join(parts[:2] + [parts[2] if parts[2] in ("intra", "inter") else "attn"])


def route_vjp(net, x_t, y, t, cot, cdt, rdt) -> dict:
    """The backbone's parameter gradients under the cotangent ``cot``."""
    net.train()
    params = dict((n, p) for n, p in net.named_parameters() if p.requires_grad)
    out = net(x_t.to(cdt), y.to(cdt), t.to(rdt))
    grads = torch.autograd.grad(out, list(params.values()), cot)
    return dict(zip(params, (g.double() for g in grads)))


def float64_gate(kernel, plain, backbone, batch, t, z, dev):
    """The parameter gradients under one cotangent (the plain route's
    dL/dx_hat) through the kernel route (its LSTM calls checked one by one,
    lstm_call_check), the plain route, the plain route with TF32 on and the
    plain route in float64 (``remat`` keeps its memory in bounds), the
    worst leaf of each group (``leaf_group``) of the fp32 routes held
    against float64 within max(F64_FLOOR, F64_K x the plain fp32 route's
    worst leaf in that group). Returns
    the record, whether the kernel route and the checks pass and the
    controls fail, and the per-leaf errors."""
    from fdbm_tpu_torch import losses

    x, y = (plain.audio_to_spec(a) for a in batch[:2])
    _, _, _, x_t = plain._sample_prior(x, y, None, t, z)
    plain.dnn.train()
    x_hat = plain.dnn(x_t, y, t)
    cot = torch.autograd.grad(losses.compute_loss(plain.loss_cfg, x_hat, x), x_hat)[0]
    del x_hat
    fp32 = (torch.complex64, torch.float32)
    records, remove_hooks = lstm_call_recorder(kernel.dnn)
    vjps = {"kernel": route_vjp(kernel.dnn, x_t, y, t, cot, *fp32)}
    remove_hooks()
    calls, faults = lstm_call_check(records, kernel.dnn, vjps["kernel"])
    del records
    torch.cuda.empty_cache()
    vjps["plain"] = route_vjp(plain.dnn, x_t, y, t, cot, *fp32)
    with tf32_on():
        vjps["plain_tf32"] = route_vjp(plain.dnn, x_t, y, t, cot, *fp32)
    net64 = backbone(use_kernels=False, remat=True).to(dev).double()
    net64.load_state_dict(plain.dnn.state_dict())
    g64 = route_vjp(net64, x_t, y, t, cot, torch.complex128, torch.float64)
    del net64
    torch.cuda.empty_cache()

    norm64 = math.sqrt(sum(float((g * g).sum()) for g in g64.values()))
    errors = {r: {n: grad_rel(g[n], g64[n], 1e-4 * norm64) for n in g64}
              for r, g in vjps.items()}
    groups = {}
    for n in g64:
        groups.setdefault(leaf_group(n), []).append(n)
    worst_by_group = lambda e: {grp: max(e[n] for n in names) for grp, names in groups.items()}
    limits = {grp: max(F64_FLOOR, F64_K * v)
              for grp, v in worst_by_group(errors["plain"]).items()}
    routes = {}
    for r, e in errors.items():
        by_group = worst_by_group(e)
        missed = sorted((grp for grp in groups if not by_group[grp] <= limits[grp]),
                        key=lambda grp: -by_group[grp] / limits[grp])
        rnn = [n for n in e if any(s in n for s in RNN_LEAF)]
        routes[r] = {"worst": [(n, e[n]) for n in sorted(e, key=e.get)[-3:][::-1]],
                     "worst_rnn": max(((n, e[n]) for n in rnn), key=lambda a: a[1]),
                     "missed": len(missed),
                     "first_missed": [(grp, by_group[grp], limits[grp]) for grp in missed[:3]]}
    # The dropped line in one call at a time, on the kernel route's groups.
    flagged = 0
    for name, delta in faults.items():
        grp = leaf_group(name)
        worst = max(grad_rel(vjps["kernel"][n] + delta[n], g64[n], 1e-4 * norm64)
                    if n in delta else errors["kernel"][n] for n in groups[grp])
        flagged += not worst <= limits[grp]
    calls["control_dropped_line"]["flagged_by_group_gate"] = flagged
    record = {"float64": {"grad_norm": norm64, "floor": F64_FLOOR, "k": F64_K,
                          "groups": len(groups), "routes": routes},
              "lstm_calls": calls}
    ok = (routes["kernel"]["missed"] == 0 and routes["plain_tf32"]["missed"] > 0
          and calls["ok"] and calls["control_dropped_line"]["flagged"] == calls["calls"])
    return record, ok, errors


def train_grad_phase(rng, dev, backbone, expected: dict, phase: str = "train_grad",
                     float64: bool = False, seed: int = SEED, strict: bool = True) -> dict:
    """One full-width training step, same batch, (t, z) and weights, through
    the kernel route and through the all-plain route; ``expected`` are the
    kernel route's launches. The gate: loss rel < 1e-5 and every leaf's
    gradient within norm-rel 1e-3 of the plain route's. With ``float64``
    the gradient gate is ``float64_gate`` instead (the fp32-vs-fp32
    readings are still printed). ``strict=False`` returns the record
    (with the per-leaf errors) instead of failing."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import TrainState

    torch.manual_seed(seed)
    kernel = fdbm_with(backbone, dev)
    plain = fdbm_with(backbone, dev, use_kernels=False)
    plain.dnn.load_state_dict(kernel.dnn.state_dict())
    cfg = kernel.cfg
    batch = synthetic_batch(rng, dev)
    shape = (TRAIN_BATCH, 1, cfg.n_fft // 2 + 1, TRAIN_FRAMES)
    t = torch.tensor([0.3, 0.8], device=dev)
    z = torch.complex(*(torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                                        / math.sqrt(2), device=dev) for _ in range(2)))
    results = []
    for fdbm in (kernel, plain):
        state = TrainState(fdbm.dnn)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = fdbm.loss_fn(batch, prior=(t, z))
        grads = torch.autograd.grad(loss, list(state.params.values()))
        torch.cuda.synchronize()
        results.append((float(loss.detach()), dict(zip(state.params, grads)),
                        time.perf_counter() - t0, ops.launch_counts()))
    (loss_k, g_k, wall_k, counts), (loss_p, g_p, wall_p, _) = results
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in g_p.values()))
    rels = {n: grad_rel(g_k[n], g_p[n], 1e-4 * gnorm) for n in g_p}
    worst = max(rels, key=rels.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del results, g_k, g_p
    record = {"phase": phase, "seed": seed, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
              "loss": loss_k, "loss_plain": loss_p, "loss_rel": loss_rel, "loss_tol": 1e-5,
              "worst_leaf": worst, "worst_grad_rel": rels[worst], "grad_tol": 1e-3,
              "grad_gate_met": rels[worst] < 1e-3, "leaves": len(rels), "grad_norm": gnorm,
              "seconds_kernel_route": wall_k, "seconds_plain_route": wall_p,
              "launches": counts}
    ok = loss_rel < 1e-5 and rels[worst] < 1e-3
    errors = None
    if float64:
        # At 6l48c200 fp32 rounding alone moves some leaves' gradients by more
        # than 1e-3 of their norm, in the plain route as much as in the
        # kernel route: the attention's q/k norms over E=2 lanes are
        # near-singular where the two lanes tie, those positions carry the
        # q/k leaves' gradients, and every leaf upstream of an attention
        # sees them. float64 tells the two fp32 routes' rounding from error.
        f64, f64_ok, errors = float64_gate(kernel, plain, backbone, batch, t, z, dev)
        record.update(f64)
        ok = loss_rel < 1e-5 and f64_ok
    emit(record)
    if not strict:
        return {**record, "ok": ok, "errors": errors}
    if not ok:
        fail(f"training step: kernel route vs plain route, loss rel {loss_rel}, "
             f"worst gradient {worst} rel {rels[worst]} ({record.get('float64')}, "
             f"{record.get('lstm_calls')})")
    if any(counts[k] != v for k, v in expected.items()):
        fail(f"training step launched {counts}, expected {expected}")
    return record


def train_cli_phase(tmp: str, smi: str) -> dict:
    """fdbm_tpu_torch.train on a synthetic dataset at the config's own
    operating point: train, resume, then serve the last slot's EMA weights.
    Returns the training kernels' launches over train + resume."""
    from fdbm_tpu_torch import infer_single, ops, train
    from fdbm_tpu_torch.utils.audio import read_wav, write_wav

    base = os.path.join(tmp, "data")
    rng = np.random.default_rng(SEED + 7)
    n = 5 * 16000
    for subset, count in (("train", 6), ("valid", 3)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(base, subset, kind))
        for i in range(count):
            clean = 0.3 * np.sin(np.arange(n) * 0.01 * (i + 1)) * rng.uniform(0.3, 1.0)
            noisy = clean + 0.05 * rng.standard_normal(n)
            write_wav(os.path.join(base, subset, "clean", f"{i}.wav"), clean.astype(np.float32),
                      16000)
            write_wav(os.path.join(base, subset, "noisy", f"{i}.wav"), noisy.astype(np.float32),
                      16000)
    root = os.path.dirname(os.path.abspath(__file__))
    args = ["-C", os.path.join(root, "configs", "config.yaml"), f"base_dir={base}",
            f"log_dir={os.path.join(tmp, 'logs')}", "num_eval_files=0",
            f"batch_size={TRAIN_BATCH}", f"num_frames={TRAIN_FRAMES}", "num_workers=2"]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        run = train.main(args + ["--max_steps", str(TRAIN_STEPS)])
        first = ops.launch_counts()
        train.main(args + ["--max_steps", str(TRAIN_STEPS + RESUME_STEPS), "--resume", run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    valid = [r["valid_loss"] for r in records if "valid_loss" in r]
    train_loss = [r["train_loss"] for r in records if "train_loss" in r]
    ckpts = os.path.join(run, "checkpoints")
    last = torch.load(os.path.join(ckpts, "last.pt"), map_location="cpu", weights_only=True)
    steps = TRAIN_STEPS + RESUME_STEPS
    valid_batches = 2 * len(valid)  # 3 valid files at batch 2 per validation
    expected = {"grid_fold_train_pair": RNN_PATHS * steps,
                "grid_fold_train_pair_bwd": RNN_PATHS * steps,
                "grid_bilstm_fold": RNN_PATHS * valid_batches}
    ok = (last["train_state"]["step"] == steps and valid and train_loss
          and all(np.isfinite(valid + train_loss))
          and all(os.path.exists(os.path.join(ckpts, f)) for f in
                  ("last.pt", "best_valid_loss.pt", "meta.json"))
          and all(counts[k] == v for k, v in expected.items())
          and all(counts[k] == 0 for k in SERVE_KERNELS))

    # Serve one file from the run's last slot (its EMA weights).
    noisy = os.path.join(base, "valid", "noisy", "0.wav")
    out_file = os.path.join(tmp, "trained_enhanced.wav")
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        infer_single.main(["-C", os.path.join(root, "configs", "config_infer_single.yaml"),
                           f"ckpt={run}", f"noisy_file={noisy}", f"output_file={out_file}",
                           "N=5", "sampler_type=sde_ei"])
    served, _ = read_wav(out_file)
    serve_counts = ops.launch_counts()
    ok = ok and served.shape == (1, n) and bool(np.isfinite(served).all()) and \
        min(serve_counts[k] for k in SERVE_KERNELS) > 0
    emit({"phase": "train", "steps": steps, "resumed_at": TRAIN_STEPS, "batch": TRAIN_BATCH,
          "frames": TRAIN_FRAMES, "train_files": 6, "valid_files": 3,
          "train_loss": train_loss, "valid_loss": valid,
          "last_step": last["train_state"]["step"],
          "slots": sorted(os.listdir(ckpts)), "wall_seconds": wall,
          "launches": counts, "launches_first_run": first, "expected_launches": expected,
          "served_samples": int(served.shape[-1]), "serve_launches": serve_counts,
          "cli": cli_out.getvalue().strip().splitlines()[-2:], "nvidia_smi": smi})
    if not ok:
        fail(f"train CLI: last step {last['train_state']['step']}, losses {train_loss} "
             f"{valid}, launches "
             f"{counts} (expected {expected}), served {served.shape}")
    return {k: counts[k] for k in TRAIN_KERNELS}


def train_rate_phase(rng, dev, smi: str, backbone, phase: str = "train_rate"):
    """Train audio-s/s over steady steps of the full-width model at B=2 and
    256 frames (8.16 audio-s per step), the step time, peak memory, and the
    device idle share and top kernels of one profiled step. Returns the
    model, its train state, the batch and the launches of the steady
    steps."""
    from torch.profiler import ProfilerActivity, profile

    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import TrainState

    torch.manual_seed(SEED)
    fdbm = fdbm_with(backbone, dev)
    state = TrainState(fdbm.dnn)
    batch = synthetic_batch(rng, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    audio_per_step = TRAIN_BATCH * (TRAIN_FRAMES - 1) * fdbm.cfg.hop_length / fdbm.cfg.sr
    for _ in range(2):
        fdbm.train_step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        fdbm.train_step(state, batch, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fdbm.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    emit({"phase": phase, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "audio_seconds_per_step": audio_per_step, "steps": steps, "step_ms": step_s * 1e3,
          "launches": counts,
          "train_audio_seconds_per_second": audio_per_step / step_s,
          "peak_memory_gb": peak / 1e9, "profiled_step_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share_of_busy": e.self_device_time_total / 1e3 / busy_ms}
                          for e in top] if busy_ms else [], "nvidia_smi": smi})
    if not busy_ms:
        fail(f"{phase}: the profiler recorded no device time")
    return fdbm, state, batch, counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from fdbm_tpu_torch.dsp import num_frames_for_length
    from fdbm_tpu_torch.infer import bucket_length
    from fdbm_tpu_torch import infer_single
    from fdbm_tpu_torch.model import FDBM, FDBMConfig
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100
    from fdbm_tpu_torch.ops import _build, attention as attn_ops, gridrnn
    from fdbm_tpu_torch.utils.audio import read_wav, write_wav

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # -- build ------------------------------------------------------------------
    built = _build.build_all()
    ptxas = [ln.strip() for rep in built["ptxas"].values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_seconds": built["seconds"], "built": built["built"],
          "libraries": built["libraries"], "ptxas": ptxas})

    # -- kernels at the main path's shapes ----------------------------------------
    # The 4 s request of the serve phase: 64-frame bucket, B=1.
    cfg = FDBMConfig()
    n_frames = num_frames_for_length(bucket_length(int(4.0 * cfg.sr), cfg.hop_length),
                                     cfg.n_fft, cfg.hop_length)
    q_bins, c, hidden, n_head, e_dim = cfg.n_fft // 2 + 1, 32, 100, 4, 2
    d_dim = c // n_head
    rng = np.random.default_rng(SEED)
    rand = lambda *shape, s=1.0: torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32) * s, device=dev)
    summary = {}

    s_len, p_len = q_bins + 6, n_frames + 6  # padded canvas, sequence on axis 1
    length = s_len - 3
    x = rand(1, s_len, p_len, c, s=0.5)
    w = (rand(2, 4 * c, 4 * hidden, s=0.1), rand(2, hidden, 4 * hidden, s=0.1),
         rand(2, 4 * hidden, s=0.1), rand(2 * hidden, 4 * c, s=0.1))
    got = gridrnn.grid_rnn_seq1_pair(x, *w)
    want = gridrnn.grid_rnn_seq1_pair_plain(x, *w)
    err, abs_err = agreement([(g[:, 3:length], r[:, 3:length]) for g, r in zip(got, want)])
    lines = p_len
    flops = 2 * lines * length * 2 * (4 * c * 4 * hidden + hidden * 4 * hidden + hidden * 4 * c)
    nbytes = 4 * (3 * x.numel() + sum(t.numel() for t in w))
    # Its two stages: the fused recurrence (projection included) and the fold.
    stages = kernel_times(lambda: gridrnn.grid_rnn_seq1_pair(x, *w),
                          {"recurrence": "gridrnn_fused_kernel", "fold": "fold_kernel"})
    summary["grid_rnn_seq1_pair"] = dict(
        rel_err=err, tol=1e-4, max_abs_err=abs_err, shape=list(x.shape),
        plan=gridrnn.fused_plan(lines, c, hidden)._asdict(), stages_ms=stages,
        recurrence_us_per_step=stages["recurrence"] / length * 1e3,
        ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair(x, *w)),
        plain_ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair_plain(x, *w), 3),
        bound=bound(flops, nbytes), library_ms=None,
        calls="one RNN path (intra or inter) of one block")

    q = rand(1, n_frames, q_bins, n_head * e_dim)
    k = rand(1, n_frames, q_bins, n_head * e_dim)
    v = rand(1, n_frames, q_bins, c)
    norms = tuple((rand(n_head, 1, s=0.3), rand(n_head, wd), rand(n_head, wd))
                  for wd in (e_dim, e_dim, d_dim))
    flat = lambda t: t.reshape(1, n_frames, -1)
    maps = ((flat(q), norms[0], e_dim), (flat(k), norms[1], e_dim), (flat(v), norms[2], d_dim))
    run_norms = lambda fn: [fn(m, *p, width=wd) for m, p, wd in maps]
    err, abs_err = agreement(list(zip(run_norms(attn_ops.flat_group_norm),
                                      run_norms(attn_ops.flat_group_norm_plain))))
    elems = sum(m.numel() for m, _, _ in maps)
    summary["flat_group_norm"] = dict(
        rel_err=err, tol=1e-5, max_abs_err=abs_err,
        shape=[list(m.shape) for m, _, _ in maps],
        ms=timed_ms(lambda: run_norms(attn_ops.flat_group_norm)) / 3,
        plain_ms=timed_ms(lambda: run_norms(attn_ops.flat_group_norm_plain)) / 3,
        bound=bound(10 * elems / 3, 2 * 4 * elems / 3), library_ms=None,
        calls="per call, mean of the q, k and v maps of one block")

    got = attn_ops.frame_attention(q, k, v, n_head, e_dim)
    want = attn_ops.frame_attention_plain(q, k, v, n_head, e_dim)
    scale = 1.0 / math.sqrt(e_dim * q_bins)
    to_heads = lambda t, w_: t.reshape(1, n_frames, q_bins, n_head, w_).permute(
        0, 3, 1, 2, 4).reshape(1, n_head, n_frames, q_bins * w_)
    qh, kh, vh = to_heads(q, e_dim), to_heads(k, e_dim), to_heads(v, d_dim)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    lib_out = sdpa().reshape(1, n_head, n_frames, q_bins, d_dim).permute(
        0, 2, 3, 1, 4).reshape(want.shape)
    t2 = n_head * n_frames * n_frames
    flops = 2 * t2 * q_bins * (e_dim + d_dim) + 5 * t2
    err, abs_err = agreement([(got, want)])
    summary["frame_attention"] = dict(
        rel_err=err, tol=1e-4, max_abs_err=abs_err,
        shape=[list(q.shape), list(v.shape)],
        plan=attn_ops.card_attention_plan(1, n_frames, q_bins, n_head, e_dim, d_dim)._asdict(),
        ms=timed_ms(lambda: attn_ops.frame_attention(q, k, v, n_head, e_dim)),
        plain_ms=timed_ms(lambda: attn_ops.frame_attention_plain(q, k, v, n_head, e_dim)),
        bound=bound(flops, 4 * (q.numel() + k.numel() + 2 * v.numel())),
        library_ms=timed_ms(sdpa), library_rel_err=rel_err(lib_out, want),
        calls="one block (norms applied before)")

    for name, s in summary.items():
        s["bound_ms"], s["bound_by"] = s.pop("bound")
        emit({"phase": "kernel", "name": name, **s})
        if not s["rel_err"] < s["tol"]:
            fail(f"{name} disagrees with its plain version: rel {s['rel_err']} >= {s['tol']}")

    # The CUDA attention has no VMEM gate: one long sequence (T=5000).
    long_t = 5000
    ql, kl = rand(1, long_t, q_bins, n_head * e_dim), rand(1, long_t, q_bins, n_head * e_dim)
    vl = rand(1, long_t, q_bins, c)
    err = rel_err(attn_ops.frame_attention(ql, kl, vl, n_head, e_dim),
                  attn_ops.frame_attention_plain(ql, kl, vl, n_head, e_dim))
    emit({"phase": "kernel_long", "name": "frame_attention", "T": long_t, "rel_err": err,
          "tol": 1e-4, "ms": timed_ms(lambda: attn_ops.frame_attention(ql, kl, vl, n_head,
                                                                       e_dim), 3)})
    if not err < 1e-4:
        fail(f"frame_attention at T={long_t} disagrees with its plain version: rel {err}")
    del ql, kl, vl
    # 6l48c200's attention: head width D = C/4 = 12, norms on plain ops first.
    d12 = WIDE_C // n_head
    vw = rand(1, n_frames, q_bins, WIDE_C)
    want = attn_ops.frame_attention_plain(q, k, vw, n_head, e_dim)
    err = rel_err(attn_ops.frame_attention(q, k, vw, n_head, e_dim), want)
    vwh = to_heads(vw, d12)
    sdpa12 = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vwh, scale=scale)
    emit({"phase": "kernel_d12", "name": "frame_attention", "v": list(vw.shape),
          "rel_err": err, "tol": 1e-4,
          "plan": attn_ops.card_attention_plan(1, n_frames, q_bins, n_head, e_dim,
                                               d12)._asdict(),
          "ms": timed_ms(lambda: attn_ops.frame_attention(q, k, vw, n_head, e_dim)),
          "plain_ms": timed_ms(lambda: attn_ops.frame_attention_plain(q, k, vw, n_head, e_dim)),
          "library_ms": timed_ms(sdpa12),
          "library_rel_err": rel_err(sdpa12().reshape(1, n_head, n_frames, q_bins, d12).permute(
              0, 2, 3, 1, 4).reshape(want.shape), want),
          "bound_ms": bound(2 * t2 * q_bins * (e_dim + d12) + 5 * t2,
                            4 * (q.numel() + k.numel() + 2 * vw.numel()))[0]})
    if not err < 1e-4:
        fail(f"frame_attention at D=12 disagrees with its plain version: rel {err}")
    del vw, vwh, want

    # -- the training kernels at the shapes of one step -----------------------------
    train_kernel_phase(rand, dev, summary)

    # -- the LSTM kernels at the shapes of 6l48c200 ----------------------------------
    lstm_kernel_phase(rand, dev, summary, n_frames)

    # -- backbone: full width, kernels against the all-plain route ----------------
    torch.manual_seed(SEED)
    net = tfgridnet_5l32c100().to(dev).eval()
    ref = tfgridnet_5l32c100(use_kernels=False).to(dev).eval()
    ref.load_state_dict(net.state_dict())
    shape = (2, 1, q_bins, 256)
    xs = torch.complex(rand(*shape), rand(*shape))
    ys = torch.complex(rand(*shape), rand(*shape))
    ts = torch.tensor([0.5, 0.9], device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        out = net(xs, ys, ts)
        torch.cuda.synchronize()
        per_forward = ops.launch_counts()
        err = rel_err(out, ref(xs, ys, ts))
        fwd_ms = timed_ms(lambda: net(xs, ys, ts), 3)
    emit({"phase": "backbone", "shape": list(shape), "rel_err": err, "tol": 1e-4,
          "finite": bool(torch.isfinite(torch.view_as_real(out)).all()),
          "launches_per_forward": per_forward, "forward_ms": fwd_ms})
    if not err < 1e-4 or min(per_forward[k] for k in SERVE_KERNELS) == 0:
        fail(f"backbone: rel {err}, launches {per_forward}")
    del net, ref

    # -- serve: the main path, through the single-file CLI ---------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        torch.manual_seed(SEED)
        fdbm = FDBM(cfg, device="cuda")
        ckpt = os.path.join(tmp, "model.pt")
        save_checkpoint(ckpt, fdbm)

        # A 2-step serve against the same weights on the plain route.
        plain = FDBM(cfg, device="cuda")
        plain.dnn = tfgridnet_5l32c100(use_kernels=False).to(dev).eval()
        plain.dnn.load_state_dict(fdbm.dnn.state_dict())
        audio = torch.as_tensor(rng.standard_normal((1, 16000)).astype(np.float32) * 0.3,
                                device=dev)
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
        a = fdbm.enhance_batch(audio, gen(), sampler_type="sde_ei", N=2)
        b = plain.enhance_batch(audio, gen(), sampler_type="sde_ei", N=2)
        err = rel_err(a, b)
        emit({"phase": "serve_check", "sampler": "sde_ei", "N": 2, "samples": audio.shape[-1],
              "rel_err": err, "tol": 1e-4})
        if not err < 1e-4:
            fail(f"serve with kernels disagrees with the plain route: rel {err}")
        del fdbm, plain

        config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                              "config_infer_single.yaml")
        totals = dict.fromkeys(ops.launch_counts(), 0)
        rate_audio = rate_wall = 0.0
        for i, (seconds, sampler, n_steps) in enumerate(SERVE_REQUESTS):
            n = int(seconds * cfg.sr)
            noisy = os.path.join(tmp, f"noisy_{i}.wav")
            out_file = os.path.join(tmp, f"enhanced_{i}.wav")
            wav = np.random.default_rng(SEED + i).standard_normal(n).astype(np.float32)
            write_wav(noisy, 0.1 * wav + 0.3 * np.sin(np.arange(n) * 0.05), cfg.sr)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as cli_out:
                infer_single.main(["-C", config, f"ckpt={ckpt}", f"noisy_file={noisy}",
                                   f"output_file={out_file}", f"N={n_steps}",
                                   f"sampler_type={sampler}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            enhanced, sr = read_wav(out_file)
            ok = (enhanced.shape == (1, n) and sr == cfg.sr
                  and bool(np.isfinite(enhanced).all())
                  and min(counts[k] for k in SERVE_KERNELS) > 0)
            emit({"phase": "serve", "request": i, "sampler": sampler, "N": n_steps,
                  "audio_seconds": seconds, "samples": int(enhanced.shape[-1]),
                  "wall_seconds": wall, "audio_seconds_per_second": seconds / wall,
                  "launches": counts, "finite": bool(np.isfinite(enhanced).all()),
                  "cli": cli_out.getvalue().strip()})
            if not ok:
                fail(f"serve request {i}: shape {enhanced.shape}, sr {sr}, launches {counts}")
            for name, count in counts.items():
                totals[name] += count
            if n_steps == 30:
                rate_audio += seconds
                rate_wall += wall
        emit({"phase": "serve_rate", "N": 30, "audio_seconds": rate_audio,
              "wall_seconds": rate_wall, "audio_seconds_per_second": rate_audio / rate_wall})
        emit(profile_request(load_checkpoint(ckpt, device="cuda"), noisy))

        # -- training: one step against the plain route, the CLI, the rate ---------
        train_grad_phase(rng, dev, tfgridnet_5l32c100,
                         {"grid_fold_train_pair": RNN_PATHS, "grid_fold_train_pair_bwd": RNN_PATHS})
        totals.update(train_cli_phase(tmp, smi))
        train_rate_phase(rng, dev, smi, tfgridnet_5l32c100)

        # -- 6l48c200: the generic RNN path through the LSTM kernels -------------
        wide_backbone_phase(rand, dev)
        wide_serve = wide_serve_phase(rng, dev, noisy)
        totals["bilstm_fused_forward"] = wide_serve["bilstm_fused_forward"]
        totals["frame_attention"] += wide_serve["frame_attention"]
        totals.update(wide_train_phase(rng, dev, smi))
    emit({"phase": "done", "wall_seconds": time.perf_counter() - t_start})

    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "launches": totals[name],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        for name, s in summary.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def probe(first: int, seeds: int, out_path: str) -> None:
    """Readings of the 6l48c200 checks over seeds first .. first + seeds - 1
    (weights, batch, noise): the 2-step serve and the training step's
    gradients of the kernel route, the plain route and the TF32 control
    against float64 (the gradients per leaf), written to ``out_path`` as
    JSON. The readings that set the float64 gate's limits; fails on
    nothing."""
    from fdbm_tpu_torch.ops import _build
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": nvidia_smi()})
    emit({"phase": "build", "nvcc_seconds": _build.build_all()["seconds"]})
    readings = []
    for seed in range(first, first + seeds):
        rng = np.random.default_rng(seed)
        serve, serve_ok, _ = wide_serve_check(rng, dev, seed)
        emit({"phase": f"probe_serve_check_{WIDE}", "ok": serve_ok, **serve})
        rec = train_grad_phase(rng, dev, TFGridNet, {}, f"probe_train_grad_{WIDE}",
                               float64=True, seed=seed, strict=False)
        readings.append({"seed": seed, "serve_check": serve, "serve_ok": serve_ok,
                         "ok": rec["ok"], "loss_rel": rec["loss_rel"], "errors": rec["errors"]})
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(readings, f)


# Copies of a kernel source with one part of the work switched off
# (probe_kernels): (file, text to replace, replacement[, further (text,
# replacement) pairs of the same variant]). Timing only: the results of a
# variant are wrong.
_ATTN_CU, _LSTM_CU_FILE, _GRID_CU = "attention.cu", "lstm.cu", "gridrnn.cu"
_TRAIN_CU_FILE = "gridrnn_train.cu"
KERNEL_VARIANTS = {
    "frame_attention": {
        "no_values": (_ATTN_CU, "  // -- values: slice `rank` of the value width",
                      "  return;\n  // -- values"),
        "no_value_loads": (_ATTN_CU, "      if (ci + p.nvs - 1 < n_chunks) "
                           "stage_values(ci + p.nvs - 1);", ""),
        "no_value_fma": (_ATTN_CU, "      if (rgv < p.rg) {\n        const float4* vs",
                         "      if (rgv < 0) {\n        const float4* vs"),
        "no_key_loads": (_ATTN_CU, "        copy_lanes(dst + u * AT_KCP + c * ew, ok ? col + "
                         "(ut0 + u) * qk_row : k, ok, ew);", ""),
        "no_score_fma": (_ATTN_CU, "    if (dsi < p.ds) {\n      const float* qa",
                         "    if (dsi < 0) {\n      const float* qa"),
    },
    "bilstm_fused_forward": {
        "no_recurrence": (_LSTM_CU_FILE, "  return launch_rec<false>(xp, w_hh, out, nullptr, S, B, "
                          "H, dirs, rev, cs, lines, stream);", "  return cudaSuccess;"),
        "no_product": (_LSTM_CU_FILE, "    for (int k = ks; k < H; k += RC_KS) {",
                       "    for (int k = ks; k < 0; k += RC_KS) {"),
        "no_remote_h": (_LSTM_CU_FILE, "      for (int r = 0; r < cs; ++r) cluster.map_shared_rank"
                        "(hnext, r)[unit * lbp + lq0 + q] = h;",
                        "      hnext[unit * lbp + lq0 + q] = h;"),
        "no_cluster_barrier": (_LSTM_CU_FILE, "    }\n    cluster.sync();\n  }\n}",
                               "    }\n    __syncthreads();\n  }\n  cluster.sync();\n}"),
        "no_xp_loads": (_LSTM_CU_FILE, "xp[(row0 + q) * N + g * H + unit] : 0.f;", "0.f : 0.f;"),
    },
    # Kernel 1: the fused recurrence's parts (the fold is unchanged).
    "grid_rnn_seq1_pair": {
        "no_window": (_GRID_CU, "    if (s + 1 < L) window(s + 1);", ""),
        "no_h_product": (_GRID_CU, "    fused_sum<LINES>(acc, wh_cols, wst, hcur, lbp, H, ks);",
                         ""),
        "no_exchange": (_GRID_CU, "          cluster.map_shared_rank(hnext, r)[units[u] * lbp + "
                        "lq0 + q] = h;", "          hnext[units[u] * lbp + lq0 + q] = h;"),
        "no_cluster_barrier": (_GRID_CU, "    if (s > 0) cluster_wait();  // every",
                               "    if (s > 0) __syncthreads();  // every",
                               (("    cluster_arrive();\n    if (s + 1 < L)", "    if (s + 1 < L)"),
                                ("  cluster_wait();  // no block leaves",
                                 "  cluster.sync();  //"))),
    },
    # Kernel 6: the reverse sweep's parts (dx and the weight gradients unchanged).
    "grid_fold_train_pair_bwd": {
        "no_sweep_product": (_TRAIN_CU_FILE, "        for (int n = ks; n < ncol; n += SW_KS) {",
                             "        for (int n = ks; n < 0; n += SW_KS) {"),
        "no_reduce_scatter": (_TRAIN_CU_FILE, "            dst[i][buf + (ks * L8 + q) * uc + "
                              "dst_col[i]] = acc[q][i];", "            ;"),
        "no_cluster_barrier": (_TRAIN_CU_FILE, "    cluster_arrive();\n    if (in_warp && s + 1 "
                               "< L) window(s + 1);\n    cluster_wait();",
                               "    if (in_warp && s + 1 < L) window(s + 1);\n    __syncthreads();",
                               (("    __syncthreads();  // dgs is read by every lane of the "
                                 "block's next product\n  }\n}",
                                 "    __syncthreads();\n  }\n  cluster.sync();\n}"),)),
        "no_dh_window": (_TRAIN_CU_FILE, "    if (in_warp && s + 1 < L) window(s + 1);", ""),
    },
    # Kernel 9: the reverse sweep's parts (dx and the weight gradients unchanged).
    "lstm_core_bwd": {
        "no_product": (_LSTM_CU_FILE, "    for (int nq = ks; nq < uc; nq += RC_KS) {",
                       "    for (int nq = ks; nq < 0; nq += RC_KS) {"),
        "no_reduce_scatter": (_LSTM_CU_FILE, "        for (int q = 0; q < L4; ++q) dst[i][buf + "
                              "(ks * L4 + q) * uc + dst_col[i]] = acc[q][i];", ""),
        "no_barrier": (_LSTM_CU_FILE, "    // 3.\n    cluster.sync();", "    // 3.",
                       (("    // 5.\n    __syncthreads();\n  }\n}",
                         "    // 5.\n    __syncthreads();\n  }\n  cluster.sync();\n}"),)),
        "no_stash_loads": (_LSTM_CU_FILE, "    // Each thread copies its own cells' stashes (so it "
                           "alone reads them).\n#pragma unroll\n    for (int i = 0; i < CELLS;",
                           "    // Each thread copies its own cells' stashes (so it alone reads "
                           "them).\n#pragma unroll\n    for (int i = 0; i < 0;"),
    },
}


# Kernel 5 runs kernel 1's recurrence with its stash: the same parts, and the stash writes.
KERNEL_VARIANTS["grid_fold_train_pair"] = {
    **KERNEL_VARIANTS["grid_rnn_seq1_pair"],
    "no_stash_writes": (_GRID_CU, "        if constexpr (STASH) {",
                        "        if constexpr (false) {"),
}


def variant_text(src: str, kernel: str, name: str, spec) -> str:
    """The source of one variant: each of its replacements must match once."""
    pairs = [(spec[1], spec[2]), *(spec[3] if len(spec) > 3 else ())]
    for old, new in pairs:
        if src.count(old) != 1:
            fail(f"probe variant {kernel}/{name}: its text is not in {spec[0]} once")
        src = src.replace(old, new)
    return src


PROBE_ATTENTION_PLANS = ((24, 3), (32, 3), (40, 3), (40, 4), (48, 4), (24, 2), (8, 1), (16, 1))


def probe_kernels(out_path: str) -> None:
    """Where the time of the redesigned kernels goes: each variant of
    KERNEL_VARIANTS is built from a copy of its source and timed at the main
    path's shape and plan beside the unchanged source, on the same inputs
    (frame_attention: B=1, T=257, D=8 and 12, and the unchanged kernel at
    the plans of PROBE_ATTENTION_PLANS; bilstm_fused_forward: 262 lines, two
    directions, H=200; grid_rnn_seq1_pair: the canvas [1, 263, 263, 32],
    H=100; grid_fold_train_pair and its backward: [263, 524, 32], H=100;
    lstm_core_bwd: [260, 524, 192], H=200). Writes the times to
    ``out_path``."""
    import ctypes

    from fdbm_tpu_torch.ops import _build, attention as attn_ops, gridrnn, gridrnn_train
    from fdbm_tpu_torch.ops import lstm as lstm_ops

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi})
    _build.build_all()
    work = tempfile.mkdtemp(prefix="probe_kernels_", dir=_build.BUILD_DIR)
    rng = np.random.default_rng(SEED)
    rand = lambda *shape, s=1.0: torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32) * s, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    readings = {"nvidia_smi": smi}
    for kernel, variants in KERNEL_VARIANTS.items():
        src_name = next(iter(variants.values()))[0]
        src = (_build.CSRC / src_name).read_text()
        texts = {"unchanged": src}
        for name, spec in variants.items():
            texts[name] = variant_text(src, kernel, name, spec)
        procs = {}
        for name, text in texts.items():
            cu = os.path.join(work, f"{kernel}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                 cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        libs = {}
        for name, proc in procs.items():
            if proc.wait():
                fail(f"probe variant {kernel}/{name} does not build: {proc.stdout.read()[-2000:]}")
            libs[name] = ctypes.CDLL(os.path.join(work, f"{kernel}_{name}.so"))
        if kernel == "frame_attention":
            for d_dim in (8, 12):
                q, k = rand(1, 257, 257, 8), rand(1, 257, 257, 8)
                v = rand(1, 257, 257, 4 * d_dim)
                out = torch.empty_like(v)
                plan = attn_ops.card_attention_plan(1, 257, 257, 4, 2, d_dim)
                row = {"plan": plan._asdict()}
                for name, lib in libs.items():
                    fn = lib.frame_attention
                    fn.argtypes, fn.restype = attn_ops._SIGNATURES["frame_attention"], ctypes.c_int
                    call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                                      257, 257, 4, 2, d_dim, 1 / math.sqrt(514), plan.rows,
                                      plan.slices, stream)
                    if call():
                        fail(f"probe variant {kernel}/{name} does not launch")
                    row[name] = timed_ms(call, 30)
                # Other plans of the unchanged kernel, with the card's count of their
                # clusters at once: a grid of more clusters than that runs in two waves.
                fn = libs["unchanged"].frame_attention
                mc = libs["unchanged"].frame_attention_max_clusters
                mc.argtypes = attn_ops._SIGNATURES["frame_attention_max_clusters"]
                row["plans"] = []
                for rows_, slices in PROBE_ATTENTION_PLANS:
                    call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                                      257, 257, 4, 2, d_dim, 1 / math.sqrt(514), rows_, slices,
                                      stream)
                    if call():
                        continue  # does not fit at this D
                    row["plans"].append({"rows": rows_, "slices": slices,
                                         "clusters": 4 * math.ceil(257 / rows_),
                                         "max_clusters": mc(257, 257, 2, d_dim, rows_, slices),
                                         "ms": timed_ms(call, 30)})
                readings[f"{kernel}_d{d_dim}"] = row
                emit({"phase": "probe_kernels", "kernel": kernel, "D": d_dim, **row})
        elif kernel == "bilstm_fused_forward":
            x = rand(260, 262, 192)
            w = (rand(2, 192, 800, s=0.07), rand(2, 200, 800, s=0.07), rand(2, 800, s=0.07))
            xp, out = torch.empty(2, 260, 262, 800, device=dev), torch.empty(2, 260, 262, 200,
                                                                              device=dev)
            plan = lstm_ops.recurrence_plan(262, 2, 200)
            row = {"plan": plan._asdict()}
            for name, lib in libs.items():
                fn = lib.lstm_forward
                fn.argtypes, fn.restype = lstm_ops._SIGNATURES["lstm_forward"], ctypes.c_int
                call = lambda: fn(x.data_ptr(), *(t.data_ptr() for t in w), xp.data_ptr(),
                                  out.data_ptr(), 260, 262, 192, 200, 2, 0, plan.cs, plan.lines,
                                  stream)
                if call():
                    fail(f"probe variant {kernel}/{name} does not launch")
                row[name] = timed_ms(call, 10)
            readings[kernel] = row
            emit({"phase": "probe_kernels", "kernel": kernel, **row})
        elif kernel == "grid_rnn_seq1_pair":
            # One RNN path of the 4 s request: canvas [1, 263, 263, 32], H = 100.
            x = rand(1, 263, 263, 32, s=0.5)
            w = (rand(2, 128, 400, s=0.1), rand(2, 100, 400, s=0.1), rand(2, 400, s=0.1),
                 rand(200, 128, s=0.1))
            hs = torch.empty(2, 263, 260, 100, device=dev)
            outf, outb = torch.empty_like(x), torch.empty_like(x)
            plan = gridrnn.fused_plan(263, 32, 100)
            row = {"plan": plan._asdict()}
            for name, lib in libs.items():
                fn = lib.gridrnn_seq1_pair
                fn.argtypes, fn.restype = gridrnn._SIGNATURES["gridrnn_seq1_pair"], ctypes.c_int
                call = lambda: fn(x.data_ptr(), *(t.data_ptr() for t in w), hs.data_ptr(),
                                  outf.data_ptr(), outb.data_ptr(), 1, 263, 263, 32, 100,
                                  plan.cs, plan.lines, stream)
                if call():
                    fail(f"probe variant {kernel}/{name} does not launch")
                row[name] = timed_ms(call, 20)
            readings[kernel] = row
            emit({"phase": "probe_kernels", "kernel": kernel, **row})
        elif kernel in ("grid_fold_train_pair", "grid_fold_train_pair_bwd"):
            # One intra path of a 5l32c100 training step: [263, 524, 32], H = 100.
            s_len, lines, c, hidden = 263, 524, 32, 100
            x = rand(s_len, lines, c, s=0.5)
            w = (rand(2, 128, 400, s=0.1), rand(2, 100, 400, s=0.1), rand(2, 400, s=0.1),
                 rand(200, 128, s=0.1))
            outf, outb, stash = gridrnn_train.grid_fold_train_pair_fwd(x, *w)
            if kernel == "grid_fold_train_pair":
                plan = gridrnn_train.train_fwd_plan(lines, c, hidden)
                args = lambda: (*(t.data_ptr() for t in (x, *w, *stash, outf, outb)), s_len,
                                lines, c, hidden, plan.cs, plan.lines, stream)
                entry, sigs, iters = "grid_fold_train_fwd", gridrnn_train._FWD_SIGNATURES, 10
            else:
                plan = gridrnn_train.train_sweep_plan(lines, c, hidden)
                cot = (rand(s_len, lines, c), rand(s_len, lines, c))
                lib6 = _build.load("gridrnn_train", gridrnn_train._SIGNATURES,
                                   gridrnn_train._RESTYPES)
                dgates = torch.empty(2, lines, s_len - 3, 4 * hidden, device=dev)
                work6 = torch.empty(lib6.grid_fold_train_bwd_workspace(s_len, lines, c, hidden),
                                    device=dev)
                grads = (torch.empty_like(x), torch.empty_like(w[0]), torch.empty_like(w[1]),
                         torch.empty_like(w[2]), torch.empty_like(w[3]))
                args = lambda: (x.data_ptr(), cot[0].data_ptr(), cot[1].data_ptr(),
                                *(t.data_ptr() for t in stash), w[0].data_ptr(), w[1].data_ptr(),
                                w[3].data_ptr(), dgates.data_ptr(), work6.data_ptr(),
                                *(g.data_ptr() for g in grads), s_len, lines, c, hidden, plan.cs,
                                plan.lines, stream)
                entry, sigs, iters = "grid_fold_train_bwd", gridrnn_train._SIGNATURES, 5
            row = {"plan": plan._asdict()}
            for name, lib in libs.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = sigs[entry], ctypes.c_int
                call = lambda: fn(*args())
                if call():
                    fail(f"probe variant {kernel}/{name} does not launch")
                row[name] = timed_ms(call, iters)
            readings[kernel] = row
            emit({"phase": "probe_kernels", "kernel": kernel, **row})
        else:
            # One lstm_core backward of a 6l48c200 step: [260, 524, 192], H = 200.
            s_len, lines, d, hidden = 260, 524, 192, 200
            x = rand(s_len, lines, d)
            w = (rand(d, 800, s=0.07), rand(hidden, 800, s=0.07), rand(800, s=0.07))
            _, (h, gates, c) = lstm_ops.lstm_core_fwd(x, *w)
            cot = rand(s_len, lines, hidden)
            dgates = torch.empty_like(gates)
            lib9 = _build.load("lstm", lstm_ops._SIGNATURES, lstm_ops._RESTYPES)
            work9 = torch.empty(lib9.lstm_train_bwd_workspace(s_len, lines, d, hidden), device=dev)
            dx, dwg = torch.empty_like(x), torch.empty(d + hidden + 1, 800, device=dev)
            plan = lstm_ops.sweep_plan(lines, hidden)
            row = {"plan": plan._asdict()}
            for name, lib in libs.items():
                fn = lib.lstm_train_bwd
                fn.argtypes, fn.restype = lstm_ops._SIGNATURES["lstm_train_bwd"], ctypes.c_int
                call = lambda: fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), gates.data_ptr(),
                                  cot.data_ptr(), w[0].data_ptr(), w[1].data_ptr(),
                                  dgates.data_ptr(), work9.data_ptr(), dx.data_ptr(),
                                  dwg.data_ptr(), s_len, lines, d, hidden, 0, plan.cs,
                                  plan.lines, stream)
                if call():
                    fail(f"probe variant {kernel}/{name} does not launch")
                row[name] = timed_ms(call, 5)
            readings[kernel] = row
            emit({"phase": "probe_kernels", "kernel": kernel, **row})
    with open(out_path, "w") as f:
        json.dump(readings, f)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--probe-seeds", type=int, default=0,
                        help="only read the 6l48c200 checks over this many seeds (see probe)")
    parser.add_argument("--probe-first", type=int, default=SEED, help="the first probe seed")
    parser.add_argument("--probe-out", help="where --probe-seeds writes its readings (JSON)")
    parser.add_argument("--probe-kernels", metavar="OUT",
                        help="only time the redesigned kernels with parts of their work "
                             "switched off (see probe_kernels), written to OUT (JSON)")
    cli = parser.parse_args()
    if cli.probe_kernels:
        probe_kernels(cli.probe_kernels)
    elif cli.probe_seeds:
        if not cli.probe_out:
            parser.error("--probe-seeds needs --probe-out")
        probe(cli.probe_first, cli.probe_seeds, cli.probe_out)
    else:
        main()
