#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fdbm_tpu_torch/ops/csrc`` with nvcc
and drives the port's two paths at the full width of
``tfgridnet_5l32c100``:

* serving: each serving kernel against its plain PyTorch version at the
  shapes of the path, the backbone against its all-plain route, three
  files through ``fdbm_tpu_torch.infer_single``, one profiled request;
* training: each training kernel (the summed fold, the stashing forward
  and its backward) against its plain version at the shapes of a step
  (B=2, 256 frames), one training step's loss and gradients against the
  all-plain route, ``fdbm_tpu_torch.train`` on a synthetic dataset (train,
  resume, then serve the ``last`` slot), and the training rate of steady
  steps with one profiled step.

Launch counts are set to 0 just before each path runs through its CLI and
read just after. Every phase prints one JSON line; any failure exits
non-zero. The last lines are the card's ``nvidia-smi`` name and power
limit, the per-kernel summary and ``{"ok": true, "device": {...}}``.

fp32 throughout with TF32 off. Tolerances (relative L2): 1e-4 for the RNN
paths and the attention (long fp32 accumulation chains, summed in another
order than the plain version), 1e-5 for the norm (a few terms per group),
1e-4 for the backbone and a 2-step serve against the plain route; 1e-3
norm-relative for each gradient of the training kernels and for every
parameter's gradient of a training step (the JAX package's model-level
gate, tests/test_gridrnn_train.py), 1e-5 for the step's loss.
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
REPLACES = {
    "grid_rnn_seq1_pair": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu", "fdbm_tpu/ops/gridrnn.py:434"),
    "flat_group_norm": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:180"),
    "frame_attention": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:324"),
    "grid_bilstm_fold": (_TRAIN_CU, "fdbm_tpu/ops/gridrnn.py:217"),
    "grid_fold_train_pair": (_TRAIN_CU, "fdbm_tpu/ops/gridrnn_train.py:217"),
    "grid_fold_train_pair_bwd": (_TRAIN_CU, "fdbm_tpu/ops/gridrnn_train.py:508"),
}
SERVE_KERNELS = ("grid_rnn_seq1_pair", "flat_group_norm", "frame_attention")
TRAIN_KERNELS = ("grid_bilstm_fold", "grid_fold_train_pair", "grid_fold_train_pair_bwd")
# The training operating point of configs/config.yaml: batch 2, 256 frames.
TRAIN_BATCH, TRAIN_FRAMES = 2, 256
TRAIN_STEPS, RESUME_STEPS = 8, 2
RNN_PATHS = 10  # 5 blocks x (intra, inter)


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


def profile_request(fdbm, noisy: str) -> dict:
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
        return {"phase": "profile", "wall_ms": wall_ms, "note": "no device time recorded"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    return {"phase": "profile", "request": "4 s, sde_ei, N=30, B=1", "wall_ms": wall_ms,
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
            rows["grid_fold_train_pair"].append(dict(
                path=path, shape=[s_len, lines, c], rel_err=err, max_abs_err=abs_err,
                ms=timed_ms(lambda: gridrnn_train.grid_fold_train_pair_fwd(x, *w)),
                plain_ms=timed_ms(lambda: gridrnn_train.grid_fold_train_pair_plain(x, *w), 3),
                bound=bound(flops["forward"], io + 8 * x.numel() + stash)))
        del want_f, want_b, got

        bwd = lambda: gridrnn_train.grid_fold_train_pair_bwd(x, *w, cot[0], cot[1], stash=st)
        plain_bwd = lambda: gridrnn_train.grid_fold_train_pair_bwd_plain(x, *w, cot[0], cot[1])
        got, want = bwd(), plain_bwd()
        names = ("dx", "dw_ih", "dw_hh", "dbias", "dwd")
        errs = {n: grad_rel(g, r) for n, g, r in zip(names, got, want)}
        rows["grid_fold_train_pair_bwd"].append(dict(
            path=path, shape=[s_len, lines, c], rel_err=max(errs.values()), grad_rel=errs,
            max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, want)),
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
        # Per call, the mean of one intra and one inter call (a step makes
        # five of each).
        mean = lambda key: sum(r[key] for r in rows[name]) / len(rows[name])
        summary[name] = dict(
            rel_err=max(r["rel_err"] for r in rows[name]), tol=tol,
            max_abs_err=max(r["max_abs_err"] for r in rows[name]), ms=mean("ms"),
            plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=rows[name][0]["bound_by"], library_ms=None,
            calls="mean of one intra and one inter call of a B=2, 256-frame step")


def synthetic_batch(rng, dev):
    """(x, y) audio [2, 255 * 256]: the crops of one training batch."""
    n = (TRAIN_FRAMES - 1) * 256
    x = 0.3 * np.sin(np.arange(n) * 0.05)[None] * rng.uniform(0.5, 1.0, (TRAIN_BATCH, 1))
    y = x + 0.05 * rng.standard_normal((TRAIN_BATCH, n))
    return tuple(torch.as_tensor(a.astype(np.float32), device=dev) for a in (x, y))


def train_grad_phase(rng, dev) -> None:
    """One full-width training step, same batch, (t, z) and weights, through
    the kernel route and through the all-plain route."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100

    cfg = FDBMConfig()
    torch.manual_seed(SEED)
    kernel = FDBM(cfg, device="cuda")
    plain = FDBM(cfg, device="cuda")
    plain.dnn = tfgridnet_5l32c100(use_kernels=False).to(dev)
    plain.dnn.load_state_dict(kernel.dnn.state_dict())
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
    emit({"phase": "train_grad", "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "loss": loss_k, "loss_plain": loss_p, "loss_rel": loss_rel, "loss_tol": 1e-5,
          "worst_leaf": worst, "worst_grad_rel": rels[worst], "grad_tol": 1e-3,
          "leaves": len(rels), "grad_norm": gnorm, "seconds_kernel_route": wall_k,
          "seconds_plain_route": wall_p, "launches": counts})
    if not (loss_rel < 1e-5 and rels[worst] < 1e-3):
        fail(f"training step: kernel route vs plain route, loss rel {loss_rel}, "
             f"worst gradient {worst} rel {rels[worst]}")
    if counts["grid_fold_train_pair"] != RNN_PATHS or counts["grid_fold_train_pair_bwd"] != RNN_PATHS:
        fail(f"training step launched {counts}, expected {RNN_PATHS} forward and backward")


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


def train_rate_phase(rng, dev, smi: str) -> None:
    """Train audio-s/s over steady steps of the full-width model at B=2 and
    256 frames (8.16 audio-s per step), the step time, peak memory, and the
    device idle share and top kernels of one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState

    torch.manual_seed(SEED)
    fdbm = FDBM(FDBMConfig(), device="cuda")
    state = TrainState(fdbm.dnn)
    batch = synthetic_batch(rng, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    audio_per_step = TRAIN_BATCH * (TRAIN_FRAMES - 1) * fdbm.cfg.hop_length / fdbm.cfg.sr
    for _ in range(2):
        fdbm.train_step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        fdbm.train_step(state, batch, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fdbm.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    emit({"phase": "train_rate", "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "audio_seconds_per_step": audio_per_step, "steps": steps, "step_ms": step_s * 1e3,
          "train_audio_seconds_per_second": audio_per_step / step_s,
          "peak_memory_gb": peak / 1e9, "profiled_step_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share_of_busy": e.self_device_time_total / 1e3 / busy_ms}
                          for e in top] if busy_ms else [], "nvidia_smi": smi})
    if not busy_ms:
        fail("train_rate: the profiler recorded no device time")


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
    summary["grid_rnn_seq1_pair"] = dict(
        rel_err=err, tol=1e-4, max_abs_err=abs_err, shape=list(x.shape),
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

    # -- the training kernels at the shapes of one step -----------------------------
    train_kernel_phase(rand, dev, summary)

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
        train_grad_phase(rng, dev)
        totals.update(train_cli_phase(tmp, smi))
        train_rate_phase(rng, dev, smi)
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


if __name__ == "__main__":
    main()
