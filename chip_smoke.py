#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fdbm_tpu_torch/ops/csrc`` with nvcc
and drives the port's paths at the full width of two TF-GridNets and of
NCSN++:

* ``tfgridnet_5l32c100`` (5 blocks, C=32, H=100), inside the fused RNN
  kernels' gate. Serving: each serving kernel against its plain PyTorch
  version at the shapes of the path (the RNN path with its plan and its two
  stages), and again at the folder's batch shape (``kernel_b16``: 16 rows
  of one 4.096 s chunk, kernel 1's plan of many waves), the backbone
  against its all-plain route, a 2-step serve against the plain route at
  B=1 and at B=16 (``serve_batch_check``, with one row of the batch against
  the same row served alone), three files through
  ``fdbm_tpu_torch.infer_single``, one profiled request; the folder CLI
  ``fdbm_tpu_torch.infer_folder`` at --batch_size 16 on 6 files of 1-12 s
  and one of 35 s (``serve_folder``: pooled 4.096 s chunks, 30-step
  sde_ei, with one profiled batch) and on three of them whole
  (``serve_folder_whole``, --chunk_seconds 0); the ``pc`` and ``ode_int``
  samplers against the plain route (``samplers``). Predictive mode:
  ``fdbm_tpu_torch.train`` on ``configs/config_predictive.yaml`` for a few
  steps, its last slot served through the folder CLI (``predictive``).
  Training: each training kernel (the summed fold, the stashing
  forward and its backward; the last two with their plans and stages, the
  backward checked for equal bits in two calls) against its plain version
  at the shapes of a step (B=2, 256 frames), one training step's loss and
  gradients against
  the all-plain route, ``fdbm_tpu_torch.train`` on a synthetic dataset
  (train, resume, then serve the ``last`` slot; its per-epoch evaluation
  fills the ``best_pesq`` and ``best_si_sdr`` slots), and the training rate
  of steady steps with one profiled step. Fine-tuning (the enhanced bridge,
  configs/config_finetuning.yaml: N=5 ``ode_ei``, the first N-1 calls on
  the serving route without a gradient, the last on the training route):
  one fine-tuning step's loss and gradients against the all-plain route
  (``finetune_grad``; against float64 where the unroll carries fp32
  rounding past the fp32 gate), ``fdbm_tpu_torch.train_finetuning`` from
  the train phase's run with its evaluation, its ``last`` slot served
  through both serving CLIs (``finetune``), ``fdbm_tpu_torch.evaluate`` on
  those outputs (``evaluate``), the fine-tuning rate (``finetune_rate``),
  and every loss type and PESQ on the card against the CPU
  (``losses_card``).
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
* NCSN++ (``ncsnpp_v2``, 65.6M parameters, seeded weights at fan-in scale),
  which runs on cuDNN convolutions and plain PyTorch ops and launches none
  of the ten kernels (their counts stay 0 over every NCSN++ phase): the
  backbone at ``[1, 1, 257, 256]`` against itself in float64 (row 0 of a
  B=16 call too), a control with one block's conv0 zeroed that must miss
  that gate, forward times at B=1 and B=16 (NCHW, channels_last, cuDNN's
  benchmark mode) beside the operations counted from the layer shapes; a
  2-step reflection-padded serve against the float64 route; 4 s and 3 s
  files through ``infer_single`` and one profiled request; the folder CLI
  at --batch_size 16 on 10 files of 1-12 s with one profiled batch; one
  training step's loss and gradients against float64; the training CLI
  (train, resume, serve the ``last`` slot); the training rate (cuDNN's
  benchmark mode on, as ``Trainer.fit`` runs); ``ncsnpp_v2_5M_predictive``
  trained through config_predictive.yaml and served through the folder CLI.
  ``--ncsnpp-only`` runs these phases alone (no kernel is built).
* bf16 serving (``inference_dtype=bfloat16``, the JAX package's serving
  dtype). Kernels 1, 2, 3 and 7 in their bf16 forms at the main path's
  shapes and rows 1-3 at B=16, on draws of their own (``kernel_bf16``,
  ``kernel_bf16_b16``: each with its up-cast control, beside the fp32
  form's time on the same inputs, SDPA on bf16 and cuDNN's bf16 LSTM). The
  serving phases above run once more with the override: the three
  requests through ``infer_single`` and one profiled request
  (``serve_bf16``, ``profile_bf16``), the pooled folder
  (``serve_folder_bf16``, one profiled batch), 6l48c200's 4 s request
  (``serve_bf16_6l48c200``), ncsnpp_v2 through ``infer_single`` and its
  folder (``ncsnpp_serve_bf16``, ``ncsnpp_serve_folder_bf16``); a bf16 serve
  launches only bf16 forms, as many as the same serve in fp32 launched of
  the fp32 forms. Last, the three backbones in bf16 (``backbone_bf16``),
  2-step serves at B=1 and B=16 and of 6l48c200 (``serve_check_bf16``), and
  5l32c100 trained QUALITY_STEPS steps on the card on speech-like pairs,
  four held-out files served with ode_ei N=8 in fp32 and bf16
  (``bf16_quality``). ``--bf16-only`` runs the bf16 kernel rows and the
  phases with a bf16 run (their fp32 runs too) alone.
* bf16 training (``compute_dtype=bfloat16``: kernels 4-6 and 8-9 on fp32
  casts, the glue in bf16). One step of 5l32c100, of 6l48c200 (both with
  their q/k projections scaled into the E=2 norms' smooth range,
  ``smooth_qk_``) and of ncsnpp_v2 on fan-in weights against the same step
  through the float64 network (``bf16_grad_phase``: TF-GridNet's loss,
  output, whole gradient and each group of leaves within 1.5x the bf16
  plain route's distance there + 1e-3, NCSN++'s within absolute bounds
  (3e-2, groups 5e-2) and above 1e-4; the bf16 step at least 3x farther
  from float64 than the fp32 step; kernels 5-6 or 8-9 under their fp32
  names and no bf16 form launched; a zeroed group and the weights rounded
  to bf16 must miss); one fine-tuning step
  (``finetune_bf16``: its N-1 calls through the bf16 forms of kernels 1-3,
  its last through kernels 5-6); the bf16 rates of 5l32c100 and ncsnpp_v2
  beside their fp32 rates, with the FLOPs a step (``flops_estimate``) and
  the TFLOP/s they imply (``bf16_train_rates``); and 5l32c100 trained
  QUALITY_TRAIN_STEPS steps in bf16 and in fp32 on ``bf16_quality``'s data
  and seed, the bf16-trained model's mean SI-SDR within 1.0 dB of the
  fp32-trained one's (``bf16_train_quality``; the two trainings run in
  worker processes started beside the DDP workers, and ``bf16_quality``
  serves the fp32 one's EMA at QUALITY_STEPS). The
  training CLI's phase reads its own ``--profile_steps`` trace (the idle
  share, the loader's wait), the loader's items by path and the
  TensorBoard state (``run_logging``), and the pooled folder runs with
  ``FDBM_TPU_SERVE_TRACE=1`` and must print one line a batch.
  ``--bf16-train-only`` runs these alone.
* Data parallelism (``fdbm_tpu_torch/parallel``), on the one card:
  ``mesh_serve`` (a 2-step serve of a B=16 batch split over two replicas
  on cuda:0 against the unsplit batch, the folder CLI with
  ``--mesh_devices 1``, and ``--mesh_devices 2`` refused); ``ddp_nccl``
  (the training CLI under ``python -m torch.distributed.run --standalone
  --nproc_per_node 1``: one NCCL rank, kernels 4-6, an NCCL all-reduce
  kernel in the profiled steps, and 2 data-parallel steps equal bit for bit
  to 2 steps without the collective, on cuDNN's deterministic algorithms);
  ``ddp_two_ranks`` (two processes on cuda:0 over gloo, each half of a B=4
  batch, against this process on the whole batch: ``train_grad``'s gate,
  and both ranks' parameters and EMA equal after 2 steps). The workers of
  the last two start before ``samplers`` and run beside it. Several cards
  are not exercised: NCCL puts no two ranks on one card.

Launch counts are set to 0 just before each path runs and read just after.
Every phase prints one JSON line; any failure exits non-zero. The last
lines are the card's ``nvidia-smi`` name and power limit, the per-kernel
summary and ``{"ok": true, "device": {...}}``.

fp32 throughout with TF32 off. Tolerances (relative L2): 1e-4 for the RNN
paths, the LSTMs and the attention (long fp32 accumulation chains, summed
in another order than the plain version), 1e-5 for the norm (a few terms
per group), 1e-4 for the backbones and the 2-step serves against the plain
route (at B=16 also one row against the same row alone), 1e-4 for the pc
sampler's first 2 steps and, for ode_int's first 3, the two routes' step
decisions (the same attempts accepted, step sizes within 1e-2) and then,
on the same steps, the kernel route against the float64 network within
max(1e-3, 3x the plain route's distance), on cuDNN's deterministic algorithms
(``ode_int_gate``; both samplers are chaotic on
random weights after a few steps, ``samplers_phase``); 1e-3 norm-relative
for each gradient of the training kernels and for
every parameter's gradient of 5l32c100's training step (the JAX package's
model-level gate, tests/test_gridrnn_train.py), 1e-5 for the step's loss.
6l48c200's step is held to the same loss gate; its gradients (where fp32
rounding alone exceeds 1e-3) are held against float64 leaf by leaf and its
LSTM calls one by one against the plain version (``float64_gate``), and its
2-step serve (where it alone exceeds 1e-4) against a float64 network
(``wide_serve_check``); the fp32-vs-fp32 readings are printed beside.
NCSN++ is held to float64 within 1e-4 (backbone, 2-step serve) and, for a
training step, 1e-5 on the loss and 1e-3 norm-relative per leaf (floored
at 1e-4 of the global norm). bf16 (``bf16_gate``): each bf16 kernel within
rel-L2 BF16_TOLS of its bf16 plain version (2e-3, 3e-5, 2.5e-4 and 1e-3
for kernels 1, 2, 3 and 7), which the up-cast control (the fp32 form on the
same bf16 inputs, rounded to bf16 after) must miss for kernels 1, 3 and 7,
and within 1.5x the plain version's distance to float64 plus 1e-3; a bf16
backbone or 2-step serve within that float64 gate (their rel-L2 to the bf16
plain route printed: random weights amplify the kernels' rare one-step
differences), 6l48c200's serve over WIDE_GATE_DRAWS draws: the median of
its distance over that limit at most 1, no draw above WIDE_GATE_W, and two
fault controls missing it (``wide_gate_phase``); ncsnpp_v2 in bf16 between
1e-4 and NCSNPP_BF16_TOL of float64; on trained weights, bf16 against fp32
at least 15 dB SI-SDR and within 0.5 dB enhanced-vs-clean.

    python3 chip_smoke.py --probe-seeds 4 --probe-out readings.json

reads only the 6l48c200 checks over four seeds, the readings the float64
gate's limits come from, and

    python3 chip_smoke.py --probe-bf16-gate readings.json 8

reads only 6l48c200's bf16 2-step serve over eight draws, through the kernel
route, the routes with kernel 3's or kernel 7's plain version in its place
and the fault controls: the readings WIDE_GATE_W comes from, and

    python3 chip_smoke.py --probe-kernels readings.json

only times the six cluster kernels (frame_attention, the LSTM recurrence,
kernel 1's fused recurrence, kernel 5's (the same with its stash), kernel
6's reverse sweep, kernel 9's reverse sweep) with one part of their work
switched off at a time.

    python3 chip_smoke.py --probe-bf16 bf16.json

reads kernel 1's bf16 step by phase, from the clock stamps that its
kernel writes when gridrnn.cu is built with -DGM_STAMPS.

    python3 chip_smoke.py --probe-fp32 fp32.pt

writes what the fp32 route computes (the ten kernels' outputs on fixed
inputs, whether a forward and its convolutions repeat their bits, and
ode_int's first steps route against route, each on its own step control,
repeated, and which plain version carries the plain route's distance to
float64 there), for a comparison of two checkouts: a copy of this script
run from each checkout's root reads that checkout.

    python3 chip_smoke.py --parallel-only 10

runs only the ``samplers`` phase ten times on one model, each reading
printed, and the data-parallel phases once.

    python3 chip_smoke.py --kernels-only

builds, checks and times the kernel rows only (no path is driven and no
ok line is printed). A copy of this script run from a parent commit's
checkout reads that commit's kernels: rows 2, 4, 5 and 6 name the kernels
of both designs (one norm launch a map before, one for the three maps of
an attention call now; the three-stage RNN path before the cluster
recurrences), so a before/after comes from one card.
"""

from __future__ import annotations

import contextlib
import atexit
import dataclasses
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
# tensor cores, dense bf16 on the tensor cores, and HBM3 bandwidth. A row's
# bound takes the peak of its operands' type: fp32 for the fp32 forms, bf16
# for the bf16 forms (whatever units their multiplies run on today).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SERVE_REQUESTS = ((2.0, "sde_ei", 30), (3.0, "ode_ei", 5), (4.0, "sde_ei", 30))
_TRAIN_CU = "fdbm_tpu_torch/ops/csrc/gridrnn_train.cu"
_LSTM_CU = "fdbm_tpu_torch/ops/csrc/lstm.cu"
REPLACES = {
    "grid_rnn_seq1_pair": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu", "fdbm_tpu/ops/gridrnn.py:434"),
    "flat_group_norm": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:180"),
    "frame_attention": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:324"),
    "grid_bilstm_fold": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu", "fdbm_tpu/ops/gridrnn.py:217"),
    "grid_fold_train_pair": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu",
                             "fdbm_tpu/ops/gridrnn_train.py:217"),
    "grid_fold_train_pair_bwd": (_TRAIN_CU, "fdbm_tpu/ops/gridrnn_train.py:508"),
    "bilstm_fused_forward": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:537"),
    "lstm_core": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:298"),
    "lstm_core_bwd": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:354"),
    "lstm_forward": (_LSTM_CU, "fdbm_tpu/ops/lstm.py:108"),
}
REPLACES.update({
    "grid_rnn_seq1_pair_bf16": REPLACES["grid_rnn_seq1_pair"],
    "flat_group_norm_bf16": REPLACES["flat_group_norm"],
    "frame_attention_bf16": REPLACES["frame_attention"],
    "bilstm_fused_forward_bf16": REPLACES["bilstm_fused_forward"],
})
SERVE_KERNELS = ("grid_rnn_seq1_pair", "flat_group_norm", "frame_attention")
TRAIN_KERNELS = ("grid_bilstm_fold", "grid_fold_train_pair", "grid_fold_train_pair_bwd")
# The training operating point of configs/config.yaml: batch 2, 256 frames.
TRAIN_BATCH, TRAIN_FRAMES = 2, 256
TRAIN_STEPS, RESUME_STEPS = 8, 2
RNN_MODEL = "tfgridnet_5l32c100"
RNN_BLOCKS = 5
RNN_PATHS = 2 * RNN_BLOCKS  # intra, inter
# TFGridNet() at its class defaults, the JAX package's and the reference's.
WIDE = "6l48c200"
WIDE_C, WIDE_H, WIDE_PATHS = 48, 200, 12  # 6 blocks x (intra, inter)


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t": round(time.perf_counter() - T_START, 1)}
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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
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


# Sampler steps of a profiled request or folder batch: 6 (of the served 30;
# 10 before the data-parallel phases joined the run), to keep the run under
# 600 s (the profiler's own host work grows with the launches it records: at
# 30 steps the profiles took 60 s more); a step is one backbone call, so the
# breakdown by kernel and the idle share are a call's either way.
PROFILE_N = 6


def profile_request(fdbm, noisy: str, phase: str = "profile", **enhance_kwargs) -> dict:
    """Device time by kernel for one PROFILE_N-step sde_ei request (the last
    serve file), from torch.profiler, and the device's idle share of its
    wall; ``enhance_kwargs`` go to ``FDBM.enhance_batch``."""
    from torch.profiler import ProfilerActivity, profile

    from fdbm_tpu_torch.infer import BUCKET_FRAMES, bucket_length, pad_to
    from fdbm_tpu_torch.utils.audio import read_wav

    audio = read_wav(noisy)[0][0]
    blen = bucket_length(len(audio), fdbm.cfg.hop_length, BUCKET_FRAMES)
    batch = torch.as_tensor(pad_to(audio / np.abs(audio).max(), blen)[None], device="cuda")
    run = lambda: fdbm.enhance_batch(batch, torch.Generator(device="cuda").manual_seed(SEED),
                                     sampler_type="sde_ei", N=PROFILE_N, **enhance_kwargs)
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
    return {"phase": phase, "request": f"4 s, sde_ei, N={PROFILE_N}, B=1", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            "busy_by_kind": busy_by_kind(kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3,
                             "share_of_busy": e.self_device_time_total / 1e3 / busy_ms}
                            for e in top]}


# Device kernels by kind, from their names: the convolutions (cuDNN's implicit
# GEMMs, and its FFT convolutions' transforms and pointwise products), the
# products (GEMMs), the reductions, and the elementwise glue (norm arithmetic,
# SiLU, adds, copies and casts).
KERNEL_KINDS = (("convolution", ("conv", "cudnn", "implicit", "winograd", "fft", "xmma",
                                 "pointwise_mult_and_sum")),
                ("matmul", ("gemm", "cutlass", "sm90_", "sm80_", "ampere_", "matmul")),
                ("reduction", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized", "copy", "cat", "index", "fill")))


def busy_by_kind(kernels) -> dict:
    """Device ms and share of busy time by KERNEL_KINDS ("other" for the
    rest), from the profiler's device kernels."""
    ms = {}
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, keys in KERNEL_KINDS if any(w in name for w in keys)), "other")
        ms[kind] = ms.get(kind, 0.0) + e.self_device_time_total / 1e3
    busy = sum(ms.values()) or 1.0
    return {k: {"ms": v, "share": v / busy} for k, v in sorted(ms.items(), key=lambda a: -a[1])}


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


# The stages of kernels 4, 5 and 6 by the names of their kernels: those of
# the cluster design and those of the three-stage design it replaced (PRs
# 6-10), so that this script also reads the parent commit's kernels (run
# from its checkout) for a before/after on one card; a stage that launched
# nothing is left out of a row.
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
    crop [3, L-1], gradients under a cotangent supported on the crop. Rows
    4-6 print their plans and stages, row 4 also the memory one call
    allocates."""
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
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = gridrnn.grid_bilstm_fold(x, *w)
            torch.cuda.synchronize()
            call_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
            err, abs_err = agreement([(got[crop], (want_f + want_b)[crop])])
            stages = kernel_times(lambda: gridrnn.grid_bilstm_fold(x, *w), TRAIN_FWD_STAGES)
            rows["grid_bilstm_fold"].append(dict(
                path=path, shape=[s_len, lines, c], rel_err=err, max_abs_err=abs_err,
                **(train_plans(gridrnn_train, "fold", lines, c, hidden)
                   if "projection" not in stages else {}),
                stages_ms=stages, recurrence_us_per_step=stages["recurrence"] / length * 1e3,
                allocated_mb_per_call=call_mb,
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
    """The cluster plan of kernel 5 (``which`` "fwd"), 6 ("bwd") or 4
    ("fold": kernel 1's plan, no stash) at this shape, with the waves its
    grid takes, and the card's count of clusters at once of every plan that
    fits a block (blocks x lines: count; the H100 counts of
    tests/test_torch_cluster_plans.py)."""
    from fdbm_tpu_torch.ops import gridrnn

    if not hasattr(module, "train_sweep_plan"):  # the three-stage design plans nothing
        return {}
    dev = torch.cuda.current_device()
    if which == "fold":
        plan = gridrnn.fused_plan(lines, c, hidden)
        count = lambda cs, t: gridrnn._card_max_clusters(dev, c, hidden, cs, t)
    else:
        plan = (module.train_fwd_plan if which == "fwd" else module.train_sweep_plan)(lines, c,
                                                                                      hidden)
        count = lambda cs, t: module._card_max_clusters(dev, which, c, hidden, cs, t)
    if which == "bwd":
        tiles, layout = module.SWEEP_LINES, lambda cs, t: module.train_sweep_layout(c, hidden,
                                                                                    cs, t)
    else:
        tiles, layout = gridrnn.FUSED_LINES, lambda cs, t: gridrnn.fused_layout(c, hidden, cs, t)
    counts = {f"{cs}x{t}": count(cs, t)
              for cs in gridrnn.CLUSTERS for t in tiles if layout(cs, t)}
    return {"plan": {**plan._asdict(), "waves": -(-plan.clusters // plan.max_clusters)},
            "max_clusters_by_plan": counts}


def kernel_times(fn, names: dict, calls: int = 3) -> dict:
    """Device time per call of ``fn`` in each of its stages, from
    torch.profiler: ``names`` maps a stage to a substring of its kernels'
    names, or to a tuple of such substrings. A stage's time is the mean over
    the launches the profiler recorded (it may miss one) times its launches
    per call; a stage that launched nothing is left out. The profiler
    sometimes records none of a short kernel's launches in a window, so a
    window that misses a stage is profiled again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        for stage, subs in names.items():
            subs = (subs,) if isinstance(subs, str) else subs
            hits = [e for e in kernels if any(sub in e.key for sub in subs)]
            launches = sum(e.count for e in hits)
            if launches and stage not in times:
                per_call = max(1, round(launches / calls))
                times[stage] = (sum(e.self_device_time_total for e in hits) / 1e3 / launches
                                * per_call)
        if len(times) == len(names):
            break
    return times


def recurrence_time(fn, steps: int, calls: int = 3) -> dict:
    """Device time per call of ``fn`` spent in the forward recurrence
    (``lstm_rec_kernel``), and per step of it."""
    ms = kernel_times(fn, {"rec": "lstm_rec_kernel"}, calls)["rec"]
    return {"recurrence_ms": ms, "recurrence_us_per_step": ms / steps * 1e3}


def tensor_core_ops(library: str, kernel: str) -> dict:
    """The tensor-core instructions (HMMA, HGMMA) in the SASS of each
    function of ``library`` whose name holds ``kernel``, by
    ``cuobjdump --dump-sass``: a kernel meant for the tensor cores that
    holds none multiplies elsewhere."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", library], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if kernel in name:
                counts[name] = 0
        elif name in counts and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


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
    and that request once more under the profiler; then the same request
    with a bf16 serving dtype, launching only kernel 7's and 3's bf16 forms,
    as many as the fp32 request launched. Returns the two requests'
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

    fdbm.dnn.serve_dtype = torch.bfloat16
    fdbm.enhance_audio(y[:16000], gen(), sampler_type="sde_ei", N=2)  # warms the bf16 route
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    enhanced = fdbm.enhance_audio(y, gen(), sampler_type="sde_ei", N=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_bf16 = ops.launch_counts()
    emit({"phase": f"serve_bf16_{WIDE}", "sampler": "sde_ei", "N": 30, "audio_seconds": seconds,
          "samples": int(enhanced.shape[-1]), "wall_seconds": wall,
          "audio_seconds_per_second": seconds / wall, "launches": counts_bf16,
          "finite": bool(np.isfinite(enhanced).all())})
    if enhanced.shape != y.shape or not np.isfinite(enhanced).all():
        fail(f"{WIDE} bf16 serve: shape {enhanced.shape}")
    expect_bf16_like(f"serve_bf16_{WIDE}", counts, counts_bf16,
                     ("bilstm_fused_forward", "frame_attention"))
    return {k: counts[k] + counts_bf16[k] for k in counts}


def wide_train_phase(rng, dev, smi: str) -> dict:
    """6l48c200 training: one step against the all-plain route and float64,
    one bf16 step against float64 (``bf16_grad_phase``, on draws of its own
    so that the phases after it keep theirs), the rate of steady steps, and
    one valid_step. Returns the launches of the main
    path: the steady steps' (kernels 8 and 9) and the validation's
    (kernel 10)."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    per_step = {"lstm_core": 2 * WIDE_PATHS, "lstm_core_bwd": 2 * WIDE_PATHS,
                "grid_fold_train_pair": 0, "grid_fold_train_pair_bwd": 0}
    train_grad_phase(rng, dev, TFGridNet, per_step, f"train_grad_{WIDE}", float64=True)
    wide_bf16_grad_phase(dev, per_step)
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


def wide_bf16_grad_phase(dev, per_step: dict) -> None:
    """6l48c200's bf16 step against float64 (``bf16_grad_phase``), on draws
    of its own so that the phases after it keep theirs."""
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    bf16_grad_phase(np.random.default_rng(SEED + 17), dev, TFGridNet,
                    f"train_grad_bf16_{WIDE}", per_step, init=smooth_qk_)


def synthetic_batch(rng, dev):
    """(x, y) audio [2, 255 * 256]: the crops of one training batch."""
    n = (TRAIN_FRAMES - 1) * 256
    x = 0.3 * np.sin(np.arange(n) * 0.05)[None] * rng.uniform(0.5, 1.0, (TRAIN_BATCH, 1))
    y = x + 0.05 * rng.standard_normal((TRAIN_BATCH, n))
    return tuple(torch.as_tensor(a.astype(np.float32), device=dev) for a in (x, y))


def fdbm_with(backbone, dev, cfg=None, **kw):
    """An FDBM of ``cfg`` (the default config) whose backbone is
    ``backbone(**kw)``, at the config's training and serving dtypes unless
    ``kw`` names them."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig

    fdbm = FDBM(cfg or FDBMConfig(), device="cuda")
    kw.setdefault("train_dtype", fdbm.train_dtype)
    kw.setdefault("serve_dtype", fdbm.serve_dtype)
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
def cudnn_benchmark():
    """cuDNN's benchmark mode on, as the trainer runs (``Trainer.fit``)."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (its default transposed convolution
    does not repeat its bits run to run)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


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


DATA_SAMPLES = 5 * 16000
# configs/config.yaml's sampler steps (sde_ei), which its per-epoch evaluation runs.
FOLDER_N_TRAIN = 5


def write_dataset(tmp: str) -> str:
    """The training phases' synthetic dataset under ``tmp/data`` (written
    once): 6 train and 3 valid pairs of 5 s. Returns its base dir."""
    from fdbm_tpu_torch.utils.audio import write_wav

    base = os.path.join(tmp, "data")
    if os.path.isdir(base):
        return base
    rng = np.random.default_rng(SEED + 7)
    n = DATA_SAMPLES
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
    return base


def train_cli_phase(tmp: str, smi: str, backbone: str = ""):
    """fdbm_tpu_torch.train on a synthetic dataset at the config's own
    operating point, its per-epoch evaluation included (the config's
    num_eval_files: all 3 valid files): train, resume, then serve the last
    slot's EMA weights. Returns the launches over train + resume and the run
    directory. With ``backbone`` set (NCSN++, no evaluation) every kernel of
    the port stays at 0 launches, training and serving."""
    from fdbm_tpu_torch import infer_single, ops, train
    from fdbm_tpu_torch.utils.audio import read_wav

    base = write_dataset(tmp)
    n = DATA_SAMPLES
    root = os.path.dirname(os.path.abspath(__file__))
    args = ["-C", os.path.join(root, "configs", "config.yaml"), f"base_dir={base}",
            f"log_dir={os.path.join(tmp, 'logs' + (f'_{backbone}' if backbone else ''))}",
            f"batch_size={TRAIN_BATCH}", f"num_frames={TRAIN_FRAMES}", "num_workers=2"]
    args += [f"backbone={backbone}", "num_eval_files=0"] if backbone else []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    profile = [] if backbone else ["--profile_steps", str(PROFILE_STEPS[0]),
                                   str(PROFILE_STEPS[1])]
    first_steps, steps = TRAIN_STEPS, TRAIN_STEPS + RESUME_STEPS
    with counting_batches() as batches, contextlib.redirect_stdout(io.StringIO()) as cli_out:
        run = train.main(args + ["--max_steps", str(first_steps)] + profile)
        first = ops.launch_counts()
        train.main(args + ["--max_steps", str(steps), "--resume", run])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    valid = [r["valid_loss"] for r in records if "valid_loss" in r]
    train_loss = [r["train_loss"] for r in records if "train_loss" in r]
    scores = [[r.get(k) for k in ("pesq", "si_sdr", "estoi")] for r in records if "valid_loss" in r]
    ckpts = os.path.join(run, "checkpoints")
    last = torch.load(os.path.join(ckpts, "last.pt"), map_location="cpu", weights_only=True)
    valid_batches = 2 * len(valid)  # 3 valid files at batch 2 per validation
    calls = FOLDER_N_TRAIN * len(batches)  # the evaluations' sampler calls (sde_ei, N=5)
    expected = {"grid_fold_train_pair": RNN_PATHS * steps,
                "grid_fold_train_pair_bwd": RNN_PATHS * steps,
                "grid_bilstm_fold": RNN_PATHS * valid_batches,
                "grid_rnn_seq1_pair": RNN_PATHS * calls,
                "flat_group_norm": RNN_BLOCKS * calls, "frame_attention": RNN_BLOCKS * calls}
    slots = ("last.pt", "best_valid_loss.pt", "meta.json")
    if backbone:
        expected = dict.fromkeys(counts, 0)
    else:
        slots += ("best_pesq.pt", "best_si_sdr.pt")
    ok = (last["train_state"]["step"] == steps and valid and train_loss
          and all(np.isfinite(valid + train_loss))
          and all(os.path.exists(os.path.join(ckpts, f)) for f in slots)
          and all(counts[k] == v for k, v in expected.items())
          and (backbone or (len(batches) == len(valid)
                            and all(s is not None and np.isfinite(s) for r in scores for s in r))))

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
    if backbone:
        served_ok = not any(serve_counts.values())
    else:
        served_ok = min(serve_counts[k] for k in SERVE_KERNELS) > 0 and \
            serve_counts["flat_group_norm"] == serve_counts["frame_attention"]
    ok = ok and served.shape == (1, n) and bool(np.isfinite(served).all()) and served_ok
    logging = None if backbone else cli_logging(run, cli_out.getvalue())
    ok = ok and (backbone or logging["ok"])
    emit({"phase": f"train_{backbone}" if backbone else "train", "backbone": backbone or None,
          "run_logging": logging,
          "steps": steps, "resumed_at": first_steps, "batch": TRAIN_BATCH,
          "frames": TRAIN_FRAMES, "train_files": 6, "valid_files": 3,
          "train_loss": train_loss, "valid_loss": valid, "pesq_si_sdr_estoi": scores,
          "eval_batches": len(batches), "last_step": last["train_state"]["step"],
          "slots": sorted(os.listdir(ckpts)), "wall_seconds": wall,
          "launches": counts, "launches_first_run": first, "expected_launches": expected,
          "served_samples": int(served.shape[-1]), "serve_launches": serve_counts,
          "cli": cli_out.getvalue().strip().splitlines()[-2:], "nvidia_smi": smi})
    if not ok:
        fail(f"train CLI: last step {last['train_state']['step']}, losses {train_loss} "
             f"{valid}, scores {scores}, slots {sorted(os.listdir(ckpts))}, launches "
             f"{counts} (expected {expected}), served {served.shape}")
    return counts, run


# The steady step's milliseconds by rate phase, for the bf16 phases' ratios.
STEP_MS = {}


# The training CLI's --profile_steps window (steps counted from 1): the first
# two steps of the second epoch (3 steps an epoch), so that no validation
# falls inside it.
PROFILE_STEPS = (4, 5)


def cli_logging(run: str, out: str) -> dict:
    """What the training CLI's own run logging shows: from its
    --profile_steps Chrome trace the steps' wall (each ``train_step`` span
    from its launch on the host to its end on the card), the card's busy
    time in them (its kernels) and idle share, and the host's wait for the
    loader (``data.wait`` spans) against the steps' wall; from its output the loader's items by
    path (native decoder or ``read_wav``) and seconds; whether TensorBoard
    event files lie beside ``metrics.jsonl`` (where ``torch.utils.tensorboard``
    imports)."""
    import glob
    import re

    path = os.path.join(run, "profile", "steps_%d-%d.json" % PROFILE_STEPS)
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    spans = lambda cat: [e for e in events if e.get("cat") == cat and e["name"] == "train_step"]
    steps, device_steps = spans("user_annotation"), spans("gpu_user_annotation")
    # Each step from its launch on the host to its end on the card.
    windows = [(h["ts"], max(h["ts"] + h["dur"], d["ts"] + d["dur"]))
               for h, d in zip(sorted(steps, key=lambda e: e["ts"]),
                               sorted(device_steps, key=lambda e: e["ts"]))]
    start = min(w[0] for w in windows)
    wall = sum(b - a for a, b in windows)
    busy = sum(max(0, min(e["ts"] + e["dur"], b) - max(e["ts"], a))
               for e in events if e.get("cat") == "kernel" for a, b in windows)
    wait = [e["dur"] for e in events if e["name"] == "data.wait"]
    cats = {}
    for e in events:
        c = cats.setdefault(e.get("cat"), [0, math.inf, -math.inf])
        c[0] += 1
        c[1] = min(c[1], (e["ts"] - start) / 1e3)
        c[2] = max(c[2], (e["ts"] + e["dur"] - start) / 1e3)
    loaded = re.search(r"\[data\] train items: native (\d+), read_wav (\d+), "
                       r"load seconds ([0-9.]+)", out)
    native, read, load_s = (int(loaded[1]), int(loaded[2]), float(loaded[3])) if loaded \
        else (0, 0, 0.0)
    try:
        import torch.utils.tensorboard  # noqa: F401
        tensorboard = True
    except ImportError:
        tensorboard = False
    tb_files = glob.glob(os.path.join(run, "events.out.tfevents.*"))
    record = {"trace_steps": list(PROFILE_STEPS), "trace_mb": os.path.getsize(path) / 1e6,
              "step_span_ms": [e["dur"] / 1e3 for e in steps],
              "device_step_span_ms": [e["dur"] / 1e3 for e in device_steps],
              "categories_n_first_last_ms": cats,
              "steps_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1 - busy / wall if wall else None,
              "loader_waits": len(wait), "loader_wait_ms": sum(wait) / 1e3,
              "loader_wait_share": sum(wait) / (wall + sum(wait)) if wall else None,
              "items_native": native, "items_read_wav": read,
              "native_share": native / (native + read) if native + read else None,
              "loader_seconds": load_s, "tensorboard_imports": tensorboard,
              "tensorboard_event_files": len(tb_files)}
    # The window opens after step START's batch is fetched: it holds the
    # fetches of the steps after it.
    record["ok"] = (busy > 0 and len(steps) == len(device_steps) == 2
                    and len(wait) >= PROFILE_STEPS[1] - PROFILE_STEPS[0]
                    and native > 0 and bool(tb_files) == tensorboard)
    return record


def train_rate_phase(rng, dev, smi: str, backbone, phase: str = "train_rate", cfg=None,
                     flops=None):
    """Train audio-s/s over steady steps of the full-width model at B=2 and
    256 frames (8.16 audio-s per step), the step time, peak memory, and the
    device idle share and top kernels of one profiled step; ``cfg`` (e.g.
    fine-tuning mode, or bf16 training) replaces the default config;
    ``flops`` (``flops_estimate`` of one step) gives the TFLOP/s the step
    time implies. Returns the model, its train state, the batch and the
    launches of the steady steps."""
    from torch.profiler import ProfilerActivity, profile

    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import TrainState

    torch.manual_seed(SEED)
    fdbm = fdbm_with(backbone, dev, cfg)
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
    STEP_MS[phase] = step_s * 1e3
    emit({"phase": phase, "mode": fdbm.cfg.mode, "compute_dtype": fdbm.cfg.compute_dtype,
          "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "audio_seconds_per_step": audio_per_step, "steps": steps, "step_ms": step_s * 1e3,
          "flops_per_step": flops, "tflops_per_second": flops and flops / step_s / 1e12,
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


# -- fine-tuning: the enhanced bridge through its unrolled ODE-EI sampler ---------------

# configs/config_finetuning.yaml: N=5 ode_ei steps, of which the first N-1 run
# on the serving route without a gradient (kernels 1-3) and the last trains
# (kernels 5-6; kernel 4 in the valid loss).
FT_N = 5
FT_STEPS = 4


def finetune_cfg():
    from fdbm_tpu_torch.model import FDBMConfig

    return FDBMConfig(mode="finetuning", sampler_type="ode_ei", N=FT_N,
                      scheduler_config={"scheduler": "exp", "config": {"gamma": 0.99995}})


def finetune_launches(steps: int, valid_batches: int = 0, eval_calls: int = 0) -> dict:
    """The kernels' launches of fine-tuning steps, fine-tuning valid batches
    and evaluation sampler calls of 5l32c100."""
    serve_calls = (FT_N - 1) * (steps + valid_batches) + eval_calls
    return {"grid_rnn_seq1_pair": RNN_PATHS * serve_calls,
            "flat_group_norm": RNN_BLOCKS * serve_calls,
            "frame_attention": RNN_BLOCKS * serve_calls,
            "grid_bilstm_fold": RNN_PATHS * valid_batches,
            "grid_fold_train_pair": RNN_PATHS * steps,
            "grid_fold_train_pair_bwd": RNN_PATHS * steps}


def finetune_grad_phase(rng, dev) -> dict:
    """One fine-tuning step of 5l32c100 (B=2, 256 frames, N=5 on ``bb``) on
    the same spectrograms, prior draw and weights through the kernel route
    and the all-plain route: the unrolled output, the loss and every leaf's
    gradient. The gate is ``train_grad``'s (loss rel 1e-5, every leaf
    norm-rel 1e-3, floored at 1e-4 of the global norm). The unroll carries
    each call's fp32 rounding into the next call's input, so where that gate
    is missed the two fp32 routes are held against the plain route in
    float64 instead, as 6l48c200's step is (``float64_gate``'s rule: per
    group of leaves within max(F64_FLOOR, F64_K x the plain fp32 route's
    worst), the loss within max(1e-5, F64_K x the plain route's), and the
    plain route with TF32 on must miss). Returns the kernel route's
    launches."""
    from fdbm_tpu_torch import losses, ops
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100

    torch.manual_seed(SEED)
    kernel = fdbm_with(tfgridnet_5l32c100, dev, finetune_cfg())
    plain = fdbm_with(tfgridnet_5l32c100, dev, finetune_cfg(), use_kernels=False)
    plain.dnn.load_state_dict(kernel.dnn.state_dict())
    x, y = (kernel.audio_to_spec(a) for a in synthetic_batch(rng, dev))
    z = complex_like(rng, y)

    def route(fdbm, cdt=torch.complex64):
        params = {n: p for n, p in fdbm.dnn.named_parameters() if p.requires_grad}
        t0 = time.perf_counter()
        out = fdbm._finetune_unrolled(y.to(cdt), z=z.to(cdt))
        loss = losses.compute_loss(fdbm.loss_cfg, out, x.to(cdt))
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return (out.detach(), float(loss.detach()),
                {n: g.double() for n, g in zip(params, grads)}, time.perf_counter() - t0)

    ops.reset_launch_counts()
    out_k, loss_k, g_k, wall_k = route(kernel)
    counts = ops.launch_counts()
    out_p, loss_p, g_p, wall_p = route(plain)
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in g_p.values()))
    rels = {n: grad_rel(g_k[n], g_p[n], 1e-4 * gnorm) for n in g_p}
    worst = max(rels, key=rels.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    record = {"phase": "finetune_grad", "N": FT_N, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
              "out_rel": rel_err(out_k, out_p), "loss": loss_k, "loss_plain": loss_p,
              "loss_rel": loss_rel, "loss_tol": 1e-5, "worst_leaf": worst,
              "worst_grad_rel": rels[worst], "grad_tol": 1e-3, "leaves": len(rels),
              "grad_norm": gnorm, "seconds_kernel_route": wall_k, "seconds_plain_route": wall_p,
              "launches": counts, "expected_launches": finetune_launches(1)}
    ok = loss_rel < 1e-5 and rels[worst] < 1e-3
    record["gate"] = "fp32"
    if not ok:
        record["gate"] = "float64"
        with tf32_on():
            out_t, loss_t, g_t, _ = route(plain)
        net64 = tfgridnet_5l32c100(use_kernels=False, remat=True).to(dev).double()
        net64.load_state_dict(plain.dnn.state_dict())
        plain.dnn = net64
        out_64, loss_64, g_64, wall_64 = route(plain, torch.complex128)
        del net64
        torch.cuda.empty_cache()
        norm64 = math.sqrt(sum(float((g * g).sum()) for g in g_64.values()))
        groups = {}
        for n in g_64:
            groups.setdefault(leaf_group(n), []).append(n)
        by_group = lambda g: {grp: max(grad_rel(g[n], g_64[n], 1e-4 * norm64) for n in names)
                              for grp, names in groups.items()}
        worst_p, worst_k, worst_t = by_group(g_p), by_group(g_k), by_group(g_t)
        limits = {grp: max(F64_FLOOR, F64_K * v) for grp, v in worst_p.items()}
        missed = lambda w: sorted(grp for grp in groups if not w[grp] <= limits[grp])
        lrel = lambda v: abs(v - loss_64) / abs(loss_64)
        loss_limit = max(1e-5, F64_K * lrel(loss_p))
        out64 = out_64.to(torch.complex64)
        record["float64"] = {
            "seconds": wall_64, "grad_norm": norm64, "floor": F64_FLOOR, "k": F64_K,
            "groups": len(groups), "loss_limit": loss_limit,
            "routes": {r: {"out_rel": rel_err(o, out64), "loss_rel": lrel(lv),
                           "worst_group": max(w.items(), key=lambda a: a[1] / limits[a[0]]),
                           "missed": missed(w)[:4]}
                       for r, o, lv, w in (("kernel", out_k, loss_k, worst_k),
                                           ("plain", out_p, loss_p, worst_p),
                                           ("plain_tf32", out_t, loss_t, worst_t))}}
        ok = (not missed(worst_k) and lrel(loss_k) <= loss_limit
              and (bool(missed(worst_t)) or lrel(loss_t) > loss_limit))
    emit(record)
    if not ok:
        fail(f"fine-tuning step: kernel route vs plain route {record}")
    if counts != {**dict.fromkeys(counts, 0), **finetune_launches(1)}:
        fail(f"fine-tuning step launched {counts}, expected {finetune_launches(1)}")
    return counts


def finetune_cli_phase(tmp: str, smi: str, pretrained: str):
    """``python -m fdbm_tpu_torch.train_finetuning -C configs/config_finetuning.yaml``
    from the train phase's run (its ``last`` slot's EMA weights) on the same
    synthetic dataset, the config's own settings (B=2, 256 frames, N=5, its
    num_eval_files: all 3 valid files) for FT_STEPS steps; then its ``last``
    slot served through ``infer_single`` (one file) and ``infer_folder``
    (the 3 valid files, which the ``evaluate`` phase scores). Returns the
    launches of the fine-tuning run and the folder of enhanced files."""
    from fdbm_tpu_torch import infer_folder, infer_single, ops, train_finetuning
    from fdbm_tpu_torch.utils.audio import read_wav

    root = os.path.dirname(os.path.abspath(__file__))
    base = write_dataset(tmp)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_batches() as batches, contextlib.redirect_stdout(io.StringIO()):
        run = train_finetuning.main([
            "-C", os.path.join(root, "configs", "config_finetuning.yaml"), f"ckpt={pretrained}",
            f"base_dir={base}", f"log_dir={os.path.join(tmp, 'ft_logs')}", "num_workers=2",
            "--max_steps", str(FT_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    valid = [r for r in records if "valid_loss" in r]
    train_loss = [r["train_loss"] for r in records if "train_loss" in r]
    ckpts = os.path.join(run, "checkpoints")
    last = torch.load(os.path.join(ckpts, "last.pt"), map_location="cpu", weights_only=True)
    cfg = last["config"]
    samples = sorted(os.listdir(os.path.join(run, "valid_samples")))
    expected = finetune_launches(FT_STEPS, valid_batches=2 * len(valid),
                                 eval_calls=FT_N * len(batches))
    # (the trainer logs train_loss every 10 steps: none in FT_STEPS)
    ok = (len(valid) == len(batches) > 0 and last["train_state"]["step"] == FT_STEPS
          and np.isfinite(train_loss).all()
          and all(np.isfinite([r.get(k, np.nan) for k in ("valid_loss", "pesq", "si_sdr",
                                                          "estoi")]).all() for r in valid)
          and all(os.path.exists(os.path.join(ckpts, f)) for f in
                  ("last.pt", "best_valid_loss.pt", "best_pesq.pt", "best_si_sdr.pt"))
          and (cfg["mode"], cfg["sampler_type"], cfg["N"]) == ("finetuning", "ode_ei", FT_N)
          and len(samples) == 3 * (2 + len(valid))
          and all(counts[k] == v for k, v in expected.items()))

    single = os.path.join(tmp, "ft_enhanced.wav")
    src = os.path.join(base, "valid", "noisy")
    dst = os.path.join(tmp, "ft_enhanced")
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        infer_single.main(["-C", os.path.join(root, "configs", "config_infer_single.yaml"),
                           f"ckpt={run}", f"noisy_file={os.path.join(src, '0.wav')}",
                           f"output_file={single}", "N=5", "sampler_type=ode_ei"])
        stats = infer_folder.main(["-C", os.path.join(root, "configs", "config_infer_folder.yaml"),
                                   f"ckpt={run}", f"test_dir={src}", f"enhanced_dir={dst}",
                                   "N=5", "sampler_type=ode_ei",
                                   "--batch_size", str(FOLDER_BATCH)])
    torch.cuda.synchronize()
    serve = ops.launch_counts()
    outputs = [read_wav(p)[0] for p in [single] + [os.path.join(dst, f) for f in
                                                   sorted(os.listdir(src))]]
    ok = ok and (stats.files == 3 and stats.failures == 0
                 and all(o.shape == (1, DATA_SAMPLES) and np.isfinite(o).all() for o in outputs)
                 and min(serve[k] for k in SERVE_KERNELS) > 0)
    emit({"phase": "finetune", "pretrained": "the train phase's run, slot last (EMA)",
          "steps": FT_STEPS, "N": cfg["N"], "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "train_loss": train_loss,
          "valid": [{k: r.get(k) for k in ("step", "valid_loss", "pesq", "si_sdr", "estoi")}
                    for r in valid],
          "eval_batches": len(batches), "slots": sorted(os.listdir(ckpts)),
          "valid_samples": len(samples), "wall_seconds": wall, "launches": counts,
          "expected_launches": expected, "served_files": stats.files + 1,
          "serve_launches": serve, "nvidia_smi": smi})
    if not ok:
        fail(f"fine-tuning CLI: valid {valid}, train {train_loss}, slots "
             f"{sorted(os.listdir(ckpts))}, samples {samples}, launches {counts} (expected "
             f"{expected}), served {stats.files} files, launches {serve}")
    return counts, dst


def evaluate_phase(tmp: str, enhanced: str) -> None:
    """``python -m fdbm_tpu_torch.evaluate`` on the fine-tuned model's
    enhanced valid files against their clean and noisy references, PESQ on
    the card."""
    from fdbm_tpu_torch import evaluate

    base = write_dataset(tmp)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = evaluate.main(["--clean_dir", os.path.join(base, "valid", "clean"),
                                 "--enhanced_dir", enhanced,
                                 "--noisy_dir", os.path.join(base, "valid", "noisy")])
    wall = time.perf_counter() - t0
    emit({"phase": "evaluate", "summary": summary, "wall_seconds": wall})
    metrics = ("si_sdr", "estoi", "pesq", "si_sir", "si_sar")
    if not (summary["files"] == 3 and summary["missing_refs"] == 0
            and all(summary[k]["n"] == 3 and np.isfinite(summary[k]["mean"]) for k in metrics)):
        fail(f"evaluate: {summary}")


def speechlike(seconds: float, seed: int) -> np.ndarray:
    """A gated harmonic voice with formants (the PESQ tests' carrier)."""
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * np.cumsum(120 * (1 + 0.1 * np.sin(2 * np.pi * 2.1 * t))) / 16000
    sig = sum((np.exp(-((120 * k - 500) / 350) ** 2) + 0.7 * np.exp(-((120 * k - 1500) / 500) ** 2))
              * np.sin(k * phase) for k in range(1, 25))
    gate = (np.sin(2 * np.pi * 4 * t) > -0.3) * (np.sin(2 * np.pi * 0.7 * t + seed) > -0.5)
    return (0.05 * sig * gate).astype(np.float32)


def losses_card_phase(rng, dev) -> None:
    """Every ``loss_type`` (with ``pesq_weight`` 0.1 on the two that take it)
    on the spectrograms of a speech-like target and its noisy copy (B=2, 256
    frames) on the card, against the same on the CPU in float64 (the PESQ
    term computes in fp32 there too), within rel 1e-5; ``pesq_mos`` of 4 s
    pairs on the card against the CPU within 1e-4 MOS; the PESQ term's
    gradient with respect to the estimate, finite and nonzero; and one
    5l32c100 training step with ``pesq_weight`` 0.1, finite, with the PESQ
    term's share of its gradient printed (on random weights the output is
    far from the target, where P.862's clamp of each frame's disturbance at
    45 can leave the term no gradient)."""
    from fdbm_tpu_torch import losses, ops, pesq_loss
    from fdbm_tpu_torch.model import FDBMConfig, TrainState
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100

    cfg = FDBMConfig()
    fdbm = fdbm_with(tfgridnet_5l32c100, dev, cfg)
    n = (TRAIN_FRAMES - 1) * cfg.hop_length
    clean = np.stack([speechlike(n / cfg.sr, s) for s in range(TRAIN_BATCH)])
    noisy = clean + 0.003 * rng.standard_normal(clean.shape)
    x_audio, y_audio = (torch.as_tensor(a.astype(np.float32), device=dev) for a in (clean, noisy))
    x, x_hat = fdbm.audio_to_spec(x_audio), fdbm.audio_to_spec(y_audio)
    rows = {}
    for loss_type, pesq_weight in (("data_prediction", 0.0), ("data_prediction", 0.1),
                                   ("data_prediction_hybrid", 0.0),
                                   ("data_prediction_hybrid", 0.1),
                                   ("data_prediction_mel", 0.0), ("data_prediction_melphase", 0.0)):
        lcfg = dataclasses.replace(fdbm.loss_cfg, loss_type=loss_type, pesq_weight=pesq_weight)
        card = float(losses.compute_loss(lcfg, x_hat, x))
        cpu = float(losses.compute_loss(lcfg, x_hat.cpu().to(torch.complex128),
                                        x.cpu().to(torch.complex128)))
        rows[f"{loss_type}+pesq{pesq_weight}"] = {"card": card, "cpu_float64": cpu,
                                                  "rel": abs(card - cpu) / abs(cpu)}
    ref = np.stack([speechlike(4.0, s) for s in range(3)])
    deg = ref + np.array([0.01, 0.003, 0.03])[:, None] * rng.standard_normal(ref.shape)
    ref_t, deg_t = torch.as_tensor(ref), torch.as_tensor(deg.astype(np.float32))
    mos_card = pesq_loss.pesq_mos(ref_t.to(dev), deg_t.to(dev)).cpu().numpy()
    mos_cpu = pesq_loss.pesq_mos(ref_t, deg_t).numpy()
    mos_ms = timed_ms(lambda: pesq_loss.pesq_mos(ref_t.to(dev), deg_t.to(dev)), 5)

    with_pesq = dataclasses.replace(fdbm.loss_cfg, pesq_weight=0.1)
    est = x_hat.clone().requires_grad_(True)
    term = losses.compute_loss(with_pesq, est, x) - losses.compute_loss(fdbm.loss_cfg, est, x)
    (term_grad,) = torch.autograd.grad(term, est)
    term_grad_norm = float(term_grad.abs().norm())

    pesq_fdbm = fdbm_with(tfgridnet_5l32c100, dev, dataclasses.replace(cfg, pesq_weight=0.1))
    pesq_fdbm.dnn.load_state_dict(fdbm.dnn.state_dict())
    t = torch.tensor([0.3, 0.8], device=dev)
    z = complex_like(rng, x)
    grads = []
    for model in (pesq_fdbm, fdbm):
        state = TrainState(model.dnn)
        loss = model.loss_fn((x_audio, y_audio), prior=(t, z))
        grads.append(torch.autograd.grad(loss, list(state.params.values())))
    model_term_norm = math.sqrt(sum(float(((a - b).double() ** 2).sum()) for a, b in zip(*grads)))
    state = TrainState(pesq_fdbm.dnn)
    step = pesq_fdbm.train_step(state, (x_audio, y_audio),
                                torch.Generator(device=dev).manual_seed(SEED))
    emit({"phase": "losses_card", "shape": list(x.shape), "losses": rows, "tol": 1e-5,
          "pesq_mos_card": mos_card.tolist(), "pesq_mos_cpu": mos_cpu.tolist(),
          "pesq_mos_max_abs": float(np.abs(mos_card - mos_cpu).max()), "pesq_mos_tol": 1e-4,
          "pesq_mos_ms_3x4s": mos_ms, "pesq_term_grad_norm_wrt_estimate": term_grad_norm,
          "pesq_term_grad_norm_through_model": model_term_norm,
          "pesq_step": {k: step[k] for k in ("train_loss", "grad_norm")}})
    finite = bool(torch.isfinite(torch.view_as_real(term_grad)).all())
    if not (all(r["rel"] < 1e-5 for r in rows.values())
            and float(np.abs(mos_card - mos_cpu).max()) < 1e-4 and finite
            and term_grad_norm > 0 and np.isfinite(model_term_norm)
            and np.isfinite([step["train_loss"], step["grad_norm"]]).all()):
        fail(f"losses on the card: {rows}, MOS {mos_card} vs {mos_cpu}, PESQ term gradient "
             f"norm {term_grad_norm} (finite {finite}), through the model {model_term_norm}, "
             f"step {step}")


def complex_like(rng, like: torch.Tensor) -> torch.Tensor:
    """CN(0, 1) noise of ``like``'s shape from ``rng``, on its device."""
    return torch.complex(*(torch.as_tensor(rng.standard_normal(tuple(like.shape))
                                           .astype(np.float32) / math.sqrt(2),
                                           device=like.device) for _ in range(2)))


# -- the folder's batch shape and the serving surface of folders ---------------------

# The folder CLI's batch: 16 rows of one pooled 4.096 s chunk (257 frames).
FOLDER_BATCH = 16
CHUNK_SAMPLES = 65536
# 16 files of 1-12 s and one of 35 s: more than two full B=16 batches of
# pooled chunks, so that batches overlap in the serving pipeline (40 files,
# then 30, before the bf16 folder and the data-parallel phases joined the
# run: fewer files keep it with a fresh build under 650 s; a smaller folder
# reads a lower rate).
FOLDER_FILES, FOLDER_LONG_SECONDS = 16, 35.0
FOLDER_N = 30
# ode_int's attempted steps held against the plain route (samplers_phase).
ODE_INT_STEPS = 3
# ode_int_gate: two fp32 routes' step sizes, each on its own step control.
STEP_SIZE_TOL = 1e-2


def kernel_b16_phase(rand, dev, w, c: int, hidden: int, n_head: int, e_dim: int) -> dict:
    """Rows 1-3 at the folder's batch shape: kernel 1 on the canvas
    [16, 263, 263, 32] (16 x 263 lines a direction, a plan of many waves),
    the norms and the attention on [16, 257, 257, 8] (v [..., 32]), each
    against its plain version at its row's tolerance. Returns the rows by
    name for the summary's B=16 columns."""
    from fdbm_tpu_torch.dsp import num_frames_for_length
    from fdbm_tpu_torch.ops import attention as attn_ops, gridrnn

    b = FOLDER_BATCH
    frames = num_frames_for_length(CHUNK_SAMPLES, 512, 256)
    q_bins = 257
    s_len, p_len = q_bins + 6, frames + 6
    length = s_len - 3
    rows = {}
    x = rand(b, s_len, p_len, c, s=0.5)
    got = gridrnn.grid_rnn_seq1_pair(x, *w)
    want = gridrnn.grid_rnn_seq1_pair_plain(x, *w)
    err, abs_err = agreement([(g[:, 3:length], r[:, 3:length]) for g, r in zip(got, want)])
    del got, want
    lines = b * p_len
    plan = gridrnn.fused_plan(lines, c, hidden)
    flops = 2 * lines * length * 2 * (4 * c * 4 * hidden + hidden * 4 * hidden + hidden * 4 * c)
    nbytes = 4 * (3 * x.numel() + sum(t.numel() for t in w))
    rows["grid_rnn_seq1_pair"] = dict(
        rel_err=err, tol=1e-4, max_abs_err=abs_err, shape=list(x.shape), plan=plan._asdict(),
        waves=math.ceil(plan.clusters / plan.max_clusters),
        stages_ms=kernel_times(lambda: gridrnn.grid_rnn_seq1_pair(x, *w),
                               {"recurrence": "gridrnn_fused_kernel", "fold": "fold_kernel"}),
        ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair(x, *w), 5),
        plain_ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair_plain(x, *w), 1),
        bound=bound(flops, nbytes), library_ms=None)
    del x

    d_dim = c // n_head
    q = rand(b, frames, q_bins, n_head * e_dim)
    k = rand(b, frames, q_bins, n_head * e_dim)
    v = rand(b, frames, q_bins, c)
    norms = tuple((rand(n_head, 1, s=0.3), rand(n_head, wd), rand(n_head, wd))
                  for wd in (e_dim, e_dim, d_dim))
    maps = [(a, *p, wd) for a, p, wd in zip((q, k, v), norms, (e_dim, e_dim, d_dim))]
    plain = lambda: [attn_ops.flat_group_norm_plain(*m[:4], width=m[4]) for m in maps]
    err, abs_err = agreement(list(zip(attn_ops.flat_group_norms(maps), plain())))
    elems = sum(m[0].numel() for m in maps)
    rows["flat_group_norm"] = dict(
        rel_err=err, tol=1e-5, max_abs_err=abs_err, shape=[list(m[0].shape) for m in maps],
        ms=timed_ms(lambda: attn_ops.flat_group_norms(maps)),
        device_ms=kernel_times(lambda: attn_ops.flat_group_norms(maps),
                               {"norm": "norm_segments_kernel"}).get("norm"),
        plain_ms=timed_ms(plain, 3), bound=bound(10 * elems, 2 * 4 * elems), library_ms=None)

    got = attn_ops.frame_attention(q, k, v, n_head, e_dim)
    want = attn_ops.frame_attention_plain(q, k, v, n_head, e_dim)
    err, abs_err = agreement([(got, want)])
    scale = 1.0 / math.sqrt(e_dim * q_bins)
    to_heads = lambda t, w_: t.reshape(b, frames, q_bins, n_head, w_).permute(
        0, 3, 1, 2, 4).reshape(b, n_head, frames, q_bins * w_)
    qh, kh, vh = to_heads(q, e_dim), to_heads(k, e_dim), to_heads(v, d_dim)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    t2 = b * n_head * frames * frames
    aplan = attn_ops.card_attention_plan(b, frames, q_bins, n_head, e_dim, d_dim)
    rows["frame_attention"] = dict(
        rel_err=err, tol=1e-4, max_abs_err=abs_err, shape=[list(q.shape), list(v.shape)],
        plan=aplan._asdict(),
        waves=math.ceil(aplan.blocks / (aplan.slices * aplan.max_clusters)),
        ms=timed_ms(lambda: attn_ops.frame_attention(q, k, v, n_head, e_dim)),
        plain_ms=timed_ms(lambda: attn_ops.frame_attention_plain(q, k, v, n_head, e_dim), 3),
        bound=bound(2 * t2 * q_bins * (e_dim + d_dim) + 5 * t2,
                    4 * (q.numel() + k.numel() + 2 * v.numel())),
        library_ms=timed_ms(sdpa))
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        emit({"phase": "kernel_b16", "name": name, "batch": b, **r})
        if not r["rel_err"] < r["tol"]:
            fail(f"{name} at B={b} disagrees with its plain version: rel {r['rel_err']}")
    return rows


def serve_batch_check(fdbm, plain, dev) -> None:
    """A 2-step sde_ei at the folder's batch shape (16 rows of 4.096 s) with
    injected noise: the kernel route against the plain route, and one row of
    the batch against the same row served alone at B=1 on the same noise
    (a plan that mixed or dropped lines of the batch would show here)."""
    from fdbm_tpu_torch import ops

    rng = np.random.default_rng(SEED + 16)
    audio = torch.as_tensor((0.3 * rng.standard_normal((FOLDER_BATCH, CHUNK_SAMPLES))).astype(
        np.float32), device=dev)
    y = fdbm.audio_to_spec(audio)
    shape = (3, *y.shape)
    noise = torch.complex(torch.as_tensor(rng.standard_normal(shape).astype(np.float32)),
                          torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
                          ).to(dev) / math.sqrt(2.0)
    run = lambda model, yy, nn: model.enhance_spec(yy, sampler_type="sde_ei", N=2, noise=nn)
    ops.reset_launch_counts()
    got = run(fdbm, y, noise)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    err = rel_err(got, run(plain, y, noise))
    row = 9
    row_err = rel_err(got[row:row + 1], run(fdbm, y[row:row + 1], noise[:, row:row + 1]))
    emit({"phase": "serve_batch_check", "sampler": "sde_ei", "N": 2, "batch": FOLDER_BATCH,
          "frames": y.shape[-1], "rel_err": err, "row": row, "row_rel_err": row_err,
          "tol": 1e-4, "launches": counts})
    expected = {"grid_rnn_seq1_pair": 2 * 2 * RNN_BLOCKS, "flat_group_norm": 2 * RNN_BLOCKS,
                "frame_attention": 2 * RNN_BLOCKS}
    if not (err < 1e-4 and row_err < 1e-4) or any(counts[k] != n for k, n in expected.items()):
        fail(f"serve at B={FOLDER_BATCH}: rel {err}, row {row} alone rel {row_err}, "
             f"launches {counts} (expected {expected})")


@contextlib.contextmanager
def counting_batches():
    """Counts the batches ``FDBM.enhance_batch`` enhances while it is open."""
    from fdbm_tpu_torch.model import FDBM

    calls = []
    enhance = FDBM.enhance_batch

    def counted(self, y_audio, *args, **kwargs):
        calls.append(tuple(y_audio.shape))
        return enhance(self, y_audio, *args, **kwargs)

    FDBM.enhance_batch = counted
    try:
        yield calls
    finally:
        FDBM.enhance_batch = enhance


def write_folder(root: str, seconds) -> dict:
    """Noisy wavs of the given lengths under ``root`` (every fifth in a
    subfolder); returns their samples by path relative to ``root``."""
    from fdbm_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(SEED + 40)
    lengths = {}
    for i, s in enumerate(seconds):
        rel = os.path.join("sub" if i % 5 == 4 else "", f"utt_{i:03d}.wav")
        n = int(s * 16000)
        wav = 0.1 * rng.standard_normal(n) + 0.3 * np.sin(np.arange(n) * rng.uniform(0.01, 0.1))
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        write_wav(os.path.join(root, rel), wav.astype(np.float32), 16000)
        lengths[rel] = n
    return lengths


def profile_batch(fdbm, n_steps: int = PROFILE_N, **enhance_kwargs) -> dict:
    """Device busy time and idle share of one folder batch (16 rows of one
    4.096 s chunk, sde_ei at ``n_steps``) under torch.profiler, its time by
    kind of kernel and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 17)
    batch = torch.as_tensor((0.3 * rng.standard_normal((FOLDER_BATCH, CHUNK_SAMPLES))).astype(
        np.float32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    run = lambda: fdbm.enhance_batch(batch, gen, sampler_type="sde_ei", N=n_steps,
                                     **enhance_kwargs)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        fail("profile_batch: the profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    audio = FOLDER_BATCH * CHUNK_SAMPLES / 16000
    # The attention (attn_kernel, attn_mma_kernel) and its q/k/v norms
    # (norm_segments_kernel), each launched once an attention call.
    attention = [e for e in kernels if "attn_" in e.key]
    norms = [e for e in kernels if "norm_segments_kernel" in e.key]
    return {"batch": FOLDER_BATCH, "samples": CHUNK_SAMPLES, "N": n_steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            "audio_seconds_per_second": audio / (wall_ms / 1e3),
            "attention_share_of_busy": sum(e.self_device_time_total for e in attention) / 1e3
            / busy_ms,
            "norm_share_of_busy": sum(e.self_device_time_total for e in norms) / 1e3 / busy_ms,
            "attention_launches": sum(e.count for e in attention),
            "norm_launches": sum(e.count for e in norms),
            "busy_by_kind": busy_by_kind(kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3,
                             "share_of_busy": e.self_device_time_total / 1e3 / busy_ms}
                            for e in top]}


SERVE_CALL_LAUNCHES = {"grid_rnn_seq1_pair": 2 * RNN_BLOCKS, "flat_group_norm": RNN_BLOCKS,
                       "frame_attention": RNN_BLOCKS}


def serve_folder(tmp: str, ckpt: str, name: str, seconds, chunk_seconds: str, smi: str,
                 profile_fdbm=None, per_call: dict = SERVE_CALL_LAUNCHES,
                 profile_kwargs: dict = None, extra=(), trace: bool = False) -> dict:
    """The folder CLI (``fdbm_tpu_torch.infer_folder.main``) on a folder of
    the given lengths, 30-step sde_ei at --batch_size 16: every file written
    at its input length and finite, no failures, and per enhanced batch one
    backbone call a step, each launching ``per_call`` (5l32c100: 10 RNN
    paths, 5 norms, 5 attentions). ``extra`` are more config overrides
    (``inference_dtype=bfloat16``). With ``trace`` the run sets
    ``FDBM_TPU_SERVE_TRACE=1`` and must print one ``[serve]`` line a batch.
    Returns the launches."""
    from fdbm_tpu_torch import infer_folder, ops
    from fdbm_tpu_torch.utils.audio import read_wav

    src, dst = os.path.join(tmp, name), os.path.join(tmp, name + "_enhanced")
    lengths = write_folder(src, seconds)
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "config_infer_folder.yaml")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    if trace:
        os.environ["FDBM_TPU_SERVE_TRACE"] = "1"
    try:
        with counting_batches() as batches, contextlib.redirect_stdout(io.StringIO()) as out:
            stats = infer_folder.main(["-C", config, f"ckpt={ckpt}", f"test_dir={src}",
                                       f"enhanced_dir={dst}", f"N={FOLDER_N}",
                                       "sampler_type=sde_ei", "--batch_size", str(FOLDER_BATCH),
                                       "--chunk_seconds", chunk_seconds, *extra])
    finally:
        os.environ.pop("FDBM_TPU_SERVE_TRACE", None)
    torch.cuda.synchronize()
    trace_lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[serve]")]
    counts = ops.launch_counts()
    calls = FOLDER_N * len(batches)
    expected = {k: v * calls for k, v in per_call.items()}
    bad = []
    for rel, n in lengths.items():
        path = os.path.join(dst, rel)
        if not os.path.exists(path):
            bad.append((rel, "missing"))
            continue
        x, sr = read_wav(path)
        if x.shape != (1, n) or sr != 16000 or not np.isfinite(x).all():
            bad.append((rel, x.shape))
    record = {"phase": name, "overrides": list(extra),
              "chunk_seconds": float(chunk_seconds), "batch_size": FOLDER_BATCH,
              "sampler": "sde_ei", "N": FOLDER_N, "files": stats.files,
              "failures": stats.failures, "audio_seconds": stats.audio_seconds,
              "wall_seconds": stats.wall_seconds, "prewarm_seconds": stats.prewarm_seconds,
              "read_seconds": stats.read_seconds, "enhance_seconds": stats.enhance_seconds,
              "write_drain_seconds": stats.write_drain_seconds,
              "audio_sec_per_sec": stats.throughput,
              "steady_audio_sec_per_sec": stats.steady_throughput,
              "batches": len(batches), "batch_shapes": sorted(set(batches)),
              "launches": counts, "expected_launches": expected,
              "serve_trace_lines": len(trace_lines) if trace else None,
              "serve_trace_last": trace_lines[-1:],
              "cli": out.getvalue().strip().splitlines()[-1:], "nvidia_smi": smi}
    if profile_fdbm is not None:
        record["profiled_batch"] = profile_batch(profile_fdbm, **(profile_kwargs or {}))
    emit(record)
    if bad or stats.failures or stats.files != len(lengths) or \
            any(counts[k] != v for k, v in expected.items()) or \
            (trace and len(trace_lines) != len(batches)):
        fail(f"{name}: files {stats.files}/{len(lengths)}, failures {stats.failures}, "
             f"bad outputs {bad[:5]}, launches {counts} (expected {expected}), serve trace "
             f"lines {len(trace_lines)} for {len(batches)} batches")
    return counts


def folder_seconds() -> list:
    """The serve folder's lengths: FOLDER_FILES of 1-12 s and one long file."""
    rng = np.random.default_rng(SEED + 41)
    return list(rng.uniform(1.0, 12.0, FOLDER_FILES)) + [FOLDER_LONG_SECONDS]


def serve_folder_bf16(tmp: str, ckpt: str, smi: str) -> dict:
    """The serve folder at ``inference_dtype=bfloat16``, pooled, with one
    profiled bf16 batch: per batch a step launches only the bf16 forms."""
    from fdbm_tpu_torch.checkpoint import load_checkpoint

    return serve_folder(tmp, ckpt, "serve_folder_bf16", folder_seconds(), "4.096", smi,
                        per_call=BF16_CALL_LAUNCHES, extra=(BF16_OVERRIDE,),
                        profile_fdbm=load_checkpoint(ckpt, device="cuda",
                                                     overrides={"inference_dtype": "bfloat16"}))


def serve_cli(tmp: str, ckpt: str, phase: str, requests, smi: str, seed: int = SEED,
              extra=()):
    """Each (seconds, sampler, N) of ``requests`` written as a wav (its noise
    from ``seed`` + its index) and served through
    ``fdbm_tpu_torch.infer_single`` with the config overrides ``extra``: the
    output at the input's length and rate, and finite. One record a request
    and the rate of the 30-step ones (``{phase}_rate``). Returns each
    request's launches and its file's path."""
    from fdbm_tpu_torch import infer_single, ops
    from fdbm_tpu_torch.utils.audio import read_wav, write_wav

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "config_infer_single.yaml")
    launches, files = [], []
    rate_audio = rate_wall = 0.0
    for i, (seconds, sampler, n_steps) in enumerate(requests):
        n = int(seconds * 16000)
        noisy = os.path.join(tmp, f"noisy_{seed + i}.wav")
        out_file = os.path.join(tmp, f"{phase}_enhanced_{i}.wav")
        files.append(noisy)
        if not os.path.exists(noisy):
            wav = np.random.default_rng(seed + i).standard_normal(n).astype(np.float32)
            write_wav(noisy, 0.1 * wav + 0.3 * np.sin(np.arange(n) * 0.05), 16000)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as cli_out:
            infer_single.main(["-C", config, f"ckpt={ckpt}", f"noisy_file={noisy}",
                               f"output_file={out_file}", f"N={n_steps}",
                               f"sampler_type={sampler}", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(ops.launch_counts())
        enhanced, sr = read_wav(out_file)
        finite = bool(np.isfinite(enhanced).all())
        emit({"phase": phase, "request": i, "overrides": list(extra), "sampler": sampler,
              "N": n_steps, "audio_seconds": seconds, "samples": int(enhanced.shape[-1]),
              "wall_seconds": wall, "audio_seconds_per_second": seconds / wall,
              "launches": launches[-1], "finite": finite, "cli": cli_out.getvalue().strip(),
              "nvidia_smi": smi})
        if enhanced.shape != (1, n) or sr != 16000 or not finite:
            fail(f"{phase} request {i}: shape {enhanced.shape}, sr {sr}, finite {finite}")
        if n_steps == 30:
            rate_audio += seconds
            rate_wall += wall
    emit({"phase": f"{phase}_rate", "N": 30, "audio_seconds": rate_audio,
          "wall_seconds": rate_wall, "audio_seconds_per_second": rate_audio / rate_wall})
    return launches, files


def expect_bf16_like(name: str, fp32: dict, bf16: dict, kernels) -> None:
    """A bf16 serve launched only the bf16 forms of ``kernels``, each as
    many times as the same serve in fp32 launched its fp32 form (at least
    once)."""
    expected = {BF16_FORMS[k]: fp32[k] for k in kernels}
    if not (only_bf16(bf16, expected) and min(expected.values()) > 0):
        fail(f"{name}: bf16 launches {bf16}, expected {expected} (the fp32 serve's)")


def serve_phase(tmp: str, ckpt: str, smi: str):
    """The main path through the single-file CLI: the SERVE_REQUESTS files
    in fp32 (each launching kernels 1-3, as many norms as attentions), then
    at ``inference_dtype=bfloat16`` (only the bf16 forms, as many as fp32
    launched), and one profiled 4 s request in each dtype. Returns the
    launches of all six requests and the 4 s file's path."""
    from fdbm_tpu_torch.checkpoint import load_checkpoint

    fp32, files = serve_cli(tmp, ckpt, "serve", SERVE_REQUESTS, smi)
    noisy = files[-1]
    bf16, _ = serve_cli(tmp, ckpt, "serve_bf16", SERVE_REQUESTS, smi, extra=(BF16_OVERRIDE,))
    totals = {}
    for i, (c32, c16) in enumerate(zip(fp32, bf16)):
        if not (min(c32[k] for k in SERVE_KERNELS) > 0
                and c32["flat_group_norm"] == c32["frame_attention"]):
            fail(f"serve request {i}: launches {c32}")
        expect_bf16_like(f"serve_bf16 request {i}", c32, c16, SERVE_KERNELS)
        for k in c32:
            totals[k] = totals.get(k, 0) + c32[k] + c16[k]
    emit(profile_request(load_checkpoint(ckpt, device="cuda"), noisy))
    emit(profile_request(load_checkpoint(ckpt, device="cuda",
                                         overrides={"inference_dtype": "bfloat16"}),
                         noisy, "profile_bf16"))
    return totals, noisy


def samplers_draws(fdbm, dev) -> dict:
    """The samplers phase's input and draws, in their order: a 2 s file's
    spectrogram ``y``, ``y`` moved by 1e-7 of its mean magnitude, pc's noise
    at N=2 and N=5, and ode_int's prior ``z``."""
    from fdbm_tpu_torch.infer import bucket_length, pad_to

    rng = np.random.default_rng(SEED + 20)
    n = 2 * 16000
    audio = 0.1 * rng.standard_normal(n) + 0.3 * np.sin(np.arange(n) * 0.05)
    audio = pad_to((audio / np.abs(audio).max()).astype(np.float32), bucket_length(n, 256))
    y = fdbm.audio_to_spec(torch.as_tensor(audio[None], device=dev))
    cn = lambda *shape: torch.complex(
        torch.as_tensor(rng.standard_normal(shape).astype(np.float32)),
        torch.as_tensor(rng.standard_normal(shape).astype(np.float32))).to(dev) / math.sqrt(2.0)
    y_moved = y + cn(*y.shape) * 1e-7 * y.abs().mean()
    return {"y": y, "y_moved": y_moved, "noise_2": cn(5, *y.shape), "noise_5": cn(11, *y.shape),
            "z": cn(*y.shape)}


@contextlib.contextmanager
def model_times(net: torch.nn.Module):
    """Records the time of every call of ``net`` (its third argument's
    first row) while it is open: ode_int's attempted steps, seven calls
    each at t + c_i h."""
    times = []
    hook = net.register_forward_pre_hook(lambda _m, args: times.append(float(args[2][0])))
    try:
        yield times
    finally:
        hook.remove()


def step_decisions(times) -> list:
    """ode_int's attempted steps ``(t, h)`` from its model-call times: an
    attempt's first call is at its t, its sixth at t + h."""
    return [(times[i], times[i + 5] - times[i]) for i in range(0, len(times) - 6, 7)]


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """While open, callers of ``module.<name>`` call ``fn``."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def backbone_swapped(name: str, fn):
    """While open, TF-GridNet calls ``fn`` where it calls ``tfgridnet.<name>``."""
    from fdbm_tpu_torch.models import tfgridnet

    return swapped(tfgridnet, name, fn)


def kernel1_fault(fault):
    """While open, the backbone's kernel 1 calls return their forward fold
    changed by ``fault`` (a function of it): the ``samplers`` gate's fault
    controls."""
    from fdbm_tpu_torch.models import tfgridnet

    fn = tfgridnet.grid_rnn_seq1_pair

    def faulty(x, *weights):
        outf, outb = fn(x, *weights)
        return fault(outf), outb

    return backbone_swapped("grid_rnn_seq1_pair", faulty)


def line_dropped(outf: torch.Tensor, line: int = 1) -> torch.Tensor:
    outf = outf.clone()
    outf[:, :, line] = 0
    return outf


@contextlib.contextmanager
def error_norms(record=None, replay=None):
    """While open, ode_int's step control (``sampling._error_norm``) appends
    each attempted step's error norm to the list ``record``, or takes the
    norms of ``replay`` in their order in place of its own, so that two
    routes take the same steps."""
    from fdbm_tpu_torch import sampling

    fn = sampling._error_norm
    replayed = None if replay is None else iter(replay)

    def norm(*args):
        e = fn(*args)
        if record is not None:
            record.append(float(e))
        return e if replayed is None else np.float32(next(replayed))

    sampling._error_norm = norm
    try:
        yield
    finally:
        sampling._error_norm = fn


# The samplers gate's fault controls, each the kernel route on the plain
# route's steps with one fault, each of which must miss the gate's limit:
# kernel 1's forward fold with one line dropped (gross) or scaled by 1 + 1e-3,
# 1e-4 or 1e-5 (fine: the last reads 3x the limit), and TF32 on for every
# cuBLAS and cuDNN call outside the kernels.
ODE_CONTROLS = {
    "dropped_line": lambda: kernel1_fault(line_dropped),
    "scaled_1e-3": lambda: kernel1_fault(lambda f: f * (1 + 1e-3)),
    "scaled_1e-4": lambda: kernel1_fault(lambda f: f * (1 + 1e-4)),
    "scaled_1e-5": lambda: kernel1_fault(lambda f: f * (1 + 1e-5)),
    "tf32": tf32_on,
}


def ode_int_gate(fdbm, plain, draws, run) -> dict:
    """ode_int's first ODE_INT_STEPS attempted steps (rtol = atol = 1e-2),
    held in two parts, on cuDNN's deterministic algorithms (its default
    transposed convolution in ``deconv_out`` does not repeat its bits run to
    run, which moved every reading). Its step control divides each step's
    error estimate, a difference of two nearly equal fifth- and fourth-order
    solutions, by the tolerance: the rounding of two fp32 routes moves the
    estimate by up to about 1e-2 of itself and the step sizes by a fifth of
    that, and the stiff start of the ODE amplifies any difference. So:

    * the step decisions: the kernel route and the plain route, each on
      its own step control, accept the same attempts, and each step size
      agrees within STEP_SIZE_TOL;
    * the outputs, on the plain route's steps (the other runs replay its
      error norms, ``error_norms``): the kernel route within max(1e-3,
      F64_K x the plain route's distance) of the plain network in float64
      (``Float64Backbone``) under the same fp32 sampler, as
      ``wide_serve_check`` holds 6l48c200: the sampler's own fp32
      rounding, which the stiff start amplifies in every route alike, stays
      out of the distances. Every control of ODE_CONTROLS, the kernel route
      with a fault on the same steps, must miss that limit.

    ``run(name, model, spec, count, **kwargs)`` runs one sampler call."""
    first = dict(sampler_type="ode_int", rtol=1e-2, atol=1e-2, z=draws["z"],
                 max_steps=ODE_INT_STEPS)
    twin = float64_twin(plain)
    norms, outs, decisions = {"kernel": [], "plain": []}, {}, {}
    replay = lambda: error_norms(replay=norms["plain"])
    routes = [("kernel", fdbm, [lambda: error_norms(record=norms["kernel"])], True),
              ("plain", plain, [lambda: error_norms(record=norms["plain"])], True),
              ("float64", twin, [replay], True), ("kernel_replayed", fdbm, [replay], True)]
    routes += [(f"control_{name}", fdbm, [replay, fault], False)
               for name, fault in ODE_CONTROLS.items()]
    with cudnn_deterministic():
        for name, model, contexts, count in routes:
            with model_times(model.dnn) as times, contextlib.ExitStack() as stack:
                for context in contexts:
                    stack.enter_context(context())
                outs[name] = run(f"ode_int_steps_{name}", model, draws["y"], count, **first)
            decisions[name] = step_decisions(times)
    del twin
    accepted = {name: [e <= 1.0 for e in norms[name]] for name in ("kernel", "plain")}
    sizes = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(decisions["kernel"],
                                                          decisions["plain"])]
    steps_agree = (accepted["kernel"] == accepted["plain"]
                   and len(decisions["kernel"]) == len(decisions["plain"]) == ODE_INT_STEPS
                   and max(sizes) <= STEP_SIZE_TOL)
    replayed = all(decisions[n] == decisions["plain"] for n in outs if n not in
                   ("kernel", "plain"))
    errs = {name: rel_err(out, outs["float64"]) for name, out in outs.items()
            if name not in ("kernel", "float64")}
    limit = max(1e-3, F64_K * errs["plain"])
    missed = {name: errs[f"control_{name}"] > limit for name in ODE_CONTROLS}
    return {"first_steps": ODE_INT_STEPS, "rtol": 1e-2, "atol": 1e-2, "cudnn_deterministic": True,
            "error_norms": norms, "accepted": accepted, "step_decisions": decisions,
            "step_size_rel_diff": sizes, "step_size_tol": STEP_SIZE_TOL,
            "steps_agree": steps_agree, "replayed_steps": replayed,
            "float64_rel_err": errs, "limit": limit, "controls_missed": missed,
            "rel_err_fp32_routes": rel_err(outs["kernel_replayed"], outs["plain"]),
            "rel_err_own_steps": rel_err(outs["kernel"], outs["plain"]),
            "ok": steps_agree and replayed and errs["kernel_replayed"] <= limit
            and all(missed.values())}


def samplers_phase(fdbm, plain, dev) -> dict:
    """``pc`` and ``ode_int`` on one 2 s file, kernel route against plain
    route on the same draws. On random weights both samplers are chaotic
    after a few steps (the plain route against itself with y moved by 1e-7
    of its mean magnitude: pc at N=5 with euler_maruyama + ald 7e-2 on the
    CPU, at N=2 4e-6), so each is held over its first steps: pc at N=2
    within rel 1e-4 of the plain route, and ode_int's first ODE_INT_STEPS
    attempted steps by their step decisions and then, on the same steps,
    against float64 (``ode_int_gate``). pc at N=5
    (euler_maruyama + ald) and ode_int's full solve (its model calls
    printed) run on the kernel route, pc also on the plain route, with pc's
    agreement printed beside the control; both must be finite. Every run on
    the kernel route must run kernels 1-3. Returns the kernel route's
    launches (the fault control's left out)."""
    from fdbm_tpu_torch import ops

    draws = samplers_draws(fdbm, dev)
    y = draws["y"]
    totals = dict.fromkeys(ops.launch_counts(), 0)
    runs = {}
    finite = lambda t: bool(torch.isfinite(torch.view_as_real(t)).all())

    def run(name, model, spec=y, count=True, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = model.enhance_spec(spec, **kw)
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0, "launches": ops.launch_counts()}
        if model is fdbm and count:
            for k, v in runs[name]["launches"].items():
                totals[k] += v
        return out

    pc = lambda steps: dict(sampler_type="pc", N=steps, predictor_name="euler_maruyama",
                            corrector_name="ald", corrector_steps=1, noise=draws[f"noise_{steps}"])
    first = pc(2)
    pc_first_err = rel_err(run("pc_N2", fdbm, **first), run("pc_N2_plain", plain, **first))
    full = pc(5)
    pc_out = run("pc_N5", fdbm, **full)
    pc_plain = run("pc_N5_plain", plain, **full)
    pc_err = rel_err(pc_out, pc_plain)
    pc_control = rel_err(run("pc_N5_plain_moved", plain, spec=draws["y_moved"], **full),
                         pc_plain)
    ode_out = run("ode_int", fdbm, sampler_type="ode_int", rtol=1e-2, atol=1e-2, z=draws["z"])
    gate = ode_int_gate(fdbm, plain, draws, run)
    nfev = runs["ode_int"]["launches"]["frame_attention"] // RNN_BLOCKS
    emit({"phase": "samplers", "frames": y.shape[-1],
          "pc": {"predictor": "euler_maruyama", "corrector": "ald", "corrector_steps": 1,
                 "N2_rel_err": pc_first_err, "N2_tol": 1e-4, "N5_rel_err": pc_err,
                 "N5_control_rel_err": pc_control, "N5_finite": finite(pc_out)},
          "ode_int": {"rtol": 1e-2, "atol": 1e-2, "model_calls": nfev, "finite": finite(ode_out),
                      "first_steps_gate": gate},
          "runs": runs})
    kernel_runs = [r["launches"] for name, r in runs.items()
                   if "plain" not in name and "float64" not in name]
    if not (pc_first_err < 1e-4 and gate["ok"] and finite(pc_out) and finite(ode_out)) or \
            any(min(c[k] for k in SERVE_KERNELS) == 0 for c in kernel_runs):
        fail(f"samplers: pc N=2 rel {pc_first_err}, ode_int first steps {gate}, runs {runs}")
    return totals


# -- data parallelism: -D / torchrun training, batch-split serving ---------------------

# ddp_nccl: the training CLI under torchrun (one NCCL rank) for DDP_STEPS steps,
# the last two profiled; ddp_two_ranks: two processes on one card over gloo,
# each half of a DDP_BATCH batch, for 2 steps. Their workers start before the
# samplers phase and run beside it on the card (start_ddp_workers); their
# phases wait for them.
DDP_STEPS, DDP_BATCH = 3, 4
WORKER_TIMEOUT = 300
_WORKERS = []


def _kill_workers(procs=_WORKERS) -> None:
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)


atexit.register(_kill_workers)


def start_worker(args) -> subprocess.Popen:
    """``python args...`` in a session of its own (its output to stderr),
    killed with its children at exit if it still runs."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.Popen([sys.executable, *args], env=env, stdout=sys.stderr,
                            stderr=sys.stderr, start_new_session=True)
    _WORKERS.append(proc)
    return proc


def wait_workers(procs, t0: float, name: str, timeout: float = WORKER_TIMEOUT) -> None:
    """Waits for ``procs`` until ``timeout`` seconds after ``t0``; a
    failure or a timeout fails the phase, and none of them outlives it."""
    try:
        rcs = [p.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = ["timeout"]
    finally:
        _kill_workers(procs)
    if any(rc != 0 for rc in rcs):
        fail(f"{name}: workers ended with {rcs}")


def start_ddp_workers(tmp: str) -> dict:
    """Starts the workers of ``ddp_nccl`` (torchrun, one process) and
    ``ddp_two_ranks`` (two processes) on the train phase's dataset."""
    write_dataset(tmp)
    me = os.path.abspath(__file__)
    prefix, store = os.path.join(tmp, "ddp_rank"), os.path.join(tmp, "ddp_store")
    nccl_out = os.path.join(tmp, "ddp_nccl.json")
    return {"t0": time.perf_counter(), "prefix": prefix, "nccl_out": nccl_out,
            "ddp_nccl": [start_worker(["-m", "torch.distributed.run", "--standalone",
                                       "--nproc_per_node", "1", me, "--ddp-nccl-worker",
                                       nccl_out, tmp])],
            "ddp_two_ranks": [start_worker([me, "--ddp-two-ranks-worker", str(r), store,
                                            prefix])
                              for r in range(2)]}


def ddp_nccl_worker(out_path: str, tmp: str) -> None:
    """Under torchrun (one process, NCCL): ``fdbm_tpu_torch.train.main`` on
    the train phase's dataset for DDP_STEPS steps with steps 2-3 profiled
    and ``--nolog``; then, in the same group and on cuDNN's deterministic
    algorithms, 2 steps of ``mesh.data_parallel_train_step`` (global draw,
    one NCCL all-reduce) against 2 of ``FDBM.train_step`` on the same
    weights, batch and generator, without the group's collective. Writes a
    JSON of what the phase checks."""
    import warnings

    from fdbm_tpu_torch import ops, train
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState
    from fdbm_tpu_torch.parallel import distributed, mesh

    t_worker = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize()  # from torchrun's environment; the CLI then keeps the group
    root = os.path.dirname(os.path.abspath(__file__))
    base = write_dataset(tmp)
    args = ["-C", os.path.join(root, "configs", "config.yaml"), f"base_dir={base}",
            f"log_dir={os.path.join(tmp, 'logs_ddp')}", f"batch_size={TRAIN_BATCH}",
            f"num_frames={TRAIN_FRAMES}", "num_workers=2", "num_eval_files=0",
            "--max_steps", str(DDP_STEPS), "--profile_steps", "2", str(DDP_STEPS), "--nolog"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run = train.main(args)
    torch.cuda.synchronize()
    record = {"cli_seconds": time.perf_counter() - t0, "launches": ops.launch_counts(),
              "world": distributed.process_count(), "backend": torch.distributed.get_backend(),
              "device": str(distributed.process_device("cuda")), "run": sorted(os.listdir(run))}
    last = torch.load(os.path.join(run, "checkpoints", "last.pt"), map_location="cpu",
                      weights_only=True)
    record["last_step"] = last["train_state"]["step"]
    trace = os.path.join(run, "profile", f"steps_2-{DDP_STEPS}.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    record["profiled_kernels"] = len(kernels)
    record["nccl_kernels"] = sorted({k[:120] for k in kernels
                                     if "nccl" in k.lower() or "onerank" in k.lower()})

    rng = np.random.default_rng(SEED + 5)
    batches = [synthetic_batch(rng, torch.device("cuda")) for _ in range(2)]
    params = {}
    with cudnn_deterministic(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        for route in ("all_reduce", "alone"):
            torch.manual_seed(SEED)
            fdbm = FDBM(FDBMConfig(), device="cuda")
            state = TrainState(fdbm.dnn)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            for b in batches:
                if route == "all_reduce":
                    mesh.data_parallel_train_step(fdbm, state, b, gen)
                else:
                    fdbm.train_step(state, b, gen)
            params[route] = {**{k: v.clone() for k, v in fdbm.dnn.state_dict().items()},
                             **{"ema." + k: v.clone() for k, v in state.ema.items()}}
        torch.use_deterministic_algorithms(False)
    record["nondeterministic_ops"] = sorted({str(w.message)[:160] for w in caught})
    record["bit_equal_leaves"] = sum(torch.equal(v, params["alone"][k])
                                     for k, v in params["all_reduce"].items())
    record["leaves"] = len(params["all_reduce"])
    record["worker_seconds"] = time.perf_counter() - t_worker
    distributed.shutdown()
    with open(out_path, "w") as f:
        json.dump(record, f)


def ddp_nccl_phase(workers: dict, smi: str) -> dict:
    """The training CLI under ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` (one NCCL rank on the card; ``ddp_nccl_worker``,
    started by ``start_ddp_workers``): kernels 5-6 launch on every step and
    kernel 4 in the valid loss, the profiled steps show NCCL's all-reduce
    kernel (on one rank NCCL's average launches its one-rank reduce),
    process 0 writes the run (no code snapshot with ``--nolog``), and the
    parameters and EMA after 2 data-parallel steps equal, bit for bit,
    those of 2 steps without the collective. Returns the CLI's launches."""
    wait_workers(workers["ddp_nccl"], workers["t0"], "ddp_nccl")
    with open(workers["nccl_out"]) as f:
        record = json.load(f)
    valid_batches = 2  # 3 valid files at batch 2
    expected = {"grid_fold_train_pair": RNN_PATHS * DDP_STEPS,
                "grid_fold_train_pair_bwd": RNN_PATHS * DDP_STEPS,
                "grid_bilstm_fold": RNN_PATHS * valid_batches}
    emit({"phase": "ddp_nccl", **record, "expected_launches": expected, "nvidia_smi": smi})
    launches = record["launches"]
    ok = (record["world"] == 1 and record["backend"] == "nccl"
          and record["last_step"] == DDP_STEPS and record["nccl_kernels"]
          and all(launches[k] == v for k, v in expected.items())
          and "code" not in record["run"] and "profile" in record["run"]
          and record["bit_equal_leaves"] == record["leaves"])
    if not ok:
        fail(f"ddp_nccl: {record}")
    return launches


def ddp_two_ranks_worker(rank: int, store: str, out_prefix: str) -> None:
    """Process ``rank`` of two on cuda:0 over gloo: 5l32c100 from seed 0, its
    half of a DDP_BATCH batch, step 1's all-reduced loss and gradients
    (``mesh.data_parallel_grads``, the global batch's (t, z) drawn from the
    generator and sliced), then step 2 (``data_parallel_train_step``).
    Writes the loss, the gradients, the parameters, the EMA weights and the
    launches."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState
    from fdbm_tpu_torch.parallel import distributed, mesh

    t_worker = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"file://{store}", 2, rank, backend="gloo")
    dev = torch.device("cuda", 0)
    torch.manual_seed(SEED)
    fdbm = FDBM(FDBMConfig(), device=dev)
    state = TrainState(fdbm.dnn)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = ddp_batch(dev)
    local = mesh.shard_batch(batch, rank, 2)
    ops.reset_launch_counts()
    loss, grads = mesh.data_parallel_grads(fdbm, state, local, gen)
    fdbm.apply_gradients(state, grads)
    grads = {k: v.cpu() for k, v in grads.items()}
    mesh.data_parallel_train_step(fdbm, state, local, gen)
    torch.cuda.synchronize()
    torch.save({"loss": loss, "grads": grads, "launches": ops.launch_counts(),
                "params": {k: v.cpu() for k, v in fdbm.dnn.state_dict().items()},
                "ema": {k: v.cpu() for k, v in state.ema.items()},
                "seconds": time.perf_counter() - t_worker}, f"{out_prefix}.{rank}.pt")
    distributed.shutdown()


def ddp_batch(dev):
    """The two-rank phase's global batch: DDP_BATCH crops of 256 frames."""
    rng = np.random.default_rng(SEED + 6)
    n = (TRAIN_FRAMES - 1) * 256
    x = 0.3 * np.sin(np.arange(n) * 0.05)[None] * rng.uniform(0.5, 1.0, (DDP_BATCH, 1))
    y = x + 0.05 * rng.standard_normal((DDP_BATCH, n))
    return tuple(torch.as_tensor(a.astype(np.float32), device=dev) for a in (x, y))


def ddp_two_ranks_phase(workers: dict, dev) -> dict:
    """Two processes on cuda:0 joined over gloo (gloo all-reduces CUDA
    tensors through the host; NCCL puts no two ranks on one card), each
    taking half of a DDP_BATCH batch (``ddp_two_ranks_worker``, started by
    ``start_ddp_workers``), against this process on the whole batch with
    the same generator, so the same (t, z): ``train_grad``'s gate on step 1
    (loss rel < 1e-5, every gradient norm-rel < 1e-3, floor 1e-4 of the
    global norm), both ranks' parameters and EMA weights equal after 2
    steps, kernels 5-6 launched on each rank. Returns the ranks' launches."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState

    wait_workers(workers["ddp_two_ranks"], workers["t0"], "ddp_two_ranks")
    ranks = [torch.load(f"{workers['prefix']}.{r}.pt", weights_only=True) for r in range(2)]

    torch.manual_seed(SEED)
    fdbm = FDBM(FDBMConfig(), device=dev)
    state = TrainState(fdbm.dnn)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    loss = fdbm.loss_fn(ddp_batch(dev), gen)
    want = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    loss = float(loss.detach())
    del fdbm, state
    norm = math.sqrt(sum(float((g * g).sum()) for g in want.values()))
    errs = {k: grad_rel(ranks[0]["grads"][k].to(dev), g, 1e-4 * norm) for k, g in want.items()}
    worst = sorted(errs, key=errs.get)[-3:][::-1]
    loss_rel = abs(ranks[0]["loss"] - loss) / abs(loss)
    same = all(torch.equal(ranks[0][part][k], ranks[1][part][k])
               for part in ("params", "ema") for k in ranks[0][part])
    launches = [r["launches"] for r in ranks]
    emit({"phase": "ddp_two_ranks", "backend": "gloo", "devices": ["cuda:0", "cuda:0"],
          "batch": DDP_BATCH, "frames": TRAIN_FRAMES, "loss": ranks[0]["loss"],
          "loss_one_process": loss, "loss_rel": loss_rel,
          "worst_grad_rel": [(k, errs[k]) for k in worst], "tol": 1e-3,
          "ranks_equal_after_2_steps": same, "launches": launches,
          "worker_seconds": [r["seconds"] for r in ranks]})
    if not (loss_rel < 1e-5 and errs[worst[0]] < 1e-3 and same
            and all(c[k] == 2 * RNN_PATHS for c in launches
                    for k in ("grid_fold_train_pair", "grid_fold_train_pair_bwd"))):
        fail(f"ddp_two_ranks: loss rel {loss_rel}, worst gradients {worst}, ranks equal "
             f"{same}, launches {launches}")
    totals = {}
    for c in launches:
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    return totals


MESH_FOLDER_SECONDS = (1.5, 2.5, 3.5, 4.5)


def mesh_serve_phase(tmp: str, ckpt: str, fdbm, dev, smi: str) -> dict:
    """Batch-split serving on the one card: a 2-step sde_ei serve of a
    FOLDER_BATCH batch of 4.096 s chunks split over two replicas on cuda:0
    (``mesh.make_parallel_enhance``: the draws made for the whole batch,
    each replica sampling 8 rows on its own host thread) against the
    unsplit batch on the same generator, within ``serve_batch_check``'s
    1e-4; the folder CLI with ``--mesh_devices 1`` on a few files, end to
    end; ``--mesh_devices 2`` must raise (one card). Returns the split
    serve's and the CLI's launches."""
    from fdbm_tpu_torch import infer_folder, ops
    from fdbm_tpu_torch.parallel import mesh

    rng = np.random.default_rng(SEED + 17)
    audio = torch.as_tensor((0.3 * rng.standard_normal((FOLDER_BATCH, CHUNK_SAMPLES))).astype(
        np.float32), device=dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    split = mesh.make_parallel_enhance(fdbm, [dev, dev], "sde_ei", 2)
    want = fdbm.enhance_batch(audio, gen(), sampler_type="sde_ei", N=2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = split(audio, gen())
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    err = rel_err(got, want)
    expected = {k: 2 * 2 * v for k, v in SERVE_CALL_LAUNCHES.items()}  # 2 replicas, 2 steps

    src, dst = os.path.join(tmp, "mesh_folder"), os.path.join(tmp, "mesh_folder_enhanced")
    write_folder(src, MESH_FOLDER_SECONDS)
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "config_infer_folder.yaml")
    cli = ["-C", config, f"ckpt={ckpt}", f"test_dir={src}", f"enhanced_dir={dst}",
           f"N={FOLDER_N_TRAIN}", "sampler_type=sde_ei", "--batch_size", "4"]
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = infer_folder.main(cli + ["--mesh_devices", "1"])
    torch.cuda.synchronize()
    cli_counts = ops.launch_counts()
    try:
        infer_folder.main(cli + ["--mesh_devices", "2"])
        refused = None
    except ValueError as e:
        refused = str(e)
    emit({"phase": "mesh_serve", "devices": [str(dev), str(dev)], "batch": FOLDER_BATCH,
          "samples": CHUNK_SAMPLES, "sampler": "sde_ei", "N": 2, "rel_err": err, "tol": 1e-4,
          "split_seconds": split_s, "launches": counts, "expected_launches": expected,
          "folder_mesh_devices_1": {"files": stats.files, "failures": stats.failures,
                                    "audio_seconds": stats.audio_seconds,
                                    "wall_seconds": stats.wall_seconds,
                                    "launches": cli_counts},
          "mesh_devices_2_refused": refused, "nvidia_smi": smi})
    if not (err < 1e-4 and all(counts[k] == v for k, v in expected.items())
            and stats.files == len(MESH_FOLDER_SECONDS) and stats.failures == 0
            and min(cli_counts[k] for k in SERVE_KERNELS) > 0
            and refused and "Requested 2 devices, have 1" in refused):
        fail(f"mesh_serve: rel {err}, launches {counts} (expected {expected}), folder "
             f"{stats.files} files {stats.failures} failures, --mesh_devices 2: {refused}")
    return {k: counts[k] + cli_counts[k] for k in counts}


def predictive_phase(tmp: str, smi: str, backbone: str = "", steps: int = 4) -> dict:
    """``python -m fdbm_tpu_torch.train -C configs/config_predictive.yaml``
    (tfgridnet_5l32c100_predictive, batch 2 of 256 frames, num_eval_files=0)
    for a few steps on the train phase's synthetic dataset, then its last
    slot served through the folder CLI: training through kernels 5 and 6
    (and 4 for the valid loss), serving through kernels 1-3, one backbone
    call a batch. Returns the launches of both. With ``backbone`` set
    (NCSN++'s twin) every kernel of the port stays at 0 launches."""
    from fdbm_tpu_torch import infer_folder, ops, train
    from fdbm_tpu_torch.utils.audio import read_wav

    root = os.path.dirname(os.path.abspath(__file__))
    base = write_dataset(tmp)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run = train.main(["-C", os.path.join(root, "configs", "config_predictive.yaml"),
                          f"base_dir={base}",
                          f"log_dir={os.path.join(tmp, 'pred_logs' + backbone)}",
                          "num_eval_files=0", f"batch_size={TRAIN_BATCH}",
                          f"num_frames={TRAIN_FRAMES}", "num_workers=2",
                          "--max_steps", str(steps)]
                         + ([f"backbone={backbone}"] if backbone else []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    valid = [r["valid_loss"] for r in records if "valid_loss" in r]
    expected = {"grid_fold_train_pair": RNN_PATHS * steps,
                "grid_fold_train_pair_bwd": RNN_PATHS * steps,
                "grid_bilstm_fold": RNN_PATHS * 2 * len(valid)}  # 3 valid files at batch 2

    src = os.path.join(base, "valid", "noisy")
    dst = os.path.join(tmp, "pred_enhanced" + backbone)
    ops.reset_launch_counts()
    with counting_batches() as batches, contextlib.redirect_stdout(io.StringIO()):
        stats = infer_folder.main(["-C", os.path.join(root, "configs", "config_infer_folder.yaml"),
                                   f"ckpt={run}", f"test_dir={src}", f"enhanced_dir={dst}",
                                   "--batch_size", str(FOLDER_BATCH)])
    torch.cuda.synchronize()
    serve = ops.launch_counts()
    serve_expected = {"grid_rnn_seq1_pair": RNN_PATHS * len(batches),
                      "flat_group_norm": RNN_BLOCKS * len(batches),
                      "frame_attention": RNN_BLOCKS * len(batches)}
    if backbone:
        expected, serve_expected = dict.fromkeys(counts, 0), dict.fromkeys(serve, 0)
    outputs = [read_wav(os.path.join(dst, f))[0] for f in sorted(os.listdir(src))]
    ok = (valid and all(np.isfinite(valid)) and all(counts[k] == v for k, v in expected.items())
          and all(counts[k] == 0 for k in SERVE_KERNELS)
          and stats.files == len(outputs) == 3 and stats.failures == 0
          and all(o.shape == (1, 5 * 16000) and np.isfinite(o).all() for o in outputs)
          and all(serve[k] == v for k, v in serve_expected.items()))
    emit({"phase": f"predictive_{backbone}" if backbone else "predictive",
          "backbone": backbone or "tfgridnet_5l32c100_predictive", "steps": steps,
          "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES, "valid_loss": valid,
          "train_wall_seconds": wall, "launches": counts, "expected_launches": expected,
          "served_files": stats.files, "failures": stats.failures, "batches": len(batches),
          "serve_launches": serve, "expected_serve_launches": serve_expected,
          "nvidia_smi": smi})
    if not ok:
        fail(f"predictive: valid {valid}, launches {counts} (expected {expected}), served "
             f"{stats.files} files with {stats.failures} failures, launches {serve} "
             f"(expected {serve_expected})")
    return {k: counts[k] + serve[k] for k in counts}


# -- NCSN++ (ncsnpp_v2, 65.6M): cuDNN convolutions and plain ops, none of the ten kernels ----

NCSNPP = "ncsnpp_v2"
NCSNPP_SHAPE = (1, 1, 257, 256)  # 4.1 s of audio
NCSNPP_FOLDER_FILES = 10  # 17 pooled chunks: one full B=16 batch and a row
# ncsnpp_v2 served in bf16 against itself in float64 (backbone_bf16).
NCSNPP_BF16_TOL = 3e-2
# One block's conv0 zeroed: the control that must miss the float64 gate.
NCSNPP_CONTROL_LEAF = "down_3_0.conv0.weight"


def fan_in_weights_(net: torch.nn.Module, seed: int = SEED) -> torch.nn.Module:
    """Seeded weights at fan-in scale for every leaf: each kernel
    N(0, 1/fan_in), each bias 0.1 N(0, 1), each GroupNorm scale
    1 + 0.1 N(0, 1), ``time_emb.W`` as initialised. The score-SDE init
    leaves every conv1, attention proj and pyr_conv near 1e-10, on which a
    1e-4 gate cannot see a dropped branch. Drawn where the weights lie,
    from a torch generator seeded with ``seed``."""
    with torch.no_grad():
        params = [(n, p) for n, p in net.named_parameters() if not n.endswith("time_emb.W")]
        gen = torch.Generator(device=params[0][1].device).manual_seed(seed)
        for name, p in params:
            p.normal_(generator=gen)
            if p.ndim >= 2:
                p.mul_(1 / math.sqrt(p[0].numel()))
            elif name.endswith("weight"):
                p.mul_(0.1).add_(1.0)
            else:
                p.mul_(0.1)
    return net


def to_double(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.complex128 if a.is_complex() else torch.float64)


def ncsnpp_backbone_phase(rng, dev) -> None:
    """ncsnpp_v2 at [1, 1, 257, 256], fp32 with TF32 off, against the same
    module in float64 on the card (rel-L2 < 1e-4), a control that must miss
    the gate (one block's conv0 zeroed), the TF32-on reading, row 0 of a
    B=16 call (where cuDNN picks other algorithms, FFT among them) against
    the same float64 output, forward ms at B=1 and B=16 (NCHW,
    channels_last, and with cuDNN's benchmark mode), and the operations
    PyTorch's FlopCounterMode counts from the layer shapes beside the bound
    at the fp32 peak."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    from fdbm_tpu_torch.models.ncsnpp import ncsnpp_v2

    torch.manual_seed(SEED)
    net = fan_in_weights_(ncsnpp_v2()).to(dev).eval()
    net64 = copy.deepcopy(net).double()
    cn = lambda b: torch.complex(*(torch.as_tensor(
        rng.standard_normal((b, *NCSNPP_SHAPE[1:])).astype(np.float32), device=dev)
        for _ in range(2))) * 0.5
    x, y, t = cn(1), cn(1), torch.tensor([0.6], device=dev)
    with torch.no_grad():
        out = net(x, y, t)
        out64 = net64(to_double(x), to_double(y), to_double(t))
        err = rel_err(out.to(torch.complex128), out64)
        with tf32_on():
            err_tf32 = rel_err(net(x, y, t).to(torch.complex128), out64)
        leaf = dict(net.named_parameters())[NCSNPP_CONTROL_LEAF]
        saved = leaf.clone()
        leaf.zero_()
        err_control = rel_err(net(x, y, t).to(torch.complex128), out64)
        leaf.copy_(saved)
        x16, y16, t16 = cn(16), cn(16), torch.full((16,), 0.6, device=dev)
        x16[0], y16[0] = x[0], y[0]
        err_b16 = rel_err(net(x16, y16, t16)[:1].to(torch.complex128), out64)
        del net64, out64
        with FlopCounterMode(display=False) as counter:
            net(x, y, t)
        flops = counter.get_total_flops()
        ms = {"b1": timed_ms(lambda: net(x, y, t), 5),
              "b16": timed_ms(lambda: net(x16, y16, t16), 3)}
        net.to(memory_format=torch.channels_last)
        ms["b1_channels_last"] = timed_ms(lambda: net(x, y, t), 5)
        ms["b16_channels_last"] = timed_ms(lambda: net(x16, y16, t16), 3)
        net.to(memory_format=torch.contiguous_format)
        with cudnn_benchmark():
            ms["b16_cudnn_benchmark"] = timed_ms(lambda: net(x16, y16, t16), 3)
            err_bench = rel_err(net(x, y, t), out)
    bound_ms = bound(flops, 4 * (3 * x.numel() * 2 + sum(p.numel() for p in net.parameters())))
    emit({"phase": "ncsnpp_backbone", "backbone": NCSNPP, "shape": list(NCSNPP_SHAPE),
          "parameters": sum(p.numel() for p in net.parameters()),
          "weights": "fan-in scale, seeded", "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "float64": {"rel_err": err, "tol": 1e-4, "b16_row0_rel_err": err_b16,
                      "tf32_rel_err": err_tf32,
                      "control_zeroed": NCSNPP_CONTROL_LEAF, "control_rel_err": err_control},
          "cudnn_benchmark_rel_err_vs_default": err_bench,
          "finite": bool(torch.isfinite(torch.view_as_real(out)).all()),
          "forward_ms": ms, "flops_b1": flops, "bound_ms_b1": bound_ms[0],
          "bound_by": bound_ms[1], "xla_flops_b1": 530.2e9})
    if not (err < 1e-4 and err_b16 < 1e-4) or err_control < 1e-4:
        fail(f"{NCSNPP} backbone: float64 rel {err}, B=16 row 0 {err_b16} (tol 1e-4), "
             f"control with {NCSNPP_CONTROL_LEAF} zeroed rel {err_control} must miss the gate")


def ncsnpp_fdbm(dev, backbone: str = NCSNPP):
    """An FDBM of the default config on ``backbone`` at fan-in weights."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig

    torch.manual_seed(SEED)
    fdbm = FDBM(FDBMConfig(backbone=backbone), device=dev)
    fan_in_weights_(fdbm.dnn)
    return fdbm


def float64_twin(fdbm):
    """``fdbm`` with a float64 copy of its backbone (``Float64Backbone``)."""
    import copy

    twin = copy.copy(fdbm)
    twin.dnn = Float64Backbone(copy.deepcopy(fdbm.dnn))
    return twin


def ncsnpp_serve_phase(tmp: str, rng, dev, smi: str):
    """ncsnpp_v2 serving: a 2-step reflection-padded serve against the float64
    route on the same noise (rel < 1e-4), then a checkpoint the script writes
    served through the single-file CLI on a 4 s and a 3 s file (257 and 193
    frames, reflection-padded to 320 and 256), 30-step sde_ei, in fp32 and
    then at ``inference_dtype=bfloat16``, and one profiled 4 s request.
    Returns the checkpoint's path and the model."""
    from fdbm_tpu_torch.checkpoint import save_checkpoint

    fdbm = ncsnpp_fdbm(dev)
    ckpt = os.path.join(tmp, "ncsnpp_v2.pt")
    save_checkpoint(ckpt, fdbm)
    f64 = float64_twin(fdbm)
    audio = torch.as_tensor(rng.standard_normal((1, 16000)).astype(np.float32) * 0.3, device=dev)
    serve = lambda f: f.enhance_batch(audio, torch.Generator(device=dev).manual_seed(SEED),
                                      sampler_type="sde_ei", N=2, pad_mode="reflection")
    with torch.no_grad():
        out, out64 = serve(fdbm), serve(f64)
        with tf32_on():
            out_tf32 = serve(fdbm)
    del f64
    err, err_tf32 = rel_err(out, out64), rel_err(out_tf32, out64)
    emit({"phase": "ncsnpp_serve_check", "backbone": NCSNPP, "sampler": "sde_ei", "N": 2,
          "samples": audio.shape[-1], "pad_mode": "reflection", "float64_rel_err": err,
          "tol": 1e-4, "tf32_rel_err": err_tf32})
    if not err < 1e-4:
        fail(f"{NCSNPP} 2-step serve disagrees with the float64 route: rel {err}")

    requests = ((4.0, "sde_ei", 30), (3.0, "sde_ei", 30))
    _, files = serve_cli(tmp, ckpt, "ncsnpp_serve", requests, smi, seed=SEED + 50)
    serve_cli(tmp, ckpt, "ncsnpp_serve_bf16", requests, smi, seed=SEED + 50,
              extra=(BF16_OVERRIDE,))
    emit(profile_request(fdbm, files[0], "ncsnpp_profile", pad_mode="reflection"))
    return ckpt, fdbm


def ncsnpp_grad_phase(rng, dev) -> None:
    """One ncsnpp_v2 training step (B=2, 256 frames, fan-in weights), with
    cuDNN's benchmark mode on as the trainer runs, against float64: the loss
    through the float64 network within rel 1e-5, and the parameter
    gradients under the fp32 route's dL/dx_hat, each leaf within norm-rel
    1e-3 of float64's with the denominator floored at 1e-4 of the global
    norm (PARITY.md's model-level gates). NCSN++ has no kernel route: the
    fp32 card route is the one under test."""
    from fdbm_tpu_torch import losses
    from fdbm_tpu_torch.model import TrainState

    fdbm = ncsnpp_fdbm(dev)
    f64 = float64_twin(fdbm)
    net64 = f64.dnn.net
    batch = synthetic_batch(rng, dev)
    shape = (TRAIN_BATCH, 1, fdbm.cfg.n_fft // 2 + 1, TRAIN_FRAMES)
    t = torch.tensor([0.3, 0.8], device=dev)
    z = torch.complex(*(torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                                        / math.sqrt(2), device=dev) for _ in range(2)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cudnn_benchmark():
        loss = fdbm.loss_fn(batch, prior=(t, z))
        state = TrainState(fdbm.dnn)
        grads = dict(zip(state.params,
                         torch.autograd.grad(loss, list(state.params.values()))))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        loss64 = float(f64.loss_fn(batch, prior=(t, z)).detach())
        x, y = (fdbm.audio_to_spec(a) for a in batch[:2])
        _, _, _, x_t = fdbm._sample_prior(x, y, None, t, z)
        fdbm.dnn.train()
        x_hat = fdbm.dnn(x_t, y, t)
        cot = torch.autograd.grad(losses.compute_loss(fdbm.loss_cfg, x_hat, x), x_hat)[0]
        del x_hat
        g64 = route_vjp(net64, x_t, y, t, cot, torch.complex128, torch.float64)
        g32 = route_vjp(fdbm.dnn, x_t, y, t, cot, torch.complex64, torch.float32)
    norm64 = math.sqrt(sum(float((g * g).sum()) for g in g64.values()))
    rels = {n: grad_rel(g32[n], g64[n], 1e-4 * norm64) for n in g64}
    # the training step's own gradients are the same computation as g32
    step_rel = max(grad_rel(grads[n].double(), g32[n], 1e-4 * norm64) for n in g64)
    worst = sorted(rels, key=rels.get)[-3:][::-1]
    loss_rel = abs(float(loss.detach()) - loss64) / abs(loss64)
    emit({"phase": "ncsnpp_train_grad", "backbone": NCSNPP, "cudnn_benchmark": True,
          "batch": TRAIN_BATCH,
          "frames": TRAIN_FRAMES, "loss": float(loss.detach()), "loss_float64": loss64,
          "loss_rel": loss_rel, "loss_tol": 1e-5, "leaves": len(rels),
          "worst_leaves": [(n, rels[n]) for n in worst], "grad_tol": 1e-3,
          "grad_norm_float64": norm64, "train_step_vs_vjp_rel": step_rel,
          "first_step_seconds": step_s, "peak_memory_gb_fp32_step": peak / 1e9})
    if not (loss_rel < 1e-5 and rels[worst[0]] < 1e-3):
        fail(f"{NCSNPP} training step against float64: loss rel {loss_rel}, worst gradients "
             f"{[(n, rels[n]) for n in worst]}")


def ncsnpp_folder(tmp: str, ckpt: str, smi: str, profile_fdbm=None, extra=()) -> None:
    """ncsnpp_v2's folder: NCSNPP_FOLDER_FILES files of 1-12 s through the
    folder CLI at --batch_size 16 with the overrides ``extra``, and one
    5-step profiled batch of ``profile_fdbm`` unless it is None."""
    seconds = list(np.random.default_rng(SEED + 61).uniform(1.0, 12.0, NCSNPP_FOLDER_FILES))
    serve_folder(tmp, ckpt, "ncsnpp_serve_folder" + ("_bf16" if extra else ""), seconds, "4.096",
                 smi, profile_fdbm=profile_fdbm, per_call={}, extra=extra,
                 profile_kwargs={"n_steps": 5, "pad_mode": "reflection"})


def ncsnpp_phases(tmp: str, rng, dev, smi: str) -> None:
    """Every NCSN++ phase, with the ten kernels' launch counts held at 0."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.models.ncsnpp import ncsnpp_v2

    t0 = time.perf_counter()
    seconds_by_phase = {}

    def timed(name, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds_by_phase[name] = time.perf_counter() - start
        return out

    ops.reset_launch_counts()
    timed("backbone", ncsnpp_backbone_phase, rng, dev)
    ckpt, fdbm = timed("serve", ncsnpp_serve_phase, tmp, rng, dev, smi)
    timed("serve_folder", ncsnpp_folder, tmp, ckpt, smi, profile_fdbm=fdbm)
    del fdbm
    timed("serve_folder_bf16", ncsnpp_folder, tmp, ckpt, smi, extra=(BF16_OVERRIDE,))
    timed("train_grad", ncsnpp_grad_phase, rng, dev)
    timed("train_cli", train_cli_phase, tmp, smi, NCSNPP)
    with cudnn_benchmark():  # as the trainer runs
        timed("train_rate", train_rate_phase, rng, dev, smi, ncsnpp_v2, "ncsnpp_train_rate")
    timed("predictive", predictive_phase, tmp, smi, "ncsnpp_v2_5M_predictive", steps=2)
    counts = ops.launch_counts()
    emit({"phase": "ncsnpp_launches", "launches": counts, "seconds_by_phase": seconds_by_phase,
          "wall_seconds": time.perf_counter() - t0})
    if any(counts.values()):
        fail(f"the NCSN++ phases launched the port's kernels: {counts}")


# -- bf16 serving: inference_dtype=bfloat16 ------------------------------------------------

# The serving kernels with a bf16 form (kernels 1, 2, 3 and 7), by the name
# their bf16 launches count under (ops.launch_counts).
BF16_FORMS = {"grid_rnn_seq1_pair": "grid_rnn_seq1_pair_bf16",
              "flat_group_norm": "flat_group_norm_bf16",
              "frame_attention": "frame_attention_bf16",
              "bilstm_fused_forward": "bilstm_fused_forward_bf16"}
# A bf16 kernel against its bf16 plain version: rel-L2 within its entry of
# BF16_TOLS, about 2.5x what the card reads at the path's shapes (8.4e-4,
# 1.1e-5, 9.0e-5 and 3.4e-4 on an H100: the sums' order moves a value across
# a bf16 rounding boundary now and then), and its distance to the plain
# version run in float64 within BF16_F64_K x the plain version's plus
# BF16_F64_ABS. The up-cast control, the fp32 form on the same bf16 inputs
# with its output rounded to bf16 (no rounding of the weights, of h before
# each product or of P before P.V), must miss BF16_TOLS for kernels 1, 3 and
# 7 (it reads 1.4e-3 to 3.9e-3 from the plain versions); kernel 2 rounds
# nothing before its output, so it has none. A backbone or a serve on random
# weights carries the kernels' rare one-step differences through the E=2
# q/k norms, which amplify them (a pair of lanes within rounding of each
# other flips sign: 5l32c100's forward reads 1.8e-2 between the routes), so
# there the float64 gate alone decides and the routes' rel-L2 is reported.
BF16_TOLS = {"grid_rnn_seq1_pair": 2e-3, "flat_group_norm": 3e-5, "frame_attention": 2.5e-4,
             "bilstm_fused_forward": 1e-3}
BF16_F64_K, BF16_F64_ABS = 1.5, 1e-3
BF16_CALL_LAUNCHES = {"grid_rnn_seq1_pair_bf16": 2 * RNN_BLOCKS,
                      "flat_group_norm_bf16": RNN_BLOCKS, "frame_attention_bf16": RNN_BLOCKS,
                      "grid_rnn_seq1_pair": 0, "flat_group_norm": 0, "frame_attention": 0}
BF16_OVERRIDE = "inference_dtype=bfloat16"
# bf16_quality: 5l32c100 trained on the card on speech-like pairs, then four
# held-out files served with ode_ei at N=8 in fp32 and in bf16.
QUALITY_STEPS, QUALITY_LR, QUALITY_BATCH, QUALITY_N = 200, 5e-4, TRAIN_BATCH, 8
QUALITY_TRAIN_FILES, QUALITY_TEST_FILES, QUALITY_SECONDS = 8, 4, 3.0
QUALITY_AGREEMENT_DB, QUALITY_DELTA_DB = 15.0, 0.5
# bf16_train_quality: the same training continued to QUALITY_TRAIN_STEPS in
# fp32 and in bf16, the bf16-trained model's mean SI-SDR within
# QUALITY_TRAIN_DELTA_DB of the fp32-trained model's. --probe-quality read
# the two trainings part by 4.4 and 2.2 dB at 200 and 400 steps and come
# within 0.65 dB at every reading from 600 to 1800 steps (1000: 0.03 dB),
# while both stay near or below their noisy input's -0.03 dB (1000: -1.66 and
# -1.63; 1800: +0.28 and -0.16; PERF.md §6).
QUALITY_TRAIN_STEPS, QUALITY_TRAIN_DELTA_DB = 1000, 1.0
# The quality trainings' worker processes must end this many seconds after
# they start.
QUALITY_WORKER_TIMEOUT = 1100
# --probe-quality reads the EMA every this many steps.
QUALITY_PROBE_EVERY = 200


def as_real64(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return (torch.view_as_real(t) if t.is_complex() else t).double()


def bf16_gate(got, plain, f64, tol) -> dict:
    """The bf16 gate of a kernel, a backbone or a serve: ``got`` (the bf16
    kernel route) against ``plain`` (the bf16 plain route; within ``tol``
    unless it is None) and ``f64`` (the plain route in float64), over
    tensors or lists of tensors."""
    cat = lambda ts: torch.cat([as_real64(t).flatten() for t in ts]) \
        if isinstance(ts, (list, tuple)) else as_real64(ts)
    g, p, f = cat(got), cat(plain), cat(f64)
    r = {"rel_err": rel_err(g, p), "kernel_f64": rel_err(g, f), "plain_f64": rel_err(p, f),
         "max_abs_err": float((g - p).abs().max())}
    r["limit_f64"] = BF16_F64_K * r["plain_f64"] + BF16_F64_ABS
    r["tol"] = tol
    r["ok"] = bool((tol is None or r["rel_err"] <= tol) and r["kernel_f64"] <= r["limit_f64"]
                   and torch.isfinite(g).all())
    return r


def only_bf16(counts: dict, expected: dict) -> bool:
    """The bf16 forms launched as ``expected`` and no fp32 form of them."""
    return (all(counts[k] == v for k, v in expected.items())
            and not any(counts[k] for k in BF16_FORMS))


def kernel_bf16_phase(dev, summary: dict) -> None:
    """Rows 1, 2, 3 and 7 in their bf16 forms at the main path's shapes (the
    4 s request, B=1; row 7 at 6l48c200's intra path) and rows 1-3 at the
    folder's batch (B=16), each against its bf16 plain version and float64
    (``bf16_gate`` within BF16_TOLS), the up-cast control beside rows 1, 3
    and 7, and the fp32 form's time on the same inputs. Bound: bf16 bytes
    (fp32 weights) over the HBM rate against the operations over the bf16
    tensor-core rate (``cuda_core_bound_ms``: over the fp32 rate of the CUDA
    cores). Rows 1, 3 and 7 run on the tensor cores: each prints its
    kernels' HMMA counts (``tensor_core_ops``; 0 fails), its stages (row 1:
    recurrence and fold, row 7: projection and recurrence, with its time a
    step) and its time at every plan the card runs (``plans_ms``), each
    plan's output held to BF16_TOLS. Library: SDPA on bf16 (row 3), cuDNN's
    bf16 LSTM (row 7)."""
    from fdbm_tpu_torch.dsp import num_frames_for_length
    from fdbm_tpu_torch.ops import _build, attention as attn_ops, gridrnn, lstm as lstm_ops

    rng = np.random.default_rng(SEED + 90)
    rand = lambda *shape, s=1.0: torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32) * s, device=dev)
    bf = lambda t: t.to(torch.bfloat16)
    dbl = lambda ts: [t.double() for t in ts]
    c, hidden, n_head, e_dim, q_bins = 32, 100, 4, 2, 257
    d_dim = c // n_head
    w = (rand(2, 4 * c, 4 * hidden, s=0.1), rand(2, hidden, 4 * hidden, s=0.1),
         rand(2, 4 * hidden, s=0.1), rand(2 * hidden, 4 * c, s=0.1))
    w_bytes = 4 * sum(t.numel() for t in w)
    n_request = num_frames_for_length(65536, 512, 256)  # the 4 s request's 64-frame bucket
    rows = {}
    # Row 1 runs on the tensor cores: its kernel's HMMA count, each
    # instantiation's, and none may be 0.
    libraries = _build.build_all()["libraries"]
    mma_ops = tensor_core_ops(libraries["gridrnn"], "gridrnn_mma_kernel")
    attn_mma_ops = tensor_core_ops(libraries["attention"], "attn_mma_kernel")
    lstm_mma_ops = {**tensor_core_ops(libraries["lstm"], "dense_mma_kernel"),
                    **tensor_core_ops(libraries["lstm"], "lstm_mma_kernel")}

    def gated(name, got, plain, f64, upcast=None):
        """``bf16_gate`` within BF16_TOLS[name]; ``upcast``, the fp32 form's
        output on the same inputs, rounded to bf16 must miss it."""
        r = bf16_gate(got, plain, f64, BF16_TOLS[name])
        if upcast is not None:
            ctl = bf16_gate(upcast, plain, f64, BF16_TOLS[name])
            r["upcast_control"] = {"rel_err": ctl["rel_err"], "kernel_f64": ctl["kernel_f64"],
                                   "missed": not ctl["ok"]}
            r["ok"] = r["ok"] and not ctl["ok"]
        return r

    def bounds(flops, nbytes):
        return {"bound": bound(flops, nbytes, PEAK_BF16_FLOPS),
                "cuda_core_bound_ms": bound(flops, nbytes)[0]}

    def mma_plans_ms(x, lines, length, crop, plain):
        """Kernel 1's bf16 time at every plan (CS, lines a tile) the card
        runs, launched directly: the plan chooses, these show the choice.
        Each plan's output is held to the bf16 plain version ``plain``
        within BF16_TOLS."""
        lib = _build.load("gridrnn", gridrnn._SIGNATURES, gridrnn._RESTYPES)
        hs = torch.empty((2, lines, length, hidden), device=dev, dtype=torch.bfloat16)
        outs = (torch.empty_like(x), torch.empty_like(x))
        times = {}
        for cs in gridrnn.CLUSTERS:
            for tile in gridrnn.MMA_LINES:
                if (gridrnn.mma_layout(c, hidden, cs, tile) is None
                        or gridrnn._card_mma_max_clusters(0, c, hidden, cs, tile) < 1):
                    continue

                def run(cs=cs, tile=tile):
                    _build.check(lib.gridrnn_seq1_pair_bf16(
                        x.data_ptr(), *(t.data_ptr() for t in w), hs.data_ptr(),
                        outs[0].data_ptr(), outs[1].data_ptr(), x.shape[0], x.shape[1],
                        x.shape[2], c, hidden, cs, tile, torch.cuda.current_stream().cuda_stream),
                        f"gridrnn_seq1_pair_bf16 (cs={cs}, lines={tile})")
                run()
                err = max(rel_err(g.double(), r.double()) for g, r in zip(crop(outs), plain))
                if not err <= BF16_TOLS["grid_rnn_seq1_pair"]:
                    fail(f"gridrnn_seq1_pair_bf16 at plan cs={cs}, lines={tile} is {err} from "
                         f"its bf16 plain version")
                times[f"cs{cs}_lines{tile}"] = timed_ms(run, 3)
        return times

    def rnn_row(b, frames):
        s_len, p_len = q_bins + 6, frames + 6
        length = s_len - 3
        x = bf(rand(b, s_len, p_len, c, s=0.5))
        x32 = x.float()
        crop = lambda pair: [t[:, 3:length] for t in pair]
        plain = crop(gridrnn.grid_rnn_seq1_pair_plain(x, *w))
        gate = gated("grid_rnn_seq1_pair", crop(gridrnn.grid_rnn_seq1_pair(x, *w)), plain,
                     crop(gridrnn.grid_rnn_seq1_pair_plain(x.double(), *dbl(w))),
                     crop([bf(t) for t in gridrnn.grid_rnn_seq1_pair(x32, *w)]))
        lines = b * p_len
        flops = 2 * lines * length * 2 * (4 * c * 4 * hidden + hidden * 4 * hidden
                                           + hidden * 4 * c)
        plan = gridrnn.mma_plan(lines, c, hidden)
        stages = kernel_times(lambda: gridrnn.grid_rnn_seq1_pair(x, *w),
                              {"recurrence": "gridrnn_mma_kernel", "fold": "fold_kernel"})
        return dict(
            gate, shape=list(x.shape),
            plan={**plan._asdict(), "waves": -(-plan.clusters // plan.max_clusters)},
            plans_ms=mma_plans_ms(x, lines, length, crop, plain), tensor_core_ops=mma_ops, stages_ms=stages,
            recurrence_ms=stages["recurrence"],
            recurrence_us_per_step=stages["recurrence"] / length * 1e3,
            ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair(x, *w), 5 if b > 1 else 20),
            fp32_ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair(x32, *w), 5 if b > 1 else 20),
            plain_ms=timed_ms(lambda: gridrnn.grid_rnn_seq1_pair_plain(x, *w), 1 if b > 1 else 3),
            **bounds(flops, 2 * 3 * x.numel() + w_bytes), library_ms=None)

    def attention_rows(b, frames):
        out = {}
        q, k = (bf(rand(b, frames, q_bins, n_head * e_dim)) for _ in range(2))
        v = bf(rand(b, frames, q_bins, c))
        norms = tuple((rand(n_head, 1, s=0.3), rand(n_head, wd), rand(n_head, wd))
                      for wd in (e_dim, e_dim, d_dim))
        maps = [(a, *p, wd) for a, p, wd in zip((q, k, v), norms, (e_dim, e_dim, d_dim))]
        maps32 = [(m[0].float(), *m[1:]) for m in maps]
        plain = lambda ms: [attn_ops.flat_group_norm_plain(*m[:4], width=m[4]) for m in ms]
        elems = sum(m[0].numel() for m in maps)
        out["flat_group_norm"] = dict(
            gated("flat_group_norm", attn_ops.flat_group_norms(maps), plain(maps),
                  plain([(*dbl(m[:4]), m[4]) for m in maps])),
            shape=[list(m[0].shape) for m in maps],
            ms=timed_ms(lambda: attn_ops.flat_group_norms(maps)),
            device_ms=kernel_times(lambda: attn_ops.flat_group_norms(maps),
                                   {"norm": "norm_segments_kernel"}).get("norm"),
            fp32_ms=timed_ms(lambda: attn_ops.flat_group_norms(maps32)),
            fp32_device_ms=kernel_times(lambda: attn_ops.flat_group_norms(maps32),
                                        {"norm": "norm_segments_kernel"}).get("norm"),
            plain_ms=timed_ms(lambda: plain(maps), 3),
            **bounds(10 * elems, 2 * 2 * elems), library_ms=None,
            calls="the q, k and v maps of one attention call (one launch); ms by events "
                  "around the wrapper, device_ms from the profiler")
        scale = 1.0 / math.sqrt(e_dim * q_bins)
        to_heads = lambda t, w_: t.reshape(b, frames, q_bins, n_head, w_).permute(
            0, 3, 1, 2, 4).reshape(b, n_head, frames, q_bins * w_)
        qh, kh, vh = to_heads(q, e_dim), to_heads(k, e_dim), to_heads(v, d_dim)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        t2 = b * n_head * frames * frames
        run = lambda: attn_ops.frame_attention(q, k, v, n_head, e_dim)
        q32, k32, v32 = q.float(), k.float(), v.float()
        plain_attn = attn_ops.frame_attention_plain(q, k, v, n_head, e_dim)
        plans_ms = {}
        for mt in attn_ops.MMA_ROW_TILES:
            for slices in attn_ops.MMA_SLICES:
                if (attn_ops.attention_mma_layout(frames, q_bins, e_dim, d_dim, mt, slices) is None
                        or attn_ops._card_mma_max_clusters(0, frames, q_bins, e_dim, d_dim,
                                                           16 * mt, slices) < 1):
                    continue
                at = lambda mt=mt, slices=slices: attn_ops.launch_frame_attention_bf16(
                    q, k, v, n_head, e_dim, 16 * mt, slices)
                err = rel_err(at().double(), plain_attn.double())
                if not err <= BF16_TOLS["frame_attention"]:
                    fail(f"frame_attention_bf16 at plan rows={16 * mt}, slices={slices} is "
                         f"{err} from its bf16 plain version")
                plans_ms[f"rows{16 * mt}_slices{slices}"] = timed_ms(at, 3)
        plan = attn_ops.card_attention_mma_plan(b, frames, q_bins, n_head, e_dim, d_dim)
        out["frame_attention"] = dict(
            gated("frame_attention", run(), plain_attn,
                  attn_ops.frame_attention_plain(q.double(), k.double(), v.double(), n_head,
                                                 e_dim),
                  bf(attn_ops.frame_attention(q32, k32, v32, n_head, e_dim))),
            shape=[list(q.shape), list(v.shape)],
            plan={**plan._asdict(), "waves": -(-plan.blocks // (plan.max_clusters
                                                                 * plan.slices))},
            plans_ms=plans_ms, tensor_core_ops=attn_mma_ops,
            stages_ms=kernel_times(run, {"attention": "attn_mma_kernel"}),
            ms=timed_ms(run),
            fp32_ms=timed_ms(lambda: attn_ops.frame_attention(q32, k32, v32, n_head, e_dim)),
            plain_ms=timed_ms(lambda: attn_ops.frame_attention_plain(q, k, v, n_head, e_dim), 3),
            **bounds(2 * t2 * q_bins * (e_dim + d_dim) + 5 * t2,
                     2 * (q.numel() + k.numel() + 2 * v.numel())),
            library_ms=timed_ms(sdpa))
        return out

    rows["grid_rnn_seq1_pair"] = rnn_row(1, n_request)
    rows.update(attention_rows(1, n_request))

    d, wide_h = 4 * WIDE_C, WIDE_H
    length = q_bins + 6 - 3
    sc = wide_h ** -0.5
    w2 = (rand(2, d, 4 * wide_h, s=sc), rand(2, wide_h, 4 * wide_h, s=sc),
          rand(2, 4 * wide_h, s=sc))
    x = bf(rand(length, n_request + 6, d))
    n = x.shape[0] * x.shape[1]
    lib = cudnn_lstm(*w2, dev).to(torch.bfloat16)
    with torch.no_grad():
        plain7 = lstm_ops.bilstm_fused_forward_plain(x, *w2)
        plans7 = {}
        for cs in lstm_ops.REC_CLUSTERS:
            for tile in lstm_ops.MMA_LINES:
                if (lstm_ops.recurrence_mma_layout(wide_h, cs, tile) is None
                        or lstm_ops._card_max_clusters(0, wide_h, cs, tile, "mma") < 1):
                    continue
                at = lambda cs=cs, tile=tile: lstm_ops._forward(
                    "bilstm_fused_forward", x, *w2, 2, False, plan=(cs, tile))
                err = max(rel_err(g.double(), r.double()) for g, r in zip(at(), plain7))
                if not err <= BF16_TOLS["bilstm_fused_forward"]:
                    fail(f"bilstm_fused_forward_bf16 at plan cs={cs}, lines={tile} is {err} "
                         f"from its bf16 plain version")
                plans7[f"cs{cs}_lines{tile}"] = timed_ms(at, 3)
        run7 = lambda: lstm_ops.bilstm_fused_forward(x, *w2)
        stages7 = kernel_times(run7, {"projection": "dense_mma_kernel",
                                      "recurrence": "lstm_mma_kernel"})
        rows["bilstm_fused_forward"] = dict(
            gated("bilstm_fused_forward", run7(), plain7,
                  lstm_ops.bilstm_fused_forward_plain(x.double(), *dbl(w2)),
                  [bf(t) for t in lstm_ops.bilstm_fused_forward(x.float(), *w2)]),
            shape=list(x.shape),
            plan=lstm_ops.recurrence_mma_plan(x.shape[1], 2, wide_h)._asdict(),
            plans_ms=plans7, tensor_core_ops=lstm_mma_ops, stages_ms=stages7,
            recurrence_ms=stages7.get("recurrence"),
            recurrence_us_per_step=stages7.get("recurrence", 0.0) / length * 1e3,
            fp32_stages_ms=kernel_times(lambda: lstm_ops.bilstm_fused_forward(x.float(), *w2),
                                        {"projection": "dense_kernel",
                                         "recurrence": "lstm_rec_kernel"}),
            ms=timed_ms(run7),
            fp32_ms=timed_ms(lambda: lstm_ops.bilstm_fused_forward(x.float(), *w2)),
            plain_ms=timed_ms(lambda: lstm_ops.bilstm_fused_forward_plain(x, *w2), 3),
            **bounds(2 * n * (2 * d * 4 * wide_h + 2 * wide_h * 4 * wide_h),
                     2 * x.numel() + 4 * sum(t.numel() for t in w2) + 2 * 2 * n * wide_h),
            library_ms=timed_ms(lambda: lib(x)),
            calls="one intra path of 6l48c200's 4 s request (B=1)")
    del x, lib
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        emit({"phase": "kernel_bf16", "name": BF16_FORMS[name], **r})
        if not r["ok"]:
            fail(f"{BF16_FORMS[name]} disagrees with its bf16 plain version, or its up-cast "
                 f"control does not: {r}")
        if "tensor_core_ops" in r and not (r["tensor_core_ops"]
                                           and all(r["tensor_core_ops"].values())):
            fail(f"{BF16_FORMS[name]}: a kernel without tensor-core instructions in its SASS: "
                 f"{r['tensor_core_ops']}")
        summary[BF16_FORMS[name]] = r

    b16 = {"grid_rnn_seq1_pair": rnn_row(FOLDER_BATCH, num_frames_for_length(
        CHUNK_SAMPLES, 512, 256))}
    b16.update(attention_rows(FOLDER_BATCH, num_frames_for_length(CHUNK_SAMPLES, 512, 256)))
    for name, r in b16.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        emit({"phase": "kernel_bf16_b16", "name": BF16_FORMS[name], "batch": FOLDER_BATCH, **r})
        if not r["ok"]:
            fail(f"{BF16_FORMS[name]} at B={FOLDER_BATCH} disagrees with its bf16 plain "
                 f"version, or its up-cast control does not: {r}")
        if "tensor_core_ops" in r and not (r["tensor_core_ops"]
                                           and all(r["tensor_core_ops"].values())):
            fail(f"{BF16_FORMS[name]}: a kernel without tensor-core instructions in its SASS: "
                 f"{r['tensor_core_ops']}")
    torch.cuda.empty_cache()


def backbone_bf16_phase(dev) -> None:
    """The three backbones in eval mode with a bf16 serving dtype at a 4 s
    request's spectrogram (B=1, 256 frames): 5l32c100 and 6l48c200 on the
    kernel route against their bf16 plain route and the plain route in
    float64 (``bf16_gate``), with their launches per forward (only bf16
    forms) and the forward's time beside fp32's; ncsnpp_v2 (fan-in weights,
    no kernel) against itself in float64."""
    import copy

    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.models.ncsnpp import ncsnpp_v2
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet, tfgridnet_5l32c100

    rng = np.random.default_rng(SEED + 91)
    cn = lambda shape: torch.complex(*(torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32), device=dev) for _ in range(2)))
    shape = (1, 1, 257, 256)
    xs, ys, ts = cn(shape), cn(shape), torch.tensor([0.6], device=dev)
    as64 = lambda: (xs.to(torch.complex128), ys.to(torch.complex128), ts.double())
    cases = ((RNN_MODEL, tfgridnet_5l32c100,
              {"grid_rnn_seq1_pair_bf16": 2 * RNN_BLOCKS, "flat_group_norm_bf16": RNN_BLOCKS,
               "frame_attention_bf16": RNN_BLOCKS}),
             (WIDE, TFGridNet, {"bilstm_fused_forward_bf16": WIDE_PATHS,
                                "frame_attention_bf16": 6, "flat_group_norm_bf16": 0,
                                "grid_rnn_seq1_pair_bf16": 0}))
    for name, make, expected in cases:
        torch.manual_seed(SEED)
        net = make(serve_dtype=torch.bfloat16).to(dev).eval()
        ref = make(use_kernels=False, serve_dtype=torch.bfloat16).to(dev).eval()
        ref.load_state_dict(net.state_dict())
        f64 = make(use_kernels=False).to(dev).eval()
        f64.load_state_dict(net.state_dict())
        f64.double()
        with torch.no_grad():
            ops.reset_launch_counts()
            out = net(xs, ys, ts)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            gate = bf16_gate(out, ref(xs, ys, ts), f64(*as64()), tol=None)
            fwd_ms = timed_ms(lambda: net(xs, ys, ts), 3)
            net.serve_dtype = torch.float32
            fwd32_ms = timed_ms(lambda: net(xs, ys, ts), 3)
        ok = gate["ok"] and only_bf16(counts, expected)
        emit({"phase": "backbone_bf16", "backbone": name, "shape": list(shape), **gate,
              "launches_per_forward": counts, "expected": expected, "forward_ms": fwd_ms,
              "fp32_forward_ms": fwd32_ms})
        if not ok:
            fail(f"{name} in bf16: {gate}, launches {counts}, expected {expected}")
        del net, ref, f64

    torch.manual_seed(SEED)
    net = fan_in_weights_(ncsnpp_v2(serve_dtype=torch.bfloat16)).to(dev).eval()
    net64 = copy.deepcopy(net)
    net64.serve_dtype = torch.float32
    net64.double()
    with torch.no_grad():
        ops.reset_launch_counts()
        out = net(xs, ys, ts)
        counts = ops.launch_counts()
        err = rel_err(as_real64(out), as_real64(net64(*as64())))
        fwd_ms = timed_ms(lambda: net(xs, ys, ts), 5)
        net.serve_dtype = torch.float32
        fwd32_ms = timed_ms(lambda: net(xs, ys, ts), 5)
    emit({"phase": "backbone_bf16", "backbone": NCSNPP, "shape": list(shape),
          "weights": "fan-in scale, seeded", "float64_rel_err": err, "tol": NCSNPP_BF16_TOL,
          "floor": 1e-4, "launches_per_forward": counts, "forward_ms": fwd_ms,
          "fp32_forward_ms": fwd32_ms})
    if not 1e-4 < err <= NCSNPP_BF16_TOL or any(counts.values()):
        fail(f"{NCSNPP} in bf16 against float64: rel {err} (within (1e-4, {NCSNPP_BF16_TOL}]), "
             f"launches {counts}")
    del net, net64
    torch.cuda.empty_cache()


def serve_check_bf16_phase(dev) -> None:
    """A 2-step sde_ei serve at ``inference_dtype=bfloat16``: 5l32c100 at B=1
    (1 s) and B=16 (16 rows of 1 s), each through the kernel route against
    the bf16 plain route and the plain network in float64 in the same
    sampler (``Float64Backbone``), on the same noise (``bf16_gate``), and
    6l48c200 at B=1 over several draws (``wide_gate_phase``); the kernel
    route launches only bf16 forms."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import FDBMConfig
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100

    rng = np.random.default_rng(SEED + 92)
    cfg = FDBMConfig(inference_dtype="bfloat16")
    expected = {k: 2 * v for k, v in BF16_CALL_LAUNCHES.items()}
    for rows in (1, FOLDER_BATCH):
        torch.manual_seed(SEED)
        make = tfgridnet_5l32c100
        fdbm = fdbm_with(make, dev, cfg, serve_dtype=torch.bfloat16)
        plain = fdbm_with(make, dev, cfg, use_kernels=False, serve_dtype=torch.bfloat16)
        plain.dnn.load_state_dict(fdbm.dnn.state_dict())
        f64 = fdbm_with(make, dev, cfg, use_kernels=False, serve_dtype=torch.float32)
        f64.dnn.load_state_dict(fdbm.dnn.state_dict())
        f64.dnn = Float64Backbone(f64.dnn).eval()
        audio = torch.as_tensor(rng.standard_normal((rows, 16000)).astype(np.float32) * 0.3,
                                device=dev)
        serve = lambda f: f.enhance_batch(audio, torch.Generator(device=dev).manual_seed(SEED),
                                          sampler_type="sde_ei", N=2)
        ops.reset_launch_counts()
        out = serve(fdbm)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        gate = bf16_gate(out, serve(plain), serve(f64), tol=None)
        emit({"phase": "serve_check_bf16", "backbone": RNN_MODEL, "batch": rows,
              "sampler": "sde_ei", "N": 2, "samples": audio.shape[-1], **gate,
              "launches": counts})
        if not (gate["ok"] and only_bf16(counts, expected)):
            fail(f"{RNN_MODEL} bf16 serve at B={rows}: {gate}, launches {counts}, "
                 f"expected {expected}")
        del fdbm, plain, f64
    audio = torch.as_tensor(rng.standard_normal((1, 16000)).astype(np.float32) * 0.3, device=dev)
    wide_gate_phase(dev, audio, {"bilstm_fused_forward_bf16": 2 * WIDE_PATHS,
                                 "frame_attention_bf16": 2 * 6})


# serve_check_bf16's 6l48c200 gate judges WIDE_GATE_DRAWS draws (weights
# from torch.manual_seed(SEED + i), 1 s of audio, the sampler's noise from
# SEED + i; draw 0 is the draw a single-draw gate read). On each draw
# the kernel route's distance to the float64 serve over its limit, BF16_F64_K
# x the bf16 plain route's distance + BF16_F64_ABS, is its ratio; the
# median ratio must be <= 1 and no draw's above WIDE_GATE_W. A 2-step serve
# of random weights through the E=2 q/k norms is chaotic: one draw judged
# the draw (with the exact plain attention in kernel 3's place, draw 0
# missed a single-draw gate). W was calibrated on the kernels' CUDA-core bf16
# forms, before their tensor-core forms (--probe-bf16-gate, 8 draws, on an
# H100 at 700 W, PERF.md §6): the
# worst ratio of the kernel route (median 0.696, worst 1.200), the route
# with frame_attention_plain in kernel 3's place (0.631, 1.240) and the
# route with bilstm_fused_forward_plain in kernel 7's place (0.660, 0.706),
# all three right by construction, is 1.240; W = 1.25 x that. The controls,
# the kernel route with one fault in every call, must miss the gate
# (WIDE_CONTROLS): kernel 7's output with one line dropped (median 1.954 on
# the 8 draws) and kernel 3's with one head scaled by 1 + 1e-1 (1.520), the
# smallest scale of 1e-2, 3e-2, 1e-1 that it catches; 1 + 1e-2 (0.719) and
# 1 + 3e-2 (0.982) pass it, so the scale of 1e-2 is read and reported
# (WIDE_REPORTED), not required to miss.
WIDE_GATE_DRAWS = 5
WIDE_GATE_W = 1.55


def wide_gate_audio(draw: int, dev) -> torch.Tensor:
    """Draw ``draw``'s 1 s of audio (draws above 0; draw 0 keeps the phase's)."""
    rng = np.random.default_rng((SEED + 92, draw))
    return torch.as_tensor(rng.standard_normal((1, 16000)).astype(np.float32) * 0.3, device=dev)


def attention_head_scaled(scale: float):
    """While open, kernel 3's output has its first head's values scaled by
    ``1 + scale`` (in bf16, as the kernel returns it)."""
    from fdbm_tpu_torch.models import tfgridnet

    fn = tfgridnet.frame_attention

    def faulty(q, k, v, n_head, e_dim, norms=None):
        out = fn(q, k, v, n_head, e_dim, norms=norms)
        out.view(*out.shape[:-1], n_head, -1)[..., 0, :] *= 1 + scale
        return out

    return swapped(tfgridnet, "frame_attention", faulty)


def lstm_lines_dropped(lines: int):
    """While open, kernel 7's forward output has ``lines`` lines from line 1
    on zeroed."""
    from fdbm_tpu_torch.models import layers

    fn = layers.bilstm_fused_forward

    def faulty(x, *weights):
        fwd, bwd = fn(x, *weights)
        fwd = fwd.clone()
        fwd[:, 1:1 + lines] = 0
        return fwd, bwd

    return swapped(layers, "bilstm_fused_forward", faulty)


def plain_in_place(which: str):
    """While open, the 6l48c200 serve runs kernel 3's (``attention``) or
    kernel 7's (``lstm``) plain version in the kernel's place."""
    from fdbm_tpu_torch.models import layers, tfgridnet
    from fdbm_tpu_torch.ops import attention, lstm

    if which == "attention":
        return swapped(tfgridnet, "frame_attention", attention.frame_attention_plain)
    return swapped(layers, "bilstm_fused_forward", lstm.bilstm_fused_forward_plain)


# The gate's fault controls, which must miss it, and the fault it cannot
# see, read beside them.
WIDE_CONTROLS = {
    "lstm_line_dropped": lambda: lstm_lines_dropped(1),
    "attention_head_scaled_1e-1": lambda: attention_head_scaled(1e-1),
}
WIDE_REPORTED = {"attention_head_scaled_1e-2": lambda: attention_head_scaled(1e-2)}
# --probe-bf16-gate's routes beside them: the two plain-in-place routes that
# calibrate W, and other faults of both kinds, for the smallest one caught.
WIDE_PROBE_ROUTES = {
    "plain_attention": lambda: plain_in_place("attention"),
    "plain_lstm": lambda: plain_in_place("lstm"),
    **WIDE_CONTROLS,
    **WIDE_REPORTED,
    "attention_head_scaled_3e-2": lambda: attention_head_scaled(3e-2),
    "attention_head_scaled_3e-1": lambda: attention_head_scaled(3e-1),
    "attention_head_scaled_1": lambda: attention_head_scaled(1.0),
    "lstm_lines_dropped_16": lambda: lstm_lines_dropped(16),
    "lstm_lines_dropped_64": lambda: lstm_lines_dropped(64),
}


def wide_gate_draws(dev, draws: int, first_audio: torch.Tensor, routes: dict,
                    expected: dict) -> list:
    """The 2-step bf16 serve of 6l48c200 on ``draws`` draws: the kernel
    route, the bf16 plain route and the plain network in float64
    (``bf16_gate``), the kernel route's launches against ``expected``, and
    each of ``routes`` (a context that changes the kernel route) against the
    same float64 serve and limit. One record a draw, with the ratios."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import FDBMConfig
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    cfg = FDBMConfig(inference_dtype="bfloat16")
    records = []
    for i in range(draws):
        torch.manual_seed(SEED + i)
        fdbm = fdbm_with(TFGridNet, dev, cfg, serve_dtype=torch.bfloat16)
        plain = fdbm_with(TFGridNet, dev, cfg, use_kernels=False, serve_dtype=torch.bfloat16)
        plain.dnn.load_state_dict(fdbm.dnn.state_dict())
        f64 = fdbm_with(TFGridNet, dev, cfg, use_kernels=False, serve_dtype=torch.float32)
        f64.dnn.load_state_dict(fdbm.dnn.state_dict())
        f64.dnn = Float64Backbone(f64.dnn).eval()
        audio = first_audio if i == 0 else wide_gate_audio(i, dev)
        serve = lambda f: f.enhance_batch(
            audio, torch.Generator(device=dev).manual_seed(SEED + i), sampler_type="sde_ei", N=2)
        ops.reset_launch_counts()
        out = serve(fdbm)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = serve(f64)
        gate = bf16_gate(out, serve(plain), want, tol=None)
        rec = {"draw": i, **gate, "ratio": gate["kernel_f64"] / gate["limit_f64"],
               "finite": bool(torch.isfinite(as_real64(out)).all()),
               "launches": counts, "launches_ok": only_bf16(counts, expected)}
        for name, route in routes.items():
            with route():
                got = serve(fdbm)
            dist = rel_err(as_real64(got), as_real64(want))
            rec[name] = {"kernel_f64": dist, "ratio": dist / gate["limit_f64"],
                         "finite": bool(torch.isfinite(as_real64(got)).all())}
        records.append(rec)
        del fdbm, plain, f64
    return records


def several_draws(ratios) -> dict:
    """The several-draw gate on one route's ratios."""
    med, worst = float(np.median(ratios)), float(max(ratios))
    return {"ratios": list(ratios), "median_ratio": med, "worst_ratio": worst,
            "w": WIDE_GATE_W, "ok": med <= 1.0 and worst <= WIDE_GATE_W}


def wide_gate_phase(dev, first_audio: torch.Tensor, expected: dict) -> None:
    """serve_check_bf16's 6l48c200 gate over WIDE_GATE_DRAWS draws: the
    kernel route passes ``several_draws``, launching only the bf16 forms as
    ``expected`` on every draw, and each of WIDE_CONTROLS misses it;
    WIDE_REPORTED's gates are printed."""
    records = wide_gate_draws(dev, WIDE_GATE_DRAWS, first_audio,
                              {**WIDE_CONTROLS, **WIDE_REPORTED}, expected)
    for rec in records:
        emit({"phase": "serve_check_bf16_draw", "backbone": WIDE, "batch": 1,
              "sampler": "sde_ei", "N": 2, **rec})
    gate = several_draws([r["ratio"] for r in records])
    controls = {name: several_draws([r[name]["ratio"] for r in records])
                for name in (*WIDE_CONTROLS, *WIDE_REPORTED)}
    ok = (gate["ok"] and all(r["launches_ok"] and r["finite"] for r in records)
          and not any(controls[name]["ok"] for name in WIDE_CONTROLS))
    emit({"phase": "serve_check_bf16", "backbone": WIDE, "batch": 1, "sampler": "sde_ei",
          "N": 2, "draws": WIDE_GATE_DRAWS, **gate,
          "controls_missed": {name: not controls[name]["ok"] for name in WIDE_CONTROLS},
          "controls": controls, "ok": ok})
    if not ok:
        fail(f"{WIDE} bf16 serve over {WIDE_GATE_DRAWS} draws: {gate}, controls {controls}, "
             f"launches {[r['launches'] for r in records]}, expected {expected}")


def probe_bf16_gate(out_path: str, draws: int) -> None:
    """Only the 6l48c200 bf16 serve over ``draws`` draws through the kernel
    route and WIDE_PROBE_ROUTES (the plain-in-place routes that calibrate
    WIDE_GATE_W, the controls and larger faults of their kinds), each
    route's several-draw gate, written to ``out_path`` as JSON; fails on
    nothing."""
    from fdbm_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": nvidia_smi()})
    emit({"phase": "build", "nvcc_seconds": _build.build_all()["seconds"]})
    rng = np.random.default_rng(SEED + 92)
    rng.standard_normal((1, 16000))
    rng.standard_normal((FOLDER_BATCH, 16000))  # serve_check_bf16's draws before 6l48c200's
    first = torch.as_tensor(rng.standard_normal((1, 16000)).astype(np.float32) * 0.3, device=dev)
    records = wide_gate_draws(dev, draws, first, WIDE_PROBE_ROUTES, {})
    for rec in records:
        emit({"phase": "probe_bf16_gate_draw", **{k: v for k, v in rec.items()
                                                   if k != "launches"}})
    gates = {"kernel": several_draws([r["ratio"] for r in records])}
    gates.update({name: several_draws([r[name]["ratio"] for r in records])
                  for name in WIDE_PROBE_ROUTES})
    emit({"phase": "probe_bf16_gate", "draws": draws, "gates": gates})
    with open(out_path, "w") as f:
        json.dump({"records": records, "gates": gates}, f)


def quality_pairs(count: int, seconds: float, seed: int):
    """Speech-like clean signals and their noisy copies (white noise at 0 dB
    SNR), normalised by the noisy peak as the data loader does."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(count):
        clean = speechlike(seconds, seed + i) * rng.uniform(0.5, 1.5)
        noisy = clean + rng.standard_normal(len(clean)).astype(np.float32) * clean.std()
        peak = np.abs(noisy).max()
        pairs.append(((clean / peak).astype(np.float32), (noisy / peak).astype(np.float32)))
    return pairs


def quality_fit(dev, compute_dtype: str, steps: int = QUALITY_STEPS, lr: float = QUALITY_LR,
                batch_size: int = QUALITY_BATCH, every: int = 0, on_checkpoint=None):
    """5l32c100 trained ``steps`` steps at ``compute_dtype`` from seed SEED
    on QUALITY_TRAIN_FILES speech-like pairs, ``batch_size`` crops of 256
    frames a step (the same crops and draws at either dtype), on cuDNN's
    deterministic algorithms. Returns the EMA and
    the untrained weights, the losses and the training's seconds; every
    ``every`` steps ``on_checkpoint(step, ema, losses)`` reads the EMA."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState

    crop = (TRAIN_FRAMES - 1) * 256
    train = quality_pairs(QUALITY_TRAIN_FILES, 5.0, SEED + 100)
    rng = np.random.default_rng(SEED + 93)
    torch.manual_seed(SEED)
    with cudnn_deterministic():
        fdbm = FDBM(FDBMConfig(lr=lr, compute_dtype=compute_dtype), device=dev)
        untrained = {k: v.detach().clone() for k, v in fdbm.dnn.state_dict().items()}
        state = TrainState(fdbm.dnn)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses, seconds = [], 0.0
        for step in range(1, steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            picks = rng.integers(0, len(train), batch_size)
            starts = rng.integers(0, len(train[0][0]) - crop, batch_size)
            batch = tuple(torch.as_tensor(np.stack([train[p][j][s:s + crop]
                                                    for p, s in zip(picks, starts)]), device=dev)
                          for j in (0, 1))
            losses.append(fdbm.train_step(state, batch, gen)["train_loss"])
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            if every and step % every == 0:
                on_checkpoint(step, state.ema, losses)
    return state.ema, untrained, losses, seconds


def quality_serve(weights, dev, dtypes=("float32", "bfloat16")) -> dict:
    """``weights`` (5l32c100) serving the QUALITY_TEST_FILES held-out files
    with ode_ei at N=QUALITY_N at each of ``dtypes`` (the serving dtype),
    on cuDNN's deterministic algorithms: the outputs, their SI-SDR against
    the clean files, the noisy files' and the launches."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import FDBM, FDBMConfig
    from fdbm_tpu_torch.utils.metrics import si_sdr

    test = quality_pairs(QUALITY_TEST_FILES, QUALITY_SECONDS, SEED + 200)
    outs = {"noisy_si_sdr": [si_sdr(clean, noisy) for clean, noisy in test]}
    with cudnn_deterministic():
        for dtype in dtypes:
            model = FDBM(FDBMConfig(inference_dtype=dtype), device=dev)
            model.dnn.load_state_dict(weights)
            ops.reset_launch_counts()
            outs[dtype] = [model.enhance_audio(noisy, torch.Generator(device=dev).manual_seed(SEED),
                                               sampler_type="ode_ei", N=QUALITY_N)
                           for _, noisy in test]
            outs[dtype + "_launches"] = ops.launch_counts()
            outs[dtype + "_si_sdr"] = [si_sdr(clean, out)
                                       for (clean, _), out in zip(test, outs[dtype])]
    return outs


def quality_models(dev, compute_dtype: str) -> dict:
    """``quality_fit`` for QUALITY_TRAIN_STEPS steps: the EMA at
    QUALITY_STEPS (``bf16_quality``'s model) and at the end
    (``bf16_train_quality``'s), the untrained weights, the losses and the
    seconds."""
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    early = {}
    ema, untrained, losses, seconds = quality_fit(
        dev, compute_dtype, QUALITY_TRAIN_STEPS, every=QUALITY_STEPS,
        on_checkpoint=lambda step, ema, _: early or early.update(cpu(ema)))
    return {"ema": cpu(ema), "ema_early": early, "untrained": cpu(untrained),
            "losses": losses, "seconds": seconds}


def quality_worker(compute_dtype: str, out_path: str) -> None:
    """``quality_models`` in a process of its own, written to ``out_path``."""
    torch.save(quality_models(torch.device("cuda"), compute_dtype), out_path)


def quality_probe_worker(compute_dtype: str, spec: str, steps: str, out_path: str) -> None:
    """``quality_fit`` at ``spec`` (``LR`` or ``LR,BATCH``) for ``steps``
    steps, its EMA served in fp32 and in bf16 every QUALITY_PROBE_EVERY
    steps; the readings to ``out_path`` (JSON)."""
    lr, batch_size = (spec.split(",") + [str(QUALITY_BATCH)])[:2]
    dev = torch.device("cuda")
    rows = []

    def read(step, ema, losses):
        served = quality_serve({k: v.detach().clone() for k, v in ema.items()}, dev)
        rows.append({"step": step, "loss_last_50": float(np.mean(losses[-50:])),
                     **{f"si_sdr_mean_{d}_db": float(np.mean(served[d + "_si_sdr"]))
                        for d in ("float32", "bfloat16")},
                     "si_sdr_noisy_mean_db": float(np.mean(served["noisy_si_sdr"]))})
        print(json.dumps({"compute_dtype": compute_dtype, "lr": float(lr),
                          "batch": int(batch_size), **rows[-1]}), file=sys.stderr, flush=True)

    *_, seconds = quality_fit(dev, compute_dtype, int(steps), float(lr), int(batch_size),
                              QUALITY_PROBE_EVERY, read)
    with open(out_path, "w") as f:
        json.dump({"compute_dtype": compute_dtype, "lr": float(lr), "batch": int(batch_size),
                   "train_seconds": seconds, "rows": rows}, f)


def probe_quality(out_path: str, steps: int, specs) -> None:
    """``bf16_quality``'s training at each of ``specs`` (``LR`` or
    ``LR,BATCH``) in fp32 and in bf16,
    each in a worker process of its own (all at once on the card), for
    ``steps`` steps: the mean SI-SDR of the EMA served in fp32 and in bf16
    every QUALITY_PROBE_EVERY steps, beside the noisy input's; the readings
    the training's steps and rate are chosen from, written to ``out_path``."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    me = os.path.abspath(__file__)
    runs = {(d, spec): os.path.join(tmp, f"{d}_{spec}.json")
            for d in ("float32", "bfloat16") for spec in specs}
    procs = [start_worker([me, "--quality-probe-worker", d, spec, str(steps), path])
             for (d, spec), path in runs.items()]
    wait_workers(procs, t0, "probe_quality", 3000)
    out = {"steps": steps, "every": QUALITY_PROBE_EVERY, "nvidia_smi": nvidia_smi(),
           "wall_seconds": time.perf_counter() - t0,
           "runs": [json.load(open(path)) for path in runs.values()]}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    emit({"phase": "probe_quality", **out})


def start_quality_workers(tmp: str) -> dict:
    """Starts ``bf16_quality``'s two trainings (fp32 and bf16), each in a
    process of its own, to run beside the phases up to theirs."""
    me = os.path.abspath(__file__)
    paths = {d: os.path.join(tmp, f"quality_{d}.pt") for d in ("float32", "bfloat16")}
    return {"t0": time.perf_counter(), "paths": paths,
            "procs": {d: start_worker([me, "--quality-worker", d, path])
                      for d, path in paths.items()}}


def quality_result(workers: dict, compute_dtype: str) -> dict:
    """The ``quality_models`` of ``compute_dtype``'s worker (waited for)."""
    wait_workers([workers["procs"][compute_dtype]], workers["t0"],
                 f"bf16_quality ({compute_dtype} training)", QUALITY_WORKER_TIMEOUT)
    return torch.load(workers["paths"][compute_dtype], map_location="cuda", weights_only=True)


@cudnn_deterministic()
def bf16_quality_phase(dev, smi: str, workers: dict = None) -> None:
    """bf16 serving and bf16 training on trained weights. Random weights
    cannot judge them (a random 30-step sampler is chaotic: 0.4 dB SI-SDR
    between fp32 and bf16 in the JAX package's records), so 5l32c100 is
    trained on the card first (``quality_fit``: ``FDBM.train_step`` at B=2
    x 256 frames on speech-like pairs at 0 dB SNR, lr QUALITY_LR) and served
    on QUALITY_TEST_FILES held-out files with ode_ei at N=QUALITY_N
    (``quality_serve``). ``bf16_quality``: the EMA at QUALITY_STEPS served
    in fp32 and in bf16, the mean SI-SDR of the bf16 outputs against the
    fp32 outputs (agreement) at least QUALITY_AGREEMENT_DB, and the mean
    enhanced-vs-clean SI-SDR of bf16 within QUALITY_DELTA_DB of fp32's; the
    same agreement on the untrained weights is printed as a control.
    ``bf16_train_quality``: the same training continued to
    QUALITY_TRAIN_STEPS at ``compute_dtype: float32`` and ``bfloat16``,
    each served at its serving dtype (bf16 inherited), the bf16-trained
    model's mean SI-SDR within QUALITY_TRAIN_DELTA_DB of the fp32-trained
    model's; the noisy input's is printed beside them. The trainings run on
    cuDNN's deterministic algorithms, so every run trains and judges the
    same models: on the default ones the training differed from run to run
    (PERF.md §6). ``workers`` (``start_quality_workers``) have trained both
    models beside the earlier phases; without them they train here."""
    from fdbm_tpu_torch.utils.metrics import si_sdr

    fit = {dtype: quality_models(dev, dtype) if workers is None else
           quality_result(workers, dtype) for dtype in ("float32", "bfloat16")}
    mean = lambda v: float(np.mean(v))
    losses = fit["float32"]["losses"]
    trained = quality_serve(fit["float32"]["ema_early"], dev)
    control = quality_serve(fit["float32"]["untrained"], dev)
    agree = [si_sdr(a, b) for a, b in zip(trained["float32"], trained["bfloat16"])]
    quality = {dtype: trained[dtype + "_si_sdr"] for dtype in ("float32", "bfloat16")}
    noisy_db = trained["noisy_si_sdr"]
    delta = mean(quality["bfloat16"]) - mean(quality["float32"])
    calls = QUALITY_N * QUALITY_TEST_FILES
    expected = {k: v * calls for k, v in BF16_CALL_LAUNCHES.items()}
    ok = (mean(agree) >= QUALITY_AGREEMENT_DB and abs(delta) <= QUALITY_DELTA_DB
          and all(np.isfinite(losses)) and only_bf16(trained["bfloat16_launches"], expected))
    emit({"phase": "bf16_quality", "backbone": RNN_MODEL, "steps": QUALITY_STEPS,
          "lr": QUALITY_LR, "batch": QUALITY_BATCH, "frames": TRAIN_FRAMES,
          "loss_first_10": mean(losses[:10]),
          "loss_last_10": mean(losses[QUALITY_STEPS - 10:QUALITY_STEPS]), "sampler": "ode_ei",
          "N": QUALITY_N, "test_files": QUALITY_TEST_FILES, "test_seconds": QUALITY_SECONDS,
          "agreement_db": agree, "agreement_mean_db": mean(agree),
          "agreement_gate_db": QUALITY_AGREEMENT_DB,
          "si_sdr_noisy_db": noisy_db, "si_sdr_fp32_db": quality["float32"],
          "si_sdr_bf16_db": quality["bfloat16"], "si_sdr_mean_fp32_db": mean(quality["float32"]),
          "si_sdr_mean_bf16_db": mean(quality["bfloat16"]), "si_sdr_delta_db": delta,
          "delta_gate_db": QUALITY_DELTA_DB,
          "control_untrained_agreement_db": [si_sdr(a, b) for a, b in
                                             zip(control["float32"], control["bfloat16"])],
          "launches_bf16": trained["bfloat16_launches"], "nvidia_smi": smi})
    if not ok:
        fail(f"bf16_quality: agreement {agree} (mean >= {QUALITY_AGREEMENT_DB} dB), "
             f"SI-SDR fp32 {quality['float32']} bf16 {quality['bfloat16']} (delta {delta}), "
             f"launches {trained['bfloat16_launches']} (expected {expected})")

    served = {dtype: quality_serve(fit[dtype]["ema"], dev, (dtype,))[dtype + "_si_sdr"]
              for dtype in ("float32", "bfloat16")}
    losses16 = fit["bfloat16"]["losses"]
    delta16 = mean(served["bfloat16"]) - mean(served["float32"])
    above = {dtype: mean(v) > mean(noisy_db) for dtype, v in served.items()}
    ok = abs(delta16) <= QUALITY_TRAIN_DELTA_DB and all(np.isfinite(losses16))
    emit({"phase": "bf16_train_quality", "backbone": RNN_MODEL, "steps": QUALITY_TRAIN_STEPS,
          "lr": QUALITY_LR, "batch": QUALITY_BATCH, "compute_dtype": "bfloat16",
          "train_seconds": {d: fit[d]["seconds"] for d in fit},
          "loss_last_50": {d: mean(fit[d]["losses"][-50:]) for d in fit},
          "si_sdr_bf16_trained_served_bf16_db": served["bfloat16"],
          "si_sdr_fp32_trained_served_fp32_db": served["float32"],
          "si_sdr_mean_bf16_trained_db": mean(served["bfloat16"]),
          "si_sdr_mean_fp32_trained_db": mean(served["float32"]),
          "si_sdr_mean_noisy_db": mean(noisy_db), "above_noisy": above,
          "delta_db": delta16, "delta_gate_db": QUALITY_TRAIN_DELTA_DB, "nvidia_smi": smi})
    if not ok:
        fail(f"bf16_train_quality: bf16-trained SI-SDR {served['bfloat16']} against the "
             f"fp32-trained {served['float32']} (delta {delta16}, gate +-"
             f"{QUALITY_TRAIN_DELTA_DB} dB), losses finite {all(np.isfinite(losses16))}")


# -- bf16 training: compute_dtype=bfloat16 ------------------------------------------------

# A bf16 training step (kernels 4-6 and 8-9 on fp32 casts, the glue in bf16)
# against the same step through the float64 network, on the same batch,
# (t, z) and weights, by loss, backbone output, whole gradient and group of
# leaves (``bf16_group``, its gradients concatenated, floored at 1e-4 of the
# float64 gradient's norm). TF-GridNet: each, the worst over BF16_DRAWS
# draws, within BF16_F64_K x the bf16 plain route's worst there plus
# BF16_F64_ABS. NCSN++ has one route (no
# kernel on its path), so it is held to absolute bounds: the loss, the
# output and the whole gradient within NCSNPP_TRAIN_BF16_TOL, each group
# within NCSNPP_TRAIN_BF16_GROUP_TOL (the readings: 2.2e-4-1.7e-3, 8.3e-3,
# 1.6e-2 and groups 3.9e-3-2.8e-2 over three runs), the output and the whole
# gradient above 1e-4. Both: the bf16 step's whole gradient at least
# BF16_TRAIN_RATIO times farther from float64 than the fp32 step's (bf16
# ran); the kernels launched under their fp32 names and no bf16 form; and
# two controls that must miss: every group's gradient zeroed in turn must
# miss that group's limit, and the kernel route on the weights rounded to
# bf16 (a bf16 training that dropped its fp32 master weights) must miss a
# limit.
BF16_TRAIN_RATIO = 3.0
# TF-GridNet's steps are taken on this many draws of batch and (t, z), and
# each route's distance to float64 is its worst over them.
BF16_DRAWS = 2
NCSNPP_TRAIN_BF16_TOL, NCSNPP_TRAIN_BF16_GROUP_TOL = 3e-2, 5e-2
# TF-GridNet's steps run on weights whose q/k projections (attn_conv_Q and
# attn_conv_K, weights and biases) are scaled by QK_SMOOTH. At the default
# init the E=2 lane norms see lanes of about 1, and the norm of two lanes has
# a derivative of up to 1/(2 sqrt(eps)) = 158 where they tie within
# sqrt(eps) = 3.2e-3; bf16 rounds a lane by 4e-3, so at the few near-tie
# positions, which carry the gradients, a bf16 route's derivative is a new
# draw: two bf16 routes that differ only by the fp32 kernels' last bits read
# 5l32c100's groups 0.04-0.48 from float64 and 6l48c200's up to 1.8, where a
# zeroed group reads 1.0 (PERF.md §6). Scaled, the lanes' differences sit
# inside the norm's smooth range and bf16 moves them by about 1e-4 of it.
QK_SMOOTH = 0.02


def smooth_qk_(net: torch.nn.Module) -> torch.nn.Module:
    """``net``'s q/k projections scaled by QK_SMOOTH (see above)."""
    with torch.no_grad():
        for block in net.blocks:
            for layer in (block.attn_conv_Q, block.attn_conv_K):
                for p in layer.parameters():
                    p.mul_(QK_SMOOTH)
    return net


def bf16_group(name: str) -> str:
    """``leaf_group`` for a TF-GridNet block's leaves, the block (or layer)
    for the other leaves of a backbone, ``stem`` for a top-level leaf."""
    if name.startswith("blocks."):
        return leaf_group(name)
    parts = name.split(".")
    return parts[0] if len(parts) > 2 else "stem"


def step_grads(fdbm, batch, t, z, outputs: dict = None, name: str = ""):
    """The loss and the parameter gradients (float64 copies) of one
    training step on ``batch`` and the draw ``(t, z)``; the backbone's
    output (complex64) goes to ``outputs[name]`` where ``outputs`` is
    given."""
    params = {n: p for n, p in fdbm.dnn.named_parameters() if p.requires_grad}
    hook = None if outputs is None else fdbm.dnn.register_forward_hook(
        lambda m, args, out: outputs.update({name: out.detach().to(torch.complex64)}))
    loss = fdbm.loss_fn(batch, prior=(t, z))
    grads = torch.autograd.grad(loss, list(params.values()))
    if hook is not None:
        hook.remove()
    return float(loss.detach()), {n: g.double() for n, g in zip(params, grads)}


def bf16_limits(dist: dict, groups: dict, kernels: bool) -> dict:
    """The limit of each quantity of ``dist["kernel"]`` (see above)."""
    if kernels:
        return {q: BF16_F64_K * v + BF16_F64_ABS for q, v in dist["plain"].items()}
    return {q: NCSNPP_TRAIN_BF16_GROUP_TOL if q in groups else NCSNPP_TRAIN_BF16_TOL
            for q in dist["kernel"]}


def bf16_gates(phase: str, dist: dict, groups: dict, zeroed: dict, grads: dict, loss: float,
               counts: dict, expected: dict, kernels: bool, record: dict) -> None:
    """Emit a bf16 step's record and hold it to the gates above: ``dist``
    are the routes' (kernel, plain, fp32, bf16_weights) distances to
    float64 by quantity, ``zeroed`` each group's distance with its gradient
    zeroed, ``grads`` and ``loss`` the kernel route's."""
    limits = bf16_limits(dist, groups, kernels)
    missed = lambda route: sorted(q for q in limits if not dist[route][q] <= limits[q])
    ran = kernels or all(dist["kernel"][q] > 1e-4 for q in ("output", "whole"))
    ratio = dist["kernel"]["whole"] / dist["fp32"]["whole"]
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values()) and math.isfinite(loss)
    bf16_launched = {k: v for k, v in counts.items() if k.endswith("_bf16") and v}
    worst = max(((q, dist["kernel"][q] / v) for q, v in limits.items()), key=lambda a: a[1])
    zeroed_passed = sorted(q for q, v in zeroed.items() if v <= limits[q])
    controls = {"bf16_weights_missed": missed("bf16_weights"), "zeroed_group": zeroed,
                "zeroed_group_passed": zeroed_passed}
    emit({"phase": phase, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES, **record,
          "groups": len(groups), "distance_to_float64": dist, "limits": limits,
          "worst_over_limit": worst, "missed": missed("kernel"), "controls": controls,
          "bf16_over_fp32_whole": ratio, "ratio_gate": BF16_TRAIN_RATIO, "launches": counts,
          "expected_launches": expected})
    if missed("kernel") or not ran or not ratio >= BF16_TRAIN_RATIO or not finite \
            or bf16_launched or any(counts[k] != v for k, v in expected.items()):
        fail(f"{phase}: missed {missed('kernel')} ({worst}), above 1e-4 {ran}, bf16/fp32 "
             f"{ratio} (>= {BF16_TRAIN_RATIO}), finite {finite}, launches {counts} "
             f"(expected {expected})")
    if not controls["bf16_weights_missed"] or zeroed_passed:
        fail(f"{phase}: a control met the gate: {controls}")


def bf16_grad_phase(rng, dev, backbone, phase: str, expected: dict, kernels: bool = True,
                    init=None, seed: int = SEED, kernel_flops=None):
    """Full-width bf16 training steps (B=2, 256 frames) through the kernel
    route, the bf16 plain route (where the backbone has a kernel route;
    NCSN++ has none, so its one route is both), the fp32 kernel route and
    the float64 plain network (``Float64Backbone``), on the same weights
    (``init`` sets them), held to the gates above; on TF-GridNet on
    BF16_DRAWS draws of batch and (t, z), each route's distances the worst
    over the draws (one draw's groups scatter by up to 1.7x between two
    bf16 routes, PERF.md §6), on NCSN++ on one. The kernel route on the
    weights rounded to bf16 (a control) runs on the first draw; ``expected``
    are the kernel route's launches there. Returns the FLOPs of the kernel
    route's step: ``flops_estimate`` of it (its products and convolutions
    on PyTorch ops) plus ``kernel_flops``, the products of the CUDA kernels
    it launched, which are opaque to the counter, from their shapes. The
    plain route's count is the same sum (1,750,987,617,280 for 5l32c100,
    PERF.md §6) at several times the cost: its recurrences are many small
    ops."""
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.model import FDBMConfig
    from fdbm_tpu_torch.utils.profiling import flops_estimate

    cfg = FDBMConfig(compute_dtype="bfloat16")
    torch.manual_seed(seed)
    kernel = fdbm_with(backbone, dev, cfg)
    if init is not None:
        init(kernel.dnn)
    weights = kernel.dnn.state_dict()
    # remat keeps the plain and float64 TF-GridNet routes' memory in bounds
    # (recomputing a block's forward repeats its bits).
    plain_kw = {"use_kernels": False, "remat": True} if kernels else {}
    routes = {"kernel": kernel,
              "plain": fdbm_with(backbone, dev, cfg, **plain_kw) if kernels else None,
              "fp32": fdbm_with(backbone, dev),
              "bf16_weights": fdbm_with(backbone, dev, cfg),
              "f64": fdbm_with(backbone, dev, **plain_kw)}
    for name, f in routes.items():
        if name != "kernel" and f is not None:
            f.dnn.load_state_dict(weights)
    with torch.no_grad():
        for p in routes["bf16_weights"].dnn.parameters():
            p.copy_(p.bfloat16().float())
    routes["f64"].dnn = Float64Backbone(routes["f64"].dnn)
    shape = (TRAIN_BATCH, 1, cfg.n_fft // 2 + 1, TRAIN_FRAMES)
    t = torch.tensor([0.3, 0.8], device=dev)
    seconds, draws = {}, []
    flops = counts = None
    for draw in range(BF16_DRAWS if kernels else 1):
        batch = synthetic_batch(rng, dev)
        z = torch.complex(*(torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                                            / math.sqrt(2), device=dev) for _ in range(2)))
        outputs, results = {}, {}
        for name, fdbm in routes.items():
            if fdbm is None or (draw and name == "bf16_weights"):
                continue
            torch.cuda.synchronize()
            start = time.perf_counter()
            if name == "kernel" and not draw:
                ops.reset_launch_counts()
                out = []
                flops = flops_estimate(lambda: out.append(step_grads(fdbm, batch, t, z, outputs,
                                                                     name)))
                results[name], counts = out[0], ops.launch_counts()
            else:
                results[name] = step_grads(fdbm, batch, t, z, outputs, name)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - start
            torch.cuda.empty_cache()
        if not kernels:
            results["plain"], outputs["plain"] = results["kernel"], outputs["kernel"]
        loss64, g64 = results.pop("f64")
        g64 = {n.removeprefix("net."): g for n, g in g64.items()}
        norm64 = math.sqrt(sum(float((g * g).sum()) for g in g64.values()))
        groups = {}
        for n in g64:
            groups.setdefault(bf16_group(n), []).append(n)
        cat = lambda g, names: torch.cat([g[n].reshape(-1) for n in names])
        dist = {r: {"loss": abs(l - loss64) / abs(loss64),
                    "output": rel_err(outputs[r], outputs["f64"]),
                    **{grp: grad_rel(cat(g, names), cat(g64, names), 1e-4 * norm64)
                       for grp, names in groups.items()},
                    "whole": grad_rel(cat(g, list(g64)), cat(g64, list(g64)))}
                for r, (l, g) in results.items()}
        if not draw:
            zeroed = {grp: grad_rel(torch.zeros_like(cat(g64, names)), cat(g64, names),
                                    1e-4 * norm64) for grp, names in groups.items()}
            first = {"loss": results["kernel"][0], "grads": results["kernel"][1],
                     "loss_float64": loss64}
        draws.append(dist)
        del results, outputs, g64
    del kernel, routes
    torch.cuda.empty_cache()
    worst = {r: {q: max(d[r][q] for d in draws if r in d) for q in draws[0][r]}
             for r in draws[0]}
    bf16_gates(phase, worst, groups, zeroed, first["grads"], first["loss"], counts, expected,
               kernels, {"kernel_route": kernels, "init": getattr(init, "__name__", None),
                         "draws": len(draws), "loss": first["loss"],
                         "loss_float64": first["loss_float64"],
                         "distance_by_draw": draws if len(draws) > 1 else None,
                         "seconds_by_route": seconds,
                         "flops_per_step": flops + (kernel_flops or 0)})
    return flops + (kernel_flops or 0)


def finetune_bf16_phase(rng, dev) -> dict:
    """One fine-tuning step of 5l32c100 at ``compute_dtype: bfloat16`` (B=2,
    256 frames, N=5 ``ode_ei``): its N-1 gradient-free calls serve in bf16
    (kernels 1-3 in their bf16 forms), its last call trains in bf16 with
    kernels 5-6 on fp32 lines; the loss and every gradient finite. Returns
    the launches."""
    from fdbm_tpu_torch import losses, ops
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100

    torch.manual_seed(SEED)
    fdbm = fdbm_with(tfgridnet_5l32c100, dev,
                     dataclasses.replace(finetune_cfg(), compute_dtype="bfloat16"))
    x, y = (fdbm.audio_to_spec(a) for a in synthetic_batch(rng, dev))
    z = complex_like(rng, y)
    params = [p for p in fdbm.dnn.parameters() if p.requires_grad]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = losses.compute_loss(fdbm.loss_cfg, fdbm._finetune_unrolled(y, z=z), x)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    calls = FT_N - 1
    expected = {**dict.fromkeys(counts, 0),
                "grid_rnn_seq1_pair_bf16": RNN_PATHS * calls,
                "flat_group_norm_bf16": RNN_BLOCKS * calls,
                "frame_attention_bf16": RNN_BLOCKS * calls,
                "grid_fold_train_pair": RNN_PATHS, "grid_fold_train_pair_bwd": RNN_PATHS}
    finite = math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    emit({"phase": "finetune_bf16", "N": FT_N, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "serve_dtype": str(fdbm.serve_dtype), "train_dtype": str(fdbm.train_dtype),
          "loss": float(loss), "finite": finite, "seconds": wall, "launches": counts,
          "expected_launches": expected})
    if not finite or counts != expected:
        fail(f"finetune_bf16: loss {float(loss)}, finite {finite}, launches {counts} "
             f"(expected {expected})")
    return counts


def bf16_train_phases(rng, dev, smi: str) -> dict:
    """bf16 training: the steps against float64 (5l32c100, ncsnpp_v2 on
    fan-in weights; 6l48c200's runs in ``wide_train_phase``, on its float64
    network), one fine-tuning step, and the rates of 5l32c100's and
    ncsnpp_v2's bf16 steps with the FLOPs a step. Returns the launches of
    the 5l32c100 steady steps and the fine-tuning step."""
    from fdbm_tpu_torch.models.ncsnpp import ncsnpp_v2
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100
    from fdbm_tpu_torch.model import FDBMConfig

    t0 = time.perf_counter()
    seconds, totals = {}, {}

    def timed(name, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - start
        return out

    cfg = FDBMConfig(compute_dtype="bfloat16")
    per_step = {"grid_fold_train_pair": RNN_PATHS, "grid_fold_train_pair_bwd": RNN_PATHS}
    # Kernels 5-6 of a step: each block's intra path (263 bins a line, 2 x 262
    # lines) and inter path (262 frames a line, 2 x 263 lines), forward and backward.
    q_pad, t_pad = cfg.n_fft // 2 + 1 + 6, TRAIN_FRAMES + 6
    paths = (rnn_flops(TRAIN_BATCH * t_pad, q_pad - 3, 32, 100),
             rnn_flops(TRAIN_BATCH * q_pad, t_pad - 3, 32, 100))
    rnn = RNN_BLOCKS * sum(f["forward"] + f["backward"] for f in paths)
    flops = {}
    flops[RNN_MODEL] = timed("train_grad_bf16", bf16_grad_phase, rng, dev, tfgridnet_5l32c100,
                             "train_grad_bf16", per_step, init=smooth_qk_, kernel_flops=rnn)
    # The fp32 rate again next to the bf16 one: the first ran beside the
    # quality trainings (start_quality_workers).
    timed("train_rate_fp32", train_rate_phase, rng, dev, smi, tfgridnet_5l32c100,
          "train_rate_fp32", None, flops[RNN_MODEL])
    *_, counts = timed("train_rate_bf16", train_rate_phase, rng, dev, smi, tfgridnet_5l32c100,
                       "train_rate_bf16", cfg, flops[RNN_MODEL])
    totals.update(counts)
    for k, v in timed("finetune_bf16", finetune_bf16_phase, rng, dev).items():
        totals[k] = totals.get(k, 0) + v
    nothing = dict.fromkeys(totals, 0)
    with cudnn_benchmark():  # as the trainer runs
        flops[NCSNPP] = timed("ncsnpp_train_grad_bf16", bf16_grad_phase, rng, dev, ncsnpp_v2,
                              "ncsnpp_train_grad_bf16", nothing, kernels=False,
                              init=fan_in_weights_)
        timed("ncsnpp_train_rate_bf16", train_rate_phase, rng, dev, smi, ncsnpp_v2,
              "ncsnpp_train_rate_bf16", cfg, flops[NCSNPP])
    # The fp32 and bf16 steps of each model (ncsnpp_v2's fp32 rate ran earlier
    # in this run).
    pairs = {RNN_MODEL: ("train_rate_fp32", "train_rate_bf16"),
             NCSNPP: ("ncsnpp_train_rate", "ncsnpp_train_rate_bf16")}
    emit({"phase": "bf16_train_rates", "flops_per_step": flops,
          "step_ms": {m: [STEP_MS.get(p) for p in ps] for m, ps in pairs.items()},
          "tflops_per_second_fp32_bf16": {
              m: [flops[m] / STEP_MS[p] / 1e9 if p in STEP_MS else None for p in ps]
              for m, ps in pairs.items()},
          "bf16_over_fp32_step": {m: STEP_MS[b] / STEP_MS[f] if f in STEP_MS else None
                                  for m, (f, b) in pairs.items()},
          "seconds_by_phase": seconds, "wall_seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    return totals


def bf16_phases(dev, smi: str, quality_workers: dict = None) -> None:
    """The bf16 phases that have no fp32 run beside them: the backbones, the
    2-step serves and the quality on trained weights (trained by
    ``quality_workers`` where given)."""
    t0 = time.perf_counter()
    seconds_by_phase = {}
    for name, fn, args in (("backbone_bf16", backbone_bf16_phase, (dev,)),
                           ("serve_check_bf16", serve_check_bf16_phase, (dev,)),
                           ("bf16_quality", bf16_quality_phase, (dev, smi, quality_workers))):
        start = time.perf_counter()
        fn(*args)
        seconds_by_phase[name] = time.perf_counter() - start
    emit({"phase": "bf16_seconds", "seconds_by_phase": seconds_by_phase,
          "wall_seconds": time.perf_counter() - t0})


def main(kernels_only: bool = False, ncsnpp_only: bool = False, bf16_only: bool = False,
         parallel_only: int = 0, bf16_train_only: bool = False) -> None:
    """The smoke run; ``kernels_only`` stops after the kernel rows,
    ``ncsnpp_only`` runs only the NCSN++ phases (no kernel is built),
    ``bf16_only`` only the bf16 kernel rows and the phases with a bf16 run
    (beside their fp32 runs), ``parallel_only`` (R) only ``samplers`` R
    times on one model, each reading printed, and the data-parallel
    phases, ``bf16_train_only`` only the bf16 training phases (beside the
    fp32 rates), the quality on trained weights, the training CLI with its
    run logging and the pooled folder with its serving trace."""
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    from fdbm_tpu_torch import ops
    from fdbm_tpu_torch.checkpoint import save_checkpoint
    from fdbm_tpu_torch.dsp import num_frames_for_length
    from fdbm_tpu_torch.infer import bucket_length
    from fdbm_tpu_torch.model import FDBM, FDBMConfig
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100
    from fdbm_tpu_torch.ops import _build, attention as attn_ops, gridrnn

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    if ncsnpp_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            ncsnpp_phases(tmp, np.random.default_rng(SEED), dev, smi)
        emit({"phase": "done", "ncsnpp_only": True, "wall_seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        return

    # -- build ------------------------------------------------------------------
    built = _build.build_all()
    ptxas = [ln.strip() for rep in built["ptxas"].values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_seconds": built["seconds"], "built": built["built"],
          "libraries": built["libraries"], "ptxas": ptxas})
    if bf16_only:
        kernel_bf16_phase(dev, {})
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            torch.manual_seed(SEED)
            ckpt = os.path.join(tmp, "model.pt")
            save_checkpoint(ckpt, FDBM(FDBMConfig(), device="cuda"))
            _, noisy = serve_phase(tmp, ckpt, smi)
            serve_folder_bf16(tmp, ckpt, smi)
            wide_serve_phase(np.random.default_rng(SEED), dev, noisy)
            ncsnpp_ckpt, _ = ncsnpp_serve_phase(tmp, np.random.default_rng(SEED), dev, smi)
            ncsnpp_folder(tmp, ncsnpp_ckpt, smi, extra=(BF16_OVERRIDE,))
            bf16_phases(dev, smi)
        emit({"phase": "done", "bf16_only": True, "wall_seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        return

    if bf16_train_only:
        from fdbm_tpu_torch.models.ncsnpp import ncsnpp_v2

        rng = np.random.default_rng(SEED)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            quality = start_quality_workers(tmp)
            train_rate_phase(rng, dev, smi, tfgridnet_5l32c100)
            with cudnn_benchmark():
                train_rate_phase(rng, dev, smi, ncsnpp_v2, "ncsnpp_train_rate")
            bf16_train_phases(rng, dev, smi)
            wide_bf16_grad_phase(dev, {"lstm_core": 2 * WIDE_PATHS,
                                       "lstm_core_bwd": 2 * WIDE_PATHS})
            _, run = train_cli_phase(tmp, smi)
            serve_folder(tmp, os.path.join(run, "checkpoints", "last.pt"), "serve_folder",
                         folder_seconds(), "4.096", smi, trace=True)
            bf16_quality_phase(dev, smi, quality)
        emit({"phase": "done", "bf16_train_only": True,
              "wall_seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        return

    if parallel_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            torch.manual_seed(SEED)
            fdbm = FDBM(FDBMConfig(), device="cuda")
            ckpt = os.path.join(tmp, "model.pt")
            save_checkpoint(ckpt, fdbm)
            plain = FDBM(FDBMConfig(), device="cuda")
            plain.dnn = tfgridnet_5l32c100(use_kernels=False).to(dev).eval()
            plain.dnn.load_state_dict(fdbm.dnn.state_dict())
            workers = start_ddp_workers(tmp)
            failed = 0
            for _ in range(parallel_only):
                try:
                    samplers_phase(fdbm, plain, dev)
                except SystemExit:
                    failed += 1
            mesh_serve_phase(tmp, ckpt, fdbm, dev, smi)
            del fdbm, plain
            ddp_nccl_phase(workers, smi)
            ddp_two_ranks_phase(workers, dev)
        emit({"phase": "done", "parallel_only": True, "samplers_repeats": parallel_only,
              "samplers_failed": failed, "wall_seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        if failed:
            sys.exit(1)
        return

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
    maps = [(a, *p, wd) for a, p, wd in zip((q, k, v), norms, (e_dim, e_dim, d_dim))]
    per_map = lambda ms: [attn_ops.flat_group_norm(*m[:4], width=m[4]) for m in ms]
    plain = lambda ms: [attn_ops.flat_group_norm_plain(*m[:4], width=m[4]) for m in ms]
    # One launch for the three maps of an attention call; a parent checkout
    # (one launch a map) runs the per-map wrapper three times.
    norms3 = getattr(attn_ops, "flat_group_norms", per_map)
    want = plain(maps)
    err, abs_err = agreement(list(zip(norms3(maps), want)) + list(zip(per_map(maps), want)))
    elems = sum(m[0].numel() for m in maps)
    ops.reset_launch_counts()
    norms3(maps)
    launches = ops.launch_counts()["flat_group_norm"]
    norm_kernels = {"norm": ("group_norm_kernel", "norm_segments_kernel")}
    summary["flat_group_norm"] = dict(
        rel_err=err, tol=1e-5, max_abs_err=abs_err, shape=[list(m[0].shape) for m in maps],
        launches_per_attention_call=launches,
        ms=timed_ms(lambda: norms3(maps)),
        device_ms=kernel_times(lambda: norms3(maps), norm_kernels).get("norm"),
        ms_per_map=timed_ms(lambda: per_map(maps)) / 3,
        device_ms_by_map={name: kernel_times(lambda m=m: per_map([m]), norm_kernels).get("norm")
                          for name, m in zip("qkv", maps)},
        plain_ms=timed_ms(lambda: plain(maps)),
        bound=bound(10 * elems, 2 * 4 * elems), library_ms=None,
        calls="per call: the q, k and v maps of one attention call (one block); ms by events "
              "around the wrapper, device_ms from the profiler")

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

    # -- rows 1-3 at the folder's batch shape ------------------------------------------
    kernel_b16_phase(rand, dev, w, c, hidden, n_head, e_dim)

    # -- the training kernels at the shapes of one step -----------------------------
    train_kernel_phase(rand, dev, summary)

    # -- the LSTM kernels at the shapes of 6l48c200 ----------------------------------
    lstm_kernel_phase(rand, dev, summary, n_frames)

    # -- rows 1, 2, 3 and 7 in their bf16 forms (their own draws) -------------------
    kernel_bf16_phase(dev, summary)
    if kernels_only:
        emit({"phase": "done", "kernels_only": True,
              "wall_seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        return

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
    # Per block one launch of each RNN path's kernel, of the norms and of the attention.
    expected = {"grid_rnn_seq1_pair": 2 * RNN_BLOCKS, "flat_group_norm": RNN_BLOCKS,
                "frame_attention": RNN_BLOCKS}
    if not err < 1e-4 or any(per_forward[k] != n for k, n in expected.items()):
        fail(f"backbone: rel {err}, launches {per_forward}, expected {expected}")
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
        serve_batch_check(fdbm, plain, dev)

        totals = dict.fromkeys(ops.launch_counts(), 0)
        counts, noisy = serve_phase(tmp, ckpt, smi)
        for k, v in counts.items():
            totals[k] += v

        # -- folders: the folder CLI at B=16, pooled and whole, and pooled in bf16;
        # the pc and ode_int samplers
        seconds = folder_seconds()
        for name, secs, chunk in (("serve_folder", seconds, "4.096"),
                                  ("serve_folder_whole", seconds[:2] + seconds[-1:], "0")):
            counts = serve_folder(tmp, ckpt, name, secs, chunk, smi,
                                  profile_fdbm=fdbm if chunk != "0" else None,
                                  trace=chunk != "0")
            for k, v in counts.items():
                totals[k] += v
        for k, v in serve_folder_bf16(tmp, ckpt, smi).items():
            totals[k] += v
        workers = start_ddp_workers(tmp)  # they run beside the phases up to theirs
        quality = start_quality_workers(tmp)
        for k, v in samplers_phase(fdbm, plain, dev).items():
            totals[k] += v
        for k, v in mesh_serve_phase(tmp, ckpt, fdbm, dev, smi).items():
            totals[k] += v
        del fdbm, plain

        # -- training: one step against the plain route, the CLI, the rate ---------
        train_grad_phase(rng, dev, tfgridnet_5l32c100,
                         {"grid_fold_train_pair": RNN_PATHS, "grid_fold_train_pair_bwd": RNN_PATHS})
        counts, run = train_cli_phase(tmp, smi)
        for k, v in counts.items():
            totals[k] += v
        # -- data parallel: the CLI under torchrun (NCCL), two ranks on one card
        for phase in (lambda: ddp_nccl_phase(workers, smi),
                      lambda: ddp_two_ranks_phase(workers, dev)):
            for k, v in phase().items():
                totals[k] += v
        for k, v in predictive_phase(tmp, smi).items():
            totals[k] += v
        train_rate_phase(rng, dev, smi, tfgridnet_5l32c100)

        # -- fine-tuning: one step against the plain route, the CLI from the train
        # phase's run with its evaluation, evaluate, the rate; the losses on the card.
        # Their draws come from a generator of their own: the 6l48c200 phases below
        # keep the batch and noise their float64 limits were set on.
        ft_rng = np.random.default_rng(SEED + 71)
        t_ft, ft_seconds = time.perf_counter(), {}
        for k, v in finetune_grad_phase(ft_rng, dev).items():
            totals[k] += v
        ft_seconds["finetune_grad"] = time.perf_counter() - t_ft
        counts, enhanced = finetune_cli_phase(tmp, smi, run)
        for k, v in counts.items():
            totals[k] += v
        ft_seconds["finetune"] = time.perf_counter() - t_ft - sum(ft_seconds.values())
        evaluate_phase(tmp, enhanced)
        ft_seconds["evaluate"] = time.perf_counter() - t_ft - sum(ft_seconds.values())
        train_rate_phase(ft_rng, dev, smi, tfgridnet_5l32c100, "finetune_rate", finetune_cfg())
        ft_seconds["finetune_rate"] = time.perf_counter() - t_ft - sum(ft_seconds.values())
        losses_card_phase(ft_rng, dev)
        ft_seconds["losses_card"] = time.perf_counter() - t_ft - sum(ft_seconds.values())
        emit({"phase": "finetune_seconds", "seconds_by_phase": ft_seconds,
              "wall_seconds": time.perf_counter() - t_ft})

        # -- 6l48c200: the generic RNN path through the LSTM kernels -------------
        wide_backbone_phase(rand, dev)
        for k, v in wide_serve_phase(rng, dev, noisy).items():
            totals[k] += v
        totals.update(wide_train_phase(rng, dev, smi))

        # -- NCSN++: ncsnpp_v2 through both CLIs, the trainer, and its 5M twin ----
        ncsnpp_phases(tmp, rng, dev, smi)

        # -- bf16 training: the steps against float64, fine-tuning, the rates -------
        ops.reset_launch_counts()
        for k, v in bf16_train_phases(rng, dev, smi).items():
            totals[k] += v

        # -- bf16 serving: the backbones, 2-step serves, quality on trained weights
        bf16_phases(dev, smi, quality)
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


def probe_fp32(out_path: str, repeats: int = 10) -> None:
    """What the fp32 route computes, for a comparison of two checkouts (run
    a copy of this script from each checkout's root): the ten kernels'
    fp32 outputs (and gradients) on fixed seeded inputs, to be compared bit
    for bit; whether four calls of 5l32c100's forward, of its ``deconv_out``
    (a transposed convolution) and of its ``conv_in`` on one input repeat
    their bits; and ode_int's first ODE_INT_STEPS steps, kernel route
    against plain route, each on its own step control (``ode_int_gate``'s
    ``rel_err_own_steps``) ``repeats`` times with cuDNN's default
    algorithms, each beside the kernel route and the plain route against
    their own previous run, then once with its deterministic ones; and
    which plain version carries the plain route's distance to float64 there
    (``ode_int_dissection``). Written to ``out_path`` (torch.save); fails on
    nothing."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig
    from fdbm_tpu_torch.models.tfgridnet import tfgridnet_5l32c100
    from fdbm_tpu_torch.ops import attention, gridrnn, gridrnn_train, lstm

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": nvidia_smi()})
    rng = np.random.default_rng(SEED)
    r = lambda *shape, sc=1.0: torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * sc,
                                               device=dev)
    c, h = 32, 100
    x = r(2, 70, 9, c, sc=0.5)
    w = (r(2, 4 * c, 4 * h, sc=.1), r(2, h, 4 * h, sc=.1), r(2, 4 * h, sc=.1),
         r(2 * h, 4 * c, sc=.1))
    bits = {}
    with torch.no_grad():
        bits["k1"] = gridrnn.grid_rnn_seq1_pair(x, *w)
        lines = r(70, 40, c, sc=.5)
        bits["k4"] = gridrnn.grid_bilstm_fold(lines, *w)
    lr, ws = lines.clone().requires_grad_(True), [t.clone().requires_grad_(True) for t in w]
    outf, outb = gridrnn_train.grid_fold_train_pair(lr, *ws)
    cot = r(*outf.shape)
    bits["k5"] = (outf.detach(), outb.detach())
    bits["k6"] = torch.autograd.grad((outf * cot).sum() + (outb * cot).sum(), [lr, *ws])
    q, k, v = r(1, 64, 33, 8), r(1, 64, 33, 8), r(1, 64, 33, 32)
    norms = tuple((r(4, 1, sc=.3), r(4, wd), r(4, wd)) for wd in (2, 2, 8))
    with torch.no_grad():
        bits["k2"] = attention.flat_group_norm(q, *norms[0], width=2)
        bits["k3"] = attention.frame_attention(q, k, v, 4, 2, norms=norms)
        xs = r(40, 30, 192)
        w2 = (r(2, 192, 800, sc=.07), r(2, 200, 800, sc=.07), r(2, 800, sc=.07))
        bits["k7"] = lstm.bilstm_fused_forward(xs, *w2)
        bits["k10"] = lstm.lstm_forward(xs, *(t[0] for t in w2))
    xg, w1 = xs.clone().requires_grad_(True), [t[0].clone().requires_grad_(True) for t in w2]
    hc = lstm.lstm_core(xg, *w1)
    cot2 = r(*hc.shape)
    bits["k8"] = hc.detach()
    bits["k9"] = torch.autograd.grad((hc * cot2).sum(), [xg, *w1])
    cpu = lambda a: [cpu(t) for t in a] if isinstance(a, (list, tuple)) else a.detach().cpu()

    torch.manual_seed(SEED)
    fdbm = FDBM(FDBMConfig(), device="cuda")
    plain = FDBM(FDBMConfig(), device="cuda")
    plain.dnn = tfgridnet_5l32c100(use_kernels=False).to(dev).eval()
    plain.dnn.load_state_dict(fdbm.dnn.state_dict())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    same = lambda fn, a: [torch.equal(fn(a), fn(a)) for _ in range(3)]
    with torch.no_grad():
        xc = torch.randn(1, 1, 257, 129, dtype=torch.complex64, device=dev, generator=gen)
        t = torch.tensor([0.5], device=dev)
        repeats_equal = {
            "forward": same(lambda a: fdbm.dnn(a, a, t), xc),
            "deconv_out": same(fdbm.dnn.deconv_out, torch.randn(1, 32, 129, 257, device=dev,
                                                                 generator=gen)),
            "conv_in": same(fdbm.dnn.conv_in, torch.randn(1, 4, 129, 257, device=dev,
                                                          generator=gen))}
    draws = samplers_draws(fdbm, dev)
    ode = dict(sampler_type="ode_int", rtol=1e-2, atol=1e-2, z=draws["z"],
               max_steps=ODE_INT_STEPS)
    readings, last = [], None
    for det in [False] * repeats + [True]:
        torch.backends.cudnn.deterministic = det
        got = fdbm.enhance_spec(draws["y"], **ode)
        want = plain.enhance_spec(draws["y"], **ode)
        readings.append({"cudnn_deterministic": det, "rel_err": rel_err(got, want),
                         "kernel_vs_previous": last and rel_err(got, last[0]),
                         "plain_vs_previous": last and rel_err(want, last[1])})
        last = (got, want)
    torch.backends.cudnn.deterministic = False
    dissection = ode_int_dissection(fdbm, plain, draws)
    emit({"phase": "probe_fp32", "repeats_equal": repeats_equal, "ode_int_first_steps": readings,
          "tol": 1e-3, "ode_int_dissection": dissection, "out": out_path})
    torch.save({"bits": {name: cpu(a) for name, a in bits.items()},
                "repeats_equal": repeats_equal, "ode_int_first_steps": readings,
                "ode_int_dissection": dissection}, out_path)


def in_float64(fn):
    """``fn`` computed in float64 on its inputs widened, its outputs
    rounded back to fp32."""
    def cast(a, dtype):
        if torch.is_tensor(a):
            return a.to(dtype) if a.is_floating_point() else a
        if isinstance(a, (list, tuple)):
            return type(a)(cast(x, dtype) for x in a)
        return a

    return lambda *args, **kwargs: cast(fn(*cast(args, torch.float64),
                                           **cast(kwargs, torch.float64)), torch.float32)


def ode_int_dissection(fdbm, plain, draws) -> dict:
    """ode_int's first ODE_INT_STEPS steps as ``ode_int_gate`` runs them (cuDNN
    deterministic, the plain route's error norms replayed), each route's
    distance to the float64 network: the kernel route, the plain route, the
    plain route with the plain version of kernel 1 or of kernel 3 (with
    kernel 2's norms) computed in float64, and the kernel route with one of
    those plain versions in fp32 in place of its kernel. Says which plain
    version carries the plain route's distance on the card."""
    from fdbm_tpu_torch.ops.attention import frame_attention_plain
    from fdbm_tpu_torch.ops.gridrnn import grid_rnn_seq1_pair_plain

    first = dict(sampler_type="ode_int", rtol=1e-2, atol=1e-2, z=draws["z"],
                 max_steps=ODE_INT_STEPS)
    norms = []
    replay = lambda: error_norms(replay=norms)
    k1, k3 = "grid_rnn_seq1_pair_plain", "frame_attention_plain"
    routes = [("plain", plain, [lambda: error_norms(record=norms)]),
              ("float64", float64_twin(plain), [replay]),
              ("kernel", fdbm, [replay]),
              ("plain_k1_float64", plain,
               [replay, lambda: backbone_swapped(k1, in_float64(grid_rnn_seq1_pair_plain))]),
              ("plain_k3_float64", plain,
               [replay, lambda: backbone_swapped(k3, in_float64(frame_attention_plain))]),
              ("kernel_k1_plain", fdbm,
               [replay, lambda: backbone_swapped("grid_rnn_seq1_pair", grid_rnn_seq1_pair_plain)]),
              ("kernel_k3_plain", fdbm,
               [replay, lambda: backbone_swapped("frame_attention", frame_attention_plain)])]
    outs, seconds = {}, {}
    with cudnn_deterministic(), torch.no_grad():
        for name, model, contexts in routes:
            with contextlib.ExitStack() as stack:
                for context in contexts:
                    stack.enter_context(context())
                t0 = time.perf_counter()
                outs[name] = model.enhance_spec(draws["y"], **first)
                torch.cuda.synchronize()
                seconds[name] = time.perf_counter() - t0
    return {"float64_rel_err": {name: rel_err(out, outs["float64"]) for name, out in outs.items()
                                if name != "float64"},
            "error_norms": norms, "seconds": seconds,
            "fp32_matmul_precision": torch.get_float32_matmul_precision(),
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}


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
    # Kernel 7's bf16 form: the tensor-core recurrence's parts (the
    # projection is unchanged; its time is read apart), and its cell with the
    # accurate activations in place of the fast ones.
    "bilstm_fused_forward_bf16": {
        "no_product": (_LSTM_CU_FILE, "    for (int kk = 0; kk < p.kh / 16; ++kk) {",
                       "    for (int kk = 0; kk < 0; ++kk) {"),
        "no_cluster_barrier": (
            _LSTM_CU_FILE, "    if (s > 0) cluster_wait();  // every block's h of the last step "
            "is in hcur\n", "",
            (("    cluster_arrive();\n    if (s + 1 < S) load_xp(s + 1);",
              "    if (s + 1 < S) load_xp(s + 1);"),
             ("  cluster_wait();  // no block leaves while another may still write its h",
              "  cluster.sync();"))),
        "no_remote_h": (_LSTM_CU_FILE, "          for (int r = 0; r < p.cs; ++r) "
                        "cluster.map_shared_rank(hnext, r)[at] = hv;", "          hnext[at] = hv;"),
        "no_cell": (_LSTM_CU_FILE, "          const bf16 hv = __float2bfloat16(og * fast_tanh(c));",
                    "          const bf16 hv = __float2bfloat16(acc[m][i][0][2 * hr]);",
                    (("          c = fg * c + ig * gg;\n", ""),)),
        "accurate_cell": (
            _LSTM_CU_FILE,
            "          const float ig = fast_sigmoid(acc[m][i][0][2 * hr] + xv[m][i][hr][0]);",
            "          const float ig = sigmoidf_(acc[m][i][0][2 * hr] + xv[m][i][hr][0]);",
            (("          const float fg = fast_sigmoid(acc[m][i][0][2 * hr + 1] + xv[m][i][hr][1]);",
              "          const float fg = sigmoidf_(acc[m][i][0][2 * hr + 1] + xv[m][i][hr][1]);"),
             ("          const float gg = fast_tanh(acc[m][i][1][2 * hr] + xv[m][i][hr][2]);",
              "          const float gg = tanhf(acc[m][i][1][2 * hr] + xv[m][i][hr][2]);"),
             ("          const float og = fast_sigmoid(acc[m][i][1][2 * hr + 1] + xv[m][i][hr][3]);",
              "          const float og = sigmoidf_(acc[m][i][1][2 * hr + 1] + xv[m][i][hr][3]);"),
             ("          const bf16 hv = __float2bfloat16(og * fast_tanh(c));",
              "          const bf16 hv = __float2bfloat16(og * tanhf(c));"))),
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


# --probe-bf16: kernel 1's bf16 step in phases, from the stamps that
# gridrnn.cu's gridrnn_mma_kernel writes when it is built with -DGM_STAMPS:
# clock64 of the first and the last warp of block 0 at steps 10-41, and the
# globaltimer of every block (entry, end of the prologue, end of the steps).
STEP_PHASES = ("h_product", "cell", "arrive", "ring_wait", "window")


def probe_steps(work: str, dev, rand) -> dict:
    """Kernel 1's bf16 recurrence at the main path's widths (C = 32, H =
    100): clock cycles a step and by phase (h product, cell, arrive, the
    ring's copy wait, the next window) for the first and the last warp of
    block 0, and the blocks' median prologue and step loop in us, at B=1
    (plans cs 1 and 2, 16 lines) and B=16 (cs 1, 32 lines)."""
    import ctypes

    from fdbm_tpu_torch.ops import _build

    so = os.path.join(work, "gridrnn_stamps.so")
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DGM_STAMPS", "-I",
                            str(_build.CSRC), "-o", so, str(_build.CSRC / "gridrnn.cu")],
                           capture_output=True, text=True)
    if built.returncode:
        fail(f"probe_steps: gridrnn.cu with -DGM_STAMPS does not build: "
             f"{(built.stdout + built.stderr)[-2000:]}")
    lib = ctypes.CDLL(so)
    fn = lib.gridrnn_seq1_pair_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    c, hidden = 32, 100
    w = (rand(2, 4 * c, 4 * hidden, s=0.1), rand(2, hidden, 4 * hidden, s=0.1),
         rand(2, 4 * hidden, s=0.1), rand(2 * hidden, 4 * c, s=0.1))
    rows = {}
    for b, cs, lines in ((1, 1, 16), (1, 2, 16), (16, 1, 32)):
        x = rand(b, 263, 263, c, s=0.5).to(torch.bfloat16)
        hs = torch.empty((2, b * 263, 260, hidden), device=dev, dtype=torch.bfloat16)
        outs = (torch.empty_like(x), torch.empty_like(x))
        for _ in range(2):
            if fn(x.data_ptr(), *(t.data_ptr() for t in w), hs.data_ptr(), outs[0].data_ptr(),
                  outs[1].data_ptr(), b, 263, 263, c, hidden, cs, lines,
                  torch.cuda.current_stream().cuda_stream):
                fail("probe_steps: the stamped kernel does not launch")
        torch.cuda.synchronize()
        steps, blocks = (ctypes.c_longlong * (2 * 32 * 6))(), (ctypes.c_ulonglong * (4096 * 3))()
        if lib.gm_read_stamps(steps, blocks):
            fail("probe_steps: reading the stamps failed")
        st = np.array(steps[:], dtype=np.float64).reshape(2, 32, 6)
        n_blocks = cs * -(-b * 263 // lines) * 2
        bl = np.array(blocks[:3 * n_blocks], dtype=np.float64).reshape(n_blocks, 3)
        rows[f"B{b}_cs{cs}_lines{lines}"] = {
            "cycles_per_step": float(np.diff(st[0, :, 0]).mean()),
            **{warp: dict(zip(STEP_PHASES, (float(v) for v in np.diff(st[i], axis=1).mean(0))))
               for i, warp in enumerate(("first_warp", "last_warp"))},
            "prologue_us": float(np.median(bl[:, 1] - bl[:, 0]) / 1e3),
            "steps_us": float(np.median(bl[:, 2] - bl[:, 1]) / 1e3)}
    return rows


def probe_bf16(out_path: str) -> None:
    """Kernel 1's bf16 step in phases (probe_steps), written to
    ``out_path``."""
    from fdbm_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi})
    _build.build_all()
    work = tempfile.mkdtemp(prefix="probe_bf16_", dir=_build.BUILD_DIR)
    rng = np.random.default_rng(SEED)
    rand = lambda *shape, s=1.0: torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32) * s, device=dev)
    readings = {"nvidia_smi": smi, "steps": probe_steps(work, dev, rand)}
    emit({"phase": "probe_steps", **readings["steps"]})
    with open(out_path, "w") as f:
        json.dump(readings, f, indent=1)
    print(smi, flush=True)


def probe_kernels(out_path: str, only=()) -> None:
    """Where the time of the redesigned kernels goes: each variant of
    KERNEL_VARIANTS is built from a copy of its source and timed at the main
    path's shape and plan beside the unchanged source, on the same inputs
    (frame_attention: B=1, T=257, D=8 and 12, and the unchanged kernel at
    the plans of PROBE_ATTENTION_PLANS; bilstm_fused_forward: 262 lines, two
    directions, H=200; grid_rnn_seq1_pair: the canvas [1, 263, 263, 32],
    H=100; grid_fold_train_pair and its backward: [263, 524, 32], H=100;
    lstm_core_bwd: [260, 524, 192], H=200; bilstm_fused_forward_bf16: x
    [260, 263, 192] in bf16, H=200, the recurrence's time a step beside the
    projection's time). ``only`` names the kernels to read (all by default).
    Writes the times to ``out_path``."""
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
        if only and kernel not in only:
            continue
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
        elif kernel == "bilstm_fused_forward_bf16":
            s_len, lines, d_in, hidden = 260, 263, 192, 200
            x = rand(s_len, lines, d_in).to(torch.bfloat16)
            sc = hidden ** -0.5
            w = (rand(2, d_in, 4 * hidden, s=sc), rand(2, hidden, 4 * hidden, s=sc),
                 rand(2, 4 * hidden, s=sc))
            xp = torch.empty(2, s_len, lines, 4 * hidden, device=dev)
            out = torch.empty(2, s_len, lines, hidden, device=dev, dtype=torch.bfloat16)
            plan = lstm_ops.recurrence_mma_plan(lines, 2, hidden)
            row = {"plan": plan._asdict()}
            for name, lib in libs.items():
                fn, proj = lib.lstm_forward_bf16, lib.lstm_projection_bf16
                fn.argtypes, fn.restype = lstm_ops._SIGNATURES["lstm_forward_bf16"], ctypes.c_int
                proj.argtypes = lstm_ops._SIGNATURES["lstm_projection_bf16"]
                proj.restype = ctypes.c_int
                call = lambda: fn(x.data_ptr(), *(t.data_ptr() for t in w), xp.data_ptr(),
                                  out.data_ptr(), s_len, lines, d_in, hidden, 2, 0, plan.cs,
                                  plan.lines, stream)
                project = lambda: proj(x.data_ptr(), w[0].data_ptr(), w[2].data_ptr(),
                                       xp.data_ptr(), s_len * lines, d_in, 4 * hidden, 2, stream)
                if call() or project():
                    fail(f"probe variant {kernel}/{name} does not launch")
                ms, proj_ms = timed_ms(call, 10), timed_ms(project, 10)
                row[name] = {"ms": ms, "projection_ms": proj_ms,
                             "recurrence_us_per_step": (ms - proj_ms) / s_len * 1e3}
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
    parser.add_argument("--probe-kernels", nargs="+", metavar=("OUT", "KERNEL"),
                        help="only time the redesigned kernels (or the KERNELs named, keys of "
                             "KERNEL_VARIANTS) with parts of their work switched off (see "
                             "probe_kernels), written to OUT (JSON)")
    parser.add_argument("--probe-bf16", metavar="OUT",
                        help="only read kernel 1's bf16 step by phase (see probe_bf16), "
                             "written to OUT (JSON)")
    parser.add_argument("--probe-bf16-gate", nargs="+", metavar=("OUT", "DRAWS"),
                        help="only read the 6l48c200 bf16 serve over DRAWS draws (default 8) "
                             "through the kernel route, the plain-in-place routes and the "
                             "fault controls (see probe_bf16_gate), written to OUT (JSON)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="only build and check and time the kernel rows, with no paths "
                             "run and no ok line (for a before/after on one card, also "
                             "from a parent commit's checkout)")
    parser.add_argument("--ncsnpp-only", action="store_true",
                        help="only run the NCSN++ phases (no kernel is built, no ok line)")
    parser.add_argument("--bf16-only", action="store_true",
                        help="only run the bf16 kernel rows and the bf16 serving phases "
                             "(no ok line)")
    parser.add_argument("--bf16-train-only", action="store_true",
                        help="only run the bf16 training phases beside the fp32 rates, the "
                             "quality on trained weights, the training CLI's run logging and "
                             "the folder's serving trace (no ok line)")
    parser.add_argument("--probe-fp32", metavar="OUT",
                        help="only write what the fp32 route computes to OUT, for a comparison "
                             "of two checkouts (see probe_fp32)")
    parser.add_argument("--parallel-only", type=int, nargs="?", const=1, default=0,
                        metavar="R", help="only run the samplers phase R times (default 1), "
                        "each reading printed, and the data-parallel phases (no ok line)")
    parser.add_argument("--ddp-nccl-worker", nargs=2, metavar=("OUT", "TMP"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--probe-quality", nargs="+", metavar=("OUT", "STEPS"),
                        help="only train bf16_quality's model in fp32 and in bf16 for STEPS "
                             "steps at each LR or LR,BATCH that follows (see probe_quality), "
                             "written to OUT (JSON)")
    parser.add_argument("--quality-worker", nargs=2, metavar=("DTYPE", "OUT"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--quality-probe-worker", nargs=4,
                        metavar=("DTYPE", "LR[,BATCH]", "STEPS", "OUT"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--ddp-two-ranks-worker", nargs=3, metavar=("RANK", "STORE", "OUT"),
                        help=argparse.SUPPRESS)
    cli = parser.parse_args()
    if cli.ddp_nccl_worker:
        ddp_nccl_worker(*cli.ddp_nccl_worker)
    elif cli.quality_worker:
        quality_worker(*cli.quality_worker)
    elif cli.quality_probe_worker:
        quality_probe_worker(*cli.quality_probe_worker)
    elif cli.probe_quality:
        out, steps, *specs = cli.probe_quality
        probe_quality(out, int(steps), specs or [str(QUALITY_LR)])
    elif cli.ddp_two_ranks_worker:
        rank, store, out = cli.ddp_two_ranks_worker
        ddp_two_ranks_worker(int(rank), store, out)
    elif cli.parallel_only:
        main(parallel_only=cli.parallel_only)
    elif cli.kernels_only:
        main(kernels_only=True)
    elif cli.ncsnpp_only:
        main(ncsnpp_only=True)
    elif cli.bf16_only:
        main(bf16_only=True)
    elif cli.bf16_train_only:
        main(bf16_train_only=True)
    elif cli.probe_fp32:
        probe_fp32(cli.probe_fp32)
    elif cli.probe_kernels:
        probe_kernels(cli.probe_kernels[0], tuple(cli.probe_kernels[1:]))
    elif cli.probe_bf16:
        probe_bf16(cli.probe_bf16)
    elif cli.probe_bf16_gate:
        out, *draws = cli.probe_bf16_gate
        probe_bf16_gate(out, int(draws[0]) if draws else 8)
    elif cli.probe_seeds:
        if not cli.probe_out:
            parser.error("--probe-seeds needs --probe-out")
        probe(cli.probe_first, cli.probe_seeds, cli.probe_out)
    else:
        main()
