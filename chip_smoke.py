#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fdbm_tpu_torch/ops/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the shapes of the
main path, holds the full-width ``tfgridnet_5l32c100`` backbone against its
all-plain route, and serves three files through
``fdbm_tpu_torch.infer_single`` (the main path), counting kernel launches.
Every phase prints one JSON line; any failure exits non-zero. The last
lines are the card's ``nvidia-smi`` name and power limit, the per-kernel
summary and ``{"ok": true, "device": {...}}``.

fp32 throughout with TF32 off. Tolerances (relative L2): 1e-4 for the RNN
path and the attention (long fp32 accumulation chains, summed in another
order than the plain version), 1e-5 for the norm (a few terms per group),
1e-4 for the backbone and a 2-step serve against the plain route.
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
REPLACES = {
    "grid_rnn_seq1_pair": ("fdbm_tpu_torch/ops/csrc/gridrnn.cu", "fdbm_tpu/ops/gridrnn.py:434"),
    "flat_group_norm": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:180"),
    "frame_attention": ("fdbm_tpu_torch/ops/csrc/attention.cu", "fdbm_tpu/ops/attention.py:324"),
}


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


def profile_request(fdbm, noisy: str) -> dict:
    """Device time by kernel for one N=30 sde_ei request (the last serve
    file), from torch.profiler, and the device's idle share of its wall."""
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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
    if not err < 1e-4 or min(per_forward.values()) == 0:
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
                  and bool(np.isfinite(enhanced).all()) and min(counts.values()) > 0)
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
