"""Frame attention of TF-GridNet and the PReLU + group norm that feeds it.

Port of ``fdbm_tpu/ops/attention.py:flat_group_norm`` and
``:frame_attention``. On a CUDA tensor each wrapper launches its
hand-written kernels from ``csrc/attention.cu``; on a CPU tensor it runs
its plain PyTorch version (``*_plain`` below). The source note of
``csrc/attention.cu`` says what bounds them on the H100 and how they are
laid out. Unlike the TPU kernel, the CUDA attention takes any number of
frames T: there is no counterpart of the VMEM gate ``fast_path_ok``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from fdbm_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flat_group_norm": [_P] * 5 + [ctypes.c_longlong, _I, _I, _P],
    "frame_attention": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P],
}
_EPS = 1e-5

NormParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flat_group_norm_plain(x: torch.Tensor, alpha: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`flat_group_norm`."""
    n_head = gamma.shape[0]
    shape = x.shape
    xs = x.reshape(*shape[:-1], -1, n_head, width)
    xs = torch.where(xs >= 0, xs, alpha.reshape(n_head, 1) * xs)
    mu = xs.mean(dim=-1, keepdim=True)
    xc = xs - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + _EPS) * gamma + beta
    return out.reshape(shape)


def _check(fn: str, name: str, t: torch.Tensor, device, shape=None) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous float32 tensor on "
                         f"{device} (got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def flat_group_norm(x: torch.Tensor, alpha: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, width: int) -> torch.Tensor:
    """PReLU + per-group affine norm on a flat ``[B, T, L]`` feature map.

    L = Q*H*width: the lanes of each frame are Q runs of H groups of
    ``width`` lanes (head-minor). Statistics over each group's lanes, fp32,
    biased two-pass variance, eps 1e-5 inside the root; ``alpha`` ``[H, 1]``
    is the per-head PReLU slope and ``gamma``/``beta`` ``[H, width]`` the
    affine parameters, as ``_AllHeadPReLULayerNorm`` holds them. ``width``
    must be a power of two up to 64. The kernel has no backward: on a CUDA
    tensor this raises if an input requires grad.
    """
    if x.device.type == "cpu":
        return flat_group_norm_plain(x, alpha, gamma, beta, width)
    if x.device.type != "cuda":
        raise ValueError(f"flat_group_norm: unsupported device {x.device}")
    n_head = gamma.shape[0]
    if width not in (1, 2, 4, 8, 16, 32, 64) or x.shape[-1] % (n_head * width):
        raise ValueError(f"flat_group_norm: width {width} must be a power of two "
                         f"<= 64 and divide the lanes {x.shape[-1]} in groups of "
                         f"{n_head} heads")
    dev = x.device
    _build.refuse_grad("flat_group_norm", x, alpha, gamma, beta)
    _check("flat_group_norm", "x", x, dev)
    _check("flat_group_norm", "alpha", alpha, dev, (n_head, 1))
    _check("flat_group_norm", "gamma", gamma, dev, (n_head, width))
    _check("flat_group_norm", "beta", beta, dev, (n_head, width))
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        lib = _build.load("attention", _SIGNATURES)
        code = lib.flat_group_norm(
            x.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            x.numel(), n_head, width, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "flat_group_norm")
    flat_group_norm.launches += 1
    return out


flat_group_norm.launches = 0


def _normed(q, k, v, n_head, e_dim, norms, norm_fn):
    b, t_len, q_bins, _ = q.shape
    d_dim = v.shape[-1] // n_head
    flat = lambda a: a.reshape(b, t_len, -1)
    qn = norm_fn(flat(q), *norms[0], width=e_dim).reshape(q.shape)
    kn = norm_fn(flat(k), *norms[1], width=e_dim).reshape(k.shape)
    vn = norm_fn(flat(v), *norms[2], width=d_dim).reshape(v.shape)
    return qn, kn, vn


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_head: int, e_dim: int,
                          norms: Optional[Sequence[NormParams]] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`frame_attention`."""
    if norms is not None:
        q, k, v = _normed(q, k, v, n_head, e_dim, norms, flat_group_norm_plain)
    b, t_len, q_bins, _ = q.shape
    d_dim = v.shape[-1] // n_head
    q5 = q.reshape(b, t_len, q_bins, n_head, e_dim)
    k5 = k.reshape(b, t_len, q_bins, n_head, e_dim)
    v5 = v.reshape(b, t_len, q_bins, n_head, d_dim)
    scores = torch.einsum("btqhe,buqhe->bhtu", q5, k5) * (1.0 / math.sqrt(e_dim * q_bins))
    attn = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhtu,buqhd->btqhd", attn, v5)
    return out.reshape(b, t_len, q_bins, n_head * d_dim)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int, e_dim: int,
                    norms: Optional[Sequence[NormParams]] = None) -> torch.Tensor:
    """Multi-head full-band attention over frames on head-minor layouts.

    Args:
      q, k: ``[B, T, Q, H*E]``; v: ``[B, T, Q, H*D]``.
      n_head: H; e_dim: E. Scale 1/sqrt(E*Q).
      norms: optional ``((alpha, gamma, beta),) * 3`` for q, k, v. When
        given, q, k, v are the raw projector outputs and
        :func:`flat_group_norm` applies PReLU + per-head norm to each first.

    Returns:
      ``[B, T, Q, H*D]``: per head softmax(Q K^T * scale) V, channels
      merged h-slow, d-fast. The kernels have no backward: on a CUDA
      tensor this raises if an input requires grad.
    """
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, n_head, e_dim, norms)
    if q.device.type != "cuda":
        raise ValueError(f"frame_attention: unsupported device {q.device}")
    _build.refuse_grad("frame_attention", q, k, v, *(t for p in norms or () for t in p))
    if norms is not None:
        q, k, v = _normed(q, k, v, n_head, e_dim, norms, flat_group_norm)
    b, t_len, q_bins, he = q.shape
    hd = v.shape[-1]
    if he != n_head * e_dim or hd % n_head:
        raise ValueError(f"frame_attention: lanes {he}/{hd} do not split into "
                         f"{n_head} heads of E={e_dim}")
    dev = q.device
    _check("frame_attention", "q", q, dev)
    _check("frame_attention", "k", k, dev, q.shape)
    _check("frame_attention", "v", v, dev, (b, t_len, q_bins, hd))
    with torch.cuda.device(dev):
        scores = torch.empty((b, n_head, t_len, t_len), device=dev, dtype=torch.float32)
        out = torch.empty_like(v)
        lib = _build.load("attention", _SIGNATURES)
        code = lib.frame_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), scores.data_ptr(), out.data_ptr(),
            b, t_len, q_bins, n_head, e_dim, hd // n_head, 1.0 / math.sqrt(e_dim * q_bins),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "frame_attention")
    frame_attention.launches += 1
    return out


frame_attention.launches = 0
