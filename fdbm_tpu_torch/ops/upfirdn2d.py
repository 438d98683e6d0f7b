"""upfirdn2d: upsample -> FIR filter -> downsample, as one depthwise convolution.

Port of ``fdbm_tpu/ops/upfirdn2d.py`` for NCHW maps ``[B, C, H, W]``. The
semantics are the reference's ``upfirdn2d_native``:

    1. zero-stuff the input by ``up`` along H and W,
    2. pad by (pad0, pad1) on each spatial dim (negative pad = crop),
    3. correlate with the *flipped* kernel (a true convolution),
    4. subsample by ``down``.

The general case zero-stuffs, pads with ``F.pad`` (the pads are not
symmetric, so ``F.conv2d``'s own padding cannot take them) and runs a
depthwise ``F.conv2d`` (``groups=C``), which correlates, with the flipped
kernel at stride ``down``. Upsampling whose pads are those of a transposed
convolution (``upsample_2d``'s always are) is one depthwise
``F.conv_transpose2d`` at stride ``up`` with the kernel as it is: a
transposed convolution correlates the zero-stuffed input with its weight
flipped. Autograd gives the backward. These are cuDNN convolutions: the JAX
package computes them with XLA's ``conv_general_dilated``, outside any
Pallas kernel. ``upsample_2d`` and ``downsample_2d`` keep each depthwise
weight they build (per kernel, gain, channel count, dtype and device), so a
model's resampling adds no work beyond its convolution.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

FIR_KERNEL = (1, 3, 3, 1)


def setup_fir_kernel(k: Union[Sequence[float], np.ndarray], gain: float = 1.0) -> np.ndarray:
    """Normalise a 1-D (separable) or 2-D FIR kernel to unit sum, times
    ``gain`` (reference up_or_down_sampling.py:181-188)."""
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return (k * gain).astype(np.float32)


def _depthwise(kern: torch.Tensor, channels: int) -> torch.Tensor:
    return kern.expand(channels, 1, *kern.shape).contiguous()


@functools.lru_cache(maxsize=64)
def _cached_weight(taps: Tuple[float, ...], shape: Tuple[int, ...], gain: float, channels: int,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    kern = setup_fir_kernel(np.reshape(taps, shape), gain)
    return _depthwise(torch.as_tensor(kern, dtype=dtype, device=device), channels)


def _weight(k: Union[Sequence[float], np.ndarray], gain: float,
            like: torch.Tensor) -> torch.Tensor:
    """The depthwise weight ``[C, 1, kh, kw]`` of :func:`setup_fir_kernel`
    for ``like``'s channels, dtype and device; one tensor per key, shared by
    every call, so callers never write to it."""
    taps = np.asarray(k, np.float32)
    return _cached_weight(tuple(taps.ravel().tolist()), taps.shape, float(gain), like.shape[1],
                          like.dtype, like.device)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x: ``[B, C, H, W]``; kernel: ``[kh, kw]``. Returns ``[B, C, H', W']``
    with ``H' = (H*up + pad0 + pad1 - kh)//down + 1``."""
    return _upfirdn2d(x, _depthwise(kernel.to(x.dtype), x.shape[1]), up, down, pad)


def _upfirdn2d(x: torch.Tensor, weight: torch.Tensor, up: int, down: int,
               pad: Tuple[int, int]) -> torch.Tensor:
    """:func:`upfirdn2d` with the kernel as its depthwise weight ``[C, 1,
    kh, kw]``, unflipped."""
    c, _, kh, kw = weight.shape
    pad0, pad1 = pad
    # Zero-stuffing to (H-1)*up + 1 samples leaves up-1 trailing zeros out.
    hi = pad1 + up - 1
    if up > 1 and down == 1 and kh == kw and pad0 == hi and pad0 <= kh - 1:
        return F.conv_transpose2d(x, weight, stride=up, padding=kh - 1 - pad0, groups=c)
    if up > 1:
        b, _, h, w = x.shape
        stuffed = x.new_zeros(b, c, (h - 1) * up + 1, (w - 1) * up + 1)
        stuffed[:, :, ::up, ::up] = x
        x = stuffed
    x = F.pad(x, (pad0, hi, pad0, hi))
    return F.conv2d(x, weight.flip(-2, -1), stride=down, groups=c)


def upsample_2d(x: torch.Tensor, k: Sequence[float] = FIR_KERNEL, factor: int = 2,
                gain: float = 1.0) -> torch.Tensor:
    """FIR upsample by ``factor`` (reference up_or_down_sampling.py:195-224):
    kernel scaled by gain*factor^2, pad ((p+1)//2 + factor - 1, p//2)."""
    weight = _weight(k, gain * factor ** 2, x)
    p = weight.shape[-1] - factor
    return _upfirdn2d(x, weight, factor, 1, ((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k: Sequence[float] = FIR_KERNEL, factor: int = 2,
                  gain: float = 1.0) -> torch.Tensor:
    """FIR downsample by ``factor`` (reference up_or_down_sampling.py:227-257):
    pad ((p+1)//2, p//2)."""
    weight = _weight(k, gain, x)
    p = weight.shape[-1] - factor
    return _upfirdn2d(x, weight, 1, factor, ((p + 1) // 2, p // 2))
