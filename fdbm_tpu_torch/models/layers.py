"""Shared layers: time embedding, PReLU, fp32 LayerNorm, BiLSTM, and the
Dense and convolution layers of the backbones.

Port of ``fdbm_tpu/models/layers.py``. Parameters keep the JAX package's
names and packing (``W``, ``alpha``, ``w_ih [2, D, 4H]``,
``w_hh [2, H, 4H]``, ``bias [2, 4H]``), so converting Flax weights is a
relabelling (``utils/weights.py``).

Parameters stay fp32 at every dtype, as Flax keeps them under
``dtype=bfloat16``. :class:`Dense`, :class:`Conv2d` and
:class:`ConvTranspose2d` compute in their input's dtype with their
parameters cast to it, Flax's ``nn.Dense(dtype=...)`` (and ``nn.Conv``,
``nn.ConvTranspose``); on fp32 inputs they are ``torch.nn``'s layers. The
cast is a differentiable op, so in bf16 training the gradients land on the
fp32 parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fdbm_tpu_torch.ops.lstm import (bilstm_fused_forward, bilstm_fused_forward_plain,
                                     bilstm_train)


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the (log-)time: ``[sin(2 pi W x),
    cos(2 pi W x)]`` with a fixed random ``W ~ N(0, scale^2)``."""

    def __init__(self, embedding_size: int = 256, scale: float = 16.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embedding_size) * scale, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x[:, None] * self.W[None, :] * (2.0 * math.pi)
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class PReLU(nn.Module):
    """PReLU with one slope of shape ``param_shape`` broadcast over x."""

    def __init__(self, param_shape: tuple = (), init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full(param_shape, init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   dim=-1, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over ``dim`` with statistics in fp32 or wider, biased, eps
    inside the root, the result in x's dtype. The statistics' algorithm
    follows the input's dtype as in the JAX package
    (``fdbm_tpu/models/layers.py:88-101``): two passes (mean, then
    E[(x - mu)^2]) for fp32 and wider, one pass for bf16 (the serving
    path's activations): the fp32 sums of x and x^2 together, the variance
    E[x^2] - mu^2 clamped at 0."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if x.dtype == torch.bfloat16:
        mu = x32.mean(dim=dim, keepdim=True)
        var = ((x32 * x32).mean(dim=dim, keepdim=True) - mu * mu).clamp(min=0.0)
        return ((x32 - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)
    mu = x32.mean(dim=dim, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=dim, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def recurrence_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` widened to fp32 (a float64 reference route stays float64): the
    training recurrences (kernels 4-6 and 8-9) run in fp32 at either
    compute dtype, their outputs cast back to the activations' dtype, as the
    JAX package's ``layers.py:155-157`` and ``tfgridnet.py:171-174`` do."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BiLSTM(nn.Module):
    """Bidirectional single-layer LSTM over axis 0 of sequence-major
    ``[S, N, D]`` -> ``[S, N, 2H]`` (forward ++ backward), gates i, f, g, o,
    fp32 carry. The JAX package's module is batch-major; TF-GridNet's
    generic RNN path builds its windows sequence-major, the layout the LSTM
    kernels take, so the port's module takes them so.

    Routed by mode, as the JAX package's ``use_pallas`` / ``use_pallas_train``
    route it: eval mode runs ``ops.lstm.bilstm_fused_forward`` (kernel 7; a
    bf16 x takes its bf16 form and gives bf16, ``layers.py:159-165``), train
    mode ``ops.lstm.bilstm_train`` on x cast to fp32 (or wider), its output
    cast back to x's dtype (``layers.py:155-157``: bf16 training keeps the
    training recurrence in fp32); ``use_kernels=False`` runs the plain
    recurrence (of the same form) on any device. Inside the fused kernels' gate the TF-GridNet
    blocks hand these parameters to ``ops.gridrnn`` instead."""

    def __init__(self, in_features: int, hidden: int, use_kernels: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)
        u = lambda *shape: nn.Parameter(torch.empty(*shape).uniform_(-bound, bound))
        self.use_kernels = use_kernels
        self.w_ih = u(2, in_features, 4 * hidden)
        self.w_hh = u(2, hidden, 4 * hidden)
        self.bias = u(2, 4 * hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = (self.w_ih, self.w_hh, self.bias)
        if self.training:
            wide = recurrence_input(x)
            if self.use_kernels:
                out = bilstm_train(wide, *weights)
            else:
                out = torch.cat(bilstm_fused_forward_plain(wide.contiguous(), *weights), dim=-1)
            return out.to(x.dtype)
        both = bilstm_fused_forward if self.use_kernels else bilstm_fused_forward_plain
        return torch.cat(both(x.contiguous(), *weights), dim=-1)
