"""Shared layers: time embedding, PReLU, fp32 LayerNorm, BiLSTM.

Port of ``fdbm_tpu/models/layers.py``. Parameters keep the JAX package's
names and packing (``W``, ``alpha``, ``w_ih [2, D, 4H]``,
``w_hh [2, H, 4H]``, ``bias [2, 4H]``), so converting Flax weights is a
relabelling (``utils/weights.py``).
"""

from __future__ import annotations

import math

import torch
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


class PReLU(nn.Module):
    """PReLU with one slope of shape ``param_shape`` broadcast over x."""

    def __init__(self, param_shape: tuple = (), init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full(param_shape, init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


def layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   dim=-1, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over ``dim`` with two-pass statistics in fp32 or wider
    (mean, then E[(x - mu)^2], biased), eps inside the root."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = x32.mean(dim=dim, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=dim, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


class BiLSTM(nn.Module):
    """Bidirectional single-layer LSTM over axis 0 of sequence-major
    ``[S, N, D]`` -> ``[S, N, 2H]`` (forward ++ backward), gates i, f, g, o,
    fp32 carry. The JAX package's module is batch-major; TF-GridNet's
    generic RNN path builds its windows sequence-major, the layout the LSTM
    kernels take, so the port's module takes them so.

    Routed by mode, as the JAX package's ``use_pallas`` / ``use_pallas_train``
    route it: eval mode runs ``ops.lstm.bilstm_fused_forward``, train mode
    ``ops.lstm.bilstm_train``; ``use_kernels=False`` runs the plain
    recurrence on any device. Inside the fused kernels' gate the TF-GridNet
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
        if self.use_kernels and self.training:
            return bilstm_train(x, *weights)
        both = bilstm_fused_forward if self.use_kernels else bilstm_fused_forward_plain
        return torch.cat(both(x.contiguous(), *weights), dim=-1)
