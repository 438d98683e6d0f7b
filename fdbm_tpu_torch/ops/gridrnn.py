"""TF-GridNet RNN path on the canvas: unfold + BiLSTM + deconv + fold.

Port of ``fdbm_tpu/ops/gridrnn.py:grid_rnn_seq1_pair``. On a CUDA tensor
:func:`grid_rnn_seq1_pair` launches the hand-written kernels of
``csrc/gridrnn.cu`` (input projection, recurrence, deconv + overlap-add);
on a CPU tensor it runs :func:`grid_rnn_seq1_pair_plain`, the same function
in plain PyTorch. The source note of ``csrc/gridrnn.cu`` says what bounds
the kernels on the H100 and how they are laid out.

The plain BiLSTM recurrence, :func:`bilstm_plain`, lives here because the
plain version needs it; ``models/layers.BiLSTM`` wraps it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fdbm_tpu_torch.ops import _build

KS = 4  # unfold width (emb_ks)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gridrnn_seq1_pair": [_P] * 9 + [_I] * 5 + [_P]}


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step from pre-activations ``[N, 4H]`` (gate order i, f, g, o)
    and the fp32 cell state; returns ``(h, c)``."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM over axis 1 of ``x [N, S, D]`` -> ``[N, S, 2H]``
    (forward ++ backward), with the JAX packing ``w_ih [2, D, 4H]``,
    ``w_hh [2, H, 4H]``, ``bias [2, 4H]`` (direction 1 runs reversed)."""
    n, s, _ = x.shape
    hidden = w_hh.shape[1]
    xp = torch.einsum("nsd,zdg->znsg", x, w_ih) + bias[:, None, None, :]
    outs = []
    for z, order in ((0, range(s)), (1, range(s - 1, -1, -1))):
        h = x.new_zeros(n, hidden)
        c = x.new_zeros(n, hidden, dtype=torch.float32)
        ys = [None] * s
        for t in order:
            h, c = _lstm_cell(xp[z, :, t] + h @ w_hh[z], c)
            ys[t] = h
        outs.append(torch.stack(ys, dim=1))
    return torch.cat(outs, dim=-1)


def _fold(z: torch.Tensor, c: int) -> torch.Tensor:
    """Overlap-add of the k=4 taps: ``z [N, L, 4C]`` (tap-major) ->
    ``[N, L+3, C]``, row r = sum_j z[r - j, tap j]."""
    n, length, _ = z.shape
    out = z.new_zeros(n, length + KS - 1, c)
    for j in range(KS):
        out[:, j:j + length] += z[..., j * c:(j + 1) * c]
    return out


def grid_rnn_seq1_pair_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                             bias: torch.Tensor, wd: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`grid_rnn_seq1_pair`: the unfused
    unfold -> BiLSTM -> deconv -> fold pipeline, exact on every row."""
    b, s, p, c = x.shape
    hidden = w_hh.shape[1]
    length = s - (KS - 1)
    lines = x.permute(0, 2, 1, 3).reshape(b * p, s, c)
    win = torch.cat([lines[:, j:j + length] for j in range(KS)], dim=-1)
    h = bilstm_plain(win, w_ih, w_hh, bias)
    outs = []
    for half, rows in ((h[..., :hidden], wd[:hidden]), (h[..., hidden:], wd[hidden:])):
        folded = _fold(half @ rows, c)
        outs.append(folded.reshape(b, p, s, c).permute(0, 2, 1, 3).contiguous())
    return outs[0], outs[1]


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"grid_rnn_seq1_pair: {name} must be a contiguous float32 "
                         f"tensor on {device} (got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"grid_rnn_seq1_pair: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def grid_rnn_seq1_pair(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                       bias: torch.Tensor, wd: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused unfold(k=4) -> BiLSTM -> deconv(k=4) -> overlap-add on a canvas
    with the sequence on axis 1, returning the unsummed per-direction folds.

    Args:
      x: ``[B, S, P, C]`` canvas (already LayerNorm'd); each (b, p) is a line.
      w_ih: ``[2, 4C, 4H]`` tap-major rows; w_hh: ``[2, H, 4H]``;
      bias: ``[2, 4H]`` (gates i, f, g, o; direction 0 forward);
      wd: ``[2H, 4C]`` deconv weight, tap-major columns.

    Returns:
      ``(outf, outb)``, each ``[B, S, P, C]`` without the deconv bias; the
      model reads rows [3, L-1] (L = S-3), the rows the JAX kernel makes
      exact. The CUDA kernels need C % 8 == 0, C <= 64 and H <= 128, the
      gate the model applies before it calls here.
    """
    if x.device.type == "cpu":
        return grid_rnn_seq1_pair_plain(x, w_ih, w_hh, bias, wd)
    if x.device.type != "cuda":
        raise ValueError(f"grid_rnn_seq1_pair: unsupported device {x.device}")
    if x.dim() != 4 or w_hh.dim() != 3:
        raise ValueError("grid_rnn_seq1_pair: x must be [B, S, P, C] and w_hh [2, H, 4H]")
    b, s, p, c = x.shape
    hidden = w_hh.shape[1]
    length = s - (KS - 1)
    if length < 1 or c % 8 or c > 64 or hidden > 128:
        raise ValueError(f"grid_rnn_seq1_pair: shape S={s}, C={c}, H={hidden} is "
                         "outside the kernel's range (S >= 4, C % 8 == 0, C <= 64, "
                         "H <= 128)")
    dev = x.device
    _check("x", x, (b, s, p, c), dev)
    _check("w_ih", w_ih, (2, KS * c, 4 * hidden), dev)
    _check("w_hh", w_hh, (2, hidden, 4 * hidden), dev)
    _check("bias", bias, (2, 4 * hidden), dev)
    _check("wd", wd, (2 * hidden, KS * c), dev)
    lines = b * p
    xp = torch.empty((2, lines, length, 4 * hidden), device=dev, dtype=torch.float32)
    hs = torch.empty((2, lines, length, hidden), device=dev, dtype=torch.float32)
    outf = torch.empty_like(x)
    outb = torch.empty_like(x)
    lib = _build.load("gridrnn", _SIGNATURES)
    code = lib.gridrnn_seq1_pair(
        x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), wd.data_ptr(),
        xp.data_ptr(), hs.data_ptr(), outf.data_ptr(), outb.data_ptr(),
        b, s, p, c, hidden, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "grid_rnn_seq1_pair")
    grid_rnn_seq1_pair.launches += 1
    return outf, outb


grid_rnn_seq1_pair.launches = 0
