"""TF-GridNet RNN path: unfold + BiLSTM + deconv + fold, forward only.

Port of ``fdbm_tpu/ops/gridrnn.py``: :func:`grid_rnn_seq1_pair` on the
canvas (serving) and :func:`grid_bilstm_fold` on sequence-major lines (the
training route's forward when no gradient is needed). On a CUDA tensor each
launches hand-written kernels (``csrc/gridrnn.cu`` and
``csrc/gridrnn_train.cu``: input projection, recurrence, deconv +
overlap-add); on a CPU tensor it runs its ``*_plain`` version, the same
function in plain PyTorch. The source notes of the ``.cu`` files say what
bounds the kernels on the H100 and how they are laid out. The
differentiable twin is ``ops/gridrnn_train.py``.

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
_FOLD_SIGNATURES = {"grid_bilstm_fold": [_P] * 8 + [_I] * 4 + [_P]}


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


def grid_bilstm_fold_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                           bias: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_bilstm_fold`: a sequence-major
    ``[S, lines, C]`` array is the canvas with B = 1 and P = lines."""
    outf, outb = grid_rnn_seq1_pair_plain(x[None], w_ih, w_hh, bias, wd)
    return (outf + outb)[0]


def check_tensor(fn: str, name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``: what the kernels of this module take."""
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous float32 tensor on {device} "
                         f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_rnn_args(fn: str, x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   bias: torch.Tensor, wd: torch.Tensor) -> Tuple[int, int]:
    """Validate the RNN path's arguments on a CUDA device; ``x`` is
    ``[..., S, P, C]``. Returns ``(C, H)``."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() < 3 or w_hh.dim() != 3:
        raise ValueError(f"{fn}: x must be [..., S, P, C] and w_hh [2, H, 4H]")
    s, c, hidden = x.shape[-3], x.shape[-1], w_hh.shape[1]
    if s - (KS - 1) < 1 or c % 8 or c > 64 or hidden > 128:
        raise ValueError(f"{fn}: shape S={s}, C={c}, H={hidden} is outside the kernel's "
                         "range (S >= 4, C % 8 == 0, C <= 64, H <= 128)")
    dev = x.device
    check_tensor(fn, "x", x, x.shape, dev)
    check_tensor(fn, "w_ih", w_ih, (2, KS * c, 4 * hidden), dev)
    check_tensor(fn, "w_hh", w_hh, (2, hidden, 4 * hidden), dev)
    check_tensor(fn, "bias", bias, (2, 4 * hidden), dev)
    check_tensor(fn, "wd", wd, (2 * hidden, KS * c), dev)
    return c, hidden


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
      gate the model applies before it calls here. They have no backward:
      on a CUDA tensor this raises if an input requires grad.
    """
    if x.device.type == "cpu":
        return grid_rnn_seq1_pair_plain(x, w_ih, w_hh, bias, wd)
    if x.dim() != 4:
        raise ValueError("grid_rnn_seq1_pair: x must be [B, S, P, C]")
    c, hidden = check_rnn_args("grid_rnn_seq1_pair", x, w_ih, w_hh, bias, wd)
    _build.refuse_grad("grid_rnn_seq1_pair", x, w_ih, w_hh, bias, wd)
    b, s, p, _ = x.shape
    length = s - (KS - 1)
    dev = x.device
    with torch.cuda.device(dev):
        xp = torch.empty((2, b * p, length, 4 * hidden), device=dev, dtype=torch.float32)
        hs = torch.empty((2, b * p, length, hidden), device=dev, dtype=torch.float32)
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


def grid_bilstm_fold(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                     bias: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Fused unfold(k=4) -> BiLSTM -> deconv(k=4) -> overlap-add on
    sequence-major lines, both directions summed.

    Args:
      x: ``[S, lines, C]`` (already LayerNorm'd and padded by the caller);
      w_ih, w_hh, bias, wd: as :func:`grid_rnn_seq1_pair`.

    Returns:
      ``[S, lines, C]`` without the deconv bias, exact on every row (the
      JAX kernel on rows [3, L-1]). Forward only: on a CUDA tensor this
      raises if an input requires grad; the differentiable twin is
      ``ops.gridrnn_train.grid_fold_train_pair``.
    """
    if x.device.type == "cpu":
        return grid_bilstm_fold_plain(x, w_ih, w_hh, bias, wd)
    if x.dim() != 3:
        raise ValueError("grid_bilstm_fold: x must be [S, lines, C]")
    c, hidden = check_rnn_args("grid_bilstm_fold", x, w_ih, w_hh, bias, wd)
    _build.refuse_grad("grid_bilstm_fold", x, w_ih, w_hh, bias, wd)
    s, lines, _ = x.shape
    length = s - (KS - 1)
    dev = x.device
    with torch.cuda.device(dev):
        xp = torch.empty((2, lines, length, 4 * hidden), device=dev, dtype=torch.float32)
        hs = torch.empty((2, lines, length, hidden), device=dev, dtype=torch.float32)
        out = torch.empty_like(x)
        lib = _build.load("gridrnn_train", _FOLD_SIGNATURES)
        code = lib.grid_bilstm_fold(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), wd.data_ptr(),
            xp.data_ptr(), hs.data_ptr(), out.data_ptr(), s, lines, c, hidden,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "grid_bilstm_fold")
    grid_bilstm_fold.launches += 1
    return out


grid_bilstm_fold.launches = 0
