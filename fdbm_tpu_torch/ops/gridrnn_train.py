"""Differentiable TF-GridNet RNN path on sequence-major lines (training).

Port of ``fdbm_tpu/ops/gridrnn_train.py:grid_fold_train_pair``: the fused
unfold(k=4) -> BiLSTM -> deconv -> overlap-add with its own backward. On a
CUDA tensor :func:`grid_fold_train_pair` is a ``torch.autograd.Function``
whose forward launches the stashing forward kernel and whose backward
launches :func:`grid_fold_train_pair_bwd`, both in ``csrc/gridrnn_train.cu``
(its source note says what bounds them and how they are laid out). On a CPU
tensor it runs :func:`grid_fold_train_pair_plain`, which autograd
differentiates.

Gradient semantics are those of the JAX VJP: the gradient of the ideal
unfold -> BiLSTM -> deconv -> fold. The CUDA forward is exact on every row,
so the kernels' gradient is that of the plain version for any cotangent; the
JAX kernels agree on the rows [3, L-1] the model keeps, and the model's crop
gives the other rows zero cotangent.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fdbm_tpu_torch.ops import _build
from fdbm_tpu_torch.ops.gridrnn import KS, check_rnn_args, check_tensor, grid_rnn_seq1_pair_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grid_fold_train_fwd": [_P] * 10 + [_I] * 4 + [_P],
    "grid_fold_train_bwd_workspace": [_I] * 4,
    "grid_fold_train_bwd": [_P] * 17 + [_I] * 4 + [_P],
}
_RESTYPES = {"grid_fold_train_bwd_workspace": ctypes.c_longlong}

# (gates [2, lines, L, 4H] activated i, f, g, o; hs, cs [2, lines, L, H])
Stash = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def grid_fold_train_pair_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                               bias: torch.Tensor, wd: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`grid_fold_train_pair`: the unfused
    pipeline on ``[S, lines, C]`` (the canvas with B = 1, P = lines)."""
    outf, outb = grid_rnn_seq1_pair_plain(x[None], w_ih, w_hh, bias, wd)
    return outf[0], outb[0]


def grid_fold_train_pair_bwd_plain(x, w_ih, w_hh, bias, wd, doutf, doutb) -> Grads:
    """Plain version of :func:`grid_fold_train_pair_bwd`: autograd through
    :func:`grid_fold_train_pair_plain`. Returns
    ``(dx, dw_ih, dw_hh, dbias, dwd)``."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in (x, w_ih, w_hh, bias, wd)]
        outf, outb = grid_fold_train_pair_plain(*args)
        return torch.autograd.grad((outf, outb), args, (doutf, doutb))


def _empty(dev, *shape) -> torch.Tensor:
    return torch.empty(shape, device=dev, dtype=torch.float32)


def grid_fold_train_pair_fwd(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                             bias: torch.Tensor, wd: torch.Tensor):
    """Kernel 5 on CUDA tensors: ``(outf, outb, stash)``, the per-direction
    folds and what :func:`grid_fold_train_pair_bwd` needs. The autograd
    function calls it; tests and ``chip_smoke.py`` call it to reach the
    backward kernel directly."""
    c, hidden = check_rnn_args("grid_fold_train_pair", x, w_ih, w_hh, bias, wd)
    s, lines, _ = x.shape
    length = s - (KS - 1)
    dev = x.device
    with torch.cuda.device(dev):
        gates = _empty(dev, 2, lines, length, 4 * hidden)
        hs = _empty(dev, 2, lines, length, hidden)
        cs = _empty(dev, 2, lines, length, hidden)
        outf, outb = torch.empty_like(x), torch.empty_like(x)
        lib = _build.load("gridrnn_train", _SIGNATURES, _RESTYPES)
        code = lib.grid_fold_train_fwd(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), wd.data_ptr(),
            gates.data_ptr(), hs.data_ptr(), cs.data_ptr(), outf.data_ptr(), outb.data_ptr(),
            s, lines, c, hidden, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "grid_fold_train_pair")
    grid_fold_train_pair.launches += 1
    return outf, outb, (gates, hs, cs)


def grid_fold_train_pair_bwd(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                             bias: torch.Tensor, wd: torch.Tensor, doutf: torch.Tensor,
                             doutb: torch.Tensor, stash: Optional[Stash] = None) -> Grads:
    """Backward of :func:`grid_fold_train_pair`: the gradients of x and the
    four weights under the output cotangents ``doutf``, ``doutb``
    ``[S, lines, C]``, as ``(dx, dw_ih, dw_hh, dbias, dwd)``.

    On a CUDA tensor it launches kernel 6 and needs the ``stash`` of the
    forward kernel; on a CPU tensor it runs
    :func:`grid_fold_train_pair_bwd_plain` (``stash`` unused)."""
    if x.device.type == "cpu":
        return grid_fold_train_pair_bwd_plain(x, w_ih, w_hh, bias, wd, doutf, doutb)
    fn = "grid_fold_train_pair_bwd"
    c, hidden = check_rnn_args(fn, x, w_ih, w_hh, bias, wd)
    if stash is None:
        raise ValueError(f"{fn}: the CUDA kernel needs the forward kernel's stash")
    s, lines, _ = x.shape
    length = s - (KS - 1)
    dev = x.device
    gates, hs, cs = stash
    check_tensor(fn, "doutf", doutf, x.shape, dev)
    check_tensor(fn, "doutb", doutb, x.shape, dev)
    check_tensor(fn, "gates", gates, (2, lines, length, 4 * hidden), dev)
    check_tensor(fn, "hs", hs, (2, lines, length, hidden), dev)
    check_tensor(fn, "cs", cs, (2, lines, length, hidden), dev)
    with torch.cuda.device(dev):
        lib = _build.load("gridrnn_train", _SIGNATURES, _RESTYPES)
        dhd = _empty(dev, 2, lines, length, hidden)
        dgates = _empty(dev, 2, lines, length, 4 * hidden)
        work = _empty(dev, lib.grid_fold_train_bwd_workspace(s, lines, c, hidden))
        dx = torch.empty_like(x)
        grads = (_empty(dev, 2, KS * c, 4 * hidden), _empty(dev, 2, hidden, 4 * hidden),
                 _empty(dev, 2, 4 * hidden), _empty(dev, 2 * hidden, KS * c))
        code = lib.grid_fold_train_bwd(
            x.data_ptr(), doutf.data_ptr(), doutb.data_ptr(), gates.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), wd.data_ptr(), dhd.data_ptr(),
            dgates.data_ptr(), work.data_ptr(), dx.data_ptr(),
            *(g.data_ptr() for g in grads), s, lines, c, hidden,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, fn)
    grid_fold_train_pair_bwd.launches += 1
    return (dx, *grads)


grid_fold_train_pair_bwd.launches = 0


class _GridFoldTrainPair(torch.autograd.Function):
    """Kernel 5 forward, kernel 6 backward."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, bias, wd):
        outf, outb, stash = grid_fold_train_pair_fwd(x, w_ih, w_hh, bias, wd)
        ctx.save_for_backward(x, w_ih, w_hh, bias, wd, *stash)
        return outf, outb

    @staticmethod
    def backward(ctx, doutf, doutb):
        x, w_ih, w_hh, bias, wd, *stash = ctx.saved_tensors
        return grid_fold_train_pair_bwd(x, w_ih, w_hh, bias, wd, doutf.contiguous(),
                                        doutb.contiguous(), tuple(stash))


def grid_fold_train_pair(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                         bias: torch.Tensor, wd: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused unfold(k=4) -> BiLSTM -> deconv -> overlap-add.

    Args:
      x: ``[S, lines, C]`` fp32 sequence-major lines (already LayerNorm'd
        and padded by the caller).
      w_ih: ``[2, 4C, 4H]``; w_hh: ``[2, H, 4H]``; bias: ``[2, 4H]``
        (i, f, g, o); wd: ``[2H, 4C]`` (rows 0:H forward, H:2H backward;
        tap-major columns), the layouts of the unfused path.

    Returns:
      ``(outf, outb)``, the per-direction folds ``[S, lines, C]`` without
      the deconv bias, exact on every row. On a CUDA tensor the kernels take
      C % 8 == 0, C <= 64 and H <= 128 (the model's gate), and raise outside.
    """
    if x.device.type == "cpu":
        return grid_fold_train_pair_plain(x, w_ih, w_hh, bias, wd)
    return _GridFoldTrainPair.apply(x, w_ih, w_hh, bias, wd)


grid_fold_train_pair.launches = 0
