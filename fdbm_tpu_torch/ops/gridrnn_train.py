"""Differentiable TF-GridNet RNN path on sequence-major lines (training).

Port of ``fdbm_tpu/ops/gridrnn_train.py:grid_fold_train_pair``: the fused
unfold(k=4) -> BiLSTM -> deconv -> overlap-add with its own backward. On a
CUDA tensor :func:`grid_fold_train_pair` is a ``torch.autograd.Function``
whose forward launches the stashing forward kernel (kernel 1's fused cluster
recurrence with its stash, ``csrc/gridrnn.cu``) and whose backward launches
:func:`grid_fold_train_pair_bwd` (a reverse sweep on clusters, then dx and
the weight gradients, ``csrc/gridrnn_train.cu``; its source note says what
bounds it and how it is laid out). :func:`train_fwd_plan` and
:func:`train_sweep_plan` size the two recurrences' clusters. On a CPU
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
import functools
from typing import Callable, Optional, Tuple

import torch

from fdbm_tpu_torch.ops import _build, gridrnn
from fdbm_tpu_torch.ops.gridrnn import (CLUSTERS, KS, SMEM_LIMIT, ClusterPlan, _cdiv,
                                        check_rnn_args, check_tensor, grid_rnn_seq1_pair_plain,
                                        plan_clusters, plan_fused)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grid_fold_train_bwd_workspace": [_I] * 4,
    "grid_fold_train_bwd": [_P] * 16 + [_I] * 6 + [_P],
    "grid_train_sweep_max_clusters": [_I] * 4,
    "grid_train_sweep_smem": [_I] * 4,
}
_RESTYPES = {"grid_fold_train_bwd_workspace": ctypes.c_longlong,
             "grid_train_sweep_smem": ctypes.c_longlong}
# Kernel 5 lives beside kernel 1, whose fused recurrence it shares.
_FWD_SIGNATURES = {"grid_fold_train_fwd": [_P] * 10 + [_I] * 6 + [_P]}

# (gates [2, lines, L, H, 4]: activated i, f, g, o of a unit together;
#  hs, cs [2, lines, L, H])
Stash = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# The reverse sweep's plans (csrc/gridrnn_train.cu: sweep_plan): clusters of
# CLUSTERS blocks that split C evenly, tiles of 8 or 16 lines, a warp of four
# groups of four units x eight lanes, at most five cells (line, unit) a
# thread and 256 threads a block, a ring of 8 cotangent rows.
SWEEP_LINES = (8, 16)
SWEEP_RING = 8
SWEEP_MAX_CELLS = 5


def train_sweep_layout(c: int, hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the reverse sweep at
    widths ``c``, ``hidden`` for the plan (``cs``, ``lines``), as
    ``csrc/gridrnn_train.cu:sweep_plan`` lays it out (its units' gate
    columns of w_hh, its channels' rows of wd^T, the tile's dgates, two
    receive tiles of every rank's sums, the ring of cotangent rows, the
    cells' stashes of a step: 4 gates, c_prev), or None if it does not fit
    a block."""
    if cs not in CLUSTERS or lines not in SWEEP_LINES or hidden < 1 or c < 1 or c % cs:
        return None
    kgroups = _cdiv(hidden, 4)
    uc, cc = _cdiv(hidden, cs), c // cs
    kp = 4 * kgroups + (48 - 4 * kgroups % 32) % 32
    lbp = lines if (lines // 4) % 2 else lines + 4
    lanes, stagers = _cdiv(kgroups, 4) * 32, _cdiv(lines * cc, 4)
    threads = lanes if lanes > stagers else _cdiv(stagers, 32) * 32
    nbytes = 4 * (4 * (uc + cc) * kp + 4 * uc * lbp + 2 * cs * lines * uc
                  + SWEEP_RING * cc * lbp + 5 * lines * uc)
    fits = (threads <= 256 and _cdiv(lines * uc, threads) <= SWEEP_MAX_CELLS
            and nbytes <= SMEM_LIMIT)
    return (threads, nbytes) if fits else None


def plan_train_fwd(lines: int, c: int, hidden: int,
                   max_clusters: Callable[[int, int], int]) -> ClusterPlan:
    """Kernel 5's plan for ``lines`` lines in each direction: kernel 1's
    (``ops.gridrnn.plan_fused``), with the card's counts of the stashing
    kernel."""
    return plan_fused(lines, c, hidden, max_clusters, "grid_fold_train_pair")


def plan_train_sweep(lines: int, c: int, hidden: int,
                     max_clusters: Callable[[int, int], int]) -> ClusterPlan:
    """Kernel 6's reverse sweep's plan for ``lines`` lines in each direction
    (see ``ops.gridrnn.plan_clusters``): a lane sums an eighth of its
    block's units (16 FMAs a line each) and of its block's 4C / cs rows of
    wd^T (4 FMAs a line each) for 4 units x tile lines."""
    return plan_clusters(
        lines, 2, SWEEP_LINES, lambda cs, tile: train_sweep_layout(c, hidden, cs, tile),
        max_clusters,
        lambda cs, tile: (_cdiv(_cdiv(hidden, cs), 8) * 16 + _cdiv(4 * (c // cs), 8) * 4) * tile,
        f"grid_fold_train_pair_bwd: no reverse sweep plan for C={c}, H={hidden}")


@functools.lru_cache(maxsize=1024)
def _card_max_clusters(device_index: int, which: str, c: int, hidden: int, cs: int,
                       tile: int) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one plan of kernel
    5 (``which`` "fwd") or of kernel 6's sweep ("bwd")."""
    if which == "fwd":
        return gridrnn._card_max_clusters(device_index, c, hidden, cs, tile, stash=True)
    with torch.cuda.device(device_index):
        lib = _build.load("gridrnn_train", _SIGNATURES, _RESTYPES)
        n = lib.grid_train_sweep_max_clusters(c, hidden, cs, tile)
    if n < 0:
        raise RuntimeError(f"grid_fold_train_pair_bwd: cudaOccupancyMaxActiveClusters failed "
                           f"(CUDA error {-n}) for cs={cs}, lines={tile}, C={c}, H={hidden}")
    return n


@functools.lru_cache(maxsize=256)
def _card_plan(device_index: int, which: str, lines: int, c: int, hidden: int) -> ClusterPlan:
    counts = lambda cs, tile: _card_max_clusters(device_index, which, c, hidden, cs, tile)
    plan = plan_train_fwd if which == "fwd" else plan_train_sweep
    return plan(lines, c, hidden, counts)


def _device_index(device: Optional[torch.device]) -> int:
    dev = torch.device(device if device is not None else "cuda")
    return dev.index if dev.index is not None else torch.cuda.current_device()


def train_fwd_plan(lines: int, c: int, hidden: int,
                   device: Optional[torch.device] = None) -> ClusterPlan:
    """:func:`plan_train_fwd` with the card's counts, each queried once: the
    plan :func:`grid_fold_train_pair_fwd` launches for this shape."""
    return _card_plan(_device_index(device), "fwd", lines, c, hidden)


def train_sweep_plan(lines: int, c: int, hidden: int,
                     device: Optional[torch.device] = None) -> ClusterPlan:
    """:func:`plan_train_sweep` with the card's counts, each queried once:
    the plan :func:`grid_fold_train_pair_bwd` launches for this shape."""
    return _card_plan(_device_index(device), "bwd", lines, c, hidden)


def train_sweep_smem(c: int, hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count of a block's shared memory for a sweep plan
    (-1 if it does not fit), to hold :func:`train_sweep_layout` to it on the
    card."""
    lib = _build.load("gridrnn_train", _SIGNATURES, _RESTYPES)
    return lib.grid_train_sweep_smem(c, hidden, cs, lines)


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
    cs, tile = train_fwd_plan(lines, c, hidden, dev)[:2]
    with torch.cuda.device(dev):
        gates = _empty(dev, 2, lines, length, hidden, 4)
        hs = _empty(dev, 2, lines, length, hidden)
        cst = _empty(dev, 2, lines, length, hidden)
        outf, outb = torch.empty_like(x), torch.empty_like(x)
        lib = _build.load("gridrnn", _FWD_SIGNATURES)
        code = lib.grid_fold_train_fwd(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), wd.data_ptr(),
            gates.data_ptr(), hs.data_ptr(), cst.data_ptr(), outf.data_ptr(), outb.data_ptr(),
            s, lines, c, hidden, cs, tile, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"grid_fold_train_pair (plan cs={cs}, lines={tile})")
    grid_fold_train_pair.launches += 1
    return outf, outb, (gates, hs, cst)


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
    gates, hs, cst = stash
    check_tensor(fn, "doutf", doutf, x.shape, dev)
    check_tensor(fn, "doutb", doutb, x.shape, dev)
    check_tensor(fn, "gates", gates, (2, lines, length, hidden, 4), dev)
    check_tensor(fn, "hs", hs, (2, lines, length, hidden), dev)
    check_tensor(fn, "cs", cst, (2, lines, length, hidden), dev)
    cs, tile = train_sweep_plan(lines, c, hidden, dev)[:2]
    with torch.cuda.device(dev):
        lib = _build.load("gridrnn_train", _SIGNATURES, _RESTYPES)
        dgates = _empty(dev, 2, lines, length, 4 * hidden)
        work = _empty(dev, lib.grid_fold_train_bwd_workspace(s, lines, c, hidden))
        dx = torch.empty_like(x)
        grads = (_empty(dev, 2, KS * c, 4 * hidden), _empty(dev, 2, hidden, 4 * hidden),
                 _empty(dev, 2, 4 * hidden), _empty(dev, 2 * hidden, KS * c))
        code = lib.grid_fold_train_bwd(
            x.data_ptr(), doutf.data_ptr(), doutb.data_ptr(), gates.data_ptr(), hs.data_ptr(),
            cst.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), wd.data_ptr(), dgates.data_ptr(),
            work.data_ptr(), dx.data_ptr(), *(g.data_ptr() for g in grads), s, lines, c, hidden,
            cs, tile, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"{fn} (plan cs={cs}, lines={tile})")
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
