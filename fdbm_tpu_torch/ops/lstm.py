"""Single-layer LSTM directions over sequence-major inputs ``[S, B, D]``.

Port of ``fdbm_tpu/ops/lstm.py``: the recurrences of TF-GridNet's generic
RNN path, which the model takes outside the fused grid kernels' gate
(C > 64 or H > 128; ``models/tfgridnet._kernel_fast_path_ok``).

* :func:`bilstm_fused_forward`: both directions, forward only (serving);
* :func:`lstm_core`: one differentiable direction, a
  ``torch.autograd.Function`` whose forward stashes what its backward,
  :func:`lstm_core_bwd`, needs; :func:`lstm_train` and :func:`bilstm_train`
  are the training route built on it;
* :func:`lstm_forward`: one direction, forward only (the training route
  without a gradient, ``FDBM.valid_step``).

On a CUDA tensor each launches hand-written kernels from ``csrc/lstm.cu``
(its source note says what bounds them on the H100 and how they are laid
out; :func:`recurrence_plan` sizes the forward recurrence's clusters); on a
CPU tensor it runs its plain version, the recurrence of
``ops.gridrnn.lstm_plain`` (under autograd for :func:`lstm_core`). Gate
order i, f, g, o; fp32 with an fp32 carry. Unlike the TPU kernels nothing
is padded: there is no lane or chunk layout to fill. A direction with
``reverse`` runs back to front, read through indices, and returns its
hidden states in time order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fdbm_tpu_torch.ops import _build
from fdbm_tpu_torch.ops.gridrnn import check_tensor, lstm_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_forward": [_P] * 6 + [_I] * 8 + [_P],
    "lstm_train_fwd": [_P] * 7 + [_I] * 7 + [_P],
    "lstm_rec_max_clusters": [_I] * 4,
    "lstm_rec_smem": [_I] * 3,
    "lstm_train_bwd_workspace": [_I] * 4,
    "lstm_train_bwd": [_P] * 13 + [_I] * 5 + [_P],
}
_RESTYPES = {"lstm_train_bwd_workspace": ctypes.c_longlong, "lstm_rec_smem": ctypes.c_longlong}
MAX_HIDDEN = 256  # the reverse sweep runs one thread per gate column: 4H <= 1024

# The forward recurrence's plans (csrc/lstm.cu: rec_plan): clusters of 1, 2,
# 4 or 8 blocks, tiles of a multiple of 4 lines up to 24, four lanes per
# unit and at most 256 threads a block, and a block's shared memory on the H100.
REC_CLUSTERS = (1, 2, 4, 8)
REC_LINES = (4, 8, 12, 16, 20, 24)
_KS, SMEM_LIMIT, SMS = 4, 232448, 132


class RecurrencePlan(NamedTuple):
    """How the forward recurrence runs: clusters of ``cs`` blocks, each
    cluster one tile of ``lines`` lines of one direction; ``clusters`` in
    the grid, of which the card runs ``max_clusters`` at once; ``threads``
    and ``smem_bytes`` per block."""
    cs: int
    lines: int
    clusters: int
    max_clusters: int
    threads: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def recurrence_layout(hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the plan (``cs``,
    ``lines``) at width ``hidden``, as ``csrc/lstm.cu:rec_plan`` lays it
    out, or None if it does not fit a block."""
    if cs not in REC_CLUSTERS or lines not in REC_LINES or hidden < 1:
        return None
    uc = _cdiv(hidden, cs)
    wst = 4 * uc + (8 - 4 * uc % 32) % 32
    lbp = lines if (lines // 4) % 2 else lines + 4
    threads = _cdiv(uc * _KS, 32) * 32
    nbytes = 4 * hidden * (wst + 2 * lbp)
    return (threads, nbytes) if threads <= 256 and nbytes <= SMEM_LIMIT else None


def plan_recurrence(lines: int, dirs: int, hidden: int,
                    max_clusters: Callable[[int, int], int]) -> RecurrencePlan:
    """The plan for ``lines`` lines in each of ``dirs`` directions at width
    ``hidden``; ``max_clusters(cs, lines)`` is the card's count of clusters
    of that plan that run at once. Plans whose grid is one wave come first;
    then the least estimated step, in cycles: a block's FMA dispatch on its
    busiest scheduler (4 per SM) at half rate, plus the cluster's exchange
    of h and its barrier, times the blocks an SM runs at once (fitted to
    the H100: 6.5 us a step for 4 x 12 lines, 10 us for 4 x 20); then
    smaller clusters."""
    best, best_key = None, None
    for cs in REC_CLUSTERS:
        for tile in REC_LINES:
            lay = recurrence_layout(hidden, cs, tile)
            if lay is None:
                continue
            at_once = max_clusters(cs, tile)
            if at_once < 1:
                continue
            threads, nbytes = lay
            clusters = dirs * _cdiv(lines, tile)
            waves = _cdiv(clusters, at_once)
            per_sm = _cdiv(at_once * cs, SMS)
            load = _cdiv(min(clusters, at_once) * cs * per_sm, at_once * cs)
            step = (2 * _cdiv(threads // 32, 4) * _cdiv(hidden, _KS) * 4 * tile
                    + 1000 + 800 * cs)
            key = (waves > 1, waves * load * step, cs)
            if best_key is None or key < best_key:
                best = RecurrencePlan(cs, tile, clusters, at_once, threads, nbytes)
                best_key = key
    if best is None:
        raise ValueError(f"lstm: no recurrence plan fits H={hidden} on this card")
    return best


@functools.lru_cache(maxsize=1024)
def _card_max_clusters(device_index: int, hidden: int, cs: int, tile: int, stash: bool) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one plan."""
    with torch.cuda.device(device_index):
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        n = lib.lstm_rec_max_clusters(hidden, cs, tile, int(stash))
    if n < 0:
        raise RuntimeError(f"lstm: cudaOccupancyMaxActiveClusters failed (CUDA error {-n}) "
                           f"for cs={cs}, lines={tile}, H={hidden}")
    return n


@functools.lru_cache(maxsize=256)
def _card_plan(device_index: int, lines: int, dirs: int, hidden: int,
               stash: bool) -> RecurrencePlan:
    return plan_recurrence(lines, dirs, hidden, lambda cs, tile: _card_max_clusters(
        device_index, hidden, cs, tile, stash))


def recurrence_plan(lines: int, dirs: int, hidden: int, stash: bool = False,
                    device: Optional[torch.device] = None) -> RecurrencePlan:
    """:func:`plan_recurrence` with the card's counts, each queried once: the
    plan the wrappers launch for this shape (``stash``: :func:`lstm_core`'s)."""
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _card_plan(index, lines, dirs, hidden, stash)


def recurrence_smem(hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count of a block's shared memory for a plan (-1 if
    it does not fit), to hold :func:`recurrence_layout` to it on the card."""
    lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
    return lib.lstm_rec_smem(hidden, cs, lines)

# (h, gates, c): hidden states, activated gates (i, f, g, o) and cell states
Stash = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def bilstm_fused_forward_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                               bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_fused_forward`."""
    return (lstm_plain(x, w_ih[0], w_hh[0], bias[0]),
            lstm_plain(x, w_ih[1], w_hh[1], bias[1], reverse=True))


def lstm_core_bwd_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                        bias: torch.Tensor, dout: torch.Tensor, reverse: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`lstm_core_bwd`: autograd through
    :func:`~fdbm_tpu_torch.ops.gridrnn.lstm_plain`. Returns
    ``(dx, dw_ih, dw_hh, dbias)``."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in (x, w_ih, w_hh, bias)]
        return torch.autograd.grad(lstm_plain(*args, reverse=reverse), args, dout)


def _check_args(fn: str, x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                bias: torch.Tensor, dirs: Tuple[int, ...]) -> Tuple[int, int, int, int]:
    """Validate the arguments on a CUDA device; ``dirs`` is ``(2,)`` for
    packed directions, ``()`` for one. Returns ``(S, B, D, H)``."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() != 3 or w_hh.dim() != len(dirs) + 2:
        raise ValueError(f"{fn}: x must be [S, B, D] and w_hh [{'2, ' * len(dirs)}H, 4H]")
    s, b, d = x.shape
    hidden = w_hh.shape[-2]
    if min(s, b, d, hidden) < 1 or hidden > MAX_HIDDEN:
        raise ValueError(f"{fn}: shape S={s}, B={b}, D={d}, H={hidden} is outside the "
                         f"kernel's range (each >= 1, H <= {MAX_HIDDEN})")
    dev = x.device
    check_tensor(fn, "x", x, x.shape, dev)
    check_tensor(fn, "w_ih", w_ih, (*dirs, d, 4 * hidden), dev)
    check_tensor(fn, "w_hh", w_hh, (*dirs, hidden, 4 * hidden), dev)
    check_tensor(fn, "bias", bias, (*dirs, 4 * hidden), dev)
    return s, b, d, hidden


def _empty(dev, *shape) -> torch.Tensor:
    return torch.empty(shape, device=dev, dtype=torch.float32)


def _forward(fn: str, x, w_ih, w_hh, bias, dirs: int, reverse: bool) -> torch.Tensor:
    """Launch ``lstm_forward`` on checked arguments: ``[dirs, S, B, H]``."""
    s, b, d, hidden = x.shape + (w_hh.shape[-2],)
    dev = x.device
    cs, tile = recurrence_plan(b, dirs, hidden, device=dev)[:2]
    with torch.cuda.device(dev):
        xp = _empty(dev, dirs, s, b, 4 * hidden)
        out = _empty(dev, dirs, s, b, hidden)
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        code = lib.lstm_forward(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), xp.data_ptr(),
            out.data_ptr(), s, b, d, hidden, dirs, int(reverse), cs, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"{fn} (recurrence plan cs={cs}, lines={tile})")
    return out


def bilstm_fused_forward(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                         bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both LSTM directions over ``x [S, B, D]`` (kernel 7).

    Args:
      x: ``[S, B, D]`` fp32; w_ih: ``[2, D, 4H]``; w_hh: ``[2, H, 4H]``;
        bias: ``[2, 4H]`` (direction 0 forward, 1 backward; gates i, f, g, o).

    Returns:
      ``(fwd, bwd)``, each ``[S, B, H]`` in time order; the backward
      direction starts from a zero state at the last frame. The kernels take
      H <= 256 and have no backward: on a CUDA tensor this raises if an input
      requires grad.
    """
    if x.device.type == "cpu":
        return bilstm_fused_forward_plain(x, w_ih, w_hh, bias)
    _check_args("bilstm_fused_forward", x, w_ih, w_hh, bias, (2,))
    _build.refuse_grad("bilstm_fused_forward", x, w_ih, w_hh, bias)
    out = _forward("bilstm_fused_forward", x, w_ih, w_hh, bias, 2, False)
    bilstm_fused_forward.launches += 1
    return out[0], out[1]


bilstm_fused_forward.launches = 0


def lstm_forward(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """One LSTM direction over ``x [S, B, D]`` -> ``[S, B, H]`` (kernel 10),
    with ``w_ih [D, 4H]``, ``w_hh [H, 4H]``, ``bias [4H]``. Forward only: on
    a CUDA tensor this raises if an input requires grad."""
    if x.device.type == "cpu":
        return lstm_plain(x, w_ih, w_hh, bias, reverse)
    _check_args("lstm_forward", x, w_ih, w_hh, bias, ())
    _build.refuse_grad("lstm_forward", x, w_ih, w_hh, bias)
    out = _forward("lstm_forward", x, w_ih, w_hh, bias, 1, reverse)
    lstm_forward.launches += 1
    return out[0]


lstm_forward.launches = 0


def lstm_core_fwd(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                  reverse: bool = False) -> Tuple[torch.Tensor, Stash]:
    """Kernel 8 on CUDA tensors: ``(h, stash)``, the hidden states and what
    :func:`lstm_core_bwd` needs. The autograd function calls it; tests and
    ``chip_smoke.py`` call it to reach the backward kernel directly."""
    s, b, d, hidden = _check_args("lstm_core", x, w_ih, w_hh, bias, ())
    dev = x.device
    cs, tile = recurrence_plan(b, 1, hidden, stash=True, device=dev)[:2]
    with torch.cuda.device(dev):
        gates = _empty(dev, s, b, 4 * hidden)
        h, c = _empty(dev, s, b, hidden), _empty(dev, s, b, hidden)
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        code = lib.lstm_train_fwd(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), gates.data_ptr(),
            h.data_ptr(), c.data_ptr(), s, b, d, hidden, int(reverse), cs, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"lstm_core (recurrence plan cs={cs}, lines={tile})")
    lstm_core.launches += 1
    return h, (h, gates, c)


def lstm_core_bwd(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
                  dout: torch.Tensor, stash: Optional[Stash] = None, reverse: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`lstm_core`: ``(dx, dw_ih, dw_hh, dbias)`` under the
    cotangent ``dout [S, B, H]`` of the hidden states.

    On a CUDA tensor it launches kernel 9 and needs the ``stash`` of the
    forward kernel; on a CPU tensor it runs :func:`lstm_core_bwd_plain`
    (``stash`` unused)."""
    if x.device.type == "cpu":
        return lstm_core_bwd_plain(x, w_ih, w_hh, bias, dout, reverse)
    fn = "lstm_core_bwd"
    s, b, d, hidden = _check_args(fn, x, w_ih, w_hh, bias, ())
    if stash is None:
        raise ValueError(f"{fn}: the CUDA kernel needs the forward kernel's stash")
    h, gates, c = stash
    dev = x.device
    check_tensor(fn, "dout", dout, (s, b, hidden), dev)
    check_tensor(fn, "h", h, (s, b, hidden), dev)
    check_tensor(fn, "gates", gates, (s, b, 4 * hidden), dev)
    check_tensor(fn, "c", c, (s, b, hidden), dev)
    with torch.cuda.device(dev):
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        w_t = w_hh.t().contiguous()
        dgates = _empty(dev, s, b, 4 * hidden)
        work = _empty(dev, lib.lstm_train_bwd_workspace(s, b, d, hidden))
        grads = (torch.empty_like(x), torch.empty_like(w_ih), torch.empty_like(w_hh),
                 torch.empty_like(bias))
        code = lib.lstm_train_bwd(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), gates.data_ptr(), dout.data_ptr(),
            w_ih.data_ptr(), w_t.data_ptr(), dgates.data_ptr(), work.data_ptr(),
            *(g.data_ptr() for g in grads), s, b, d, hidden, int(reverse),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, fn)
    lstm_core_bwd.launches += 1
    return grads


lstm_core_bwd.launches = 0


class _LstmCore(torch.autograd.Function):
    """Kernel 8 forward, kernel 9 backward."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, bias, reverse):
        h, stash = lstm_core_fwd(x, w_ih, w_hh, bias, reverse)
        ctx.save_for_backward(x, w_ih, w_hh, bias, *stash)
        ctx.reverse = reverse
        return h

    @staticmethod
    def backward(ctx, dout):
        x, w_ih, w_hh, bias, *stash = ctx.saved_tensors
        grads = lstm_core_bwd(x, w_ih, w_hh, bias, dout.contiguous(), tuple(stash),
                              ctx.reverse)
        return (*grads, None)


def lstm_core(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """One differentiable LSTM direction over ``x [S, B, D]`` -> ``[S, B, H]``,
    with ``w_ih [D, 4H]``, ``w_hh [H, 4H]``, ``bias [4H]``. On a CUDA tensor
    its forward is kernel 8 and its backward kernel 9 (H <= 256)."""
    if x.device.type == "cpu":
        return lstm_plain(x, w_ih, w_hh, bias, reverse)
    return _LstmCore.apply(x, w_ih, w_hh, bias, reverse)


lstm_core.launches = 0


def lstm_train(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """The training route of one direction, the JAX package's
    ``lstm_train_pallas``: :func:`lstm_core` when autograd needs a gradient,
    else its primal without the stash, :func:`lstm_forward`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_ih, w_hh, bias)):
        return lstm_core(x, w_ih, w_hh, bias, reverse)
    return lstm_forward(x, w_ih, w_hh, bias, reverse)


def bilstm_train(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Bidirectional training route over sequence-major ``x [S, N, D]`` ->
    ``[S, N, 2H]`` (forward ++ backward): the JAX package's
    ``bilstm_pallas_train``, which takes and returns ``[N, S, *]``. One
    :func:`lstm_train` per direction."""
    x = x.contiguous()
    return torch.cat([lstm_train(x, w_ih[z], w_hh[z], bias[z], reverse=z == 1)
                      for z in (0, 1)], dim=-1)
