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
out; :func:`recurrence_plan` sizes the forward recurrence's clusters,
:func:`sweep_plan` the reverse sweep's); on a
CPU tensor it runs its plain version, the recurrence of
``ops.gridrnn.lstm_plain`` (under autograd for :func:`lstm_core`). Gate
order i, f, g, o; fp32 with an fp32 carry. Unlike the TPU kernels nothing
is padded: there is no lane or chunk layout to fill. A direction with
``reverse`` runs back to front, read through indices, and returns its
hidden states in time order.

:func:`bilstm_fused_forward` also takes bf16 inputs (``inference_dtype:
bfloat16``) and then launches the kernels' bf16 form, the JAX kernel's bf16
path (``fdbm_tpu/ops/lstm.py:500-521,548``): bf16 x and hidden states, w_ih
and w_hh rounded to bf16, h rounded to bf16 before each product, fp32
pre-activations, bias, cell state and gates, both products on the tensor
cores (the projection ``dense_mma_kernel``; the recurrence
``lstm_mma_kernel``, planned by :func:`recurrence_mma_plan`). Its plain
version is the same function on a bf16 tensor. The two forms count their
launches apart (``launches``, ``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from fdbm_tpu_torch.ops import _build
from fdbm_tpu_torch.ops.gridrnn import (CLUSTERS, SMEM_LIMIT, ClusterPlan, _cdiv, check_tensor,
                                        fma_step, lstm_plain, plan_clusters, round_bf16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_forward": [_P] * 6 + [_I] * 8 + [_P],
    "lstm_forward_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "lstm_train_fwd": [_P] * 7 + [_I] * 7 + [_P],
    "lstm_rec_max_clusters": [_I] * 4,
    "lstm_rec_smem": [_I] * 3,
    "lstm_sweep_max_clusters": [_I] * 3,
    "lstm_sweep_smem": [_I] * 3,
    "lstm_train_bwd_workspace": [_I] * 4,
    "lstm_train_bwd": [_P] * 11 + [_I] * 7 + [_P],
    "lstm_projection_bf16": [_P] * 4 + [ctypes.c_longlong] + [_I] * 3 + [_P],
    "lstm_projection_smem": [_I],
    "lstm_mma_max_clusters": [_I] * 3,
    "lstm_mma_smem": [_I] * 3,
}
_RESTYPES = {"lstm_train_bwd_workspace": ctypes.c_longlong, "lstm_rec_smem": ctypes.c_longlong,
             "lstm_sweep_smem": ctypes.c_longlong, "lstm_projection_smem": ctypes.c_longlong,
             "lstm_mma_smem": ctypes.c_longlong}
MAX_HIDDEN = 256  # four lanes per unit (or group of four units) in at most 256 threads

# The recurrences' plans (csrc/lstm.cu: rec_plan, sweep_plan; planned by
# ops/gridrnn.plan_clusters): tiles of a multiple of 4 lines up to 24, four
# lanes per unit (forward) or per group of four units (the reverse sweep), at
# most 256 threads a block.
REC_CLUSTERS = CLUSTERS
REC_LINES = (4, 8, 12, 16, 20, 24)
_KS = 4
# The bf16 form on the tensor cores (csrc/lstm.cu): the recurrence's tiles
# of 16 or 32 lines (lstm_mma_plan: two quads of units a warp, at most 512
# threads); the projection's 160-column tiles of 128 or 64 rows
# (dense_mma_plan), the whole depth of w_ih resident.
MMA_LINES = (16, 32)
_LM_QPW, _LM_MAX_THREADS = 2, 512
_DM_BN = 160


def recurrence_layout(hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the forward plan
    (``cs``, ``lines``) at width ``hidden``, as ``csrc/lstm.cu:rec_plan``
    lays it out, or None if it does not fit a block."""
    if cs not in REC_CLUSTERS or lines not in REC_LINES or hidden < 1:
        return None
    uc = _cdiv(hidden, cs)
    wst = 4 * uc + (8 - 4 * uc % 32) % 32
    lbp = lines if (lines // 4) % 2 else lines + 4
    threads = _cdiv(uc * _KS, 32) * 32
    nbytes = 4 * hidden * (wst + 2 * lbp)
    return (threads, nbytes) if threads <= 256 and nbytes <= SMEM_LIMIT else None


def sweep_layout(hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the reverse sweep's
    plan, as ``csrc/lstm.cu:sweep_plan`` lays it out (the units' gate
    columns of w_hh n-major, the tile's dgates, two receive tiles of every
    rank's partial sums, the cells' stashes of a step: 4 gates, c_prev,
    dout), or None if it does not fit a block."""
    if cs not in REC_CLUSTERS or lines not in REC_LINES or hidden < 1:
        return None
    uc = _cdiv(hidden, cs)
    kp = 4 * _cdiv(hidden, 4)
    threads = _cdiv(kp, 32) * 32  # four lanes per group of four units
    nbytes = 4 * (4 * uc * kp + lines * 4 * uc + (2 * cs + 6) * lines * uc)
    cells = _cdiv(lines * uc, threads)
    # a thread of the sweep owns at most lines / 4 + 1 cells (line, unit)
    fits = threads <= 256 and cells <= lines // 4 + 1 and nbytes <= SMEM_LIMIT
    return (threads, nbytes) if fits else None


def recurrence_mma_layout(hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the bf16 recurrence
    plan (``cs``, ``lines``) at width ``hidden``, as
    ``csrc/lstm.cu:lstm_mma_plan`` lays it out (the block's gate columns of
    w_hh in bf16, 16 a quad of units, over H padded to 16 rows; two bf16
    copies of the tile's h), or None if it does not fit a block."""
    if cs not in REC_CLUSTERS or lines not in MMA_LINES or not 1 <= hidden <= MAX_HIDDEN:
        return None
    quads = _cdiv(_cdiv(hidden, cs), 4)
    kh = 16 * _cdiv(hidden, 16)
    threads = 32 * _cdiv(quads, _LM_QPW)
    nbytes = 2 * kh * 16 * quads + 4 * kh * lines
    return (threads, nbytes) if threads <= _LM_MAX_THREADS and nbytes <= SMEM_LIMIT else None


def recurrence_mma_step_cycles(hidden: int, cs: int, lines: int) -> int:
    """Estimated cycles of one step of one block of the bf16 recurrence: its
    m16n8k16 products on the busiest of the SM's four sub-partitions (about
    8 cycles each) or its ldmatrix reads (512 bytes each at 128 bytes a
    cycle), whichever is longer, plus the cell and the cluster's barrier and
    remote writes of h."""
    quads = _cdiv(_cdiv(hidden, cs), 4)
    warps = _cdiv(quads, _LM_QPW)
    k_tiles = _cdiv(hidden, 16)
    mt = lines // 16
    products = _cdiv(warps, 4) * _LM_QPW * 2 * mt * k_tiles * 8
    loads = 4 * k_tiles * (quads + warps * mt)
    return max(products, loads) + 300 * mt + 1000 + 800 * cs


def plan_recurrence_mma(lines: int, dirs: int, hidden: int,
                        max_clusters: Callable[[int, int], int]) -> ClusterPlan:
    """The bf16 recurrence's plan for ``lines`` lines in each of ``dirs``
    directions (see ``ops.gridrnn.plan_clusters``), a step estimated by
    :func:`recurrence_mma_step_cycles`."""
    return plan_clusters(lines, dirs, MMA_LINES,
                         lambda cs, tile: recurrence_mma_layout(hidden, cs, tile), max_clusters,
                         lambda cs, tile, threads: recurrence_mma_step_cycles(hidden, cs, tile),
                         f"lstm (bf16): no recurrence plan for H={hidden}")


def projection_mma_layout(d_in: int) -> Optional[Tuple[int, int]]:
    """``(rows a tile, shared-memory bytes)`` of the bf16 projection's block
    at depth ``d_in``, as ``csrc/lstm.cu:dense_mma_plan`` lays it out (a
    160-column tile of w_ih over the depth rounded to 16, and two x tiles),
    or None if even 64-row tiles do not fit."""
    if d_in < 1:
        return None
    kp = 16 * _cdiv(d_in, 16)
    for bm in (128, 64):
        nbytes = 2 * kp * (_DM_BN + 8) + 2 * 2 * bm * (kp + 8)
        if nbytes <= SMEM_LIMIT:
            return bm, nbytes
    return None


def plan_recurrence(lines: int, dirs: int, hidden: int,
                    max_clusters: Callable[[int, int], int]) -> ClusterPlan:
    """The forward recurrence's plan for ``lines`` lines in each of ``dirs``
    directions at width ``hidden``; ``max_clusters(cs, lines)`` is the
    card's count of clusters of that plan that run at once (see
    ``ops.gridrnn.plan_clusters``). A lane sums a quarter of H rows for 4
    gates x tile lines."""
    return plan_clusters(lines, dirs, REC_LINES,
                         lambda cs, tile: recurrence_layout(hidden, cs, tile), max_clusters,
                         fma_step(lambda cs, tile: _cdiv(hidden, _KS) * 4 * tile),
                         f"lstm: no recurrence plan for H={hidden}")


def plan_sweep(lines: int, hidden: int, max_clusters: Callable[[int, int], int]
               ) -> ClusterPlan:
    """The reverse sweep's plan (kernel 9) for ``lines`` lines of one
    direction: as :func:`plan_recurrence`, with a lane summing a quarter of
    its block's units' gate quads for 4 units x tile lines (16 x tile FMAs
    per quad)."""
    return plan_clusters(lines, 1, REC_LINES, lambda cs, tile: sweep_layout(hidden, cs, tile),
                         max_clusters,
                         fma_step(lambda cs, tile: _cdiv(_cdiv(hidden, cs), _KS) * 16 * tile),
                         f"lstm: no reverse sweep plan for H={hidden}")


@functools.lru_cache(maxsize=1024)
def _card_max_clusters(device_index: int, hidden: int, cs: int, tile: int, kind: str) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one plan of the
    forward (``kind`` "forward" or "stash") or of the sweep ("sweep")."""
    with torch.cuda.device(device_index):
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        if kind == "sweep":
            n = lib.lstm_sweep_max_clusters(hidden, cs, tile)
        elif kind == "mma":
            n = lib.lstm_mma_max_clusters(hidden, cs, tile)
        else:
            n = lib.lstm_rec_max_clusters(hidden, cs, tile, int(kind == "stash"))
    if n < 0:
        raise RuntimeError(f"lstm: cudaOccupancyMaxActiveClusters failed (CUDA error {-n}) "
                           f"for the {kind} plan cs={cs}, lines={tile}, H={hidden}")
    return n


@functools.lru_cache(maxsize=256)
def _card_plan(device_index: int, lines: int, dirs: int, hidden: int,
               kind: str) -> ClusterPlan:
    counts = lambda cs, tile: _card_max_clusters(device_index, hidden, cs, tile, kind)
    if kind == "sweep":
        return plan_sweep(lines, hidden, counts)
    if kind == "mma":
        return plan_recurrence_mma(lines, dirs, hidden, counts)
    return plan_recurrence(lines, dirs, hidden, counts)


def _device_index(device: Optional[torch.device]) -> int:
    dev = torch.device(device if device is not None else "cuda")
    return dev.index if dev.index is not None else torch.cuda.current_device()


def recurrence_plan(lines: int, dirs: int, hidden: int, stash: bool = False,
                    device: Optional[torch.device] = None) -> ClusterPlan:
    """:func:`plan_recurrence` with the card's counts, each queried once: the
    plan the wrappers launch for this shape (``stash``: :func:`lstm_core`'s)."""
    return _card_plan(_device_index(device), lines, dirs, hidden,
                      "stash" if stash else "forward")


def recurrence_mma_plan(lines: int, dirs: int, hidden: int,
                        device: Optional[torch.device] = None) -> ClusterPlan:
    """:func:`plan_recurrence_mma` with the card's counts, each queried once:
    the plan :func:`bilstm_fused_forward` launches on a bf16 x."""
    return _card_plan(_device_index(device), lines, dirs, hidden, "mma")


def recurrence_mma_smem(hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count of a block's shared memory for a bf16 plan (-1
    if it does not fit), to hold :func:`recurrence_mma_layout` to it."""
    lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
    return lib.lstm_mma_smem(hidden, cs, lines)


def projection_mma_smem(d_in: int) -> int:
    """The kernel's own count for the bf16 projection, against
    :func:`projection_mma_layout`."""
    lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
    return lib.lstm_projection_smem(d_in)


def sweep_plan(lines: int, hidden: int, device: Optional[torch.device] = None
               ) -> ClusterPlan:
    """:func:`plan_sweep` with the card's counts: the plan
    :func:`lstm_core_bwd` launches for ``lines`` lines at width ``hidden``."""
    return _card_plan(_device_index(device), lines, 1, hidden, "sweep")


def recurrence_smem(hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count of a block's shared memory for a forward plan
    (-1 if it does not fit), to hold :func:`recurrence_layout` to it on the
    card."""
    lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
    return lib.lstm_rec_smem(hidden, cs, lines)


def sweep_smem(hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count for a sweep plan, against :func:`sweep_layout`."""
    lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
    return lib.lstm_sweep_smem(hidden, cs, lines)

# (h, gates, c): hidden states, activated gates (i, f, g, o) and cell states
Stash = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def bilstm_fused_forward_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                               bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bilstm_fused_forward`; on a bf16
    tensor the plain version of the bf16 form: x widened to fp32, w_ih and
    w_hh rounded to bf16, h rounded before each product, the outputs bf16."""
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, w_ih, w_hh = x.float(), round_bf16(w_ih), round_bf16(w_hh)
    outs = tuple(lstm_plain(x, w_ih[z], w_hh[z], bias[z], reverse=z == 1, round_h=bf16)
                 for z in (0, 1))
    return tuple(o.to(torch.bfloat16) for o in outs) if bf16 else outs


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
                bias: torch.Tensor, dirs: Tuple[int, ...],
                x_dtypes: Tuple[torch.dtype, ...] = (torch.float32,)
                ) -> Tuple[int, int, int, int]:
    """Validate the arguments on a CUDA device; ``dirs`` is ``(2,)`` for
    packed directions, ``()`` for one; x of one of ``x_dtypes``, the
    weights fp32. Returns ``(S, B, D, H)``."""
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
    if x.dtype not in x_dtypes:
        raise ValueError(f"{fn}: x must be one of {x_dtypes}, got {x.dtype}")
    check_tensor(fn, "x", x, x.shape, dev, x.dtype)
    check_tensor(fn, "w_ih", w_ih, (*dirs, d, 4 * hidden), dev)
    check_tensor(fn, "w_hh", w_hh, (*dirs, hidden, 4 * hidden), dev)
    check_tensor(fn, "bias", bias, (*dirs, 4 * hidden), dev)
    return s, b, d, hidden


def _empty(dev, *shape) -> torch.Tensor:
    return torch.empty(shape, device=dev, dtype=torch.float32)


def _forward(fn: str, x, w_ih, w_hh, bias, dirs: int, reverse: bool,
             plan: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch ``lstm_forward`` (``lstm_forward_bf16``, on the tensor cores,
    for a bf16 x) on checked arguments at the card's plan, or at ``plan``
    (cs, lines): ``[dirs, S, B, H]`` in x's dtype."""
    s, b, d, hidden = x.shape + (w_hh.shape[-2],)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    if plan is not None:
        cs, tile = plan
    elif bf16:
        if projection_mma_layout(d) is None:
            raise ValueError(f"{fn}: D={d} input features are above the bf16 projection's "
                             f"limit: a 64-row tile no longer fits in a block's shared memory")
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: a bf16 x must start on a 16-byte boundary")
        cs, tile = recurrence_mma_plan(b, dirs, hidden, device=dev)[:2]
    else:
        cs, tile = recurrence_plan(b, dirs, hidden, device=dev)[:2]
    with torch.cuda.device(dev):
        xp = _empty(dev, dirs, s, b, 4 * hidden)
        out = torch.empty((dirs, s, b, hidden), device=dev, dtype=x.dtype)
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        entry = lib.lstm_forward_bf16 if bf16 else lib.lstm_forward
        code = entry(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), xp.data_ptr(),
            out.data_ptr(), s, b, d, hidden, dirs, int(reverse), cs, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"{fn} (recurrence plan cs={cs}, lines={tile})")
    return out


def bilstm_fused_forward(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                         bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both LSTM directions over ``x [S, B, D]`` (kernel 7).

    Args:
      x: ``[S, B, D]`` fp32 or bf16; w_ih: ``[2, D, 4H]``; w_hh:
        ``[2, H, 4H]``; bias: ``[2, 4H]`` (direction 0 forward, 1 backward;
        gates i, f, g, o); the weights fp32.

    Returns:
      ``(fwd, bwd)``, each ``[S, B, H]`` in time order and x's dtype; the
      backward direction starts from a zero state at the last frame. The
      kernels take H <= 256 and have no backward: on a CUDA tensor this
      raises if an input requires grad. A bf16 x launches the bf16 form and
      counts on ``launches_bf16``.
    """
    if x.device.type == "cpu":
        return bilstm_fused_forward_plain(x, w_ih, w_hh, bias)
    _check_args("bilstm_fused_forward", x, w_ih, w_hh, bias, (2,),
                (torch.float32, torch.bfloat16))
    _build.refuse_grad("bilstm_fused_forward", x, w_ih, w_hh, bias)
    out = _forward("bilstm_fused_forward", x, w_ih, w_hh, bias, 2, False)
    if x.dtype == torch.bfloat16:
        bilstm_fused_forward.launches_bf16 += 1
    else:
        bilstm_fused_forward.launches += 1
    return out[0], out[1]


bilstm_fused_forward.launches = 0
bilstm_fused_forward.launches_bf16 = 0


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
    cs, tile = sweep_plan(b, hidden, device=dev)[:2]
    with torch.cuda.device(dev):
        lib = _build.load("lstm", _SIGNATURES, _RESTYPES)
        dgates = _empty(dev, s, b, 4 * hidden)
        work = _empty(dev, lib.lstm_train_bwd_workspace(s, b, d, hidden))
        dx = torch.empty_like(x)
        dwg = _empty(dev, d + hidden + 1, 4 * hidden)  # dW_ih, dW_hh, db
        code = lib.lstm_train_bwd(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), gates.data_ptr(), dout.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), dgates.data_ptr(), work.data_ptr(),
            dx.data_ptr(), dwg.data_ptr(), s, b, d, hidden, int(reverse), cs, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"{fn} (sweep plan cs={cs}, lines={tile})")
    lstm_core_bwd.launches += 1
    return dx, dwg[:d], dwg[d:d + hidden], dwg[d + hidden]


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
