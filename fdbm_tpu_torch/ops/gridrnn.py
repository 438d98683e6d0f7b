"""TF-GridNet RNN path: unfold + BiLSTM + deconv + fold, forward only.

Port of ``fdbm_tpu/ops/gridrnn.py``: :func:`grid_rnn_seq1_pair` on the
canvas (serving) and :func:`grid_bilstm_fold` on sequence-major lines (the
training route's forward when no gradient is needed). On a CUDA tensor each
launches the hand-written kernels of ``csrc/gridrnn.cu``: a cluster
recurrence with the input projection fused in, its clusters sized by
:func:`fused_plan`, then deconv + overlap-add (per direction, or both
directions summed for :func:`grid_bilstm_fold`); on a CPU tensor it runs
its ``*_plain`` version, the same function in plain PyTorch. The source
note of ``csrc/gridrnn.cu`` says what bounds the kernels on the H100 and
how they are laid out. The differentiable twin is ``ops/gridrnn_train.py``.

:func:`grid_rnn_seq1_pair` also takes a bf16 canvas (``inference_dtype:
bfloat16``): it then launches its bf16 form, which computes the JAX
kernel's bf16 path (``fdbm_tpu/ops/gridrnn.py:467,514-515,550-553``): bf16
canvas, hidden states and outputs, the weights rounded to bf16, h rounded to
bf16 before each product, fp32 sums, bias, cell state and gates. Its
recurrence is a kernel of its own on the tensor cores (mma.sync on bf16
operands), its plan from :func:`mma_plan`; the fold is the fp32 form's on
bf16 h. Its plain version is the same function on a bf16 tensor
(:func:`grid_rnn_seq1_pair_plain`): the same operands rounded with
``.to(torch.bfloat16)`` and multiplied in fp32. The two forms count their
launches apart (``launches``, ``launches_bf16``).

The plain LSTM recurrences, :func:`lstm_plain` (one direction) and
:func:`bilstm_plain`, live here because the plain version needs them;
:func:`lstm_plain` is also the plain version of ``ops/lstm.py``'s kernels,
and so of ``models/layers.BiLSTM``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fdbm_tpu_torch.ops import _build

KS = 4  # unfold width (emb_ks)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gridrnn_seq1_pair": [_P] * 8 + [_I] * 7 + [_P],
               "gridrnn_seq1_pair_bf16": [_P] * 8 + [_I] * 7 + [_P],
               "gridrnn_fused_max_clusters": [_I] * 5,
               "gridrnn_fused_smem": [_I] * 4,
               "gridrnn_mma_max_clusters": [_I] * 4,
               "gridrnn_mma_smem": [_I] * 4}
_RESTYPES = {"gridrnn_fused_smem": ctypes.c_longlong, "gridrnn_mma_smem": ctypes.c_longlong}
# Kernel 4 lives beside kernel 1, whose fused recurrence it runs.
_FOLD_SIGNATURES = {"grid_bilstm_fold": [_P] * 7 + [_I] * 6 + [_P]}


# The cluster kernels' plans: clusters of 1, 2, 4 or 8 blocks, within a
# block's shared memory on the H100, over the card's 132 SMs.
CLUSTERS = (1, 2, 4, 8)
SMEM_LIMIT, SMS = 232448, 132
# Kernel 1's fused recurrence (csrc/gridrnn.cu: fused_plan): tiles of 8 lines
# (eight lanes per pair of units) or 16 (four lanes per unit), at most 256
# threads a block, a ring of 8 canvas rows.
FUSED_LINES = (8, 16)
FUSED_RING = 8
# Kernel 1's bf16 form (csrc/gridrnn.cu: mma_plan): tiles of 16 or 32 lines
# (one or two M tiles of mma), two quads of units a warp, at most 512 threads
# a block, a ring of 8 canvas rows.
MMA_LINES = (16, 32)
MMA_RING, MMA_QUADS_PER_WARP, MMA_MAX_THREADS = 8, 2, 512
MMA_STAGE = 4  # 16-byte copies of a canvas row a thread stages, at most


class ClusterPlan(NamedTuple):
    """How a recurrence runs on clusters: ``cs`` blocks a cluster, each
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


def plan_clusters(lines: int, dirs: int, tiles: Tuple[int, ...],
                  layout: Callable[[int, int], Optional[Tuple[int, int]]],
                  max_clusters: Callable[[int, int], int],
                  step_cycles: Callable[[int, int, int], int], what: str) -> ClusterPlan:
    """The plan of least estimated time for ``lines`` lines in each of
    ``dirs`` directions: over clusters of CLUSTERS blocks and the ``tiles``
    of lines whose ``layout(cs, tile)`` (threads, bytes) fits a block and of
    which the card runs ``max_clusters(cs, tile)`` at once. Plans whose grid
    is one wave come first; then the least estimated time, the cycles of a
    block's step (``step_cycles(cs, tile, threads)``) times the blocks an SM
    runs at once and the waves; then smaller clusters."""
    best, best_key = None, None
    for cs in CLUSTERS:
        for tile in tiles:
            lay = layout(cs, tile)
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
            key = (waves > 1, waves * load * step_cycles(cs, tile, threads), cs)
            if best_key is None or key < best_key:
                best = ClusterPlan(cs, tile, clusters, at_once, threads, nbytes)
                best_key = key
    if best is None:
        raise ValueError(f"{what} fits on this card")
    return best


def fma_step(lane_fmas: Callable[[int, int], int]) -> Callable[[int, int, int], int]:
    """The step estimate of the FMA recurrences, for :func:`plan_clusters`:
    a block's FMA dispatch on its busiest scheduler (4 per SM; a lane
    issues ``lane_fmas(cs, tile)`` a step) at half rate, plus the cluster's
    exchange and barrier (fitted to the H100's LSTM forward recurrence: 6.5
    us a step for 4 x 12 lines, 10 us for 4 x 20)."""
    return lambda cs, tile, threads: (2 * _cdiv(threads // 32, 4) * lane_fmas(cs, tile)
                                      + 1000 + 800 * cs)


def fused_layout(c: int, hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the fused recurrence
    at widths ``c``, ``hidden`` for the plan (``cs``, ``lines``), as
    ``csrc/gridrnn.cu:fused_plan`` lays it out (the units' gate columns of
    the stacked [W_ih; W_hh], two copies of h, the ring of canvas rows), or
    None if it does not fit a block."""
    if cs not in CLUSTERS or lines not in FUSED_LINES or hidden < 1 or c < 1:
        return None
    uc = _cdiv(hidden, cs)
    wst = 4 * uc + (8 - 4 * uc % 32) % 32
    lbp = lines if (lines // 4) % 2 else lines + 4
    # the lanes of every group of units, and at least a quarter of a staged row's floats
    lanes = 8 * _cdiv(uc, 2) if lines == 8 else 4 * uc
    threads = _cdiv(max(lanes, _cdiv(lines * c, 4)), 32) * 32
    nbytes = 4 * ((KS * c + hidden) * wst + 2 * hidden * lbp + FUSED_RING * c * lbp)
    return (threads, nbytes) if threads <= 256 and nbytes <= SMEM_LIMIT else None


def plan_fused(lines: int, c: int, hidden: int, max_clusters: Callable[[int, int], int],
               what: str = "grid_rnn_seq1_pair") -> ClusterPlan:
    """Kernel 1's plan for ``lines`` lines in each direction (see
    :func:`plan_clusters`): a lane sums an eighth of the 4C + H stacked rows
    for 2 units x 4 gates x tile lines. ``what`` names the caller in the
    error raised when nothing runs (kernel 5 shares the recurrence)."""
    return plan_clusters(lines, 2, FUSED_LINES, lambda cs, tile: fused_layout(c, hidden, cs, tile),
                         max_clusters,
                         fma_step(lambda cs, tile: _cdiv(KS * c + hidden, 8) * 8 * tile),
                         f"{what}: no plan for C={c}, H={hidden}")


@functools.lru_cache(maxsize=1024)
def _card_max_clusters(device_index: int, c: int, hidden: int, cs: int, tile: int,
                       stash: bool = False) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one plan of the
    fused recurrence, serving (kernel 1) or with its stash (kernel 5)."""
    with torch.cuda.device(device_index):
        lib = _build.load("gridrnn", _SIGNATURES, _RESTYPES)
        n = lib.gridrnn_fused_max_clusters(c, hidden, cs, tile, int(stash))
    if n < 0:
        raise RuntimeError(f"fused recurrence: cudaOccupancyMaxActiveClusters failed (CUDA "
                           f"error {-n}) for cs={cs}, lines={tile}, C={c}, H={hidden}, "
                           f"stash={stash}")
    return n


@functools.lru_cache(maxsize=256)
def _card_plan(device_index: int, lines: int, c: int, hidden: int) -> ClusterPlan:
    return plan_fused(lines, c, hidden, lambda cs, tile: _card_max_clusters(
        device_index, c, hidden, cs, tile))


def fused_plan(lines: int, c: int, hidden: int,
               device: Optional[torch.device] = None) -> ClusterPlan:
    """:func:`plan_fused` with the card's counts, each queried once: the plan
    :func:`grid_rnn_seq1_pair` on an fp32 canvas (``lines`` = B * P) and
    :func:`grid_bilstm_fold` launch for this shape."""
    dev = torch.device(device if device is not None else "cuda")
    return _card_plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                      lines, c, hidden)


def fused_smem(c: int, hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count of a block's shared memory for a plan (-1 if
    it does not fit), to hold :func:`fused_layout` to it on the card."""
    lib = _build.load("gridrnn", _SIGNATURES, _RESTYPES)
    return lib.gridrnn_fused_smem(c, hidden, cs, lines)


def mma_layout(c: int, hidden: int, cs: int, lines: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of kernel 1's bf16
    recurrence at widths ``c``, ``hidden`` for the plan (``cs``, ``lines``),
    as ``csrc/gridrnn.cu:mma_plan`` lays it out (the block's gate columns of
    the stacked [W_ih; W_hh] in bf16 over 4C + H rows, H padded to 16; two
    bf16 copies of h; the ring of bf16 canvas rows, a line's C / 8 chunks of
    16 bytes made odd; an mbarrier), or None if it does not fit a block or
    its threads cannot stage a row in MMA_STAGE copies each."""
    if (cs not in CLUSTERS or lines not in MMA_LINES or c < 8 or c % 8 or c > 64
            or not 1 <= hidden <= 128):
        return None
    quads = _cdiv(_cdiv(hidden, cs), 4)
    kh = _cdiv(hidden, 16) * 16
    cch = c // 8 if (c // 8) % 2 else c // 8 + 1
    threads = 32 * _cdiv(quads, MMA_QUADS_PER_WARP)
    nbytes = 2 * (KS * c + kh) * 16 * quads + 4 * kh * lines + 16 * MMA_RING * lines * cch + 16
    fits = (threads <= MMA_MAX_THREADS and nbytes <= SMEM_LIMIT
            and lines * (c // 8) <= MMA_STAGE * threads)
    return (threads, nbytes) if fits else None


def mma_step_cycles(c: int, hidden: int, cs: int, lines: int) -> int:
    """Estimated cycles of one step of one block of kernel 1's bf16
    recurrence: its m16n8k16 products on the busiest of the SM's four
    sub-partitions (a warp's two quads, about 8 cycles a product) or its
    ldmatrix reads of shared memory (512 bytes each at 128 bytes a cycle),
    whichever is longer, plus the step's cell and barrier (an mbarrier at
    CS = 1, the cluster barrier and h's remote writes otherwise)."""
    quads = _cdiv(_cdiv(hidden, cs), 4)
    warps = _cdiv(quads, MMA_QUADS_PER_WARP)
    k_tiles = (KS * c + _cdiv(hidden, 16) * 16) // 16
    mt = lines // 16
    products = _cdiv(warps, 4) * MMA_QUADS_PER_WARP * 2 * mt * k_tiles * 8
    loads = 4 * k_tiles * (quads + warps * mt)
    return max(products, loads) + (400 if cs == 1 else 1000 + 800 * cs)


def plan_mma(lines: int, c: int, hidden: int, max_clusters: Callable[[int, int], int],
             what: str = "grid_rnn_seq1_pair_bf16") -> ClusterPlan:
    """Kernel 1's bf16 plan for ``lines`` lines in each direction (see
    :func:`plan_clusters`), over tiles of MMA_LINES lines, a step estimated
    by :func:`mma_step_cycles`."""
    return plan_clusters(lines, 2, MMA_LINES, lambda cs, tile: mma_layout(c, hidden, cs, tile),
                         max_clusters,
                         lambda cs, tile, threads: mma_step_cycles(c, hidden, cs, tile),
                         f"{what}: no plan for C={c}, H={hidden}")


@functools.lru_cache(maxsize=1024)
def _card_mma_max_clusters(device_index: int, c: int, hidden: int, cs: int, tile: int) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one plan of kernel
    1's bf16 recurrence."""
    with torch.cuda.device(device_index):
        lib = _build.load("gridrnn", _SIGNATURES, _RESTYPES)
        n = lib.gridrnn_mma_max_clusters(c, hidden, cs, tile)
    if n < 0:
        raise RuntimeError(f"bf16 recurrence: cudaOccupancyMaxActiveClusters failed (CUDA "
                           f"error {-n}) for cs={cs}, lines={tile}, C={c}, H={hidden}")
    return n


@functools.lru_cache(maxsize=256)
def _card_mma_plan(device_index: int, lines: int, c: int, hidden: int) -> ClusterPlan:
    return plan_mma(lines, c, hidden, lambda cs, tile: _card_mma_max_clusters(
        device_index, c, hidden, cs, tile))


def mma_plan(lines: int, c: int, hidden: int,
             device: Optional[torch.device] = None) -> ClusterPlan:
    """:func:`plan_mma` with the card's counts, each queried once: the plan
    :func:`grid_rnn_seq1_pair` launches on a bf16 canvas (``lines`` = B * P)."""
    dev = torch.device(device if device is not None else "cuda")
    return _card_mma_plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                          lines, c, hidden)


def mma_smem(c: int, hidden: int, cs: int, lines: int) -> int:
    """The kernel's own count of a block's shared memory for a bf16 plan (-1
    if it does not fit), to hold :func:`mma_layout` to it on the card."""
    lib = _build.load("gridrnn", _SIGNATURES, _RESTYPES)
    return lib.gridrnn_mma_smem(c, hidden, cs, lines)


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step from pre-activations ``[N, 4H]`` (gate order i, f, g, o)
    and the fp32 cell state; returns ``(h, c)``."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even, as the kernels and
    ``astype(bfloat16)`` round) and held in fp32: an operand of the bf16
    forms' plain versions, which multiply in fp32."""
    return t.to(torch.bfloat16).float()


def lstm_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
               reverse: bool = False, round_h: bool = False) -> torch.Tensor:
    """One LSTM direction over axis 0 of ``x [S, B, D]`` -> ``[S, B, H]``,
    with ``w_ih [D, 4H]``, ``w_hh [H, 4H]``, ``bias [4H]``; ``reverse`` runs
    it back to front and keeps the outputs in time order. ``round_h`` rounds
    each h to bf16 before it enters the next product and the outputs (the
    bf16 forms' recurrence; the cell state stays fp32)."""
    s, b, _ = x.shape
    xp = x @ w_ih + bias
    h = x.new_zeros(b, w_hh.shape[0])
    c = torch.zeros_like(h, dtype=torch.float32)
    ys = [None] * s
    for t in (range(s - 1, -1, -1) if reverse else range(s)):
        h, c = _lstm_cell(xp[t] + h @ w_hh, c)
        if round_h:
            h = round_bf16(h)
        ys[t] = h
    return torch.stack(ys)


def bilstm_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                 bias: torch.Tensor, round_h: bool = False) -> torch.Tensor:
    """Bidirectional LSTM over axis 1 of ``x [N, S, D]`` -> ``[N, S, 2H]``
    (forward ++ backward), with the JAX packing ``w_ih [2, D, 4H]``,
    ``w_hh [2, H, 4H]``, ``bias [2, 4H]`` (direction 1 runs reversed)."""
    xs = x.transpose(0, 1)
    outs = [lstm_plain(xs, w_ih[z], w_hh[z], bias[z], reverse=z == 1, round_h=round_h)
            for z in (0, 1)]
    return torch.cat(outs, dim=-1).transpose(0, 1)


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
    unfold -> BiLSTM -> deconv -> fold pipeline, exact on every row. On a
    bf16 canvas it is the plain version of the bf16 form: the canvas widened
    to fp32, w_ih, w_hh and wd rounded to bf16, h rounded before each
    product, fp32 products and fold, the outputs rounded to bf16."""
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, w_ih, w_hh, wd = x.float(), round_bf16(w_ih), round_bf16(w_hh), round_bf16(wd)
    b, s, p, c = x.shape
    hidden = w_hh.shape[1]
    length = s - (KS - 1)
    lines = x.permute(0, 2, 1, 3).reshape(b * p, s, c)
    win = torch.cat([lines[:, j:j + length] for j in range(KS)], dim=-1)
    h = bilstm_plain(win, w_ih, w_hh, bias, round_h=bf16)
    outs = []
    for half, rows in ((h[..., :hidden], wd[:hidden]), (h[..., hidden:], wd[hidden:])):
        folded = _fold(half @ rows, c)
        out = folded.reshape(b, p, s, c).permute(0, 2, 1, 3).contiguous()
        outs.append(out.to(torch.bfloat16) if bf16 else out)
    return outs[0], outs[1]


def grid_bilstm_fold_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                           bias: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_bilstm_fold`: a sequence-major
    ``[S, lines, C]`` array is the canvas with B = 1 and P = lines."""
    outf, outb = grid_rnn_seq1_pair_plain(x[None], w_ih, w_hh, bias, wd)
    return (outf + outb)[0]


def check_tensor(fn: str, name: str, t: torch.Tensor, shape, device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what the kernels of this module take."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on {device} "
                         f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_rnn_args(fn: str, x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   bias: torch.Tensor, wd: torch.Tensor,
                   x_dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> Tuple[int, int]:
    """Validate the RNN path's arguments on a CUDA device; ``x`` is
    ``[..., S, P, C]`` of one of ``x_dtypes``, the weights fp32. Returns
    ``(C, H)``."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() < 3 or w_hh.dim() != 3:
        raise ValueError(f"{fn}: x must be [..., S, P, C] and w_hh [2, H, 4H]")
    s, c, hidden = x.shape[-3], x.shape[-1], w_hh.shape[1]
    if s - (KS - 1) < 1 or c % 8 or c > 64 or hidden > 128:
        raise ValueError(f"{fn}: shape S={s}, C={c}, H={hidden} is outside the kernel's "
                         "range (S >= 4, C % 8 == 0, C <= 64, H <= 128)")
    dev = x.device
    if x.dtype not in x_dtypes:
        raise ValueError(f"{fn}: x must be one of {x_dtypes}, got {x.dtype}")
    check_tensor(fn, "x", x, x.shape, dev, x.dtype)
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
      ``(outf, outb)``, each ``[B, S, P, C]`` in x's dtype (fp32 or bf16)
      without the deconv bias; the model reads rows [3, L-1] (L = S-3), the
      rows the JAX kernel makes exact. The CUDA kernels need C % 8 == 0,
      C <= 64 and H <= 128, the gate the model applies before it calls here.
      They have no backward: on a CUDA tensor this raises if an input
      requires grad. A bf16 canvas launches the bf16 form (fp32 weights,
      rounded in the kernel; its recurrence on the tensor cores at
      :func:`mma_plan`'s plan, which raises where no plan fits) and counts
      on ``launches_bf16``.
    """
    if x.device.type == "cpu":
        return grid_rnn_seq1_pair_plain(x, w_ih, w_hh, bias, wd)
    if x.dim() != 4:
        raise ValueError("grid_rnn_seq1_pair: x must be [B, S, P, C]")
    c, hidden = check_rnn_args("grid_rnn_seq1_pair", x, w_ih, w_hh, bias, wd,
                               (torch.float32, torch.bfloat16))
    _build.refuse_grad("grid_rnn_seq1_pair", x, w_ih, w_hh, bias, wd)
    bf16 = x.dtype == torch.bfloat16
    b, s, p, _ = x.shape
    length = s - (KS - 1)
    dev = x.device
    if bf16 and x.data_ptr() % 16:
        raise ValueError("grid_rnn_seq1_pair: a bf16 canvas must start on a 16-byte boundary")
    cs, tile = (mma_plan if bf16 else fused_plan)(b * p, c, hidden, dev)[:2]
    with torch.cuda.device(dev):
        hs = torch.empty((2, b * p, length, hidden), device=dev, dtype=x.dtype)
        outf = torch.empty_like(x)
        outb = torch.empty_like(x)
        lib = _build.load("gridrnn", _SIGNATURES, _RESTYPES)
        entry = lib.gridrnn_seq1_pair_bf16 if bf16 else lib.gridrnn_seq1_pair
        code = entry(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), wd.data_ptr(),
            hs.data_ptr(), outf.data_ptr(), outb.data_ptr(), b, s, p, c, hidden, cs, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"grid_rnn_seq1_pair{'_bf16' if bf16 else ''} (plan cs={cs}, "
                 f"lines={tile})")
    if bf16:
        grid_rnn_seq1_pair.launches_bf16 += 1
    else:
        grid_rnn_seq1_pair.launches += 1
    return outf, outb


grid_rnn_seq1_pair.launches = 0
grid_rnn_seq1_pair.launches_bf16 = 0


def grid_bilstm_fold(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                     bias: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Fused unfold(k=4) -> BiLSTM -> deconv(k=4) -> overlap-add on
    sequence-major lines, both directions summed.

    Args:
      x: ``[S, lines, C]`` (already LayerNorm'd and padded by the caller);
      w_ih, w_hh, bias, wd: as :func:`grid_rnn_seq1_pair`.

    Returns:
      ``[S, lines, C]`` without the deconv bias, exact on every row (the
      JAX kernel on rows [3, L-1]). On a CUDA tensor it runs kernel 1's
      fused recurrence on the lines as a canvas with B = 1, P = lines, at
      :func:`fused_plan`'s plan, and one fold summing both directions.
      Forward only: on a CUDA tensor this raises if an input requires
      grad; the differentiable twin is
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
    cs, tile = fused_plan(lines, c, hidden, dev)[:2]
    with torch.cuda.device(dev):
        hs = torch.empty((2, lines, length, hidden), device=dev, dtype=torch.float32)
        out = torch.empty_like(x)
        lib = _build.load("gridrnn", _FOLD_SIGNATURES)
        code = lib.grid_bilstm_fold(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), wd.data_ptr(),
            hs.data_ptr(), out.data_ptr(), s, lines, c, hidden, cs, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"grid_bilstm_fold (plan cs={cs}, lines={tile})")
    grid_bilstm_fold.launches += 1
    return out


grid_bilstm_fold.launches = 0
