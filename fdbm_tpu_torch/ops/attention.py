"""Frame attention of TF-GridNet and the PReLU + group norm that feeds it.

Port of ``fdbm_tpu/ops/attention.py:flat_group_norm`` and
``:frame_attention``. On a CUDA tensor each wrapper launches its
hand-written kernels from ``csrc/attention.cu``; on a CPU tensor it runs
its plain PyTorch version (``*_plain`` below). The source note of
``csrc/attention.cu`` says what bounds them on the H100 and how they are
laid out. The norms of one attention call's q, k and v are one launch
(:func:`flat_group_norms`), the attention one more; its plan (query rows per
block, blocks per cluster) comes from :func:`attention_plan`, which also
sets its limit on the number of frames T: an 8-row score tile of T floats
per row must fit in a block's shared memory (about 5180 frames at Q=257;
the serving path cuts files at 30 s, about 1900 frames).

Both wrappers also take bf16 maps (``inference_dtype: bfloat16``) and then
launch their kernels' bf16 forms, the JAX kernels' bf16 paths
(``fdbm_tpu/ops/attention.py:199,229,351-353``): the norm reads and writes
bf16 with fp32 statistics and parameters; the attention reads bf16 q, k, v
and writes bf16, with fp32 score sums and softmax and P rounded to bf16
before the value product (fp32 sums), both products on the tensor cores
(``attn_mma_kernel``; its plan from :func:`attention_mma_plan`, which
mirrors the kernel's shared-memory layout in :func:`attention_mma_layout`).
Their plain versions are the same functions on bf16 tensors, the operands
widened to fp32 and P rounded with ``.to(torch.bfloat16)``. The two forms
count their launches apart (``launches``, ``launches_bf16``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from fdbm_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flat_group_norm_segments": [_P, _I, _I, _P],
    "flat_group_norm_segments_bf16": [_P, _I, _I, _P],
    "frame_attention": [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
    "frame_attention_bf16": [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
    "frame_attention_smem": [_I] * 6,
    "frame_attention_max_clusters": [_I] * 6,
    "frame_attention_mma_smem": [_I] * 6,
    "frame_attention_mma_threads": [_I] * 6,
    "frame_attention_mma_max_clusters": [_I] * 6,
}
_RESTYPES = {"frame_attention_smem": ctypes.c_longlong,
             "frame_attention_mma_smem": ctypes.c_longlong}
_EPS = 1e-5

NormParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# One map of flat_group_norms: (x, alpha, gamma, beta, width).
NormMap = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]
_WIDTHS = (1, 2, 4, 8, 16, 32, 64)
_MAX_MAPS = 3  # csrc/attention.cu: GN_MAX_SEGS
_IO_DTYPES = (torch.float32, torch.bfloat16)


# The attention kernel's layout constants (csrc/attention.cu: AT_*) and the
# card's: a block's shared memory and the SMs.
SMEM_LIMIT, SMS = 232448, 132
_RM, _UT, _KCP, _DS_MAX, _RING, _NT_MIN, _NT_MAX = 8, 32, 132, 16, 98304, 128, 512
_STAGES = ((3, 4), (3, 3), (2, 3), (2, 2))  # (key ring, V ring), deepest first
_PLAN_ROWS = tuple(range(_RM, 65, _RM))
_PLAN_SLICES = (1, 2, 3, 4)


class AttentionPlan(NamedTuple):
    """How :func:`frame_attention` cuts one call: ``rows`` query rows per
    block (TR), ``slices`` blocks per cluster, each taking one slice of the
    value width (NS), ``threads`` per block, ``smem_bytes`` of shared memory
    per block, ``blocks`` in the grid, and ``max_clusters``, the clusters
    of this plan the card runs at once."""
    rows: int
    slices: int
    threads: int
    smem_bytes: int
    blocks: int
    max_clusters: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attention_layout(t_len: int, q_bins: int, e_dim: int, d_dim: int, rows: int,
                     slices: int) -> Optional[Tuple[int, int]]:
    """``(threads, shared-memory bytes)`` of a block of the plan (``rows``,
    ``slices``), as ``csrc/attention.cu:attn_plan`` lays it out, or None if
    it does not fit a block."""
    if rows % _RM or not _RM <= rows <= 64 or not 1 <= slices <= 8 or t_len < 1:
        return None
    rg = rows // _RM
    cols = _cdiv(_cdiv(q_bins * d_dim, slices), 8) * 8
    want = max(rg * (cols // 8), rg * (_UT // 4) * 4)
    threads = min(_NT_MAX, max(_NT_MIN, _cdiv(want, 32) * 32))
    tcp = threads // rg
    ds = min(_DS_MAX, max(1, threads // (rg * (_UT // 4))))
    for nks, nvs in _STAGES:
        uk = min(8, max(1, _RING // (nvs * tcp * 8 * 4)))
        t_pad = _cdiv(t_len, uk) * uk
        region = max(q_bins * e_dim * rows + nks * _UT * _KCP + ds * rows * _UT,
                     nvs * uk * tcp * 8, threads + 2 * rows)
        nbytes = 4 * (t_pad * rows + region)
        if nbytes <= SMEM_LIMIT:
            return threads, nbytes
    return None


def attention_max_frames(q_bins: int, e_dim: int, d_dim: int) -> int:
    """The most frames any plan takes: the T at which an 8-row score tile
    still fits beside the rest of the block's shared memory."""
    best = 0
    for slices in _PLAN_SLICES:
        lo, hi = 0, 1 << 20
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if attention_layout(mid, q_bins, e_dim, d_dim, _RM, slices) is None:
                hi = mid - 1
            else:
                lo = mid
        best = max(best, lo)
    return best


def _sectors(width: int, n_head: int) -> float:
    """32-byte sectors one head's ``width`` lanes of one (frame, bin) touch,
    averaged over the heads: the heads' lanes share each bin's sectors."""
    nbytes = 4 * width
    return sum((h * nbytes + nbytes - 1) // 32 - (h * nbytes) // 32 + 1
               for h in range(n_head)) / n_head


def attention_plan(batch: int, t_len: int, q_bins: int, n_head: int, e_dim: int, d_dim: int,
                   max_clusters: Optional[Callable[[int, int], int]] = None) -> AttentionPlan:
    """The plan of one :func:`frame_attention` call. ``max_clusters(rows,
    slices)`` is the card's count of clusters of that plan that run at once
    (the wrapper asks the card; by default every SM takes one block). Among
    the plans that fit (rows a multiple of 8 up to 64, 1-4 slices), those
    whose grid is one wave come first; then the least estimated time, in
    cycles of one SM, times the blocks it runs at once: its FMAs at 58 a
    cycle plus 2 cycles for each 32-byte sector it loads (a head's lanes
    share their sectors with the other heads', so loads cost by sector, not
    by byte). Both rates were fitted to the H100 at the main-path shape.
    Raises ValueError above :func:`attention_max_frames`."""
    if max_clusters is None:
        max_clusters = lambda rows, slices: SMS // slices
    sec_e, sec_d = _sectors(e_dim, n_head), _sectors(d_dim, n_head)
    best, best_key = None, None
    for rows in _PLAN_ROWS:
        for slices in _PLAN_SLICES:
            lay = attention_layout(t_len, q_bins, e_dim, d_dim, rows, slices)
            if lay is None:
                continue
            at_once = max_clusters(rows, slices)
            if at_once < 1:
                continue
            threads, nbytes = lay
            clusters = batch * n_head * _cdiv(t_len, rows)
            waves = _cdiv(clusters, at_once)
            # Blocks an SM holds at once, and the SMs the clusters spread over.
            per_sm = _cdiv(at_once * slices, SMS)
            load = _cdiv(min(clusters, at_once) * slices * per_sm, at_once * slices)
            keys = _cdiv(t_len, slices)
            cols = _cdiv(_cdiv(q_bins * d_dim, slices), 8) * 8
            fma = rows * (keys * q_bins * e_dim + t_len * cols)
            sectors = (keys + rows) * q_bins * sec_e + t_len * (cols / d_dim) * sec_d
            cost = waves * load * (fma / 58 + 2 * sectors)
            key = (waves > 1, cost, slices, -rows)
            if best_key is None or key < best_key:
                best_key = key
                best = AttentionPlan(rows, slices, threads, nbytes, clusters * slices, at_once)
    if best is None:
        raise ValueError(
            f"frame_attention: T={t_len} frames is above the kernel's limit of "
            f"{attention_max_frames(q_bins, e_dim, d_dim)} at Q={q_bins}, E={e_dim}, "
            f"D={d_dim}: an 8-row score tile no longer fits in a block's shared memory")
    return best


# The bf16 attention on the tensor cores (csrc/attention.cu: attn_mma_plan):
# blocks of 16 MT query rows (MT m16 tiles), clusters of 1, 2, 4 or 8, V
# stages of 32 keys, K chunks of at most 80 keys, 4-16 warps.
MMA_ROW_TILES = (1, 2, 3, 4)
MMA_SLICES = (1, 2, 4, 8)
_AM_VK, _AM_KC_MAX, _AM_MIN_WARPS, _AM_MAX_WARPS = 32, 80, 4, 16


class AttentionMmaLayout(NamedTuple):
    """A block of the bf16 plan (MT, NS) as ``attn_mma_plan`` lays it out:
    ``threads``, ``smem_bytes``; each rank's ``rank_keys`` keys (the last
    rank's fewer), taken in chunks of ``key_chunk``; each rank's
    ``rank_bins`` bins of the value width in ``passes`` passes of
    ``pass_bins``, through ``v_stages`` V stages."""
    threads: int
    smem_bytes: int
    rank_keys: int
    key_chunk: int
    rank_bins: int
    pass_bins: int
    passes: int
    v_stages: int


def _mma_npw(mt: int) -> int:
    """n8 tiles of the value slice a warp holds (csrc/attention.cu: am_npw)."""
    return 8 if mt <= 2 else (6 if mt == 3 else 5)


def attention_mma_layout(t_len: int, q_bins: int, e_dim: int, d_dim: int, mt: int,
                         slices: int) -> Optional[AttentionMmaLayout]:
    """The block of the bf16 plan (``mt`` m16 tiles of query rows,
    ``slices`` blocks a cluster), as ``csrc/attention.cu:attn_mma_plan``
    lays it out: the fp32 scores [16 mt][T rounded to 32, + 8]; then, in the
    score phase, the query tile and a key chunk head-major in bf16 (rows of
    the Q*E depth rounded to 16, + 8 lanes) and the depth split's partial
    sums, or, in the value phase, P in bf16 [16 mt][T rounded to 32, + 8]
    and 3 (else 2) V stages of 32 keys x the pass's columns. None if it does
    not fit a block."""
    if (mt not in MMA_ROW_TILES or slices not in MMA_SLICES or min(t_len, q_bins, e_dim,
                                                                   d_dim) < 1):
        return None
    tr = 16 * mt
    qes = 16 * _cdiv(q_bins * e_dim, 16) + 8
    kr = 2 * _cdiv(_cdiv(t_len, slices), 2)
    kc = min(16 * _cdiv(kr, 16), _AM_KC_MAX)
    t32 = 32 * _cdiv(t_len, 32)
    l8 = 8 // math.gcd(8, d_dim) * d_dim
    ub = l8 // d_dim
    br = ub * _cdiv(_cdiv(q_bins, slices), ub)
    npw = _mma_npw(mt)
    nw = min(_AM_MAX_WARPS, max(_AM_MIN_WARPS, _cdiv(br * d_dim // 8, npw)))
    items = mt * (kc // 16)
    ksplit = max(1, nw // items)
    score = 2 * (tr + kc) * qes + (4 * ksplit * tr * kc if ksplit > 1 else 0)
    # the widest pass the warps hold, halved in whole units while the V ring
    # does not fit beside P
    bp = min(br, nw * npw * 8 // l8 * ub)
    while bp >= ub:
        pt = bp * d_dim // 8
        vst = 8 * pt + (0 if pt % 2 else 8)
        for nvs in (3, 2):
            nbytes = 4 * tr * (t32 + 8) + max(score, 2 * tr * (t32 + 8) + 2 * nvs * _AM_VK * vst)
            if nbytes <= SMEM_LIMIT:
                return AttentionMmaLayout(32 * nw, nbytes, kr, kc, br, bp, _cdiv(br, bp), nvs)
        if bp == ub:
            break
        bp = max(ub, bp // 2 // ub * ub)
    return None


def attention_mma_max_frames(q_bins: int, e_dim: int, d_dim: int) -> int:
    """The most frames any bf16 plan takes: the T at which a 16-row score
    tile still fits beside the rest of the block's shared memory."""
    best = 0
    for slices in MMA_SLICES:
        lo, hi = 0, 1 << 16
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if attention_mma_layout(mid, q_bins, e_dim, d_dim, 1, slices) is None:
                hi = mid - 1
            else:
                lo = mid
        best = max(best, lo)
    return best


def _copy_bytes(width: int) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that divides a run of ``width``
    bf16 lanes (csrc/attention.cu: copy_bytes)."""
    nb = 2 * width
    return next(c for c in (16, 8, 4, 2) if nb % c == 0)


def attention_mma_block_cycles(t_len: int, q_bins: int, e_dim: int, d_dim: int, mt: int,
                               slices: int, lay: AttentionMmaLayout) -> float:
    """Estimated cycles of one block of the bf16 plan on its SM: about 8 a
    m16n8k16 product (a block's products are a chain of dependent
    fragments, not the tensor cores' rate), one a staging copy (the head's
    lanes are copied 2E or 2D bytes at a time) and 6000 a block of its
    cluster (the scores written to every block, the cluster's barriers).
    Fitted to the H100's times of every plan at the main path's shapes (B=1
    and B=16; PERF.md §6)."""
    score = mt * 2 * _cdiv(lay.rank_keys, 16) * _cdiv(q_bins * e_dim, 16)
    value = mt * _cdiv(lay.rank_bins * d_dim, 8) * _cdiv(t_len, 16)
    copies = ((16 * mt + lay.rank_keys) * q_bins * (2 * e_dim // _copy_bytes(e_dim))
              + t_len * lay.rank_bins * (2 * d_dim // _copy_bytes(d_dim)))
    return 8 * (score + value) + copies + 6000 * slices


def attention_mma_plan(batch: int, t_len: int, q_bins: int, n_head: int, e_dim: int,
                       d_dim: int, max_clusters: Optional[Callable[[int, int], int]] = None
                       ) -> AttentionPlan:
    """The plan of one bf16 :func:`frame_attention` call (``rows`` = 16 MT).
    ``max_clusters(rows, slices)`` is the card's count of clusters of that
    plan at once (by default every SM takes one block). Among the plans that
    fit, those whose grid is one wave come first, then the least estimated
    time: :func:`attention_mma_block_cycles` times the blocks an SM runs at
    once and the waves. Raises ValueError above
    :func:`attention_mma_max_frames`."""
    if max_clusters is None:
        max_clusters = lambda rows, slices: SMS // slices
    best, best_key = None, None
    for mt in MMA_ROW_TILES:
        for slices in MMA_SLICES:
            lay = attention_mma_layout(t_len, q_bins, e_dim, d_dim, mt, slices)
            if lay is None:
                continue
            at_once = max_clusters(16 * mt, slices)
            if at_once < 1:
                continue
            clusters = batch * n_head * _cdiv(t_len, 16 * mt)
            waves = _cdiv(clusters, at_once)
            per_sm = _cdiv(at_once * slices, SMS)
            load = _cdiv(min(clusters, at_once) * slices * per_sm, at_once * slices)
            cost = waves * load * attention_mma_block_cycles(t_len, q_bins, e_dim, d_dim, mt,
                                                             slices, lay)
            key = (waves > 1, cost, slices, -mt)
            if best_key is None or key < best_key:
                best_key = key
                best = AttentionPlan(16 * mt, slices, lay.threads, lay.smem_bytes,
                                     clusters * slices, at_once)
    if best is None:
        raise ValueError(
            f"frame_attention (bf16): T={t_len} frames is above the kernel's limit of "
            f"{attention_mma_max_frames(q_bins, e_dim, d_dim)} at Q={q_bins}, E={e_dim}, "
            f"D={d_dim}: a 16-row score tile no longer fits in a block's shared memory")
    return best


@functools.lru_cache(maxsize=4096)
def _card_mma_max_clusters(device_index: int, t_len: int, q_bins: int, e_dim: int, d_dim: int,
                           rows: int, slices: int) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one bf16 plan."""
    with torch.cuda.device(device_index):
        lib = _build.load("attention", _SIGNATURES, _RESTYPES)
        n = lib.frame_attention_mma_max_clusters(t_len, q_bins, e_dim, d_dim, rows // 16, slices)
    if n < 0:
        raise RuntimeError(f"frame_attention (bf16): cudaOccupancyMaxActiveClusters failed "
                           f"(CUDA error {-n}) for rows={rows}, slices={slices}")
    return n


@functools.lru_cache(maxsize=256)
def _card_mma_plan(device_index: int, batch: int, t_len: int, q_bins: int, n_head: int,
                   e_dim: int, d_dim: int) -> AttentionPlan:
    return attention_mma_plan(batch, t_len, q_bins, n_head, e_dim, d_dim,
                              lambda rows, slices: _card_mma_max_clusters(
                                  device_index, t_len, q_bins, e_dim, d_dim, rows, slices))


def card_attention_mma_plan(batch: int, t_len: int, q_bins: int, n_head: int, e_dim: int,
                            d_dim: int, device: Optional[torch.device] = None) -> AttentionPlan:
    """:func:`attention_mma_plan` with the card's counts, each queried once:
    the plan :func:`frame_attention` launches on bf16 maps."""
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _card_mma_plan(index, batch, t_len, q_bins, n_head, e_dim, d_dim)


def frame_attention_mma_smem(t_len: int, q_bins: int, e_dim: int, d_dim: int, mt: int,
                             slices: int) -> Tuple[int, int]:
    """The kernel's own ``(threads, shared-memory bytes)`` of a bf16 plan
    (-1, -1 if it does not fit), to hold :func:`attention_mma_layout` to it
    on the card."""
    lib = _build.load("attention", _SIGNATURES, _RESTYPES)
    return (lib.frame_attention_mma_threads(t_len, q_bins, e_dim, d_dim, mt, slices),
            lib.frame_attention_mma_smem(t_len, q_bins, e_dim, d_dim, mt, slices))


def launch_frame_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                n_head: int, e_dim: int, rows: int, slices: int
                                ) -> torch.Tensor:
    """The bf16 kernel at the plan (``rows`` query rows a block, ``slices``
    blocks a cluster) on checked bf16 maps: the launch :func:`frame_attention`
    makes, also used to time or test every plan. Counts nothing."""
    b, t_len, q_bins, _ = q.shape
    d_dim = v.shape[-1] // n_head
    dev = q.device
    with torch.cuda.device(dev):
        out = torch.empty_like(v)
        lib = _build.load("attention", _SIGNATURES, _RESTYPES)
        code = lib.frame_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t_len, q_bins, n_head,
            e_dim, d_dim, 1.0 / math.sqrt(e_dim * q_bins), rows // 16, slices,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"frame_attention_bf16 (plan rows={rows}, slices={slices})")
    return out


@functools.lru_cache(maxsize=4096)
def _card_max_clusters(device_index: int, t_len: int, q_bins: int, e_dim: int, d_dim: int,
                       rows: int, slices: int) -> int:
    """The card's ``cudaOccupancyMaxActiveClusters`` for one plan."""
    with torch.cuda.device(device_index):
        lib = _build.load("attention", _SIGNATURES, _RESTYPES)
        n = lib.frame_attention_max_clusters(t_len, q_bins, e_dim, d_dim, rows, slices)
    if n < 0:
        raise RuntimeError(f"frame_attention: cudaOccupancyMaxActiveClusters failed "
                           f"(CUDA error {-n}) for rows={rows}, slices={slices}")
    return n


@functools.lru_cache(maxsize=256)
def _card_plan(device_index: int, batch: int, t_len: int, q_bins: int, n_head: int, e_dim: int,
               d_dim: int) -> AttentionPlan:
    return attention_plan(batch, t_len, q_bins, n_head, e_dim, d_dim,
                          lambda rows, slices: _card_max_clusters(
                              device_index, t_len, q_bins, e_dim, d_dim, rows, slices))


def card_attention_plan(batch: int, t_len: int, q_bins: int, n_head: int, e_dim: int,
                        d_dim: int, device: Optional[torch.device] = None) -> AttentionPlan:
    """:func:`attention_plan` with the card's counts of clusters at once,
    each queried once: the plan :func:`frame_attention` launches."""
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _card_plan(index, batch, t_len, q_bins, n_head, e_dim, d_dim)


def flat_group_norm_plain(x: torch.Tensor, alpha: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`flat_group_norm`; a bf16 map is
    widened to fp32 and the result rounded back to bf16."""
    n_head = gamma.shape[0]
    shape = x.shape
    xs = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(*shape[:-1], -1, n_head, width)
    xs = torch.where(xs >= 0, xs, alpha.reshape(n_head, 1) * xs)
    mu = xs.mean(dim=-1, keepdim=True)
    xc = xs - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + _EPS) * gamma + beta
    return out.reshape(shape).to(x.dtype)


def _check(fn: str, name: str, t: torch.Tensor, device, shape=None,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on "
                         f"{device} (got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_norm_map(fn: str, x, alpha, gamma, beta, width: int, n_head: int, dev,
                    io_dtype: torch.dtype) -> None:
    if width not in _WIDTHS or x.shape[-1] % (n_head * width):
        raise ValueError(f"{fn}: width {width} must be a power of two <= 64 and divide "
                         f"the lanes {x.shape[-1]} in groups of {n_head} heads")
    _check(fn, "x", x, dev, dtype=io_dtype)
    _check(fn, "alpha", alpha, dev, (n_head, 1))
    _check(fn, "gamma", gamma, dev, (n_head, width))
    _check(fn, "beta", beta, dev, (n_head, width))


def flat_group_norm(x: torch.Tensor, alpha: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, width: int) -> torch.Tensor:
    """PReLU + per-group affine norm on a flat ``[B, T, L]`` feature map.

    L = Q*H*width: the lanes of each frame are Q runs of H groups of
    ``width`` lanes (head-minor). Statistics over each group's lanes, fp32,
    biased two-pass variance, eps 1e-5 inside the root; ``alpha`` ``[H, 1]``
    is the per-head PReLU slope and ``gamma``/``beta`` ``[H, width]`` the
    affine parameters, as ``_AllHeadPReLULayerNorm`` holds them. ``width``
    must be a power of two up to 64. :func:`flat_group_norms` with one map:
    on a CUDA tensor one launch, which has no backward (this raises if an
    input requires grad). A bf16 map launches the bf16 form (fp32
    parameters) and gives a bf16 map.
    """
    return flat_group_norms([(x, alpha, gamma, beta, width)])[0]


flat_group_norm.launches = 0
flat_group_norm.launches_bf16 = 0


def flat_group_norms_plain(maps: Sequence[NormMap]) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`flat_group_norms`: one
    :func:`flat_group_norm_plain` a map."""
    return [flat_group_norm_plain(x, alpha, gamma, beta, width)
            for x, alpha, gamma, beta, width in maps]


def flat_group_norms(maps: Sequence[NormMap]) -> List[torch.Tensor]:
    """:func:`flat_group_norm` of up to three maps in one launch: the q, k
    and v of one attention call, each ``(x, alpha, gamma, beta, width)``
    with the same number of heads H and its own width; ``x`` may keep its
    own shape (``[B, T, Q, H*width]``), as only its last axis, a multiple
    of H*width, and its layout matter. The maps are all fp32 or all bf16
    (the bf16 form); the parameters are fp32. The launch counts once on
    ``flat_group_norm.launches`` (``launches_bf16`` for bf16 maps). On CPU
    tensors the plain version, one map at a time.

    This wrapper runs before every attention call of the serving path, and
    its host work costs more than the kernel (about 6 us on the H100 for
    the main path's three maps), so the checks are one pass over the
    twelve tensors; only a failing call pays for naming the culprit."""
    x0 = maps[0][0]
    if x0.device.type == "cpu":
        return flat_group_norms_plain(maps)
    if x0.device.type != "cuda":
        raise ValueError(f"flat_group_norms: unsupported device {x0.device}")
    dev = x0.device
    if not 1 <= len(maps) <= _MAX_MAPS:
        raise ValueError(f"flat_group_norms: 1 to {_MAX_MAPS} maps, got {len(maps)}")
    n_head = maps[0][2].shape[0]
    io_dtype = x0.dtype
    tensors = [t for m in maps for t in m[:4]]
    _build.refuse_grad("flat_group_norms", *tensors)
    if io_dtype not in _IO_DTYPES:
        raise ValueError(f"flat_group_norms: maps must be float32 or bfloat16, got {io_dtype}")
    if any(w not in _WIDTHS or x.shape[-1] % (n_head * w) or a.shape != (n_head, 1)
           or g.shape != (n_head, w) or b.shape != (n_head, w) for x, a, g, b, w in maps) or \
            any(t.device != dev or t.dtype != (io_dtype if i % 4 == 0 else torch.float32)
                or not t.is_contiguous() or t.data_ptr() % 16 for i, t in enumerate(tensors)):
        for m in maps:
            _check_norm_map("flat_group_norms", *m, n_head, dev, io_dtype)
    with torch.cuda.device(dev):
        outs = [torch.empty_like(m[0]) for m in maps]
        desc = []
        for (x, alpha, gamma, beta, width), out in zip(maps, outs):
            desc += (x.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     out.data_ptr(), x.numel(), width)
        lib = _build.load("attention", _SIGNATURES, _RESTYPES)
        bf16 = io_dtype == torch.bfloat16
        entry = lib.flat_group_norm_segments_bf16 if bf16 else lib.flat_group_norm_segments
        code = entry((ctypes.c_longlong * len(desc))(*desc), len(maps), n_head,
                     torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(code, "flat_group_norms" + ("_bf16" if bf16 else ""))
    if bf16:
        flat_group_norm.launches_bf16 += 1
    else:
        flat_group_norm.launches += 1
    return outs


def _normed(q, k, v, n_head, e_dim, norms, norm_fn):
    """q, k, v through ``norm_fn`` (:func:`flat_group_norms` or its plain
    version) in their own shapes."""
    widths = (e_dim, e_dim, v.shape[-1] // n_head)
    return tuple(norm_fn([(a, *p, w) for a, p, w in zip((q, k, v), norms, widths)]))


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_head: int, e_dim: int,
                          norms: Optional[Sequence[NormParams]] = None,
                          widen: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`frame_attention`. On bf16 maps it is
    the plain version of the bf16 form: q, k, v widened to fp32, the scores
    and softmax in fp32, P rounded to bf16, the value product in fp32 and
    the result rounded to bf16. ``widen=False`` keeps both products in the
    maps' dtype, only the softmax in fp32: the training route's attention,
    as the JAX package trains it on XLA ops
    (``fdbm_tpu/models/tfgridnet.py:373-394``)."""
    if norms is not None:
        q, k, v = _normed(q, k, v, n_head, e_dim, norms, flat_group_norms_plain)
    io_dtype = v.dtype
    wide = torch.promote_types(io_dtype, torch.float32) if widen else io_dtype
    b, t_len, q_bins, _ = q.shape
    d_dim = v.shape[-1] // n_head
    q5 = q.to(wide).reshape(b, t_len, q_bins, n_head, e_dim)
    k5 = k.to(wide).reshape(b, t_len, q_bins, n_head, e_dim)
    v5 = v.to(wide).reshape(b, t_len, q_bins, n_head, d_dim)
    scores = torch.einsum("btqhe,buqhe->bhtu", q5, k5) * (1.0 / math.sqrt(e_dim * q_bins))
    attn = torch.softmax(scores.float(), dim=-1).to(io_dtype).to(wide)
    out = torch.einsum("bhtu,buqhd->btqhd", attn, v5)
    return out.reshape(b, t_len, q_bins, n_head * d_dim).to(io_dtype)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int, e_dim: int,
                    norms: Optional[Sequence[NormParams]] = None) -> torch.Tensor:
    """Multi-head full-band attention over frames on head-minor layouts.

    Args:
      q, k: ``[B, T, Q, H*E]``; v: ``[B, T, Q, H*D]``.
      n_head: H; e_dim: E. Scale 1/sqrt(E*Q).
      norms: optional ``((alpha, gamma, beta),) * 3`` for q, k, v. When
        given, q, k, v are the raw projector outputs and
        :func:`flat_group_norms` applies PReLU + per-head norm to the three
        first, in one launch.

    Returns:
      ``[B, T, Q, H*D]``: per head softmax(Q K^T * scale) V, channels
      merged h-slow, d-fast, in the maps' dtype. One kernel launch (and
      one for the norms); no ``[B, H, T, T]`` scores exist in device
      memory. The kernel has no backward: on a CUDA tensor this raises if
      an input requires grad. bf16 maps launch the bf16 form and count on
      ``launches_bf16``.
    """
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v, n_head, e_dim, norms)
    if q.device.type != "cuda":
        raise ValueError(f"frame_attention: unsupported device {q.device}")
    _build.refuse_grad("frame_attention", q, k, v, *(t for p in norms or () for t in p))
    if norms is not None:
        q, k, v = _normed(q, k, v, n_head, e_dim, norms, flat_group_norms)
    b, t_len, q_bins, he = q.shape
    hd = v.shape[-1]
    if he != n_head * e_dim or hd % n_head:
        raise ValueError(f"frame_attention: lanes {he}/{hd} do not split into "
                         f"{n_head} heads of E={e_dim}")
    d_dim = hd // n_head
    dev = q.device
    io_dtype = q.dtype
    if io_dtype not in _IO_DTYPES:
        raise ValueError(f"frame_attention: maps must be float32 or bfloat16, got {io_dtype}")
    _check("frame_attention", "q", q, dev, dtype=io_dtype)
    _check("frame_attention", "k", k, dev, q.shape, io_dtype)
    _check("frame_attention", "v", v, dev, (b, t_len, q_bins, hd), io_dtype)
    if io_dtype == torch.bfloat16:
        plan = card_attention_mma_plan(b, t_len, q_bins, n_head, e_dim, d_dim, dev)
        out = launch_frame_attention_bf16(q, k, v, n_head, e_dim, plan.rows, plan.slices)
        frame_attention.launches_bf16 += 1
        return out
    plan = card_attention_plan(b, t_len, q_bins, n_head, e_dim, d_dim, dev)
    with torch.cuda.device(dev):
        out = torch.empty_like(v)
        lib = _build.load("attention", _SIGNATURES, _RESTYPES)
        code = lib.frame_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t_len, q_bins, n_head, e_dim, d_dim, 1.0 / math.sqrt(e_dim * q_bins),
            plan.rows, plan.slices, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"frame_attention (plan rows={plan.rows}, slices={plan.slices})")
    frame_attention.launches += 1
    return out


def frame_attention_smem(t_len: int, q_bins: int, e_dim: int, d_dim: int, rows: int,
                         slices: int) -> int:
    """The kernel's own count of a block's shared memory for a plan (-1 if
    it does not fit), to hold :func:`attention_layout` to it on the card."""
    lib = _build.load("attention", _SIGNATURES, _RESTYPES)
    return lib.frame_attention_smem(t_len, q_bins, e_dim, d_dim, rows, slices)


frame_attention.launches = 0
frame_attention.launches_bf16 = 0
