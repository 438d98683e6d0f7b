"""The plans and layouts of the bf16 forms of kernels 3 and 7 on the tensor
cores, held on the CPU (no card, no JAX): ``ops.attention.attention_mma_plan``
and ``attention_mma_layout`` (``frame_attention`` on bf16 maps),
``ops.lstm.plan_recurrence_mma``, ``recurrence_mma_layout`` and
``projection_mma_layout`` (``bilstm_fused_forward`` on a bf16 x).

The plans take the card's count of clusters that run at once as a function;
here it is given (by default every SM takes one block). A CPU model of the
attention kernel's staging walk (``csrc/attention.cu: stage_runs``) is held
to the head-minor layout it reads, and the value sweep's columns to the
slices of every rank. On the card, ``tests/test_torch_cuda.py`` holds the
layouts mirrored here to the kernels' own counts, and every plan's output
to the plain version.
"""

import math

import numpy as np
import pytest

from fdbm_tpu_torch.ops import attention as attn_ops
from fdbm_tpu_torch.ops import lstm as lstm_ops

SMEM = 232448                # a block's shared memory on the H100
Q, H, E = 257, 4, 2          # the main path: n_fft 512, 4 heads, E = 2
MAIN_T, FOLDER_B = 257, 16   # frames of the 4 s request; the folder's batch
LONGEST_T = 1921             # frames of a 30 s bucket, the serving path's longest
WIDE_H, WIDE_D, WIDE_LINES = 200, 192, 263  # 6l48c200's LSTM at the 4 s request


def _plans(t_len, d_dim):
    for mt in attn_ops.MMA_ROW_TILES:
        for slices in attn_ops.MMA_SLICES:
            lay = attn_ops.attention_mma_layout(t_len, Q, E, d_dim, mt, slices)
            if lay is not None:
                yield mt, slices, lay


# -- frame_attention on bf16 maps --------------------------------------------------------

@pytest.mark.parametrize("d_dim", [4, 8, 12])
@pytest.mark.parametrize("t_len", [1, 5, 33, 70, MAIN_T, 1000, LONGEST_T])
def test_attention_mma_plan_fits_a_block(t_len, d_dim):
    for batch in (1, FOLDER_B):
        plan = attn_ops.attention_mma_plan(batch, t_len, Q, H, E, d_dim)
        assert plan.smem_bytes <= attn_ops.SMEM_LIMIT == SMEM
        assert plan.threads % 32 == 0 and 128 <= plan.threads <= 512
        lay = attn_ops.attention_mma_layout(t_len, Q, E, d_dim, plan.rows // 16, plan.slices)
        assert (lay.threads, lay.smem_bytes) == (plan.threads, plan.smem_bytes)
        # Each block holds its rows' fp32 scores over every frame.
        assert 4 * plan.rows * t_len <= plan.smem_bytes
        assert plan.blocks == plan.slices * H * batch * math.ceil(t_len / plan.rows)
    for _, _, lay in _plans(t_len, d_dim):
        assert lay.smem_bytes <= SMEM and lay.v_stages in (2, 3)


@pytest.mark.parametrize("d_dim", [4, 8, 12])
@pytest.mark.parametrize("t_len", [5, 70, MAIN_T, LONGEST_T])
def test_attention_mma_plan_covers_every_row_key_and_bin_once(t_len, d_dim):
    """Row tiles cover the frames, the ranks' keys (even starts) cover the
    frames and the ranks' bins (whole units of lcm(8, D) lanes) the bins,
    each once; a rank's passes cover its bins."""
    for mt, slices, lay in _plans(t_len, d_dim):
        rows = 16 * mt
        starts = range(0, t_len, rows)
        assert len(starts) == math.ceil(t_len / rows)
        keys = [k for r in range(slices) for k in range(r * lay.rank_keys,
                                                         min(t_len, (r + 1) * lay.rank_keys))]
        assert sorted(keys) == list(range(t_len)) and lay.rank_keys % 2 == 0
        unit = math.lcm(8, d_dim) // d_dim
        assert lay.rank_bins % unit == 0 and lay.pass_bins % unit == 0
        bins = [q for r in range(slices) for q in range(r * lay.rank_bins,
                                                        min(Q, (r + 1) * lay.rank_bins))]
        assert sorted(bins) == list(range(Q))
        assert lay.passes == math.ceil(lay.rank_bins / lay.pass_bins)
        assert lay.key_chunk % 16 == 0 and lay.key_chunk <= 80


def _value_columns(d_dim, mt, lay, rank):
    """The (bin, lane) of every output the value sweep of ``rank`` stores, as
    the kernel's epilogue walks them: warp w holds n8 tiles w + nw j of each
    pass, lane t4 columns 8 jt + 2 t4 and + 1 of a tile."""
    nw, npw = lay.threads // 32, attn_ops._mma_npw(mt)
    lo, hi = rank * lay.rank_bins, min(Q, (rank + 1) * lay.rank_bins)
    seen = []
    for pb0 in range(lo, hi, lay.pass_bins):
        pbins = min(lay.pass_bins, hi - pb0)
        ptiles = math.ceil(pbins * d_dim / 8)
        for w in range(nw):
            for j in range(npw):
                jt = w + nw * j
                if jt >= ptiles:
                    continue
                for t4 in range(4):
                    for e in range(2):
                        col = 8 * jt + 2 * t4 + e
                        if col // d_dim < pbins:
                            seen.append((pb0 + col // d_dim, col % d_dim))
    return seen


@pytest.mark.parametrize("d_dim", [4, 8, 12])
def test_attention_mma_value_sweep_writes_every_lane_once(d_dim):
    """Every (bin, lane) of a head's D lanes is stored by exactly one rank,
    pass, warp and lane, and a warp never holds more tiles than its
    accumulators (a pass's tiles fit nw x NPW)."""
    for t_len in (MAIN_T, LONGEST_T):
        for mt, slices, lay in _plans(t_len, d_dim):
            nw = lay.threads // 32
            assert math.ceil(lay.pass_bins * d_dim / 8) <= nw * attn_ops._mma_npw(mt)
            seen = [c for r in range(slices) for c in _value_columns(d_dim, mt, lay, r)]
            assert sorted(seen) == [(q, d) for q in range(Q) for d in range(d_dim)]


def _stage_runs(dst, dst_stride, src, row_stride, bin_stride, row0, row_end, rows, bins,
                bins_real, width, nt):
    """The kernel's staging walk (csrc/attention.cu: stage_runs) on numpy
    arrays: thread tid copies runs' pieces tid, tid + nt, ... of CW bytes,
    stepping (row, piece) without a division; zeros past row_end or past
    bins_real. Returns how many times each destination lane was written."""
    cw = attn_ops._copy_bytes(width)
    el = cw // 2
    per_bin = width // el
    per_row = bins * per_bin
    n = rows * per_row
    written = np.zeros(dst.shape, np.int64)
    for tid in range(nt):
        r, c = divmod(tid, per_row)
        dr, dc = divmod(nt, per_row)
        for _ in range(tid, n, nt):
            b = c // per_bin
            lane = (c - b * per_bin) * el
            ok = row0 + r < row_end and b < bins_real
            for i in range(el):
                d = r * dst_stride + b * width + lane + i
                dst.flat[d] = src[(row0 + r) * row_stride + b * bin_stride + lane + i] if ok else 0
                written.flat[d] += 1
            r += dr
            c += dc
            if c >= per_row:
                c -= per_row
                r += 1
    return written


@pytest.mark.parametrize("e_dim,d_dim", [(2, 8), (2, 12), (4, 4), (1, 5)])
def test_attention_mma_staging_reads_the_head_minor_layout(e_dim, d_dim):
    """The query and key tiles staged head-major (a row a frame, the head's
    Q*E lanes contiguous, zero past T) and a V stage (a row a key, the pass's
    bins' D lanes contiguous) equal the head's lanes of the head-minor maps,
    each lane written once, at every copy width the kernel takes."""
    rng = np.random.default_rng(0)
    t_len, q_bins, n_head, head = 21, 9, 3, 2
    q = rng.standard_normal((t_len, q_bins, n_head * e_dim)).astype(np.float32)
    v = rng.standard_normal((t_len, q_bins, n_head * d_dim)).astype(np.float32)
    qes = 16 * math.ceil(q_bins * e_dim / 16) + 8
    for t0, rows, nt in ((0, 16, 128), (16, 16, 96), (0, 32, 160)):
        tile = np.full((rows, qes), np.nan, np.float32)
        written = _stage_runs(tile, qes, q.reshape(-1)[head * e_dim:], q_bins * n_head * e_dim,
                              n_head * e_dim, t0, t_len, rows, q_bins, q_bins, e_dim, nt)
        want = np.zeros((rows, q_bins * e_dim), np.float32)
        real = min(rows, t_len - t0)
        want[:real] = q[t0:t0 + real, :, head * e_dim:(head + 1) * e_dim].reshape(real, -1)
        np.testing.assert_array_equal(tile[:, :q_bins * e_dim], want)
        assert (written[:, :q_bins * e_dim] == 1).all() and written[:, q_bins * e_dim:].sum() == 0
    pb0, pbins, vst = 4, 4, 8 * math.ceil(4 * d_dim / 8) + 8
    stage = np.full((32, vst), np.nan, np.float32)
    written = _stage_runs(stage, vst, v.reshape(-1)[pb0 * n_head * d_dim + head * d_dim:],
                          q_bins * n_head * d_dim, n_head * d_dim, 0, t_len, 32, pbins, pbins,
                          d_dim, 160)
    want = np.zeros((32, pbins * d_dim), np.float32)
    want[:t_len] = v[:, pb0:pb0 + pbins, head * d_dim:(head + 1) * d_dim].reshape(t_len, -1)
    np.testing.assert_array_equal(stage[:, :pbins * d_dim], want)
    assert (written[:, :pbins * d_dim] == 1).all()


@pytest.mark.parametrize("d_dim", [8, 12])
def test_attention_mma_plan_is_one_wave_at_the_main_path_shape(d_dim):
    """A 4 s request's bf16 attention (B = 1) is one wave of clusters; the
    folder's batch takes more rows a block than the B = 1 plan's smallest
    tile, so fewer clusters read each key and value."""
    plan = attn_ops.attention_mma_plan(1, MAIN_T, Q, H, E, d_dim)
    assert plan.blocks // plan.slices <= plan.max_clusters
    b16 = attn_ops.attention_mma_plan(FOLDER_B, MAIN_T, Q, H, E, d_dim)
    assert b16.rows >= 32


def test_attention_mma_layout_refuses_what_the_kernel_refuses():
    assert attn_ops.attention_mma_layout(MAIN_T, Q, E, 8, 5, 1) is None   # 1-4 m16 tiles
    assert attn_ops.attention_mma_layout(MAIN_T, Q, E, 8, 1, 3) is None   # 1, 2, 4 or 8 blocks
    assert attn_ops.attention_mma_layout(0, Q, E, 8, 1, 1) is None
    for d_dim in (8, 12):
        limit = attn_ops.attention_mma_max_frames(Q, E, d_dim)
        assert LONGEST_T <= limit < 2200
        attn_ops.attention_mma_plan(1, limit, Q, H, E, d_dim)
        assert all(attn_ops.attention_mma_layout(limit + 1, Q, E, d_dim, mt, s) is None
                   for mt in attn_ops.MMA_ROW_TILES for s in attn_ops.MMA_SLICES)
        with pytest.raises(ValueError, match="16-row score tile"):
            attn_ops.attention_mma_plan(1, limit + 1, Q, H, E, d_dim)


def test_attention_mma_plan_skips_plans_the_card_cannot_run():
    only_twos = lambda rows, slices: 66 if slices == 2 else 0
    assert attn_ops.attention_mma_plan(1, MAIN_T, Q, H, E, 8, only_twos).slices == 2
    with pytest.raises(ValueError):
        attn_ops.attention_mma_plan(1, MAIN_T, Q, H, E, 8, lambda rows, slices: 0)


# -- bilstm_fused_forward on a bf16 x -------------------------------------------------------

def _any_card(cs, lines):
    return 132 // cs


@pytest.mark.parametrize("hidden", [1, 20, 100, 129, WIDE_H, 256])
def test_recurrence_mma_plan_fits_a_block(hidden):
    for lines in (5, 40, WIDE_LINES, 4208):
        plan = lstm_ops.plan_recurrence_mma(lines, 2, hidden, _any_card)
        assert plan.smem_bytes <= SMEM
        assert plan.threads % 32 == 0 and plan.threads <= 512
        assert lstm_ops.recurrence_mma_layout(hidden, plan.cs, plan.lines) == (
            plan.threads, plan.smem_bytes)
        # The block's gate columns of w_hh stay on chip in bf16 for the sweep.
        units = math.ceil(hidden / plan.cs)
        assert plan.smem_bytes >= 2 * hidden * 4 * units


@pytest.mark.parametrize("lines,hidden,cs_tile", [
    (WIDE_LINES, WIDE_H, None), (4208, WIDE_H, None), (5, 20, (1, 16)), (40, WIDE_H, (4, 32)),
    (1, 256, (8, 16)), (263, 199, (2, 32))])
def test_recurrence_mma_plan_covers_every_line_and_unit_once(lines, hidden, cs_tile):
    """The clusters tile each direction's lines with less than one tile to
    spare; a cluster's blocks own ceil(H / CS) units each, in quads of four,
    two quads a warp, and every quad has a warp and no warp is without one."""
    if cs_tile is None:
        plan = lstm_ops.plan_recurrence_mma(lines, 2, hidden, _any_card)
    else:
        plan = lstm_ops.plan_recurrence_mma(lines, 2, hidden,
                                            lambda cs, tile: 1 if (cs, tile) == cs_tile else 0)
        assert (plan.cs, plan.lines) == cs_tile
    per_dir = plan.clusters // 2
    assert per_dir * plan.lines >= lines > (per_dir - 1) * plan.lines
    uc = math.ceil(hidden / plan.cs)
    assert plan.cs * uc >= hidden > (plan.cs - 1) * uc
    quads, warps = math.ceil(uc / 4), plan.threads // 32
    assert 2 * (warps - 1) < quads <= 2 * warps


def test_recurrence_mma_plan_is_one_wave_at_the_main_path_shape():
    """6l48c200's 4 s request: 263 lines a direction in one wave of clusters,
    w_hh (320 KB a direction in bf16) split over at least two blocks."""
    plan = lstm_ops.plan_recurrence_mma(WIDE_LINES, 2, WIDE_H, _any_card)
    assert plan.clusters <= plan.max_clusters
    assert plan.cs >= 2
    assert lstm_ops.recurrence_mma_layout(WIDE_H, 1, 16) is None


def test_recurrence_mma_layout_refuses_what_the_kernel_refuses():
    assert lstm_ops.recurrence_mma_layout(257, 8, 16) is None     # H <= 256
    assert lstm_ops.recurrence_mma_layout(WIDE_H, 2, 24) is None  # 16 or 32 lines
    assert lstm_ops.recurrence_mma_layout(WIDE_H, 3, 16) is None  # 1, 2, 4 or 8 blocks
    assert lstm_ops.recurrence_mma_layout(256, 1, 16) is None     # 512 KB of bf16 weights
    assert lstm_ops.recurrence_mma_layout(WIDE_H, 2, 16) == (416, 179712)
    with pytest.raises(ValueError, match="H=200"):
        lstm_ops.plan_recurrence_mma(WIDE_LINES, 2, WIDE_H, lambda cs, lines: 0)


def test_projection_mma_layout_holds_the_whole_depth():
    """The bf16 projection's block holds a 160-column tile of w_ih over the
    whole depth and two x tiles: 128-row tiles at 6l48c200's D = 192, 64-row
    tiles further up, refused where even those do not fit."""
    assert lstm_ops.projection_mma_layout(WIDE_D) == (128, 166912)
    for d_in in range(1, 381):
        lay = lstm_ops.projection_mma_layout(d_in)
        assert lay is not None and lay[1] <= SMEM, d_in
    assert lstm_ops.projection_mma_layout(300)[0] == 64
    assert lstm_ops.projection_mma_layout(400) is None
    assert lstm_ops.projection_mma_layout(0) is None
