"""The plans of the two cluster kernels, held on the CPU (no card, no JAX).

``ops.attention.attention_plan`` cuts a ``frame_attention`` call into
clusters of blocks, ``ops.lstm.plan_recurrence`` the LSTM forward
recurrence. Both take the card's count of clusters that run at once as a
function; here it is given, including the H100's own counts (clusters of 2,
3 and 4 blocks: 66, 39 and 30 at the main-path shapes, read with
``cudaOccupancyMaxActiveClusters`` on an NVIDIA H100 80GB HBM3). On the card,
``tests/test_torch_cuda.py`` holds the layouts mirrored here to the kernels'
own counts.
"""

import math

import pytest

from fdbm_tpu_torch.ops import attention as attn_ops
from fdbm_tpu_torch.ops import lstm as lstm_ops

Q, H, E = 257, 4, 2     # the main path: n_fft 512, 4 heads, E = 2
MAIN_T = 257            # frames of the 4 s request
H100_ATTN = {1: 132, 2: 66, 3: 39, 4: 30}  # clusters at once, by blocks per cluster


def _h100(rows, slices):
    return H100_ATTN[slices]


@pytest.mark.parametrize("d_dim", [8, 12])
@pytest.mark.parametrize("t_len", [1, 7, 64, 257, 1000, 1900, 3000, 5000])
def test_attention_plan_fits_a_block(t_len, d_dim):
    plan = attn_ops.attention_plan(1, t_len, Q, H, E, d_dim, _h100)
    assert plan.smem_bytes <= attn_ops.SMEM_LIMIT == 232448
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert attn_ops.attention_layout(t_len, Q, E, d_dim, plan.rows, plan.slices) == (
        plan.threads, plan.smem_bytes)
    # The score rows of every frame are held: rows x T floats fit beside the rest.
    assert 4 * plan.rows * t_len <= plan.smem_bytes
    assert plan.blocks == plan.slices * H * math.ceil(t_len / plan.rows)


@pytest.mark.parametrize("d_dim", [8, 12])
def test_attention_plan_is_one_wave_at_the_main_path_shape(d_dim):
    """On the card's counts the main-path call is one wave over most of the
    SMs the card gives to clusters; if every SM could take a block it would
    give one to each of the 132."""
    plan = attn_ops.attention_plan(1, MAIN_T, Q, H, E, d_dim, _h100)
    clusters = plan.blocks // plan.slices
    assert clusters <= H100_ATTN[plan.slices] == plan.max_clusters
    assert plan.blocks >= 0.9 * H100_ATTN[plan.slices] * plan.slices
    free = attn_ops.attention_plan(1, MAIN_T, Q, H, E, d_dim)
    assert free.blocks >= attn_ops.SMS
    assert free.blocks // free.slices <= attn_ops.SMS // free.slices


@pytest.mark.parametrize("d_dim", [8, 12])
def test_attention_plan_raises_above_its_frame_limit(d_dim):
    limit = attn_ops.attention_max_frames(Q, E, d_dim)
    assert 5000 <= limit < 6000
    attn_ops.attention_plan(1, limit, Q, H, E, d_dim, _h100)
    with pytest.raises(ValueError, match=f"limit of {limit}"):
        attn_ops.attention_plan(1, limit + 1, Q, H, E, d_dim, _h100)


def test_attention_plan_skips_plans_the_card_cannot_run():
    """A plan of which the card runs no cluster is never taken."""
    only_pairs = lambda rows, slices: 66 if slices == 2 else 0
    assert attn_ops.attention_plan(1, MAIN_T, Q, H, E, 8, only_pairs).slices == 2
    with pytest.raises(ValueError):
        attn_ops.attention_plan(1, MAIN_T, Q, H, E, 8, lambda rows, slices: 0)


def test_attention_layout_refuses_what_the_kernel_refuses():
    assert attn_ops.attention_layout(MAIN_T, Q, E, 8, 12, 1) is None   # rows not a multiple of 8
    assert attn_ops.attention_layout(MAIN_T, Q, E, 8, 72, 1) is None   # above 64 rows
    assert attn_ops.attention_layout(MAIN_T, Q, E, 8, 8, 9) is None    # above 8 per cluster
    assert attn_ops.attention_layout(0, Q, E, 8, 8, 1) is None
    assert attn_ops.attention_layout(MAIN_T, Q, E, 8, 64, 1) is None   # 64 rows do not fit


# The LSTM recurrence at the main-path shapes: 6l48c200's intra path, H = 200,
# 262 lines of a 4 s request (kernel 10: one direction, kernel 7: two) and
# 524 lines of a B=2, 256-frame training step (kernel 8).
MAIN_RECURRENCES = [(262, 1), (262, 2), (524, 1)]


def _clusters_of(counts):
    """max_clusters(cs, lines) from {cs: count}: the H100 runs as many
    clusters of 4 as of 8 blocks at H = 200 (30), none of 1 or 2 (w_hh
    does not fit)."""
    return lambda cs, lines: counts.get(cs, 0)


@pytest.mark.parametrize("at_once", [24, 30, 32, 33])
@pytest.mark.parametrize("lines,dirs", MAIN_RECURRENCES)
def test_recurrence_plan_is_one_wave_at_the_main_path_shapes(lines, dirs, at_once):
    plan = lstm_ops.plan_recurrence(lines, dirs, 200, _clusters_of({4: at_once, 8: at_once}))
    assert plan.clusters == dirs * math.ceil(lines / plan.lines)
    assert plan.clusters <= plan.max_clusters == at_once
    assert plan.lines in lstm_ops.REC_LINES and plan.cs in (4, 8)
    assert plan.smem_bytes <= lstm_ops.SMEM_LIMIT and plan.threads <= 256


def test_recurrence_plan_on_the_h100_counts():
    """With the card's counts (30 clusters of 4, 30 of 8 below 24 lines) the
    plans are the fastest measured on it: clusters of 4, 12 lines for one
    direction of 262, 20 lines for two directions and for 524."""
    counts = lambda cs, lines: {4: 30, 8: 15 if lines == 24 else 30}.get(cs, 0)
    got = [lstm_ops.plan_recurrence(lines, dirs, 200, counts)[:3]
           for lines, dirs in MAIN_RECURRENCES]
    assert got == [(4, 12, 22), (4, 20, 28), (4, 20, 27)]


@pytest.mark.parametrize("hidden", [1, 20, 40, 132, 197, 199, 200, 256])
@pytest.mark.parametrize("lines", [1, 5, 13, 262, 1000])
def test_recurrence_plan_covers_every_line_and_unit(hidden, lines):
    """Every line (B not a multiple of the tile) and every unit (H not a
    multiple of the cluster) has an owner, in one wave or more."""
    plan = lstm_ops.plan_recurrence(lines, 2, hidden, lambda cs, tile: 8)
    assert plan.clusters * plan.lines >= 2 * lines
    assert (plan.clusters - 2) * plan.lines < 2 * lines  # no tile beyond the last line
    units = math.ceil(hidden / plan.cs)
    assert plan.cs * units >= hidden and (plan.cs - 1) * units < hidden
    assert plan.threads >= 4 * units  # four lanes per unit
    assert lstm_ops.recurrence_layout(hidden, plan.cs, plan.lines) == (
        plan.threads, plan.smem_bytes)


def test_recurrence_layout_holds_w_hh_on_chip():
    """A block keeps its H x 4H/CS slice of w_hh and two copies of h in
    shared memory: at H = 200, 160 KB of weights with clusters of 4."""
    threads, nbytes = lstm_ops.recurrence_layout(200, 4, 12)
    assert threads == 224
    assert nbytes >= 200 * 200 * 4 + 2 * 200 * 12 * 4  # H x 4(H/4) floats, two h buffers
    assert lstm_ops.recurrence_layout(200, 2, 12) is None   # 320 KB of weights
    assert lstm_ops.recurrence_layout(256, 4, 4) is None    # 256 KB
    assert lstm_ops.recurrence_layout(256, 8, 24) is not None
    assert lstm_ops.recurrence_layout(200, 4, 6) is None    # lines not a multiple of 4
    assert lstm_ops.recurrence_layout(200, 3, 8) is None    # clusters of 1, 2, 4 or 8


def test_recurrence_plan_raises_when_nothing_runs():
    with pytest.raises(ValueError, match="H=200"):
        lstm_ops.plan_recurrence(262, 1, 200, lambda cs, lines: 0)
