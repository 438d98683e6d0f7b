"""The plans of the cluster kernels, held on the CPU (no card, no JAX):
kernel 1's fused recurrence, kernel 9's reverse sweep, and the training
pair's forward (kernel 5) and reverse sweep (kernel 6).

``ops.gridrnn.plan_fused`` cuts a ``grid_rnn_seq1_pair`` call into clusters
of blocks, ``ops.lstm.plan_sweep`` the reverse sweep of ``lstm_core_bwd``,
``ops.gridrnn_train.plan_train_fwd`` and ``plan_train_sweep`` the two
recurrences of ``grid_fold_train_pair``. Each takes the card's count of
clusters that run at once as a function; here it is given, including the
H100's own counts at the main-path shapes, read with
``cudaOccupancyMaxActiveClusters`` on an NVIDIA H100 80GB HBM3. On the
card, ``tests/test_torch_cuda.py`` holds the layouts mirrored here to the
kernels' own counts.
"""

import math

import pytest

from fdbm_tpu_torch.ops import gridrnn
from fdbm_tpu_torch.ops import gridrnn_train
from fdbm_tpu_torch.ops import lstm as lstm_ops

SMEM = 232448  # a block's shared memory on the H100

# Kernel 1 at C = 32, H = 100: clusters at once by (blocks per cluster, lines).
H100_FUSED = {(2, 8): 66, (2, 16): 66, (4, 8): 30, (4, 16): 30, (8, 8): 30, (8, 16): 30}
# Kernel 9 at H = 200: by blocks per cluster (the same for every tile of lines).
H100_SWEEP = {4: 30, 8: 15}


def _fused_h100(cs, lines):
    return H100_FUSED.get((cs, lines), 0)


def _any_card(cs, lines):
    """A card on which one cluster of every plan that fits a block runs."""
    return 1


@pytest.mark.parametrize("hidden", [1, 24, 80, 100, 128])
@pytest.mark.parametrize("c", [8, 32, 48, 64])
def test_fused_plan_fits_a_block(c, hidden):
    plan = gridrnn.plan_fused(263, c, hidden, _any_card)
    assert plan.smem_bytes <= gridrnn.SMEM_LIMIT == SMEM
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert gridrnn.fused_layout(c, hidden, plan.cs, plan.lines) == (
        plan.threads, plan.smem_bytes)
    # Every pair of units has eight lanes, every line a tile, both directions.
    units = math.ceil(hidden / plan.cs)
    assert plan.threads >= 8 * math.ceil(units / 2)
    assert plan.clusters == 2 * math.ceil(263 / plan.lines)
    # The stacked weights of the block's units stay on chip for the sweep.
    assert plan.smem_bytes >= 4 * (4 * c + hidden) * 4 * units


def test_fused_plan_is_one_wave_at_the_main_path_shape():
    """5l32c100's RNN path of a 4 s request: 263 lines of each direction at
    C = 32, H = 100, on the H100's counts: 66 clusters of 2 blocks of 8
    lines, one block on each of the 132 SMs."""
    plan = gridrnn.plan_fused(263, 32, 100, _fused_h100)
    assert plan.clusters <= plan.max_clusters
    assert (plan.cs, plan.lines, plan.clusters) == (2, 8, 66)
    assert plan.clusters * plan.cs == gridrnn.SMS


def test_fused_plan_of_the_4l32c80_backbone_is_one_wave():
    """tfgridnet_4l32c80 (C = 32, H = 80) at the same canvas, on counts of
    66 clusters of 2 (its blocks are smaller than 5l32c100's)."""
    plan = gridrnn.plan_fused(263, 32, 80, lambda cs, lines: 66 if cs == 2 else 0)
    assert plan.clusters <= plan.max_clusters and plan.cs == 2


@pytest.mark.parametrize("c", [8, 16, 24, 32, 40, 48, 56, 64])
def test_every_width_inside_the_gate_has_a_fused_plan(c):
    """The model's gate (C % 8 == 0, C <= 64, H <= 128): every H has a
    plan that fits a block, the widest corner (C = 64, H = 128) with
    clusters of 4 or 8."""
    for hidden in range(1, 129):
        plan = gridrnn.plan_fused(13, c, hidden, _any_card)
        assert plan.smem_bytes <= SMEM, (c, hidden)
    assert gridrnn.plan_fused(13, 64, 128, _any_card).cs >= 4


def test_fused_layout_refuses_what_the_kernel_refuses():
    assert gridrnn.fused_layout(32, 100, 1, 8) is None     # 372 KB of weights
    assert gridrnn.fused_layout(64, 128, 2, 8) is None     # 405 KB
    assert gridrnn.fused_layout(32, 100, 3, 8) is None     # clusters of 1, 2, 4 or 8
    assert gridrnn.fused_layout(32, 100, 2, 4) is None     # 8 or 16 lines
    assert gridrnn.fused_layout(32, 100, 2, 12) is None
    assert gridrnn.fused_layout(32, 100, 2, 20) is None
    assert gridrnn.fused_layout(8, 128, 1, 8) is None      # 512 threads
    assert gridrnn.fused_layout(32, 100, 2, 8) == (224, 204288)


def test_fused_plan_skips_plans_the_card_cannot_run():
    only_fours = lambda cs, lines: 30 if cs == 4 else 0
    assert gridrnn.plan_fused(263, 32, 100, only_fours).cs == 4
    with pytest.raises(ValueError, match="C=32, H=100"):
        gridrnn.plan_fused(263, 32, 100, lambda cs, lines: 0)


# -- kernel 9's reverse sweep --

def _sweep_h100(cs, lines):
    return H100_SWEEP.get(cs, 0)


def test_sweep_plan_is_one_wave_at_the_main_path_shape():
    """A 6l48c200 training step's lstm_core backward: 524 lines at H = 200,
    on the H100's counts: 27 clusters of 4 blocks of 20 lines, of 30."""
    plan = lstm_ops.plan_sweep(524, 200, _sweep_h100)
    assert plan.clusters <= plan.max_clusters == 30
    assert (plan.cs, plan.lines, plan.clusters) == (4, 20, 27)
    assert plan.smem_bytes <= lstm_ops.SMEM_LIMIT == SMEM and plan.threads <= 256


@pytest.mark.parametrize("lines", [1, 13, 70, 524, 1000])
def test_every_width_up_to_256_has_a_sweep_plan(lines):
    """4H <= 1024: every H up to 256 has a plan, whose blocks cover every
    unit and line."""
    for hidden in range(1, 257):
        plan = lstm_ops.plan_sweep(lines, hidden, lambda cs, tile: 8)
        assert plan.smem_bytes <= SMEM and plan.threads <= 256, hidden
        assert plan.cs * math.ceil(hidden / plan.cs) >= hidden
        assert plan.clusters * plan.lines >= lines
        assert (plan.clusters - 1) * plan.lines < lines
        assert lstm_ops.sweep_layout(hidden, plan.cs, plan.lines) == (
            plan.threads, plan.smem_bytes)


def test_sweep_layout_holds_w_hh_on_chip():
    """A block keeps its units' gate columns of w_hh (no transposed copy in
    device memory), its tile's dgates, two receive tiles and its cells'
    stashes of one step: at H = 200 and clusters of 4, 160 KB of weights,
    232000 of the 232448 bytes in all."""
    threads, nbytes = lstm_ops.sweep_layout(200, 4, 20)
    assert threads == 224
    assert nbytes == 4 * (200 * 200 + 20 * 200 + 2 * 4 * 20 * 50 + 6 * 20 * 50) == 232000
    assert lstm_ops.sweep_layout(200, 2, 4) is None     # 320 KB of weights
    assert lstm_ops.sweep_layout(256, 4, 4) is None     # 256 KB
    assert lstm_ops.sweep_layout(256, 8, 24) is not None
    assert lstm_ops.sweep_layout(200, 4, 6) is None     # lines not a multiple of 4
    assert lstm_ops.sweep_layout(200, 3, 8) is None     # clusters of 1, 2, 4 or 8
    assert lstm_ops.sweep_layout(20, 1, 24) is None     # 24 cells a thread


def test_sweep_plan_raises_when_nothing_runs():
    with pytest.raises(ValueError, match="reverse sweep.*H=200"):
        lstm_ops.plan_sweep(524, 200, lambda cs, lines: 0)


# -- kernels 5 and 6: the training pair's forward and reverse sweep --

# At C = 32, H = 100, clusters at once by (blocks per cluster, lines): kernel
# 5 (kernel 1's recurrence with its stash) and kernel 6's sweep (chip_smoke.py's
# rows 5 and 6 print them as max_clusters_by_plan).
H100_TRAIN_FWD = {(2, 8): 66, (2, 16): 66, (4, 8): 30, (4, 16): 30, (8, 8): 30, (8, 16): 30}
H100_TRAIN_SWEEP = {(2, 8): 66, (2, 16): 66, (4, 8): 30, (4, 16): 30, (8, 8): 15, (8, 16): 15}
GATE_C = (8, 16, 24, 32, 40, 48, 56, 64)
GATE_H = (1, 24, 80, 100, 128)


@pytest.mark.parametrize("lines", [524, 526])
def test_train_plans_are_one_wave_at_the_main_path_shape(lines):
    """A 5l32c100 training step (B = 2, 256 frames): the intra path's 524
    lines and the inter path's 526 a direction, on the H100's counts: 66
    clusters of 2 blocks of 16 lines, one block on each of the 132 SMs."""
    fwd = gridrnn_train.plan_train_fwd(lines, 32, 100, lambda cs, t: H100_TRAIN_FWD.get((cs, t), 0))
    bwd = gridrnn_train.plan_train_sweep(lines, 32, 100,
                                         lambda cs, t: H100_TRAIN_SWEEP.get((cs, t), 0))
    for plan in (fwd, bwd):
        assert plan.clusters <= plan.max_clusters
        assert (plan.cs, plan.lines, plan.clusters) == (2, 16, 66)
        assert plan.clusters * plan.cs == gridrnn.SMS
    assert bwd.threads == 224 and bwd.smem_bytes <= SMEM


@pytest.mark.parametrize("c", GATE_C)
def test_every_width_inside_the_gate_has_train_plans(c):
    """C % 8 == 0, C <= 64, H <= 128: both recurrences have a plan that
    fits a block's 232,448 bytes, and the sweep's blocks cover every unit,
    channel and line."""
    for hidden in GATE_H:
        for lines in (13, 524):
            fwd = gridrnn_train.plan_train_fwd(lines, c, hidden, _any_card)
            bwd = gridrnn_train.plan_train_sweep(lines, c, hidden, _any_card)
            for plan in (fwd, bwd):
                assert plan.smem_bytes <= SMEM and plan.threads <= 256, (c, hidden)
                assert plan.clusters == 2 * math.ceil(lines / plan.lines)
            assert c % bwd.cs == 0
            assert gridrnn_train.train_sweep_layout(c, hidden, bwd.cs, bwd.lines) == (
                bwd.threads, bwd.smem_bytes)
            # four lanes' groups of four units a warp, at most five cells a thread
            units = math.ceil(hidden / bwd.cs)
            assert bwd.threads >= 8 * math.ceil(hidden / 4)
            assert bwd.threads * gridrnn_train.SWEEP_MAX_CELLS >= bwd.lines * units


def test_train_sweep_layout_holds_the_weights_on_chip():
    """At C = 32, H = 100 and clusters of 2: the units' gate columns of
    w_hh (90 KB with the row padding), their channels' rows of wd^T, the tile's dgates, two
    receive tiles, the ring of cotangent rows and the cells' stashes of a
    step; the gate's corner needs clusters of 4."""
    threads, nbytes = gridrnn_train.train_sweep_layout(32, 100, 2, 16)
    assert threads == 224
    assert nbytes == 4 * (200 * 112 + 64 * 112 + 200 * 20 + 2 * 2 * 16 * 50 + 8 * 16 * 20
                          + 5 * 16 * 50)
    assert gridrnn_train.train_sweep_layout(32, 100, 1, 16) is None   # 276 KB
    assert gridrnn_train.train_sweep_layout(64, 128, 2, 16) is None   # 262 KB
    assert gridrnn_train.train_sweep_layout(64, 128, 4, 16) is not None


def test_train_sweep_layout_refuses_what_the_kernel_refuses():
    assert gridrnn_train.train_sweep_layout(32, 100, 3, 16) is None   # clusters of 1, 2, 4 or 8
    assert gridrnn_train.train_sweep_layout(32, 100, 2, 4) is None    # 8 or 16 lines
    assert gridrnn_train.train_sweep_layout(32, 100, 2, 12) is None
    assert gridrnn_train.train_sweep_layout(8, 24, 16, 8) is None
    assert gridrnn_train.train_sweep_layout(24, 24, 16, 8) is None    # C / cs channels a rank
    assert gridrnn_train.train_sweep_layout(16, 100, 1, 16) is None   # 8 cells a thread
    assert gridrnn_train.train_sweep_layout(32, 100, 2, 8) is not None


def test_train_plans_skip_plans_the_card_cannot_run():
    only_fours = lambda cs, lines: 30 if cs == 4 else 0
    assert gridrnn_train.plan_train_fwd(524, 32, 100, only_fours).cs == 4
    assert gridrnn_train.plan_train_sweep(524, 32, 100, only_fours).cs == 4
    with pytest.raises(ValueError, match="grid_fold_train_pair: .*C=32, H=100"):
        gridrnn_train.plan_train_fwd(524, 32, 100, lambda cs, lines: 0)
    with pytest.raises(ValueError, match="reverse sweep.*C=32, H=100"):
        gridrnn_train.plan_train_sweep(524, 32, 100, lambda cs, lines: 0)
