"""The plan and layout of kernel 1's bf16 form on the tensor cores, held on
the CPU (no card, no JAX): ``ops.gridrnn.plan_mma`` and ``mma_layout``
(``grid_rnn_seq1_pair`` on a bf16 canvas).

The plan takes the card's count of clusters that run at once as a function;
here it is given, including the H100's own counts at the main path's shape
(C = 32, H = 100), read with ``cudaOccupancyMaxActiveClusters`` on an NVIDIA
H100 80GB HBM3. On the card, ``tests/test_torch_cuda.py`` holds the layout
mirrored here to the kernel's own byte count, and the kernel's own layout
of lanes and gate columns by the comparison of every plan with the plain
version.
"""

import math

import pytest

from fdbm_tpu_torch.ops import gridrnn

SMEM = 232448             # a block's shared memory on the H100
C, HIDDEN = 32, 100       # tfgridnet_5l32c100's RNN widths
LINES_B1, LINES_B16 = 263, 4208  # kernel 1's lines a direction at B = 1 and B = 16
# Kernel 1 at C = 32, H = 100: clusters at once by (blocks a cluster, lines a tile).
H100_MMA = {(1, 16): 132, (1, 32): 132, (2, 16): 66, (2, 32): 66, (4, 16): 92, (4, 32): 62}


def _mma_h100(cs, lines):
    return H100_MMA.get((cs, lines), 0)


def _any_card(cs, lines):
    """A card on which one cluster of every plan that fits a block runs."""
    return 1


# -- grid_rnn_seq1_pair on a bf16 canvas ---------------------------------------------------

@pytest.mark.parametrize("lines", [LINES_B1, LINES_B16])
def test_mma_plan_fits_a_block_at_the_main_path_shape(lines):
    plan = gridrnn.plan_mma(lines, C, HIDDEN, _mma_h100)
    assert plan.smem_bytes <= gridrnn.SMEM_LIMIT == SMEM
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert gridrnn.mma_layout(C, HIDDEN, plan.cs, plan.lines) == (plan.threads, plan.smem_bytes)
    assert plan.clusters == 2 * math.ceil(lines / plan.lines)
    # The block's whole stacked weight stays on chip in bf16 for the sweep.
    units = math.ceil(HIDDEN / plan.cs)
    assert plan.smem_bytes >= 2 * (4 * C + HIDDEN) * 4 * units


@pytest.mark.parametrize("c", [8, 16, 24, 32, 40, 48, 56, 64])
def test_every_width_inside_the_gate_has_an_mma_plan(c):
    """The model's gate (C % 8 == 0, C <= 64, H <= 128): every H has a plan
    that fits a block; at C = 32, H = 100 a cluster of one block holds the
    whole stacked weight."""
    for hidden in range(1, 129):
        plan = gridrnn.plan_mma(263, c, hidden, _any_card)
        assert plan.smem_bytes <= SMEM, (c, hidden)
    assert gridrnn.mma_layout(C, HIDDEN, 1, 16) is not None


def test_mma_plan_is_one_wave_at_the_main_path_shape():
    """A 4 s request: 263 lines a direction in 34 clusters of one block of 16
    lines, one wave on the H100's counts; at the folder's 4208 lines no plan
    is one wave and tiles of 32 lines take two."""
    plan = gridrnn.plan_mma(LINES_B1, C, HIDDEN, _mma_h100)
    assert (plan.cs, plan.lines, plan.clusters) == (1, 16, 34)
    assert plan.clusters <= plan.max_clusters
    b16 = gridrnn.plan_mma(LINES_B16, C, HIDDEN, _mma_h100)
    assert all(2 * math.ceil(LINES_B16 / t) > n for (cs, t), n in H100_MMA.items()
               if gridrnn.mma_layout(C, HIDDEN, cs, t))
    assert (b16.cs, b16.lines) == (1, 32)
    assert math.ceil(b16.clusters / b16.max_clusters) == 2


def test_mma_plan_skips_plans_the_card_cannot_run():
    only_twos = lambda cs, lines: 66 if cs == 2 else 0
    assert gridrnn.plan_mma(LINES_B1, C, HIDDEN, only_twos).cs == 2
    with pytest.raises(ValueError, match="C=32, H=100"):
        gridrnn.plan_mma(LINES_B1, C, HIDDEN, lambda cs, lines: 0)


def test_mma_layout_refuses_what_the_kernel_refuses():
    assert gridrnn.mma_layout(64, 128, 1, 16) is None    # 393 KB of bf16 weights
    assert gridrnn.mma_layout(C, HIDDEN, 1, 64) is None  # 16 or 32 lines
    assert gridrnn.mma_layout(C, HIDDEN, 3, 16) is None  # clusters of 1, 2, 4 or 8
    assert gridrnn.mma_layout(C, HIDDEN, 1, 8) is None
    assert gridrnn.mma_layout(12, HIDDEN, 1, 16) is None  # C % 8 == 0
    assert gridrnn.mma_layout(C, 129, 2, 16) is None     # H <= 128
    assert gridrnn.mma_layout(64, 1, 8, 32) is None      # 256 copies a row for 32 threads
    assert gridrnn.mma_layout(C, HIDDEN, 1, 16) == (416, 209424)


@pytest.mark.parametrize("lines,hidden,cs_tile", [
    (LINES_B1, HIDDEN, None), (LINES_B16, HIDDEN, None), (17, 24, (1, 16)), (33, 128, (4, 32)),
    (1, 40, (8, 32)), (263, 99, (4, 16))])
def test_mma_plan_covers_every_line_and_unit_once(lines, hidden, cs_tile):
    """The plan's clusters tile each direction's lines with less than one
    tile to spare; a cluster's blocks own ceil(H / CS) units each, in quads
    of four, two quads a warp, and the layout's threads give every quad a
    warp and leave no warp without one."""
    if cs_tile is None:
        plan = gridrnn.plan_mma(lines, C, hidden, _mma_h100)
    else:
        plan = gridrnn.plan_mma(lines, C, hidden,
                                lambda cs, tile: 1 if (cs, tile) == cs_tile else 0)
        assert (plan.cs, plan.lines) == cs_tile
    per_dir = plan.clusters // 2
    assert per_dir * plan.lines >= lines > (per_dir - 1) * plan.lines
    uc = math.ceil(hidden / plan.cs)
    assert plan.cs * uc >= hidden > (plan.cs - 1) * uc
    quads, warps = math.ceil(uc / 4), plan.threads // 32
    assert 2 * (warps - 1) < quads <= 2 * warps
