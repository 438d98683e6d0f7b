"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels are built from
``fdbm_tpu_torch/ops/csrc`` at first use); elsewhere they skip. They import
nothing of JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)

Tolerances: all kernels are fp32 on the CUDA cores and differ from the plain
versions only in the order of their sums, so they are held at 1e-4 relative
(RNN, attention; long chains of accumulation) and 1e-5 (norm).
"""

import numpy as np
import pytest
import torch

from fdbm_tpu_torch.ops import attention as attn_ops
from fdbm_tpu_torch.ops import gridrnn


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, scale, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * scale, device=dev)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("b,s,p,c,hidden", [
    (1, 20, 9, 8, 10),      # lines not a multiple of the 4-line group
    (2, 35, 12, 16, 24),
    (1, 70, 5, 32, 100),    # production width, short sequence
    (1, 12, 7, 64, 128),    # the gate's upper corner
    (2, 40, 3, 32, 80),     # tfgridnet_4l32c80 width
])
def test_grid_rnn_matches_plain(dev, b, s, p, c, hidden):
    rng = np.random.default_rng(0)
    x = _rand(rng, (b, s, p, c), 0.5, dev)
    w_ih = _rand(rng, (2, 4 * c, 4 * hidden), 0.1, dev)
    w_hh = _rand(rng, (2, hidden, 4 * hidden), 0.1, dev)
    bias = _rand(rng, (2, 4 * hidden), 0.1, dev)
    wd = _rand(rng, (2 * hidden, 4 * c), 0.1, dev)
    n0 = gridrnn.grid_rnn_seq1_pair.launches
    got = gridrnn.grid_rnn_seq1_pair(x, w_ih, w_hh, bias, wd)
    torch.cuda.synchronize()
    assert gridrnn.grid_rnn_seq1_pair.launches == n0 + 1
    want = gridrnn.grid_rnn_seq1_pair_plain(x, w_ih, w_hh, bias, wd)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        # the kernels are exact on every row, not only on the crop [3, L-1]
        assert _rel(g, w) < 1e-4


@pytest.mark.parametrize("rows,q_bins,n_head,width", [
    (3, 5, 4, 2), (2, 257, 4, 8), (7, 3, 2, 1), (1, 9, 4, 32)])
def test_flat_group_norm_matches_plain(dev, rows, q_bins, n_head, width):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, rows, q_bins * n_head * width), 1.0, dev)
    alpha = _rand(rng, (n_head, 1), 0.3, dev)
    gamma = _rand(rng, (n_head, width), 1.0, dev)
    beta = _rand(rng, (n_head, width), 1.0, dev)
    got = attn_ops.flat_group_norm(x, alpha, gamma, beta, width)
    want = attn_ops.flat_group_norm_plain(x, alpha, gamma, beta, width)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("b,t,q_bins,n_head,e,c", [
    (1, 5, 3, 4, 2, 32), (2, 70, 17, 4, 2, 32), (1, 33, 257, 2, 4, 16)])
def test_frame_attention_matches_plain(dev, b, t, q_bins, n_head, e, c):
    rng = np.random.default_rng(2)
    q = _rand(rng, (b, t, q_bins, n_head * e), 1.0, dev)
    k = _rand(rng, (b, t, q_bins, n_head * e), 1.0, dev)
    v = _rand(rng, (b, t, q_bins, c), 1.0, dev)
    d = c // n_head
    norms = tuple((_rand(rng, (n_head, 1), 0.3, dev), _rand(rng, (n_head, w), 1.0, dev),
                   _rand(rng, (n_head, w), 1.0, dev)) for w in (e, e, d))
    for nm in (None, norms):
        got = attn_ops.frame_attention(q, k, v, n_head, e, norms=nm)
        want = attn_ops.frame_attention_plain(q, k, v, n_head, e, norms=nm)
        assert _rel(got, want) < 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 10, 4, 12, device=dev)  # C % 8 != 0
    w = torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        gridrnn.grid_rnn_seq1_pair(x, w, w, w, w)
    q = torch.zeros(1, 4, 3, 8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        attn_ops.frame_attention(q, q, q, 4, 2)


def test_rnn_path_outside_the_gate_raises_on_the_card(dev):
    from fdbm_tpu_torch.models.tfgridnet import _RnnPath

    path = _RnnPath(emb_dim=72, hidden=16).to(dev)  # C > 64: JAX's fallback kernel 7
    with pytest.raises(NotImplementedError, match="bilstm_fused_forward"):
        path(torch.zeros(1, 10, 3, 72, device=dev))


def test_small_backbone_kernels_match_plain_route(dev):
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet
    from fdbm_tpu_torch import ops

    torch.manual_seed(0)
    net = TFGridNet(n_layers=2, emb_dim=16, hidden=24).to(dev).eval()
    ref = TFGridNet(n_layers=2, emb_dim=16, hidden=24, use_kernels=False).to(dev).eval()
    ref.load_state_dict(net.state_dict())
    x = torch.randn(2, 1, 33, 20, dtype=torch.complex64, device=dev)
    y = torch.randn(2, 1, 33, 20, dtype=torch.complex64, device=dev)
    t = torch.tensor([0.3, 0.8], device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = net(x, y, t)
        want = ref(x, y, t)
    assert ops.launch_counts() == {"grid_rnn_seq1_pair": 4, "flat_group_norm": 6,
                                   "frame_attention": 2}
    assert _rel(got, want) < 1e-4
