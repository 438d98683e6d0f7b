"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels are built from
``fdbm_tpu_torch/ops/csrc`` at first use); elsewhere they skip. They import
nothing of JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)

Tolerances: all kernels are fp32 on the CUDA cores and differ from the plain
versions only in the order of their sums, so they are held at 1e-4 relative
(RNN, attention; long chains of accumulation) and 1e-5 (norm). The training
kernels' gradients are held at 1e-3 norm-relative per gradient, and a
training step's parameter gradients at 1e-3 norm-relative per leaf (the JAX
package's own gates for its training kernel, tests/test_gridrnn_train.py).
"""

import numpy as np
import pytest
import torch

from fdbm_tpu_torch import ops
from fdbm_tpu_torch.ops import attention as attn_ops
from fdbm_tpu_torch.ops import gridrnn
from fdbm_tpu_torch.ops import gridrnn_train


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
                                   "frame_attention": 2, "grid_bilstm_fold": 0,
                                   "grid_fold_train_pair": 0, "grid_fold_train_pair_bwd": 0}
    assert _rel(got, want) < 1e-4


TRAIN_SHAPES = [
    (35, 12, 16, 24),   # JAX's training-kernel test shapes (s, lines, C, H)
    (29, 5, 8, 10),     # lines not a multiple of the 4-line group
    (40, 7, 32, 100),   # production width
    (12, 9, 64, 128),   # the gate's upper corner
]


def _rnn_args(rng, s, lines, c, hidden, dev):
    return (_rand(rng, (s, lines, c), 0.5, dev), _rand(rng, (2, 4 * c, 4 * hidden), 0.2, dev),
            _rand(rng, (2, hidden, 4 * hidden), 0.2, dev), _rand(rng, (2, 4 * hidden), 0.2, dev),
            _rand(rng, (2 * hidden, 4 * c), 0.2, dev))


@pytest.mark.parametrize("s,lines,c,hidden", TRAIN_SHAPES)
def test_train_kernels_match_plain(dev, s, lines, c, hidden):
    """Kernel 4 and kernel 5's forward against the plain pipeline (every
    row), kernel 6's five gradients against autograd of the plain pipeline
    under a random cotangent on every row."""
    rng = np.random.default_rng(3)
    args = _rnn_args(rng, s, lines, c, hidden, dev)
    want = gridrnn_train.grid_fold_train_pair_plain(*args)
    ops.reset_launch_counts()
    got = gridrnn.grid_bilstm_fold(*args)
    assert _rel(got, want[0] + want[1]) < 1e-4
    outf, outb, stash = gridrnn_train.grid_fold_train_pair_fwd(*args)
    for g, w in zip((outf, outb), want):
        assert _rel(g, w) < 1e-4
    cot = (_rand(rng, (s, lines, c), 1.0, dev), _rand(rng, (s, lines, c), 1.0, dev))
    got = gridrnn_train.grid_fold_train_pair_bwd(*args, *cot, stash=stash)
    torch.cuda.synchronize()
    want = gridrnn_train.grid_fold_train_pair_bwd_plain(*args, *cot)
    for name, g, w in zip(("dx", "dw_ih", "dw_hh", "dbias", "dwd"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < 1e-3, name
    assert ops.launch_counts()["grid_bilstm_fold"] == 1
    assert ops.launch_counts()["grid_fold_train_pair"] == 1
    assert ops.launch_counts()["grid_fold_train_pair_bwd"] == 1


def test_train_backward_is_deterministic(dev):
    rng = np.random.default_rng(4)
    args = _rnn_args(rng, 40, 7, 32, 100, dev)
    _, _, stash = gridrnn_train.grid_fold_train_pair_fwd(*args)
    cot = (_rand(rng, (40, 7, 32), 1.0, dev),) * 2
    first = gridrnn_train.grid_fold_train_pair_bwd(*args, *cot, stash=stash)
    again = gridrnn_train.grid_fold_train_pair_bwd(*args, *cot, stash=stash)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_gradients_flow_through_grid_fold_train_pair(dev):
    rng = np.random.default_rng(5)
    args = [a.requires_grad_(True) for a in _rnn_args(rng, 20, 6, 16, 24, dev)]
    ops.reset_launch_counts()
    outf, outb = gridrnn_train.grid_fold_train_pair(*args)
    cot = _rand(rng, (20, 6, 16), 1.0, dev)
    ((outf + outb) * cot).sum().backward()
    assert ops.launch_counts()["grid_fold_train_pair"] == 1
    assert ops.launch_counts()["grid_fold_train_pair_bwd"] == 1
    plain = [a.detach().clone().requires_grad_(True) for a in args]
    pf, pb = gridrnn_train.grid_fold_train_pair_plain(*plain)
    ((pf + pb) * cot).sum().backward()
    for a, p in zip(args, plain):
        assert a.grad is not None and _rel(a.grad, p.grad) < 1e-3


def test_serving_wrappers_refuse_grad(dev):
    """The serving kernels have no backward: with grad enabled and an input
    that requires grad they raise rather than cut the graph."""
    rng = np.random.default_rng(6)
    x = _rand(rng, (1, 12, 5, 8), 0.5, dev)
    w = [_rand(rng, shape, 0.1, dev).requires_grad_(True)
         for shape in ((2, 32, 40), (2, 10, 40), (2, 40), (20, 32))]
    with pytest.raises(RuntimeError, match="no backward"):
        gridrnn.grid_rnn_seq1_pair(x, *w)
    with pytest.raises(RuntimeError, match="no backward"):
        gridrnn.grid_bilstm_fold(x[0], *w)
    q = _rand(rng, (1, 4, 3, 8), 1.0, dev).requires_grad_(True)
    v = _rand(rng, (1, 4, 3, 16), 1.0, dev)
    with pytest.raises(RuntimeError, match="no backward"):
        attn_ops.frame_attention(q, q, v, 4, 2)
    norm = (torch.full((4, 1), 0.25, device=dev, requires_grad=True),
            torch.ones(4, 2, device=dev), torch.zeros(4, 2, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        attn_ops.flat_group_norm(q.detach().reshape(1, 4, 24), *norm, width=2)
    with torch.no_grad():  # the serving path runs under no_grad
        gridrnn.grid_rnn_seq1_pair(x, *w)
        attn_ops.frame_attention(q, q, v, 4, 2)


def _grad_rel(a: torch.Tensor, b: torch.Tensor, gnorm: float) -> float:
    """Norm-relative difference, the denominator floored at 1e-4 of the
    global gradient norm (leaves whose exact gradient is ~0 hold fp32
    cancellation residue in both routes: tests/test_gridrnn_train.py)."""
    return float((a - b).norm() / max(float(b.norm()), 1e-4 * gnorm))


def test_small_backbone_train_step_kernel_route_matches_plain(dev):
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    cfg = FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=64, hop_length=32, num_frames=16)
    torch.manual_seed(0)
    fdbms = []
    for use_kernels in (True, False):
        fdbm = FDBM(cfg, device="cuda")
        fdbm.dnn = TFGridNet(n_layers=2, emb_dim=16, hidden=24,
                             use_kernels=use_kernels).to(dev)
        fdbms.append(fdbm)
    fdbms[1].dnn.load_state_dict(fdbms[0].dnn.state_dict())
    rng = np.random.default_rng(7)
    audio = rng.standard_normal((2, 2, 15 * 32)).astype(np.float32) * 0.3
    batch = fdbms[0].to_device((audio[0], audio[1]))
    t = torch.tensor([0.3, 0.8], device=dev)
    z = torch.complex(*(_rand(rng, (2, 1, 33, 16), 0.7, dev) for _ in range(2)))
    losses, grads = [], []
    ops.reset_launch_counts()
    for fdbm in fdbms:
        state = TrainState(fdbm.dnn)
        loss = fdbm.loss_fn(batch, prior=(t, z))
        grads.append(dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values())))))
        losses.append(float(loss.detach()))
    assert ops.launch_counts()["grid_fold_train_pair"] == 4
    assert ops.launch_counts()["grid_fold_train_pair_bwd"] == 4
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads[1].values())))
    worst = max(_grad_rel(grads[0][k], grads[1][k], gnorm) for k in grads[1])
    assert worst < 1e-3
