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
The LSTM kernels of ops/lstm.py are held to the same: 1e-4 on hidden
states, 1e-3 per gradient.
"""

import numpy as np
import pytest
import torch

from fdbm_tpu_torch import ops
from fdbm_tpu_torch.ops import attention as attn_ops
from fdbm_tpu_torch.ops import gridrnn
from fdbm_tpu_torch.ops import gridrnn_train
from fdbm_tpu_torch.ops import lstm as lstm_ops


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


def test_frame_attention_matches_plain_at_head_width_12(dev):
    """C = 48, 4 heads: D = 12, which the norm kernel does not take, so the
    model norms on plain ops and calls the attention without norms."""
    rng = np.random.default_rng(2)
    q = _rand(rng, (1, 40, 17, 8), 1.0, dev)
    k = _rand(rng, (1, 40, 17, 8), 1.0, dev)
    v = _rand(rng, (1, 40, 17, 48), 1.0, dev)
    got = attn_ops.frame_attention(q, k, v, 4, 2)
    assert _rel(got, attn_ops.frame_attention_plain(q, k, v, 4, 2)) < 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 10, 4, 12, device=dev)  # C % 8 != 0
    w = torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        gridrnn.grid_rnn_seq1_pair(x, w, w, w, w)
    q = torch.zeros(1, 4, 3, 8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        attn_ops.frame_attention(q, q, q, 4, 2)


def test_rnn_path_outside_the_gate_matches_plain_on_the_card(dev):
    """C > 64: the generic path, whose BiLSTM runs kernel 7 in eval mode."""
    from fdbm_tpu_torch.models.tfgridnet import _RnnPath

    torch.manual_seed(0)
    path = _RnnPath(emb_dim=72, hidden=16).to(dev).eval()
    ref = _RnnPath(emb_dim=72, hidden=16, use_kernels=False).to(dev).eval()
    ref.load_state_dict(path.state_dict())
    x = torch.randn(2, 13, 3, 72, device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = path(x)
        want = ref(x)
    assert ops.launch_counts()["bilstm_fused_forward"] == 1
    assert ops.launch_counts()["grid_rnn_seq1_pair"] == 0
    assert _rel(got, want) < 1e-4


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
                                   "grid_fold_train_pair": 0, "grid_fold_train_pair_bwd": 0,
                                   "bilstm_fused_forward": 0, "lstm_core": 0,
                                   "lstm_core_bwd": 0, "lstm_forward": 0}
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


LSTM_SHAPES = [
    (37, 5, 24, 20),     # tests/test_pallas_lstm.py's unaligned sizes (S, B, D, H)
    (21, 9, 12, 132),    # H > 128; lines not a multiple of the 8-line tile
    (30, 11, 192, 200),  # the class-default width: D = 4C = 192, H = 200
    (6, 3, 8, 256),      # the kernels' upper corner, 4H = 1024 threads
]


def _lstm_args(rng, s, b, d, hidden, dev, dirs=()):
    scale = hidden ** -0.5
    return (_rand(rng, (s, b, d), 1.0, dev), _rand(rng, (*dirs, d, 4 * hidden), scale, dev),
            _rand(rng, (*dirs, hidden, 4 * hidden), scale, dev),
            _rand(rng, (*dirs, 4 * hidden), scale, dev))


@pytest.mark.parametrize("s,b,d,hidden", LSTM_SHAPES)
def test_lstm_forward_kernels_match_plain(dev, s, b, d, hidden):
    """Kernels 7 and 10 against their plain versions."""
    rng = np.random.default_rng(8)
    args = _lstm_args(rng, s, b, d, hidden, dev, dirs=(2,))
    ops.reset_launch_counts()
    got = lstm_ops.bilstm_fused_forward(*args)
    torch.cuda.synchronize()
    want = lstm_ops.bilstm_fused_forward_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == (s, b, hidden) and torch.isfinite(g).all()
        assert _rel(g, w) < 1e-4
    one = [a[1] for a in args[1:]]
    for reverse in (False, True):
        got = lstm_ops.lstm_forward(args[0], *one, reverse=reverse)
        torch.cuda.synchronize()
        assert _rel(got, gridrnn.lstm_plain(args[0], *one, reverse=reverse)) < 1e-4
    assert ops.launch_counts()["bilstm_fused_forward"] == 1
    assert ops.launch_counts()["lstm_forward"] == 2


@pytest.mark.parametrize("s,b,d,hidden", LSTM_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_core_kernels_match_plain(dev, s, b, d, hidden, reverse):
    """Kernel 8's hidden states and kernel 9's four gradients against the
    plain recurrence and its autograd, under a random cotangent."""
    rng = np.random.default_rng(9)
    args = _lstm_args(rng, s, b, d, hidden, dev)
    ops.reset_launch_counts()
    h, stash = lstm_ops.lstm_core_fwd(*args, reverse=reverse)
    assert _rel(h, gridrnn.lstm_plain(*args, reverse=reverse)) < 1e-4
    cot = _rand(rng, (s, b, hidden), 1.0, dev)
    got = lstm_ops.lstm_core_bwd(*args, cot, stash=stash, reverse=reverse)
    torch.cuda.synchronize()
    want = lstm_ops.lstm_core_bwd_plain(*args, cot, reverse=reverse)
    for name, g, w in zip(("dx", "dw_ih", "dw_hh", "dbias"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < 1e-3, name
    assert ops.launch_counts()["lstm_core"] == 1
    assert ops.launch_counts()["lstm_core_bwd"] == 1


def test_lstm_core_backward_is_deterministic(dev):
    rng = np.random.default_rng(10)
    args = _lstm_args(rng, 40, 70, 192, 200, dev)
    _, stash = lstm_ops.lstm_core_fwd(*args)
    cot = _rand(rng, (40, 70, 200), 1.0, dev)
    first = lstm_ops.lstm_core_bwd(*args, cot, stash=stash)
    again = lstm_ops.lstm_core_bwd(*args, cot, stash=stash)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_gradients_flow_through_lstm_train(dev):
    """bilstm_train under autograd: kernels 8 and 9 once per direction;
    without a gradient, kernel 10 once per direction."""
    rng = np.random.default_rng(11)
    x, w_ih, w_hh, bias = _lstm_args(rng, 23, 6, 16, 40, dev, dirs=(2,))
    args = [a.requires_grad_(True) for a in (x, w_ih, w_hh, bias)]
    cot = _rand(rng, (23, 6, 80), 1.0, dev)
    ops.reset_launch_counts()
    (lstm_ops.bilstm_train(*args) * cot).sum().backward()
    assert ops.launch_counts()["lstm_core"] == 2 and ops.launch_counts()["lstm_core_bwd"] == 2
    plain = [a.detach().clone().requires_grad_(True) for a in args]
    plain_out = torch.cat(lstm_ops.bilstm_fused_forward_plain(*plain), dim=-1)
    (plain_out * cot).sum().backward()
    for a, p in zip(args, plain):
        assert a.grad is not None and _rel(a.grad, p.grad) < 1e-3
    with torch.no_grad():
        out = lstm_ops.bilstm_train(*args)
    assert ops.launch_counts()["lstm_forward"] == 2
    assert _rel(out, plain_out.detach()) < 1e-4


def test_lstm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(12)
    x, w_ih, w_hh, bias = _lstm_args(rng, 7, 3, 8, 16, dev, dirs=(2,))
    with pytest.raises(ValueError, match="cpu"):  # a device mix
        lstm_ops.bilstm_fused_forward(x, w_ih.cpu(), w_hh, bias)
    with pytest.raises(ValueError, match="H=257"):
        big = _lstm_args(rng, 2, 1, 4, 257, dev, dirs=(2,))
        lstm_ops.bilstm_fused_forward(*big)
    with pytest.raises(ValueError):
        lstm_ops.lstm_forward(x, w_ih, w_hh, bias)  # packed weights into one direction
    w = w_ih.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        lstm_ops.bilstm_fused_forward(x, w, w_hh, bias)
    with pytest.raises(RuntimeError, match="no backward"):
        lstm_ops.lstm_forward(x, w[0], w_hh[0], bias[0])
    with torch.no_grad():  # the serving path runs under no_grad
        lstm_ops.bilstm_fused_forward(x, w, w_hh, bias)


def test_small_wide_train_step_kernel_route_matches_plain(dev):
    """Outside the gate (C = 48, H = 132): one training step through kernels
    8 and 9 against the all-plain route."""
    from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    cfg = FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=64, hop_length=32, num_frames=16)
    torch.manual_seed(0)
    fdbms = []
    for use_kernels in (True, False):
        fdbm = FDBM(cfg, device="cuda")
        fdbm.dnn = TFGridNet(n_layers=1, emb_dim=48, hidden=132,
                             use_kernels=use_kernels).to(dev)
        fdbms.append(fdbm)
    fdbms[1].dnn.load_state_dict(fdbms[0].dnn.state_dict())
    rng = np.random.default_rng(13)
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
    assert ops.launch_counts()["lstm_core"] == 4
    assert ops.launch_counts()["lstm_core_bwd"] == 4
    assert ops.launch_counts()["grid_fold_train_pair"] == 0
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads[1].values())))
    worst = max(_grad_rel(grads[0][k], grads[1][k], gnorm) for k in grads[1])
    assert worst < 1e-3


# -- the cluster kernels: frame_attention (one launch) and the LSTM recurrence --

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t", [1, 7, 257, 1900])
@pytest.mark.parametrize("d", [8, 12])
def test_frame_attention_is_one_launch_without_scores_in_memory(dev, b, t, d):
    """At the main path's widths (Q = 257, 4 heads, E = 2, D = 8 or 12): the
    kernel against its plain version, one kernel on the card per call, and
    no [B, H, T, T] scores: the call allocates its output and nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(20)
    q = _rand(rng, (b, t, 257, 8), 1.0, dev)
    k = _rand(rng, (b, t, 257, 8), 1.0, dev)
    v = _rand(rng, (b, t, 257, 4 * d), 1.0, dev)
    attn_ops.frame_attention(q, k, v, 4, 2)  # builds, plans
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n0 = attn_ops.frame_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = attn_ops.frame_attention(q, k, v, 4, 2)
        torch.cuda.synchronize()
    assert attn_ops.frame_attention.launches == n0 + 1
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
    assert torch.cuda.max_memory_allocated(dev) - base <= got.numel() * 4 + (2 << 20)
    assert _rel(got, attn_ops.frame_attention_plain(q, k, v, 4, 2)) < 1e-4


def test_attention_layouts_match_the_kernel(dev):
    """ops.attention mirrors the kernel's shared-memory layout (the plans
    are chosen and tested on it); the kernel's own count must agree."""
    for t, e, d in ((1, 2, 8), (257, 2, 8), (257, 2, 12), (1900, 2, 8), (5000, 2, 8),
                    (33, 4, 8), (70, 2, 6)):
        for rows in (8, 16, 24, 40, 64):
            for slices in (1, 2, 3, 4):
                lay = attn_ops.attention_layout(t, 257, e, d, rows, slices)
                want = lay[1] if lay else -1
                assert attn_ops.frame_attention_smem(t, 257, e, d, rows, slices) == want


def test_attention_plans_the_card_cannot_launch_are_refused(dev):
    """A plan that does not fit is refused by the kernel's entry (the
    wrapper raises on any refusal), never run short; above the frame limit
    the wrapper raises before launching."""
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(21)
    q = _rand(rng, (1, 257, 257, 8), 1.0, dev)
    v = _rand(rng, (1, 257, 257, 32), 1.0, dev)
    out = torch.empty_like(v)
    lib = _build.load("attention", attn_ops._SIGNATURES, attn_ops._RESTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows, slices in ((64, 1), (12, 1), (8, 9)):  # too much shared memory; not plans
        code = lib.frame_attention(q.data_ptr(), q.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                                   257, 257, 4, 2, 8, 0.05, rows, slices, stream)
        assert code != 0, (rows, slices)
    with pytest.raises(ValueError, match="limit"):
        long = _rand(rng, (1, 6000, 257, 8), 1.0, dev)
        attn_ops.frame_attention(long, long, long, 4, 2)


def _lstm_stash_plain(x, w_ih, w_hh, bias, reverse):
    """The recurrence step by step: hidden states, activated gates (i, f, g,
    o) and cell states, each in time order: what kernel 8 stashes."""
    s, b, _ = x.shape
    hidden = w_hh.shape[0]
    xp = x @ w_ih + bias
    h = x.new_zeros(b, hidden)
    c = x.new_zeros(b, hidden)
    hs, gs, cs = [None] * s, [None] * s, [None] * s
    for p in (range(s - 1, -1, -1) if reverse else range(s)):
        z = xp[p] + h @ w_hh
        i, f, g, o = z.split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[p], gs[p], cs[p] = h, torch.cat([i, f, g, o], dim=-1), c
    return torch.stack(hs), torch.stack(gs), torch.stack(cs)


@pytest.mark.parametrize("hidden", [200, 197])
@pytest.mark.parametrize("lines", [13, 70, 262])
def test_lstm_recurrence_matches_plain(dev, hidden, lines):
    """Kernels 7, 8 (its stash included) and 10 on the cluster recurrence:
    H = 200 (the class-default width) and 197 (not a multiple of the
    cluster), lines not a multiple of the tile, both directions."""
    rng = np.random.default_rng(22)
    x, w_ih, w_hh, bias = _lstm_args(rng, 31, lines, 192, hidden, dev, dirs=(2,))
    with torch.no_grad():
        got = lstm_ops.bilstm_fused_forward(x, w_ih, w_hh, bias)
        want = lstm_ops.bilstm_fused_forward_plain(x, w_ih, w_hh, bias)
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-4
        one = (w_ih[1], w_hh[1], bias[1])
        for reverse in (False, True):
            assert _rel(lstm_ops.lstm_forward(x, *one, reverse=reverse),
                        gridrnn.lstm_plain(x, *one, reverse)) < 1e-4
            h, (h2, gates, c) = lstm_ops.lstm_core_fwd(x, *one, reverse=reverse)
            want_h, want_g, want_c = _lstm_stash_plain(x, *one, reverse)
            assert h is h2
            assert _rel(h, want_h) < 1e-4
            assert _rel(gates, want_g) < 1e-4
            assert _rel(c, want_c) < 1e-4


def test_recurrence_layouts_match_the_kernel(dev):
    for hidden in (1, 20, 132, 197, 200, 256):
        for cs in lstm_ops.REC_CLUSTERS + (3, 16):
            for tile in lstm_ops.REC_LINES + (6,):
                lay = lstm_ops.recurrence_layout(hidden, cs, tile)
                assert lstm_ops.recurrence_smem(hidden, cs, tile) == (lay[1] if lay else -1)


def test_recurrence_plan_is_one_wave_on_the_card(dev):
    """The main-path shapes (262 lines in one or two directions, 524 with
    the stash) run in one wave of clusters on this card."""
    for lines, dirs, stash in ((262, 1, False), (262, 2, False), (524, 1, True)):
        plan = lstm_ops.recurrence_plan(lines, dirs, 200, stash, dev)
        assert plan.clusters <= plan.max_clusters, plan


def test_recurrence_plans_the_card_cannot_launch_are_refused(dev):
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(23)
    x, w_ih, w_hh, bias = _lstm_args(rng, 9, 10, 16, 200, dev)
    xp, h, c = (torch.empty(9, 10, n, device=dev) for n in (800, 200, 200))
    lib = _build.load("lstm", lstm_ops._SIGNATURES, lstm_ops._RESTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (x, w_ih, w_hh, bias)]
    for cs, tile in ((1, 24), (2, 8), (16, 8), (4, 6), (4, 28)):
        assert lib.lstm_forward(*ptrs, xp.data_ptr(), h.data_ptr(), 9, 10, 16, 200, 1, 0, cs,
                                tile, stream) != 0, (cs, tile)
        assert lib.lstm_train_fwd(*ptrs, xp.data_ptr(), h.data_ptr(), c.data_ptr(), 9, 10, 16,
                                  200, 0, cs, tile, stream) != 0, (cs, tile)
    torch.cuda.synchronize()


# -- the cluster kernels of kernel 1 (the fused recurrence) and kernel 9 (the sweep) --

@pytest.mark.parametrize("s", [4, 23])
@pytest.mark.parametrize("hidden", [1, 100, 128])
@pytest.mark.parametrize("c", [8, 32, 64])
def test_fused_grid_rnn_matches_plain(dev, c, hidden, s):
    """Kernel 1 on its fused cluster recurrence at the gate's widths, on
    13 lines of two canvas items (a tile of lines crosses from one item to
    the next, and 13 is no multiple of a tile), S = 4 (one window) and 23;
    one launch per call, and no buffer beside hs and the outputs."""
    rng = np.random.default_rng(24)
    x = _rand(rng, (2, s, 13, c), 0.5, dev)[:, :, :13]
    x = x.contiguous()
    w = (_rand(rng, (2, 4 * c, 4 * hidden), 0.1, dev),
         _rand(rng, (2, hidden, 4 * hidden), 0.1, dev),
         _rand(rng, (2, 4 * hidden), 0.1, dev), _rand(rng, (2 * hidden, 4 * c), 0.1, dev))
    with torch.no_grad():
        gridrnn.grid_rnn_seq1_pair(x, *w)  # builds, plans
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = gridrnn.grid_rnn_seq1_pair.launches
        got = gridrnn.grid_rnn_seq1_pair(x, *w)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated(dev) - base
        assert gridrnn.grid_rnn_seq1_pair.launches == n0 + 1
        hs = 2 * 2 * 13 * (s - 3) * hidden * 4
        assert used <= 2 * x.numel() * 4 + hs + (2 << 20)
        want = gridrnn.grid_rnn_seq1_pair_plain(x, *w)
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, r) < 1e-4


def test_fused_layouts_match_the_kernel(dev):
    for c in (8, 32, 64):
        for hidden in (1, 80, 100, 128):
            for cs in gridrnn.CLUSTERS + (3,):
                for tile in gridrnn.FUSED_LINES + (6, 20):
                    lay = gridrnn.fused_layout(c, hidden, cs, tile)
                    assert gridrnn.fused_smem(c, hidden, cs, tile) == (lay[1] if lay else -1)


def test_fused_plan_is_one_wave_on_the_card(dev):
    """The main path's call (263 lines of a 4 s request, C = 32, H = 100)
    and tfgridnet_4l32c80's run in one wave of clusters on this card."""
    for c, hidden in ((32, 100), (32, 80)):
        plan = gridrnn.fused_plan(263, c, hidden, dev)
        assert plan.clusters <= plan.max_clusters, plan


def test_fused_plans_the_card_cannot_launch_are_refused(dev):
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(25)
    x = _rand(rng, (1, 12, 9, 64), 0.5, dev)
    w = [_rand(rng, shape, 0.1, dev) for shape in ((2, 256, 512), (2, 128, 512), (2, 512),
                                                   (256, 256))]
    hs, out = torch.empty(2, 9, 9, 128, device=dev), torch.empty_like(x)
    lib = _build.load("gridrnn", gridrnn._SIGNATURES, gridrnn._RESTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cs, tile in ((1, 4), (2, 8), (16, 4), (4, 6), (4, 20)):  # too large; not plans
        code = lib.gridrnn_seq1_pair(x.data_ptr(), *(t.data_ptr() for t in w), hs.data_ptr(),
                                     out.data_ptr(), out.data_ptr(), 1, 12, 9, 64, 128, cs, tile,
                                     stream)
        assert code != 0, (cs, tile)
    torch.cuda.synchronize()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lines", [13, 70, 524])
@pytest.mark.parametrize("hidden", [200, 197])
def test_lstm_sweep_matches_plain(dev, hidden, lines, reverse):
    """Kernel 9 on its cluster sweep: H = 200 (the class-default width) and
    197 (not a multiple of the cluster or of four), lines not a multiple of
    the tile and the main path's 524, both directions."""
    rng = np.random.default_rng(26)
    args = _lstm_args(rng, 9, lines, 192, hidden, dev)
    _, stash = lstm_ops.lstm_core_fwd(*args, reverse=reverse)
    cot = _rand(rng, (9, lines, hidden), 1.0, dev)
    got = lstm_ops.lstm_core_bwd(*args, cot, stash=stash, reverse=reverse)
    torch.cuda.synchronize()
    want = lstm_ops.lstm_core_bwd_plain(*args, cot, reverse=reverse)
    for name, g, w in zip(("dx", "dw_ih", "dw_hh", "dbias"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < 1e-3, name


def test_lstm_sweep_is_deterministic_at_the_main_path_width(dev):
    rng = np.random.default_rng(27)
    args = _lstm_args(rng, 12, 524, 192, 200, dev)
    _, stash = lstm_ops.lstm_core_fwd(*args)
    cot = _rand(rng, (12, 524, 200), 1.0, dev)
    first = lstm_ops.lstm_core_bwd(*args, cot, stash=stash)
    again = lstm_ops.lstm_core_bwd(*args, cot, stash=stash)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_sweep_layouts_match_the_kernel(dev):
    for hidden in (1, 20, 132, 197, 200, 256):
        for cs in lstm_ops.REC_CLUSTERS + (3, 16):
            for tile in lstm_ops.REC_LINES + (6, 28):
                lay = lstm_ops.sweep_layout(hidden, cs, tile)
                assert lstm_ops.sweep_smem(hidden, cs, tile) == (lay[1] if lay else -1)


def test_sweep_plan_is_one_wave_on_the_card(dev):
    plan = lstm_ops.sweep_plan(524, 200, dev)
    assert plan.clusters <= plan.max_clusters, plan


def test_sweep_plans_the_card_cannot_launch_are_refused(dev):
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(28)
    x, w_ih, w_hh, bias = _lstm_args(rng, 5, 10, 16, 200, dev)
    _, (h, gates, c) = lstm_ops.lstm_core_fwd(x, w_ih, w_hh, bias)
    lib = _build.load("lstm", lstm_ops._SIGNATURES, lstm_ops._RESTYPES)
    dgates, dx = torch.empty_like(gates), torch.empty_like(x)
    work = torch.empty(lib.lstm_train_bwd_workspace(5, 10, 16, 200), device=dev)
    dwg = torch.empty(16 + 200 + 1, 800, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cs, tile in ((1, 8), (2, 8), (16, 8), (4, 6), (4, 28)):
        code = lib.lstm_train_bwd(x.data_ptr(), h.data_ptr(), c.data_ptr(), gates.data_ptr(),
                                  h.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
                                  dgates.data_ptr(), work.data_ptr(), dx.data_ptr(),
                                  dwg.data_ptr(), 5, 10, 16, 200, 0, cs, tile, stream)
        assert code != 0, (cs, tile)
    torch.cuda.synchronize()


# -- kernels 5 and 6 on their cluster plans (the training pair) --

def _train_pair_check(args, cot, stash_plan=None, sweep_plan=None):
    """Kernel 5's outputs and stash, then kernel 6's five gradients, against
    the plain versions; with a plan (cs, lines) given, through the C entries
    at that plan instead of the card's choice."""
    from fdbm_tpu_torch.ops import _build

    x = args[0]
    s, lines, c = x.shape
    hidden = args[2].shape[1]
    length = s - 3
    want = gridrnn_train.grid_fold_train_pair_plain(*args)
    if stash_plan is None:
        outf, outb, stash = gridrnn_train.grid_fold_train_pair_fwd(*args)
    else:
        lib = _build.load("gridrnn", gridrnn_train._FWD_SIGNATURES)
        stash = (torch.empty(2, lines, length, hidden, 4, device=x.device),
                 torch.empty(2, lines, length, hidden, device=x.device),
                 torch.empty(2, lines, length, hidden, device=x.device))
        outf, outb = torch.empty_like(x), torch.empty_like(x)
        code = lib.grid_fold_train_fwd(*(t.data_ptr() for t in args),
                                       *(t.data_ptr() for t in stash), outf.data_ptr(),
                                       outb.data_ptr(), s, lines, c, hidden, *stash_plan,
                                       torch.cuda.current_stream(x.device).cuda_stream)
        assert code == 0, stash_plan
    for g, w in zip((outf, outb), want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) < 1e-4
    # The stash: the activated gates, h and c of the plain recurrence.
    _, hs, cst = stash
    assert torch.isfinite(hs).all() and torch.isfinite(cst).all()
    if sweep_plan is None:
        got = gridrnn_train.grid_fold_train_pair_bwd(*args, *cot, stash=stash)
    else:
        lib = _build.load("gridrnn_train", gridrnn_train._SIGNATURES, gridrnn_train._RESTYPES)
        dgates = torch.empty(2, lines, length, 4 * hidden, device=x.device)
        work = torch.empty(lib.grid_fold_train_bwd_workspace(s, lines, c, hidden),
                           device=x.device)
        got = (torch.empty_like(x), torch.empty(2, 4 * c, 4 * hidden, device=x.device),
               torch.empty(2, hidden, 4 * hidden, device=x.device),
               torch.empty(2, 4 * hidden, device=x.device),
               torch.empty(2 * hidden, 4 * c, device=x.device))
        w_ih, w_hh, wd = args[1], args[2], args[4]
        code = lib.grid_fold_train_bwd(
            x.data_ptr(), cot[0].data_ptr(), cot[1].data_ptr(),
            *(t.data_ptr() for t in stash), w_ih.data_ptr(), w_hh.data_ptr(), wd.data_ptr(),
            dgates.data_ptr(), work.data_ptr(), *(g.data_ptr() for g in got), s, lines, c,
            hidden, *sweep_plan, torch.cuda.current_stream(x.device).cuda_stream)
        assert code == 0, sweep_plan
    torch.cuda.synchronize()
    want = gridrnn_train.grid_fold_train_pair_bwd_plain(*args, *cot)
    for name, g, w in zip(("dx", "dw_ih", "dw_hh", "dbias", "dwd"), got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        if float(w.norm()) == 0:  # dW_hh at L = 1: no step consumes a state
            assert float(g.abs().max()) == 0, name
        else:
            assert _rel(g, w) < 1e-3, name


@pytest.mark.parametrize("s,lines,c,hidden", [
    (23, 13, 32, 100),    # lines not a multiple of the tile
    (23, 70, 32, 100),
    (12, 13, 64, 128),    # the gate's corner: clusters of 4 or 8
    (23, 13, 16, 24),     # H not a multiple of 8
    (17, 21, 8, 1),
    (4, 13, 32, 100),     # S = 4: one window
    (5, 70, 32, 100),     # S = 5: two windows
    (5, 13, 64, 128),
])
def test_train_pair_kernels_match_plain_at_the_plans_edges(dev, s, lines, c, hidden):
    """Kernels 5 and 6 at the card's plans, every row and gradient against
    the plain pipeline under a random cotangent on every row."""
    rng = np.random.default_rng(40)
    args = _rnn_args(rng, s, lines, c, hidden, dev)
    cot = (_rand(rng, (s, lines, c), 1.0, dev), _rand(rng, (s, lines, c), 1.0, dev))
    _train_pair_check(args, cot)


@pytest.mark.parametrize("c,hidden", [(32, 100), (16, 24), (64, 128)])
def test_train_pair_kernels_match_plain_on_every_plan(dev, c, hidden):
    """Every plan (blocks per cluster, lines per tile) that fits a block, on
    21 lines (a partial tile), H spread unevenly over the ranks where it
    does not divide (H = 100 on 8 ranks, H = 24 on 8)."""
    rng = np.random.default_rng(41)
    args = _rnn_args(rng, 9, 21, c, hidden, dev)
    cot = (_rand(rng, (9, 21, c), 1.0, dev), _rand(rng, (9, 21, c), 1.0, dev))
    fwd = [(cs, t) for cs in gridrnn.CLUSTERS for t in gridrnn.FUSED_LINES
           if gridrnn.fused_layout(c, hidden, cs, t)]
    bwd = [(cs, t) for cs in gridrnn.CLUSTERS for t in gridrnn_train.SWEEP_LINES
           if gridrnn_train.train_sweep_layout(c, hidden, cs, t)]
    assert fwd and bwd
    for i, plan in enumerate(bwd):
        _train_pair_check(args, cot, fwd[i % len(fwd)], plan)


def test_train_backward_is_deterministic_at_the_main_path_width(dev):
    """Kernel 6 on its main-path plan (524 lines, C = 32, H = 100): two calls
    give the same bits."""
    rng = np.random.default_rng(42)
    args = _rnn_args(rng, 12, 524, 32, 100, dev)
    _, _, stash = gridrnn_train.grid_fold_train_pair_fwd(*args)
    cot = (_rand(rng, (12, 524, 32), 1.0, dev), _rand(rng, (12, 524, 32), 1.0, dev))
    first = gridrnn_train.grid_fold_train_pair_bwd(*args, *cot, stash=stash)
    again = gridrnn_train.grid_fold_train_pair_bwd(*args, *cot, stash=stash)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_train_sweep_layouts_match_the_kernel(dev):
    for c in (8, 24, 32, 64):
        for hidden in (1, 24, 80, 100, 128):
            for cs in gridrnn.CLUSTERS + (3,):
                for tile in gridrnn_train.SWEEP_LINES + (4, 12):
                    lay = gridrnn_train.train_sweep_layout(c, hidden, cs, tile)
                    assert gridrnn_train.train_sweep_smem(c, hidden, cs, tile) == (
                        lay[1] if lay else -1)


def test_train_plans_are_one_wave_on_the_card(dev):
    """A 5l32c100 training step's two RNN paths: 524 (intra) and 526
    (inter) lines a direction at C = 32, H = 100."""
    for lines in (524, 526):
        for plan in (gridrnn_train.train_fwd_plan(lines, 32, 100, dev),
                     gridrnn_train.train_sweep_plan(lines, 32, 100, dev)):
            assert plan.clusters <= plan.max_clusters, plan


def test_train_plans_the_card_cannot_launch_are_refused(dev):
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(43)
    args = _rnn_args(rng, 9, 10, 64, 128, dev)
    x = args[0]
    stash = (torch.empty(2, 10, 6, 128, 4, device=dev), torch.empty(2, 10, 6, 128, device=dev),
             torch.empty(2, 10, 6, 128, device=dev))
    out = torch.empty_like(x)
    fwd = _build.load("gridrnn", gridrnn_train._FWD_SIGNATURES)
    bwd = _build.load("gridrnn_train", gridrnn_train._SIGNATURES, gridrnn_train._RESTYPES)
    dgates = torch.empty(2, 10, 6, 512, device=dev)
    work = torch.empty(bwd.grid_fold_train_bwd_workspace(9, 10, 64, 128), device=dev)
    grads = [torch.empty(n, device=dev) for n in (2 * 256 * 512, 2 * 128 * 512, 2 * 512,
                                                  256 * 256)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cs, tile in ((1, 8), (2, 16), (16, 8), (4, 4), (4, 12)):  # too large; not plans
        code = fwd.grid_fold_train_fwd(*(t.data_ptr() for t in args),
                                       *(t.data_ptr() for t in stash), out.data_ptr(),
                                       out.data_ptr(), 9, 10, 64, 128, cs, tile, stream)
        assert code != 0, (cs, tile)
        code = bwd.grid_fold_train_bwd(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in stash),
            args[1].data_ptr(), args[2].data_ptr(), args[4].data_ptr(), dgates.data_ptr(),
            work.data_ptr(), out.data_ptr(), *(g.data_ptr() for g in grads), 9, 10, 64, 128,
            cs, tile, stream)
        assert code != 0, (cs, tile)
    torch.cuda.synchronize()
