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

The bf16 forms of kernels 1, 2, 3 and 7 (``inference_dtype: bfloat16``) are
held to their bf16 plain versions within rel-L2 2e-3, 3e-5, 2.5e-4 and 1e-3
(the sums' order moves a value across a bf16 rounding boundary now and
then, one bf16 step of that value, and the recurrences carry it on; the
limits are chip_smoke.py's), and their distance to a float64 run of the
plain version within 1.5x the plain bf16 version's plus 1e-3. For kernels
1, 3 and 7 the up-cast control, the fp32 form on the same bf16 inputs with
its output rounded to bf16, must miss the limit: a bf16 form that skipped
the bf16 rounding of the weights, of h or of P would pass as it.
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
    (3, 5, 4, 2), (2, 257, 4, 8), (7, 3, 2, 1), (1, 9, 4, 32),
    (3, 5, 1, 1),     # 30 elements: the map ends in a partial float4
    (5, 7, 3, 64)])
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


NORM_WIDTHS = (1, 2, 4, 8, 16, 32, 64)


@pytest.mark.parametrize("n_head", [3, 4])
@pytest.mark.parametrize("width", NORM_WIDTHS)
def test_flat_group_norms_match_plain(dev, width, n_head):
    """Three maps in one launch: unequal sizes that are no multiple of a
    block's 256 float4s (the last one the main path's v at this width), a
    second width in the middle map, three heads (a period of 3 x width
    lanes) and four; each map against the plain version."""
    rng = np.random.default_rng(7)
    other = NORM_WIDTHS[(NORM_WIDTHS.index(width) + 3) % len(NORM_WIDTHS)]
    maps = []
    for (b, t, q_bins), w in (((1, 5, 3), width), ((2, 37, 11), other), ((1, 257, 257), width)):
        maps.append((_rand(rng, (b, t, q_bins * n_head * w), 1.0, dev),
                     _rand(rng, (n_head, 1), 0.3, dev), _rand(rng, (n_head, w), 1.0, dev),
                     _rand(rng, (n_head, w), 1.0, dev), w))
    n0 = attn_ops.flat_group_norm.launches
    got = attn_ops.flat_group_norms(maps)
    torch.cuda.synchronize()
    assert attn_ops.flat_group_norm.launches == n0 + 1
    for g, m in zip(got, maps):
        assert g.shape == m[0].shape and g.data_ptr() % 16 == 0
        assert _rel(g, attn_ops.flat_group_norm_plain(*m[:4], width=m[4])) < 1e-5
    # one map, and two, through the same entry
    for some in (maps[1:2], maps[:2]):
        for g, m in zip(attn_ops.flat_group_norms(some), some):
            assert _rel(g, attn_ops.flat_group_norm_plain(*m[:4], width=m[4])) < 1e-5


def test_flat_group_norms_refuse_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 3, 5 * 4 * 2, device=dev)
    norm = (torch.zeros(4, 1, device=dev), torch.ones(4, 2, device=dev),
            torch.zeros(4, 2, device=dev), 2)
    with pytest.raises(ValueError, match="1 to 3 maps"):
        attn_ops.flat_group_norms([(x, *norm)] * 4)
    with pytest.raises(ValueError, match="power of two"):
        attn_ops.flat_group_norms([(x, *norm), (x, *norm[:3], 12)])
    shifted = torch.zeros(124, device=dev)[2:122].view(1, 3, 40)  # 8 bytes off
    with pytest.raises(ValueError, match="16-byte boundary"):
        attn_ops.flat_group_norms([(x, *norm), (shifted, *norm)])
    with pytest.raises(ValueError, match="shape"):
        attn_ops.flat_group_norms([(x, norm[0], norm[1][:2], norm[2], 2)])


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
    # per block: two RNN paths, one launch of the norms of q, k and v, one attention
    assert ops.launch_counts() == {"grid_rnn_seq1_pair": 4, "flat_group_norm": 2,
                                   "frame_attention": 2, "grid_bilstm_fold": 0,
                                   "grid_fold_train_pair": 0, "grid_fold_train_pair_bwd": 0,
                                   "bilstm_fused_forward": 0, "lstm_core": 0,
                                   "lstm_core_bwd": 0, "lstm_forward": 0,
                                   "grid_rnn_seq1_pair_bf16": 0, "flat_group_norm_bf16": 0,
                                   "frame_attention_bf16": 0, "bilstm_fused_forward_bf16": 0}
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
    with pytest.raises(RuntimeError, match="no backward"):
        attn_ops.flat_group_norms([(q.detach().reshape(1, 4, 24), *norm, 2)])
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
    no [B, H, T, T] scores: the call allocates its output and nothing else.
    The profiler sometimes records no kernel at all around a call, so each
    of four calls is profiled on its own: every call whose kernels were
    recorded shows one kernel, at least one call's were, and the launch
    counter rises by one a call."""
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
    recorded = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = attn_ops.frame_attention(q, k, v, 4, 2)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        recorded.append(sum(e.count for e in kernels))
        del got
    assert attn_ops.frame_attention.launches == n0 + 4
    assert max(recorded) == 1 and all(n in (0, 1) for n in recorded), recorded
    got = attn_ops.frame_attention(q, k, v, 4, 2)
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


def test_fused_grid_rnn_matches_plain_over_many_waves(dev):
    """Kernel 1 at the folder's batch of 16 rows: 16 x 263 lines of each
    direction, about eight waves of clusters on this card at C = 32,
    H = 100, on a short canvas (S = 23); every row of the batch against the
    plain version, and one row against the same row run alone."""
    rng = np.random.default_rng(26)
    x = _rand(rng, (16, 23, 263, 32), 0.5, dev)
    w = (_rand(rng, (2, 128, 400), 0.1, dev), _rand(rng, (2, 100, 400), 0.1, dev),
         _rand(rng, (2, 400), 0.1, dev), _rand(rng, (200, 128), 0.1, dev))
    plan = gridrnn.fused_plan(16 * 263, 32, 100, dev)
    assert plan.clusters > 4 * plan.max_clusters, plan
    with torch.no_grad():
        got = gridrnn.grid_rnn_seq1_pair(x, *w)
        want = gridrnn.grid_rnn_seq1_pair_plain(x, *w)
        alone = gridrnn.grid_rnn_seq1_pair(x[11:12].contiguous(), *w)
    for g, r, a in zip(got, want, alone):
        for row in range(16):
            assert _rel(g[row], r[row]) < 1e-4, row
        assert _rel(g[11:12], a) < 1e-4


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


# -- kernel 4: the summed fold on kernel 1's fused recurrence --

@pytest.mark.parametrize("s,lines,c,hidden", [
    (23, 13, 32, 100),    # lines not a multiple of the tile
    (23, 70, 32, 100),
    (12, 13, 64, 128),    # the gate's corner: clusters of 4 or 8
    (12, 70, 64, 128),
    (17, 21, 8, 1),       # H = 1
    (4, 13, 32, 100),     # S = 4: one window
    (5, 70, 32, 100),     # S = 5: two windows
    (5, 13, 64, 128),
])
def test_bilstm_fold_matches_plain_at_the_plans_edges(dev, s, lines, c, hidden):
    """Kernel 4 at the card's plan (kernel 1's), every row against the
    plain pipeline; one launch, and no buffer beside hs and the output (no
    pre-activations in device memory)."""
    rng = np.random.default_rng(44)
    args = _rnn_args(rng, s, lines, c, hidden, dev)
    with torch.no_grad():
        gridrnn.grid_bilstm_fold(*args)  # builds, plans
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = gridrnn.grid_bilstm_fold.launches
        got = gridrnn.grid_bilstm_fold(*args)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated(dev) - base
        assert gridrnn.grid_bilstm_fold.launches == n0 + 1
        hs = 2 * lines * (s - 3) * hidden * 4
        assert used <= args[0].numel() * 4 + hs + (2 << 20)
        want = gridrnn.grid_bilstm_fold_plain(*args)
    assert torch.isfinite(got).all()
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("c,hidden", [(32, 100), (16, 24), (64, 128), (8, 1)])
def test_bilstm_fold_matches_plain_on_every_plan(dev, c, hidden):
    """Every plan (blocks per cluster, lines per tile) that fits a block,
    forced through the entry on 21 lines (a partial tile); a plan that is
    none is refused."""
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(45)
    args = _rnn_args(rng, 9, 21, c, hidden, dev)
    want = gridrnn.grid_bilstm_fold_plain(*args)
    lib = _build.load("gridrnn", gridrnn._FOLD_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plans = [(cs, t) for cs in gridrnn.CLUSTERS for t in gridrnn.FUSED_LINES
             if gridrnn.fused_layout(c, hidden, cs, t)]
    assert plans
    for cs, tile in plans + [(3, 8), (2, 12)]:
        hs = torch.empty(2, 21, 6, hidden, device=dev)
        out = torch.full_like(args[0], float("nan"))
        code = lib.grid_bilstm_fold(*(t.data_ptr() for t in args), hs.data_ptr(),
                                    out.data_ptr(), 9, 21, c, hidden, cs, tile, stream)
        if (cs, tile) not in plans:
            assert code != 0, (cs, tile)
            continue
        assert code == 0, (cs, tile)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), (cs, tile)
        assert _rel(out, want) < 1e-4, (cs, tile)


def test_small_backbone_finetuning_step_kernel_route_matches_plain(dev):
    """One fine-tuning step (N=3 on ``bb``): the first two calls on the
    serving kernels without a gradient, the last on the training kernels.
    The unroll carries each call's fp32 rounding into the next call's input,
    so both fp32 routes are held against the plain route in float64: the
    kernel route's loss and worst gradient leaf no farther from it than
    max(floor, 3 x the plain fp32 route's)."""
    from fdbm_tpu_torch import losses
    from fdbm_tpu_torch.model import FDBM, FDBMConfig
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    cfg = FDBMConfig(mode="finetuning", sampler_type="ode_ei", N=3, n_fft=64, hop_length=32,
                     num_frames=16)
    torch.manual_seed(0)
    fdbms = []
    for use_kernels in (True, False, False):
        fdbm = FDBM(cfg, device="cuda")
        fdbm.dnn = TFGridNet(n_layers=2, emb_dim=16, hidden=24, use_kernels=use_kernels).to(dev)
        fdbms.append(fdbm)
    for fdbm in fdbms[1:]:
        fdbm.dnn.load_state_dict(fdbms[0].dnn.state_dict())
    fdbms[2].dnn.double()
    rng = np.random.default_rng(8)
    audio = rng.standard_normal((2, 2, 15 * 32)).astype(np.float32) * 0.3
    x, y = (fdbms[0].audio_to_spec(torch.as_tensor(a, device=dev)) for a in audio)
    z = torch.complex(*(_rand(rng, tuple(y.shape), 0.7, dev) for _ in range(2)))
    results = []
    for fdbm, cdt in zip(fdbms, (torch.complex64, torch.complex64, torch.complex128)):
        params = {n: p for n, p in fdbm.dnn.named_parameters() if p.requires_grad}
        ops.reset_launch_counts()
        out = fdbm._finetune_unrolled(y.to(cdt), z=z.to(cdt))
        loss = losses.compute_loss(fdbm.loss_cfg, out, x.to(cdt))
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((float(loss.detach()), {n: g.double() for n, g in zip(params, grads)},
                        ops.launch_counts()))
    assert results[0][2] == {**results[2][2], "grid_rnn_seq1_pair": 8, "flat_group_norm": 4,
                             "frame_attention": 4, "grid_fold_train_pair": 4,
                             "grid_fold_train_pair_bwd": 4}
    loss64, g64, _ = results[2]
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in g64.values())))
    loss_err = [abs(r[0] - loss64) / abs(loss64) for r in results[:2]]
    grad_err = [max(_grad_rel(r[1][k], g64[k], gnorm) for k in g64) for r in results[:2]]
    assert loss_err[0] <= max(1e-6, 3 * loss_err[1]), loss_err
    assert grad_err[0] <= max(1e-3, 3 * grad_err[1]), grad_err


def test_pesq_on_the_card_matches_the_cpu(dev):
    """A 4 s pair (and a noisier one) through pesq_mos on the card and on
    the CPU: MOS within 1e-4 (fp32 with TF32 off on both); the loss's
    gradient on the card is finite and nonzero."""
    from fdbm_tpu_torch import pesq_loss

    rng = np.random.default_rng(9)
    t = np.arange(64000) / 16000
    ref = sum(np.sin(2 * np.pi * 120 * k * t) / k for k in range(1, 20))
    ref = ref * (np.sin(2 * np.pi * 3 * t) > -0.3) * 0.05
    ref = np.stack([ref, ref]).astype(np.float32)
    deg = (ref + np.array([[0.002], [0.02]]) * rng.standard_normal(ref.shape)).astype(np.float32)
    ref_t, deg_t = torch.as_tensor(ref), torch.as_tensor(deg)
    card = pesq_loss.pesq_mos(ref_t.to(dev), deg_t.to(dev)).cpu()
    cpu = pesq_loss.pesq_mos(ref_t, deg_t)
    assert torch.isfinite(card).all() and float((card - cpu).abs().max()) < 1e-4
    d = deg_t.to(dev).requires_grad_(True)
    pesq_loss.pesq_loss(ref_t.to(dev), d).sum().backward()
    assert torch.isfinite(d.grad).all() and float(d.grad.norm()) > 0


# -- the bf16 forms of kernels 1, 2, 3 and 7 ------------------------------------------------


BF16_TOLS = {"grid_rnn_seq1_pair": 2e-3, "flat_group_norm": 3e-5, "frame_attention": 2.5e-4,
             "bilstm_fused_forward": 1e-3}


def _bf16_gates(tol, got, plain, f64, upcast=None):
    """rel-L2 to the bf16 plain version within ``tol``, and no further from
    float64 than 1.5x the plain version plus 1e-3; ``upcast`` (the fp32
    form's output on the same inputs) rounded to bf16 misses ``tol``."""
    got, plain, f64 = (torch.as_tensor(a).double() for a in (got, plain, f64))
    assert _rel(got, plain) <= tol
    assert _rel(got, f64) <= 1.5 * _rel(plain, f64) + 1e-3
    if upcast is not None:
        assert _rel(upcast.to(torch.bfloat16).double(), plain) > tol


def _bf16_counts_moved(name, before):
    """Only ``name``'s bf16 form launched, once, since ``before``."""
    after = ops.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {f"{name}_bf16": 1}, moved


@pytest.mark.parametrize("b,s,p,c,hidden", [
    (2, 35, 12, 8, 24), (2, 35, 12, 16, 24), (1, 70, 5, 32, 100), (1, 12, 7, 64, 128),
    (2, 263, 9, 32, 100)])
def test_grid_rnn_bf16_matches_plain(dev, b, s, p, c, hidden):
    rng = np.random.default_rng(10)
    x = _rand(rng, (b, s, p, c), 0.5, dev).to(torch.bfloat16)
    w = (_rand(rng, (2, 4 * c, 4 * hidden), 0.1, dev),
         _rand(rng, (2, hidden, 4 * hidden), 0.1, dev),
         _rand(rng, (2, 4 * hidden), 0.1, dev), _rand(rng, (2 * hidden, 4 * c), 0.1, dev))
    before = ops.launch_counts()
    got = gridrnn.grid_rnn_seq1_pair(x, *w)
    torch.cuda.synchronize()
    _bf16_counts_moved("grid_rnn_seq1_pair", before)
    plain = gridrnn.grid_rnn_seq1_pair_plain(x, *w)
    f64 = gridrnn.grid_rnn_seq1_pair_plain(x.double(), *(a.double() for a in w))
    upcast = gridrnn.grid_rnn_seq1_pair(x.float(), *w)
    for g, r, f, u in zip(got, plain, f64, upcast):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        _bf16_gates(BF16_TOLS["grid_rnn_seq1_pair"], g, r, f, u)


@pytest.mark.parametrize("b,s,p,c,hidden", [
    (2, 35, 12, 8, 24), (1, 40, 21, 24, 40), (1, 70, 33, 32, 100), (1, 20, 9, 64, 128)])
def test_grid_rnn_bf16_every_plan_matches_plain(dev, b, s, p, c, hidden):
    """Every plan (cluster size, lines a tile) that fits a block, launched
    directly, matches the bf16 plain version: one and two M tiles, with
    and without a cluster, at C = 8 (a lane's first k-chunk is tap 1)."""
    from fdbm_tpu_torch.ops import _build

    rng = np.random.default_rng(13)
    x = _rand(rng, (b, s, p, c), 0.5, dev).to(torch.bfloat16)
    w = (_rand(rng, (2, 4 * c, 4 * hidden), 0.1, dev),
         _rand(rng, (2, hidden, 4 * hidden), 0.1, dev),
         _rand(rng, (2, 4 * hidden), 0.1, dev), _rand(rng, (2 * hidden, 4 * c), 0.1, dev))
    plain = gridrnn.grid_rnn_seq1_pair_plain(x, *w)
    f64 = gridrnn.grid_rnn_seq1_pair_plain(x.double(), *(a.double() for a in w))
    lib = _build.load("gridrnn", gridrnn._SIGNATURES, gridrnn._RESTYPES)
    hs = torch.empty((2, b * p, s - 3, hidden), device=dev, dtype=torch.bfloat16)
    ran = []
    for cs in gridrnn.CLUSTERS:
        for lines in gridrnn.MMA_LINES:
            if (gridrnn.mma_layout(c, hidden, cs, lines) is None
                    or gridrnn._card_mma_max_clusters(torch.cuda.current_device(), c, hidden,
                                                      cs, lines) < 1):
                continue
            outs = (torch.full_like(x, float("nan")), torch.full_like(x, float("nan")))
            err = lib.gridrnn_seq1_pair_bf16(
                x.data_ptr(), *(t.data_ptr() for t in w), hs.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), b, s, p, c, hidden, cs, lines,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, (cs, lines, err)
            torch.cuda.synchronize()
            for g, r, f in zip(outs, plain, f64):
                assert torch.isfinite(g.float()).all(), (cs, lines)
                _bf16_gates(BF16_TOLS["grid_rnn_seq1_pair"], g, r, f)
            ran.append((cs, lines))
    assert {lines for _, lines in ran} == set(gridrnn.MMA_LINES)
    assert any(cs > 1 and lines == 32 for cs, lines in ran), ran


@pytest.mark.parametrize("n_head", [3, 4])
def test_flat_group_norms_bf16_match_plain(dev, n_head):
    rng = np.random.default_rng(11)
    maps = []
    for (b, t, q_bins), w in (((1, 5, 3), 2), ((2, 37, 11), 8), ((1, 257, 257), 2),):
        maps.append((_rand(rng, (b, t, q_bins * n_head * w), 1.0, dev).to(torch.bfloat16),
                     _rand(rng, (n_head, 1), 0.3, dev), _rand(rng, (n_head, w), 1.0, dev),
                     _rand(rng, (n_head, w), 1.0, dev), w))
    before = ops.launch_counts()
    got = attn_ops.flat_group_norms(maps)
    torch.cuda.synchronize()
    _bf16_counts_moved("flat_group_norm", before)
    for g, m in zip(got, maps):
        assert g.dtype == torch.bfloat16 and g.shape == m[0].shape
        plain = attn_ops.flat_group_norm_plain(*m[:4], width=m[4])
        f64 = attn_ops.flat_group_norm_plain(*(a.double() for a in m[:4]), width=m[4])
        _bf16_gates(BF16_TOLS["flat_group_norm"], g, plain, f64)


@pytest.mark.parametrize("b,t,q_bins,n_head,e,c", [
    (1, 5, 3, 4, 2, 32), (2, 70, 17, 4, 2, 32), (1, 256, 257, 4, 2, 32), (1, 33, 257, 4, 2, 48)])
def test_frame_attention_bf16_matches_plain(dev, b, t, q_bins, n_head, e, c):
    rng = np.random.default_rng(12)
    q, k = (_rand(rng, (b, t, q_bins, n_head * e), 1.0, dev).to(torch.bfloat16)
            for _ in range(2))
    v = _rand(rng, (b, t, q_bins, c), 1.0, dev).to(torch.bfloat16)
    d = c // n_head
    norms = tuple((_rand(rng, (n_head, 1), 0.3, dev), _rand(rng, (n_head, w), 1.0, dev),
                   _rand(rng, (n_head, w), 1.0, dev)) for w in (e, e, d))
    for nm in ((None, norms) if d & (d - 1) == 0 else (None,)):
        before = ops.launch_counts()
        got = attn_ops.frame_attention(q, k, v, n_head, e, norms=nm)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert after["frame_attention_bf16"] == before["frame_attention_bf16"] + 1
        assert after["frame_attention"] == before["frame_attention"]
        assert after["flat_group_norm"] == before["flat_group_norm"]
        assert got.dtype == torch.bfloat16
        plain = attn_ops.frame_attention_plain(q, k, v, n_head, e, norms=nm)
        f64 = attn_ops.frame_attention_plain(
            q.double(), k.double(), v.double(), n_head, e,
            norms=nm and tuple(tuple(a.double() for a in p) for p in nm))
        upcast = attn_ops.frame_attention(q.float(), k.float(), v.float(), n_head, e, norms=nm)
        _bf16_gates(BF16_TOLS["frame_attention"], got, plain, f64, upcast)
    # Every plan of the tensor-core kernel the card runs, launched directly:
    # a partial last query tile, T off 16, the ranks' uneven keys, D = 12.
    plain = attn_ops.frame_attention_plain(q, k, v, n_head, e)
    f64 = attn_ops.frame_attention_plain(q.double(), k.double(), v.double(), n_head, e)
    ran = 0
    for mt in attn_ops.MMA_ROW_TILES:
        for slices in attn_ops.MMA_SLICES:
            if (attn_ops.attention_mma_layout(t, q_bins, e, d, mt, slices) is None
                    or attn_ops._card_mma_max_clusters(0, t, q_bins, e, d, 16 * mt, slices) < 1):
                continue
            got = attn_ops.launch_frame_attention_bf16(q, k, v, n_head, e, 16 * mt, slices)
            torch.cuda.synchronize()
            _bf16_gates(BF16_TOLS["frame_attention"], got, plain, f64)
            ran += 1
    assert ran >= 8


@pytest.mark.parametrize("s,b,d,hidden", [(37, 5, 24, 20), (64, 40, 192, 200), (9, 35, 20, 52)])
def test_bilstm_fused_forward_bf16_matches_plain(dev, s, b, d, hidden):
    rng = np.random.default_rng(13)
    x, *w = _lstm_args(rng, s, b, d, hidden, dev, dirs=(2,))
    x = x.to(torch.bfloat16)
    before = ops.launch_counts()
    got = lstm_ops.bilstm_fused_forward(x, *w)
    torch.cuda.synchronize()
    _bf16_counts_moved("bilstm_fused_forward", before)
    plain = lstm_ops.bilstm_fused_forward_plain(x, *w)
    f64 = lstm_ops.bilstm_fused_forward_plain(x.double(), *(a.double() for a in w))
    upcast = lstm_ops.bilstm_fused_forward(x.float(), *w)
    for g, r, f, u in zip(got, plain, f64, upcast):
        assert g.dtype == torch.bfloat16 and g.shape == (s, b, hidden)
        _bf16_gates(BF16_TOLS["bilstm_fused_forward"], g, r, f, u)
    # Every recurrence plan of the tensor-core kernels the card runs (line
    # counts off the 16- and 32-line tiles; D = 20 stages x by 2-byte loads).
    ran = 0
    for cs in lstm_ops.REC_CLUSTERS:
        for lines in lstm_ops.MMA_LINES:
            if (lstm_ops.recurrence_mma_layout(hidden, cs, lines) is None
                    or lstm_ops._card_max_clusters(0, hidden, cs, lines, "mma") < 1):
                continue
            got = lstm_ops._forward("bilstm_fused_forward", x, *w, 2, False, plan=(cs, lines))
            torch.cuda.synchronize()
            for g, r, f in zip(got, plain, f64):
                _bf16_gates(BF16_TOLS["bilstm_fused_forward"], g, r, f)
            ran += 1
    assert ran >= 4


def test_bf16_wrappers_refuse_bf16_weights(dev):
    """The bf16 forms take fp32 weights (rounded in the kernels) and never
    fall back: bf16 weights raise."""
    x = torch.zeros(1, 10, 4, 8, device=dev, dtype=torch.bfloat16)
    w = (torch.zeros(2, 32, 32, device=dev), torch.zeros(2, 8, 32, device=dev),
         torch.zeros(2, 32, device=dev), torch.zeros(16, 32, device=dev))
    with pytest.raises(ValueError):
        gridrnn.grid_rnn_seq1_pair(x, w[0].bfloat16(), *w[1:])
    xs = torch.zeros(5, 3, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        lstm_ops.bilstm_fused_forward(xs, torch.zeros(2, 8, 32, device=dev, dtype=torch.bfloat16),
                                      w[1], w[2])


def test_bf16_tensor_core_layouts_match_the_kernel(dev):
    """Kernel 1's bf16 plan mirrored in Python (tests/test_torch_bf16_plans.py)
    lays out shared memory as the kernel counts it."""
    for c, hidden in ((32, 100), (64, 128), (16, 24), (8, 1)):
        for cs in gridrnn.CLUSTERS:
            for lines in gridrnn.MMA_LINES:
                lay = gridrnn.mma_layout(c, hidden, cs, lines)
                assert gridrnn.mma_smem(c, hidden, cs, lines) == (-1 if lay is None else lay[1])


def test_bf16_tensor_core_plan_is_one_wave_on_the_card(dev):
    """A 4 s request's bf16 RNN calls (B=1) are one wave on the card's counts."""
    rnn = gridrnn.mma_plan(263, 32, 100, dev)
    assert rnn.clusters <= rnn.max_clusters


def test_bf16_attention_and_lstm_layouts_match_the_kernels(dev):
    """The tensor-core plans of kernels 3 and 7 mirrored in Python
    (tests/test_torch_bf16_mma_plans.py) lay out their blocks as the kernels
    count them."""
    for t_len, q_bins, e, d in ((257, 257, 2, 8), (257, 257, 2, 12), (1921, 257, 2, 12),
                                (5, 3, 2, 8), (33, 17, 4, 4), (9, 5, 1, 5)):
        for mt in attn_ops.MMA_ROW_TILES:
            for slices in attn_ops.MMA_SLICES:
                lay = attn_ops.attention_mma_layout(t_len, q_bins, e, d, mt, slices)
                want = (-1, -1) if lay is None else (lay.threads, lay.smem_bytes)
                assert attn_ops.frame_attention_mma_smem(t_len, q_bins, e, d, mt,
                                                         slices) == want
    for hidden in (1, 20, 52, 200, 256):
        for cs in lstm_ops.REC_CLUSTERS:
            for lines in lstm_ops.MMA_LINES:
                lay = lstm_ops.recurrence_mma_layout(hidden, cs, lines)
                assert lstm_ops.recurrence_mma_smem(hidden, cs, lines) == (
                    -1 if lay is None else lay[1])
    for d_in in (1, 20, 192, 300, 400):
        lay = lstm_ops.projection_mma_layout(d_in)
        assert lstm_ops.projection_mma_smem(d_in) == (-1 if lay is None else lay[1])


def test_bf16_attention_and_lstm_plans_are_one_wave_on_the_card(dev):
    """A 4 s request's bf16 attention (B=1, D = 8 and 12) and 6l48c200's
    bf16 LSTM (263 lines) are one wave on the card's counts."""
    for d in (8, 12):
        plan = attn_ops.card_attention_mma_plan(1, 257, 257, 4, 2, d, dev)
        assert plan.blocks // plan.slices <= plan.max_clusters
    rec = lstm_ops.recurrence_mma_plan(263, 2, 200, dev)
    assert rec.clusters <= rec.max_clusters


def test_bf16_attention_and_lstm_refuse_what_they_cannot_run(dev):
    """Past its frame limit the bf16 attention raises, and so does the bf16
    LSTM past its projection's depth limit or on an x off 16 bytes: no
    fallback to another form."""
    limit = attn_ops.attention_mma_max_frames(257, 2, 8)
    q = torch.zeros(1, limit + 1, 257, 8, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(1, limit + 1, 257, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-row score tile"):
        attn_ops.frame_attention(q, q, v, 4, 2)
    w = (torch.zeros(2, 400, 80, device=dev), torch.zeros(2, 20, 80, device=dev),
         torch.zeros(2, 80, device=dev))
    with pytest.raises(ValueError, match="projection"):
        lstm_ops.bilstm_fused_forward(torch.zeros(3, 2, 400, device=dev, dtype=torch.bfloat16),
                                      *w)
    x = torch.zeros(3 * 2 * 24 + 4, device=dev, dtype=torch.bfloat16)[4:].view(3, 2, 24)
    with pytest.raises(ValueError, match="16-byte"):
        lstm_ops.bilstm_fused_forward(x, torch.zeros(2, 24, 80, device=dev), *w[1:])


def test_bf16_rnn_wrapper_refuses_a_canvas_off_16_bytes(dev):
    """The tensor-core kernel stages the canvas by 16-byte copies: a bf16
    canvas off a 16-byte boundary raises rather than fall back."""
    x = torch.zeros(12 * 7 * 32 + 4, device=dev, dtype=torch.bfloat16)[4:].view(1, 12, 7, 32)
    w = (torch.zeros(2, 128, 400, device=dev), torch.zeros(2, 100, 400, device=dev),
         torch.zeros(2, 400, device=dev), torch.zeros(200, 128, device=dev))
    with pytest.raises(ValueError, match="16-byte"):
        gridrnn.grid_rnn_seq1_pair(x, *w)


def test_small_backbone_bf16_kernels_match_plain_route(dev):
    """A TF-GridNet served in bf16 (eval mode, ``serve_dtype``) launches
    only the bf16 forms, and the kernel route agrees with the plain route
    in bf16 within the bf16 gates (against the float64 network)."""
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    torch.manual_seed(0)
    kw = dict(n_layers=2, emb_dim=16, hidden=24, qk_output_channel=4)
    net = TFGridNet(serve_dtype=torch.bfloat16, **kw).to(dev).eval()
    ref = TFGridNet(use_kernels=False, serve_dtype=torch.bfloat16, **kw).to(dev).eval()
    f64 = TFGridNet(use_kernels=False, **kw).to(dev).eval()
    ref.load_state_dict(net.state_dict())
    f64.load_state_dict(net.state_dict())
    f64.double()
    x = torch.randn(2, 1, 33, 20, dtype=torch.complex64, device=dev)
    y = torch.randn(2, 1, 33, 20, dtype=torch.complex64, device=dev)
    t = torch.tensor([0.3, 0.8], device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = net(x, y, t)
        counts = ops.launch_counts()
        want = ref(x, y, t)
        exact = f64(x.to(torch.complex128), y.to(torch.complex128), t.double())
    assert {k: v for k, v in counts.items() if v} == {
        "grid_rnn_seq1_pair_bf16": 4, "flat_group_norm_bf16": 2, "frame_attention_bf16": 2}
    _bf16_gates(1e-2, torch.view_as_real(got), torch.view_as_real(want),
                torch.view_as_real(exact))


GLOO_WORKER = """
import sys
import torch
from fdbm_tpu_torch import model as pmodel, ops
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.parallel import distributed, mesh

rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
distributed.initialize(f"file://{store}", 2, rank, backend="gloo")
blob = torch.load(inp, weights_only=True)
fdbm = pmodel.FDBM(pmodel.FDBMConfig(n_fft=64, hop_length=32), device="cuda:0")
fdbm.dnn = TFGridNet(**blob["net"]).to("cuda:0")
fdbm.dnn.load_state_dict(blob["weights"])
state = pmodel.TrainState(fdbm.dnn)
local = mesh.shard_batch(tuple(b.cuda() for b in blob["batch"]), rank, 2)
ops.reset_launch_counts()
loss, grads = mesh.data_parallel_grads(fdbm, state, local,
                                       torch.Generator(device="cuda:0").manual_seed(3))
torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in grads.items()},
            "launches": ops.launch_counts()}, f"{out}.{rank}.pt")
distributed.shutdown()
"""


def test_gloo_two_ranks_on_one_card_match_one_rank(dev, tmp_path):
    """Two processes on cuda:0 joined over gloo, each half of a 4-row batch:
    the all-reduced loss and gradients (the global batch's draw, sliced by
    rank) against one process on the whole batch on the same generator,
    within the training step's gates (loss 1e-5, each gradient norm-rel
    1e-3 floored at 1e-4 of the global norm); kernels 5-6 on each rank."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from fdbm_tpu_torch import model as pmodel
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet

    net = dict(n_layers=1, emb_dim=16, hidden=24)
    torch.manual_seed(0)
    weights = TFGridNet(**net).state_dict()
    rng = np.random.default_rng(8)
    x = (0.1 * rng.standard_normal((4, 15 * 32))).astype(np.float32)
    batch = (torch.as_tensor(x), torch.as_tensor(x + 0.02 * rng.standard_normal(x.shape)
                                                  .astype(np.float32)))
    torch.save({"net": net, "weights": weights, "batch": batch}, tmp_path / "in.pt")
    (tmp_path / "worker.py").write_text(GLOO_WORKER)
    repo = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r),
                               str(tmp_path / "store"), str(tmp_path / "in.pt"),
                               str(tmp_path / "out")], env=env) for r in range(2)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
    finally:
        for p in procs:
            p.kill()
    ranks = [torch.load(tmp_path / f"out.{r}.pt", weights_only=True) for r in range(2)]
    fdbm = pmodel.FDBM(pmodel.FDBMConfig(n_fft=64, hop_length=32), device=dev)
    fdbm.dnn = TFGridNet(**net).to(dev)
    fdbm.dnn.load_state_dict(weights)
    state = pmodel.TrainState(fdbm.dnn)
    loss = fdbm.loss_fn(tuple(b.to(dev) for b in batch),
                        torch.Generator(device=dev).manual_seed(3))
    want = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert abs(ranks[0]["loss"] - float(loss.detach())) <= 1e-5 * abs(float(loss.detach()))
    norm = float(torch.sqrt(sum((g * g).sum() for g in want.values())))
    for name, g in want.items():
        got = ranks[0]["grads"][name].to(dev)
        assert torch.equal(ranks[1]["grads"][name].to(dev), got), name
        assert float((got - g).norm()) / max(float(g.norm()), 1e-4 * norm) < 1e-3, name
    for r in ranks:
        assert r["launches"]["grid_fold_train_pair"] == r["launches"][
            "grid_fold_train_pair_bwd"] == 2  # one block: its intra and inter paths


def test_more_devices_than_visible_are_refused(dev, tmp_path):
    """``-D`` and ``--mesh_devices`` beyond the visible cards raise before
    anything starts."""
    from pathlib import Path

    from fdbm_tpu_torch import infer_folder, train

    n = torch.cuda.device_count() + 1
    configs = Path(__file__).resolve().parents[1] / "configs"
    with pytest.raises(ValueError, match=f"Requested {n} devices, have {n - 1}"):
        train.main(["-C", str(configs / "config.yaml"), "-D", str(n),
                    f"log_dir={tmp_path}"])
    with pytest.raises(ValueError, match=f"Requested {n} devices, have {n - 1}"):
        infer_folder.main(["-C", str(configs / "config_infer_folder.yaml"), "--mesh_devices",
                           str(n), "ckpt=unused"])
