"""Plain versions of the port's kernels and its TF-GridNet against fdbm_tpu,
on the CPU.

The JAX kernels run as tests/test_gridrnn.py and tests/test_attention.py run
them here: Pallas in interpret mode on the CPU, at small shapes. The port's
wrappers, given CPU tensors, run their plain PyTorch versions (the CUDA
kernels are held against those on the card: tests/test_torch_cuda.py).
Inputs come from numpy seeds. Tolerances: 2e-4 for the RNN path and the
attention, the tolerance tests/test_gridrnn.py holds the JAX kernel to
against its float64 oracle; 1e-5 for the elementwise layers; rel-L2 < 1e-4
for whole modules (PARITY.md's module gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu.models import layers as jlayers
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu.ops import attention as jattn
from fdbm_tpu.ops import gridrnn as jgrid
from fdbm_tpu_torch import ops
from fdbm_tpu_torch.models import layers as players
from fdbm_tpu_torch.models import tfgridnet as ptfg
from fdbm_tpu_torch.ops import attention as pattn
from fdbm_tpu_torch.ops import gridrnn as pgrid
from fdbm_tpu_torch.utils import weights

KS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many tiny products, and
    the test workers share the machine's cores (oversubscribed BLAS threads
    spin instead of working)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _perturbed(params, seed):
    """Flax params with noise added, so ones/zeros inits do not hide a
    swapped or dropped parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * _rand(rng, np.shape(a)), jax.device_get(params))


@pytest.mark.parametrize("b,s,p,c,hidden", [(1, 12, 5, 8, 8), (2, 10, 3, 16, 16)])
def test_grid_rnn_plain_matches_jax_kernel_on_crop(b, s, p, c, hidden):
    rng = np.random.default_rng(0)
    x = _rand(rng, (b, s, p, c), 0.5)
    w = (_rand(rng, (2, KS * c, 4 * hidden), 0.2), _rand(rng, (2, hidden, 4 * hidden), 0.2),
         _rand(rng, (2, 4 * hidden), 0.2), _rand(rng, (2 * hidden, KS * c), 0.2))
    want = jgrid.grid_rnn_seq1_pair(jnp.asarray(x), *map(jnp.asarray, w))
    n0 = pgrid.grid_rnn_seq1_pair.launches
    got = pgrid.grid_rnn_seq1_pair(torch.as_tensor(x), *map(torch.as_tensor, w))
    assert pgrid.grid_rnn_seq1_pair.launches == n0  # CPU tensors: the plain version
    length = s - (KS - 1)
    for g, w_ in zip(got, want):
        assert g.shape == (b, s, p, c)
        # the JAX kernel is exact on rows [3, L-1] only
        np.testing.assert_allclose(g.numpy()[:, 3:length], np.asarray(w_)[:, 3:length],
                                   rtol=2e-4, atol=2e-4)


def test_bilstm_matches_flax():
    rng = np.random.default_rng(1)
    x = _rand(rng, (3, 9, 12))
    jm = jlayers.BiLSTM(hidden=10)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jm.apply(params, jnp.asarray(x))
    pm = players.BiLSTM(12, 10)
    pm.load_state_dict({k: torch.as_tensor(v) for k, v in params["params"].items()})
    with torch.no_grad():
        got = pm(torch.as_tensor(x))
    assert got.shape == (3, 9, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_head,width,q_bins", [(4, 2, 5), (4, 8, 3), (2, 4, 7)])
def test_flat_group_norm_plain_matches_jax_kernel(n_head, width, q_bins):
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 6, q_bins * n_head * width))
    alpha, gamma, beta = (_rand(rng, (n_head, 1), 0.3), _rand(rng, (n_head, width)),
                          _rand(rng, (n_head, width)))
    want = jattn.flat_group_norm(jnp.asarray(x), alpha, gamma, beta, width=width)
    got = pattn.flat_group_norm(*map(torch.as_tensor, (x, alpha, gamma, beta)), width=width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused_norms", [False, True])
@pytest.mark.parametrize("b,t,q_bins,n_head,e,c", [(1, 6, 5, 4, 2, 32), (2, 9, 3, 2, 4, 16)])
def test_frame_attention_plain_matches_jax_kernel(b, t, q_bins, n_head, e, c, fused_norms):
    rng = np.random.default_rng(3)
    q, k = _rand(rng, (b, t, q_bins, n_head * e)), _rand(rng, (b, t, q_bins, n_head * e))
    v = _rand(rng, (b, t, q_bins, c))
    norms = None
    if fused_norms:
        norms = tuple((_rand(rng, (n_head, 1), 0.3), _rand(rng, (n_head, w)),
                       _rand(rng, (n_head, w))) for w in (e, e, c // n_head))
    want = jattn.frame_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_head, e,
                                 norms=norms and tuple(tuple(map(jnp.asarray, n)) for n in norms))
    got = pattn.frame_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), n_head, e,
        norms=norms and tuple(tuple(map(torch.as_tensor, n)) for n in norms))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_elementwise_layers_match_flax():
    rng = np.random.default_rng(4)
    x = _rand(rng, (5,), 1.0)
    jg = jlayers.GaussianFourierProjection(embedding_size=6)
    gp = _perturbed(jg.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    pg = players.GaussianFourierProjection(6)
    pg.W.data = torch.as_tensor(gp["params"]["W"])
    np.testing.assert_allclose(pg(torch.as_tensor(x)).numpy(),
                               np.asarray(jg.apply(gp, jnp.asarray(x))), rtol=1e-5, atol=1e-5)

    y = _rand(rng, (3, 4, 8))
    pp = players.PReLU(())
    pp.alpha.data.fill_(0.1)
    np.testing.assert_array_equal(
        pp(torch.as_tensor(y)).detach().numpy(),
        np.asarray(jlayers.PReLU(param_shape=()).apply(
            {"params": {"alpha": np.float32(0.1)}}, jnp.asarray(y))))

    gamma, beta = _rand(rng, (8,)), _rand(rng, (8,))
    np.testing.assert_allclose(
        players.layer_norm_f32(*map(torch.as_tensor, (y, gamma, beta))).numpy(),
        np.asarray(jlayers.layer_norm_f32(jnp.asarray(y), gamma, beta, axis=-1)),
        rtol=1e-5, atol=1e-5)


def test_allhead_norm_matches_flax():
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, 3, 5, 8))
    jm = jtfg._AllHeadPReLULayerNorm(n_head=4, e_dim=2)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    pm = ptfg._AllHeadPReLULayerNorm(4, 2)
    pm.load_state_dict({k: torch.as_tensor(v) for k, v in params["params"].items()})
    with torch.no_grad():
        got = pm(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gridnet_block_matches_flax(use_pallas):
    """Both Flax routes: plain XLA, and the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(6)
    x = _rand(rng, (1, 6, 5, 8))
    jm = jtfg.GridNetBlock(emb_dim=8, hidden=8, use_pallas=use_pallas)
    params = _perturbed(jtfg.GridNetBlock(emb_dim=8, hidden=8).init(
        jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    want = jm.apply(params, jnp.asarray(x))
    pm = ptfg.GridNetBlock(8, 8)
    pm.load_state_dict(weights.gridnet_block_from_flax(params["params"]))
    with torch.no_grad():
        got = pm(torch.as_tensor(x))
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("n_layers,emb_dim,hidden", [(2, 8, 8)])
def test_tfgridnet_matches_flax(n_layers, emb_dim, hidden):
    rng = np.random.default_rng(7)
    shape = (2, 1, 9, 7)
    x = (_rand(rng, shape) + 1j * _rand(rng, shape)).astype(np.complex64)
    y = (_rand(rng, shape) + 1j * _rand(rng, shape)).astype(np.complex64)
    t = np.array([0.3, 0.9], np.float32)
    jm = jtfg.TFGridNet(n_layers=n_layers, emb_dim=emb_dim, hidden=hidden)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(t)), 7)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
    pm = ptfg.TFGridNet(n_layers=n_layers, emb_dim=emb_dim, hidden=hidden)
    pm.load_state_dict(weights.tfgridnet_from_flax(params), strict=True)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = pm(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(t))
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert got.shape == shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-4


def test_registered_variants_and_gate():
    from fdbm_tpu_torch.models import BackboneRegistry

    assert BackboneRegistry.get_all_names() == ["tfgridnet_4l32c80", "tfgridnet_5l32c100"]
    for name, hidden in (("tfgridnet_5l32c100", 100), ("tfgridnet_4l32c80", 80)):
        net = BackboneRegistry.get_by_name(name)()
        assert net.blocks[0].intra.bilstm.w_hh.shape == (2, hidden, 4 * hidden)
        assert ptfg._kernel_fast_path_ok(32, hidden)
        assert ptfg._kernel_fast_path_ok(32, hidden) == jtfg._pallas_fast_path_ok(32, hidden)
    assert not ptfg._kernel_fast_path_ok(72, 16) and not ptfg._kernel_fast_path_ok(32, 129)
    # Outside the gate, CPU tensors take the plain route (on the card it raises).
    path = ptfg._RnnPath(emb_dim=12, hidden=6)
    with torch.no_grad():
        assert path(torch.zeros(1, 8, 3, 12)).shape == (1, 8, 3, 12)
