"""bf16 serving (``inference_dtype: bfloat16``) of the port against fdbm_tpu's
bf16 path, on the CPU.

Each module that holds a kernel with a bf16 form (``grid_rnn_seq1_pair``,
``flat_group_norm``, ``frame_attention``, ``bilstm_fused_forward``) runs
its bf16 plain version (the CPU route of the bf16 kernel) against the JAX
kernel on the same bf16 inputs, Pallas in interpret mode as the JAX
package's own tests run it; the backbones run in eval mode against Flax
modules built with ``dtype=jnp.bfloat16`` and the Pallas route
(``use_pallas=True``) on the same converted weights; a 2-step zero-noise
``sde_ei`` serve runs through ``FDBM.enhance_batch`` of both packages at
``inference_dtype="bfloat16"``.

bf16 has no bit-level parity between two frameworks: they round at other
places (a bf16 Dense, a bf16 einsum, a reduction order). So every
comparison passes three gates (``_gates``):

1. rel-L2 to the JAX bf16 output within ``tol``, set from the measured
   readings (noted beside each) with no more than a 3x margin (a reading
   of exactly 0, the same bits, gets 1e-6);
2. the port's distance to a float64 route on the same inputs and weights
   no more than 1.5x the JAX bf16 output's distance plus 1e-3: the port
   rounds no worse than the reference;
3. that distance above 1e-4, a control: a route that quietly stayed in
   fp32 reads about 1e-6 there and fails.

The kernels' modules agree with the JAX kernels to 1.4e-4 or better (the
same fp32 arithmetic on the same bf16 operands, rounded at the same
places). A random TF-GridNet amplifies bf16 rounding: its E=2 q/k norms
normalise pairs of lanes, and a pair within bf16 rounding of each other
flips sign, so one draw of ``tfgridnet_4l32c80`` reads 0.07-0.18 between
the two packages and 0.10-0.14 from float64 on each side (the JAX package
records the same of its own bf16 path: 0.4 dB SI-SDR between fp32 and bf16
serves on random weights, BENCH_NOTES.md). So the backbone tests read three
draws and hold gates 2 and 3 on the distances summed over them, and the
narrow nets of the other backbone and serve tests take E=4 q/k lanes.

Also: ``layer_norm_f32``'s single-pass bf16 form against the JAX function,
the fp32 forms unchanged bit for bit, and both serving CLIs on the CPU with
``inference_dtype=bfloat16`` (finite outputs of the right length; the
checkpoint's parameters still fp32).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import model as jmodel
from fdbm_tpu import sampling as jsampling
from fdbm_tpu.models import BackboneRegistry as JaxRegistry
from fdbm_tpu.models import layers as jlayers
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu.ops import attention as jattn
from fdbm_tpu.ops import gridrnn as jgrid
from fdbm_tpu.ops import lstm as jlstm
from fdbm_tpu_torch import infer_folder, infer_single, ops
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import sampling as psampling
from fdbm_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.models import layers as players
from fdbm_tpu_torch.models import tfgridnet as ptfg
from fdbm_tpu_torch.ops import attention as pattn
from fdbm_tpu_torch.ops import gridrnn as pgrid
from fdbm_tpu_torch.ops import lstm as plstm
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import backbone_state_dict_from_flax, tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
KS = 4
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_np(a):
    """``a`` rounded to bf16, as float32 numpy (the inputs both packages take)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (torch.view_as_real(t) if t.is_complex() else t).double().numpy()
    a = np.asarray(t)
    return np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a.astype(np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _gates(port, jax_out, f64, tol):
    """The three gates of the module docstring; returns the readings."""
    r = {"jax": _rel(port, jax_out), "port_f64": _rel(port, f64), "jax_f64": _rel(jax_out, f64)}
    assert r["jax"] < tol, r
    assert r["port_f64"] <= 1.5 * r["jax_f64"] + 1e-3, r
    assert r["port_f64"] > 1e-4, r
    return r


def _perturbed(params, seed):
    """Flax params with noise added, so ones/zeros inits do not hide a
    swapped or dropped parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * _rand(rng, np.shape(a)), jax.device_get(params))


# -- the kernels' modules -----------------------------------------------------------------


def test_grid_rnn_bf16_matches_jax_kernel():
    """Kernel 1's bf16 form at tests/test_gridrnn.py's bf16 shapes and seed,
    on the crop rows [3, L-1] the JAX kernel makes exact. Readings: rel
    1.4e-4 to JAX, 3.4e-3 / 3.4e-3 to float64."""
    b, s, p, c, hidden = 2, 35, 12, 16, 24
    rng = np.random.default_rng(4)
    x = _bf16_np(_rand(rng, (b, s, p, c), 0.5))
    w = (_rand(rng, (2, KS * c, 4 * hidden), 0.2), _rand(rng, (2, hidden, 4 * hidden), 0.2),
         _rand(rng, (2, 4 * hidden), 0.2), _rand(rng, (2 * hidden, KS * c), 0.2))
    want = jgrid.grid_rnn_seq1_pair(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w))
    assert all(o.dtype == jnp.bfloat16 for o in want)
    n0 = ops.launch_counts()
    got = pgrid.grid_rnn_seq1_pair(torch.as_tensor(x).to(BF16), *map(torch.as_tensor, w))
    assert ops.launch_counts() == n0  # CPU tensors: the plain version
    assert all(g.dtype == BF16 and g.shape == (b, s, p, c) for g in got)
    f64 = pgrid.grid_rnn_seq1_pair_plain(torch.as_tensor(x).double(),
                                         *(torch.as_tensor(a).double() for a in w))
    crop = slice(3, s - (KS - 1))
    stack = lambda pair: torch.stack([torch.as_tensor(_np(o))[:, crop] for o in pair])
    _gates(stack(got), stack(want), stack(f64), 4e-4)


@pytest.mark.parametrize("n_head,width,q_bins", [(4, 2, 40), (4, 8, 12)])
def test_flat_group_norm_bf16_matches_jax_kernel(n_head, width, q_bins):
    """Kernel 2's bf16 form: fp32 statistics, bf16 in and out. Readings:
    rel 0 / 2.9e-5 to JAX (the same fp32 arithmetic, rounded once; a
    rounding-boundary flip or two), 1.4e-3 / 1.6e-3 to float64."""
    rng = np.random.default_rng(2)
    x = _bf16_np(_rand(rng, (2, 50, q_bins * n_head * width)))
    params = (_rand(rng, (n_head, 1), 0.3), _rand(rng, (n_head, width)),
              _rand(rng, (n_head, width)))
    want = jattn.flat_group_norm(jnp.asarray(x, jnp.bfloat16), *params, width=width)
    assert want.dtype == jnp.bfloat16
    got = pattn.flat_group_norm(torch.as_tensor(x).to(BF16), *map(torch.as_tensor, params),
                                width=width)
    assert got.dtype == BF16
    f64 = pattn.flat_group_norm_plain(torch.as_tensor(x).double(),
                                      *(torch.as_tensor(a).double() for a in params), width)
    _gates(got, want, f64, 8e-5)


@pytest.mark.parametrize("fused_norms", [False, True])
def test_frame_attention_bf16_matches_jax_kernel(fused_norms):
    """Kernel 3's bf16 form (and kernel 2's before it with the norms) at
    tests/test_attention.py's bf16 shapes and seed. Readings: rel 0 /
    5.6e-6 to JAX, 2.3e-3 / 2.6e-3 to float64."""
    b, t, q_bins, n_head, e, c = 2, 50, 40, 4, 2, 32
    rng = np.random.default_rng(1)
    q, k = (_bf16_np(_rand(rng, (b, t, q_bins, n_head * e))) for _ in range(2))
    v = _bf16_np(_rand(rng, (b, t, q_bins, c)))
    norms = None
    if fused_norms:
        norms = tuple((_rand(rng, (n_head, 1), 0.3), _rand(rng, (n_head, w)),
                       _rand(rng, (n_head, w))) for w in (e, e, c // n_head))
    cast = lambda conv: tuple(tuple(map(conv, n)) for n in norms) if norms else None
    want = jattn.frame_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), n_head, e,
                                 norms=cast(jnp.asarray))
    assert want.dtype == jnp.bfloat16
    got = pattn.frame_attention(*(torch.as_tensor(a).to(BF16) for a in (q, k, v)), n_head, e,
                                norms=cast(torch.as_tensor))
    assert got.dtype == BF16
    f64 = pattn.frame_attention_plain(
        *(torch.as_tensor(a).double() for a in (q, k, v)), n_head, e,
        norms=norms and tuple(tuple(torch.as_tensor(a).double() for a in n) for n in norms))
    _gates(got, want, f64, 1.6e-5)


def test_bilstm_fused_forward_bf16_matches_jax_kernel():
    """Kernel 7's bf16 form at tests/test_torch_lstm.py's shapes. Readings:
    rel 0 to JAX (the same bits), 2.4e-3 to float64."""
    s, b, d, hidden = 37, 5, 24, 20
    rng = np.random.default_rng(0)
    u = lambda *shape: (rng.uniform(-1, 1, shape) / np.sqrt(hidden)).astype(np.float32)
    x = _bf16_np(rng.standard_normal((s, b, d)).astype(np.float32))
    w = (u(2, d, 4 * hidden), u(2, hidden, 4 * hidden), u(2, 4 * hidden))
    want = jlstm.bilstm_fused_forward(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w))
    assert all(o.dtype == jnp.bfloat16 for o in want)
    got = plstm.bilstm_fused_forward(torch.as_tensor(x).to(BF16), *map(torch.as_tensor, w))
    assert all(g.dtype == BF16 and g.shape == (s, b, hidden) for g in got)
    f64 = plstm.bilstm_fused_forward_plain(torch.as_tensor(x).double(),
                                           *(torch.as_tensor(a).double() for a in w))
    _gates(torch.stack(got), jnp.stack(want), torch.stack(f64), 1e-6)


# The card's limits for kernels 1, 3 and 7 against their bf16 plain versions
# (chip_smoke.py's BF16_TOLS and tests/test_torch_cuda.py's).
CARD_BF16_TOLS = {"grid_rnn_seq1_pair": 2e-3, "frame_attention": 2.5e-4,
                  "bilstm_fused_forward": 1e-3}


def _card_shaped(kernel, rng):
    """The kernel's plain version and its bf16 input and fp32 weights at the
    main path's shapes (chip_smoke.py's kernel_bf16 rows, B=1)."""
    t = lambda *shape, s=1.0: torch.as_tensor(_rand(rng, shape, s))
    if kernel == "grid_rnn_seq1_pair":
        c, hidden = 32, 100
        w = (t(2, KS * c, 4 * hidden, s=0.1), t(2, hidden, 4 * hidden, s=0.1),
             t(2, 4 * hidden, s=0.1), t(2 * hidden, KS * c, s=0.1))
        crop = lambda pair: torch.stack([o[:, 3:260] for o in pair])
        return lambda *a: crop(pgrid.grid_rnn_seq1_pair_plain(*a)), (t(1, 263, 70, c, s=0.5),), w
    if kernel == "frame_attention":
        qkv = (t(1, 64, 257, 8), t(1, 64, 257, 8), t(1, 64, 257, 32))
        return lambda q, k, v: pattn.frame_attention_plain(q, k, v, 4, 2), qkv, ()
    hidden = 200
    w = tuple(t(*shape, s=hidden ** -0.5) for shape in
              ((2, 192, 4 * hidden), (2, hidden, 4 * hidden), (2, 4 * hidden)))
    return lambda *a: torch.stack(plstm.bilstm_fused_forward_plain(*a)), (t(260, 70, 192),), w


@pytest.mark.parametrize("kernel", sorted(CARD_BF16_TOLS))
def test_upcast_control_misses_the_card_limits(kernel):
    """On the card each bf16 kernel must be within CARD_BF16_TOLS of its
    bf16 plain version, and the up-cast control must miss that limit: the
    fp32 form on the same bf16 inputs with its output rounded to bf16, a
    kernel that never rounds the weights, h before each product or P before
    P.V. Here the plain versions stand in for both kernels at the card's
    shapes, so the limits are seen to tell the two designs apart. Readings:
    3.7e-3 (kernel 1), 2.6e-3 (kernel 3), 3.0e-3 (kernel 7)."""
    plain, inputs, weights = _card_shaped(kernel, np.random.default_rng(90))
    inputs = tuple(a.to(BF16) for a in inputs)
    with torch.no_grad():
        want = plain(*inputs, *weights)
        upcast = plain(*(a.float() for a in inputs), *weights).to(BF16)
    assert want.dtype == BF16
    assert _rel(upcast, want) > CARD_BF16_TOLS[kernel]


def test_layer_norm_single_pass_bf16_and_fp32_unchanged():
    """bf16 inputs take the JAX package's single-pass statistics (fp32 sums
    of x and x^2, the variance clamped at 0), fp32 inputs keep the two-pass
    form bit for bit; PReLU keeps x's dtype."""
    rng = np.random.default_rng(5)
    y = _rand(rng, (3, 4, 32), 2.0) + 1.5
    gamma, beta = _rand(rng, (32,)), _rand(rng, (32,))
    yb = _bf16_np(y)
    want = jlayers.layer_norm_f32(jnp.asarray(yb, jnp.bfloat16), gamma, beta, axis=-1)
    got = players.layer_norm_f32(torch.as_tensor(yb).to(BF16), *map(torch.as_tensor,
                                                                     (gamma, beta)))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the single-pass form, not the two-pass one, on the same bf16 input
    x32 = torch.as_tensor(yb)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
    single = ((x32 - mu) * torch.rsqrt(var + 1e-5) * torch.as_tensor(gamma)
              + torch.as_tensor(beta)).to(BF16)
    assert torch.equal(got, single)
    # fp32: the two-pass form, bit for bit
    x = torch.as_tensor(y)
    xc = x - x.mean(-1, keepdim=True)
    two_pass = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) \
        * torch.as_tensor(gamma) + torch.as_tensor(beta)
    assert torch.equal(players.layer_norm_f32(x, *map(torch.as_tensor, (gamma, beta))),
                       two_pass)
    prelu = players.PReLU(())
    assert prelu(torch.as_tensor(yb).to(BF16)).dtype == BF16
    assert torch.equal(prelu(x), torch.where(x >= 0, x, prelu.alpha * x))


# -- the backbones ----------------------------------------------------------------------


def _complex(rng, shape):
    return (_rand(rng, shape) + 1j * _rand(rng, shape)).astype(np.complex64)


def _backbone_readings(kw, shape, seeds, tol):
    """JAX bf16 output (the Flax twin with ``dtype=bfloat16`` on its Pallas
    route), the port's bf16 output (eval mode) and the port's float64 route,
    on perturbed Flax weights and inputs from each of ``seeds``; the gates
    of ``_gates`` on the readings summed over the seeds (see the module
    docstring on why one draw is not enough)."""
    jinit, jbf16 = jtfg.TFGridNet(**kw), jtfg.TFGridNet(dtype=jnp.bfloat16, use_pallas=True, **kw)
    apply = jax.jit(jbf16.apply)
    rng0 = np.random.default_rng(0)
    x0 = jnp.asarray(_complex(rng0, shape))
    base = jinit.init(jax.random.PRNGKey(0), x0, x0, jnp.ones(shape[:1], jnp.float32))
    sums = dict.fromkeys(("jax", "port_f64", "jax_f64"), 0.0)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        x, y = _complex(rng, shape), _complex(rng, shape)
        t = rng.uniform(0.2, 0.9, shape[:1]).astype(np.float32)
        params = _perturbed(base, seed)
        want = apply(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
        pnet = ptfg.TFGridNet(serve_dtype=BF16, **kw)
        pnet.load_state_dict(tfgridnet_from_flax(params))
        pnet.eval()
        args = tuple(map(torch.as_tensor, (x, y, t)))
        with torch.no_grad():
            got = pnet(*args)
            pnet.serve_dtype = torch.float32
            f64 = pnet.double()(args[0].to(torch.complex128), args[1].to(torch.complex128),
                                args[2].double())
        assert got.dtype == torch.complex64 and got.shape == shape
        r = {"jax": _rel(got, want), "port_f64": _rel(got, f64), "jax_f64": _rel(want, f64)}
        assert r["jax"] < tol, (seed, r)
        for k in sums:
            sums[k] += r[k]
    assert sums["port_f64"] <= 1.5 * sums["jax_f64"] + 1e-3, sums
    assert sums["port_f64"] > 1e-4 * len(seeds), sums
    return sums


def test_tfgridnet_4l32c80_bf16_matches_flax():
    """``tfgridnet_4l32c80`` at full width, narrow F and T, inside the fused
    kernels' gate: kernels 1, 2 and 3 (their bf16 plain versions) against
    the Flax twin. Its E=2 q/k norms make one draw chaotic (a pair of lanes
    within bf16 rounding of each other flips sign), so three draws.
    Readings (seeds 11-13): rel to JAX 0.070 / 0.100 / 0.175; distances to
    float64 summed, port 0.362, JAX 0.368."""
    _backbone_readings(dict(n_layers=4, emb_dim=32, hidden=80), (1, 1, 9, 8), (11, 12, 13), 0.25)


def test_tfgridnet_outside_the_gate_bf16_matches_flax():
    """``TFGridNet`` outside the fused kernels' gate (C % 8 != 0, as the
    class defaults' H=200 is), at a small width: the generic RNN path
    through kernel 7's bf16 form and the norms on plain ops before kernel
    3, with E=4 q/k lanes (better conditioned than E=2). Readings (seeds
    12-14): rel to JAX 0.023 / 0.037 / 0.017; distances to float64 summed,
    port 0.117, JAX 0.146."""
    kw = dict(n_layers=2, emb_dim=12, hidden=16, qk_output_channel=4)
    assert not ptfg._kernel_fast_path_ok(12, 16)
    _backbone_readings(kw, (1, 1, 9, 8), (12, 13, 14), 0.1)


def _fan_in(params, seed=0):
    """Every kernel N(0, 1/fan_in), biases 0.1 N(0, 1), GroupNorm scales
    1 + 0.1 N(0, 1) (tests/test_torch_ncsnpp.py: the score-SDE init hides
    dropped branches)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        leaf = jax.tree_util.keystr(path[-1:])
        if leaf == "['W']":
            return a
        if leaf == "['kernel']":
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(
                np.float32)
        if leaf == "['scale']":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def test_ncsnpp_v2_5m_bf16_matches_flax():
    """``ncsnpp_v2_5M`` on fan-in-scale weights (17 bins read as 16, 8
    frames) in eval mode with a bf16 serving dtype against the Flax net
    with ``dtype=bfloat16``: no kernel, cuDNN-style convolutions and plain
    ops in bf16 with fp32 norms. Readings: rel 1.65e-2 to JAX, 1.29e-2 /
    1.52e-2 to float64."""
    rng = np.random.default_rng(13)
    shape = (1, 1, 17, 8)
    x, y = _complex(rng, shape), _complex(rng, shape)
    t = np.array([0.6], np.float32)
    jinit = JaxRegistry.get_by_name("ncsnpp_v2_5M")()
    params = _fan_in(jinit.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(t)))
    want = JaxRegistry.get_by_name("ncsnpp_v2_5M")(dtype=jnp.bfloat16).apply(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
    pnet = BackboneRegistry.get_by_name("ncsnpp_v2_5M")(image_size=16, serve_dtype=BF16).eval()
    pnet.load_state_dict(backbone_state_dict_from_flax("ncsnpp_v2_5M", params))
    args = tuple(map(torch.as_tensor, (x, y, t)))
    with torch.no_grad():
        got = pnet(*args)
        pnet.serve_dtype = torch.float32
        f64 = pnet.double()(args[0].to(torch.complex128), args[1].to(torch.complex128),
                            args[2].double())
    assert got.dtype == torch.complex64 and got.shape == shape
    _gates(got, want, f64, 3e-2)


# -- the serving path -----------------------------------------------------------------------


NET = dict(n_layers=2, emb_dim=16, hidden=16, qk_output_channel=4)
MODEL = dict(n_fft=64, hop_length=32)


def test_two_step_serve_bf16_matches_jax(monkeypatch):
    """A 2-step zero-noise ``sde_ei`` serve through ``FDBM.enhance_batch``
    at ``inference_dtype="bfloat16"`` in both packages (the JAX serving
    twin on its Pallas route), a narrow TF-GridNet on the same Flax weights;
    every sampler state stays complex64. Readings: rel 2.6e-2 to JAX, 2.2e-2
    / 2.5e-2 to the port's float64 network in the same sampler."""
    monkeypatch.setattr(jsampling, "complex_normal_like", lambda key, x: jnp.zeros_like(x))
    monkeypatch.setattr(psampling, "complex_normal_like",
                        lambda x, generator=None: torch.zeros_like(x))
    jf = jmodel.FDBM(jmodel.FDBMConfig(inference_dtype="bfloat16", **MODEL))
    jf.dnn = jtfg.TFGridNet(**NET)
    jf.dnn_sample = jtfg.TFGridNet(dtype=jnp.bfloat16, use_pallas=True, **NET)
    params = _perturbed(jf.init_params(jax.random.PRNGKey(0)), 3)
    audio = (0.3 * np.random.default_rng(3).standard_normal((2, 1500))).astype(np.float32)
    want = jf.enhance_batch(params, jnp.asarray(audio), jax.random.PRNGKey(0),
                            sampler_type="sde_ei", N=2)

    pf = pmodel.FDBM(pmodel.FDBMConfig(inference_dtype="bfloat16", **MODEL), device="cpu")
    assert pf.serve_dtype == BF16
    pf.dnn = ptfg.TFGridNet(serve_dtype=BF16, **NET).eval()
    pf.dnn.load_state_dict(tfgridnet_from_flax(params))
    states = []
    call = pf.dnn.forward
    monkeypatch.setattr(pf.dnn, "forward", lambda x, y, t: states.append((x.dtype, y.dtype))
                        or call(x, y, t))
    got = pf.enhance_batch(torch.as_tensor(audio), sampler_type="sde_ei", N=2)
    assert states and all(s == (torch.complex64, torch.complex64) for s in states)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pf.dnn.parameters())

    class F64(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net.double()

        def forward(self, x, y, t):
            return self.net(x.to(torch.complex128), y.to(torch.complex128),
                            t.double()).to(x.dtype)

    monkeypatch.undo()
    monkeypatch.setattr(psampling, "complex_normal_like",
                        lambda x, generator=None: torch.zeros_like(x))
    f64 = pmodel.FDBM(pmodel.FDBMConfig(**MODEL), device="cpu")
    net = ptfg.TFGridNet(**NET)
    net.load_state_dict(tfgridnet_from_flax(params))
    f64.dnn = F64(net).eval()
    ref = f64.enhance_batch(torch.as_tensor(audio), sampler_type="sde_ei", N=2)
    _gates(got, want, ref, 4e-2)


def test_bf16_config_resolution():
    """``compute_dtype`` and ``inference_dtype`` as the JAX package resolves
    them (``fdbm_tpu/model.py:162,177-180``): the serving dtype is
    ``inference_dtype``, or ``compute_dtype`` where it is ``""``, so
    ``compute_dtype: bfloat16`` trains and serves in bf16 unless
    ``inference_dtype: float32``; a dtype that is neither float32 nor
    bfloat16 raises; ``param_dtype`` is read nowhere, as in the JAX
    package; parameters stay fp32 and each backbone gets both dtypes."""
    cfg = pmodel.FDBMConfig
    assert pmodel.serving_dtype(cfg()) == torch.float32
    assert pmodel.serving_dtype(cfg(inference_dtype="bfloat16")) == BF16
    assert pmodel.serving_dtype(cfg(inference_dtype="float32")) == torch.float32
    assert pmodel.serving_dtype(cfg(param_dtype="bfloat16")) == torch.float32
    assert pmodel.training_dtype(cfg()) == torch.float32
    for kw, train, serve in ((dict(compute_dtype="bfloat16"), BF16, BF16),
                             (dict(compute_dtype="bfloat16", inference_dtype="float32"),
                              BF16, torch.float32),
                             (dict(inference_dtype="bfloat16"), torch.float32, BF16)):
        f = pmodel.FDBM(cfg(n_fft=32, hop_length=16, **kw), device="cpu")
        assert (f.train_dtype, f.serve_dtype) == (train, serve), kw
        assert (f.dnn.train_dtype, f.dnn.serve_dtype) == (train, serve), kw
        jf = jmodel.FDBM(jmodel.FDBMConfig(**kw))
        want = lambda net: BF16 if net.dtype == jnp.bfloat16 else torch.float32
        assert (want(jf.dnn), want(jf.dnn_sample)) == (train, serve), kw
    for bad in (dict(inference_dtype="float16"), dict(compute_dtype="float16"),
                dict(compute_dtype="float16", inference_dtype="bfloat16")):
        with pytest.raises(ValueError):
            pmodel.serving_dtype(cfg(**bad))
    f = pmodel.FDBM(cfg(backbone="ncsnpp_v2_5M", compute_dtype="bfloat16", n_fft=32,
                        hop_length=16), device="cpu")
    assert (f.dnn.train_dtype, f.dnn.serve_dtype) == (BF16, BF16)
    assert all(p.dtype == torch.float32 for p in f.dnn.parameters())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A random ``tfgridnet_4l32c80`` model file saved at fp32 and two wavs."""
    tmp = tmp_path_factory.mktemp("bf16_cli")
    torch.manual_seed(0)
    fdbm = pmodel.FDBM(pmodel.FDBMConfig(backbone="tfgridnet_4l32c80", **MODEL), device="cpu")
    ckpt = str(tmp / "model.pt")
    save_checkpoint(ckpt, fdbm)
    rng = np.random.default_rng(0)
    for name, n in (("a.wav", 1500), ("b.wav", 2300)):
        (tmp / "noisy").mkdir(exist_ok=True)
        write_wav(str(tmp / "noisy" / name), (0.2 * rng.standard_normal(n)).astype(np.float32),
                  16000)
    return tmp, ckpt


def test_infer_single_cli_bf16_on_cpu(served):
    tmp, ckpt = served
    out = str(tmp / "single.wav")
    infer_single.main(["-C", str(REPO / "configs" / "config_infer_single.yaml"), "--device",
                       "cpu", f"ckpt={ckpt}", f"noisy_file={tmp / 'noisy' / 'a.wav'}",
                       f"output_file={out}", "N=2", "sampler_type=sde_ei",
                       "inference_dtype=bfloat16"])
    audio, sr = read_wav(out)
    assert audio.shape == (1, 1500) and sr == 16000 and np.isfinite(audio).all()
    # The stored config (inference_dtype "") does not pin the serving dtype.
    served_model = load_checkpoint(ckpt, device="cpu", overrides={"inference_dtype": "bfloat16"})
    assert served_model.dnn.serve_dtype == BF16
    assert all(p.dtype == torch.float32 for p in served_model.dnn.parameters())
    assert load_checkpoint(ckpt, device="cpu").dnn.serve_dtype == torch.float32


def test_bf16_override_reaches_every_checkpoint_kind(served, tmp_path):
    """``inference_dtype=bfloat16`` as a YAML key of the serving config, and
    as an override of a training run's slot and of a reference ``.ckpt``
    (the JAX CLI's ``{**meta, **overrides}``); a predictive model serves its
    one call in bf16 too."""
    from fdbm_tpu.utils.torch_export import save_reference_checkpoint
    from fdbm_tpu_torch.checkpoint import CheckpointManager
    from fdbm_tpu_torch.config import load_config

    tmp, ckpt = served
    yaml = tmp_path / "serve.yaml"
    yaml.write_text((REPO / "configs" / "config_infer_single.yaml").read_text()
                    + "\ninference_dtype: bfloat16\n")
    cfg = load_config(str(yaml), {"ckpt": ckpt})
    assert load_checkpoint(ckpt, device="cpu", overrides=cfg).serve_dtype == BF16

    torch.manual_seed(1)
    pred = pmodel.FDBM(pmodel.FDBMConfig(backbone="tfgridnet_4l32c80_predictive",
                                         mode="predictive", **MODEL), device="cpu")
    CheckpointManager(str(tmp_path / "run" / "checkpoints")).save(pred, pmodel.TrainState(pred.dnn))
    served_pred = load_checkpoint(str(tmp_path / "run"), device="cpu",
                                  overrides={"inference_dtype": "bfloat16"})
    assert served_pred.cfg.mode == "predictive" and served_pred.serve_dtype == BF16
    calls = []
    call = served_pred.dnn.forward
    served_pred.dnn.forward = lambda x, y, t=None: calls.append(
        served_pred.dnn.serve_dtype) or call(x, y, t)
    out = served_pred.enhance_batch(torch.zeros(1, 1500).uniform_(-0.3, 0.3))
    assert calls == [BF16] and torch.isfinite(out).all()

    x0 = jnp.zeros((1, 1, 33, 8), jnp.complex64)
    params = JaxRegistry.get_by_name("tfgridnet_4l32c80")().init(jax.random.PRNGKey(0), x0, x0,
                                                                 jnp.ones((1,)))
    ref = str(tmp_path / "ref.ckpt")
    save_reference_checkpoint(ref, "tfgridnet_4l32c80", jax.device_get(params),
                              hyper_parameters=dict(n_fft=64, hop_length=32))
    imported = load_checkpoint(ref, device="cpu", overrides={"inference_dtype": "bfloat16"})
    assert imported.serve_dtype == BF16 and imported.dnn.serve_dtype == BF16
    assert all(p.dtype == torch.float32 for p in imported.dnn.parameters())


def test_infer_folder_cli_bf16_on_cpu(served):
    tmp, ckpt = served
    stats = infer_folder.main([
        "-C", str(REPO / "configs" / "config_infer_folder.yaml"), "--device", "cpu",
        "--batch_size", "2", f"ckpt={ckpt}", f"test_dir={tmp / 'noisy'}",
        f"enhanced_dir={tmp / 'enhanced'}", "N=2", "sampler_type=sde_ei",
        "inference_dtype=bfloat16"])
    assert (stats.files, stats.failures) == (2, 0)
    for name, n in (("a.wav", 1500), ("b.wav", 2300)):
        audio, _ = read_wav(str(tmp / "enhanced" / name))
        assert audio.shape[-1] == n and np.isfinite(audio).all()
