"""The port's NCSN++ against fdbm_tpu's, module by module, on the CPU.

Inputs are seeded numpy; JAX runs on the CPU. Every module gets the same
parameters on both sides through ``utils/weights.ncsnpp_from_flax``, drawn
at fan-in scale for every leaf (``fan_in_params``): the score-SDE init
(``default_init`` with ``init_scale=0``) makes every ``conv1``, attention
``proj`` and ``pyr_conv`` about 1e-10 in scale, and on those weights a
port that dropped the time embedding or an attention would still pass a
1e-4 gate. ``test_zeroed_branch_moves_the_output`` is the sentinel that
holds the test weights to that: zeroing any one group of leaves moves
``ncsnpp_v2_5M``'s output by more than 1e-2.

The gate is PARITY.md's fp32 module gate, rel-L2 < 1e-4 (the readings are
near 1e-6). ``upfirdn2d`` is also held to an asymmetric kernel, which shows
a wrong flip that [1,3,3,1] hides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu.models import BackboneRegistry as JaxRegistry
from fdbm_tpu.models import ncsnpp as jncsn
from fdbm_tpu.utils import torch_port as jax_torch_port
from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.models import ncsnpp as pncsn
from fdbm_tpu_torch.ops import upfirdn2d as pfir
from fdbm_tpu_torch.utils import torch_port
from fdbm_tpu_torch.utils.weights import backbone_state_dict_from_flax, ncsnpp_from_flax

# fdbm_tpu.ops exports the function upfirdn2d under the module's name.
jfir = importlib.import_module("fdbm_tpu.ops.upfirdn2d")

NAMES = ("ncsnpp_v2", "ncsnpp_v2_5M", "ncsnpp_v2_16M", "ncsnpp_v2_37M", "ncsnpp_v2_predictive",
         "ncsnpp_v2_5M_predictive")
TOL = 1e-4
ASYM = (1, 2, 3, 4)
# nf=16, three levels, one block: attention fires where H is 8 or 4 (levels
# 1 and 2 of a 16-bin input), down, up and in the middle.
SMALL = dict(nf=16, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(8, 4))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def fan_in_params(params, seed=0):
    """Every Dense/Conv kernel N(0, 1/fan_in), every bias 0.1 N(0, 1), every
    GroupNorm scale 1 + 0.1 N(0, 1); ``time_emb.W`` as initialised."""
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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nhwc(rng, shape, mean=0.0):
    return (rng.standard_normal(shape) + mean).astype(np.float32)


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _from_nchw(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _spec(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.5).astype(
        np.complex64)


def _pair(jm, pm, *args):
    """``jm`` on fan-in params for ``args`` (numpy, NHWC) and ``pm`` with the
    same weights on the NCHW arguments: (port output, JAX output)."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = fan_in_params(jm.init(jax.random.PRNGKey(0), *jargs))
    pm.load_state_dict(ncsnpp_from_flax(params))
    want = np.asarray(jm.apply(params, *jargs))
    pargs = [None if a is None else (_to_nchw(a) if a.ndim == 4 else torch.from_numpy(a))
             for a in args]
    with torch.no_grad():
        got = _from_nchw(pm(*pargs))
    return got, want


# -- FIR resampling -----------------------------------------------------------------------


@pytest.mark.parametrize("taps", [(1, 3, 3, 1), ASYM], ids=["fir1331", "asym1234"])
@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (3, 2))])
def test_upfirdn2d_matches_jax(up, down, pad, taps):
    """The four cases of tests/test_ncsnpp_ops.py; (2, 1, (2, 1)) takes the
    transposed-convolution route, the others the padded correlation."""
    x = _nhwc(np.random.default_rng(0), (2, 8, 9, 3))
    kern = jfir.setup_fir_kernel(taps)
    want = np.asarray(jfir.upfirdn2d(jnp.asarray(x), jnp.asarray(kern), up, down, pad))
    got = _from_nchw(pfir.upfirdn2d(_to_nchw(x), torch.from_numpy(kern), up, down, pad))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("taps", [(1, 3, 3, 1), ASYM], ids=["fir1331", "asym1234"])
@pytest.mark.parametrize("size", [(8, 12), (7, 9)], ids=["even", "odd"])
@pytest.mark.parametrize("which", ["upsample_2d", "downsample_2d"])
def test_resampling_matches_jax(which, size, taps):
    x = _nhwc(np.random.default_rng(1), (2, *size, 3))
    want = np.asarray(getattr(jfir, which)(jnp.asarray(x), taps))
    got = _from_nchw(getattr(pfir, which)(_to_nchw(x), taps))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


# -- layers -------------------------------------------------------------------------------


@pytest.mark.parametrize("act", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("channels", [16, 96, 384])
def test_group_norm_act_matches_jax(channels, act):
    """384 channels are the concatenated up-path inputs, in groups of 12;
    a mean of 3 against a spread of 1 exercises the E[x^2] - mu^2 form."""
    x = _nhwc(np.random.default_rng(2), (2, 8, 6, channels), mean=3.0)
    jm = jncsn.GroupNormAct(num_groups=jncsn._gn_groups(channels), act=act)
    pm = pncsn.GroupNormAct(channels, act=act)
    assert pm.num_groups == jm.num_groups
    got, want = _pair(jm, pm, x)
    assert _rel(got, want) < TOL


def test_attn_block_matches_jax():
    x = _nhwc(np.random.default_rng(3), (2, 4, 6, 32))
    got, want = _pair(jncsn.AttnBlock(channels=32), pncsn.AttnBlock(32), x)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("temb", [False, True], ids=["no_temb", "temb"])
@pytest.mark.parametrize("kind,out_ch", [("plain", 16), ("widen", 32), ("up", 16),
                                         ("down", 16)])
def test_resnet_block_matches_jax(kind, out_ch, temb):
    rng = np.random.default_rng(4)
    x = _nhwc(rng, (2, 8, 6, 16))
    e = _nhwc(rng, (2, 24)) if temb else None
    flags = dict(up=kind == "up", down=kind == "down")
    jm = jncsn.ResnetBlockBigGAN(in_ch=16, out_ch=out_ch, temb_dim=24 if temb else 0, **flags)
    pm = pncsn.ResnetBlockBigGAN(16, out_ch, 24 if temb else 0, **flags)
    assert hasattr(pm, "shortcut") == (kind != "plain")
    got, want = _pair(jm, pm, x, e)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


# -- the network --------------------------------------------------------------------------


@pytest.mark.parametrize("time_conditioned", [True, False], ids=["generative", "predictive"])
def test_small_ncsnpp_matches_jax(time_conditioned):
    """Odd bin count (17: sliced to 16 and a zero row appended), attention
    down, up and in the middle."""
    rng = np.random.default_rng(5)
    x, y = _spec(rng, (2, 1, 17, 12)), _spec(rng, (2, 1, 17, 12))
    t = np.array([0.3, 0.8], np.float32)
    jm = jncsn.NCSNpp(time_conditioned=time_conditioned, **SMALL)
    pm = pncsn.NCSNpp(time_conditioned=time_conditioned, image_size=16, **SMALL)
    assert {n for n in pm._modules if "attn" in n} == {
        "down_attn_1_0", "down_attn_2_0", "mid_attn", "up_attn_1", "up_attn_2"}
    args = (x, y, t) if time_conditioned else (None, y)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = fan_in_params(jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs))
    pm.load_state_dict(ncsnpp_from_flax(params))
    want = np.asarray(jax.jit(jm.apply)(params, *jargs))
    with torch.no_grad():
        got = pm(*[None if a is None else torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == want.shape == (2, 1, 17, 12)
    assert not got[:, :, -1].any()
    assert _rel(got, want) < TOL


@pytest.fixture(scope="module")
def v2_5m():
    """``ncsnpp_v2_5M`` at [1, 1, 257, 64] on fan-in params: the JAX output
    and the port's module with the same weights, and the inputs."""
    rng = np.random.default_rng(6)
    x, y = _spec(rng, (1, 1, 257, 64)), _spec(rng, (1, 1, 257, 64))
    t = np.array([0.6], np.float32)
    jm = JaxRegistry.get_by_name("ncsnpp_v2_5M")()
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
    params = fan_in_params(jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs))
    want = np.asarray(jax.jit(jm.apply)(params, *jargs))
    pm = BackboneRegistry.get_by_name("ncsnpp_v2_5M")().eval()
    pm.load_state_dict(ncsnpp_from_flax(params))
    return pm, tuple(torch.from_numpy(a) for a in (x, y, t)), want


def test_ncsnpp_v2_5m_matches_jax(v2_5m):
    pm, args, want = v2_5m
    with torch.no_grad():
        got = pm(*args).numpy()
    assert _rel(got, want) < TOL


# Each group of leaves the parity tests would miss on default-init weights.
GROUPS = {"conv0": lambda n: ".conv0." in n, "conv1": lambda n: ".conv1." in n,
          "temb_proj": lambda n: ".temb_proj." in n, "time_fc0": lambda n: n.startswith("time_fc0"),
          "mid_attn": lambda n: n.startswith("mid_attn."), "q": lambda n: ".q." in n}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_zeroed_branch_moves_the_output(v2_5m, group):
    """The sentinel: under the test weights zeroing one group of leaves moves
    the output by more than 1e-2, so a port that dropped it fails the gate."""
    pm, args, _ = v2_5m
    saved = {n: p.detach().clone() for n, p in pm.named_parameters() if GROUPS[group](n)}
    assert saved
    with torch.no_grad():
        ref = pm(*args)
        try:
            for n, p in pm.named_parameters():
                if n in saved:
                    p.zero_()
            moved = pm(*args)
        finally:
            for n, p in pm.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
    assert float((moved - ref).norm() / ref.norm()) > 1e-2


def test_attention_placement_is_held_to_the_bin_count():
    """A net built for 16 bins refuses 32 (its attention would move)."""
    pm = pncsn.NCSNpp(image_size=16, **SMALL)
    y = torch.zeros(1, 1, 33, 8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="image_size"):
        pm(y, y, torch.ones(1))


# -- weights ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_registered_variants_convert_from_their_flax_trees(name):
    """Every registered name builds in the port, and the Flax tree of the
    JAX package's variant (``jax.eval_shape`` at 257 bins, no init) converts
    to the port's keys and shapes; the reference .ckpt presets are the JAX
    package's."""
    jm = JaxRegistry.get_by_name(name)()
    spec = jax.ShapeDtypeStruct((1, 1, 257, 64), jnp.complex64)
    args = (None, spec) if name.endswith("_predictive") else (
        spec, spec, jax.ShapeDtypeStruct((1,), jnp.float32))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    flax = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = backbone_state_dict_from_flax(name, flax)
    got = BackboneRegistry.get_by_name(name)().state_dict()
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert torch_port._NCSNPP_PRESETS[name] == jax_torch_port._NCSNPP_PRESETS[name]


def test_flax_converter_dispatch_by_name():
    with pytest.raises(ValueError, match="No Flax converter"):
        backbone_state_dict_from_flax("resnet", {})
