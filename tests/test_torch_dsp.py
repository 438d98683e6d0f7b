"""fdbm_tpu_torch's signal path, probability paths, config and WAV I/O
against fdbm_tpu, on the CPU.

Inputs come from numpy seeds and go to both packages as numpy arrays.
Tolerances: float32 round-off of the same formulas computed by two
libraries (XLA and PyTorch order their sums differently), stated per test.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import config as jconfig
from fdbm_tpu import dsp as jdsp
from fdbm_tpu import paths as jpaths
from fdbm_tpu.utils import audio as jaudio
from fdbm_tpu_torch import config as pconfig
from fdbm_tpu_torch import dsp as pdsp
from fdbm_tpu_torch import paths as ppaths
from fdbm_tpu_torch.utils import audio as paudio
from fdbm_tpu_torch.utils.registry import Registry

# The times tests/test_paths.py checks, float64 as there.
TS = np.array([0.0001, 0.03, 0.25, 0.5, 0.9, 0.999, 1.0], np.float64)


def _signal(n=1000, batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, n)).astype(np.float32)


@pytest.mark.parametrize("window", ["sqrthann", "hann"])
def test_get_window_matches(window):
    np.testing.assert_array_equal(pdsp.get_window(window, 64), jdsp.get_window(window, 64))
    with pytest.raises(NotImplementedError):
        pdsp.get_window("hamming", 64)


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (64, 16), (60, 25)])
def test_stft_istft_match(n_fft, hop):
    x = _signal()
    w = jdsp.get_window("sqrthann", n_fft)
    want = np.array(jdsp.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(w)))
    got = pdsp.stft(torch.as_tensor(x), n_fft, hop, torch.as_tensor(w)).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    # fp32 FFT round-off on O(10) magnitudes
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert got.shape[-1] == pdsp.num_frames_for_length(x.shape[-1], n_fft, hop)
    for length in (None, 1000, 1100):  # trim, exact, zero-padded past the signal
        iw = np.asarray(jdsp.istft(jnp.asarray(want), n_fft, hop, jnp.asarray(w), length=length))
        ip = pdsp.istft(torch.as_tensor(want), n_fft, hop, torch.as_tensor(w),
                        length=length).numpy()
        assert ip.shape == iw.shape
        np.testing.assert_allclose(ip, iw, rtol=0, atol=5e-5)


@pytest.mark.parametrize("transform_type", ["exponent", "log", "none"])
def test_spec_transforms_match(transform_type):
    x = _signal()
    w = jnp.asarray(jdsp.get_window("sqrthann", 64))
    spec = np.array(jdsp.stft(jnp.asarray(x), 64, 16, w))
    spec[0, 0, 0] = 0  # the origin guard
    want = np.array(jdsp.spec_fwd(jnp.asarray(spec), transform_type=transform_type))
    got = pdsp.spec_fwd(torch.as_tensor(spec), transform_type=transform_type).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back_w = np.asarray(jdsp.spec_back(jnp.asarray(want), transform_type=transform_type))
    back_p = pdsp.spec_back(torch.as_tensor(want), transform_type=transform_type).numpy()
    np.testing.assert_allclose(back_p, back_w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["spec_fwd", "spec_back"])
def test_unknown_transform_raises_like_jax(fn):
    spec = np.ones((1, 3, 4), np.complex64)
    for impl, arr in ((jdsp, jnp.asarray(spec)), (pdsp, torch.as_tensor(spec))):
        with pytest.raises(ValueError):  # exponent_diff too (PARITY.md divergence)
            getattr(impl, fn)(arr, transform_type="exponent_diff")


@pytest.mark.parametrize("mode", ["zero_pad", "reflection", "replication"])
@pytest.mark.parametrize("frames", [10, 64, 70])
def test_pad_spec_matches(mode, frames):
    rng = np.random.default_rng(1)
    spec = (rng.standard_normal((1, 1, 5, frames))
            + 1j * rng.standard_normal((1, 1, 5, frames))).astype(np.complex64)
    want = np.asarray(jdsp.pad_spec(jnp.asarray(spec), mode))
    got = pdsp.pad_spec(torch.as_tensor(spec), mode).numpy()
    np.testing.assert_array_equal(got, want)


def _path_pairs():
    for schedule in ("gmax", "vp", "ve", "bb"):
        yield (f"sb-{schedule}", jpaths.make_path("sb", noise_schedule=schedule),
               ppaths.make_path("sb", noise_schedule=schedule))
    yield "fm", jpaths.make_path("fm"), ppaths.make_path("fm")


PATHS = list(_path_pairs())


@pytest.mark.parametrize("name,jp,pp", PATHS, ids=[p[0] for p in PATHS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_paths_match_jax(name, jp, pp, dtype):
    """float32 times: the same fp32 formulas, rtol 1e-5. float64 times (as
    tests/test_paths.py uses them): the port computes in float64 while JAX
    casts to float32, so the marginals and the EI weights agree at
    tests/test_paths.py's own tolerances (2e-5 / 3e-5), with the EI steps
    between interior times as there; the instantaneous ODE/SDE weights are
    compared in float32 only. At t=1e-4 and t=1 those cancel to fp32 noise
    that a float64 result does not share."""
    # float64: EI steps between interior times, where fp32 keeps 5 digits
    ts = TS if dtype == torch.float32 else TS[1:-1]
    t_prev, t_curr = ts[1:], ts[:-1]
    as_t = lambda a: torch.as_tensor(a, dtype=dtype)
    fns = [("path_param", (TS,)), ("sigma_t", (TS,)),
           ("sampling_param_ode_ei", (t_curr, t_prev))]
    if name != "fm":
        fns.append(("sampling_param_sde_ei", (t_curr, t_prev)))
    if dtype == torch.float32:
        fns += [("ode_weights", (TS,)), ("sde_weights", (TS,))]
        rtol, atol = 1e-5, 1e-6
    else:
        rtol, atol = 3e-5, 2e-5
    for fn, args in fns:
        want = getattr(jp, fn)(*[jnp.asarray(a) for a in args])
        got = getattr(pp, fn)(*[as_t(a) for a in args])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            g = torch.as_tensor(g)
            assert g.dtype == dtype, (fn, g.dtype)
            w = np.broadcast_to(np.asarray(w), g.shape)
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                       atol=atol * (1 + np.abs(w).max()),
                                       err_msg=f"{name}.{fn}")


def test_path_registry_and_fm_sde():
    assert set(ppaths.BridgeRegistry.get_all_names()) == {"sb", "fm"}
    p = ppaths.make_path("sb", noise_schedule="vp", not_a_field=3)
    assert p.noise_schedule == "vp"
    with pytest.raises(NotImplementedError):
        ppaths.make_path("fm").sampling_param_sde_ei(0.5, 0.6)
    with pytest.raises(ValueError):
        ppaths.make_path("sb", noise_schedule="nope").sigma_t(0.5)


def test_registry_rejects_duplicates_and_unknown_names():
    reg = Registry("Thing")
    reg.register("a")(int)
    reg.register("a")(int)
    with pytest.raises(ValueError):
        reg.register("a")(float)
    with pytest.raises(ValueError, match="Available"):
        reg.get_by_name("b")
    assert "a" in reg and reg.get_all_names() == ["a"]


@pytest.mark.parametrize("name", ["config.yaml", "config_finetuning.yaml",
                                  "config_infer_folder.yaml", "config_infer_single.yaml",
                                  "config_predictive.yaml"])
def test_load_config_matches(name):
    path = f"configs/{name}"
    assert pconfig.load_config(path) == jconfig.load_config(path)
    over = {"N": 30, "sampler_type": "sde_ei", "ckpt": "/x/m.pt"}
    assert pconfig.load_config(path, over) == jconfig.load_config(path, over)


def test_cli_overrides_and_scalars_match_yaml():
    import yaml

    args = ["N=30", "lr=5e-4", "x=1.0e-4", "flag=true", "on=on", "name=sde_ei",
            "ckpt=/a/b.pt", "n=null", "neg=-3", "hexa=0x1f", "q='a b'", "lst=[1, 2.5, x]"]
    assert pconfig.parse_cli_overrides(args) == jconfig.parse_cli_overrides(args)
    for text in ["017", ".5", "-.inf", "yes", "Off", "~", "", "3.", "1_000", "+7", '"t\\tx"']:
        assert pconfig._scalar(text) == yaml.safe_load(text), text
    assert math.isnan(pconfig._scalar(".nan"))
    with pytest.raises(ValueError):
        pconfig.parse_cli_overrides(["no_equals_sign"])
    with pytest.raises(ValueError):
        pconfig.parse_yaml("a: &anchor 1\n")


def test_wav_io_and_resample_match(tmp_path):
    x = _signal(4000, 1, seed=3)[0] * 0.3
    for subtype in ("pcm16", "float32"):
        path = str(tmp_path / f"{subtype}.wav")
        paudio.write_wav(path, x, 16000, subtype)
        got, sr = paudio.read_wav(path)
        want, sr_j = jaudio.read_wav(path)
        assert sr == sr_j == 16000
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(paudio.resample(x, 22050, 16000),
                                  jaudio.resample(x, 22050, 16000))
