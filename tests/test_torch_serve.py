"""The port's serving path against fdbm_tpu, and its independence from it,
on the CPU.

Both EI samplers run end to end at n_fft 64, N=2, over a narrow TF-GridNet
whose Flax weights reach the port through utils/weights.py, on the same
noise: the SDE sampler's draws are injected with ``noise=``, and the ODE
sampler's prior is the JAX ``complex_normal_like`` draw handed to the port
as ``z=``. Tolerance: rel-L2 < 1e-4 on the sampled spectrogram (PARITY.md's
module gate; two steps add little to the per-call fp32 difference).
"""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import dsp as jdsp
from fdbm_tpu import sampling as jsampling
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu_torch import infer_single, ops
from fdbm_tpu_torch import sampling as psampling
from fdbm_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from fdbm_tpu_torch.infer import bucket_length, pad_to
from fdbm_tpu_torch.model import FDBM, FDBMConfig
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
N_FFT, HOP, N_STEPS = 64, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many tiny products, and
    the test workers share the machine's cores (oversubscribed BLAS threads
    spin instead of working)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """A narrow TF-GridNet in both frameworks on the same weights, and a
    compressed noisy spectrogram y [1, 1, 33, T]."""
    rng = np.random.default_rng(0)
    audio = (0.3 * rng.standard_normal((1, 480))).astype(np.float32)
    window = jdsp.get_window("sqrthann", N_FFT)
    y = np.array(jdsp.spec_fwd(jdsp.stft(jnp.asarray(audio), N_FFT, HOP,
                                         jnp.asarray(window))))[:, None]
    jm = jtfg.TFGridNet(n_layers=1, emb_dim=8, hidden=8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y),
                     jnp.ones((1,), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))
    pm = TFGridNet(n_layers=1, emb_dim=8, hidden=8).eval()
    pm.load_state_dict(tfgridnet_from_flax(params))
    jfn = lambda x, yy, t: jm.apply(params, x, yy, t)
    return jfn, pm, y, audio, window


def _bridges(sampler):
    kw = dict(N=N_STEPS, sampler_type=sampler, noise_schedule="bb")
    return jsampling.Bridge.create("sb", **kw), psampling.Bridge.create("sb", **kw)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_sde_ei_matches_jax_on_injected_noise(pair):
    jfn, pm, y, _, _ = pair
    jb, pb = _bridges("sde_ei")
    rng = np.random.default_rng(1)
    noise = ((rng.standard_normal((N_STEPS + 1, *y.shape))
              + 1j * rng.standard_normal((N_STEPS + 1, *y.shape))) / np.sqrt(2)).astype(np.complex64)
    want = jb.sde_sampler_ei(jfn, jnp.asarray(y), jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    with torch.no_grad():
        got = pb.sde_sampler_ei(lambda x, yy, t: pm(x, yy, t), torch.as_tensor(y),
                                noise=torch.as_tensor(noise))
    assert got.shape == y.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-4


def test_ode_ei_matches_jax_on_the_jax_prior_draw(pair):
    jfn, pm, y, _, _ = pair
    jb, pb = _bridges("ode_ei")
    key = jax.random.PRNGKey(3)
    want = jb.ode_sampler_ei(jfn, jnp.asarray(y), key)
    z = np.array(jsampling.complex_normal_like(key, jnp.asarray(y)))  # JAX's prior draw
    with torch.no_grad():
        got = pb.sample(lambda x, yy, t: pm(x, yy, t), torch.as_tensor(y), z=torch.as_tensor(z))
    assert _rel(got.numpy(), want) < 1e-4


def test_sampler_surface():
    pb = psampling.Bridge.create("sb", N=4)
    grid = pb.time_grid()
    np.testing.assert_allclose(grid.numpy(), np.asarray(
        jsampling.Bridge.create("sb", N=4).time_grid()), rtol=1e-6)
    y = torch.zeros(2, 1, 3, 4, dtype=torch.complex64)
    g = torch.Generator().manual_seed(0)
    z = psampling.complex_normal_like(torch.zeros(20000, dtype=torch.complex64), g)
    assert abs(float(z.real.var()) - 0.5) < 0.02 and abs(float(z.imag.var()) - 0.5) < 0.02
    for sampler in ("pc", "ode_int"):
        with pytest.raises(NotImplementedError, match="later slice"):
            psampling.Bridge.create("sb", sampler_type=sampler).sample(None, y)
    with pytest.raises(ValueError):
        psampling.Bridge.create("sb", sampler_type="euler").sample(None, y)


def test_enhance_batch_front_end_matches_jax(pair):
    """FDBM.audio_to_spec / spec_to_audio are the JAX front end."""
    _, _, y, audio, window = pair
    fdbm = FDBM(FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=N_FFT, hop_length=HOP),
                device="cpu")
    spec = fdbm.audio_to_spec(torch.as_tensor(audio))
    np.testing.assert_allclose(spec.numpy(), y, rtol=0, atol=2e-5)
    back = fdbm.spec_to_audio(spec[:, 0], length=audio.shape[-1]).numpy()
    want = np.asarray(jdsp.istft(jdsp.spec_back(jnp.asarray(y[:, 0])), N_FFT, HOP,
                                 jnp.asarray(window), length=audio.shape[-1]))
    np.testing.assert_allclose(back, want, rtol=0, atol=5e-5)


def test_enhance_audio_normalises_and_restores_scale():
    torch.manual_seed(1)
    fdbm = FDBM(FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=N_FFT, hop_length=HOP),
                device="cpu")
    y = (0.2 * np.random.default_rng(4).standard_normal(700)).astype(np.float32)
    run = lambda a: fdbm.enhance_audio(a, torch.Generator().manual_seed(0),
                                       sampler_type="ode_ei", N=1)
    x = run(y)
    assert x.shape == (700,) and np.isfinite(x).all()
    # 'noisy' normalisation divides by the peak and multiplies it back; a
    # power-of-two gain keeps the normalised input bit-identical
    np.testing.assert_allclose(run(4 * y), 4 * x, rtol=1e-6, atol=0)


def test_bucket_padding_matches_jax_enhancer():
    """64-frame buckets and the reflect-tile pad of the JAX BucketedEnhancer."""
    assert bucket_length(64000, 256) == 65536 and bucket_length(100, 256) == 16384
    assert bucket_length(1000, 256, frames_multiple=1) == 1024
    a = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(pad_to(a, 12), [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 0, 1])
    np.testing.assert_array_equal(pad_to(a, 3), a[:3])


@pytest.mark.parametrize("name", ["config.yaml", "config_finetuning.yaml",
                                  "config_infer_single.yaml"])
def test_configs_load_into_the_serving_config(name):
    from fdbm_tpu_torch.config import load_config

    cfg = FDBMConfig.from_dict(load_config(str(REPO / "configs" / name)))
    assert cfg.backbone == "tfgridnet_5l32c100" and cfg.n_fft == 512


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FDBM(FDBMConfig())
    with pytest.raises(NotImplementedError):
        FDBM(FDBMConfig(inference_dtype="bfloat16"), device="cpu")


def test_infer_single_cli_on_cpu(tmp_path):
    torch.manual_seed(0)
    cfg = FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=N_FFT, hop_length=HOP)
    fdbm = FDBM(cfg, device="cpu")
    ckpt = str(tmp_path / "model.pt")
    save_checkpoint(ckpt, fdbm)
    reloaded = load_checkpoint(ckpt, device="cpu", overrides={"N": 7, "ckpt": ckpt})
    assert reloaded.cfg.N == 7 and reloaded.cfg.n_fft == N_FFT
    for (k, a), b in zip(fdbm.dnn.state_dict().items(), reloaded.dnn.state_dict().values()):
        assert torch.equal(a, b), k

    n = 1600
    rng = np.random.default_rng(2)
    noisy = str(tmp_path / "noisy.wav")
    write_wav(noisy, (0.3 * rng.standard_normal(n)).astype(np.float32), 16000)
    out = str(tmp_path / "sub" / "enhanced.wav")
    ops.reset_launch_counts()
    x_hat = infer_single.main([
        "-C", str(REPO / "configs" / "config_infer_single.yaml"), "--device", "cpu",
        f"ckpt={ckpt}", f"noisy_file={noisy}", f"output_file={out}",
        f"N={N_STEPS}", "sampler_type=sde_ei"])
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    written, sr = read_wav(out)
    assert sr == 16000 and written.shape == (1, n) and x_hat.shape == (n,)
    assert np.isfinite(written).all() and np.abs(x_hat).max() <= 1.0
    # one seed, one result
    again = infer_single.main([
        "-C", str(REPO / "configs" / "config_infer_single.yaml"), "--device", "cpu",
        f"ckpt={ckpt}", f"noisy_file={noisy}", f"output_file={out}",
        f"N={N_STEPS}", "sampler_type=sde_ei"])
    np.testing.assert_array_equal(again, x_hat)


_FORBIDDEN = ("jax", "flax", "optax", "orbax", "fdbm_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "fdbm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in _FORBIDDEN]
    assert bad == []


def test_import_checker_matches_module_names_exactly(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import fdbm_tpu_torch.ops\nfrom fdbm_tpu_torch import dsp\n"
                     "import jaxlib_like\nfrom fdbm_tpu.ops import x\nimport flax.linen as nn\n")
    found = [n for n in _imports(probe) if n.split(".")[0] in _FORBIDDEN]
    assert found == ["fdbm_tpu.ops", "flax.linen"]


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A random narrow model saved as a model file, and a noisy wav."""
    tmp = tmp_path_factory.mktemp("serve")
    torch.manual_seed(0)
    fdbm = FDBM(FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=N_FFT, hop_length=HOP),
                device="cpu")
    ckpt = str(tmp / "model.pt")
    save_checkpoint(ckpt, fdbm)
    noisy = str(tmp / "noisy.wav")
    write_wav(noisy, (0.3 * np.random.default_rng(2).standard_normal(1200)).astype(np.float32),
              16000)
    return ckpt, noisy, str(tmp)


@pytest.mark.parametrize("sampler", ["sde_ei", "ode_ei"])
def test_ei_samplers_drop_sampler_kwargs(small_ckpt, sampler):
    """An infer config's sampler_kwargs (rtol/atol of ode_int) are dropped by
    the EI samplers, as fdbm_tpu/sampling.py:Bridge.sample drops them."""
    ckpt, noisy, tmp = small_ckpt
    out = os.path.join(tmp, f"{sampler}.wav")
    x_hat = infer_single.main([
        "-C", str(REPO / "configs" / "config_infer_single.yaml"), "--device", "cpu",
        f"ckpt={ckpt}", f"noisy_file={noisy}", f"output_file={out}", "N=2",
        f"sampler_type={sampler}", "sampler_kwargs={rtol: 1e-5, atol: 1e-5}"])
    assert x_hat.shape == (1200,) and np.isfinite(x_hat).all()


@pytest.mark.parametrize("override", [
    "sampler_kwargs={snr: 0.5, corrector_steps: 1}", "k={rtol: 1e-5, atol: 1.0e-5}",
    "k={name: x, flag: true, n: null, q: 'a b'}", "k={}", "k={a, b: 2}", "k=[1, 2.5, x]",
    "lr=5e-4", "N=30", "k=null"])
def test_cli_overrides_parse_as_jax_parses_them(override):
    from fdbm_tpu.config import parse_cli_overrides as jax_parse
    from fdbm_tpu_torch.config import parse_cli_overrides

    assert parse_cli_overrides([override]) == jax_parse([override])


@pytest.mark.parametrize("n,max_len,hop", [(5000, 1600, 32), (4000, 1000, 64),
                                           (10000, 2500, 256), (1700, 1600, 32)])
def test_long_file_chunks_match_jax(n, max_len, hop):
    """The chunk starts and contents of fdbm_tpu's _enhance_long, and its
    cross-fade reassembly (BucketedEnhancer._overlap_add)."""
    from types import SimpleNamespace

    from fdbm_tpu.infer import BucketedEnhancer
    from fdbm_tpu_torch.infer import OVERLAP_FRAMES, chunk_starts, overlap_add

    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)

    class Recorder:  # stands in for the enhancer: records instead of enhancing
        fdbm = SimpleNamespace(cfg=SimpleNamespace(hop_length=hop))

        def enhance_many(self, chunks, key, clip_scale, max_seconds):
            return [0.5 * c for c in chunks]

        @staticmethod
        def _overlap_add(total_len, segments, ramp_len):
            return total_len, segments, ramp_len

    total, segments, ramp = BucketedEnhancer._enhance_long(Recorder(), audio,
                                                           jax.random.PRNGKey(0), 0.5, max_len)
    chunk_len, starts = chunk_starts(n, max_len, hop)
    assert starts == [s for s, _ in segments] and ramp == OVERLAP_FRAMES * hop
    for s, e in segments:
        np.testing.assert_array_equal(0.5 * audio[s:s + chunk_len], e)
    np.testing.assert_array_equal(overlap_add(total, segments, ramp),
                                  BucketedEnhancer._overlap_add(total, segments, ramp))


def test_long_file_is_enhanced_in_chunks(small_ckpt, monkeypatch):
    from fdbm_tpu_torch.infer import enhance_single

    ckpt, _, tmp = small_ckpt
    fdbm = load_checkpoint(ckpt, device="cpu")
    noisy = os.path.join(tmp, "long.wav")
    n = 3000
    write_wav(noisy, (0.3 * np.random.default_rng(3).standard_normal(n)).astype(np.float32),
              16000)
    calls = []
    enhance = fdbm.enhance_batch
    monkeypatch.setattr(fdbm, "enhance_batch", lambda b, *a, **k: calls.append(b.shape[-1])
                        or enhance(b, *a, **k))
    # max 0.1 s = 1600 samples: chunks of 1600 starting every 1600 - 16 * 32
    x_hat = enhance_single(fdbm, noisy, os.path.join(tmp, "long_out.wav"), sampler_type="ode_ei",
                           N=1, max_seconds=0.1)
    assert x_hat.shape == (n,) and np.isfinite(x_hat).all()
    assert len(calls) == 3
    assert read_wav(os.path.join(tmp, "long_out.wav"))[0].shape == (1, n)
