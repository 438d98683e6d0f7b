"""The port's folder serving against fdbm_tpu, on the CPU.

The batch plan (``plan``, ``_dispatch_width``, ``_bucket_length`` with and
without pooled chunks, ``_chunk_plan``) and the cross-fade (``_overlap_add``)
must equal the JAX package's exactly, over many lengths. The slice as a
whole: ``enhance_folder`` of both packages on one folder of seven wavs of
mixed lengths (one in a subfolder), a narrow TF-GridNet on the same Flax
weights, ``sde_ei`` with N=2 at batch 4 (so a remainder width is
dispatched), and a small ``chunk_seconds`` (so files are pooled and
cross-faded), with every draw set to zero in both packages, so both runs are
deterministic. Tolerance: each written wav within rel-L2 1e-4 (PARITY.md's
fp32 module gate; two steps add little to the per-call difference).
``ode_ei`` is not the sampler here: its first step on the bb schedule
computes x1 = 4999.5 x0 - 4999.0 y + 0.4999 est with x0 = y, so its fp32
rounding (4.5e-5 of x1, the same bits in both packages on the same input)
changes with any difference in the input; a 1.8e-7 difference between the
two packages' STFTs reaches 3.3e-4 at the output after N=2, the port against
itself. The CLI serves a folder on the CPU, and counts an unreadable file
and a NaN output as failures.
"""

import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fdbm_tpu import infer as jinfer
from fdbm_tpu import model as jmodel
from fdbm_tpu import sampling as jsampling
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu_torch import infer as pinfer
from fdbm_tpu_torch import infer_folder
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import sampling as psampling
from fdbm_tpu_torch.checkpoint import save_checkpoint
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
NET = dict(n_layers=1, emb_dim=8, hidden=8)
MODEL = dict(n_fft=64, hop_length=32)
CHUNK_SECONDS = 0.128  # a 2048-sample target: 512-sample grid and overlap
LENGTHS = {"a.wav": 900, "b.wav": 1700, "c.wav": 2600, "sub/d.wav": 4400, "e.wav": 4500,
           "f.wav": 6100, "g.wav": 8500}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _enhancers(hop=256, sr=16000, batch_size=16, multiple=64, chunk_seconds=None):
    fdbm = SimpleNamespace(cfg=SimpleNamespace(hop_length=hop, sr=sr))
    return (jinfer.BucketedEnhancer(fdbm, None, batch_size=batch_size,
                                    bucket_frames_multiple=multiple, chunk_seconds=chunk_seconds),
            pinfer.BucketedEnhancer(fdbm, batch_size=batch_size, bucket_frames_multiple=multiple,
                                    chunk_seconds=chunk_seconds))


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(1, 700_000), min_size=1, max_size=40),
       batch_size=st.sampled_from([1, 3, 8, 16]), multiple=st.sampled_from([1, 16, 64]),
       chunk_seconds=st.sampled_from([None, 4.096, 2.0]))
def test_plan_and_buckets_match_jax(lengths, batch_size, multiple, chunk_seconds):
    jax_e, port_e = _enhancers(batch_size=batch_size, multiple=multiple,
                               chunk_seconds=chunk_seconds)
    assert port_e.plan(lengths) == jax_e.plan(lengths)
    for n in lengths:
        assert port_e._bucket_length(n) == jax_e._bucket_length(n)
    for rows in range(1, 2 * batch_size + 1):
        assert port_e._dispatch_width(rows) == jax_e._dispatch_width(rows)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 2_000_000), chunk_seconds=st.sampled_from([4.096, 2.0, 8.0, 1.0]),
       hop=st.sampled_from([256, 128]))
def test_chunk_plan_matches_jax(n, chunk_seconds, hop):
    jax_e, port_e = _enhancers(hop=hop, chunk_seconds=chunk_seconds)
    assert port_e._chunk_plan(n) == jax_e._chunk_plan(n)


@pytest.mark.parametrize("n", [5000, 9000, 20000, 33000, 100_000])
def test_chunk_plan_stays_on_the_grid_for_a_tiny_target(n):
    """A target tiny against the 16-frame overlap (0.05 s at hop 256): the
    chunks still run at their own length on the fine grid, in the band
    where _bucket_length uses it (fdbm_tpu's fallback may leave it)."""
    _, port_e = _enhancers(chunk_seconds=0.05)
    chunk_len, starts = port_e._chunk_plan(n)
    assert port_e._bucket_length(chunk_len) == chunk_len or chunk_len == n
    assert starts[0] == 0 and starts[-1] + chunk_len == n
    assert all(b - a <= chunk_len - 16 * 256 for a, b in zip(starts, starts[1:]))


@settings(max_examples=60, deadline=None)
@given(total=st.integers(100, 20_000), data=st.data())
def test_overlap_add_matches_jax(total, data):
    ramp = data.draw(st.integers(1, 600))
    n = data.draw(st.integers(min(total, ramp), total))
    starts = sorted(set(data.draw(st.lists(st.integers(0, total - n), min_size=1,
                                           max_size=5)) + [0, total - n]))
    rng = np.random.default_rng(total)
    segs = [(s, rng.standard_normal(n).astype(np.float32)) for s in starts]
    np.testing.assert_array_equal(pinfer.overlap_add(total, segs, ramp),
                                  jinfer.BucketedEnhancer._overlap_add(total, segs, ramp))


def _write_folder(root, lengths, seed=0):
    rng = np.random.default_rng(seed)
    for name, n in lengths.items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wav = 0.1 * rng.standard_normal(n) + 0.3 * np.sin(np.arange(n) * rng.uniform(0.02, 0.2))
        write_wav(path, wav.astype(np.float32), 16000)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    _write_folder(str(root / "noisy"), LENGTHS)
    return root


@pytest.fixture(scope="module")
def models():
    """A narrow TF-GridNet in both packages on the same perturbed Flax weights."""
    jf = jmodel.FDBM(jmodel.FDBMConfig(**MODEL))
    jf.dnn = jf.dnn_sample = jtfg.TFGridNet(**NET)
    params = jf.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))
    pf = pmodel.FDBM(pmodel.FDBMConfig(**MODEL), device="cpu")
    pf.dnn = TFGridNet(**NET).eval()
    pf.dnn.load_state_dict(tfgridnet_from_flax(params))
    return jf, params, pf


def _written(root):
    return {str(p.relative_to(root)): read_wav(str(p))[0][0]
            for p in sorted(Path(root).rglob("*.wav"))}


def test_enhance_folder_matches_jax(folder, models, monkeypatch):
    jf, params, pf = models
    monkeypatch.setattr(jsampling, "complex_normal_like", lambda key, x: jnp.zeros_like(x))
    monkeypatch.setattr(psampling, "complex_normal_like",
                        lambda x, generator=None: torch.zeros_like(x))
    kw = dict(sampler_type="sde_ei", N=2, batch_size=4, chunk_seconds=CHUNK_SECONDS,
              progress=False)
    want = jinfer.enhance_folder(jf, params, str(folder / "noisy"), str(folder / "jax"),
                                 process_index=0, process_count=1, **kw)
    pieces = [len(pinfer.BucketedEnhancer(pf, chunk_seconds=CHUNK_SECONDS)._chunk_plan(n)[1])
              for n in LENGTHS.values()]
    assert sum(pieces) % 4 and max(pieces) > 1  # a remainder width, and pooled chunks
    calls = []
    enhance = pf.enhance_batch
    monkeypatch.setattr(pf, "enhance_batch", lambda b, *a, **k: calls.append(b.shape[0])
                        or enhance(b, *a, **k))
    got = pinfer.enhance_folder(pf, str(folder / "noisy"), str(folder / "port"), **kw)
    assert (got.files, got.failures) == (want.files, want.failures) == (len(LENGTHS), 0)
    assert abs(got.audio_seconds - want.audio_seconds) < 1e-9
    assert calls[-1] < 4 and sum(calls) >= sum(pieces)
    jax_out, port_out = _written(folder / "jax"), _written(folder / "port")
    assert sorted(port_out) == sorted(jax_out) == sorted(LENGTHS)
    for name, w in jax_out.items():
        g = port_out[name]
        assert g.shape == w.shape == (LENGTHS[name],)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-4, name


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    fdbm = pmodel.FDBM(pmodel.FDBMConfig(backbone="tfgridnet_4l32c80", **MODEL), device="cpu")
    path = str(tmp / "model.pt")
    save_checkpoint(path, fdbm)
    return path


def _cli(ckpt, test_dir, out_dir, *extra):
    return infer_folder.main([
        "-C", str(REPO / "configs" / "config_infer_folder.yaml"), "--device", "cpu",
        "--batch_size", "4", f"ckpt={ckpt}", f"test_dir={test_dir}", f"enhanced_dir={out_dir}",
        "N=2", "sampler_type=sde_ei", *extra])


@pytest.mark.parametrize("chunk_seconds", ["0.128", "0"])
def test_folder_cli_on_cpu(tmp_path, ckpt, capsys, chunk_seconds):
    lengths = {"x.wav": 700, "y.wav": 2600, "deep/z.wav": 5000}
    _write_folder(str(tmp_path / "in"), lengths, seed=3)
    (tmp_path / "in" / "broken.wav").write_bytes(b"not a wav")
    stats = _cli(ckpt, tmp_path / "in", tmp_path / "out", "--chunk_seconds", chunk_seconds)
    assert (stats.files, stats.failures) == (3, 1)
    out = _written(tmp_path / "out")
    assert sorted(out) == sorted(lengths)
    for name, x in out.items():
        assert x.shape == (lengths[name],) and np.isfinite(x).all() and np.abs(x).max() <= 1.0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"files": 3, "failures": 1' in line and "audio_sec_per_sec" in line


def test_folder_cli_counts_nan_outputs_as_failures(tmp_path, ckpt, monkeypatch):
    _write_folder(str(tmp_path / "in"), {"x.wav": 700, "y.wav": 2600}, seed=4)
    monkeypatch.setattr(pmodel.FDBM, "enhance_batch",
                        lambda self, y, *a, **k: torch.full_like(y, float("nan")))
    stats = _cli(ckpt, tmp_path / "in", tmp_path / "out")
    assert (stats.files, stats.failures) == (0, 2)
    assert not (tmp_path / "out").exists()


def test_folder_cli_refuses_a_mesh(tmp_path, ckpt):
    """``--mesh_devices`` splits batches over the visible cards: a mesh of
    more cards than are visible is refused before anything is read."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"Requested {n} devices, have {n - 1}"):
        _cli(ckpt, tmp_path, tmp_path / "out", "--device", "cuda", "--mesh_devices", str(n))
    assert not (tmp_path / "out").exists()
