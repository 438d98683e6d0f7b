"""The port's native WAV loader (``fdbm_tpu_torch/native/wavio.cc``) against
the JAX package's (``fdbm_tpu/ops/native``), on the CPU, on wavs the test
writes: 16-bit PCM, float32, stereo, and files of exactly ``target_len``,
shorter and longer. Both libraries are built by g++ at first use; the
whole decoded files match ``read_wav``, and the crops and the
``SpecsDataset`` batches (two epochs of random crops) must be bit-equal to
the JAX package's. A file the decoder does not take (8-bit
PCM) goes through ``read_wav`` in both packages, and the port counts it. A
failed build raises."""

import os
import wave

import numpy as np
import pytest

from fdbm_tpu import data as jdata
from fdbm_tpu.ops import native as jnative
from fdbm_tpu_torch import data as pdata
from fdbm_tpu_torch.native import wavio
from fdbm_tpu_torch.utils.audio import read_wav, write_wav

TARGET = (8 - 1) * 16  # num_frames 8, hop 16


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    assert jnative.native_available(), "the JAX package's native loader did not build"


def _pcm8(path, x, sr=16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(sr)
        w.writeframes(np.clip(x * 128 + 128, 0, 255).astype(np.uint8).tobytes())


def _files(tmp_path):
    """name -> path: one wav of each kind the loaders meet."""
    rng = np.random.default_rng(0)
    sig = lambda n: (0.3 * rng.standard_normal(n)).astype(np.float32)
    files = {}
    for name, n, kw in (("pcm16", 300, {}), ("float32", 250, {"subtype": "float32"}),
                        ("exact", TARGET, {}), ("short", 70, {}), ("long", 900, {})):
        files[name] = str(tmp_path / f"{name}.wav")
        write_wav(files[name], sig(n), 16000, **kw)
    files["stereo"] = str(tmp_path / "stereo.wav")
    write_wav(files["stereo"], np.stack([sig(200), sig(200)]), 16000)
    files["pcm8"] = str(tmp_path / "pcm8.wav")
    _pcm8(files["pcm8"], sig(200))
    return files


def test_decode_and_crop_bit_equal_to_jax(tmp_path):
    """Every file decoded whole (cropped or padded to its own length,
    unnormalised) equals ``read_wav``'s channel 0; the header's frames are
    the file's; the crops and pads of both packages are the same bits."""
    files = _files(tmp_path)
    for name, path in files.items():
        info = wavio.wav_info(path)
        if name == "pcm8":
            assert wavio.load_crop_pair_native(path, path, 200, 0, "not") is None
            continue
        want, sr = read_wav(path)
        assert info[0] == sr == 16000 and info[2] == want.shape[-1]
        got = wavio.load_crop_pair_native(path, path, info[2], 0, "not")
        for g in got:
            np.testing.assert_allclose(g, want[0], rtol=0, atol=1e-7)
    for name, path in files.items():
        n = wavio.wav_info(path)[2]
        for start in {-1, 0, max(n - TARGET, 0)}:
            for mode in ("noisy", "clean", "not", "std"):
                got = wavio.load_crop_pair_native(path, files["pcm16"] if name != "pcm8" else path,
                                                  TARGET, start, mode)
                want = jnative.load_crop_pair_native(
                    path, files["pcm16"] if name != "pcm8" else path, TARGET, start, mode)
                if name == "pcm8":
                    assert got is None and want is None
                    continue
                for g, w in zip(got, want):
                    assert g.shape == (TARGET,) and g.dtype == np.float32
                    np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="normalize"):
        wavio.load_crop_pair_native(files["pcm16"], files["pcm16"], TARGET, -1, "peak")


def _dataset(base):
    rng = np.random.default_rng(1)
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(base, "train", kind))
    for i, n in enumerate((300, TARGET, 70, 900, 250, 180)):
        x = (0.3 * np.sin(np.arange(n) * 0.03 * (i + 1))).astype(np.float32)
        y = (x + 0.05 * rng.standard_normal(n)).astype(np.float32)
        sub = "float32" if i == 4 else "pcm16"
        for kind, a in (("clean", x), ("noisy", y)):
            path = os.path.join(base, "train", kind, f"{i:03d}.wav")
            if i == 5:
                _pcm8(path, a)
            else:
                write_wav(path, a, 16000, subtype=sub)


def test_specs_dataset_batches_bit_equal_to_jax(tmp_path):
    """Two epochs of shuffled random crops from both packages'
    ``SpecsDataset`` (native loaders, one worker, one seed): the same bits;
    the 8-bit pair takes ``read_wav`` in both, and the port counts it."""
    base = str(tmp_path / "data")
    _dataset(base)
    kw = dict(base_dir=base, batch_size=2, n_fft=32, hop_length=16, num_frames=8,
              num_workers=1)
    jds = jdata.SpecsDataset(jdata.DataConfig(**kw), "train", shuffle_spec=True, seed=3)
    pds = pdata.SpecsDataset(pdata.DataConfig(**kw), "train", shuffle_spec=True, seed=3)
    jl = jdata.BatchLoader(jds, 2, shuffle=True, num_workers=1, drop_last=True, seed=3)
    pl = pdata.BatchLoader(pds, 2, shuffle=True, num_workers=1, drop_last=True, seed=3)
    for _ in range(2):
        jds.sample_data_per_epoch()
        pds.sample_data_per_epoch()
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 3
        for a, b in zip(jb, pb):
            for ja, pa in zip(a, b):
                np.testing.assert_array_equal(pa, ja)
    assert pds.loaded["native"] == 10 and pds.loaded["read_wav"] == 2
    assert pds.loaded["seconds"] > 0


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "wavio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(wavio, "SOURCE", bad)
    monkeypatch.setattr(wavio, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(wavio, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        wavio.get_lib()
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.setattr(wavio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        wavio.build()
