"""Tracing and run logging of the port, on the CPU: ``utils/profiling.py``
(``StepTimer`` against the JAX package's on one patched clock,
``flops_estimate`` against 2·M·N·K by hand, ``trace``), the serving
loop's ``FDBM_TPU_SERVE_TRACE`` and ``FDBM_TPU_SERVE_DEPTH``, and the
training CLI at ``compute_dtype=bfloat16`` with ``--profile_steps``: its
Chrome trace, its TensorBoard event files beside ``metrics.jsonl`` (this
machine has ``tensorboard``), the loader's count of items by path, and the
run served through both serving CLIs and fine-tuned from."""

import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from fdbm_tpu.utils import profiling as jprofiling
from fdbm_tpu_torch import infer_folder, infer_single
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import train as ptrain
from fdbm_tpu_torch import train_finetuning
from fdbm_tpu_torch.checkpoint import load_checkpoint
from fdbm_tpu_torch.infer import BucketedEnhancer
from fdbm_tpu_torch.models.layers import Conv2d, Dense
from fdbm_tpu_torch.utils import profiling
from fdbm_tpu_torch.utils.audio import read_wav

from test_torch_train import _write_pairs

REPO = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the test workers share the machine's cores, and
    oversubscribed threads spin instead of working (the serving test took
    355 s beside five other workers on every core, 8 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_step_timer_matches_jax(monkeypatch):
    """The same ticks on the same clock give the same EMA and steps/s."""
    clock = iter([10.0, 10.5, 10.75, 11.5, 11.625, 13.0])
    times = list(clock)
    for mod in (profiling, jprofiling):
        ticks = iter(times)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(decay=0.8)
        readings = [timer.tick() for _ in times]
        if mod is profiling:
            got = (readings, timer.steps_per_sec)
        else:
            want = (readings, timer.steps_per_sec)
        monkeypatch.undo()
    assert got[0][0] is None and got == want
    assert got[1] == pytest.approx(1.0 / got[0][-1])


def test_flops_estimate_counts_products():
    """2·M·N·K for a Dense and for a Conv2d (as an im2col product), forward,
    and three times that with the backward of both operands."""
    torch.manual_seed(0)
    dense = Dense(24, 40)
    x = torch.randn(7, 24)
    assert profiling.flops_estimate(dense, x) == 2 * 7 * 40 * 24
    conv = Conv2d(3, 8, 3, padding=1)
    img = torch.randn(2, 3, 10, 12)
    assert profiling.flops_estimate(conv, img) == 2 * (2 * 10 * 12) * 8 * (3 * 3 * 3)
    xg = x.clone().requires_grad_(True)
    assert profiling.flops_estimate(lambda: dense(xg).sum().backward()) == 3 * 2 * 7 * 40 * 24


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(3) + 1
    assert prof is None
    with profiling.trace(str(tmp_path / "t"), "x.json") as prof:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert prof is not None
    events = json.load(open(tmp_path / "t" / "x.json"))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_serve_trace_and_depth(monkeypatch, capsys):
    """``FDBM_TPU_SERVE_TRACE=1`` prints one ``[serve]`` line a batch, and
    the pipeline's depth changes only when batches are read back: depth 1
    and 3 give the same bits."""
    torch.manual_seed(0)
    fdbm = pmodel.FDBM(pmodel.FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=32, hop_length=16,
                                         N=2, sampler_type="sde_ei"), device="cpu")
    rng = np.random.default_rng(0)
    audios = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in (900, 700, 1300, 500,
                                                                         1100)]
    enhancer = BucketedEnhancer(fdbm, batch_size=2)
    batches = len(enhancer.plan([len(a) for a in audios]))
    outs = {}
    for depth in ("1", "3"):
        monkeypatch.setenv("FDBM_TPU_SERVE_DEPTH", depth)
        monkeypatch.setenv("FDBM_TPU_SERVE_TRACE", "1")
        capsys.readouterr()
        outs[depth] = enhancer.enhance_many(audios, torch.Generator().manual_seed(1))
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve]")]
        assert len(lines) == batches == 3, lines
        assert all(k in lines[0] for k in ("blen=", "n=", "gap=", "build+h2d=", "retire="))
    assert all(np.array_equal(a, b) for a, b in zip(outs["1"], outs["3"]))
    monkeypatch.delenv("FDBM_TPU_SERVE_TRACE")
    enhancer.enhance_many(audios[:1], torch.Generator().manual_seed(1))
    assert "[serve]" not in capsys.readouterr().out


def test_bf16_training_cli_logs_resumes_and_serves(tmp_path, capsys):
    """``python -m fdbm_tpu_torch.train ... compute_dtype=bfloat16
    --profile_steps 1 2``: 2 steps with their Chrome trace, TensorBoard
    event files beside ``metrics.jsonl`` and the loader's line (every item
    native but the one 8-bit file, read through ``read_wav``); a resume to
    3; fp32 parameters, Adam state and EMA in the checkpoint; ``last``
    served through both serving CLIs (in bf16, the resolved serving dtype);
    then ``train_finetuning`` one step from it, which keeps the source's
    compute dtype."""
    base = str(tmp_path / "data")
    _write_pairs(base, "train", [400, 300, 500, 260], seed=0)
    _write_pairs(base, "valid", [300, 200], seed=1)
    args = ["-C", str(REPO / "configs" / "config.yaml"), "--device", "cpu",
            f"base_dir={base}", f"log_dir={tmp_path / 'logs'}", "backbone=tfgridnet_4l32c80",
            "n_fft=32", "hop_length=16", "num_frames=8", "batch_size=2", "num_workers=1",
            "num_eval_files=0", "compute_dtype=bfloat16"]
    _write_pcm8(os.path.join(base, "train", "noisy", "003.wav"))
    capsys.readouterr()
    run = ptrain.main(args + ["--max_steps", "2", "--profile_steps", "1", "2"])
    out = capsys.readouterr().out
    assert "[data] train items: native 3, read_wav 1," in out, out
    events = json.load(open(os.path.join(run, "profile", "steps_1-2.json")))["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert names.count("train_step") == 2 and "data.wait" in names
    assert glob.glob(os.path.join(run, "events.out.tfevents.*"))
    assert any("valid_loss" in json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl")))
    ptrain.main(args + ["--max_steps", "3", "--resume", run])
    blob = torch.load(os.path.join(run, "checkpoints", "last.pt"), map_location="cpu",
                      weights_only=True)
    assert blob["config"]["compute_dtype"] == "bfloat16"
    tensors = [v for v in blob["state_dict"].values()]
    tensors += list(blob["train_state"]["ema"].values())
    tensors += [v for st in blob["train_state"]["optimizer"]["state"].values()
                for v in st.values() if v.dim() > 0]
    assert blob["train_state"]["step"] == 3 and tensors
    assert all(t.dtype == torch.float32 for t in tensors)
    served = load_checkpoint(run, device="cpu")
    assert (served.train_dtype, served.serve_dtype) == (BF16, BF16)

    out = str(tmp_path / "single.wav")
    noisy = os.path.join(base, "valid", "noisy", "000.wav")
    infer_single.main(["-C", str(REPO / "configs" / "config_infer_single.yaml"), "--device",
                       "cpu", f"ckpt={run}", f"noisy_file={noisy}", f"output_file={out}", "N=2",
                       "sampler_type=sde_ei"])
    audio, _ = read_wav(out)
    assert audio.shape == (1, 300) and np.isfinite(audio).all()
    stats = infer_folder.main([
        "-C", str(REPO / "configs" / "config_infer_folder.yaml"), "--device", "cpu",
        "--batch_size", "2", f"ckpt={run}", f"test_dir={os.path.join(base, 'valid', 'noisy')}",
        f"enhanced_dir={tmp_path / 'enhanced'}", "N=2", "sampler_type=sde_ei"])
    assert (stats.files, stats.failures) == (2, 0)

    ft = train_finetuning.main([
        "-C", str(REPO / "configs" / "config_finetuning.yaml"), "--device", "cpu",
        "--max_steps", "1", f"ckpt={run}", f"base_dir={base}", f"log_dir={tmp_path / 'ft'}",
        "num_workers=1", "num_eval_files=0", "N=2"])
    tuned = load_checkpoint(ft, device="cpu")
    assert tuned.cfg.mode == "finetuning" and tuned.train_dtype == BF16


def _write_pcm8(path):
    """Rewrite a wav as 8-bit PCM, a format the native decoder does not take."""
    audio, sr = read_wav(path)
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(sr)
        w.writeframes(np.clip(audio[0] * 128 + 128, 0, 255).astype(np.uint8).tobytes())
