"""The port's metrics against fdbm_tpu/utils/metrics.py, on the CPU.

The numpy and scipy metrics are copies and must give the same numbers on
the same arrays (rel 1e-12: same operations, same order). ``pesq_wb``
falls back to each package's own estimator (no ITU ``pesq`` package here),
the port's on the CPU: they agree within 1e-4 MOS, and both return None
under 1024 samples or at another rate than 16 kHz. ``print_metrics`` prints
the same lines, and the port's ``evaluate`` CLI the root ``evaluate.py``'s
JSON.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fdbm_tpu.utils import metrics as jm
from fdbm_tpu_torch import evaluate as pevaluate
from fdbm_tpu_torch.utils import metrics as pm
from fdbm_tpu_torch.utils.audio import write_wav

REPO = Path(__file__).resolve().parents[1]


def _signals(n=24000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    s = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 3 * t) > -0.2)
    noise = 0.05 * rng.standard_normal(n)
    s_hat = s + 0.3 * noise + 0.01 * rng.standard_normal(n)
    return s, s_hat, noise


@pytest.mark.parametrize("name", ["si_sdr", "snr_db", "energy_ratios", "si_sdr_components",
                                  "estoi", "estoi_8k", "mean_std", "mean_conf_int",
                                  "hp_filter"])
def test_metric_matches_jax_package(name):
    s, s_hat, noise = _signals()
    calls = {
        "si_sdr": lambda m: m.si_sdr(s, s_hat),
        "snr_db": lambda m: m.snr_db(s, noise),
        "energy_ratios": lambda m: m.energy_ratios(s_hat, s, noise),
        "si_sdr_components": lambda m: m.si_sdr_components(s_hat, s, noise),
        "estoi": lambda m: m.estoi(s, s_hat, 16000),
        "estoi_8k": lambda m: m.estoi(s[::2], s_hat[::2], 8000),
        "mean_std": lambda m: m.mean_std(np.array([1.0, np.nan, 2.5, 4.0])),
        "mean_conf_int": lambda m: m.mean_conf_int([1.0, 2.5, 4.0, 3.0]),
        "hp_filter": lambda m: m.hp_filter(s_hat),
    }
    got, want = calls[name](pm), calls[name](jm)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=1e-12)
    assert np.isfinite(np.asarray(got, np.float64)).all()


def test_pesq_wb_falls_back_to_the_estimator():
    s, s_hat, _ = _signals(n=16000)
    got = pm.pesq_wb(16000, s, s_hat, device="cpu")
    want = jm.pesq_wb(16000, s, s_hat)
    assert got is not None and want is not None and 1.0 <= got <= 4.7
    assert abs(got - want) < 1e-4
    assert pm.pesq_wb(16000, s[:1000], s_hat[:1000], device="cpu") is None
    assert pm.pesq_wb(8000, s, s_hat, device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.pesq_wb(16000, s, s_hat)


def test_print_metrics_prints_the_same_lines(capsys):
    s, s_hat, noise = _signals(n=16000)
    jm.print_metrics(s, s + noise, [s_hat], ["Enhanced"])
    want = capsys.readouterr().out
    pm.print_metrics(s, s + noise, [s_hat], ["Enhanced"], device="cpu")
    got = capsys.readouterr().out
    assert got == want and "ESTOI" in got and "PESQ" in got


def test_evaluate_cli_prints_the_root_clis_summary(tmp_path):
    """The port's ``evaluate`` against the root ``evaluate.py`` (run in its
    own process, on the CPU) on the same directories: three enhanced files,
    one in a subfolder, one found by its name alone, one with no clean
    reference, and noisy files for the energy ratios. Everything but PESQ
    is numpy and prints the same; PESQ's mean may move in the last printed
    digit (the estimators agree within 1e-4)."""
    rng = np.random.default_rng(3)
    for d in ("clean/sub", "noisy/sub", "enhanced/sub"):
        os.makedirs(tmp_path / d)
    names = {"a.wav": "a.wav", "sub/b.wav": "sub/b.wav", "sub/c.wav": "c.wav"}
    for i, (enh, clean) in enumerate(names.items()):
        s, s_hat, noise = _signals(n=16000, seed=i)
        write_wav(str(tmp_path / "clean" / clean), s.astype(np.float32), 16000)
        write_wav(str(tmp_path / "noisy" / enh), (s + noise).astype(np.float32), 16000)
        write_wav(str(tmp_path / "enhanced" / enh), s_hat.astype(np.float32), 16000)
    write_wav(str(tmp_path / "enhanced" / "orphan.wav"),
              (0.1 * rng.standard_normal(4000)).astype(np.float32), 16000)
    args = ["--clean_dir", str(tmp_path / "clean"), "--enhanced_dir", str(tmp_path / "enhanced"),
            "--noisy_dir", str(tmp_path / "noisy")]
    env = dict(os.environ, JAX_PLATFORMS="cpu", FDBM_TPU_NO_COMPILE_CACHE="1")
    proc = subprocess.run([sys.executable, str(REPO / "evaluate.py"), *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, check=True)
    want = json.loads(proc.stdout[proc.stdout.index("{"):])
    got = pevaluate.main(args + ["--device", "cpu"])
    assert got.keys() == want.keys() >= {"si_sdr", "estoi", "pesq", "si_sir", "si_sar"}
    assert (got["files"], got["missing_refs"]) == (want["files"], want["missing_refs"]) == (4, 1)
    pesq, want_pesq = got.pop("pesq"), want.pop("pesq")
    assert got == want
    assert pesq["n"] == want_pesq["n"] == 3
    for k in ("mean", "std", "ci95"):
        assert abs(pesq[k] - want_pesq[k]) <= 2e-4, k
