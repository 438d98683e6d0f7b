"""The port's PESQ estimator against fdbm_tpu/pesq_loss.py, on the CPU.

The 28 conditions of ``tools/gen_pesq_golden.py:golden_conditions`` (4 s
of a synthetic voice under white, pink, low-passed and modulated noise at
six SNRs, clipping, mu-law) go through both packages in one batched call.
They include low-passed noise, where the wideband input filter's
asymmetric response shows: a causal filter applied the wrong way round
moves every MOS. Tolerances: MOS within 1e-4 (fp32, the same operations in
another order; the packages read 4e-7 apart); the loss within rel 1e-5 and
its gradient within norm-rel 1e-4. Within each noise type the port's MOS
rises strictly with SNR, as ``tests/test_pesq.py`` holds the JAX package's.
No ITU-scored audio is in the repository, so the absolute calibration
(``tests/test_pesq.py::test_itu_golden_calibration``) is not repeated here.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import pesq_loss as jpesq
from fdbm_tpu_torch import pesq_loss as ppesq

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from gen_pesq_golden import golden_conditions  # noqa: E402


@pytest.fixture(scope="module")
def grid():
    conds = golden_conditions()
    names = [c[0] for c in conds]
    return names, np.stack([c[1] for c in conds]), np.stack([c[2] for c in conds])


@pytest.fixture(scope="module")
def mos(grid):
    _, ref, deg = grid
    want = np.asarray(jax.jit(jpesq.pesq_mos)(jnp.asarray(ref), jnp.asarray(deg)))
    got = ppesq.pesq_mos(torch.as_tensor(ref), torch.as_tensor(deg)).numpy()
    return got, want


def test_mos_matches_jax_on_the_golden_grid(grid, mos):
    got, want = mos
    assert got.shape == want.shape == (len(grid[0]),)
    assert np.isfinite(got).all() and (got >= 1.0).all() and (got <= 4.7).all()
    assert np.abs(got - want).max() < 1e-4, dict(zip(grid[0], got - want))
    assert np.ptp(got) > 2.0  # the grid spans the scale


def test_mos_ordering_within_each_noise_type(grid, mos):
    by_kind = {}
    for name, m in zip(grid[0], mos[0]):
        if "_snr" in name:
            kind, snr = name.split("_snr")
            by_kind.setdefault(kind, []).append((int(snr), float(m)))
    assert len(by_kind) == 4 and all(len(v) == 6 for v in by_kind.values())
    for kind, pairs in by_kind.items():
        scores = [m for _, m in sorted(pairs)]
        assert all(a < b for a, b in zip(scores, scores[1:])), (kind, scores)


def test_loss_and_gradient_match_jax(grid):
    """Four conditions (white and low-passed noise at 20 and 0 dB), 1 s."""
    names, ref, deg = grid
    pick = [names.index(n) for n in ("white_snr+20", "white_snr+0", "lowpass_snr+20",
                                     "lowpass_snr+0")]
    ref, deg = ref[pick, :16000], deg[pick, :16000]
    loss_fn = lambda d: jpesq.pesq_loss(jnp.asarray(ref), d)
    want = np.asarray(jax.jit(loss_fn)(jnp.asarray(deg)))
    jg = np.asarray(jax.jit(jax.grad(lambda d: loss_fn(d).sum()))(jnp.asarray(deg)))
    d = torch.as_tensor(deg).requires_grad_(True)
    got = ppesq.pesq_loss(torch.as_tensor(ref), d)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=0)
    g = d.grad.numpy()
    assert np.isfinite(g).all() and np.linalg.norm(g) > 0
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 1e-4


@pytest.mark.parametrize("length", [1024, 5003, 16001])
def test_mos_matches_jax_at_odd_lengths(grid, length):
    """Lengths off the power of two (the front end's transform pads to the
    next one) and off the frame grid (the split-second windows' tails)."""
    _, ref, deg = grid
    pick = [1, 14, 26]
    ref, deg = ref[pick, 3000:3000 + length], deg[pick, 3000:3000 + length]
    want = np.asarray(jax.jit(jpesq.pesq_mos)(jnp.asarray(ref), jnp.asarray(deg)))
    got = ppesq.pesq_mos(torch.as_tensor(ref), torch.as_tensor(deg)).numpy()
    assert np.abs(got - want).max() < 1e-4


def test_identity_scores_top_and_other_rates_raise(grid):
    _, ref, _ = grid
    x = torch.as_tensor(ref[:1, :32000])
    assert float(ppesq.pesq_mos(x, 0.5 * x)[0]) > 4.5
    assert float(ppesq.pesq_loss(x, x)[0]) < 0.01
    with pytest.raises(NotImplementedError, match="16 kHz"):
        ppesq.pesq_mos(x, x, sample_rate=8000)
