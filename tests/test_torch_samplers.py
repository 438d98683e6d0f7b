"""The port's ``pc`` and ``ode_int`` samplers against fdbm_tpu, on the CPU.

The samplers' arithmetic is compared in isolation, on a closed-form model
``model_fn(x, y, t)`` written once in each framework (no network numerics in
the error budget), on a [B, 1, 17, 24] spectrogram at B=1 and B=3 with the
same draws: ``pc`` takes the JAX draw order through ``noise=``
(``[1 + N*(corrector_steps+1), *y.shape]``) and ``ode_int`` the prior through
``z=``. Tolerances: rel-L2 < 1e-5 for ``pc`` (fixed steps, fp32 sums in
another order); < 1e-4 for ``ode_int`` (the same adaptive step sequence, each
step's error norm summed in another order); < 1e-3 for ``ode_int`` against
scipy's ``solve_ivp(RK45)`` at rtol = atol = 1e-5 (PARITY.md's gate: two
solvers taking their own step sequences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import sampling as jsampling
from fdbm_tpu_torch import sampling as psampling

N_PC = 4


def _cn(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2.0)).astype(np.complex64)


def _jax_model(x, y, t):
    return 0.85 * x + (0.15 * (1.0 - 0.5 * t))[:, None, None, None] * y


def _torch_model(x, y, t):
    return 0.85 * x + (0.15 * (1.0 - 0.5 * t))[:, None, None, None] * y


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bridges(sampler, n=N_PC):
    kw = dict(N=n, sampler_type=sampler, noise_schedule="bb")
    return jsampling.Bridge.create("sb", **kw), psampling.Bridge.create("sb", **kw)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("corrector", ["langevin", "ald", "none"])
@pytest.mark.parametrize("predictor", ["euler_maruyama", "none", "reverse_diffusion"])
def test_pc_matches_jax_on_injected_noise(predictor, corrector, batch):
    rng = np.random.default_rng(batch)
    y = 0.3 * _cn(rng, (batch, 1, 17, 24))
    steps = 2
    noise = _cn(rng, (1 + N_PC * (steps + 1), *y.shape))
    kw = dict(predictor_name=predictor, corrector_name=corrector, snr=0.4,
              corrector_steps=steps)
    jb, pb = _bridges("pc")
    for denoise in (True, False):
        want = jb.pc_sampler(_jax_model, jnp.asarray(y), jax.random.PRNGKey(0),
                             denoise=denoise, noise=jnp.asarray(noise), **kw)
        got = pb.sample(_torch_model, torch.as_tensor(y), denoise=denoise,
                        noise=torch.as_tensor(noise), **kw)
        assert got.shape == y.shape and got.dtype == torch.complex64
        assert _rel(got.numpy(), want) < 1e-5, (denoise, _rel(got.numpy(), want))


def test_pc_draws_from_the_generator_without_noise():
    """Without ``noise`` the draws come from the generator: one seed, one
    result, and another seed another."""
    y = torch.as_tensor(0.3 * _cn(np.random.default_rng(0), (2, 1, 17, 24)))
    _, pb = _bridges("pc")
    run = lambda seed: pb.sample(_torch_model, y, torch.Generator().manual_seed(seed),
                                 predictor_name="euler_maruyama", corrector_name="ald")
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


@pytest.mark.parametrize("batch", [1, 3])
def test_ode_int_matches_jax_on_the_same_prior(batch):
    rng = np.random.default_rng(10 + batch)
    y = 0.3 * _cn(rng, (batch, 1, 17, 24))
    z = _cn(rng, y.shape)
    jb, pb = _bridges("ode_int")
    want = jb.ode_sampler_int(_jax_model, jnp.asarray(y), jax.random.PRNGKey(0),
                              rtol=1e-5, atol=1e-5, z=jnp.asarray(z))
    calls = []
    model = lambda x, yy, t: calls.append(t) or _torch_model(x, yy, t)
    got = pb.sample(model, torch.as_tensor(y), rtol=1e-5, atol=1e-5, z=torch.as_tensor(z))
    assert got.shape == y.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-4
    # one step-size sequence for the whole batch: every call sees one time
    assert len(calls) % 7 == 0 and all(bool((t == t[0]).all()) for t in calls)


def test_ode_int_matches_scipy_rk45():
    """The probability-flow ODE of the bb bridge solved by scipy's RK45 from
    the same prior, set up as the reference's ``ode_int`` sets it up: the
    complex state flattened, cast to complex64 for each model call, the
    path's float32 weights; on PARITY.md's analytic model 0.9 x + 0.1 y, the
    one its gate (rel < 1e-3 at rtol = atol = 1e-5) was set on. Both are
    adaptive solves of a stiff ODE (weights near 3e7 at t = 1), so their
    global errors are far above the local tolerance: with a time-dependent
    model they differ by about 1.6e-3, each within 1.7e-3 (this solver) and
    1.5e-2 (scipy) of a solve at 1e-10."""
    model = lambda x, y, t: 0.9 * x + 0.1 * y
    from scipy.integrate import solve_ivp

    rng = np.random.default_rng(29)
    y = torch.as_tensor(0.3 * _cn(rng, (1, 1, 17, 24)))
    z = torch.as_tensor(_cn(rng, tuple(y.shape)))
    _, pb = _bridges("ode_int")

    def rhs(t, flat):
        x = torch.as_tensor(flat.reshape(y.shape)).to(torch.complex64)
        w_x, w_s, w_y = pb.path.ode_weights(torch.tensor(t, dtype=torch.float32))
        return (w_x * x + w_s * model(x, y, None) + w_y * y).numpy().reshape(-1)

    x0 = pb.prior_sampling(y, z=z).numpy().reshape(-1)
    sol = solve_ivp(rhs, (pb.start_time, pb.end_time), x0, method="RK45", rtol=1e-5, atol=1e-5)
    want = sol.y[:, -1].reshape(y.shape)
    got = pb.sample(model, y, rtol=1e-5, atol=1e-5, z=z)
    assert _rel(got.numpy(), want) < 1e-3


def test_rk45_integrates_both_directions():
    """dx/dt = x from 0 to 1 gives e, and from 1 back to 0 gives 1/e."""
    x0 = torch.ones(1)
    f = lambda t, x: x
    fwd = psampling._rk45(f, x0, 0.0, 1.0, 1e-6, 1e-8, 10000)
    back = psampling._rk45(f, x0, 1.0, 0.0, 1e-6, 1e-8, 10000)
    np.testing.assert_allclose(float(fwd[0]), np.e, rtol=1e-4)
    np.testing.assert_allclose(float(back[0]), np.exp(-1.0), rtol=1e-4)


@pytest.mark.parametrize("kwargs,match", [
    (dict(predictor_name="heun"), "Unknown predictor"),
    (dict(corrector_name="euler"), "Unknown corrector"),
])
def test_unknown_pc_names_raise(kwargs, match):
    y = torch.zeros(1, 1, 3, 4, dtype=torch.complex64)
    for bridge in _bridges("pc"):
        args = (_jax_model, jnp.asarray(y.numpy()), jax.random.PRNGKey(0)) \
            if isinstance(bridge, jsampling.Bridge) else (_torch_model, y)
        with pytest.raises(ValueError, match=match):
            bridge.sample(*args, **kwargs)


def test_unknown_sampler_and_sampler_kwargs_raise():
    y = torch.zeros(1, 1, 3, 4, dtype=torch.complex64)
    with pytest.raises(ValueError, match="Unknown sampler_type"):
        psampling.Bridge.create("sb", sampler_type="euler").sample(_torch_model, y)
    # ode_int and pc take every sampler kwarg, as the JAX package's do
    for sampler, kwargs in (("pc", {"rtol": 1e-5}), ("ode_int", {"snr": 0.5})):
        with pytest.raises(TypeError):
            psampling.Bridge.create("sb", sampler_type=sampler).sample(_torch_model, y, **kwargs)
