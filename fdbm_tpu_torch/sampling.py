"""Samplers of the bridge: exponential-integrator ODE/SDE, predictor-corrector
and adaptive RK45.

Port of ``fdbm_tpu/sampling.py``. The N steps are a Python loop (the JAX
package's ``lax.scan``): PyTorch runs eagerly and each step is one backbone
call. Per-step path weights depend only on the time, which is the same for
every row of a batch, so they are computed on the host as float32 scalars.
The EI samplers evaluate the model at ``t_prev`` and the SDE sampler zeroes
its noise on the final step. ``ode_int`` is the JAX package's Dormand-Prince
RK45 (``_rk45``) with one step-size sequence for the whole batch; its
accept and step-size decision reads the error norm on the host, one device
sync a step (the JAX package's ``lax.while_loop`` keeps it on the device).

Complex noise is CN(0,1): real and imaginary parts each have variance 1/2,
drawn from an explicit ``torch.Generator``. ``model_fn(x_t, y, t)`` takes
complex ``[B, C, F, T]`` states and a ``[B]`` time vector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fdbm_tpu_torch.paths import ProbabilityPath, make_path

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def complex_normal_like(x: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """CN(0,1) noise with the shape and device of x (complex64)."""
    re = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    im = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return torch.complex(re, im) / math.sqrt(2.0)


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, *([1] * (like.ndim - 1)))


@dataclasses.dataclass(frozen=True)
class Bridge:
    """Path + sampler configuration."""

    path: ProbabilityPath
    N: int = 5
    T: float = 1.0
    sampler_type: str = "ode_ei"
    sampling_eps: float = 1e-4

    @classmethod
    def create(cls, bridge: str, N: int = 5, T: float = 1.0,
               sampler_type: str = "ode_ei", sampling_eps: float = 1e-4, **kwargs):
        path = make_path(bridge, T=T, **kwargs)
        return cls(path=path, N=N, T=T, sampler_type=sampler_type,
                   sampling_eps=sampling_eps)

    @property
    def start_time(self) -> float:
        return self.sampling_eps if self.path.sampling_direction == "forward" else self.path.T

    @property
    def end_time(self) -> float:
        return self.path.T if self.path.sampling_direction == "forward" else self.sampling_eps

    def prior_sampling(self, y: torch.Tensor, generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_start = b_start*y + sigma_start*z; ``z`` overrides the CN(0,1)
        draw (the hook the cross-framework tests feed both samplers with)."""
        t0 = torch.full((y.shape[0],), self.start_time, dtype=torch.float32)
        _, b0, sig0 = self.path.path_param(t0)
        if z is None:
            z = complex_normal_like(y, generator)
        b0, sig0 = b0.to(y.device), sig0.to(y.device)
        return y * _bcast(b0, y) + z * _bcast(sig0, y)

    def time_grid(self) -> torch.Tensor:
        return torch.linspace(self.start_time, self.end_time, self.N + 1,
                              dtype=torch.float32)

    def sample(self, model_fn: ModelFn, y: torch.Tensor,
               generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        """Run the configured sampler. As ``fdbm_tpu/sampling.py:Bridge.sample``
        does, ``ode_int`` and ``pc`` take every sampler kwarg (an unknown one
        raises ``TypeError``), while the EI samplers take only their noise
        overrides ``z`` (ODE) and ``noise`` (SDE) and drop the rest."""
        if self.sampler_type == "ode_ei":
            return self.ode_sampler_ei(model_fn, y, generator, z=kwargs.get("z"))
        if self.sampler_type == "sde_ei":
            return self.sde_sampler_ei(model_fn, y, generator, noise=kwargs.get("noise"))
        if self.sampler_type == "ode_int":
            return self.ode_sampler_int(model_fn, y, generator, **kwargs)
        if self.sampler_type == "pc":
            return self.pc_sampler(model_fn, y, generator, **kwargs)
        raise ValueError(f"Unknown sampler_type {self.sampler_type}")

    def check_rows_apart(self, corrector_name: str = "ald", **_) -> None:
        """Raises for the samplers whose steps couple a batch's rows, which
        therefore cannot be sampled in row slices: ``ode_int`` (one
        step-size sequence for the batch) and ``pc`` with the ``langevin``
        corrector (a step size from batch means)."""
        if self.sampler_type == "ode_int" or (self.sampler_type == "pc"
                                              and corrector_name == "langevin"):
            raise ValueError(f"sampler {self.sampler_type!r} (corrector {corrector_name!r}) "
                             "decides its steps over the whole batch; its rows cannot be "
                             "sampled apart")

    def draws(self, y: torch.Tensor, generator: Optional[torch.Generator] = None,
              predictor_name: str = "reverse_diffusion", corrector_name: str = "ald",
              corrector_steps: int = 1, sampler: Optional[str] = None,
              **_) -> Dict[str, torch.Tensor]:
        """Every draw of ``sampler`` (default: the configured one) for
        ``y``, drawn from ``generator``, as the override the sampler takes
        (``z`` or ``noise``, with the rows on the axis of ``y``'s rows). The
        samplers draw through here, so a batch split into row slices, each
        sampled with its slice of these, samples as the whole batch does on
        ``generator``."""
        sampler = sampler or self.sampler_type
        draw = lambda: complex_normal_like(y, generator)
        if sampler in ("ode_ei", "ode_int"):
            return {"z": draw()}
        if sampler == "sde_ei":
            return {"noise": torch.stack([draw() for _ in range(self.N + 1)])}
        if sampler != "pc":
            raise ValueError(f"Unknown sampler_type {sampler}")
        per_step = corrector_steps + 1
        noise = torch.zeros((1 + self.N * per_step, *y.shape), dtype=torch.complex64,
                            device=y.device)
        noise[0] = draw()
        for i in range(self.N):
            if corrector_name != "none":
                for j in range(corrector_steps):
                    noise[1 + i * per_step + j] = draw()
            if predictor_name == "euler_maruyama":
                noise[1 + i * per_step + corrector_steps] = draw()
        return {"noise": noise}

    def _steps(self, weights) -> List[List[float]]:
        """Per-step (t_prev, *weights) as Python floats, computed once."""
        times = self.time_grid()
        w = weights(times[1:], times[:-1])
        return [list(step) for step in zip(times[:-1].tolist(), *(x.tolist() for x in w))]

    def ode_sampler_ei(self, model_fn: ModelFn, y: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = self.draws(y, generator, sampler="ode_ei")["z"] if z is None else z
        x = self.prior_sampling(y, z=z)
        for tp, wxt, ws, wy in self._steps(self.path.sampling_param_ode_ei):
            est = model_fn(x, y, torch.full((y.shape[0],), tp, device=y.device))
            x = wxt * x + ws * est + wy * y
        return x

    def sde_sampler_ei(self, model_fn: ModelFn, y: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """EI SDE sampler. ``noise`` (optional, ``[N+1, *y.shape]`` complex)
        overrides every draw: ``noise[0]`` is the prior draw, ``noise[1:]``
        the N per-step noises."""
        steps = self._steps(self.path.sampling_param_sde_ei)
        steps[-1][3] = 0.0  # the final step is deterministic
        if noise is None:
            noise = self.draws(y, generator, sampler="sde_ei")["noise"]
        x = self.prior_sampling(y, z=noise[0])
        for i, (tp, wxt, ws, wz) in enumerate(steps):
            est = model_fn(x, y, torch.full((y.shape[0],), tp, device=y.device))
            x = wxt * x + ws * est + wz * noise[i + 1]
        return x

    def score_fn(self, t: float, x: torch.Tensor, s: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        """-(x - mean_t) / (sigma_t^2 + 1e-8), with ``s`` the clean estimate
        and ``t`` one time for the whole batch."""
        a_t, b_t, sig = self.path.path_param(_f32(t))
        denom = float(sig * sig + 1e-8)
        return -(x - (float(a_t) * s + float(b_t) * y)) / denom

    def pc_sampler(self, model_fn: ModelFn, y: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   predictor_name: str = "reverse_diffusion", corrector_name: str = "ald",
                   denoise: bool = True, snr: float = 0.5, corrector_steps: int = 1,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Predictor-corrector sampler over N times from start to end.

        Predictors ``euler_maruyama`` and ``none`` (``reverse_diffusion``, the
        reference's unregistered default, is a no-op alias); correctors
        ``langevin``, ``ald`` and ``none``; any other name raises. ``noise``
        (``[1 + N*(corrector_steps+1), *y.shape]`` complex) overrides every
        draw in the reference's order: ``noise[0]`` the prior, then per step
        the ``corrector_steps`` corrector noises and one predictor noise."""
        known_predictors = ("euler_maruyama", "none", "reverse_diffusion")
        known_correctors = ("langevin", "ald", "none")
        if predictor_name not in known_predictors:
            raise ValueError(
                f"Unknown predictor {predictor_name!r}; known: {known_predictors} "
                f"('reverse_diffusion' is a documented no-op alias)")
        if corrector_name not in known_correctors:
            raise ValueError(f"Unknown corrector {corrector_name!r}; known: {known_correctors}")
        times = torch.linspace(self.start_time, self.end_time, self.N, dtype=torch.float32)
        stepsizes = torch.cat([times[:-1] - times[1:], times[-1:]])
        per_step = corrector_steps + 1
        if noise is None:
            noise = self.draws(y, generator, predictor_name, corrector_name, corrector_steps,
                               sampler="pc")["noise"]
        x = self.prior_sampling(y, z=noise[0])
        x_mean = x
        batch = y.shape[0]
        draw = lambda step, j: noise[1 + step * per_step + j]

        for i, (t, stepsize) in enumerate(zip(times.tolist(), stepsizes)):
            t_vec = torch.full((batch,), t, device=y.device)
            if corrector_name != "none":
                for j in range(corrector_steps):
                    grad = self.score_fn(t, x, model_fn(x, y, t_vec), y)
                    z = draw(i, j)
                    if corrector_name == "langevin":
                        grad_norm = torch.linalg.vector_norm(
                            grad.abs().reshape(batch, -1), dim=-1).mean()
                        noise_norm = torch.linalg.vector_norm(
                            z.abs().reshape(batch, -1), dim=-1).mean()
                        step_size = (snr * noise_norm / (grad_norm + 1e-8)) ** 2 * 2
                        root = torch.sqrt(step_size * 2)
                    else:  # ald
                        step_size = (snr * self.path.sigma_t(_f32(t))) ** 2 * 2
                        root, step_size = float(torch.sqrt(step_size * 2)), float(step_size)
                    x_mean = x + step_size * grad
                    x = x_mean + z * root
            if predictor_name == "euler_maruyama":
                dt = -stepsize
                z = draw(i, corrector_steps)
                s = model_fn(x, y, t_vec)
                w_x, w_s, w_y, diffusion = (float(w) for w in self.path.sde_weights(_f32(t)))
                drift = w_x * x + w_s * s + w_y * y
                x_mean = x + drift * float(dt)
                x = x_mean + float(diffusion * torch.sqrt(-dt)) * z
            else:
                x_mean = x
        return x_mean if denoise else x

    def ode_sampler_int(self, model_fn: ModelFn, y: torch.Tensor,
                        generator: Optional[torch.Generator] = None, rtol: float = 1e-5,
                        atol: float = 1e-5, max_steps: int = 1000,
                        z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Adaptive Dormand-Prince RK45 solve of the probability-flow ODE from
        the prior at start_time to end_time; ``z`` overrides the prior draw."""
        z = self.draws(y, generator, sampler="ode_int")["z"] if z is None else z
        x0 = self.prior_sampling(y, z=z)
        batch = y.shape[0]

        def f(t: np.float32, x: torch.Tensor) -> torch.Tensor:
            s = model_fn(x, y, torch.full((batch,), float(t), device=y.device))
            w_x, w_s, w_y = (float(w) for w in self.path.ode_weights(_f32(t)))
            return w_x * x + w_s * s + w_y * y

        return _rk45(f, x0, self.start_time, self.end_time, rtol, atol, max_steps)


def _f32(t) -> torch.Tensor:
    return torch.tensor(t, dtype=torch.float32)


# Dormand-Prince (RK45) Butcher tableau, as float32 like the JAX package's.
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
                  np.float32)
_DP_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100,
                   1 / 40], np.float32)


def _error_norm(x: torch.Tensor, x5: torch.Tensor, x4: torch.Tensor, rtol: float,
                atol: float) -> np.float32:
    """RMS over the batch of an attempted step's error estimate ``x5 - x4``,
    scaled by ``atol + rtol * max(|x5|, |x|)``: the step control's norm."""
    scale = atol + torch.maximum(x5.abs(), x.abs()) * rtol
    return np.float32(torch.sqrt(torch.mean(((x5 - x4) / scale).abs() ** 2)).item())


def _rk45(f, x0: torch.Tensor, t0: float, t1: float, rtol: float, atol: float,
          max_steps: int) -> torch.Tensor:
    """Adaptive RK45 from t0 to t1 (either direction), seven calls of ``f``
    an attempted step. Times, step sizes and the step-size
    control are float32 on the host, as the JAX package's ``_rk45``
    computes them; the error norm is over the whole batch, so every row
    takes the same steps. Each attempted step reads the error norm back
    from the device once (one sync a step)."""
    f32 = np.float32
    direction = 1.0 if t1 >= t0 else -1.0
    span = abs(t1 - t0)
    t, h, x = f32(t0), f32(direction * span / 50.0), x0
    for _ in range(max_steps):
        if not direction * (f32(t1) - t) > 1e-10:
            break
        if direction * (t + h - f32(t1)) > 0:  # do not step past t1
            h = f32(t1) - t
        ks: List[torch.Tensor] = []
        for i in range(7):
            xi = x
            for j, a in enumerate(_DP_A[i]):
                xi = xi + float(h * f32(a)) * ks[j]
            ks.append(f(t + _DP_C[i] * h, xi))
        x5, x4 = x, x
        for i in range(7):
            x5 = x5 + float(h * _DP_B5[i]) * ks[i]
            x4 = x4 + float(h * _DP_B4[i]) * ks[i]
        err_norm = _error_norm(x, x5, x4, rtol, atol)
        if err_norm <= 1.0:
            t, x = f32(t + h), x5
        factor = np.clip(f32(0.9) * (err_norm + f32(1e-12)) ** f32(-0.2), f32(0.2), f32(5.0))
        h = f32(h * factor)
        if abs(h) < 1e-8 * span:
            h = f32(direction * 1e-8 * span)
    return x
