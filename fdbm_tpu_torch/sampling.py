"""Exponential-integrator ODE/SDE samplers of the bridge.

Port of ``fdbm_tpu/sampling.py:37-184``. The N steps are a Python loop (the
JAX package's ``lax.scan``): PyTorch runs eagerly and each step is one
backbone call. The per-step path weights are computed once, on the host,
before the loop. The EI samplers evaluate the model at ``t_prev`` and the
SDE sampler zeroes its noise on the final step.

Complex noise is CN(0,1): real and imaginary parts each have variance 1/2,
drawn from an explicit ``torch.Generator``. ``model_fn(x_t, y, t)`` takes
complex ``[B, C, F, T]`` states and a ``[B]`` time vector.

The predictor-corrector (``pc``) and adaptive RK45 (``ode_int``) samplers
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

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
        if self.sampler_type == "ode_ei":
            return self.ode_sampler_ei(model_fn, y, generator, **kwargs)
        if self.sampler_type == "sde_ei":
            return self.sde_sampler_ei(model_fn, y, generator, **kwargs)
        if self.sampler_type in ("ode_int", "pc"):
            raise NotImplementedError(
                f"sampler_type={self.sampler_type!r} is not ported to fdbm_tpu_torch "
                "yet (a later slice of the port); use 'ode_ei' or 'sde_ei'")
        raise ValueError(f"Unknown sampler_type {self.sampler_type}")

    def _steps(self, weights) -> List[List[float]]:
        """Per-step (t_prev, *weights) as Python floats, computed once."""
        times = self.time_grid()
        w = weights(times[1:], times[:-1])
        return [list(step) for step in zip(times[:-1].tolist(), *(x.tolist() for x in w))]

    def ode_sampler_ei(self, model_fn: ModelFn, y: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.prior_sampling(y, generator, z=z)
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
        x = self.prior_sampling(y, generator, z=None if noise is None else noise[0])
        for i, (tp, wxt, ws, wz) in enumerate(steps):
            est = model_fn(x, y, torch.full((y.shape[0],), tp, device=y.device))
            z = complex_normal_like(y, generator) if noise is None else noise[i + 1]
            x = wxt * x + ws * est + wz * z
        return x
