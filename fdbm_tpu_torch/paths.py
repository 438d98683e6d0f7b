"""Probability paths: Schroedinger-bridge (SB) and flow-matching (FM).

Port of ``fdbm_tpu/paths.py`` on torch tensors. A path supplies, for time
``t`` in (0, 1]:

* ``path_param(t) -> (a_t, b_t, sigma_t)`` — marginal ``x_t ~ N(a_t*x +
  b_t*y, sigma_t^2)``,
* per-step exponential-integrator weights for the ODE/SDE samplers,
* instantaneous ODE/SDE coefficient triples for the generic integrators.

All functions are elementwise in ``t`` (a tensor or a Python number) and
keep its floating dtype: Python numbers compute in float32 like the JAX
package, float64 tensors in float64. The SB path masks ``t == 1`` exactly
(a=0, b=1, sigma=0 at the prior endpoint).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from fdbm_tpu_torch.utils.registry import Registry

BridgeRegistry: Registry = Registry("Bridge")

Array = torch.Tensor


def _as_t(t) -> torch.Tensor:
    """Times as a floating tensor: Python numbers become float32 (the JAX
    package's dtype), float64 tensors stay float64."""
    t = torch.as_tensor(t)
    return t if t.is_floating_point() else t.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ProbabilityPath:
    """Base: total time T and sampling direction."""

    T: float = 1.0
    eps: float = 1e-8
    # "reverse": sample from t=T down to ~0 (SB); "forward": t~0 up to T (FM)
    sampling_direction: str = "reverse"

    def path_param(self, t: Array) -> Tuple[Array, Array, Array]:
        raise NotImplementedError

    def sigma_t(self, t: Array) -> Array:
        raise NotImplementedError

    def ode_weights(self, t: Array) -> Tuple[Array, Array, Array]:
        """(w_x, w_s, w_y) such that dx/dt = w_x*x + w_s*s + w_y*y."""
        raise NotImplementedError

    def sde_weights(self, t: Array) -> Tuple[Array, Array, Array, Array]:
        """(w_x, w_s, w_y, diffusion) for the reverse SDE drift/diffusion."""
        raise NotImplementedError

    def sampling_param_ode_ei(self, t_curr: Array, t_prev: Array):
        raise NotImplementedError

    def sampling_param_sde_ei(self, t_curr: Array, t_prev: Array):
        raise NotImplementedError


@BridgeRegistry.register("sb")
@dataclasses.dataclass(frozen=True)
class SBPath(ProbabilityPath):
    """Schroedinger-bridge path with gmax / vp / ve / bb noise schedules.

    Formulas re-derived from reference fdbm/bridge.py:187-337 (I2SB-style
    bridge between the clean posterior and the noisy prior).  Defaults
    match the reference argparse (bridge.py:191-197): bb schedule, k=2.6,
    c=0.4, beta_0=0.01, beta_1=20, rho=1.0.
    """

    noise_schedule: str = "bb"
    k: float = 2.6
    c: float = 0.4
    beta_0: float = 0.01
    beta_1: float = 20.0
    rho: float = 1.0
    sampling_direction: str = "reverse"
    # "g" uses the SDE diffusion g(t); "ode" zeroes it (bridge.py:255-259)
    diffusion_coeff_mode: str = "g"

    # -- schedule primitives ------------------------------------------------

    def _beta_int(self, t: Array) -> Array:
        """Integral of beta: beta_0*t + 0.5*(beta_1-beta_0)*t^2."""
        return self.beta_0 * t + 0.5 * (self.beta_1 - self.beta_0) * (t ** 2)

    def _rhos_alphas(self, t: Array):
        """rho_t, rho_T, rho_bar_t, alpha_t, alpha_T, alpha_bar_t."""
        t = _as_t(t)
        ones = torch.ones_like(t)
        TT = torch.as_tensor(self.T, dtype=t.dtype)
        if self.noise_schedule == "gmax":
            alpha_t, alpha_T = ones, ones
            rho_t = torch.sqrt(self._beta_int(t))
            rho_T = torch.sqrt(self._beta_int(TT)) * ones
        elif self.noise_schedule == "vp":
            alpha_t = torch.exp(-0.5 * self._beta_int(t))
            alpha_T = torch.exp(-0.5 * self._beta_int(TT)) * ones
            rho_t = torch.sqrt(self.c * (torch.exp(self._beta_int(t)) - 1.0))
            rho_T = torch.sqrt(self.c * (torch.exp(self._beta_int(TT)) - 1.0)) * ones
        elif self.noise_schedule == "ve":
            alpha_t, alpha_T = ones, ones
            logk2 = 2.0 * math.log(self.k)
            rho_t = torch.sqrt(self.c * (self.k ** (2.0 * t) - 1.0) / logk2)
            rho_T = math.sqrt(self.c * (self.k ** (2.0 * self.T) - 1.0) / logk2) * ones
        elif self.noise_schedule == "bb":  # SB-CFM / Brownian bridge
            alpha_t, alpha_T = ones, ones
            rho_t = torch.sqrt(t) * self.rho
            rho_T = ones * self.rho
        else:
            raise ValueError(f"Unknown SB noise schedule {self.noise_schedule}")

        alpha_bar_t = alpha_t / (alpha_T + self.eps)
        # Clamp before the sqrt: at t == T the difference is analytically 0
        # but fused rounding can land a hair below -eps, which would poison the
        # whole sampler with NaNs.
        rho_bar_t = torch.sqrt(
            torch.clamp(rho_T ** 2 - rho_t ** 2, min=0.0) + self.eps)
        return rho_t, rho_T, rho_bar_t, alpha_t, alpha_T, alpha_bar_t

    def _f_g(self, t: Array):
        """Drift f(t) and diffusion g(t) of the forward SDE."""
        t = _as_t(t)
        if self.noise_schedule == "ve":
            f = torch.zeros_like(t)
            g = math.sqrt(self.c) * self.k ** t
        elif self.noise_schedule == "vp":
            beta = self.beta_0 + (self.beta_1 - self.beta_0) * t
            f = -0.5 * beta
            g = torch.sqrt(self.c * beta)
        elif self.noise_schedule == "gmax":
            f = torch.zeros_like(t)
            g = torch.sqrt(self.beta_0 + (self.beta_1 - self.beta_0) * t)
        elif self.noise_schedule == "bb":
            f = torch.zeros_like(t)
            g = self.rho * torch.ones_like(t)
        else:
            raise ValueError(self.noise_schedule)
        return f, g

    def _gd(self, g: Array) -> Array:
        if self.diffusion_coeff_mode == "g":
            return g
        return torch.zeros_like(g)

    # -- public surface -----------------------------------------------------

    def sigma_t(self, t: Array) -> Array:
        rho_t, rho_T, rho_bar_t, alpha_t, _, _ = self._rhos_alphas(t)
        sig = alpha_t * rho_bar_t * rho_t / (rho_T + self.eps)
        return torch.where(_as_t(t) == 1.0, 0.0, sig)

    def path_param(self, t: Array):
        rho_t, rho_T, rho_bar_t, alpha_t, _, alpha_bar_t = self._rhos_alphas(t)
        a_t = alpha_t * rho_bar_t ** 2 / (rho_T ** 2 + self.eps)
        b_t = alpha_bar_t * rho_t ** 2 / (rho_T ** 2 + self.eps)
        sig = alpha_t * rho_bar_t * rho_t / (rho_T + self.eps)
        mask = _as_t(t) == 1.0
        a_t = torch.where(mask, 0.0, a_t)
        b_t = torch.where(mask, 1.0, b_t)
        sig = torch.where(mask, 0.0, sig)
        return a_t, b_t, sig

    def ode_weights(self, t: Array):
        rho, _, rho_bar, alpha, _, alpha_bar = self._rhos_alphas(t)
        f, g = self._f_g(t)
        w_x = f + g ** 2 * (rho_bar ** 2 - rho ** 2) / (
            2 * alpha ** 2 * rho ** 2 * rho_bar ** 2 + self.eps
        )
        w_s = -(g ** 2) / (2 * alpha * rho ** 2 + self.eps)
        w_y = alpha_bar * g ** 2 / (2 * alpha ** 2 * rho_bar ** 2 + self.eps)
        return w_x, w_s, w_y

    def sde_weights(self, t: Array):
        rho, _, rho_bar, alpha, _, alpha_bar = self._rhos_alphas(t)
        f, g = self._f_g(t)
        gd = self._gd(g)
        w_x = f + ((g ** 2 + gd ** 2) * rho_bar ** 2 - (g ** 2 - gd ** 2) * rho ** 2) / (
            2 * alpha ** 2 * rho ** 2 * rho_bar ** 2 + self.eps
        )
        w_s = -(g ** 2 + gd ** 2) / (2 * alpha * rho ** 2 + self.eps)
        w_y = alpha_bar * (g ** 2 - gd ** 2) / (2 * alpha ** 2 * rho_bar ** 2 + self.eps)
        return w_x, w_s, w_y, gd

    def sampling_param_ode_ei(self, t_curr: Array, t_prev: Array):
        rho_p, rho_T, rhob_p, alpha_p, _, _ = self._rhos_alphas(t_prev)
        rho_c, rho_T, rhob_c, alpha_c, alpha_T, _ = self._rhos_alphas(t_curr)
        w_xt = alpha_c * rho_c * rhob_c / (alpha_p * rho_p * rhob_p + self.eps)
        w_s = alpha_c / (rho_T ** 2 + self.eps) * (
            rhob_c ** 2 - rhob_p * rho_c * rhob_c / (rho_p + self.eps)
        )
        w_y = alpha_c / (alpha_T * rho_T ** 2 + self.eps) * (
            rho_c ** 2 - rho_p * rho_c * rhob_c / (rhob_p + self.eps)
        )
        return w_xt, w_s, w_y

    def sampling_param_sde_ei(self, t_curr: Array, t_prev: Array):
        rho_p, _, _, alpha_p, _, _ = self._rhos_alphas(t_prev)
        rho_c, _, _, alpha_c, _, _ = self._rhos_alphas(t_curr)
        w_xt = alpha_c * rho_c ** 2 / (alpha_p * rho_p ** 2 + self.eps)
        # tmp is analytically >= 0 in reverse sampling (rho_c <= rho_p);
        # clamp so fused rounding can't push it under 0 into sqrt(NaN).
        tmp = torch.clamp(1.0 - rho_c ** 2 / (rho_p ** 2 + self.eps), min=0.0)
        w_s = alpha_c * tmp
        w_z = alpha_c * rho_c * torch.sqrt(tmp)
        return w_xt, w_s, w_z


@BridgeRegistry.register("fm")
@dataclasses.dataclass(frozen=True)
class FMPath(ProbabilityPath):
    """OT conditional flow-matching path, forward-time sampling.

    sigma_t = t*sigma_min + (1-t)*sigma_max; a_t = t; b_t = 1-t
    (reference: fdbm/bridge.py:340-385).
    """

    sigma_max: float = 1.0
    sigma_min: float = 0.01
    noise_schedule: str = "ot"
    sampling_direction: str = "forward"

    def sigma_t(self, t: Array) -> Array:
        t = _as_t(t)
        return t * self.sigma_min + (1.0 - t) * self.sigma_max

    def path_param(self, t: Array):
        t = _as_t(t)
        return t, 1.0 - t, self.sigma_t(t)

    def ode_weights(self, t: Array):
        sig = self.sigma_t(t)
        denom = sig + self.eps
        w_x = (self.sigma_min - self.sigma_max) / denom
        w_s = self.sigma_max / denom
        w_y = -self.sigma_min / denom
        return w_x, w_s, w_y

    def sde_weights(self, t: Array):
        # The reference FM path defines no SDE; expose the ODE with zero
        # diffusion so the generic machinery stays total.
        w_x, w_s, w_y = self.ode_weights(t)
        return w_x, w_s, w_y, torch.zeros_like(_as_t(t))

    def sampling_param_ode_ei(self, t_curr: Array, t_prev: Array):
        t_curr = _as_t(t_curr)
        t_prev = _as_t(t_prev)
        t_diff = t_curr - t_prev
        sig_c = self.sigma_t(t_curr)
        sig_p = self.sigma_t(t_prev)
        w_xt = sig_c / (sig_p + self.eps)
        w_s = self.sigma_max * t_diff / (sig_p + self.eps)
        w_y = -self.sigma_min * t_diff / (sig_p + self.eps)
        return w_xt, w_s, w_y

    def sampling_param_sde_ei(self, t_curr: Array, t_prev: Array):
        raise NotImplementedError(
            "FM path has no SDE-EI sampler (reference defines none); "
            "use sampler_type='ode_ei'."
        )


def make_path(name: str, **kwargs) -> ProbabilityPath:
    """Instantiate a path by registry name, ignoring unknown kwargs
    (mirrors the reference's `**ignored_kwargs` ctor behaviour)."""
    cls = BridgeRegistry.get_by_name(name)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})
