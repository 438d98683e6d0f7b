"""Serving model: config, spectral front-end and bridge sampling.

Port of the serving part of ``fdbm_tpu/model.py`` (``FDBMConfig`` and the
``FDBM`` spec helpers and enhance functions). The backbone is an
``nn.Module`` that owns its parameters; randomness comes from an explicit
``torch.Generator``. Training, the predictive mode and NCSN++ are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from fdbm_tpu_torch import dsp
from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.sampling import Bridge


@dataclasses.dataclass
class FDBMConfig:
    """Serving fields of the config; key names match the repo's YAML."""

    mode: str = "generative"  # generative | finetuning (both serve through the sampler)
    backbone: str = "tfgridnet_5l32c100"
    bridge: str = "sb"
    noise_schedule: str = "bb"
    sampler_type: str = "sde_ei"
    N: int = 5
    T: float = 1.0
    sampling_eps: float = 1e-4
    sr: int = 16000
    # SB / FM schedule parameters
    k: float = 2.6
    c: float = 0.4
    beta_0: float = 0.01
    beta_1: float = 20.0
    rho: float = 1.0
    sigma_max: float = 1.0
    sigma_min: float = 0.01
    # STFT / compression
    n_fft: int = 512
    hop_length: int = 256
    window: str = "sqrthann"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    transform_type: str = "exponent"
    normalize: str = "noisy"
    # numerics: the port serves in float32 only
    compute_dtype: str = "float32"
    inference_dtype: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FDBMConfig":
        """Build from a config dict; keys that are not serving fields
        (training, logging, data) are ignored."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


class FDBM:
    """A generative bridge model ready to serve on one device."""

    def __init__(self, cfg: FDBMConfig, device="cuda"):
        if cfg.mode not in ("generative", "finetuning"):
            raise NotImplementedError(f"mode={cfg.mode!r} is not ported to fdbm_tpu_torch yet")
        for name in ("compute_dtype", "inference_dtype"):
            if getattr(cfg, name) not in ("", "float32"):
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r}: fdbm_tpu_torch serves in float32 only")
        self.cfg = cfg
        self.device = _resolve_device(device)
        # Hold fp32 as fp32: cuDNN runs fp32 convolutions (conv_in,
        # deconv_out) in TF32 by default, and TF32's 10-bit mantissa breaks
        # parity with the JAX reference, which computes them in full fp32;
        # the 30-step sampler amplifies any per-call deviation.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dnn = BackboneRegistry.get_by_name(cfg.backbone)()
        self.dnn.to(self.device).eval()
        self.bridge = Bridge.create(
            cfg.bridge, N=cfg.N, T=cfg.T, sampler_type=cfg.sampler_type,
            sampling_eps=cfg.sampling_eps, noise_schedule=cfg.noise_schedule,
            k=cfg.k, c=cfg.c, beta_0=cfg.beta_0, beta_1=cfg.beta_1, rho=cfg.rho,
            sigma_max=cfg.sigma_max, sigma_min=cfg.sigma_min,
        )
        self.window = torch.as_tensor(dsp.get_window(cfg.window, cfg.n_fft), device=self.device)

    # -- spec helpers -------------------------------------------------------

    def audio_to_spec(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, L] real -> [B, 1, F, T] compressed complex spec."""
        spec = dsp.stft(audio, self.cfg.n_fft, self.cfg.hop_length, self.window)
        return dsp.spec_fwd(spec, self.cfg.spec_factor, self.cfg.spec_abs_exponent,
                            self.cfg.transform_type)[:, None]

    def spec_to_audio(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        back = dsp.spec_back(spec, self.cfg.spec_factor, self.cfg.spec_abs_exponent,
                             self.cfg.transform_type)
        return dsp.istft(back, self.cfg.n_fft, self.cfg.hop_length, self.window,
                         length=length)

    def model_fn(self):
        """(x_t, y, t) -> estimate of the clean spec."""
        return lambda x_t, y, t: self.dnn(x_t, y, t)

    # -- enhancement --------------------------------------------------------

    @torch.no_grad()
    def enhance_spec(self, y_spec: torch.Tensor, generator: Optional[torch.Generator] = None,
                     sampler_type: Optional[str] = None, N: Optional[int] = None,
                     **kwargs) -> torch.Tensor:
        """Run the sampler on a compressed spec [B, 1, F, T] -> clean spec."""
        bridge = self.bridge
        if sampler_type is not None or N is not None:
            bridge = dataclasses.replace(bridge, sampler_type=sampler_type or bridge.sampler_type,
                                         N=N or bridge.N)
        return bridge.sample(self.model_fn(), y_spec, generator, **kwargs)

    @torch.no_grad()
    def enhance_batch(self, y_audio: torch.Tensor, generator: Optional[torch.Generator] = None,
                      sampler_type: Optional[str] = None, N: Optional[int] = None,
                      **kwargs) -> torch.Tensor:
        """[B, L] float32 normalised audio in, [B, L] float32 out."""
        length = y_audio.shape[-1]
        y_spec = self.audio_to_spec(y_audio.to(self.device))
        sample = self.enhance_spec(y_spec, generator, sampler_type, N, **kwargs)
        return self.spec_to_audio(sample[:, 0], length=length)

    def enhance_audio(self, y: np.ndarray, generator: Optional[torch.Generator] = None,
                      sampler_type: Optional[str] = None, N: Optional[int] = None,
                      **kwargs) -> np.ndarray:
        """Enhance one utterance [L] with the config's normalisation."""
        norm = normalisation(y, self.cfg.normalize)
        y_n = torch.as_tensor((y[None, :] / norm).astype(np.float32), device=self.device)
        x_hat = self.enhance_batch(y_n, generator, sampler_type, N, **kwargs)
        return x_hat[0].cpu().numpy() * norm


def normalisation(y: np.ndarray, mode: str) -> float:
    """The divisor the config's ``normalize`` mode applies to the input."""
    if mode == "noisy":
        norm = float(np.max(np.abs(y)))
    elif mode == "std":
        norm = float(np.std(y))
    else:
        norm = 1.0
    return norm if norm != 0 else 1.0
