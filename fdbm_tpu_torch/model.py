"""Model: config, spectral front-end, training steps and bridge sampling.

Port of ``fdbm_tpu/model.py``: ``FDBMConfig``, ``make_lr_schedule``, a
train state, and ``FDBM`` with its spec helpers, generative loss, train and
valid steps and enhance functions. The backbone is an ``nn.Module`` that
owns its parameters; its train mode is the training route and its eval
mode the serving route (``models/tfgridnet.py``). Randomness comes from an
explicit ``torch.Generator``. The optimiser is the JAX package's
``clip_by_global_norm(3.0)`` + Adam at the scheduled learning rate (with
``optax.MultiSteps`` gradient accumulation), and the EMA uses torch_ema's
num_updates correction, each matched to optax step by step. The
predictive and finetuning objectives and NCSN++ are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from fdbm_tpu_torch import dsp, losses
from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.sampling import Bridge, complex_normal_like

# Max global gradient norm (optax.clip_by_global_norm(3.0)).
CLIP_NORM = 3.0


def make_lr_schedule(scheduler_config: Optional[Dict[str, Any]],
                     lr: float) -> Callable[[int], float]:
    """step -> learning rate, computed in float32 as the JAX package's
    schedule is: ``fixed``, ``warmup`` (linear warmup, cosine decay to
    ``min_lr`` at ``decay_until_step``) or ``exp`` (``lr * gamma**step``)."""
    f32 = np.float32
    cfg = scheduler_config or {"scheduler": "fixed"}
    kind = cfg.get("scheduler", "fixed")
    if kind == "fixed":
        return lambda step: float(f32(lr))
    sub = cfg.get("config", {})
    if kind == "warmup":
        warmup, until = f32(sub["warmup_steps"]), f32(sub["decay_until_step"])
        max_lr, min_lr = f32(sub["max_lr"]), f32(sub["min_lr"])

        def schedule(step: int) -> float:
            step = f32(step)
            if step < warmup:
                return float(max_lr * step / warmup)
            if step > until:
                return float(min_lr)
            ratio = np.clip((step - warmup) / (until - warmup), f32(0), f32(1))
            return float(min_lr + f32(0.5) * (f32(1) + np.cos(f32(np.pi) * ratio))
                         * (max_lr - min_lr))

        return schedule
    if kind == "exp":
        gamma = f32(sub["gamma"])
        return lambda step: float(f32(lr) * np.power(gamma, f32(step)))
    raise ValueError(f"Unknown scheduler {kind}")


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
    # training
    t_eps: float = 0.03
    lr: float = 1e-4
    ema_decay: float = 0.999
    loss_type: str = "data_prediction_hybrid"
    l1_weight: float = 0.001
    pesq_weight: float = 0.0
    scheduler_config: Optional[Dict[str, Any]] = None
    num_frames: int = 256
    # micro-batch accumulation: the optimiser applies every k-th step
    accumulate_grad_batches: int = 1
    # recompute each backbone block in the backward
    remat: bool = False
    # numerics: the port trains and serves in float32 only
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    inference_dtype: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FDBMConfig":
        """Build from a config dict; keys that are not model fields
        (logging, data) are ignored."""
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
        for name in ("param_dtype", "compute_dtype", "inference_dtype"):
            if getattr(cfg, name) not in ("", "float32"):
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r}: fdbm_tpu_torch runs in float32 only")
        self.cfg = cfg
        self.device = _resolve_device(device)
        # Hold fp32 as fp32: cuDNN runs fp32 convolutions (conv_in,
        # deconv_out) in TF32 by default, and TF32's 10-bit mantissa breaks
        # parity with the JAX reference, which computes them in full fp32;
        # the 30-step sampler amplifies any per-call deviation.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dnn = BackboneRegistry.get_by_name(cfg.backbone)(remat=cfg.remat)
        self.dnn.to(self.device).eval()
        self.bridge = Bridge.create(
            cfg.bridge, N=cfg.N, T=cfg.T, sampler_type=cfg.sampler_type,
            sampling_eps=cfg.sampling_eps, noise_schedule=cfg.noise_schedule,
            k=cfg.k, c=cfg.c, beta_0=cfg.beta_0, beta_1=cfg.beta_1, rho=cfg.rho,
            sigma_max=cfg.sigma_max, sigma_min=cfg.sigma_min,
        )
        window = dsp.get_window(cfg.window, cfg.n_fft)
        self.window = torch.as_tensor(window, device=self.device)
        self.loss_cfg = losses.LossConfig(
            n_fft=cfg.n_fft, hop_length=cfg.hop_length, window=tuple(window.tolist()),
            num_frames=cfg.num_frames, spec_factor=cfg.spec_factor,
            spec_abs_exponent=cfg.spec_abs_exponent, transform_type=cfg.transform_type,
            loss_type=cfg.loss_type, l1_weight=cfg.l1_weight, pesq_weight=cfg.pesq_weight,
            sample_rate=cfg.sr)
        self.lr_schedule = make_lr_schedule(cfg.scheduler_config, cfg.lr)

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
        """(x_t, y, t) -> estimate of the clean spec, on the serving route."""
        self.dnn.eval()
        return lambda x_t, y, t: self.dnn(x_t, y, t)

    # -- objective ----------------------------------------------------------

    def _sample_prior(self, x: torch.Tensor, y: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        """t ~ U[t_eps, T]; x_t = a_t x + b_t y + sigma_t z. ``t`` and ``z``
        replace the draws (the hook the tests feed the JAX draw through).
        Returns ``(t, mean, z, x_t)``."""
        b = x.shape[0]
        if t is None:
            t = torch.rand(b, generator=generator, device=x.device, dtype=torch.float32) \
                * (self.cfg.T - self.cfg.t_eps) + self.cfg.t_eps
        a_t, b_t, sigma_t = self.bridge.path.path_param(t)
        bcast = lambda v: v.reshape(-1, 1, 1, 1)
        mean = bcast(a_t) * x + bcast(b_t) * y
        if z is None:
            z = complex_normal_like(x, generator)
        return t, mean, z, mean + bcast(sigma_t) * z

    def loss_fn(self, batch: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None,
                prior: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The configured loss of one batch ``(x_audio, y_audio[, weights])``
        on the training route; ``params`` replaces the backbone's own (the
        EMA weights of the valid loss), ``prior`` the ``(t, z)`` draw."""
        if self.cfg.mode != "generative":
            raise NotImplementedError(
                f"training in mode={self.cfg.mode!r} is not ported to fdbm_tpu_torch yet")
        x_audio, y_audio = batch[0], batch[1]
        weights = batch[2] if len(batch) > 2 else None
        x = self.audio_to_spec(x_audio)
        y = self.audio_to_spec(y_audio)
        t, _, _, x_t = self._sample_prior(x, y, generator, *(prior or (None, None)))
        self.dnn.train()
        x_hat = (self.dnn(x_t, y, t) if params is None
                 else functional_call(self.dnn, params, (x_t, y, t)))
        return losses.compute_loss(self.loss_cfg, x_hat, x, weights)

    # -- steps --------------------------------------------------------------

    def to_device(self, batch: Sequence[Any]) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(np.asarray(b, np.float32), device=self.device)
                     for b in batch)

    def train_step(self, state: "TrainState", batch: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   prior: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict[str, float]:
        """One step: loss, backward, then :meth:`apply_gradients`."""
        loss = self.loss_fn(batch, generator, prior)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        metrics = self.apply_gradients(state, dict(zip(state.params, grads)))
        return {"train_loss": float(loss.detach()), **metrics}

    def apply_gradients(self, state: "TrainState",
                        grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The optimiser step of ``FDBM.train_step`` in the JAX package:
        micro-batch mean under accumulation (``optax.MultiSteps``), then on
        an applying step the global-norm clip, Adam at the scheduled
        learning rate of the update count, and the EMA blend."""
        norm = _global_norm(grads.values())
        metrics = {"learning_rate": self.lr_schedule(state.step), "grad_norm": float(norm)}
        k = self.cfg.accumulate_grad_batches
        if k > 1:
            n = state.mini_step
            acc = state.acc_grads or {name: torch.zeros_like(g) for name, g in grads.items()}
            grads = {name: acc[name] + (g - acc[name]) / (n + 1) for name, g in grads.items()}
            state.mini_step = (n + 1) % k
            applied = n == k - 1
            state.acc_grads = None if applied else grads
            if applied:
                norm = _global_norm(grads.values())
        else:
            applied = True
        if applied:
            with torch.no_grad():
                if not bool(norm < CLIP_NORM):
                    grads = {name: g / norm * CLIP_NORM for name, g in grads.items()}
                for name, p in state.params.items():
                    p.grad = grads[name]
                for group in state.optimizer.param_groups:
                    group["lr"] = self.lr_schedule(state.updates)
                state.optimizer.step()
                state.optimizer.zero_grad(set_to_none=True)
                state.updates += 1
                state.ema_num_updates += 1
                n = np.float32(state.ema_num_updates)
                decay = min(np.float32(self.cfg.ema_decay),
                            (np.float32(1) + n) / (np.float32(10) + n))
                one_minus = float(np.float32(1) - decay)
                for name, p in self.dnn.named_parameters():
                    e = state.ema[name]
                    e.sub_(one_minus * (e - p))
        state.step += 1
        return metrics

    @torch.no_grad()
    def valid_step(self, state: "TrainState", batch: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   prior: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> float:
        """The loss under the EMA weights, on the training route."""
        return float(self.loss_fn(batch, generator, prior, params=state.ema))

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


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class TrainState:
    """What training carries from step to step, for ``dnn``'s parameters
    (updated in place): the step count, the number of applied optimiser
    updates (they differ under gradient accumulation), Adam's state, the
    EMA weights and their update count, and the accumulated micro-batch
    gradient mean."""

    def __init__(self, dnn: torch.nn.Module):
        self.params = {n: p for n, p in dnn.named_parameters() if p.requires_grad}
        # optax.adam's defaults; the learning rate is set before each update.
        self.optimizer = torch.optim.Adam(self.params.values(), lr=0.0, betas=(0.9, 0.999),
                                          eps=1e-8)
        self.ema = {n: p.detach().clone() for n, p in dnn.named_parameters()}
        self.step = 0
        self.updates = 0
        self.ema_num_updates = 0
        self.mini_step = 0
        self.acc_grads: Optional[Dict[str, torch.Tensor]] = None

    _COUNTERS = ("step", "updates", "ema_num_updates", "mini_step")

    def state_dict(self) -> Dict[str, Any]:
        """Everything but the parameters themselves, on the CPU."""
        cpu = lambda d: None if d is None else {k: v.detach().cpu() for k, v in d.items()}
        return {"optimizer": self.optimizer.state_dict(), "ema": cpu(self.ema),
                "acc_grads": cpu(self.acc_grads),
                **{k: getattr(self, k) for k in self._COUNTERS}}

    def load_state_dict(self, blob: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(blob["optimizer"])
        dev = next(iter(self.ema.values())).device
        for k, v in blob["ema"].items():
            self.ema[k].copy_(v)
        self.acc_grads = (None if blob["acc_grads"] is None
                          else {k: v.to(dev) for k, v in blob["acc_grads"].items()})
        for k in self._COUNTERS:
            setattr(self, k, int(blob[k]))
