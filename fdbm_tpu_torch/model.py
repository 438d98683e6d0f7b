"""Model: config, spectral front-end, training steps and bridge sampling.

Port of ``fdbm_tpu/model.py``: ``FDBMConfig``, ``make_lr_schedule``, a
train state, and ``FDBM`` with its spec helpers, generative loss, train and
valid steps and enhance functions. The backbone is an ``nn.Module`` that
owns its parameters; its train mode is the training route and its eval
mode the serving route (``models/tfgridnet.py``). Randomness comes from an
explicit ``torch.Generator``. The optimiser is the JAX package's
``clip_by_global_norm(3.0)`` + Adam at the scheduled learning rate (with
``optax.MultiSteps`` gradient accumulation), and the EMA uses torch_ema's
num_updates correction, each matched to optax step by step. Predictive
mode (a ``*_predictive`` backbone that maps y to the clean spec in one
call: trained on that call's loss, served without a sampler) follows
``fdbm_tpu/model.py``. The backbones are TF-GridNet and NCSN++
(``models/ncsnpp.py``, built for the config's bin count; its spectrograms
are padded to a multiple of 64 frames before sampling, ``enhance_batch``).
Finetuning mode (the "enhanced bridge") trains a pretrained bridge through
its own unrolled N-step ODE-EI sampler, with a gradient through the last
backbone call only (``_finetune_unrolled``).

The dtypes follow ``fdbm_tpu/model.py:162,177-180``: ``compute_dtype``
(float32 or bfloat16) is the dtype of the training route, the backbone's
train mode; the serving dtype is ``inference_dtype`` (``bfloat16`` or
``float32``), or ``compute_dtype`` where it is ``""``. The backbone reads the
serving dtype in eval mode, so every serving call follows it:
``enhance_batch`` / ``enhance_audio``, predictive mode's one call, and the
N-1 gradient-free calls of the fine-tuning unroll (the JAX package's
``model_fn(fast=True)``), whose last call trains at the compute dtype. In
bf16 the backbones cast where the JAX package's ``dtype=bfloat16`` modules
do, and the recurrences of the training route stay fp32. The parameters,
Adam, the EMA and the checkpoints stay fp32, as Flax keeps its parameters
fp32 under ``dtype=bfloat16``; ``param_dtype`` is read nowhere, as in the
JAX package.
"""

from __future__ import annotations

import copy
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

    mode: str = "generative"  # generative | predictive | finetuning
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
    # numerics: training (compute_dtype) and serving (inference_dtype, ""
    # inherits compute_dtype) in float32 or bfloat16; param_dtype is read
    # nowhere (parameters stay float32), as in the JAX package
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    inference_dtype: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FDBMConfig":
        """Build from a config dict; keys that are not model fields
        (logging, data) are ignored."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def training_dtype(cfg: FDBMConfig) -> torch.dtype:
    """The dtype of the training route: ``compute_dtype``, float32 or
    bfloat16 (``fdbm_tpu/model.py:162``)."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: training runs in one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.compute_dtype]


def serving_dtype(cfg: FDBMConfig) -> torch.dtype:
    """The dtype of the serving route (``fdbm_tpu/model.py:177-180``):
    ``inference_dtype`` if set, else ``compute_dtype``. ``param_dtype`` is
    accepted and read nowhere, as in the JAX package (``model.py:129``):
    the parameters, Adam and the EMA stay float32. Raises for a dtype that
    is neither float32 nor bfloat16, in either field."""
    training_dtype(cfg)
    name = cfg.inference_dtype or cfg.compute_dtype
    if name not in _DTYPES:
        raise ValueError(f"inference_dtype={cfg.inference_dtype!r}: serving runs in one of "
                         f"{sorted(_DTYPES)} (or '' for compute_dtype)")
    return _DTYPES[name]


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


class FDBM:
    """A bridge model (or a predictive backbone) on one device."""

    def __init__(self, cfg: FDBMConfig, device="cuda"):
        if cfg.mode not in ("generative", "predictive", "finetuning"):
            raise ValueError(f"Unknown mode {cfg.mode}")
        if cfg.mode == "predictive" and not cfg.backbone.endswith("_predictive"):
            raise ValueError(
                f"mode='predictive' requires a *_predictive backbone (got {cfg.backbone!r}), "
                f"matching the reference config pairing (config_predictive.yaml).")
        self.train_dtype = training_dtype(cfg)
        self.serve_dtype = serving_dtype(cfg)
        self.cfg = cfg
        self.device = _resolve_device(device)
        # Hold fp32 as fp32: cuDNN runs fp32 convolutions (conv_in,
        # deconv_out) in TF32 by default, and TF32's 10-bit mantissa breaks
        # parity with the JAX reference, which computes them in full fp32;
        # the 30-step sampler amplifies any per-call deviation.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        backbone_kwargs = {"remat": cfg.remat, "train_dtype": self.train_dtype,
                           "serve_dtype": self.serve_dtype}
        if cfg.backbone.startswith("ncsnpp"):
            # The U-Net places its attention by the (even) bin count it reads.
            backbone_kwargs["image_size"] = (cfg.n_fft // 2 + 1) // 2 * 2
        self.dnn = BackboneRegistry.get_by_name(cfg.backbone)(**backbone_kwargs)
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

    def replica(self, device) -> "FDBM":
        """This model on ``device``: the same config, a copy of the
        backbone's weights (one replica a device of batch-split serving)."""
        twin = copy.copy(self)
        twin.device = _resolve_device(device)
        twin.dnn = copy.deepcopy(self.dnn).to(twin.device)
        twin.window = self.window.to(twin.device)
        return twin

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
        """(x_t, y, t) -> estimate of the clean spec, on the serving route
        (a predictive backbone reads only y)."""
        self.dnn.eval()
        if self.cfg.mode == "predictive":
            return lambda x_t, y, t: self.dnn(None, y)
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

    def _finetune_unrolled(self, y: torch.Tensor, generator: Optional[torch.Generator] = None,
                           z: Optional[torch.Tensor] = None,
                           params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The bridge's N-step ODE-EI sampler from its prior (``z`` replaces
        the draw) with a gradient through the last backbone call only, as
        ``fdbm_tpu/model.py:_finetune_unrolled`` stops it on steps 1..N-1.
        Those steps run on the serving route (eval mode, the serving dtype)
        without autograd; the last runs on the training route (train mode,
        the compute dtype), with autograd where it is enabled. ``params``
        (the EMA weights of the valid loss) replaces the backbone's own on
        every step. The backbone's mode is restored after."""
        bridge = self.bridge
        steps = bridge._steps(bridge.path.sampling_param_ode_ei)
        call = self.dnn if params is None else \
            lambda *args: functional_call(self.dnn, params, args)
        grad = torch.is_grad_enabled()
        was_training = self.dnn.training
        try:
            xt = bridge.prior_sampling(y, generator, z=z)
            for i, (tp, wxt, ws, wy) in enumerate(steps):
                last = i == len(steps) - 1
                self.dnn.train(last)
                with torch.set_grad_enabled(grad and last):
                    est = call(xt, y, torch.full((y.shape[0],), tp, device=y.device))
                xt = wxt * xt + ws * est + wy * y
        finally:
            self.dnn.train(was_training)
        return xt

    def loss_fn(self, batch: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None,
                prior: Optional[Tuple[Optional[torch.Tensor], torch.Tensor]] = None,
                params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The configured loss of one batch ``(x_audio, y_audio[, weights])``;
        ``params`` replaces the backbone's own (the EMA weights of the valid
        loss), ``prior`` the ``(t, z)`` draw of the generative objective (the
        finetuning objective takes its ``z`` as the sampler's prior draw and
        has no ``t``); the predictive one draws nothing. The generative and
        predictive objectives run on the training route."""
        x_audio, y_audio = batch[0], batch[1]
        weights = batch[2] if len(batch) > 2 else None
        x = self.audio_to_spec(x_audio)
        y = self.audio_to_spec(y_audio)
        if self.cfg.mode == "finetuning":
            z = prior[1] if prior is not None else None
            x_hat = self._finetune_unrolled(y, generator, z, params)
            return losses.compute_loss(self.loss_cfg, x_hat, x, weights)
        if self.cfg.mode == "predictive":
            args = (None, y)
        else:
            t, _, _, x_t = self._sample_prior(x, y, generator, *(prior or (None, None)))
            args = (x_t, y, t)
        self.dnn.train()
        x_hat = self.dnn(*args) if params is None else functional_call(self.dnn, params, args)
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
        """Run the sampler on a compressed spec [B, 1, F, T] -> clean spec;
        in predictive mode one backbone call on y, no sampler."""
        if self.cfg.mode == "predictive":
            return self.model_fn()(None, y_spec, None)
        bridge = self.bridge
        if sampler_type is not None or N is not None:
            bridge = dataclasses.replace(bridge, sampler_type=sampler_type or bridge.sampler_type,
                                         N=N or bridge.N)
        return bridge.sample(self.model_fn(), y_spec, generator, **kwargs)

    @torch.no_grad()
    def enhance_batch(self, y_audio: torch.Tensor, generator: Optional[torch.Generator] = None,
                      sampler_type: Optional[str] = None, N: Optional[int] = None,
                      pad_mode: str = "zero_pad", sample_spec: Optional[Callable] = None,
                      **kwargs) -> torch.Tensor:
        """[B, L] float32 normalised audio in, [B, L] float32 out.

        ``pad_mode``: the frame padding of an NCSN++ backbone's spec to a
        multiple of 64 frames (``"zero_pad"`` in validation, ``"reflection"``
        in the serving CLIs; reference infer_single.py:64-69), trimmed by
        the iSTFT. The padding repeats whole complex frames, which is the
        JAX package's padding of the real and imaginary parts one by one.
        ``sample_spec`` replaces :meth:`enhance_spec` between the STFT and
        the iSTFT, with its arguments (batch-split serving,
        ``parallel.mesh.make_parallel_enhance``)."""
        length = y_audio.shape[-1]
        y_spec = self.audio_to_spec(y_audio.to(self.device))
        if self.cfg.backbone.startswith("ncsnpp"):
            y_spec = dsp.pad_spec(y_spec, pad_mode)
        sample = (sample_spec or self.enhance_spec)(y_spec, generator, sampler_type, N, **kwargs)
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
