"""NCSN++ (score-SDE U-Net) backbone in PyTorch.

Port of ``fdbm_tpu/models/ncsnpp.py``: BigGAN residual blocks, FIR
[1,3,3,1] resampling (``ops/upfirdn2d.py``), the progressive ``input_skip``
and ``output_skip`` pyramids with 'sum' combining, channel self-attention,
and a Gaussian-Fourier embedding of log(t). Submodules keep the JAX
package's names (``conv_in``, ``down_{l}_{b}``, ``down_{l}_ds``,
``down_attn_{l}_{b}``, ``combine_{l}``, ``mid_0``, ``mid_attn``, ``mid_1``,
``up_{l}_{b}``, ``up_attn_{l}``, ``up_{l}_us``, ``pyr_gn_{l}``,
``pyr_conv_{l}``, ``output_layer``, ``time_emb``, ``time_fc0``,
``time_fc1``), so converting Flax weights is a relabelling
(``utils/weights.ncsnpp_from_flax``).

Maps are NCHW with H = frequency and W = frames, the JAX package's NHWC
with its channels moved to axis 1 (``channels_last`` measured slower on the
card, PERF.md). The Dense layers on maps (``shortcut``,
``combine_*``, ``q``/``k``/``v``/``proj``, ``output_layer``) are 1x1
convolutions with ``nn.Linear`` weights. A spectrogram with an odd bin
count is sliced to even on entry and a zero row is appended on exit.

No Pallas kernel lies on this path in the JAX package (its convolutions,
norms and attention are XLA ops), so the port runs cuDNN convolutions and
plain PyTorch ops and launches none of the port's CUDA kernels.

``serve_dtype`` (bf16 under ``inference_dtype: bfloat16``) is the dtype of
eval mode, the serving route, and ``train_dtype`` (bf16 under
``compute_dtype: bfloat16``) that of train mode; the JAX package runs one
module on both routes, so the two modes cast alike. In bf16 the net casts
where the JAX package's ``dtype=bfloat16`` module does
(``fdbm_tpu/models/ncsnpp.py``): the input stack and ``conv_in``, the time
MLP, the blocks' convolutions, ``temb_proj``, the Dense layers on maps, the
attention's q/k/v/proj (its softmax in fp32, cast back) and the pyramid in
bf16; every ``GroupNormAct`` with fp32 statistics and a bf16 output; the
FIR resampling weights in the map's dtype; the output layer in fp32.
Parameters stay fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.models.layers import Conv2d, Dense, GaussianFourierProjection
from fdbm_tpu_torch.ops.upfirdn2d import FIR_KERNEL, downsample_2d, upsample_2d

_SQRT2 = math.sqrt(2.0)


def default_init_(layer: nn.Module, scale: float = 1.0) -> nn.Module:
    """The score-SDE init of the JAX package's ``default_init``:
    variance scaling over fan_avg, uniform (xavier-uniform with gain
    sqrt(scale)); a scale of 0 uses 1e-10. Zero bias."""
    nn.init.xavier_uniform_(layer.weight, gain=math.sqrt(max(scale, 1e-10)))
    nn.init.zeros_(layer.bias)
    return layer


def _conv3x3(in_ch: int, out_ch: int, init_scale: float = 1.0) -> nn.Conv2d:
    return default_init_(Conv2d(in_ch, out_ch, 3, padding=1), init_scale)


class NIN(nn.Linear):
    """A Dense layer over the channels of a map ``[B, C, H, W]``: a 1x1
    convolution with ``nn.Linear``'s weight ``[O, I]``, in the map's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight[:, :, None, None].to(x.dtype), self.bias.to(x.dtype))


def _nin(in_ch: int, out_ch: int, init_scale: float = 1.0) -> NIN:
    return default_init_(NIN(in_ch, out_ch), init_scale)


def gn_groups(ch: int) -> int:
    return min(max(ch // 4, 1), 32)


class GroupNormAct(nn.Module):
    """GroupNorm with statistics in fp32 (or wider) in the E[x^2] - mu^2
    form, the variance clamped at 0 and eps inside the root, then the
    optional SiLU: the JAX package's ``GroupNormAct``. Written for few
    launches, which set a B=1 call's time on the card: the mean, the
    root of the sum of squares (``vector_norm``, one read of the map),
    the statistics on ``[B, G]``, then ``(x - mu) * (inv * scale) + bias``."""

    def __init__(self, channels: int, eps: float = 1e-6, act: bool = False):
        super().__init__()
        self.num_groups = gn_groups(channels)
        assert channels % self.num_groups == 0, "channels must divide into groups"
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(b, g, c // g, -1)
        n = xg.shape[2] * xg.shape[3]
        mu = xg.mean(dim=(2, 3), keepdim=True)
        root = torch.linalg.vector_norm(xg, dim=(2, 3), keepdim=True)
        var = torch.addcmul(root * root / n, mu, mu, value=-1.0).clamp(min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight.view(1, g, c // g, 1)
        h = torch.addcmul(self.bias.view(1, g, c // g, 1), xg - mu, scale).reshape(x.shape)
        if self.act:
            h = F.silu(h)
        return h.to(x.dtype)


class AttnBlock(nn.Module):
    """Channel self-attention over all H*W positions (reference
    layerspp.py:62-91): ``softmax(q k^T c^-1/2)`` in fp32 (or wider), then
    ``proj``, then ``(x + out) / sqrt(2)``."""

    def __init__(self, channels: int, skip_rescale: bool = True, init_scale: float = 0.0):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.norm = GroupNormAct(channels)
        self.q, self.k, self.v = (_nin(channels, channels) for _ in range(3))
        self.proj = _nin(channels, channels, init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.norm(x)
        q, k, v = (m(g).reshape(b, c, h * w) for m in (self.q, self.k, self.v))
        attn = torch.matmul(q.transpose(1, 2), k) * (c ** -0.5)  # [B, HW(q), HW(k)]
        attn = torch.softmax(attn.to(torch.promote_types(attn.dtype, torch.float32)), dim=-1)
        out = torch.matmul(v, attn.to(v.dtype).transpose(1, 2)).reshape(b, c, h, w)
        res = x + self.proj(out)
        return res / _SQRT2 if self.skip_rescale else res


class ResnetBlockBigGAN(nn.Module):
    """BigGAN residual block with optional FIR up- or downsampling
    (reference layerspp.py:212-274)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, temb_dim: int = 0,
                 up: bool = False, down: bool = False, dropout: float = 0.0,
                 skip_rescale: bool = True, init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.dropout = dropout
        self.skip_rescale = skip_rescale
        self.gn0 = GroupNormAct(in_ch, act=True)
        self.conv0 = _conv3x3(in_ch, out_ch)
        if temb_dim:
            self.temb_proj = default_init_(Dense(temb_dim, out_ch))
        self.gn1 = GroupNormAct(out_ch, act=True)
        self.conv1 = _conv3x3(out_ch, out_ch, init_scale)
        if in_ch != out_ch or up or down:
            self.shortcut = _nin(in_ch, out_ch)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.gn0(x)
        if self.up:
            h, x = upsample_2d(h, FIR_KERNEL), upsample_2d(x, FIR_KERNEL)
        elif self.down:
            h, x = downsample_2d(h, FIR_KERNEL), downsample_2d(x, FIR_KERNEL)
        h = self.conv0(h)
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.gn1(h)
        if self.dropout > 0:
            h = F.dropout(h, self.dropout, self.training)
        h = self.conv1(h)
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        res = x + h
        return res / _SQRT2 if self.skip_rescale else res


class NCSNpp(nn.Module):
    """NCSN++ v2: ``(x_t, y, t) -> clean-spec estimate`` on complex
    ``[B, 1, F, T]`` spectrograms. With ``time_conditioned=False`` (the
    predictive twins) it has no time embedding and reads only ``y``.

    ``image_size`` is the (even) bin count H the net reads, which decides
    where the attention sits: after the blocks of each level whose H
    (``image_size >> level``) is in ``attn_resolutions``, as the JAX
    package decides it from the actual H at init; the bottleneck always
    has ``mid_attn``. A spectrogram whose H puts the attention elsewhere is
    refused. H and T must divide by 2^(levels - 1).
    """

    def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 image_size: int = 256, fourier_scale: float = 16.0, dropout: float = 0.0,
                 skip_rescale: bool = True, init_scale: float = 0.0,
                 time_conditioned: bool = True, train_dtype: torch.dtype = torch.float32,
                 serve_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.train_dtype = train_dtype
        self.serve_dtype = serve_dtype
        self.levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.image_size = image_size
        self.time_conditioned = time_conditioned
        channels = 4 if time_conditioned else 2
        temb_dim = 4 * nf if time_conditioned else 0
        if time_conditioned:
            self.time_emb = GaussianFourierProjection(nf, fourier_scale)
            self.time_fc0 = default_init_(Dense(2 * nf, temb_dim))
            self.time_fc1 = default_init_(Dense(temb_dim, temb_dim))

        def resblock(name, in_ch, out_ch=None, up=False, down=False):
            self.add_module(name, ResnetBlockBigGAN(
                in_ch, out_ch, temb_dim, up=up, down=down, dropout=dropout,
                skip_rescale=skip_rescale, init_scale=init_scale))

        def attnblock(name, ch):
            self.add_module(name, AttnBlock(ch, skip_rescale, init_scale))

        self.conv_in = _conv3x3(channels, nf)
        hs_ch = [nf]
        in_ch = nf
        for level in range(self.levels):
            for block in range(num_res_blocks):
                out_ch = nf * ch_mult[level]
                resblock(f"down_{level}_{block}", in_ch, out_ch)
                in_ch = out_ch
                if self._attends(image_size >> level):
                    attnblock(f"down_attn_{level}_{block}", in_ch)
                hs_ch.append(in_ch)
            if level != self.levels - 1:
                resblock(f"down_{level}_ds", in_ch, down=True)
                self.add_module(f"combine_{level}", _nin(channels, in_ch))
                hs_ch.append(in_ch)

        resblock("mid_0", in_ch)
        attnblock("mid_attn", in_ch)
        resblock("mid_1", in_ch)

        for level in reversed(range(self.levels)):
            for block in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[level]
                resblock(f"up_{level}_{block}", in_ch + hs_ch.pop(), out_ch)
                in_ch = out_ch
            if self._attends(image_size >> level):
                attnblock(f"up_attn_{level}", in_ch)
            self.add_module(f"pyr_gn_{level}", GroupNormAct(in_ch, act=True))
            self.add_module(f"pyr_conv_{level}", _conv3x3(in_ch, channels, init_scale))
            if level != 0:
                resblock(f"up_{level}_us", in_ch, up=True)
        assert not hs_ch
        # Flax Dense's own init (lecun_normal): the JAX package gives the
        # output layer no default_init.
        self.output_layer = NIN(channels, 2)
        std = 1.0 / math.sqrt(channels) / 0.87962566103423978
        nn.init.trunc_normal_(self.output_layer.weight, std=std, a=-2 * std, b=2 * std)
        nn.init.zeros_(self.output_layer.bias)

    def _attends(self, h: int) -> bool:
        return h in self.attn_resolutions

    def _attn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """The attention block ``name`` where this level attends."""
        built = name in self._modules
        if self._attends(h.shape[2]) != built:
            raise ValueError(
                f"NCSNpp built for H={self.image_size} frequency bins places {name} "
                f"{'' if built else 'nowhere '}at this level, but the input's H there is "
                f"{h.shape[2]}; build the model with image_size set to the input's "
                "(even) bin count")
        return self._modules[name](h) if built else h

    def forward(self, x: Optional[torch.Tensor], y: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, y: complex ``[B, 1, F, T]``; t: ``[B]`` (x and t unused by a
        predictive twin). Returns complex ``[B, 1, F, T]``."""
        # A bf16 dtype of the mode's route casts the activations; otherwise
        # they keep the input's dtype (fp32, or float64 for a reference route).
        dt = self.train_dtype if self.training else self.serve_dtype
        dt = None if dt == torch.float32 else dt
        chans = [x.real, x.imag, y.real, y.imag] if self.time_conditioned else [y.real, y.imag]
        inp = torch.stack([ch[:, 0] for ch in chans], dim=1)  # [B, C, F, T]
        inp = inp if dt is None else inp.to(dt)
        orig_f = inp.shape[2]
        if orig_f % 2 == 1:  # the Nyquist bin (ncsnpp_v2.py:249-250)
            inp = inp[:, :, :orig_f - 1]
        mods = self._modules

        temb = None
        if self.time_conditioned:
            temb = self.time_emb(torch.log(t))
            temb = self.time_fc1(F.silu(self.time_fc0(temb if dt is None else temb.to(dt))))

        input_pyramid = inp
        hs = [self.conv_in(inp)]
        for level in range(self.levels):
            for block in range(self.num_res_blocks):
                h = mods[f"down_{level}_{block}"](hs[-1], temb)
                hs.append(self._attn(f"down_attn_{level}_{block}", h))
            if level != self.levels - 1:
                h = mods[f"down_{level}_ds"](hs[-1], temb)
                input_pyramid = downsample_2d(input_pyramid, FIR_KERNEL)
                hs.append(mods[f"combine_{level}"](input_pyramid) + h)

        h = self.mid_1(self.mid_attn(self.mid_0(hs[-1], temb)), temb)

        pyramid = None
        for level in reversed(range(self.levels)):
            for block in range(self.num_res_blocks + 1):
                h = mods[f"up_{level}_{block}"](torch.cat([h, hs.pop()], dim=1), temb)
            h = self._attn(f"up_attn_{level}", h)
            pyr_h = mods[f"pyr_conv_{level}"](mods[f"pyr_gn_{level}"](h))
            pyramid = pyr_h if pyramid is None else upsample_2d(pyramid, FIR_KERNEL) + pyr_h
            if level != 0:
                h = mods[f"up_{level}_us"](h, temb)
        assert not hs

        out = self.output_layer(pyramid.to(torch.promote_types(pyramid.dtype, torch.float32)))
        out = torch.complex(out[:, 0], out[:, 1])  # [B, F', T]
        if orig_f % 2 == 1:
            out = torch.cat([out, torch.zeros_like(out[:, :1])], dim=1)
        return out[:, None]


# Registered variants (reference names, ncsnpp_v2.py:36,404-453). Each
# factory takes the ``remat`` that ``FDBM`` passes and ignores it, as the
# JAX package's factories do, ``image_size``, the even bin count of the
# spectrogram the net reads (256 for the configs' n_fft 510 and 512), and
# ``train_dtype`` and ``serve_dtype``, the dtypes of train and eval mode.
_SMALL = dict(ch_mult=(1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(0,))


@BackboneRegistry.register("ncsnpp_v2")
def ncsnpp_v2(remat: bool = False, image_size: int = 256,
              **dtypes: torch.dtype) -> NCSNpp:
    return NCSNpp(image_size=image_size, **dtypes)


@BackboneRegistry.register("ncsnpp_v2_5M")
def ncsnpp_v2_5m(remat: bool = False, image_size: int = 256,
                 **dtypes: torch.dtype) -> NCSNpp:
    return NCSNpp(nf=96, image_size=image_size, **dtypes, **_SMALL)


@BackboneRegistry.register("ncsnpp_v2_16M")
def ncsnpp_v2_16m(remat: bool = False, image_size: int = 256,
                  **dtypes: torch.dtype) -> NCSNpp:
    return NCSNpp(nf=64, attn_resolutions=(0,), image_size=image_size, **dtypes)


@BackboneRegistry.register("ncsnpp_v2_37M")
def ncsnpp_v2_37m(remat: bool = False, image_size: int = 256,
                  **dtypes: torch.dtype) -> NCSNpp:
    return NCSNpp(nf=96, image_size=image_size, **dtypes)


@BackboneRegistry.register("ncsnpp_v2_predictive")
def ncsnpp_v2_predictive(remat: bool = False, image_size: int = 256,
                         **dtypes: torch.dtype) -> NCSNpp:
    return NCSNpp(time_conditioned=False, image_size=image_size, **dtypes)


@BackboneRegistry.register("ncsnpp_v2_5M_predictive")
def ncsnpp_v2_5m_predictive(remat: bool = False, image_size: int = 256,
                            **dtypes: torch.dtype) -> NCSNpp:
    return NCSNpp(nf=96, time_conditioned=False, image_size=image_size, **dtypes,
                  **_SMALL)
