"""TF-GridNet (V3) backbone in PyTorch.

Port of ``fdbm_tpu/models/tfgridnet.py``: per block an intra-frequency and
an inter-frame RNN path (unfold k=4 -> BiLSTM -> deconv -> overlap-add),
full-band frame self-attention, and a per-block additive bias from a
Gaussian-Fourier embedding of log(t). Channel-last canvases
``[B, T, Q, C]`` as in the JAX package.

Two kernel routes share one parameter set, chosen by the module's mode:

* eval mode is the serving route, the JAX package's ``use_pallas``
  (``tfgridnet.py:114-147`` and ``:308-356``): each RNN path calls
  ``ops.gridrnn.grid_rnn_seq1_pair`` on a canvas with its sequence on
  axis 1 (intra on the (1,2)-swapped canvas, inter on the swap back), and
  the attention calls ``ops.attention.frame_attention`` with the q/k/v
  norms fused in. These kernels have no backward.
* train mode is the training route, the JAX package's ``use_pallas_train``
  (``tfgridnet.py:148-172``): each RNN path turns its canvas into
  sequence-major lines and calls ``ops.gridrnn_train.grid_fold_train_pair``
  (kernels with a backward), or ``ops.gridrnn.grid_bilstm_fold`` when no
  gradient is needed, on fp32 lines at either compute dtype; the attention
  runs on plain PyTorch ops under autograd, as the JAX package trains it on
  plain XLA ops.

Outside the fused RNN-path kernels' gate (C % 8 == 0, C <= 64, H <= 128;
the class defaults C=48, H=200 are outside it) each RNN path takes the JAX
package's generic path (``tfgridnet.py:179-216``) on either route: unfold,
the ``BiLSTM`` module, the deconv as a product and the overlap-add. The
``BiLSTM`` runs ``ops.lstm.bilstm_fused_forward`` in eval mode and
``ops.lstm.bilstm_train`` (``lstm_core``, or ``lstm_forward`` without a
gradient) in train mode. The attention fuses its q/k/v norms only where
their widths E and C/n_head are powers of two, as the JAX package does;
otherwise it norms on plain ops and calls ``frame_attention`` without them.

On CPU tensors the wrappers run their plain versions; with
``use_kernels=False`` the model calls the plain versions on any device,
which is the reference the card's kernels are held against. ``remat``
recomputes each block in the backward (``torch.utils.checkpoint``), the
JAX package's ``nn.remat``. ``conv_in``, the output ConvTranspose and the
Dense layers are ``torch.nn``'s (``layers.Dense``, ``Conv2d``,
``ConvTranspose2d`` compute in their input's dtype).

``serve_dtype`` (bf16 under ``inference_dtype: bfloat16``) is the dtype of
the serving route (eval mode) and ``train_dtype`` (bf16 under
``compute_dtype: bfloat16``) that of the training route (train mode). In
bf16 the model casts where the JAX package's ``dtype=bfloat16`` modules do
(``fdbm_tpu/models/tfgridnet.py``): the input and ``conv_in`` in bf16,
``gn_in`` with fp32 statistics cast to bf16; the Fourier embedding in fp32,
the time MLP and block biases in bf16; each RNN path's LayerNorm with fp32
statistics (single pass), then on the serving route the bf16 canvas
through kernel 1's bf16 form (or, outside its gate, the bf16 windows
through kernel 7's and the deconv as a bf16 product), on the training route
the lines cast to fp32 through kernels 5-6 (or 4) and the fold cast back
(outside the gate the ``BiLSTM`` runs kernels 8-9 on fp32 and the deconv is
a bf16 product), ``outf + outb + bias + residual`` in bf16; the Q/K/V
projections in bf16, then on the serving route kernels 2 and 3 on bf16
maps, on the training route the norms (fp32 statistics) and both products
in bf16 with the softmax in fp32; ``attn_proj``, the PReLU and the
LayerNorm, then ``deconv_out`` in bf16, and the output cast to fp32 before
the complex spectrogram. Parameters stay fp32. With ``use_kernels=False``
the plain route casts the same, so that it stays the reference of the
kernel route.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.models.layers import (BiLSTM, Conv2d, ConvTranspose2d, Dense,
                                          GaussianFourierProjection, PReLU, layer_norm_f32,
                                          recurrence_input)
from fdbm_tpu_torch.ops.attention import (flat_group_norm_plain, frame_attention,
                                          frame_attention_plain)
from fdbm_tpu_torch.ops.gridrnn import (grid_bilstm_fold, grid_rnn_seq1_pair,
                                        grid_rnn_seq1_pair_plain)
from fdbm_tpu_torch.ops.gridrnn_train import grid_fold_train_pair, grid_fold_train_pair_plain

_OLP_KS = 4  # emb_ks
_OLP_HS = 1  # emb_hs


def _kernel_fast_path_ok(c: int, hidden: int) -> bool:
    """The JAX package's RNN shape gate (``_pallas_fast_path_ok``): the
    fused RNN-path kernel takes C % 8 == 0, C <= 64 and H <= 128."""
    return c % 8 == 0 and c <= 64 and hidden <= 128


def _fused_norms_ok(e: int, d: int) -> bool:
    """The JAX package's predicate for fusing the q/k/v norms into the
    attention (``fdbm_tpu/ops/attention.py:166-169``): ``flat_group_norm``
    takes power-of-two group widths only."""
    return all(w > 0 and w & (w - 1) == 0 for w in (e, d))


class _RnnPath(nn.Module):
    """One intra- or inter- RNN path on a canvas ``[B, S, P, C]`` with the
    sequence on axis 1: LN -> unfold -> BiLSTM -> deconv -> fold -> +res.
    The canvas is already padded by 3 on both spatial axes.

    Inside the fused kernels' gate (``_kernel_fast_path_ok``) the whole path
    is one fused RNN-path call; outside it, the JAX package's generic path
    (``fdbm_tpu/models/tfgridnet.py:179-216``): the k=4 windows, the
    ``BiLSTM`` module (``ops.lstm``'s kernels), the deconv as a product and
    the overlap-add in plain PyTorch."""

    def __init__(self, emb_dim: int, hidden: int, use_kernels: bool = True):
        super().__init__()
        c = emb_dim
        self.hidden = hidden
        self.use_kernels = use_kernels
        self.ln_gamma = nn.Parameter(torch.ones(c))
        self.ln_beta = nn.Parameter(torch.zeros(c))
        self.bilstm = BiLSTM(_OLP_KS * c, hidden, use_kernels)
        # ConvTranspose1d(2H -> C, k=4) as a Dense [2H, 4C] (tap-major
        # columns) plus a bias per output position.
        self.deconv_kernel = nn.Parameter(torch.randn(2 * hidden, _OLP_KS * c)
                                          / (2 * hidden) ** 0.5)
        self.deconv_bias = nn.Parameter(torch.zeros(c))

    def _generic(self, lines: torch.Tensor) -> torch.Tensor:
        """Sequence-major lines ``[S, N, C]`` -> their folds ``[S, N, C]``,
        exact on every row."""
        s, n, c = lines.shape
        length = s - (_OLP_KS - 1)
        # Windows [L, N, 4C], tap-major (j slow, c fast) as the fused kernels read them.
        win = torch.cat([lines[j:j + length] for j in range(_OLP_KS)], dim=-1)
        hidden = self.bilstm(win)
        taps = hidden @ self.deconv_kernel.to(hidden.dtype)  # [L, N, 4C]
        # Overlap-add: row r = sum_j taps[r - j, tap j], in taps' dtype and
        # tap order, as the JAX package's pad-and-sum.
        out = taps.new_zeros(s, n, c)
        for j in range(_OLP_KS):
            out[j:j + length] += taps[..., j * c:(j + 1) * c]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm_f32(x, self.ln_gamma, self.ln_beta)
        lstm = self.bilstm
        weights = (lstm.w_ih, lstm.w_hh, lstm.bias, self.deconv_kernel)
        b, s, p, c = h.shape
        fused = _kernel_fast_path_ok(c, self.hidden)
        kernel = self.use_kernels and fused
        if fused and not self.training:
            rnn = grid_rnn_seq1_pair if kernel else grid_rnn_seq1_pair_plain
            outf, outb = rnn(h.contiguous(), *weights)
            folded = outf + outb
        else:
            # Sequence-major lines [S, B*P, C], as the JAX training route
            # hands them to grid_fold_train_pair: in fp32 (or wider) under
            # bf16 training too, the fold cast back below.
            lines = h.transpose(0, 1).reshape(s, b * p, c).contiguous()
            if not fused:
                lines = self._generic(lines)
            else:
                lines = recurrence_input(lines)
                if not kernel:
                    outf, outb = grid_fold_train_pair_plain(lines, *weights)
                    lines = outf + outb
                elif torch.is_grad_enabled():
                    outf, outb = grid_fold_train_pair(lines, *weights)
                    lines = outf + outb
                else:
                    lines = grid_bilstm_fold(lines, *weights)
            folded = lines.reshape(s, b, p, c).transpose(0, 1)
        # Rows outside [3, L-1] of the fused fold are cropped by GridNetBlock.
        return (folded + self.deconv_bias.to(folded.dtype)).to(x.dtype) + x


class _AllHeadPReLULayerNorm(nn.Module):
    """PReLU (per head) + per-(head, E) affine norm over the E lanes of
    ``[B, T, Q, H*E]`` -> ``[B, T, Q, H, E]``. GridNetBlock hands the
    parameters to ``frame_attention(norms=...)``."""

    def __init__(self, n_head: int, e_dim: int):
        super().__init__()
        self.e_dim = e_dim
        self.prelu_alpha = nn.Parameter(torch.full((n_head, 1), 0.25))
        self.gamma = nn.Parameter(torch.ones(n_head, e_dim))
        self.beta = nn.Parameter(torch.zeros(n_head, e_dim))

    def params(self):
        return self.prelu_alpha, self.gamma, self.beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, q, _ = x.shape
        alpha, gamma, beta = self.params()
        if x.dtype == torch.bfloat16:
            # The JAX module applies the PReLU in the activations' dtype, then
            # normalises in fp32 (fdbm_tpu/models/tfgridnet.py:280-298).
            xs = x.reshape(b, t, q, -1, self.e_dim)
            x = torch.where(xs >= 0, xs, alpha.to(x.dtype) * xs).reshape(x.shape)
            alpha = torch.ones_like(alpha)
        out = flat_group_norm_plain(x.reshape(b, t, -1), alpha, gamma, beta, width=self.e_dim)
        return out.reshape(b, t, q, -1, self.e_dim)


class GridNetBlock(nn.Module):
    """One TF-GridNet V3 block: intra-RNN, inter-RNN, frame attention."""

    def __init__(self, emb_dim: int, hidden: int, n_head: int = 4,
                 qk_output_channel: int = 2, use_kernels: bool = True):
        super().__init__()
        c, e = emb_dim, qk_output_channel
        self.n_head, self.e_dim = n_head, e
        self.use_kernels = use_kernels
        self.intra = _RnnPath(c, hidden, use_kernels)
        self.inter = _RnnPath(c, hidden, use_kernels)
        self.attn_conv_Q = Dense(c, n_head * e)
        self.attn_conv_K = Dense(c, n_head * e)
        self.attn_conv_V = Dense(c, c)
        self.attn_norm_Q = _AllHeadPReLULayerNorm(n_head, e)
        self.attn_norm_K = _AllHeadPReLULayerNorm(n_head, e)
        self.attn_norm_V = _AllHeadPReLULayerNorm(n_head, c // n_head)
        self.attn_proj = Dense(c, c)
        self.attn_prelu = PReLU(())
        self.attn_ln_gamma = nn.Parameter(torch.ones(c))
        self.attn_ln_beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, T, Q, C]`` -> ``[B, T, Q, C]``."""
        _, old_t, old_q, _ = x.shape
        olp = _OLP_KS - _OLP_HS  # 3
        xp = F.pad(x, (0, 0, olp, olp, olp, olp))
        # The RNN paths want the sequence on axis 1: intra runs on the
        # (1,2)-swapped canvas [B, Q', T', C], inter on the swap back.
        xq = self.intra(xp.transpose(1, 2))
        xp = self.inter(xq.transpose(1, 2))
        inter = xp[:, olp:olp + old_t, olp:olp + old_q, :]

        norm_mods = (self.attn_norm_Q, self.attn_norm_K, self.attn_norm_V)
        q, k, v = self.attn_conv_Q(inter), self.attn_conv_K(inter), self.attn_conv_V(inter)
        norms = tuple(m.params() for m in norm_mods)
        if self.training:
            # The training route trains the attention on plain ops, as JAX does.
            q, k, v = (m(a).reshape(a.shape) for m, a in zip(norm_mods, (q, k, v)))
            out = frame_attention_plain(q, k, v, self.n_head, self.e_dim, widen=False)
        elif not self.use_kernels:
            out = frame_attention_plain(q, k, v, self.n_head, self.e_dim, norms=norms)
        elif _fused_norms_ok(self.e_dim, x.shape[-1] // self.n_head):
            out = frame_attention(q, k, v, self.n_head, self.e_dim, norms=norms)
        else:
            q, k, v = (m(a).reshape(a.shape) for m, a in zip(norm_mods, (q, k, v)))
            out = frame_attention(q, k, v, self.n_head, self.e_dim)
        out = self.attn_prelu(self.attn_proj(out))
        out = layer_norm_f32(out, self.attn_ln_gamma, self.attn_ln_beta)
        return out + inter


class TFGridNet(nn.Module):
    """TF-GridNet: ``(x_t, y, t) -> clean-spec estimate``. With
    ``time_conditioned=False`` (the predictive twins) it has no time
    embedding and no per-block time bias, and reads only ``y``.
    ``serve_dtype`` is the dtype of eval mode, the serving route, and
    ``train_dtype`` that of train mode, the training route (each fp32 or
    bf16)."""

    def __init__(self, n_layers: int = 6, emb_dim: int = 48, hidden: int = 200,
                 n_head: int = 4, qk_output_channel: int = 2, n_srcs: int = 1,
                 fourier_scale: float = 16.0, time_conditioned: bool = True,
                 use_kernels: bool = True, remat: bool = False,
                 train_dtype: torch.dtype = torch.float32,
                 serve_dtype: torch.dtype = torch.float32):
        super().__init__()
        c = emb_dim
        self.n_srcs = n_srcs
        self.time_conditioned = time_conditioned
        self.remat = remat
        self.train_dtype = train_dtype
        self.serve_dtype = serve_dtype
        self.conv_in = Conv2d(4 if time_conditioned else 2, c, 3, padding=1)
        self.gn_in = nn.GroupNorm(1, c, eps=1e-5)
        if time_conditioned:
            self.time_emb = GaussianFourierProjection(c, fourier_scale)
            self.time_fc1 = Dense(2 * c, 4 * c)
            self.time_fc2 = Dense(4 * c, 4 * c)
            self.time_blocks = nn.ModuleList(Dense(4 * c, c) for _ in range(n_layers))
        self.blocks = nn.ModuleList(
            GridNetBlock(c, hidden, n_head, qk_output_channel, use_kernels)
            for _ in range(n_layers))
        self.deconv_out = ConvTranspose2d(c, 2 * n_srcs, 3, padding=1)

    def forward(self, x: Optional[torch.Tensor], y: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, y: complex ``[B, 1, F, T]``; t: ``[B]`` (both unused by a
        predictive twin). Returns complex ``[B, n_srcs, F, T]``."""
        # A bf16 dtype of the mode's route casts the activations; otherwise
        # they keep the input's dtype (fp32, or float64 for a reference route).
        dt = self.train_dtype if self.training else self.serve_dtype
        dt = None if dt == torch.float32 else dt
        chans = [x.real, x.imag, y.real, y.imag] if self.time_conditioned else [y.real, y.imag]
        inp = torch.stack([ch[:, 0] for ch in chans], dim=1).transpose(2, 3)  # [B, Cin, T, F]
        if dt is None:
            h = self.gn_in(self.conv_in(inp))
        else:  # gn_in takes fp32 statistics of conv_in's output, then casts to dt
            h = self.gn_in(self.conv_in(inp.to(dt)).float()).to(dt)
        h = h.permute(0, 2, 3, 1).contiguous()  # [B, T, Q, C]

        if self.time_conditioned:
            temb = self.time_emb(torch.log(t))
            temb = temb if dt is None else temb.to(dt)
            temb = F.silu(self.time_fc2(F.silu(self.time_fc1(temb))))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if self.time_conditioned:
                h = h + self.time_blocks[i](temb)[:, None, None, :]
            h = checkpoint(block, h, use_reentrant=False) if remat else block(h)

        out = self.deconv_out(h.permute(0, 3, 1, 2)).float()  # [B, 2*S, T, Q]
        b, _, tt, qq = out.shape
        out = out.reshape(b, self.n_srcs, 2, tt, qq)
        return torch.complex(out[:, :, 0], out[:, :, 1]).transpose(-1, -2)


@BackboneRegistry.register("tfgridnet_5l32c100")
def tfgridnet_5l32c100(**kwargs) -> TFGridNet:
    return TFGridNet(n_layers=5, emb_dim=32, hidden=100, **kwargs)


@BackboneRegistry.register("tfgridnet_4l32c80")
def tfgridnet_4l32c80(**kwargs) -> TFGridNet:
    return TFGridNet(n_layers=4, emb_dim=32, hidden=80, **kwargs)


@BackboneRegistry.register("tfgridnet_5l32c100_predictive")
def tfgridnet_5l32c100_predictive(**kwargs) -> TFGridNet:
    return TFGridNet(n_layers=5, emb_dim=32, hidden=100, time_conditioned=False, **kwargs)


@BackboneRegistry.register("tfgridnet_4l32c80_predictive")
def tfgridnet_4l32c80_predictive(**kwargs) -> TFGridNet:
    return TFGridNet(n_layers=4, emb_dim=32, hidden=80, time_conditioned=False, **kwargs)
