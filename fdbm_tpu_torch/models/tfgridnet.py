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
  gradient is needed; the attention is the plain PyTorch version under
  autograd, as the JAX package trains it on plain XLA ops.

On CPU tensors the wrappers run their plain versions; with
``use_kernels=False`` the model calls the plain versions on any device,
which is the reference the card's kernels are held against. ``remat``
recomputes each block in the backward (``torch.utils.checkpoint``), the
JAX package's ``nn.remat``. ``conv_in``, the output ConvTranspose and the
Dense layers stay ``torch.nn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fdbm_tpu_torch.models import BackboneRegistry
from fdbm_tpu_torch.models.layers import BiLSTM, GaussianFourierProjection, PReLU, layer_norm_f32
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


class _RnnPath(nn.Module):
    """One intra- or inter- RNN path on a canvas ``[B, S, P, C]`` with the
    sequence on axis 1: LN -> unfold -> BiLSTM -> deconv -> fold -> +res.
    The canvas is already padded by 3 on both spatial axes."""

    def __init__(self, emb_dim: int, hidden: int, use_kernels: bool = True):
        super().__init__()
        c = emb_dim
        self.hidden = hidden
        self.use_kernels = use_kernels
        self.ln_gamma = nn.Parameter(torch.ones(c))
        self.ln_beta = nn.Parameter(torch.zeros(c))
        self.bilstm = BiLSTM(_OLP_KS * c, hidden)
        # ConvTranspose1d(2H -> C, k=4) as a Dense [2H, 4C] (tap-major
        # columns) plus a bias per output position.
        self.deconv_kernel = nn.Parameter(torch.randn(2 * hidden, _OLP_KS * c)
                                          / (2 * hidden) ** 0.5)
        self.deconv_bias = nn.Parameter(torch.zeros(c))

    def _kernel_ok(self, x: torch.Tensor) -> bool:
        """Whether the fused kernels take this path; on the card a path
        outside their gate raises (its fallback is not ported)."""
        if not self.use_kernels:
            return False
        if _kernel_fast_path_ok(x.shape[-1], self.hidden):
            return True
        if x.is_cuda:
            raise NotImplementedError(
                f"TF-GridNet RNN path with C={x.shape[-1]}, H={self.hidden} is outside "
                "the fused kernel's gate (C % 8 == 0, C <= 64, H <= 128); its fallbacks, "
                "fdbm_tpu/ops/lstm.py:537 bilstm_fused_forward and :298 lstm_core, are "
                "not ported yet")
        return False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm_f32(x, self.ln_gamma, self.ln_beta)
        lstm = self.bilstm
        weights = (lstm.w_ih, lstm.w_hh, lstm.bias, self.deconv_kernel)
        kernel = self._kernel_ok(x)
        if not self.training:
            rnn = grid_rnn_seq1_pair if kernel else grid_rnn_seq1_pair_plain
            outf, outb = rnn(h.contiguous(), *weights)
            folded = outf + outb
        else:
            # Sequence-major lines [S, B*P, C], as the JAX training route
            # hands them to grid_fold_train_pair.
            b, s, p, c = h.shape
            lines = h.transpose(0, 1).reshape(s, b * p, c).contiguous()
            if not kernel:
                outf, outb = grid_fold_train_pair_plain(lines, *weights)
                lines = outf + outb
            elif torch.is_grad_enabled():
                outf, outb = grid_fold_train_pair(lines, *weights)
                lines = outf + outb
            else:
                lines = grid_bilstm_fold(lines, *weights)
            folded = lines.reshape(s, b, p, c).transpose(0, 1)
        # Rows outside [3, L-1] of the fold are cropped by GridNetBlock.
        return folded + self.deconv_bias + x


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
        out = flat_group_norm_plain(x.reshape(b, t, -1), *self.params(), width=self.e_dim)
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
        self.attn_conv_Q = nn.Linear(c, n_head * e)
        self.attn_conv_K = nn.Linear(c, n_head * e)
        self.attn_conv_V = nn.Linear(c, c)
        self.attn_norm_Q = _AllHeadPReLULayerNorm(n_head, e)
        self.attn_norm_K = _AllHeadPReLULayerNorm(n_head, e)
        self.attn_norm_V = _AllHeadPReLULayerNorm(n_head, c // n_head)
        self.attn_proj = nn.Linear(c, c)
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

        norms = (self.attn_norm_Q.params(), self.attn_norm_K.params(),
                 self.attn_norm_V.params())
        # The training route trains the attention on plain ops, as JAX does.
        attention = (frame_attention if self.use_kernels and not self.training
                     else frame_attention_plain)
        out = attention(self.attn_conv_Q(inter), self.attn_conv_K(inter),
                        self.attn_conv_V(inter), self.n_head, self.e_dim, norms=norms)
        out = self.attn_prelu(self.attn_proj(out))
        out = layer_norm_f32(out, self.attn_ln_gamma, self.attn_ln_beta)
        return out + inter


class TFGridNet(nn.Module):
    """Generative TF-GridNet: ``(x_t, y, t) -> clean-spec estimate``."""

    def __init__(self, n_layers: int = 6, emb_dim: int = 48, hidden: int = 200,
                 n_head: int = 4, qk_output_channel: int = 2, n_srcs: int = 1,
                 fourier_scale: float = 16.0, use_kernels: bool = True, remat: bool = False):
        super().__init__()
        c = emb_dim
        self.n_srcs = n_srcs
        self.remat = remat
        self.conv_in = nn.Conv2d(4, c, 3, padding=1)
        self.gn_in = nn.GroupNorm(1, c, eps=1e-5)
        self.time_emb = GaussianFourierProjection(c, fourier_scale)
        self.time_fc1 = nn.Linear(2 * c, 4 * c)
        self.time_fc2 = nn.Linear(4 * c, 4 * c)
        self.time_blocks = nn.ModuleList(nn.Linear(4 * c, c) for _ in range(n_layers))
        self.blocks = nn.ModuleList(
            GridNetBlock(c, hidden, n_head, qk_output_channel, use_kernels)
            for _ in range(n_layers))
        self.deconv_out = nn.ConvTranspose2d(c, 2 * n_srcs, 3, padding=1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x, y: complex ``[B, 1, F, T]``; t: ``[B]``. Returns complex
        ``[B, n_srcs, F, T]``."""
        chans = [x.real, x.imag, y.real, y.imag]
        inp = torch.stack([ch[:, 0] for ch in chans], dim=1).transpose(2, 3)  # [B, 4, T, F]
        h = self.gn_in(self.conv_in(inp))
        h = h.permute(0, 2, 3, 1).contiguous()  # [B, T, Q, C]

        temb = self.time_emb(torch.log(t))
        temb = F.silu(self.time_fc2(F.silu(self.time_fc1(temb))))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for time_block, block in zip(self.time_blocks, self.blocks):
            h = h + time_block(temb)[:, None, None, :]
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
