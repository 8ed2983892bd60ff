"""CDM — the semantic/distortion modulation blocks of KSVQE (counterpart of
kvq_tpu/nn/cdm.py; reference KSVQE_model.py).

  - :class:`CrossAttention`    == crossattention1 (:1553-1591): q from x,
    k/v from tokens, NO output projection, scale 1/sqrt(C) over the FULL
    model dim (reference quirk, kept);
  - :class:`TemporalAttention` == Attention (:1508-1551): qkv linear without
    bias, per-head scale, output projection;
  - :class:`SemanticFiLM`      == Semantic_Transformation2 (:817-835);
  - :class:`DistFiLM`          == Dist_Transformation3 (:934-960).

The reference's variants that no config uses, as kvq_tpu rebuilds them
(kvq_tpu/nn/cdm.py:183-302): :class:`SemanticFiLM4` (channel FiLM from the
field's mean and std), :class:`SemanticFiLM6` (spatial then channel FiLM,
the channel gain from ``get_beta(mean)``: the reference's ``get_gamma`` is
dead and, as in kvq_tpu, not built), :class:`SemanticFiLM8` (a 3x3 conv
and LeakyReLU, then spatial FiLM), :class:`DistFiLM5` (token-wise FiLM
from 3x3x3 convs) and :class:`DistFiLM7` (token-wise then channel FiLM).
The means and stds are :func:`~kvq_tpu_torch.nn.layers.avg_std_pool` over
every axis but the channels.

With ``use_pallas`` the attentions run K2
(:func:`~kvq_tpu_torch.ops.window_attention.flash_attention_nobias_cl`) at
eval: the CUDA kernel for CUDA tensors, its plain version for CPU tensors.
K2 has no backward: in training the attentions run their plain composition
under autograd, as the JAX package keeps its XLA form there
(kvq_tpu/nn/cdm.py, ``use_pallas and not train``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.window_attention import flash_attention_nobias_cl
from .layers import avg_std_pool, conv1x1, conv_channels_last


class AdapterMLP(nn.Sequential):
    """Linear(d, d/4) -> ReLU -> Linear(d/4, out) -> ReLU, the shape of every
    adapter in KSVQE (KSVQE_model.py:1080-1084, 1174-1186)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, in_dim // 4), nn.ReLU(),
                         nn.Linear(in_dim // 4, out_dim), nn.ReLU())

    def forward(self, x):
        return super().forward(x.to(self[0].weight.dtype))


def _heads(t, h):
    B, N, C = t.shape
    return t.reshape(B, N, h, C // h).transpose(1, 2)


def _merge(t):
    B, h, N, hd = t.shape
    return t.transpose(1, 2).reshape(B, N, h * hd)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_pallas = use_pallas
        self.fc_q = nn.Linear(dim, dim)
        self.fc_k = nn.Linear(dim, dim)
        self.fc_v = nn.Linear(dim, dim)

    def forward(self, q_tokens, kv_tokens):
        # q_tokens (B, Nq, C), kv_tokens (B, Nk, C) -> (B, Nq, C)
        C = q_tokens.shape[-1]
        h = self.num_heads
        q, k, v = self.fc_q(q_tokens), self.fc_k(kv_tokens), self.fc_v(kv_tokens)
        if self.use_pallas and not self.training:
            return flash_attention_nobias_cl(q, k, v, h, C ** -0.5)
        q, k, v = _heads(q, h), _heads(k, h), _heads(v, h)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / C ** 0.5
        attn = attn.softmax(dim=-1).to(v.dtype)
        return _merge(torch.matmul(attn, v))


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_pallas = use_pallas
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(dim, dim), nn.Dropout(0.0))

    def forward(self, x):
        C = x.shape[-1]
        h = self.num_heads
        hd = C // h
        q, k, v = self.to_qkv(x).split(C, dim=-1)
        if self.use_pallas and not self.training:
            return self.to_out(flash_attention_nobias_cl(q, k, v, h, hd ** -0.5))
        q, k, v = _heads(q, h) * hd ** -0.5, _heads(k, h), _heads(v, h)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = attn.softmax(dim=-1).to(v.dtype)
        return self.to_out(_merge(torch.matmul(attn, v)))


class SemanticFiLM(nn.Module):
    """Spatial FiLM: out = sigmoid(conv_g(x)) * inp + conv_b(x), 1x1 convs to
    one channel, run channels-last as matmuls."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_gama = nn.Conv2d(dim, 1, 1)
        self.conv_beta = nn.Conv2d(dim, 1, 1)

    def forward(self, x, inp):
        # x, inp: (N, H, W, C)
        gamma = torch.sigmoid(conv1x1(self.conv_gama, x))
        return gamma * inp + conv1x1(self.conv_beta, x)


class DistFiLM(nn.Module):
    """Channel FiLM from the mean and unbiased std over (T, H, W) of the
    distortion field."""

    def __init__(self, dim: int):
        super().__init__()
        self.get_gamma = nn.Linear(dim, dim)
        self.get_beta = nn.Linear(dim, dim)

    def forward(self, x, inp):
        # x: (B, T, H, W, C); inp: (B, T*H*W, C)
        gamma, beta = _channel_film(self, x)
        return gamma[:, None, :] * inp + beta[:, None, :]


def _channel_pool(x):
    """(mean, std) over every axis of ``x`` but the first and the last."""
    return avg_std_pool(x.reshape(x.shape[0], -1, x.shape[-1]), (1,))


def _channel_film(mod, x):
    """sigmoid(get_gamma(std)), get_beta(mean) of ``x``'s channels."""
    mean, std = _channel_pool(x)
    dt = mod.get_gamma.weight.dtype
    return (torch.sigmoid(mod.get_gamma(std.to(dt))),
            mod.get_beta(mean.to(dt)))


class SemanticFiLM4(nn.Module):
    """Channel FiLM: sigmoid(get_gamma(std)) * inp + get_beta(mean), the
    pools over (H, W) of x.  x, inp: (N, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.get_gamma = nn.Linear(dim, dim)
        self.get_beta = nn.Linear(dim, dim)

    def forward(self, x, inp):
        gamma, beta = _channel_film(self, x)
        return gamma[:, None, None, :] * inp + beta[:, None, None, :]


class SemanticFiLM6(SemanticFiLM):
    """:class:`SemanticFiLM`, then channel FiLM with sigmoid(get_beta(mean))
    as the gain and get_beta(std) as the shift.  x, inp: (N, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.get_beta = nn.Linear(dim, dim)

    def forward(self, x, inp):
        inp1 = super().forward(x, inp)
        mean, std = _channel_pool(x)
        dt = self.get_beta.weight.dtype
        cgamma = torch.sigmoid(self.get_beta(mean.to(dt)))
        cbeta = self.get_beta(std.to(dt))
        return cgamma[:, None, None, :] * inp1 + cbeta[:, None, None, :]


class SemanticFiLM8(SemanticFiLM):
    """A 3x3 conv (C -> C) and LeakyReLU(0.2), then :class:`SemanticFiLM`
    of its output.  x, inp: (N, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, inp):
        out = nn.functional.leaky_relu(conv_channels_last(self.conv1, x), 0.2)
        return super().forward(out, inp)


class DistFiLM5(nn.Module):
    """Token-wise FiLM: sigmoid(conv_gama(x)) * inp + conv_beta(x), 3x3x3
    convs to one channel.  x: (B, T, H, W, C); inp: (B, T*H*W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_gama = nn.Conv3d(dim, 1, 3, padding=1)
        self.conv_beta = nn.Conv3d(dim, 1, 3, padding=1)

    def forward(self, x, inp):
        B = x.shape[0]
        gamma = torch.sigmoid(conv_channels_last(self.conv_gama, x))
        beta = conv_channels_last(self.conv_beta, x)
        return gamma.reshape(B, -1, 1) * inp + beta.reshape(B, -1, 1)


class DistFiLM7(DistFiLM5):
    """:class:`DistFiLM5`, then :class:`DistFiLM`'s channel FiLM.  x:
    (B, T, H, W, C); inp: (B, T*H*W, C)."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.get_gamma = nn.Linear(dim, dim)
        self.get_beta = nn.Linear(dim, dim)

    def forward(self, x, inp):
        inp1 = super().forward(x, inp)
        gamma, beta = _channel_film(self, x)
        return gamma[:, None, :] * inp1 + beta[:, None, :]
