"""CDM — the semantic/distortion modulation blocks of KSVQE (counterpart of
kvq_tpu/nn/cdm.py; reference KSVQE_model.py).

  - :class:`CrossAttention`    == crossattention1 (:1553-1591): q from x,
    k/v from tokens, NO output projection, scale 1/sqrt(C) over the FULL
    model dim (reference quirk, kept);
  - :class:`TemporalAttention` == Attention (:1508-1551): qkv linear without
    bias, per-head scale, output projection;
  - :class:`SemanticFiLM`      == Semantic_Transformation2 (:817-835);
  - :class:`DistFiLM`          == Dist_Transformation3 (:934-960).

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
from .layers import conv1x1


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
        B, C = x.shape[0], x.shape[-1]
        xf = x.reshape(B, -1, C).float()
        n = xf.shape[1]
        mean = xf.mean(dim=1)
        var = xf.var(dim=1, unbiased=False) * (n / max(n - 1, 1))
        std = torch.sqrt(var + 1e-10)
        dt = self.get_gamma.weight.dtype
        gamma = torch.sigmoid(self.get_gamma(std.to(dt)))
        beta = self.get_beta(mean.to(dt))
        return gamma[:, None, :] * inp + beta[:, None, :]
