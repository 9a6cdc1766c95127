"""Transformer1D over anchor tokens (counterpart of
``igs_tpu/models/transformer1d.py``): layer norm, self-attention only,
GEGLU feed-forward, diffusers key names.

Attention is ``F.scaled_dot_product_attention`` (a library kernel): at
8192 anchor tokens the (L, L) scores of 5·8 heads would take ~10.7 GB in
float32, and its fused paths never materialize them.

``dtype`` (the ``encoder_bf16`` flag) is the compute type of the attention
and the feed-forward: each casts its input to it and its output back to
the input's type; the scores accumulate and the softmax runs in float32.
The norms, ``proj_in``, ``proj_out`` and the residual adds keep the
input's type.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from igs_tpu_torch.models.networks import Dense, GroupNorm, LayerNorm


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, head_dim: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(inner, dim, dtype=dtype),
                                     nn.Identity()])

    def forward(self, x):  # (B, L, D)
        b, seq, _ = x.shape
        in_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)

        def split(t):
            return t.reshape(b, seq, self.heads, self.head_dim).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x)))
        out = out.transpose(1, 2).reshape(b, seq, self.heads * self.head_dim)
        return self.to_out[0](out).to(in_dtype)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Dense(dim, inner * 2, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult, dtype=dtype), nn.Identity(),
             Dense(dim * mult, dim, dtype=dtype)])

    def forward(self, x):
        in_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        for m in self.net:
            x = m(x)
        return x.to(in_dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8, head_dim: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    """(B, C, L) → (B, C, L) with residual."""

    def __init__(self, in_channels: int = 128, num_attention_heads: int = 8,
                 attention_head_dim: int = 64, num_layers: int = 4,
                 norm_num_groups: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = Dense(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_attention_heads,
                                   attention_head_dim, dtype=dtype)
             for _ in range(num_layers)])
        self.proj_out = Dense(inner, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(self.norm(x).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h)
        return self.proj_out(h).transpose(1, 2) + x
