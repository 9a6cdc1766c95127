"""Transformer1D over anchor tokens (counterpart of
``igs_tpu/models/transformer1d.py``): layer norm, self-attention only,
GEGLU feed-forward, diffusers key names.

Attention is ``F.scaled_dot_product_attention`` (a library kernel): at
8192 anchor tokens the (L, L) scores of 5·8 heads would take ~10.7 GB in
float32, and its fused paths never materialize them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, head_dim: int = 64):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Identity()])

    def forward(self, x):  # (B, L, D)
        b, seq, _ = x.shape

        def split(t):
            return t.reshape(b, seq, self.heads, self.head_dim).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x)))
        out = out.transpose(1, 2).reshape(b, seq, self.heads * self.head_dim)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8, head_dim: int = 64):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    """(B, C, L) → (B, C, L) with residual."""

    def __init__(self, in_channels: int = 128, num_attention_heads: int = 8,
                 attention_head_dim: int = 64, num_layers: int = 4,
                 norm_num_groups: int = 32):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_attention_heads,
                                   attention_head_dim)
             for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(self.norm(x).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h)
        return self.proj_out(h).transpose(1, 2) + x
