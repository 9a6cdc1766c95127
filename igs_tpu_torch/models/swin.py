"""GMFlow feature transformer: shifted-window single-head attention.

Counterpart of ``igs_tpu/models/swin.py`` on its XLA path: window
attention with the additive −100 shift mask, which
``F.scaled_dot_product_attention`` takes as a float mask in the query's
type (a library kernel, not one of this repo's; it runs the softmax in
float32 whatever the type of q, k and v). Tokens are channel-last
(B, H·W, C); feature maps at the public functions are NCHW.

``dtype`` (the ``ft_bf16`` flag) is the compute type of the q/k/v, merge
and MLP projections, and so of the attention; the LayerNorms and the
residual add stay float32.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from igs_tpu_torch.models.networks import Dense, LayerNorm


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0) -> np.ndarray:
    """(C, H, W) DETR-style sine positional encoding."""
    y_embed = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x_embed = np.cumsum(np.ones((h, w), np.float32), axis=1)
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2).transpose(2, 0, 1)


def split_feature(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """(B, H, W, C) → (B·K·K, H/K, W/K, C)."""
    b, h, w, c = x.shape
    k = num_splits
    x = x.reshape(b, k, h // k, k, w // k, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b * k * k, h // k, w // k, c)


def merge_splits(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """Inverse of split_feature."""
    bkk, hk, wk, c = x.shape
    k = num_splits
    b = bkk // (k * k)
    x = x.reshape(b, k, k, hk, wk, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, k * hk, k * wk, c)


@lru_cache(maxsize=16)
def shift_window_attn_mask(h: int, w: int, window_h: int, window_w: int,
                           shift_h: int, shift_w: int) -> np.ndarray:
    """(K², L, L) additive mask, −100 across the swin region boundaries."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window_h), slice(-window_h, -shift_h),
               slice(-shift_h, None)):
        for ws in (slice(0, -window_w), slice(-window_w, -shift_w),
                   slice(-shift_w, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    k = w // window_w
    m = img_mask.reshape(1, h // window_h, window_h, k, window_w, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_h * window_w)
    attn = m[:, None, :] - m[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


def window_attention(q, k, v, num_splits: int, h: int, w: int,
                     with_shift: bool = False) -> torch.Tensor:
    """Single-head split-window attention, (B, H·W, C) → (B, H·W, C)."""
    b, seq, c = q.shape
    wh, ww = h // num_splits, w // num_splits
    sh, sw = wh // 2, ww // 2
    k2 = num_splits * num_splits

    def prep(x):
        x = x.reshape(b, h, w, c)
        if with_shift:
            x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
        return split_feature(x, num_splits).reshape(b, k2, wh * ww, c)

    mask = None
    if with_shift:
        mask = torch.from_numpy(
            shift_window_attn_mask(h, w, wh, ww, sh, sw)).to(q.device,
                                                              q.dtype)
    out = F.scaled_dot_product_attention(prep(q), prep(k), prep(v),
                                         attn_mask=mask)
    out = merge_splits(out.reshape(b * k2, wh, ww, c), num_splits)
    if with_shift:
        out = torch.roll(out, shifts=(sh, sw), dims=(1, 2))
    return out.reshape(b, seq, c)


class TransformerLayer(nn.Module):
    """q/k/v proj (no bias) → window attention → merge → norm → [FFN]."""

    def __init__(self, d_model: int = 128, no_ffn: bool = False,
                 ffn_dim_expansion: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.q_proj = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.merge = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.no_ffn = no_ffn
        if not no_ffn:
            in_ch = 2 * d_model
            self.mlp = nn.Sequential(
                Dense(in_ch, in_ch * ffn_dim_expansion, bias=False,
                      dtype=dtype),
                nn.GELU(),
                Dense(in_ch * ffn_dim_expansion, d_model, bias=False,
                      dtype=dtype))
            self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, source, target, h, w, attn_num_splits=2,
                with_shift=False):
        q = self.q_proj(source)
        k = self.k_proj(target)
        v = self.v_proj(target)
        if attn_num_splits > 1:
            message = window_attention(q, k, v, attn_num_splits, h, w,
                                       with_shift=with_shift)
        else:
            message = F.scaled_dot_product_attention(q, k, v)
        message = self.norm1(self.merge(message).float())
        if not self.no_ffn:
            message = self.norm2(
                self.mlp(torch.cat([source, message], -1)).float())
        return source + message


class TransformerBlock(nn.Module):
    """self-attn (no FFN) + cross-attn+FFN."""

    def __init__(self, d_model: int = 128, ffn_dim_expansion: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, no_ffn=True,
                                          ffn_dim_expansion=ffn_dim_expansion,
                                          dtype=dtype)
        self.cross_attn_ffn = TransformerLayer(
            d_model, no_ffn=False, ffn_dim_expansion=ffn_dim_expansion,
            dtype=dtype)

    def forward(self, source, target, h, w, attn_num_splits=2,
                with_shift=False):
        source = self.self_attn(source, source, h, w, attn_num_splits,
                                with_shift)
        return self.cross_attn_ffn(source, target, h, w, attn_num_splits,
                                   with_shift)


def _tokens(f):
    b, c, h, w = f.shape
    return f.reshape(b, c, h * w).transpose(1, 2)


def _untokens(t, c, h, w):
    return t.transpose(1, 2).reshape(t.shape[0], c, h, w)


class FeatureTransformer(nn.Module):
    """Joint self/cross transformer over (feature0, feature1): both run as
    one batch, feature1 re-derived by swapping halves; shift on odd
    layers."""

    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerBlock(d_model, ffn_dim_expansion, dtype=dtype)
             for _ in range(num_layers)])

    def forward(self, feature0, feature1, attn_num_splits=2):
        b, c, h, w = feature0.shape
        f0, f1 = _tokens(feature0), _tokens(feature1)
        concat0 = torch.cat([f0, f1], 0)
        concat1 = torch.cat([f1, f0], 0)
        for i, layer in enumerate(self.layers):
            concat0 = layer(concat0, concat1, h, w, attn_num_splits,
                            with_shift=attn_num_splits > 1 and i % 2 == 1)
            half0, half1 = concat0.chunk(2, 0)
            concat1 = torch.cat([half1, half0], 0)
        f0, f1 = concat0.chunk(2, 0)
        return _untokens(f0, c, h, w), _untokens(f1, c, h, w)


class FeatureTransformerMy(nn.Module):
    """IGS's motion transformer: cross-attend f0 → f1 only."""

    def __init__(self, num_layers: int = 1, d_model: int = 128,
                 ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerBlock(d_model, ffn_dim_expansion)
             for _ in range(num_layers)])

    def forward(self, feature0, feature1, attn_num_splits=2):
        b, c, h, w = feature0.shape
        f0, f1 = _tokens(feature0), _tokens(feature1)
        for i, layer in enumerate(self.layers):
            f0 = layer(f0, f1, h, w, attn_num_splits,
                       with_shift=attn_num_splits > 1 and i % 2 == 1)
        return _untokens(f0, c, h, w)


def feature_add_position(feature0, feature1, attn_splits: int,
                         channels: int):
    """Add the sine PE inside each split window."""
    b, c, h, w = feature0.shape
    dev = feature0.device
    if attn_splits > 1:
        pos = torch.from_numpy(position_embedding_sine(
            h // attn_splits, w // attn_splits, channels // 2)).to(dev)
        pos = pos.permute(1, 2, 0)[None]  # (1, h/s, w/s, C)

        def add(f):
            fs = split_feature(f.permute(0, 2, 3, 1), attn_splits) + pos.to(
                f.dtype)
            return merge_splits(fs, attn_splits).permute(0, 3, 1, 2)

        return add(feature0), add(feature1)
    pos = torch.from_numpy(position_embedding_sine(h, w, channels // 2)).to(dev)
    return feature0 + pos.to(feature0.dtype), feature1 + pos.to(
        feature1.dtype)
