"""Transformer building blocks for the MASt3R two-view network.

Behavioral spec: ``croco/models/blocks.py`` (Attention/CrossAttention/Block/
DecoderBlock/Mlp/PatchEmbed) and the RoPE2D fallback in
``croco/models/pos_embed.py:112-159``. Module and parameter names follow the
reference state dict (``enc_blocks.{i}.attn.qkv.weight``, ...), so a
checkpoint loads with ``load_state_dict``.

Numerics follow the JAX package: a linear casts its weight to the activation
dtype (bf16 transformer by default), layernorms compute in f32 and cast
back, GELU is exact. Every attention goes through
:func:`~frodo_slam_tpu_torch.ops.attention_kernel.flash_attention` (the
Hopper kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_kernel import flash_attention


# ---------------------------------------------------------------------------
# init helpers (xavier-uniform to mirror CroCoNet._init_weights)
# ---------------------------------------------------------------------------

def xavier_(w: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=gen)


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` with the weight cast to the activation dtype."""
    b = mod.bias.to(x.dtype) if mod.bias is not None else None
    return F.linear(x, mod.weight.to(x.dtype), b)


def layernorm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(),
                     mod.bias.float(), mod.eps)
    return y.to(x.dtype)


def LayerNorm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (blocks.py:66-90)."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden)
        self.fc2 = nn.Linear(d_hidden, d_in if d_out is None else d_out)

    def forward(self, x):
        return linear(self.fc2, F.gelu(linear(self.fc1, x), approximate="none"))


# ---------------------------------------------------------------------------
# RoPE2D (pos_embed.py:112-159): head dim split in half; first half rotated
# by y position, second half by x position; freqs laid out as cat(f, f).
# ---------------------------------------------------------------------------

def _rope_cos_sin(pos1d: torch.Tensor, half_dim: int, base: float, dtype):
    inv_freq = 1.0 / (base ** (torch.arange(0, half_dim, 2, dtype=torch.float32,
                                            device=pos1d.device) / half_dim))
    freqs = pos1d.float()[..., None] * inv_freq  # (..., N, half_dim/2)
    freqs = torch.cat([freqs, freqs], dim=-1)  # (..., N, half_dim)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope2d(tokens: torch.Tensor, pos: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """``tokens``: (B, heads, N, head_dim); ``pos``: (B, N, 2) int (y, x)."""
    half = tokens.shape[-1] // 2
    y_tok, x_tok = tokens[..., :half], tokens[..., half:]
    cos_y, sin_y = _rope_cos_sin(pos[..., 0], half, base, tokens.dtype)
    cos_x, sin_x = _rope_cos_sin(pos[..., 1], half, base, tokens.dtype)
    cos_y, sin_y, cos_x, sin_x = (t[:, None] for t in (cos_y, sin_y, cos_x, sin_x))
    y_tok = y_tok * cos_y + _rotate_half(y_tok) * sin_y
    x_tok = x_tok * cos_x + _rotate_half(x_tok) * sin_x
    return torch.cat([y_tok, x_tok], dim=-1)


def _sdpa(q, k, v):
    """q, k, v: (B, heads, N, hd) -> (B, N, heads*hd). One function for
    both of the JAX package's ``attention_impl`` values ("xla" and
    "pallas"), at any N (JAX's pallas path needs N % 128 blocks)."""
    b, h, n, hd = q.shape
    return flash_attention(q, k, v).transpose(1, 2).reshape(b, n, h * hd)


class Attention(nn.Module):
    """Self-attention with RoPE2D (blocks.py:92-135)."""

    def __init__(self, dim: int, num_heads: int, rope_base: float | None):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = linear(self.qkv, x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if self.rope_base is not None:
            q = apply_rope2d(q, xpos, self.rope_base)
            k = apply_rope2d(k, xpos, self.rope_base)
        return linear(self.proj, _sdpa(q, k, v))


class CrossAttention(nn.Module):
    """Cross-attention with RoPE2D (blocks.py:158-215)."""

    def __init__(self, dim: int, num_heads: int, rope_base: float | None):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, qpos, kpos):
        b, nq, c = query.shape
        hd = c // self.num_heads
        q = linear(self.projq, query).reshape(b, nq, self.num_heads, hd).transpose(1, 2)
        k = linear(self.projk, key).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        v = linear(self.projv, value).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        if self.rope_base is not None:
            q = apply_rope2d(q, qpos, self.rope_base)
            k = apply_rope2d(k, kpos, self.rope_base)
        return linear(self.proj, _sdpa(q, k, v))


class Block(nn.Module):
    """Encoder block (blocks.py:137-156)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, rope_base: float | None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, xpos):
        x = x + self.attn(layernorm(self.norm1, x), xpos)
        return x + self.mlp(layernorm(self.norm2, x))


class DecoderBlock(nn.Module):
    """Decoder block: self-attn, cross-attn to the other view, MLP
    (blocks.py:217-231); returns the updated x (y passes through)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, rope_base: float | None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm_y = LayerNorm(dim)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(layernorm(self.norm1, x), xpos)
        y_ = layernorm(self.norm_y, y)
        x = x + self.cross_attn(layernorm(self.norm2, x), y_, y_, xpos, ypos)
        return x + self.mlp(layernorm(self.norm3, x))


class PatchEmbed(nn.Module):
    """Stride == kernel conv as reshape + one matmul (PatchEmbedDust3R)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, img: torch.Tensor):
        """``img``: (B, H, W, 3) -> tokens (B, N, D), pos (B, N, 2) (y, x)."""
        b, h, w, c = img.shape
        k = self.patch_size
        gh, gw = h // k, w // k
        x = img.reshape(b, gh, k, gw, k, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, k * k * c)
        kernel = self.proj.weight.to(x.dtype).permute(2, 3, 1, 0).reshape(k * k * c, -1)
        tokens = x @ kernel + self.proj.bias.to(x.dtype)
        yy, xx = torch.meshgrid(torch.arange(gh, device=img.device),
                                torch.arange(gw, device=img.device), indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, gh * gw, 2).expand(b, gh * gw, 2)
        return tokens, pos
