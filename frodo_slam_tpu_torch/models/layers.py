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
from ..ops.rope_kernel import rope2d_, rope2d_plain


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
# The tables depend on the token grid only, so a forward builds them once
# and every attention rotates its q and k with one rope2d_ call.
# ---------------------------------------------------------------------------

def _rope_cos_sin(pos1d: torch.Tensor, half_dim: int, base: float, dtype):
    inv_freq = 1.0 / (base ** (torch.arange(0, half_dim, 2, dtype=torch.float32,
                                            device=pos1d.device) / half_dim))
    freqs = pos1d.float()[..., None] * inv_freq  # (..., N, half_dim/2)
    freqs = torch.cat([freqs, freqs], dim=-1)  # (..., N, half_dim)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def rope_tables(pos: torch.Tensor, head_dim: int, base: float, dtype) -> torch.Tensor:
    """``pos``: (B, N, 2) int (y, x) -> (B, N, 4, head_dim/2) in ``dtype``:
    cos_y, sin_y, cos_x, sin_x, one tensor so that :class:`TensorParallel`
    moves it like any other argument."""
    half = head_dim // 2
    cos_y, sin_y = _rope_cos_sin(pos[..., 0], half, base, dtype)
    cos_x, sin_x = _rope_cos_sin(pos[..., 1], half, base, dtype)
    return torch.stack([cos_y, sin_y, cos_x, sin_x], dim=-2)


def apply_rope2d(tokens: torch.Tensor, pos: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """The plain reference: ``tokens`` (B, heads, N, head_dim); ``pos``:
    (B, N, 2) int (y, x)."""
    return rope2d_plain(tokens, rope_tables(pos, tokens.shape[-1], base, tokens.dtype))


def _sdpa(q, k, v):
    """q, k, v: (B, heads, N, hd) -> (B, N, heads*hd). One function for
    both of the JAX package's ``attention_impl`` values ("xla" and
    "pallas"), at any N (JAX's pallas path needs N % 128 blocks)."""
    b, h, n, hd = q.shape
    return flash_attention(q, k, v).transpose(1, 2).reshape(b, n, h * hd)


class Attention(nn.Module):
    """Self-attention with RoPE2D (blocks.py:92-135). ``head_dim`` is the
    model's (dim // num_heads) unless given: a tensor-parallel shard holds
    fewer heads of the same width. The forward takes the tokens' RoPE table
    (:func:`rope_tables`; None without RoPE) and rotates q and k in place,
    as views into the qkv projection's output."""

    def __init__(self, dim: int, num_heads: int, rope_base: float | None, head_dim: int | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads if head_dim is None else head_dim
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, 3 * num_heads * self.head_dim)
        self.proj = nn.Linear(num_heads * self.head_dim, dim)

    def forward(self, x, rope):
        b, n, _ = x.shape
        qkv = linear(self.qkv, x).reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if self.rope_base is not None:
            rope2d_(q, k, rope, rope)
        return linear(self.proj, _sdpa(q, k, v))


class CrossAttention(nn.Module):
    """Cross-attention with RoPE2D (blocks.py:158-215); ``head_dim`` and the
    RoPE tables as in :class:`Attention`, q rotated by the query tokens'
    table, k by the key tokens'."""

    def __init__(self, dim: int, num_heads: int, rope_base: float | None, head_dim: int | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads if head_dim is None else head_dim
        self.rope_base = rope_base
        inner = num_heads * self.head_dim
        self.projq = nn.Linear(dim, inner)
        self.projk = nn.Linear(dim, inner)
        self.projv = nn.Linear(dim, inner)
        self.proj = nn.Linear(inner, dim)

    def forward(self, query, key, value, qrope, krope):
        b, nq, _ = query.shape
        hd = self.head_dim
        q = linear(self.projq, query).reshape(b, nq, self.num_heads, hd).transpose(1, 2)
        k = linear(self.projk, key).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        v = linear(self.projv, value).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        if self.rope_base is not None:
            rope2d_(q, k, qrope, krope)
        return linear(self.proj, _sdpa(q, k, v))


class Block(nn.Module):
    """Encoder block (blocks.py:137-156)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, rope_base: float | None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, rope_base)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, rope):
        x = x + self.attn(layernorm(self.norm1, x), rope)
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

    def forward(self, x, y, xrope, yrope):
        x = x + self.attn(layernorm(self.norm1, x), xrope)
        y_ = layernorm(self.norm_y, y)
        x = x + self.cross_attn(layernorm(self.norm2, x), y_, y_, xrope, yrope)
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


# ---------------------------------------------------------------------------
# tensor parallelism (the JAX package's tp layout, parallel/mesh.py:60-80):
# q/k/v and fc1 split by output features, the output projections and fc2 by
# input features, everything else whole on the first device
# ---------------------------------------------------------------------------

def copy_param(t: torch.Tensor, device) -> nn.Parameter:
    """A contiguous copy of ``t`` on ``device`` (never a view of it)."""
    return nn.Parameter(t.detach().to(device, copy=True, memory_format=torch.contiguous_format),
                        requires_grad=False)


def _shard_linear(lin: nn.Linear, src: nn.Linear, device, rows=None, cols=None):
    """Fill ``lin`` (built on the meta device) with the output features
    ``rows`` or the input features ``cols`` of ``src``, on ``device``; a
    shard of input features has no bias (:class:`TensorParallel` adds it)."""
    if rows is not None:
        lin.weight = copy_param(src.weight[rows], device)
        lin.bias = copy_param(src.bias[rows], device)
    else:
        lin.weight = copy_param(src.weight[:, cols], device)
        lin.bias = None
    return lin


class TensorParallel(nn.Module):
    """One layer (:class:`Attention`, :class:`CrossAttention` or
    :class:`Mlp`) split over ``devices``: shard r, on ``devices[r]``, holds
    its share of the heads or hidden features and its rows of the output
    projection, without bias. The forward hands each shard its inputs on its
    device, moves the partial outputs to the first device, adds them there
    in shard order in f32 and adds the bias once after the sum, so the
    result does not depend on which shard finishes first."""

    def __init__(self, shards, bias: torch.Tensor, devices):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.bias = copy_param(bias, devices[0])
        self.devices = tuple(devices)

    def forward(self, *args):
        dtype = args[0].dtype
        parts = [s(*(None if a is None else a.to(d) for a in args))
                 for s, d in zip(self.shards, self.devices)]
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.to(self.devices[0]).float()
        return (acc + self.bias.to(dtype).float()).to(dtype)


def _tp(n: int, devices, what: str) -> int:
    tp = len(devices)
    if n % tp:
        raise ValueError(f"tensor parallel: {n} {what} do not split over {tp} devices")
    return n // tp


def split_attention(attn: Attention, devices) -> TensorParallel:
    """Shard r takes heads [r H/tp, (r+1) H/tp) of each of q, k and v (a
    contiguous cut of the 3 * dim rows of ``qkv`` would hand rank 0 all of q
    and half of k) and the matching input columns of ``proj``."""
    hs = _tp(attn.num_heads, devices, "heads")
    hd, dim = attn.head_dim, attn.proj.out_features
    inner = attn.num_heads * hd
    shards = []
    for r, d in enumerate(devices):
        cut = slice(r * hs * hd, (r + 1) * hs * hd)
        rows = torch.cat([torch.arange(inner, device=attn.qkv.weight.device)[cut] + i * inner
                          for i in range(3)])
        with torch.device("meta"):
            s = Attention(dim, hs, attn.rope_base, head_dim=hd)
        _shard_linear(s.qkv, attn.qkv, d, rows=rows)
        _shard_linear(s.proj, attn.proj, d, cols=cut)
        shards.append(s)
    return TensorParallel(shards, attn.proj.bias, devices)


def split_cross_attention(attn: CrossAttention, devices) -> TensorParallel:
    """Shard r takes heads [r H/tp, (r+1) H/tp) of q, k and v and the
    matching input columns of ``proj``."""
    hs = _tp(attn.num_heads, devices, "heads")
    hd, dim = attn.head_dim, attn.proj.out_features
    shards = []
    for r, d in enumerate(devices):
        cut = slice(r * hs * hd, (r + 1) * hs * hd)
        with torch.device("meta"):
            s = CrossAttention(dim, hs, attn.rope_base, head_dim=hd)
        for name in ("projq", "projk", "projv"):
            _shard_linear(getattr(s, name), getattr(attn, name), d, rows=cut)
        _shard_linear(s.proj, attn.proj, d, cols=cut)
        shards.append(s)
    return TensorParallel(shards, attn.proj.bias, devices)


def split_mlp(mlp: Mlp, devices) -> TensorParallel:
    """Shard r takes hidden features [r F/tp, (r+1) F/tp): those rows of
    ``fc1`` and those input columns of ``fc2``."""
    hidden = mlp.fc1.out_features
    f = _tp(hidden, devices, "hidden features")
    shards = []
    for r, d in enumerate(devices):
        cut = slice(r * f, (r + 1) * f)
        with torch.device("meta"):
            s = Mlp(mlp.fc1.in_features, f, mlp.fc2.out_features)
        _shard_linear(s.fc1, mlp.fc1, d, rows=cut)
        _shard_linear(s.fc2, mlp.fc2, d, cols=cut)
        shards.append(s)
    return TensorParallel(shards, mlp.fc2.bias, devices)
