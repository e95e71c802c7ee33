"""The MASt3R two-view pointmap network as a PyTorch module.

Architecture of record (the published
``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric`` checkpoint,
``mast3r/model.py:21-37`` / ``dust3r/dust3r/model.py:46-210`` /
``croco/models/croco.py:21-112``):

- shared ViT-L encoder: patch 16, dim 1024, depth 24, heads 16, RoPE base 100
- two decoders (``dec_blocks``, ``dec_blocks2``): dim 768, depth 12, heads 12,
  cross-attending to the other view each layer
- per-view DPT head (hooks [0, 6, 9, 12]) for pts3d+conf and a cat-MLP
  pixel-shuffle head for 24-dim local descriptors + desc confidence
- postprocess: pts3d = unit(xyz) * expm1(|xyz|), conf = 1 + exp, desc
  L2-normalized, desc_conf = exp

Functional API over the module (the JAX package's ``params, cfg`` pair is the
module, which carries its config):
    encode_image(model, img)                     -> feat (B,N,1024) f32, pos (B,N,2)
    decode(model, f1, p1, f2, p2)                -> hook token lists per view
    decode_and_heads(model, f1, p1, f2, p2, hw)  -> (res1, res2) dicts

The encoder/decoder run in ``cfg.dtype`` (bf16 by default) with their
weights cast once (:meth:`MASt3R.cast_transformer_`); heads run in
``cfg.head_dtype`` (f32, the reference contract).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..utils.device import resolve_device
from . import dpt as dpt_mod
from .layers import Block, DecoderBlock, LayerNorm, Mlp, PatchEmbed, layernorm, linear, xavier_


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    local_feat_dim: int = 24
    two_confs: bool = True
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, ...] = (96, 192, 384, 768)
    dtype: torch.dtype = torch.bfloat16  # encoder/decoder compute dtype
    head_dtype: torch.dtype = torch.float32  # heads: f32 is the reference contract
    # the JAX package's "xla" | "pallas": both compute the one attention
    # function that the port's kernel computes at any N (layers._sdpa)
    attention_impl: str = "xla"
    # portrait inputs (true height > width) are stored transposed into
    # landscape layout and flagged here; the patch embed / heads transpose
    # in and out (ManyAR_PatchEmbed + transpose_to_landscape)
    portrait: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"attention_impl {self.attention_impl!r} is not 'xla' or 'pallas'")

    @property
    def hooks(self) -> Tuple[int, int, int, int]:
        l2 = self.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)

    @property
    def dpt_last_dim(self) -> int:
        return self.dpt_feature_dim // 2


def tiny_config(**kw) -> MASt3RConfig:
    """Small config for CPU tests; dec_depth stays 12 (head hooks require >9,
    catmlp_dpt_head.py:108). Same widths as the JAX package's tiny_config."""
    kw.setdefault("enc_embed_dim", 64)
    kw.setdefault("enc_depth", 2)
    kw.setdefault("enc_num_heads", 2)
    kw.setdefault("dec_embed_dim", 48)
    kw.setdefault("dec_depth", 12)
    kw.setdefault("dec_num_heads", 2)
    kw.setdefault("dtype", torch.float32)
    return MASt3RConfig(**kw)


class _Head(nn.Module):
    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        dim_tokens = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
        self.dpt = dpt_mod.DPTOutputAdapter(dim_tokens, cfg.dpt_layer_dims, cfg.dpt_feature_dim,
                                            cfg.dpt_last_dim, num_channels=4)
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        out = (cfg.local_feat_dim + int(cfg.two_confs)) * cfg.patch_size ** 2
        self.head_local_features = Mlp(idim, 4 * idim, out)


class MASt3R(nn.Module):
    """Parameter names follow the reference ``AsymmetricMASt3R`` state dict."""

    _TRANSFORMER = ("patch_embed", "enc_blocks", "decoder_embed", "dec_blocks", "dec_blocks2")

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = cfg
        r = cfg.rope_base
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, cfg.enc_embed_dim)
        self.enc_blocks = nn.ModuleList(
            [Block(cfg.enc_embed_dim, cfg.enc_num_heads, cfg.mlp_ratio, r) for _ in range(cfg.enc_depth)])
        self.enc_norm = LayerNorm(cfg.enc_embed_dim)
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, cfg.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads, cfg.mlp_ratio, r) for _ in range(cfg.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads, cfg.mlp_ratio, r) for _ in range(cfg.dec_depth)])
        self.dec_norm = LayerNorm(cfg.dec_embed_dim)
        self.downstream_head1 = _Head(cfg)
        self.downstream_head2 = _Head(cfg)

    @torch.no_grad()
    def init_weights_(self, gen: torch.Generator) -> "MASt3R":
        """Random init from ``gen`` with the JAX package's distributions:
        xavier-uniform linears (CroCoNet._init_weights), normal convs scaled
        by 1/sqrt(fan_in), zero biases, unit layernorms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                xavier_(mod.weight, mod.in_features, mod.out_features, gen)
            elif isinstance(mod, nn.ConvTranspose2d):
                mod.weight.normal_(generator=gen).mul_(mod.weight.shape[0] ** -0.5)
            elif isinstance(mod, nn.Conv2d):
                o, i, kh, kw = mod.weight.shape
                if mod is self.patch_embed.proj:
                    xavier_(mod.weight, i * kh * kw, o, gen)
                else:
                    mod.weight.normal_(generator=gen).mul_((kh * kw * i) ** -0.5)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
                continue
            else:
                continue
            if mod.bias is not None:
                mod.bias.zero_()
        return self

    def cast_transformer_(self, dtype=None) -> "MASt3R":
        """Cast the encoder/decoder weights to the compute dtype ONCE (the
        JAX package's cast_transformer_params); norms stay f32-computed,
        heads keep their own dtype."""
        dtype = self.cfg.dtype if dtype is None else dtype
        for name in self._TRANSFORMER:
            getattr(self, name).to(dtype)
        return self


def init_model(cfg: MASt3RConfig, seed: int = 0, device=None) -> MASt3R:
    """A random-weight model on ``device`` (the card unless the caller asks
    for the CPU) from a seeded generator, with the transformer cast to
    ``cfg.dtype``."""
    device = resolve_device(device)
    with torch.device(device):
        model = MASt3R(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights_(gen).cast_transformer_().eval()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode_image(model: MASt3R, img: torch.Tensor, portrait=None):
    """``img``: (B, H, W, 3) ImgNorm'd, stored landscape (W >= H). Returns
    f32 feat (B, N, D), pos (B, N, 2) int32 (y, x) (dust3r/model.py:127-139).
    ``portrait=True``: the image is transposed back before the patch embed,
    so tokens come out in portrait raster order (ManyAR_PatchEmbed)."""
    cfg = model.cfg
    portrait = cfg.portrait if portrait is None else portrait
    if portrait:
        img = img.transpose(1, 2)
    x, pos = model.patch_embed(img.to(cfg.dtype))
    pos = pos.to(torch.int32)
    for blk in model.enc_blocks:
        x = blk(x, pos)
    x = layernorm(model.enc_norm, x)
    return x.float(), pos


@torch.no_grad()
def decode(model: MASt3R, f1, pos1, f2, pos2):
    """Cross-attending twin decoders (dust3r/model.py:171-190), run as two
    plain passes per layer. Returns (hooks1, hooks2): per view the 4 hook
    activations [enc_out, dec_{l/2}, dec_{3l/4}, dec_norm(dec_l)] in f32."""
    cfg = model.cfg
    x1 = linear(model.decoder_embed, f1.to(cfg.dtype))
    x2 = linear(model.decoder_embed, f2.to(cfg.dtype))
    ys1: List[torch.Tensor] = []
    ys2: List[torch.Tensor] = []
    for b1, b2 in zip(model.dec_blocks, model.dec_blocks2):
        # each stream cross-attends to the other's previous layer output
        x1, x2 = b1(x1, x2, pos1, pos2), b2(x2, x1, pos2, pos1)
        ys1.append(x1)
        ys2.append(x2)
    h1, h2, h3 = cfg.hooks[1] - 1, cfg.hooks[2] - 1, cfg.hooks[3] - 1
    hooks1 = [f1, ys1[h1].float(), ys1[h2].float(), layernorm(model.dec_norm, ys1[h3]).float()]
    hooks2 = [f2, ys2[h1].float(), ys2[h2].float(), layernorm(model.dec_norm, ys2[h3]).float()]
    return hooks1, hooks2


def _transpose_res(res: Dict) -> Dict:
    """Swap the spatial axes of every head output map (dust3r's
    ``transposed()``), back to the landscape storage layout."""
    return {k: v.transpose(1, 2) for k, v in res.items()}


def _head(head: _Head, cfg: MASt3RConfig, hooks, grid):
    hooks = [t.to(cfg.head_dtype) for t in hooks]
    pts_conf = head.dpt(hooks, grid)  # (B, H, W, 4)
    local = dpt_mod.catmlp_apply(head.head_local_features, hooks[0], hooks[3], grid,
                                 cfg.patch_size, cfg.local_feat_dim, cfg.two_confs)
    return dpt_mod.postprocess(torch.cat([pts_conf, local], dim=-1).float(), cfg.local_feat_dim)


@torch.no_grad()
def decode_and_heads(model: MASt3R, f1, pos1, f2, pos2, img_hw, portrait=None):
    """One decoder pass + both heads — the reference's ``decoder()``
    (mast3r_utils.py:56-72). Returns (res1, res2) dicts of (B, h, w, ·)
    maps in the landscape storage layout ``img_hw``."""
    cfg = model.cfg
    portrait = cfg.portrait if portrait is None else portrait
    hooks1, hooks2 = decode(model, f1, pos1, f2, pos2)
    h, w = img_hw
    if portrait:
        h, w = w, h
    grid = (h // cfg.patch_size, w // cfg.patch_size)
    res1 = _head(model.downstream_head1, cfg, hooks1, grid)
    res2 = _head(model.downstream_head2, cfg, hooks2, grid)
    if portrait:
        res1, res2 = _transpose_res(res1), _transpose_res(res2)
    return res1, res2

