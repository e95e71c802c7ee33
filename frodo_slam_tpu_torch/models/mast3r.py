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

import copy
import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..utils import spans
from ..utils.device import resolve_device
from . import dpt as dpt_mod
from .layers import (Block, DecoderBlock, LayerNorm, Mlp, PatchEmbed, layernorm, linear, split_attention,
                     split_cross_attention, split_mlp, xavier_)


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


def _copy_to(mod: nn.Module, device) -> nn.Module:
    """A copy of ``mod`` on ``device`` that shares no storage with it."""
    return copy.deepcopy(mod).to(device)


def _rebuild(mod: nn.Module, devices, split: dict) -> nn.Module:
    """A new module of ``mod``'s class whose children named in ``split`` are
    ``split[name](child, devices)`` and whose other children are copies on
    ``devices[0]``."""
    out = type(mod).__new__(type(mod))
    nn.Module.__init__(out)
    out.training = mod.training
    for name, child in mod.named_children():
        setattr(out, name, split[name](child, devices) if name in split else _copy_to(child, devices[0]))
    return out


class BackendReplica(nn.Module):
    """The decoder and both heads of ``model`` for one dp rank of the
    backend, on ``devices`` (the rank's tp devices): the layers the JAX
    package splits over its ``tp`` axis (parallel/mesh.py ``_pspec_for_path``:
    attention and cross-attention heads, the MLPs' hidden features, the
    heads' cat-MLP) split over ``devices`` by :class:`~.layers.TensorParallel`,
    the rest copied whole onto ``devices[0]``. No encoder: the backend
    decodes stored features. It has the attributes :func:`decode` and
    :func:`decode_and_heads` read, so it takes ``model``'s place there;
    inputs go on :attr:`device`, outputs come back there. It shares no
    parameter storage with ``model``."""

    def __init__(self, model: MASt3R, devices):
        super().__init__()
        self.cfg = model.cfg
        self.devices = tuple(devices)
        first = self.devices[0]
        block_split = {"attn": split_attention, "cross_attn": split_cross_attention, "mlp": split_mlp}
        self.decoder_embed = _copy_to(model.decoder_embed, first)
        for name in ("dec_blocks", "dec_blocks2"):
            setattr(self, name, nn.ModuleList(_rebuild(b, self.devices, block_split)
                                              for b in getattr(model, name)))
        self.dec_norm = _copy_to(model.dec_norm, first)
        for name in ("downstream_head1", "downstream_head2"):
            setattr(self, name, _rebuild(getattr(model, name), self.devices,
                                         {"head_local_features": split_mlp}))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.devices[0]


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
    with spans.span("model.encode"):
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
    h, w = img_hw
    if portrait:
        h, w = w, h
    grid = (h // cfg.patch_size, w // cfg.patch_size)
    with spans.span("model.decode"):
        hooks1, hooks2 = decode(model, f1, pos1, f2, pos2)
        res1 = _head(model.downstream_head1, cfg, hooks1, grid)
        res2 = _head(model.downstream_head2, cfg, hooks2, grid)
        if portrait:
            res1, res2 = _transpose_res(res1), _transpose_res(res2)
        return res1, res2



# ---------------------------------------------------------------------------
# model FLOP count
# ---------------------------------------------------------------------------

def _attention_block_flops(n_q: int, n_kv: int, dim: int, cross: bool) -> int:
    """One attention sublayer: the q, k, v and output projections and the
    two products with the attention matrix (2 a multiply-add)."""
    proj = 2 * n_q * dim * dim * 2 + 2 * n_kv * dim * dim * 2 if cross else 2 * n_q * dim * 4 * dim
    return proj + 2 * 2 * n_q * n_kv * dim


def _mlp_flops(n: int, d_in: int, d_hidden: int, d_out: int) -> int:
    return 2 * n * d_hidden * (d_in + d_out)


def _conv_flops(h: int, w: int, c_in: int, c_out: int, k: int = 1, stride: int = 1) -> int:
    """A k x k convolution, padding k // 2, over an ``h x w`` input. Only the
    kernel taps that land inside the input count: padding is no work."""
    def taps(n):  # along one axis, summed over the output positions
        n_out = (n + 2 * (k // 2) - k) // stride + 1
        return sum(1 for i in range(n_out) for t in range(k) if 0 <= stride * i - k // 2 + t < n)

    return 2 * taps(h) * taps(w) * c_in * c_out


def _dpt_flops(cfg: MASt3RConfig, gh: int, gw: int) -> int:
    """One DPT head (DPTOutputAdapter_fix, dust3r/heads/dpt_head.py:34-66)
    on a (gh, gw) token grid: the act_postprocess pyramid, the layer_rn
    projections, the four refinenet fusions (two residual units each, one
    without the skip input) and the regression head at full resolution."""
    L, F = cfg.dpt_layer_dims, cfg.dpt_feature_dim
    dims = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
    h4, w4 = (gh - 1) // 2 + 1, (gw - 1) // 2 + 1  # the 3x3 stride-2 conv of act4
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (h4, w4)]
    f = (_conv_flops(gh, gw, dims[0], L[0]) + 2 * gh * gw * L[0] * 16 * L[0]  # 1x1, 4x4 stride-4 deconv
         + _conv_flops(gh, gw, dims[1], L[1]) + 2 * gh * gw * L[1] * 4 * L[1]  # 1x1, 2x2 stride-2 deconv
         + _conv_flops(gh, gw, dims[2], L[2])
         + _conv_flops(gh, gw, dims[3], L[3]) + _conv_flops(gh, gw, L[3], L[3], 3, stride=2))
    f += sum(_conv_flops(h, w, L[i], F, 3) for i, (h, w) in enumerate(sizes))
    rcu = lambda h, w: 2 * _conv_flops(h, w, F, F, 3)  # noqa: E731  one residual conv unit
    for i, (h, w) in enumerate(sizes):  # refinenet i fuses at layer i's size, upsamples 2x
        f += rcu(h, w) * (1 if i == 3 else 2) + _conv_flops(2 * h, 2 * w, F, F)
    h1, w1 = 2 * sizes[0][0], 2 * sizes[0][1]
    return (f + _conv_flops(h1, w1, F, F // 2, 3) + _conv_flops(2 * h1, 2 * w1, F // 2, cfg.dpt_last_dim, 3)
            + _conv_flops(2 * h1, 2 * w1, cfg.dpt_last_dim, 4))


def model_flops(cfg: MASt3RConfig, img_hw) -> Dict[str, int]:
    """Floating-point operations of one tracked frame's model work, counted
    from the config's widths and the token count: :func:`encode_image` of
    one image and :func:`decode_and_heads` of one pair (both decoders, both
    heads). Every matrix product and convolution counts 2 a multiply-add,
    every layer of every stack and the attention products included;
    elementwise work (norms, activations, softmax, RoPE, resizes) is not
    counted. Keys: ``encode``, ``decoder``, ``dpt``, ``local_features``
    (both views each) and ``total``."""
    gh, gw = img_hw[0] // cfg.patch_size, img_hw[1] // cfg.patch_size
    n, de, dd = gh * gw, cfg.enc_embed_dim, cfg.dec_embed_dim
    patch = 2 * n * 3 * cfg.patch_size ** 2 * de
    enc_block = _attention_block_flops(n, n, de, False) + _mlp_flops(n, de, int(cfg.mlp_ratio * de), de)
    dec_block = (_attention_block_flops(n, n, dd, False) + _attention_block_flops(n, n, dd, True)
                 + _mlp_flops(n, dd, int(cfg.mlp_ratio * dd), dd))
    idim = de + dd
    local = _mlp_flops(n, idim, 4 * idim, (cfg.local_feat_dim + int(cfg.two_confs)) * cfg.patch_size ** 2)
    out = {
        "encode": patch + cfg.enc_depth * enc_block,
        "decoder": 2 * (2 * n * de * dd + cfg.dec_depth * dec_block),
        "dpt": 2 * _dpt_flops(cfg, gh, gw),
        "local_features": 2 * local,
    }
    out["total"] = sum(out.values())
    return out
