"""Seeded random weights for a MASt3R configuration, made by the benchmark.

The parameter names are the reference ``AsymmetricMASt3R`` state dict's
(the program's module and the plain reference both read them). Every
parameter is listed from the widths of a configuration file's ``model``
section. Weights are drawn on the device from one generator seeded with the
run's seed, in a few large calls: one normal draw over a flat buffer of the
type each group is served in (the transformer in ``dtype``, the norms after
it and the heads in ``head_dtype``), then each leaf scaled in place: a
linear's weight to Xavier's variance, a convolution's to 1 / fan-in, the
transposed convolutions' to 1 / its input channels, biases 0 and norms 1;
the DPT head's last convolution, which gives the pointmap's direction and
log-distance and the confidence logit, a tenth of that (``OUT_SCALE``), and
its z output the bias ``Z_BIAS``, so that the points lie in front of the
camera at a room's distances (about 2 to 7), as a trained head puts them.
At the full scale and no bias the logits reach 10 and more (distances 1e5,
confidences 1e6) and on some images most points lie behind the camera:
the calibrated tracker then loses every frame of the session.
The second decoder and head are copies of the first: with random weights
two independent decoders never agree across views, so no frame would track
(the program's ``FRODO_RANDOM_SHARE_DECODER``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, kind, group); kind: lin (fan_in, fan_out) | conv fan_in |
# convT in_ch | bias | ln_w | ln_b; group: transformer | f32 | head
Spec = Tuple[str, Tuple[int, ...], tuple, str]
OUT_SCALE = 0.1  # the DPT head's last convolution (see above)
Z_BIAS = 1.5  # its z output's bias


def _linear(name, d_in, d_out, group) -> List[Spec]:
    return [(f"{name}.weight", (d_out, d_in), ("lin", d_in, d_out), group),
            (f"{name}.bias", (d_out,), ("bias",), group)]


def _ln(name, d, group) -> List[Spec]:
    return [(f"{name}.weight", (d,), ("ln_w",), group), (f"{name}.bias", (d,), ("ln_b",), group)]


def _conv(name, c_in, c_out, k, group, bias=True) -> List[Spec]:
    out = [(f"{name}.weight", (c_out, c_in, k, k), ("conv", c_in * k * k), group)]
    return out + ([(f"{name}.bias", (c_out,), ("bias",), group)] if bias else [])


def _attn(prefix, d) -> List[Spec]:
    return _linear(f"{prefix}.qkv", d, 3 * d, "transformer") + _linear(f"{prefix}.proj", d, d, "transformer")


def _mlp(prefix, d_in, d_hidden, d_out, group) -> List[Spec]:
    return _linear(f"{prefix}.fc1", d_in, d_hidden, group) + _linear(f"{prefix}.fc2", d_hidden, d_out, group)


def _dec_block(prefix, d, hidden) -> List[Spec]:
    t = "transformer"
    out = _ln(f"{prefix}.norm1", d, t) + _attn(f"{prefix}.attn", d)
    for p in ("projq", "projk", "projv", "proj"):
        out += _linear(f"{prefix}.cross_attn.{p}", d, d, t)
    out += _ln(f"{prefix}.norm2", d, t) + _ln(f"{prefix}.norm3", d, t)
    return out + _mlp(f"{prefix}.mlp", d, hidden, d, t) + _ln(f"{prefix}.norm_y", d, t)


def _head(prefix, m) -> List[Spec]:
    de, dd, p = m["enc_embed_dim"], m["dec_embed_dim"], m["patch_size"]
    L, F = m["dpt_layer_dims"], m["dpt_feature_dim"]
    dims = (de, dd, dd, dd)
    g = "head"
    d = f"{prefix}.dpt"
    ap = f"{d}.act_postprocess"
    out = _conv(f"{ap}.0.0", dims[0], L[0], 1, g)
    out += [(f"{ap}.0.1.weight", (L[0], L[0], 4, 4), ("convT", L[0]), g), (f"{ap}.0.1.bias", (L[0],), ("bias",), g)]
    out += _conv(f"{ap}.1.0", dims[1], L[1], 1, g)
    out += [(f"{ap}.1.1.weight", (L[1], L[1], 2, 2), ("convT", L[1]), g), (f"{ap}.1.1.bias", (L[1],), ("bias",), g)]
    out += _conv(f"{ap}.2.0", dims[2], L[2], 1, g)
    out += _conv(f"{ap}.3.0", dims[3], L[3], 1, g) + _conv(f"{ap}.3.1", L[3], L[3], 3, g)
    for i in range(4):
        out += _conv(f"{d}.scratch.layer{i + 1}_rn", L[i], F, 3, g, bias=False)
    for i in range(4):
        r = f"{d}.scratch.refinenet{i + 1}"
        for u in ("resConfUnit1", "resConfUnit2"):
            out += _conv(f"{r}.{u}.conv1", F, F, 3, g) + _conv(f"{r}.{u}.conv2", F, F, 3, g)
        out += _conv(f"{r}.out_conv", F, F, 1, g)
    out += _conv(f"{d}.head.0", F, F // 2, 3, g) + _conv(f"{d}.head.2", F // 2, F // 2, 3, g)
    out += [(f"{d}.head.4.weight", (4, F // 2, 1, 1), ("conv", F // 2, OUT_SCALE), g),
            (f"{d}.head.4.bias", (4,), ("bias",), g)]
    idim = de + dd
    return out + _mlp(f"{prefix}.head_local_features", idim, 4 * idim, (m["local_feat_dim"] + 1) * p * p, g)


def param_specs(m: Dict) -> List[Spec]:
    """Every parameter of the model with widths ``m``, the second decoder
    and head left out (they are copies of the first)."""
    de, dd, p = m["enc_embed_dim"], m["dec_embed_dim"], m["patch_size"]
    t = "transformer"
    out = [("patch_embed.proj.weight", (de, 3, p, p), ("lin", 3 * p * p, de), t),
           ("patch_embed.proj.bias", (de,), ("bias",), t)]
    for i in range(m["enc_depth"]):
        b = f"enc_blocks.{i}"
        out += _ln(f"{b}.norm1", de, t) + _attn(f"{b}.attn", de) + _ln(f"{b}.norm2", de, t)
        out += _mlp(f"{b}.mlp", de, int(m["mlp_ratio"] * de), de, t)
    out += _ln("enc_norm", de, "f32") + _linear("decoder_embed", de, dd, t)
    for i in range(m["dec_depth"]):
        out += _dec_block(f"dec_blocks.{i}", dd, int(m["mlp_ratio"] * dd))
    out += _ln("dec_norm", dd, "f32")
    return out + _head("downstream_head1", m)


def _std(kind) -> float:
    if kind[0] == "lin":
        return math.sqrt(2.0 / (kind[1] + kind[2]))
    if kind[0] == "conv":
        return kind[1] ** -0.5 * (kind[2] if len(kind) > 2 else 1.0)
    return kind[1] ** -0.5  # convT


@torch.no_grad()
def make(m: Dict, seed: int, device, dtype=torch.bfloat16, head_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict of seed ``seed``: transformer leaves in ``dtype``, the
    two final norms in f32 and the heads in ``head_dtype`` (the types the
    program serves them in), drawn on ``device``. Same seed, same device
    and types: same values."""
    specs = param_specs(m)
    types = {"transformer": dtype, "f32": torch.float32, "head": head_dtype}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sd: Dict[str, torch.Tensor] = {}
    for group in ("transformer", "f32", "head"):
        mine = [s for s in specs if s[3] == group]
        sizes = [math.prod(s[1]) for s in mine]
        flat = torch.empty(sum(sizes), dtype=types[group], device=device)
        flat.normal_(generator=gen)
        for (name, shape, kind, _), leaf in zip(mine, torch.split(flat, sizes)):
            leaf = leaf.view(shape)
            if kind[0] in ("bias", "ln_b"):
                leaf.zero_()
                if name.endswith(".dpt.head.4.bias"):
                    leaf[2] = Z_BIAS
            elif kind[0] == "ln_w":
                leaf.fill_(1.0)
            else:
                leaf.mul_(_std(kind))
            sd[name] = leaf
    for name in list(sd):
        for src, dst in (("dec_blocks.", "dec_blocks2."), ("downstream_head1.", "downstream_head2.")):
            if name.startswith(src):
                sd[dst + name[len(src):]] = sd[name].clone()
    return sd


def n_params(m: Dict) -> int:
    """Parameters of the whole model, both decoders and heads counted."""
    total = 0
    for name, shape, _, _ in param_specs(m):
        k = math.prod(shape)
        total += 2 * k if name.startswith(("dec_blocks.", "downstream_head1.")) else k
    return total
