"""Weights across packages: JAX params pytree -> the port's state dict, and
the reference ``.pth`` checkpoint read directly.

The port's :class:`~.mast3r.MASt3R` names its parameters exactly as the
reference ``AsymmetricMASt3R`` state dict, so a reference checkpoint needs no
renaming. :func:`state_dict_from_jax` is the exact inverse of the JAX
package's ``convert_state_dict`` (``frodo_slam_tpu/models/convert.py:119-147``):

- linear   (in, out)      -> weight (out, in)
- conv     HWIO           -> OIHW
- deconv   (I, k, k, O)   -> (I, O, k, k)
- layernorm scale/bias    -> weight/bias
- stacked layer params (L, ...) -> ``.{i}.`` entries
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .mast3r import MASt3RConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _lin(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _ln(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _deconv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(0, 3, 1, 2))
    sd[f"{name}.bias"] = _t(p["b"])


def _mlp(sd, name, p):
    _lin(sd, f"{name}.fc1", p["fc1"])
    _lin(sd, f"{name}.fc2", p["fc2"])


def _attn(sd, name, p):
    _lin(sd, f"{name}.qkv", p["qkv"])
    _lin(sd, f"{name}.proj", p["proj"])


def _enc_block(sd, name, p):
    _ln(sd, f"{name}.norm1", p["norm1"])
    _attn(sd, f"{name}.attn", p["attn"])
    _ln(sd, f"{name}.norm2", p["norm2"])
    _mlp(sd, f"{name}.mlp", p["mlp"])


def _dec_block(sd, name, p):
    _ln(sd, f"{name}.norm1", p["norm1"])
    _attn(sd, f"{name}.attn", p["attn"])
    for k in ("projq", "projk", "projv", "proj"):
        _lin(sd, f"{name}.cross_attn.{k}", p["cross_attn"][k])
    _ln(sd, f"{name}.norm2", p["norm2"])
    _ln(sd, f"{name}.norm3", p["norm3"])
    _mlp(sd, f"{name}.mlp", p["mlp"])
    _ln(sd, f"{name}.norm_y", p["norm_y"])


def _dpt(sd, name, p):
    _conv(sd, f"{name}.act_postprocess.0.0", p["act1_conv"])
    _deconv(sd, f"{name}.act_postprocess.0.1", p["act1_deconv"])
    _conv(sd, f"{name}.act_postprocess.1.0", p["act2_conv"])
    _deconv(sd, f"{name}.act_postprocess.1.1", p["act2_deconv"])
    _conv(sd, f"{name}.act_postprocess.2.0", p["act3_conv"])
    _conv(sd, f"{name}.act_postprocess.3.0", p["act4_conv"])
    _conv(sd, f"{name}.act_postprocess.3.1", p["act4_conv2"])
    for i in range(4):
        _conv(sd, f"{name}.scratch.layer{i + 1}_rn", p["layer_rn"][i])
        r = p["refine"][i]
        pre = f"{name}.scratch.refinenet{i + 1}"
        for unit, key in (("resConfUnit1", "res1"), ("resConfUnit2", "res2")):
            _conv(sd, f"{pre}.{unit}.conv1", r[key]["conv1"])
            _conv(sd, f"{pre}.{unit}.conv2", r[key]["conv2"])
        _conv(sd, f"{pre}.out_conv", r["out_conv"])
    _conv(sd, f"{name}.head.0", p["head_conv1"])
    _conv(sd, f"{name}.head.2", p["head_conv2"])
    _conv(sd, f"{name}.head.4", p["head_conv3"])


def state_dict_from_jax(params: Dict[str, Any], cfg: MASt3RConfig) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves, any float dtype) -> the port's
    state dict, f32 CPU tensors."""
    params = _to_f32(params)
    sd: Dict[str, torch.Tensor] = {}
    pe = params["patch_embed"]
    sd["patch_embed.proj.weight"] = _t(np.asarray(pe["w"]).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(pe["b"])
    for i in range(cfg.enc_depth):
        _enc_block(sd, f"enc_blocks.{i}", _index(params["enc_blocks"], i))
    _ln(sd, "enc_norm", params["enc_norm"])
    _lin(sd, "decoder_embed", params["decoder_embed"])
    for stack in ("dec_blocks", "dec_blocks2"):
        for i in range(cfg.dec_depth):
            _dec_block(sd, f"{stack}.{i}", _index(params[stack], i))
    _ln(sd, "dec_norm", params["dec_norm"])
    for n in (1, 2):
        head = params[f"head{n}"]
        _dpt(sd, f"downstream_head{n}.dpt", head["dpt"])
        _mlp(sd, f"downstream_head{n}.head_local_features", head["catmlp"]["mlp"])
    return sd


def retrieval_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX retrieval-head params (``retrieval/model.py``: ``prewhiten``,
    ``projector.layers[i].{lin, ln}``, ``projector.final``, ``postwhiten``;
    numpy leaves) -> the port's :class:`RetrievalHead` state dict, f32 CPU
    tensors. The inverse of the JAX ``convert_retrieval_checkpoint``."""
    params = _to_f32(params)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("prewhiten", "postwhiten"):
        sd[f"{name}.m"] = _t(params[name]["m"])
        sd[f"{name}.p"] = _t(params[name]["p"])
    proj = params["projector"]
    for i, layer in enumerate(proj["layers"]):
        _lin(sd, f"projector.{3 * i}", layer["lin"])
        _ln(sd, f"projector.{3 * i + 1}", layer["ln"])
    if proj.get("final") is not None:
        _lin(sd, f"projector.{3 * len(proj['layers'])}", proj["final"])
    return sd


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_f32(v) for v in tree]
    return None if tree is None else np.asarray(tree, dtype=np.float32)


def load_torch_checkpoint(path: str, cfg: MASt3RConfig) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` checkpoint into the port's state dict (for
    ``MASt3R.load_state_dict``). Older checkpoints without ``dec_blocks2``
    get a copy of ``dec_blocks`` (dust3r/model.py:92-99); keys the port does
    not use (``mask_token``, the ``scratch.layer_rn`` aliases) are dropped."""
    from .mast3r import MASt3R

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}
    if not any(k.startswith("dec_blocks2") for k in sd):
        for k in list(sd):
            if k.startswith("dec_blocks."):
                sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = sd[k]
    with torch.device("meta"):
        wanted = MASt3R(cfg).state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters, e.g. {missing[:5]}")
    return {k: sd[k] for k in wanted}
