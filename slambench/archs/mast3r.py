"""MASt3R ``ViTLarge_BaseDecoder_512_catmlpdpt`` behind the architecture
seam (``archs/__init__.py``): the port's ``models/mast3r.py`` on the
benchmark's seeded state dict, and the frozen functions that ``correct`` and
the rooflines were set on (``weights.py``, ``reference.py``,
``yardstick.py``), passed through as they are. A configuration without
``model.arch`` runs this architecture."""

from __future__ import annotations

import dataclasses

import torch

from slambench import reference, weights, yardstick

# an encode (encoder) and a pair decode (both decoders and both heads)
MODEL_SPANS = ("model.encode", "model.decode")
HEADS = ("downstream_head1", "downstream_head2")

make_weights = weights.make
param_specs = weights.param_specs
net_input = reference.network_input
ref_views = reference.reference_views  # asserts that the two views of an identical pair agree
head_err = reference.head_rel_err
flops = yardstick.model_flops


def build_model(m, sd, dtype, head_dtype):
    from frodo_slam_tpu_torch.models import mast3r

    keys = [f.name for f in dataclasses.fields(mast3r.MASt3RConfig)]
    mw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items() if k in keys}
    with torch.device("meta"):
        model = mast3r.MASt3R(mast3r.MASt3RConfig(**mw, dtype=dtype, head_dtype=head_dtype))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def make_reference(sd, m, precision="f32"):
    return reference.Ref(sd, m, precision=precision)


def control_views(ref, ctrl, net, device):
    """The control's first view of the pair (net, net), and its heads (each
    DPT and local-feature MLP) judged on the control's own head inputs."""
    reference.set_f32_numerics()
    r1, _, hooks = ctrl.pair(torch.as_tensor(net, device=device), with_hooks=True)
    X = r1["pts3d"].reshape(-1, 3).double().cpu().numpy()
    C = r1["conf"].reshape(-1, 1).double().cpu().numpy()
    return X, C, reference.head_rel_err(ref, ctrl.head_calls(*hooks), device)


def head_modules(model):
    """Each head's DPT (inputs: the four hook token maps) and local-feature
    MLP (inputs: the encoder and last decoder tokens concatenated)."""
    return [(kind, pre, getattr(getattr(model, pre), attr)) for pre in HEADS
            for kind, attr in (("dpt", "dpt"), ("mlp", "head_local_features"))]


def forward_bounds(m, img_hw, batch, dtype):
    b = yardstick.forward_attention_bound(m, img_hw, batch, dtype)
    return {"model.encode": b["encode"], "model.decode": b["decode"]}
