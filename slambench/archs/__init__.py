"""The architecture seam: everything the harness takes from a model, found
by name in ``slambench/archs/<arch>.py``, as ``metrics/<name>.py`` is.

A configuration names its architecture in ``model.arch``; a configuration
without that key runs ``mast3r``. An architecture's module gives, at module
level:

- ``MODEL_SPANS``: the program's spans that each hold one forward of the
  model (attribute ``batch``, 1 where absent), in the order the trace
  reduction and the readers take them;
- ``make_weights(m, seed, device, dtype, head_dtype)``: the state dict of
  seed ``seed`` for the widths ``m`` (the configuration's ``model``
  section), made on ``device`` in the types the program serves;
- ``build_model(m, sd, dtype, head_dtype)``: the program's model on that
  state dict, in eval mode, as the system under test runs it;
- ``make_reference(sd, m, precision)``: the plain reference at
  ``precision`` ``"f32"``, ``"bf16"`` or ``"control"`` (one step below each
  precision that the configuration states);
- ``net_input(frame_u8, long_side)``: the network input (1, h, w, 3) f32
  of a camera frame (H, W, 3) uint8;
- ``ref_views(ref, net, device)``: a reference's pointmap (hw, 3) and
  confidence (hw, 1), f64 on the host, of one session's image: what every
  keyframe of the session must hold;
- ``control_views(ref, ctrl, net, device)``: the control's pointmap and
  confidence of that image, and its heads judged as the program's are;
- ``head_modules(model)``: the program's head modules that the probe
  hooks, as (kind, head, module);
- ``head_err(ref, calls, device)``: the judge of the head calls that the
  probe kept, (kind, head, inputs, output) each;
- ``flops(m, img_hw)``: the operations of one frame's forwards, keys
  ``encode`` and ``total`` at least (a keyframe task's decode is ``total``
  less ``encode``);
- ``forward_bounds(m, img_hw, batch, dtype)``: the least seconds of the
  attention calls of one forward, keyed by the span in ``MODEL_SPANS`` it
  belongs to.

Each is the architecture's own frozen copy: nothing here is shared between
architectures but the SLAM side (``reference.expected_session`` and
``compare``, ``run.judge``, the probe's backend decode wrapper).
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT = "mast3r"
SEAM = ("MODEL_SPANS", "make_weights", "build_model", "make_reference", "net_input", "ref_views",
        "control_views", "head_modules", "head_err", "flops", "forward_bounds")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


def arch_name(config: dict) -> str:
    """The architecture a configuration (a loaded configuration file) names."""
    return str((config.get("model") or {}).get("arch", DEFAULT))


def load_arch(name: str, root: pathlib.Path = ROOT):
    """The module ``slambench/archs/<name>.py`` under ``root``; fails with
    the name and the path it looked for where there is none, and names
    what a module that is there lacks of the seam."""
    path = pathlib.Path(root) / "slambench" / "archs" / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise SystemExit(f"no architecture {name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(f"slambench_arch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in SEAM if not hasattr(mod, k)]
    if missing:
        raise SystemExit(f"architecture {name!r} ({path}) lacks {', '.join(missing)}")
    return mod
