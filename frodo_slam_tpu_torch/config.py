"""YAML configuration with single-inheritance chains.

The port's own copy of the JAX package's loader: the same ``configs/*.yaml``
files load into the same tree. A config file may name a parent via an
``inherit: <path>`` key; the parent is loaded first and child keys are merged
on top, recursively for nested dicts (reference ``mast3r_slam/config.py:7-48``).
``default_config()`` provides the full default tree so components can be
constructed without any file on disk.
"""

from __future__ import annotations

import copy
import pathlib
from typing import Any, Dict, Optional

import yaml


def merge_config(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``child`` over ``base``, recursing into nested dicts."""
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str | pathlib.Path) -> Dict[str, Any]:
    """Load a YAML config, resolving its ``inherit`` chain, over defaults."""
    cfg = _load_chain(pathlib.Path(path))
    return merge_config(default_config(), cfg)


def _load_chain(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("inherit", None)
    if parent is not None:
        parent_path = pathlib.Path(parent)
        if not parent_path.is_absolute() and not parent_path.exists():
            # Allow paths relative to the child config file.
            candidate = path.parent / parent_path.name
            if candidate.exists():
                parent_path = candidate
        base = _load_chain(parent_path)
        cfg = merge_config(base, cfg)
    return cfg


def default_config() -> Dict[str, Any]:
    """Full default configuration tree (reference ``config/base.yaml``
    runtime defaults). The ``tpu`` section keeps its name so both packages
    read one file; in the port ``dtype``/``head_dtype`` set the transformer
    and head compute types and ``max_keyframes`` the store capacity."""
    return copy.deepcopy(
        {
            "use_calib": False,
            "single_thread": True,
            "image_size": [288, 512],  # (h, w) after 512-long-edge resize
            "dataset": {
                "subsample": 1,
                "img_downsample": 1,
                "center_principle_point": True,
            },
            "matching": {
                "max_iter": 10,
                "lambda_init": 1e-8,
                "convergence_thresh": 1e-6,
                "dist_thresh": 1e-1,
                "radius": 3,
                "dilation_max": 5,
                "dilation_max_warm": -1,
                "max_iter_warm": 4,
                "seed_consecutive": True,
                "dilation_max_seed": 5,
                "ft_matching_threshold": 0.8,
                "refine_impl": "auto",
            },
            "tracking": {
                "min_match_frac": 0.008,
                "use_fnn": True,
                "min_match_frac_fnn": 0.0008,
                "max_iters": 50,
                "C_conf": 0.0,
                "Q_conf": 1.5,
                "rel_error": 1e-3,
                "delta_norm": 1e-3,
                "huber": 1.345,
                "match_frac_thresh": 0.333,
                "sigma_ray": 0.003,
                "sigma_dist": 1e1,
                "sigma_pixel": 1.0,
                "sigma_depth": 1e1,  # log-depth sigma
                "sigma_point": 0.05,
                "pixel_border": -10,
                "depth_eps": 1e-6,
                "filtering_mode": "weighted_pointmap",
                "filtering_score": "median",
                "new_map_after_loss_track_N": 3,
            },
            "local_opt": {
                "pin": 1,
                "window_size": 1e6,
                "C_conf": 0.0,
                "Q_conf": 1.5,
                "min_match_frac": 0.1,
                "pixel_border": -10,
                "depth_eps": 1e-6,
                "max_iters": 10,
                "sigma_ray": 0.003,
                "sigma_dist": 1e1,
                "sigma_pixel": 1.0,
                "sigma_depth": 1e1,
                "sigma_point": 0.05,
                "delta_norm": 1e-8,
                "sigma_odom_t": 0.001,
                "sigma_odom_r": 0.001,
                "sigma_ray_odom_mode": 0.1,
                "sigma_scale_prior": 0.1,
            },
            "retrieval": {"k": 3, "min_thresh": 5e-3},
            "reloc": {"min_match_frac": 0.3, "strict": True},
            "height_prior": {
                "enabled": False,
                "camera_height": 0.55,
                "ransac_iters": 100,
                "dist_thresh": 0.02,
                "tilt_max_deg": 5.0,
                "rect": None,
                "mask_file": None,
            },
            "tpu": {
                "dtype": "bfloat16",  # enc/dec compute dtype
                "head_dtype": "float32",  # heads: f32 is the reference contract
                "max_edges": 256,
                "max_odom_edges": 64,
                "max_keyframes": 300,  # keyframe ring capacity
                "ba_opt_window": 32,
                "match_chunks": 16,
                "mesh": {"dp": 1, "tp": 1},
                "placement": "overlap",
                "consecutive_half_reuse": True,
                "backend_queue_max": 8,
                "kf_sync_per_frame": False,
            },
        }
    )


class Config(dict):
    """Dict with attribute access, for ergonomic threading through the stack."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v


def make_config(path: Optional[str] = None, **overrides: Any) -> Config:
    cfg = load_config(path) if path else default_config()
    if overrides:
        cfg = merge_config(cfg, overrides)
    return Config(cfg)


def apply_x64_knob(cfg, entry_default: bool) -> bool:
    """Resolve ``tpu.x64_eval`` for one entry point (the JAX package's
    ``config.apply_x64_knob``): an explicit value wins, else the entry
    point's default (dataset runner and session replay on, the live robot
    off). The value is written back into ``cfg["tpu"]["x64_eval"]``, where
    ``SLAM`` reads it: on, the window solve runs in f64 (the reference's
    double Eigen solve); off, in f32 with damping and one refinement step
    (the real-time numerics of ``configs/realtime.yaml``). No global state
    is set. Logs and returns the resolved value."""
    from .utils.log import get_logger

    tpu = cfg.setdefault("tpu", {})
    v = tpu.get("x64_eval", None)
    v = bool(entry_default) if v is None else bool(v)
    tpu["x64_eval"] = v
    get_logger("config").info("numerics: tpu.x64_eval=%s (%s window solve)", v,
                              "f64" if v else "f32 + one refinement step")
    return v
