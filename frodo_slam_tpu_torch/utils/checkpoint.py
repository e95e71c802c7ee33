"""SLAM-state checkpoint / resume.

The reference persists nothing mid-run (outputs are written only at
termination). Like the JAX package's ``utils/checkpoint.py``, this module
saves a ``SLAM``'s whole map state — the keyframe store, the backend's edge
and odometry rows, the PGO ring, the retrieval database — into one
compressed ``.npz`` of numpy arrays plus a small JSON sidecar of host
bookkeeping, so a run restarts mid-sequence. The port's own layout: one
array per tensor field under ``store/``, ``edges/``, ``odom/``, ``pgo/`` and
``rdb/``, the host counters in the sidecar. A checkpoint loads onto any
device: the arrays land on the restoring ``SLAM``'s, the edge and odometry
rows on its backend's (the solve device under a placement).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch


def _tensor_fields(obj) -> dict:
    """Name -> tensor of a dataclass's or NamedTuple's tensor fields."""
    items = obj._asdict().items() if hasattr(obj, "_asdict") else (
        (f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: v for k, v in items if isinstance(v, torch.Tensor)}


def _save_fields(arrays: dict, obj, prefix: str):
    for k, v in _tensor_fields(obj).items():
        arrays[prefix + k] = v.detach().cpu().numpy()


def _load_fields(obj, data, prefix: str):
    """Copy the saved arrays into ``obj``'s tensors in place (same shapes,
    their own device and type)."""
    for k, v in _tensor_fields(obj).items():
        arr = data[prefix + k]
        if arr.shape != tuple(v.shape):
            raise ValueError(f"{prefix}{k}: checkpoint shape {arr.shape} != {tuple(v.shape)}")
        v.copy_(torch.from_numpy(arr).to(v.dtype))


def save_slam_state(slam, path: str) -> str:
    """Checkpoint a ``SLAM`` instance's map state (not the model weights).
    Waits for the backend to go idle first."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    slam._join_backend()
    arrays: dict = {}
    with slam._backend_lock:
        _save_fields(arrays, slam.store, "store/")
        _save_fields(arrays, slam.pgo, "pgo/")
        if slam.backend is not None:
            _save_fields(arrays, slam.backend.edges, "edges/")
            _save_fields(arrays, slam.backend.odom, "odom/")
    if slam.retrieval is not None:
        # retrieval is map state too: without it a resumed run never closes
        # loops against the keyframes from before the checkpoint
        for k, v in slam.retrieval.state_arrays().items():
            arrays["rdb/" + k] = v
    np.savez_compressed(str(path), **arrays)

    be = slam.backend
    meta = {
        "mode": slam.mode.name,
        "frame_count": slam.frame_count,
        "loss_track_counter": slam.loss_track_counter,
        "kf_timestamps": list(map(float, slam.kf_timestamps)),
        "current_T_WC": np.asarray(slam.current_T_WC).tolist(),
        "store_n_size": slam.store.n_size,
        "store_n_total": slam.store.n_total,
        "pgo_n_total": slam.pgo.n_total,
        "backend_pairs": [list(p) for p in be._pairs] if be is not None else [],
        "backend_odom_pairs": [list(p) for p in be._odom_pairs] if be is not None else [],
        "backend_n_odom": be._n_odom if be is not None else 0,
        "atlas_maps": len(slam.atlas),
    }
    with open(str(path) + ".json", "w") as f:
        json.dump(meta, f)
    return str(path)


def load_slam_state(slam, path: str) -> None:
    """Restore a checkpoint into a compatibly constructed ``SLAM`` (same
    capacities and image size), on that ``SLAM``'s device."""
    from ..slam import frame as frame_mod
    from ..slam.frame import Mode

    slam._join_backend(discard_pending=True)
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    with np.load(str(path)) as data, slam._backend_lock:
        _load_fields(slam.store, data, "store/")
        _load_fields(slam.pgo, data, "pgo/")
        if slam.backend is not None:
            _load_fields(slam.backend.edges, data, "edges/")
            _load_fields(slam.backend.odom, data, "odom/")
        if slam.retrieval is not None and "rdb/kf_counter" in data.files:
            slam.retrieval.load_state_arrays({k[len("rdb/"):]: data[k] for k in data.files
                                              if k.startswith("rdb/")})
        slam.store.n_size = int(meta["store_n_size"])
        slam.store.n_total = int(meta["store_n_total"])
        slam.pgo.n_total = int(meta["pgo_n_total"])
        if slam.backend is not None:
            slam.backend._pairs = [tuple(p) for p in meta["backend_pairs"]]
            slam.backend._odom_pairs = [tuple(p) for p in meta["backend_odom_pairs"]]
            slam.backend._n_odom = meta["backend_n_odom"]
        slam.mode = Mode[meta["mode"]]
        slam.frame_count = meta["frame_count"]
        slam.loss_track_counter = meta["loss_track_counter"]
        slam.kf_timestamps = meta["kf_timestamps"]
        slam.current_T_WC = np.asarray(meta["current_T_WC"], np.float32)
        slam._idx_f2k = None
        slam._hp_cache, slam._hp_gen_of = {}, {}
        slam.last_odom_pose = None
        # the streaming active-keyframe state: the last stored keyframe
        if slam.store.n_size > 0:
            kf = frame_mod.kf_get_frame(slam.store, slam.store.last_slot())
            h, w = slam.img_hw
            slam.active_kf = dataclasses.replace(
                kf, img=torch.zeros((1, h, w, 3), dtype=torch.float32, device=slam.device),
                **{f: getattr(kf, f).clone() for f in ("T_WC", "X_canon", "C", "feat", "N", "N_updates")})
