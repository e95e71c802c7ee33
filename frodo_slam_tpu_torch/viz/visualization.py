"""Visualization of the live map, headless.

The port's copy of the JAX package's ``viz/visualization.py``, which keeps
the reference viewer's data contract (per-keyframe pointmaps, poses and
factor-graph edges, re-drawn when the keyframes change; reference
``mast3r_slam/visualization.py:73-600``) without a display stack:

- :class:`SLAMViewer`: matplotlib PNG renders of the map (top-down points,
  keyframe trajectory, factor edges) and of several trajectories;
- :func:`export_state`: the live map as an ``.npz`` for any outside viewer;
- :func:`run_visualization`: a background loop that re-renders only when
  the keyframe count changes;
- :func:`visualize_matches`: two frames side by side with their matches.

The store is read differently from the JAX package. There every store
write makes new arrays, so a reader without a lock sees whole arrays. Here
the frontend and the backend worker write slots of the live tensors in
place (``slam/frame.py``), so every reader takes :func:`read_map`: a copy
of the live slots and of the factor-graph pairs under ``SLAM._backend_lock``
(the lock that guards every store write; never the lock a window solve
holds for its whole length). The confidence gate and the subsample run on
the copy on the device; only the kept points cross to the host
(:func:`gated_points`). matplotlib is imported inside the functions that
draw, so the rest works where it is not installed.
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import lie


def live_slots(store) -> List[int]:
    """Physical slots of the live keyframes, oldest first."""
    n = int(store.n_size)
    total = int(store.n_total)
    return [k % store.capacity for k in range(max(0, total - n), total)]


@dataclasses.dataclass
class MapSnapshot:
    """Copies of the live keyframes' state, oldest first, taken at one
    instant of the run."""

    T_WC: torch.Tensor  # (n, 8)
    X_canon: torch.Tensor  # (n, HW, 3)
    C: torch.Tensor  # (n, HW, 1)
    N: torch.Tensor  # (n,) int32
    frame_id: torch.Tensor  # (n,) int32
    pairs: List[Tuple[int, int]]  # the backend's factor-graph edges, logical indices
    n_total: int
    frames: int

    def live_edges(self) -> List[List[int]]:
        """The edges between live keyframes, as indices into ``T_WC``."""
        logical0 = max(0, self.n_total - self.T_WC.shape[0])
        return [[i - logical0, j - logical0] for i, j in self.pairs if i >= logical0 and j >= logical0]


def read_map(slam) -> Optional[MapSnapshot]:
    """Copy the live slots and the factor-graph pairs under the store's lock
    (None while a map reset swaps the ring). The copies are enqueued before
    any later in-place write, so poses, points and edges are of one
    instant."""
    with slam._backend_lock:
        store = slam.store
        if store is None:
            return None
        idx = torch.as_tensor(live_slots(store), dtype=torch.long, device=store.T_WC.device)
        return MapSnapshot(T_WC=store.T_WC[idx], X_canon=store.X_canon[idx], C=store.C[idx],
                           N=store.N[idx], frame_id=store.frame_id[idx],
                           pairs=list(getattr(slam.backend, "_pairs", [])),
                           n_total=int(store.n_total), frames=int(slam.frame_count))


@torch.no_grad()
def gated_points(snap: MapSnapshot, conf_threshold: float, max_points: int) -> torch.Tensor:
    """World points ``[x y z conf]`` (M, 4) f32 on the snapshot's device:
    the points whose mean confidence ``C / max(N, 1)`` exceeds the
    threshold, subsampled to ``max_points`` by the JAX package's draw
    (``default_rng(0).choice(count, max_points, replace=False)``).

    The gate runs in f64, as the JAX package's numpy gate does; reading the
    gated count is the one wait on the device. ``sim3_act`` moves only the
    kept points: it is elementwise, so the numbers are those of moving every
    point first."""
    hw = snap.X_canon.shape[1]
    conf = (snap.C[..., 0].double() / torch.clamp(snap.N, min=1).double()[:, None]).reshape(-1)
    keep = torch.nonzero(conf > conf_threshold).squeeze(1)
    if keep.numel() > max_points:
        sel = np.random.default_rng(0).choice(keep.numel(), max_points, replace=False)
        keep = keep[torch.from_numpy(sel).to(keep.device)]
    pts = lie.sim3_act(snap.T_WC[keep // hw], snap.X_canon.reshape(-1, 3)[keep])
    return torch.cat([pts.float(), conf[keep].float()[:, None]], dim=1)


def export_state(slam, path: str) -> str:
    """Dump the live keyframes' poses, pointmaps, confidences and counts and
    every factor-graph edge to ``.npz`` (the shared-state contract of
    SharedKeyframes, reference frame.py:360-390)."""
    snap = read_map(slam)
    data = dict(
        T_WC=snap.T_WC.cpu().numpy(),
        X_canon=snap.X_canon.cpu().numpy(),
        C=snap.C.cpu().numpy(),
        N=snap.N.cpu().numpy(),
        frame_id=snap.frame_id.cpu().numpy(),
        edges_ii=np.asarray([i for i, _ in snap.pairs], np.int32),
        edges_jj=np.asarray([j for _, j in snap.pairs], np.int32),
    )
    path = str(path)
    np.savez_compressed(path, **data)
    return path


class SLAMViewer:
    """Matplotlib snapshot renderer of the live map."""

    def __init__(self, conf_threshold: float = 1.5, max_points: int = 200_000):
        self.conf_threshold = conf_threshold
        self.max_points = max_points

    def _world_points(self, slam, snap: Optional[MapSnapshot] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Gated, subsampled world points (M, 3) and their confidences (M,)."""
        packed = gated_points(snap or read_map(slam), self.conf_threshold, self.max_points).cpu().numpy()
        return packed[:, :3], packed[:, 3]

    def render(self, slam, out_path: str, title: str = "") -> str:
        """Top-down (x-z) map: points, keyframe trajectory, factor edges,
        all from one snapshot."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        snap = read_map(slam)
        pts, conf = self._world_points(slam, snap)
        T = snap.T_WC.cpu().numpy()

        fig, ax = plt.subplots(figsize=(8, 8))
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 2], s=0.3, c=conf, cmap="viridis", alpha=0.5)
        if len(T):
            ax.plot(T[:, 0], T[:, 2], "r.-", lw=1.5, ms=6, label="keyframes")
            # factor-graph edges (visualization.py:234-262)
            for a, b in snap.live_edges():
                if a < len(T) and b < len(T):
                    ax.plot([T[a, 0], T[b, 0]], [T[a, 2], T[b, 2]], "g-", lw=0.5, alpha=0.6)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_aspect("equal")
        ax.set_title(title or f"map: {len(T)} keyframes, {len(pts)} pts")
        ax.legend(loc="upper right")
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path

    def plot_trajectories(self, trajs: dict, out_path: str) -> str:
        """Multi-trajectory comparison (map_visualization.py:18-267): dict of
        name -> (N, >=2) positions."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        for name, P in trajs.items():
            P = np.asarray(P)
            ax.plot(P[:, 0], P[:, 2] if P.shape[1] > 2 else P[:, 1], ".-", label=name)
        ax.set_aspect("equal")
        ax.legend()
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path


def run_visualization(slam, out_dir: str, interval_s: float = 2.0,
                      stop_event: Optional[threading.Event] = None) -> threading.Thread:
    """Background render loop (the viz process slot of the reference's
    main.py:193-197): re-renders only when the keyframe count changes.
    The thread carries its ``stop_event``."""
    viewer = SLAMViewer()
    stop = stop_event or threading.Event()

    def loop():
        last_n = -1
        frame_i = 0
        while not stop.is_set():
            store = slam.store  # None while a map reset swaps the ring
            n = -1 if store is None else int(store.n_total)
            if n != last_n and n > 0:
                viewer.render(slam, str(pathlib.Path(out_dir) / f"map_{frame_i:05d}.png"))
                last_n = n
                frame_i += 1
            stop.wait(interval_s)

    t = threading.Thread(target=loop, daemon=True)
    t.stop_event = stop  # type: ignore[attr-defined]
    t.start()
    return t


def visualize_matches(matches_a, matches_b, img_a, img_b, out_path: str,
                      max_draw: int = 200) -> str:
    """Side-by-side match visualization (visualization_utils.py:138-190):
    the two frames concatenated horizontally with correspondence lines.

    matches_a/matches_b: (N, 2) [u, v] pixel coords; img_*: (H, W, 3) in
    [0, 1] or uint8.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(img_a)
    b = np.asarray(img_b)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    if b.dtype != np.uint8:
        b = (np.clip(b, 0, 1) * 255).astype(np.uint8)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b

    ma = np.asarray(matches_a)
    mb = np.asarray(matches_b)
    n = len(ma)
    if n > max_draw:
        sel = np.random.default_rng(0).choice(n, max_draw, replace=False)
        ma, mb = ma[sel], mb[sel]

    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas)
    off = a.shape[1]
    for (ua, va), (ub, vb) in zip(ma, mb):
        ax.plot([ua, ub + off], [va, vb], "-", lw=0.5, alpha=0.6)
    ax.scatter(ma[:, 0], ma[:, 1], s=2, c="lime")
    ax.scatter(mb[:, 0] + off, mb[:, 1], s=2, c="cyan")
    ax.axis("off")
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path
