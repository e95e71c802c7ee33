"""Synthetic-oracle end-to-end accuracy of the port: the full SLAM system
against a geometrically consistent synthetic world, ATE RMSE against ground
truth.

    python -m frodo_slam_tpu_torch.tools.eval_synthetic [--frames 40] [--noise 0.003]
        [--per-frame | --calib | --loop | --episode | --vio] [--threaded] [--device cuda|cpu]

The port's own copy of the JAX package's ``scripts/eval_synthetic.py``. No dataset and no trained
weights exist here, so the two model entry points every SLAM decode goes
through, ``mast3r.encode_image`` (``SLAM._encode_frame``) and
``mast3r.decode_and_heads`` (``slam/inference.py``), are replaced by an
ORACLE that renders pointmaps of a fixed world from the frame's ground-truth
pose, smuggled through the image pixels. Everything else is the port end to
end: preprocessing, the matcher and its refine, the Sim(3) tracking GN,
keyframing, retrieval and relocalization, the backend factor graph and
window BA, odometry factors and the scale-only PGO, trajectory export and
the ATE.

The patch is module-wide, so run the harness in a process of its own. It
runs on the card unless ``--device cpu``. Pointmap noise is drawn on the CPU
from a generator seeded by the pose, so the card and the CPU see the same
noise. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile

import numpy as np
import torch

H, W = 32, 64
HW = H * W
POSE_SCALE = 0.1  # the image encodes pose v as v * POSE_SCALE + 0.5 in [0, 1]
K_PLANE = np.asarray([[100.0, 0.0, W / 2], [0.0, 100.0, H / 2], [0.0, 0.0, 1.0]], np.float32)


def make_world():
    """A smooth textured surface ~5 m ahead of the trajectory start, in world
    coordinates, in raster order (the oracle's "every view sees point i at
    pixel i" convention), and unique smooth per-pixel descriptors (Fourier
    features of (u, v)). Returns CPU tensors (HW, 3) and (H, W, 24)."""
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    x = (uu - W / 2) / 8.0
    y = (vv - H / 2) / 8.0
    z = 5.0 + 0.8 * np.sin(uu * 0.15) + 0.5 * np.cos(vv * 0.23)
    pts_w = np.stack([x, y, z], -1).reshape(HW, 3)
    feats = []
    for k in range(6):
        feats += [np.sin((k + 1) * 0.37 * uu + k), np.cos((k + 1) * 0.29 * vv - k)]
    D = np.stack(feats * 2, -1).astype(np.float32)  # (H, W, 24)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return torch.from_numpy(pts_w.astype(np.float32)), torch.from_numpy(D)


def trajectory(n_frames):
    """Smooth forward arc with yaw: per-frame ground-truth Sim(3) T_WC (n, 8)."""
    from ..ops import lie

    poses = []
    for t in range(n_frames):
        s = t / max(n_frames - 1, 1)
        xi = torch.tensor([1.2 * s, 0.15 * np.sin(3 * s), 0.6 * s,  # translation
                           0.05 * np.sin(2 * s), 0.35 * s, 0.03 * np.cos(2 * s),  # rotation
                           0.0], dtype=torch.float32)  # scale fixed (monocular gauge)
        poses.append(lie.sim3_exp(xi))
    return torch.stack(poses)


def trajectory_loop(n_frames):
    """Out-and-back arc: the camera returns to (near) its start pose, so the
    last keyframes re-observe the first ones."""
    from ..ops import lie

    poses = []
    for t in range(n_frames):
        s = t / max(n_frames - 1, 1)
        a = np.sin(np.pi * s)  # 0 -> 1 -> 0
        xi = torch.tensor([1.1 * a, 0.08 * np.sin(2 * np.pi * s), 0.35 * a,
                           0.03 * np.sin(2 * np.pi * s), 0.22 * a, 0.02 * a, 0.0], dtype=torch.float32)
        poses.append(lie.sim3_exp(xi))
    return torch.stack(poses)


def encode_pose_image(T_WC, marker=0):
    """Smuggle the ground-truth pose into the frame's pixels. ``marker``
    (pixel value 8) selects a degradation the oracle applies to THIS
    frame's decode: 0 clean, 1 warped geometry with intact descriptors (the
    projective matcher fails, the fnn fallback recovers), 2 dead
    descriptors (nothing can match: a covered camera)."""
    img = np.full((H, W, 3), 0.5, np.float32)
    vals = np.asarray(T_WC, np.float32) * POSE_SCALE + 0.5
    img.reshape(-1)[: len(vals)] = vals
    img.reshape(-1)[8] = marker * POSE_SCALE + 0.5
    return img


def _decode_pose(feat):
    # feat channels 0:8 of token 0 carry the normalized pose pixels
    return feat[:, 0, :8] / (2.0 * POSE_SCALE)


def _token_grid(cfg, b, device):
    n_tok = (H // cfg.patch_size) * (W // cfg.patch_size)
    yy, xx = torch.meshgrid(torch.arange(H // cfg.patch_size, device=device),
                            torch.arange(W // cfg.patch_size, device=device), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, n_tok, 2).to(torch.int32).expand(b, n_tok, 2)
    return n_tok, pos


def _noisy(X, T_WC, salt, noise):
    """X plus noise drawn on the CPU from a generator seeded by the pose."""
    if noise <= 0:
        return X
    seed = int(abs(float(T_WC.double().sum()) * 1e4)) + salt
    n = torch.randn(X.shape, generator=torch.Generator().manual_seed(seed))
    return X + noise * n.to(X.device, X.dtype)


def install_oracle(pts_w, D_desc, noise):
    """Patch the two model entry points with the world-renderer oracle."""
    from ..models import mast3r
    from ..ops import lie

    def oracle_encode(model, img, portrait=None):
        b = img.shape[0]
        n_tok, pos = _token_grid(model.cfg, b, img.device)
        # the image is ImgNorm'd: value = (raw - 0.5) / 0.5 = pose * 2 * SCALE
        feat = torch.zeros((b, n_tok, model.cfg.enc_embed_dim), dtype=torch.float32, device=img.device)
        feat[:, 0, :9] = img.reshape(b, -1)[:, :9].float()  # 8 pose + 1 degradation marker
        return feat, pos

    def oracle_decode(model, f1, p1, f2, p2, img_hw, portrait=None):
        dev = f1.device
        pose1 = _decode_pose(f1).float()  # (B, 8) view1 T_WC
        b = pose1.shape[0]
        marker = torch.round(f1[:, 0, 8] / (2.0 * POSE_SCALE))
        pw = pts_w.to(dev)

        def render(T, salt):
            X = lie.sim3_act(lie.sim3_inv(T), pw)  # (HW, 3) camera frame
            return _noisy(X, T, salt, noise).reshape(H, W, 3)

        # view2's points ARE the same world points in view1's frame (the
        # asymmetric-decode contract: res2 = view2's pointmap in view1 coordinates)
        X1 = torch.stack([render(pose1[i], 1) for i in range(b)])
        X2 = torch.stack([render(pose1[i], 2) for i in range(b)])
        ones = torch.ones((b, H, W, 1), dtype=torch.float32, device=dev)
        desc = D_desc.to(dev)[None].expand(b, H, W, D_desc.shape[-1])

        # marker 1: a strong smooth warp of view1's geometry only: the views
        # disagree in 3D (the occlusion gate kills the projective match)
        # while the descriptors stay exact (the fnn fallback can recover)
        vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        warp = 0.6 * torch.stack([torch.sin(vv * 0.4), torch.cos(uu * 0.3), torch.sin((uu + vv) * 0.2)], -1)
        m1 = (marker == 1)[:, None, None, None]
        X1 = torch.where(m1, X1 + warp[None], X1)
        # marker 2: dead descriptors on view1: neither the projective score
        # gate nor the descriptor fallback can match (a covered camera)
        m2 = (marker == 2)[:, None, None, None]
        desc1 = torch.where(m2, -desc, desc)
        q1 = torch.where(m2, 0.0 * ones, 4.0 * ones)

        res1 = {"pts3d": X1, "conf": 5.0 * ones, "desc": desc1, "desc_conf": q1}
        res2 = {"pts3d": X2, "conf": 5.0 * ones, "desc": desc, "desc_conf": 4.0 * ones}
        return res1, res2

    mast3r.encode_image = oracle_encode
    mast3r.decode_and_heads = oracle_decode


# ---------------------------------------------------------------------------
# Plane-world oracle (calibrated and loop-closure modes)
#
# The identity-correspondence oracle above cannot exercise the calibrated
# pipeline: its residual is [pixel u, v, log z], which vanishes at ground
# truth only if every pointmap point lies ON its pixel's ray through K. The
# plane world renders each view by closed-form ray/plane intersection, so
# pointmaps are ray-consistent by construction AND correspondences between
# views are real (nearest-pixel, not identity).
# ---------------------------------------------------------------------------

def make_plane_world(K):
    """World = one tilted textured plane n.X = d, ~4 m ahead of the origin.

    Returns (render, desc_of_world, token_sig):
      render(T_WC)       -> (X_cam (HW, 3) on pixel rays, X_world (HW, 3))
      desc_of_world(X_w) -> (..., 24) unit descriptors, smooth Fourier
                            features of the in-plane coordinates
      token_sig(T_WC)    -> (N_TOK, 24) plane descriptors at the patch-token
                            centres of this view (a place signature)
    """
    from ..ops import geometry, lie

    n = np.asarray([0.06, -0.10, 1.0], np.float32)
    n /= np.linalg.norm(n)
    d = 4.0
    e1 = np.cross([0.0, 1.0, 0.0], n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    # 12 Fourier plane waves -> 24-dim (sin, cos) descriptors, |k| in [3, 18]:
    # the autocorrelation stays above the 0.8 score gate at 1-pixel offsets
    # and decays by ~5 pixels, as trained local features do
    rng = np.random.default_rng(11)
    kmag = rng.uniform(3.0, 18.0, 12).astype(np.float32)
    kang = rng.uniform(0, 2 * np.pi, 12).astype(np.float32)
    kvec = np.stack([kmag * np.cos(kang), kmag * np.sin(kang)], -1)  # (12, 2)
    kph = rng.uniform(0, 2 * np.pi, 12).astype(np.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    n_t, e1_t, e2_t, kvec_t, kph_t = f32(n), f32(e1), f32(e2), f32(kvec), f32(kph)
    uv = geometry.get_pixel_coords((H, W))  # (HW, 2)
    dirs_cpu = geometry.backproject(uv, torch.ones((HW, 1)), f32(K))  # z = 1

    def on(x, like):
        return x.to(like.device)

    def render(T_WC):
        dirs = on(dirs_cpu, T_WC)
        t = T_WC[:3]
        sRd = lie.sim3_act(T_WC, dirs) - t  # s R dirs
        z = (d - torch.dot(on(n_t, T_WC), t)) / (sRd @ on(n_t, T_WC))  # (HW,) depth along +z
        X_cam = z[:, None] * dirs
        return X_cam, lie.sim3_act(T_WC, X_cam)

    def desc_of_world(X_w):
        p = torch.stack([X_w @ on(e1_t, X_w), X_w @ on(e2_t, X_w)], -1)  # plane coords
        phase = p @ on(kvec_t, X_w).T + on(kph_t, X_w)  # (..., 12)
        f = torch.cat([torch.sin(phase), torch.cos(phase)], -1)  # (..., 24)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def token_sig(T_WC):
        _, X_w = render(T_WC)
        ty, tx = torch.meshgrid(torch.arange(H // 16), torch.arange(W // 16), indexing="ij")
        centers = ((ty * 16 + 8) * W + (tx * 16 + 8)).reshape(-1).to(X_w.device)
        return desc_of_world(X_w[centers])

    return render, desc_of_world, token_sig


def install_plane_oracle(K, noise, token_desc=False):
    """Patch the model entry points with the plane-world renderer.

    ``token_desc``: also write each view's plane descriptors at the patch
    centres into encoder-token channels 16:40, a place signature that makes
    ASMK retrieval similarity track viewpoint overlap (the role trained
    encoder features play, retrieval_database.py:30-46)."""
    from ..models import mast3r
    from ..ops import lie

    render, desc_of_world, token_sig = make_plane_world(K)

    def oracle_encode(model, img, portrait=None):
        b = img.shape[0]
        n_tok, pos = _token_grid(model.cfg, b, img.device)
        pose_px = img.reshape(b, -1)[:, :9].float()
        feat = torch.zeros((b, n_tok, model.cfg.enc_embed_dim), dtype=torch.float32, device=img.device)
        feat[:, 0, :9] = pose_px
        if token_desc:
            pose = pose_px[:, :8] / (2.0 * POSE_SCALE)
            feat[:, :, 16:40] = torch.stack([token_sig(pose[i]) for i in range(b)])
        return feat, pos

    def oracle_decode(model, f1, p1, f2, p2, img_hw, portrait=None):
        pose1 = _decode_pose(f1).float()  # (B, 8) view1 T_WC
        pose2 = _decode_pose(f2).float()  # (B, 8) view2 T_WC
        b = pose1.shape[0]

        def one(T1, T2):
            X1c, X1w = render(T1)
            X2c, X2w = render(T2)
            # asymmetric-decode contract: res2 = view2's pointmap in view1's
            # coordinates (mast3r_utils.py:295-320)
            X21 = lie.sim3_act(lie.sim3_rel(T1, T2), X2c)
            return (_noisy(X1c, T1, 1, noise).reshape(H, W, 3), _noisy(X21, T2, 2, noise).reshape(H, W, 3),
                    desc_of_world(X1w).reshape(H, W, 24), desc_of_world(X2w).reshape(H, W, 24))

        X11, X21, d1, d2 = (torch.stack(x) for x in zip(*[one(pose1[i], pose2[i]) for i in range(b)]))
        ones = torch.ones((b, H, W, 1), dtype=torch.float32, device=f1.device)
        res1 = {"pts3d": X11, "conf": 5.0 * ones, "desc": d1, "desc_conf": 4.0 * ones}
        res2 = {"pts3d": X21, "conf": 5.0 * ones, "desc": d2, "desc_conf": 4.0 * ones}
        return res1, res2

    mast3r.encode_image = oracle_encode
    mast3r.decode_and_heads = oracle_decode


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def _tiny_model(device):
    """Weights the oracle never reads; the system needs a model on its device."""
    from ..models import mast3r

    return mast3r.init_model(mast3r.tiny_config(), seed=0, device=device)


def _gt_file(out_dir, T_true, n_frames):
    gt_rows = np.concatenate([np.arange(n_frames, dtype=np.float64)[:, None],
                              np.asarray(T_true[:, :7], np.float64)], axis=1)
    gt_path = pathlib.Path(out_dir) / "synth_gt.txt"
    np.savetxt(gt_path, gt_rows, fmt="%.9f")
    return gt_path


def _ate_of_system(slam, T_true, n_frames, out_dir):
    from ..utils import evaluate

    out_dir = pathlib.Path(out_dir or tempfile.mkdtemp(prefix="synth_eval_"))
    stamps, poses = slam.keyframe_poses()
    traj = evaluate.save_traj(out_dir, "synth.txt", stamps, poses)
    return float(evaluate.ate_rmse(str(_gt_file(out_dir, T_true, n_frames)), str(traj), max_dt=0.5))


def _synth_tpu_overrides():
    """``tpu:`` overrides shared by all runs: FRODO_SYNTH_HALF A/Bs the
    consecutive-edge half reuse, FRODO_SYNTH_KF_SYNC the per-frame keyframe
    pointmap write-back."""
    over = {}
    if os.environ.get("FRODO_SYNTH_HALF") is not None:
        over["consecutive_half_reuse"] = bool(int(os.environ["FRODO_SYNTH_HALF"]))
    if os.environ.get("FRODO_SYNTH_KF_SYNC") is not None:
        over["kf_sync_per_frame"] = bool(int(os.environ["FRODO_SYNTH_KF_SYNC"]))
    return over


def _synth_matching_overrides():
    """``matching:`` overrides shared by all runs (accuracy A/B knobs)."""
    over = {}
    if os.environ.get("FRODO_SYNTH_DILATION"):
        over["dilation_max"] = int(os.environ["FRODO_SYNTH_DILATION"])
    if os.environ.get("FRODO_SYNTH_DILATION_WARM") is not None:
        over["dilation_max_warm"] = int(os.environ["FRODO_SYNTH_DILATION_WARM"])
    if os.environ.get("FRODO_SYNTH_MAXITER_WARM") is not None:
        over["max_iter_warm"] = int(os.environ["FRODO_SYNTH_MAXITER_WARM"])
    if os.environ.get("FRODO_SYNTH_SEED") is not None:
        over["seed_consecutive"] = bool(int(os.environ["FRODO_SYNTH_SEED"]))
    if os.environ.get("FRODO_SYNTH_DILATION_SEED") is not None:
        over["dilation_max_seed"] = int(os.environ["FRODO_SYNTH_DILATION_SEED"])
    return over


def _random_db(nfeat, device):
    """A seeded random retrieval head over the tiny encoder width and a
    random 64-word codebook."""
    from ..models import mast3r
    from ..retrieval.asmk import Codebook
    from ..retrieval.database import RetrievalDatabase
    from ..retrieval.model import RetrievalHead

    dim = mast3r.tiny_config().enc_embed_dim
    head = RetrievalHead.init(torch.Generator().manual_seed(1), backbone_dim=dim, hdims=[dim],
                              nfeat=nfeat, device=device)
    return RetrievalDatabase(head, Codebook.random(np.random.default_rng(0), 64, dim, device=device))


def run(n_frames=40, noise=0.003, single_thread=True, out_dir=None, per_frame=False, device="cuda"):
    """The straight arc on the identity-correspondence world. Every frame a
    keyframe (ATE over the keyframe poses), or with ``per_frame`` sparse
    keyframing (threshold 0.15: most frames warm-started) and the ATE over
    every tracked frame's frontend pose."""
    from ..config import make_config
    from ..slam.system import SLAM
    from ..utils import evaluate

    pts_w, D_desc = make_world()
    install_oracle(pts_w, D_desc, noise)
    T_true = trajectory(n_frames)

    tracking_over = {"min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 30}
    if not per_frame:
        tracking_over["match_frac_thresh"] = 1.1
    else:
        # this oracle's steady-state unique-match fraction is ~0.24, so the
        # reference 0.333 would keyframe every frame
        tracking_over["match_frac_thresh"] = float(os.environ.get("FRODO_SYNTH_KF_THRESH", 0.15))
    cfg = make_config(
        tracking=tracking_over,
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 6},
        matching=_synth_matching_overrides(),
        tpu={"max_keyframes": max(8, n_frames + 2), "max_edges": 32, "max_odom_edges": 8,
             **_synth_tpu_overrides()},
    )
    slam = SLAM(cfg, _tiny_model(device), (H, W), retrieval_db=None, use_backend=True,
                use_reloc=False, single_thread=single_thread, device=device)

    ok_count = 0
    frame_stamps, frame_poses = [], []
    for t in range(n_frames):
        ok, pose, _ = slam.grab_rgb(encode_pose_image(T_true[t]), timestamp=float(t))
        ok_count += int(ok)
        if ok:
            frame_stamps.append(float(t))
            frame_poses.append(np.asarray(pose, np.float64))
    slam.terminate()

    out_dir = pathlib.Path(out_dir or tempfile.mkdtemp(prefix="synth_eval_"))
    if per_frame:
        stamps, poses = frame_stamps, np.stack(frame_poses)
    else:
        stamps, poses = slam.keyframe_poses()
    traj = evaluate.save_traj(out_dir, "synth.txt", stamps, poses)
    rmse = evaluate.ate_rmse(str(_gt_file(out_dir, T_true, n_frames)), str(traj), max_dt=0.5)
    return {"mode": "per_frame" if per_frame else "straight", "ate_rmse": round(float(rmse), 6),
            "n_kf": len(slam.kf_timestamps), "frames_tracked_ok": ok_count, "noise": noise}


def run_calib(n_frames=20, noise=0.003, out_dir=None, device="cuda"):
    """The calibrated pipeline on the plane world: pixel + log-depth
    tracking GN, the calibrated window solve and ray constraining."""
    from ..config import make_config
    from ..slam.system import SLAM

    install_plane_oracle(K_PLANE, noise)
    T_true = trajectory(n_frames)
    cfg = make_config(
        use_calib=True,
        tracking={"min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 30, "match_frac_thresh": 1.1},
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 6},
        matching=_synth_matching_overrides(),
        tpu={"max_keyframes": max(8, n_frames + 2), "max_edges": 32, "max_odom_edges": 8,
             **_synth_tpu_overrides()},
    )
    slam = SLAM(cfg, _tiny_model(device), (H, W), calib=K_PLANE, retrieval_db=None,
                use_backend=True, use_reloc=False, single_thread=True, device=device)
    if not slam.tcfg.use_calib:
        raise RuntimeError("calib mode did not reach the tracker")
    ok_count = 0
    for t in range(n_frames):
        ok, _, _ = slam.grab_rgb(encode_pose_image(T_true[t]), timestamp=float(t))
        ok_count += int(ok)
    slam.terminate()
    rmse = _ate_of_system(slam, T_true, n_frames, out_dir)
    return {"mode": "calib", "ate_rmse": round(rmse, 6), "n_kf": len(slam.kf_timestamps),
            "frames_tracked_ok": ok_count, "noise": noise}


def run_loop(n_frames=24, noise=0.004, out_dir=None, with_retrieval=True, device="cuda"):
    """Loop closure on the plane world: an out-and-back trajectory drifts
    with pointmap noise; with the retrieval database on, the backend inserts
    non-consecutive (loop-closure) edges between the revisit keyframes and
    the window BA pulls the loop shut (vio.py:124-148)."""
    from ..config import make_config
    from ..slam.system import SLAM

    install_plane_oracle(K_PLANE, noise, token_desc=True)
    T_true = trajectory_loop(n_frames)
    cfg = make_config(
        tracking={"min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 30, "match_frac_thresh": 1.1},
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.2, "max_iters": 6},
        matching=_synth_matching_overrides(),
        tpu={"max_keyframes": max(8, n_frames + 2), "max_edges": max(64, 3 * n_frames),
             "max_odom_edges": 8, **_synth_tpu_overrides()},
    )
    db = _random_db(8, device) if with_retrieval else None
    slam = SLAM(cfg, _tiny_model(device), (H, W), retrieval_db=db, use_backend=True,
                use_reloc=False, single_thread=True, device=device)
    ok_count = 0
    for t in range(n_frames):
        ok, _, _ = slam.grab_rgb(encode_pose_image(T_true[t]), timestamp=float(t))
        ok_count += int(ok)
    slam.terminate()
    loop_edges = [(i, j) for i, j in slam.backend._pairs if abs(j - i) > 1]
    # a genuine loop closure links the revisit tail to the early map
    long_edges = [(i, j) for i, j in loop_edges if abs(j - i) >= n_frames // 3]
    rmse = _ate_of_system(slam, T_true, n_frames, out_dir)
    return {"mode": "loop" if with_retrieval else "loop_noretrieval", "ate_rmse": round(rmse, 6),
            "n_kf": len(slam.kf_timestamps), "frames_tracked_ok": ok_count,
            "n_loop_edges": len(loop_edges), "n_long_loop_edges": len(long_edges), "noise": noise}


def run_vio(n_frames=16, noise=0.002, alpha=0.5, use_odometry=True, out_dir=None, device="cuda"):
    """The robot VIO mode end to end (the JAX package's ``run_vio`` row):
    wheel-odometry SE(3) factors and the scale-only PGO recover METRIC scale.

    The oracle world is rendered along a trajectory whose translations are
    the metric ground truth scaled by ``alpha``: pure VO can only recover
    that alpha-scaled trajectory (the monocular gauge g = alpha). The
    odometry stream reports the true metric SE(3) poses. With
    ``use_odometry`` (``local_opt_mode``) each keyframe's odometry delta
    enters the window BA and the PGO writes the gauge into the keyframes'
    scale channels (g = world / metric), so the metric trajectory is t / s.

    Metric-ness is measured WITHOUT the Sim(3) alignment's scale freedom:
    the SE(3)-aligned ATE of the metric trajectory against the metric ground
    truth (``ate_se3_scaled``); without odometry it misses by about (1 -
    alpha) x the trajectory's spread. ``ate_sim3`` is the shape control."""
    from ..config import make_config
    from ..slam.system import SLAM
    from ..utils import evaluate

    pts_w, D_desc = make_world()
    install_oracle(pts_w, D_desc, noise)
    T_metric = trajectory(n_frames).numpy()  # Sim3 (8,): metric ground truth
    T_vo = T_metric.copy()
    T_vo[:, :3] *= alpha  # what monocular VO sees (the world is self-consistent)
    cfg = make_config(
        tracking={"min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 30,
                  "match_frac_thresh": 1.1},  # a keyframe per frame
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 6},
        tpu={"max_keyframes": max(8, n_frames + 2), "max_edges": max(32, 4 * n_frames),
             "max_odom_edges": max(8, n_frames + 2)},
    )
    slam = SLAM(cfg, _tiny_model(device), (H, W), retrieval_db=None, use_backend=True,
                use_reloc=False, single_thread=True, local_opt_mode=use_odometry, device=device)
    ok_count = 0
    for t in range(n_frames):
        odom = T_metric[t, :7].astype(np.float64) if use_odometry else None
        ok, _, _ = slam.grab_rgb(encode_pose_image(T_vo[t]), timestamp=float(t), odom_pose=odom)
        ok_count += int(ok)
    slam.terminate()

    stamps, poses = slam.keyframe_poses()  # (N, 8) Sim3, world gauge
    _, poses_metric = slam.metric_keyframe_poses()  # t / s
    out_dir = pathlib.Path(out_dir or tempfile.mkdtemp(prefix="synth_vio_"))
    gt_rows = np.concatenate([np.arange(n_frames, dtype=np.float64)[:, None],
                              np.asarray(T_metric[:, :7], np.float64)], axis=1)
    gt_path = out_dir / "vio_gt.txt"
    np.savetxt(gt_path, gt_rows, fmt="%.9f")
    traj_raw = evaluate.save_traj(out_dir, "vio_raw.txt", stamps, poses)
    traj_met = evaluate.save_traj(out_dir, "vio_metric.txt", stamps, poses_metric)
    ate = lambda traj, **kw: float(evaluate.ate_rmse(str(gt_path), str(traj), max_dt=0.5, **kw))  # noqa: E731
    return {"mode": "vio" if use_odometry else "vio_no_odom", "alpha": alpha,
            "scale_median": round(float(np.median(poses[:, 7])), 4),  # a transient between alpha and 1
            "ate_se3_raw": round(ate(traj_raw, with_scale=False), 6),
            "ate_se3_scaled": round(ate(traj_met, with_scale=False), 6),
            "ate_sim3": round(ate(traj_raw), 6),
            "pgo_scale": round(float(slam.pgo.scale[0, 0]), 6),
            "n_kf": len(stamps), "frames_tracked_ok": ok_count, "noise": noise}


def run_episode(noise=0.0, device="cuda"):
    """The failure-path episode (reference tracker.py:222-276, vio.py:29-72,
    321-328): the real accept gate, the fnn descriptor fallback, and
    tracking loss -> relocalization attempts -> map reset -> re-init, with
    counters that prove each path fired.

    Phases: (1) clean tracking with a real min_match_frac gate and use_fnn;
    (2) one warped-geometry frame: the projective match dies at the
    occlusion gate, the fnn fallback recovers; (3) dead-descriptor frames:
    nothing matches, each failure attempts a retrieval-seeded
    relocalization (the strict gate rejects a blinded camera), the loss
    counter runs out and the map resets into the atlas; (4) clean frames
    again: a fresh map re-initializes and tracks."""
    from ..config import make_config
    from ..slam.system import SLAM

    pts_w, D_desc = make_world()
    install_oracle(pts_w, D_desc, noise)
    n1, n_loss, n4 = 8, 3, 6
    T_true = trajectory(n1 + n_loss + n4 + 1)
    cfg = make_config(
        tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.05, "Q_conf": 1.0, "max_iters": 30,
                  "use_fnn": True,
                  "min_match_frac_fnn": 0.004,  # fnn subsamples 8x8: at most ~1/64
                  "new_map_after_loss_track_N": 3},
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 6},
        tpu={"max_keyframes": 32, "max_edges": 32, "max_odom_edges": 8},
    )
    slam = SLAM(cfg, _tiny_model(device), (H, W), retrieval_db=_random_db(32, device),
                use_backend=True, use_reloc=True, single_thread=True, device=device)

    counters = {"fnn_frames": 0, "loss_frames": 0, "reloc_attempts": 0, "resets": 0,
                "post_reset_tracked": 0}
    real_reloc = slam._relocalize

    def counting_reloc(frame, timestamp):
        counters["reloc_attempts"] += 1
        return real_reloc(frame, timestamp)

    slam._relocalize = counting_reloc
    t = 0

    def step(marker, expect_ok):
        nonlocal t
        ok, pose, _ = slam.grab_rgb(encode_pose_image(T_true[t], marker=marker), timestamp=float(t))
        t += 1
        if not np.all(np.isfinite(pose)):
            raise RuntimeError(f"frame {t - 1}: non-finite pose")
        if ok != expect_ok:
            raise RuntimeError(f"frame {t - 1} marker={marker}: ok={ok}")
        return ok

    def used_fnn():
        return bool(slam.last_track.flags[19].item() > 0)

    for _ in range(n1):  # phase 1: clean, real gate
        step(0, True)
    step(1, True)  # phase 2: warped geometry -> projective match dies, fnn recovers
    if not used_fnn():
        raise RuntimeError("the fnn fallback did not fire")
    counters["fnn_frames"] += 1
    for _ in range(n_loss):  # phase 3: dead descriptors -> losses -> map reset
        step(2, False)
        counters["loss_frames"] += 1
    if len(slam.atlas) != 1:
        raise RuntimeError("tracking loss did not reset the map")
    if counters["reloc_attempts"] < 1:
        raise RuntimeError("loss frames never attempted a relocalization")
    counters["resets"] = len(slam.atlas)
    for _ in range(n4):  # phase 4: clean frames -> a fresh map re-initializes and tracks
        counters["post_reset_tracked"] += int(step(0, True))
    slam.terminate()
    counters["n_kf_new_map"] = int(slam.store.n_size)
    return counters


def main(argv=None):
    ap = argparse.ArgumentParser(description="synthetic-oracle ATE of the PyTorch/CUDA port")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--noise", type=float, default=0.003)
    ap.add_argument("--threaded", action="store_true")
    ap.add_argument("--episode", action="store_true",
                    help="the failure-path episode (fnn fallback, loss -> reloc -> reset -> re-init)")
    ap.add_argument("--calib", action="store_true",
                    help="the calibrated pipeline on the ray-consistent plane world")
    ap.add_argument("--loop", action="store_true",
                    help="loop closure on the plane world, with and without the retrieval database")
    ap.add_argument("--per-frame", action="store_true",
                    help="sparse keyframing + per-frame-pose ATE (the warm-started matcher path)")
    ap.add_argument("--vio", action="store_true",
                    help="the robot VIO mode (odometry factors + scale-only PGO), with and without odometry")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    if args.episode:
        out = run_episode(args.noise, device=dev)
    elif args.calib:
        out = run_calib(args.frames, args.noise, out_dir=args.out, device=dev)
    elif args.vio:
        on = run_vio(args.frames, args.noise, use_odometry=True, out_dir=args.out, device=dev)
        off = run_vio(args.frames, args.noise, use_odometry=False, out_dir=args.out, device=dev)
        out = {"vio": on, "no_odom": off}
    elif args.loop:
        on = run_loop(args.frames, args.noise, out_dir=args.out, with_retrieval=True, device=dev)
        off = run_loop(args.frames, args.noise, out_dir=args.out, with_retrieval=False, device=dev)
        out = {"loop": on, "no_retrieval": off}
    else:
        out = run(args.frames, args.noise, single_thread=not args.threaded, out_dir=args.out,
                  per_frame=args.per_frame, device=dev)
    dev = torch.device(dev)
    out["device"] = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    # the hand-written kernels' launches in this process (each counts on the card only)
    from ..ops import ba_reduce_kernel, calib_edge_kernel, refine_kernel

    out["launches"] = {"refine_matches": refine_kernel.refine_matches.launches,
                       "ray_edge_systems": ba_reduce_kernel.ray_edge_systems.launches,
                       "calib_edge_systems": calib_edge_kernel.calib_edge_systems.launches}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
