"""Dry run of the multi-card backend on a list of n devices.

    python -m frodo_slam_tpu_torch.tools.dryrun_multichip [--n 8] [--device cuda|cpu]

The port's counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:169-380``), at its 32x64 ``tiny_config`` setup and
with its bars. The devices are ``--n`` slots: on the CPU n aliases of the
CPU; on the cards, card ``i mod count`` for slot i (n aliases of the one
card where there is one). Four checks, each raising on failure:

1. the dp/tp-split symmetric pair decode (2 dp pairs over a (dp, tp) grid,
   tp = 2 when n is even) gives finite outputs from every rank;
2. the dp-split matcher on an oracle world (a smooth surface seen twice, the
   second view rolled 3 pixels): valid fraction > 0.8 and > 98% of the valid
   matches correct;
3. the edge-split ray BA on a consistent synthetic world converges to under
   0.2 of the initial relative-pose error;
4. ``overlap`` keeps slot 0 (the tracker's) out of the backend's slots, the
   backend decodes on its grid while the tracker's matcher runs on slot 0.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import mast3r
from ..ops import lie, matching
from ..parallel import mesh
from ..slam.global_opt import BAConfig, Edges, empty_odom_edges, solve_gn_rays
from ..slam.inference import decode_symmetric_split

H, W = 32, 64
SHIFT = 3
MATCH_KW = dict(max_iter=6, lambda_init=1e-8, convergence_thresh=1e-6, dist_thresh=1e-1, radius=3,
                dilation_max=2, ft_matching_threshold=0.8, refine_impl="auto")


def slot_devices(n: int, device: str):
    """The n device slots of the dry run (see the module docstring)."""
    if device == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device (pass --device cpu)")
    return [torch.device("cuda", i % count) for i in range(n)]


def oracle_match_world(b: int, h: int = H, w: int = W, shift: int = SHIFT):
    """The JAX dry run's oracle matcher inputs: a smooth textured surface
    seen twice, the second view's pointmap and unique random descriptors
    rolled ``shift`` pixels along u, so that query (u, v) matches pixel
    ((u + shift) mod w, v). Returns X11, X21, D11, D21 (b, h, w, .) float32
    numpy, the true match (h w,) and the mask of pixels held to it
    (wrapped columns and a 2-pixel border band excluded)."""
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x = (uu - w / 2) / 16.0
    y = (vv - h / 2) / 16.0
    z = 5.0 + 0.4 * np.sin(uu * 0.15) + 0.25 * np.cos(vv * 0.23)
    X11 = np.stack([x, y, z], -1)
    D11 = np.random.default_rng(3).normal(size=(h, w, 24)).astype(np.float32)
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    X21 = np.roll(X11, -shift, axis=1)
    D21 = np.roll(D11, -shift, axis=1)
    tile = lambda a: np.repeat(a[None], b, axis=0).astype(np.float32)  # noqa: E731
    idx_true = (vv.astype(np.int64) * w + ((uu.astype(np.int64) + shift) % w)).reshape(-1)
    interior = ((uu + shift <= w - 2) & (uu >= 1) & (vv >= 2) & (vv <= h - 3)).reshape(-1)
    return tile(X11), tile(X21), tile(D11), tile(D21), idx_true, interior


def synthetic_ba_world(n_kf: int, hw: int, seed: int = 7):
    """Ground-truth Sim(3) poses and per-keyframe pointmaps of one shared
    world cloud (identity correspondences): the residual vanishes at the
    truth. float64 tensors (P, 8), (P, hw, 3)."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-2.0, 2.0, (hw, 3)) + np.array([0.0, 0.0, 6.0]))
    xis = torch.from_numpy(rng.normal(size=(n_kf, 7)) * np.array([0.3, 0.3, 0.3, 0.15, 0.15, 0.15, 0.05]))
    T = lie.sim3_exp(xis)
    return T, lie.sim3_act(lie.sim3_inv(T)[:, None, :], pts[None])


def _match_scores(idx, valid, idx_true, interior):
    """(valid fraction, correct fraction of the valid) on the interior."""
    v = valid[..., 0].cpu().numpy()[:, interior]
    ok = (idx.cpu().numpy()[:, interior] == idx_true[None, interior]) & v
    return float(v.mean()), float(ok.sum() / max(v.sum(), 1))


def _split_match(placement, X11, X21, D11, D21):
    """The matcher on each rank's share of the batch, on its device."""
    n = X11.shape[0]
    parts = [mesh.split_batch(torch.from_numpy(a), placement) for a in (X11, X21, D11, D21)]
    outs = [matching.match(*(p[r] for p in parts), None, **MATCH_KW) for r in range(placement.dp)]
    return tuple(mesh.gather_batch([o[k] for o in outs], placement.solve_device, n) for k in (0, 1))


def run(n: int = 8, device: str = "cuda") -> dict:
    devices = slot_devices(n, device)
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // tp
    placement = mesh.make_placement(dp, tp, devices)
    cfg = mast3r.tiny_config()
    n_tok = (H // 16) * (W // 16)
    n_pairs = 2 * dp
    out = dict(n=n, devices=[str(d) for d in devices], dp=dp, tp=tp)

    # 1) the dp/tp-split symmetric pair decode
    model = mast3r.init_model(cfg, seed=0, device=devices[0])
    replicas = mesh.backend_replicas(model, placement)
    rng = np.random.default_rng(0)
    feat = lambda: torch.from_numpy(rng.normal(size=(n_pairs, n_tok, cfg.enc_embed_dim)).astype(np.float32))  # noqa: E731
    yy, xx = np.meshgrid(np.arange(H // 16), np.arange(W // 16), indexing="ij")
    pos = torch.from_numpy(np.stack([yy, xx], -1).reshape(1, n_tok, 2).astype(np.int32)).expand(n_pairs, -1, -1)
    X, C, D, Q = decode_symmetric_split(replicas, placement, feat(), pos, feat(), pos, (H, W))
    if not (bool(torch.isfinite(X).all()) and bool(torch.isfinite(C).all())):
        raise AssertionError("non-finite outputs from the split symmetric pair decode")
    out["decode_shape"] = list(X.shape)

    # 2) the dp-split matcher on the oracle world
    X11, X21, D11, D21, idx_true, interior = oracle_match_world(n_pairs)
    idx, valid = _split_match(placement, X11, X21, D11, D21)
    frac, correct = _match_scores(idx, valid, idx_true, interior)
    out.update(match_frac=frac, match_correct=correct)
    if not frac > 0.8:
        raise AssertionError(f"split matcher valid-match fraction too low: {frac:.4f}")
    if not correct > 0.98:
        raise AssertionError(f"split matcher found wrong correspondences: {correct:.4f} of the valid")

    # 3) the edge-split ray BA on a consistent world
    n_poses = n_pairs + 1
    hw = H * W
    T_true, X_world = synthetic_ba_world(n_poses, hw)
    noise = np.random.default_rng(11).normal(size=(n_poses, 7)) * np.array([0.05] * 3 + [0.02] * 3 + [0.01])
    noise[0] = 0.0
    sd = placement.solve_device
    T_init = lie.sim3_retr(T_true, torch.from_numpy(noise)).float().to(sd)
    ii = [k + d for k in range(n_poses - 1) for d in (0, 1)]
    jj = [k + 1 - d for k in range(n_poses - 1) for d in (0, 1)]
    E = len(ii)
    edges = Edges(ii=torch.tensor(ii, dtype=torch.int32, device=sd),
                  jj=torch.tensor(jj, dtype=torch.int32, device=sd),
                  idx=torch.arange(hw, dtype=torch.int32, device=sd).expand(E, hw).contiguous(),
                  valid=torch.ones((E, hw), dtype=torch.bool, device=sd),
                  Q=torch.full((E, hw), 4.0, device=sd), active=torch.ones((E,), dtype=torch.bool, device=sd))
    T_new = solve_gn_rays(BAConfig(max_iters=10, pin=1, delta_norm=1e-10), 1, T_init,
                          X_world.float().to(sd), torch.full((n_poses, hw, 1), 5.0, device=sd), edges,
                          empty_odom_edges(1, device=sd), torch.full((n_poses,), -1.0, device=sd),
                          placement=placement)
    if not bool(torch.isfinite(T_new).all()):
        raise AssertionError("non-finite poses from the split BA")

    def rel_pose_err(T):
        T = T.double().cpu()
        return max(float(torch.linalg.norm(lie.sim3_rel(T[0], T[k]) - lie.sim3_rel(T_true[0], T_true[k])))
                   for k in range(1, n_poses))

    before, after = rel_pose_err(T_init), rel_pose_err(T_new)
    out.update(edge_parts=len(mesh.edge_parts(E, placement)), ba_err_before=before, ba_err_after=after)
    if not after < 0.2 * before:
        raise AssertionError(f"BA did not converge toward the truth: {before:.4f} -> {after:.4f}")

    # 4) overlap: the tracker keeps slot 0, the backend decodes on the rest
    if n >= 2:
        ov = mesh.default_placement("overlap", devices)
        if 0 in ov.backend_slots:
            raise AssertionError(f"overlap put the tracker's slot 0 in the backend's slots {ov.backend_slots}")
        reps = mesh.backend_replicas(model, ov)
        nb = 2 * ov.dp
        Xb = decode_symmetric_split(reps, ov, feat()[:nb], pos[:nb], feat()[:nb], pos[:nb], (H, W))[0]
        X11t, X21t, D11t, D21t, idx_t, int_t = oracle_match_world(1)
        t_idx, t_valid = matching.match(*(torch.from_numpy(a).to(ov.tracker) for a in (X11t, X21t, D11t, D21t)),
                                        None, **MATCH_KW)
        _, corr_t = _match_scores(t_idx, t_valid, idx_t, int_t)
        if not bool(torch.isfinite(Xb).all()):
            raise AssertionError("overlap: non-finite backend decode")
        if not corr_t > 0.98:
            raise AssertionError(f"overlap: the tracker's matcher is wrong: {corr_t:.4f}")
        out["overlap"] = dict(backend_slots=list(ov.backend_slots),
                              dp=ov.dp, tp=ov.tp, tracker_correct=corr_t)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="device slots")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = run(args.n, args.device)
    print(json.dumps(dict(out, ok=True)))
    return out


if __name__ == "__main__":
    main()
