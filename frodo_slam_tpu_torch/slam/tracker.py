"""Frame-to-keyframe tracker: dense matching + Sim(3) Gauss-Newton.

Behavioral spec: ``mast3r_slam/tracker.py`` — ``FrameTracker.track``
(:161-368), ``opt_pose_ray_dist_sim3`` (:414-465), ``opt_pose_calib_sim3``
(:467-517), ``solve`` (:397-412), ``get_points_poses`` (:370-395).

Like the JAX package, all HW points are kept and invalid ones get zero
information weight (the normal equations equal the reference's gathered
subset, shapes stay static). Two decisions wait on the host, where the JAX
package branches on the device: the GN loop checks its early exit after each
iteration (one small fetch per iteration; the result equals the JAX
``lax.while_loop``), and the fnn fallback is entered only when the
projective match was too sparse (one fetch per frame when ``use_fnn``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops import lie, matching
from ..ops.fast_nn import fast_reciprocal_nns
from ..ops.geometry import (act_Sim3, constrain_points_to_ray, get_pixel_coords,
                            point_to_ray_dist, project_calib)
from ..ops.normal_eqs import ray_dist_drd_cols, reduce_sim3_system
from ..ops.robust import huber
from ..utils import spans
from . import frame as frame_mod
from . import inference as inference_mod
from .frame import Frame


class TrackingCfg(NamedTuple):
    """Static tracking parameters (config/base.yaml:18-38)."""

    min_match_frac: float = 0.1
    use_fnn: bool = False
    min_match_frac_fnn: float = 0.0008
    fnn_subsample: int = 8
    max_iters: int = 50
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber_k: float = 1.345
    match_frac_thresh: float = 0.333
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: float = -10.0
    depth_eps: float = 1e-6
    filtering_mode: str = "weighted_pointmap"
    filtering_score: str = "median"
    use_calib: bool = False


class TrackResult(NamedTuple):
    """Small per-frame result. ``flags`` packs the host-read scalars into ONE
    tensor so a single fetch serves the host control flow:
    [0] match_frac, [1] ok, [2] new_kf, [3:11] T_WCf, [11:19] T_CkCf,
    [19] used_fnn (the JAX package's layout).

    ``pair_half`` is the raw projective half of this frame's pair decode from
    BEFORE the fnn fallback, ``(idx_f2k (1, HW), valid_match_k (1, HW, 1),
    Qff (1, HW, 1), Qkf (1, HW, 1))``: the backend reuses it for the
    consecutive edge when the frame becomes a keyframe. It stays on the
    device and is read only then."""

    flags: torch.Tensor  # (20,) f32
    idx_f2k: torch.Tensor  # (1, HW) int32, warm-starts the next frame's matcher
    pair_half: tuple


# ---------------------------------------------------------------------------
# dense 7x7 Gauss-Newton (tracker.py:397-412 solve + 414-465 loop)
# ---------------------------------------------------------------------------

def _safe_cholesky(H: torch.Tensor):
    """Cholesky that never raises: a non-PD or non-finite H gives ok=False
    and the identity in place of L (JAX's cholesky returns NaN there)."""
    L, info = torch.linalg.cholesky_ex(H)
    ok = (info == 0) & torch.all(torch.isfinite(L))
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return torch.where(ok, L, eye), ok


def _gn_loop_fused(cfg: TrackingCfg, T_init: torch.Tensor, hg_fn):
    """GN driver over a fused step ``hg_fn(T) -> (H (7,7), g (7,), cost)``
    with the convergence test of nonlinear_optimizer.py:5-25. Stops after
    the iteration that converged or failed, like the JAX while_loop."""
    T = T_init
    old_cost = torch.full((), float("inf"), dtype=T.dtype, device=T.device)
    ok_all = torch.ones((), dtype=torch.bool, device=T.device)
    step = -1
    for step in range(cfg.max_iters):
        H, g, new_cost = hg_fn(T)
        L, ok = _safe_cholesky(H)
        tau = torch.cholesky_solve(g[:, None], L)[:, 0]
        tau = torch.where(ok, tau, torch.zeros_like(tau)).to(T.dtype)
        new_cost = new_cost.to(old_cost.dtype)
        T = lie.sim3_retr(T, tau)
        rel = torch.abs(new_cost - old_cost) / torch.clamp(new_cost, min=1e-12)
        dn = torch.linalg.norm(tau)
        converged = ((rel < cfg.rel_error) | (dn < cfg.delta_norm)) & (step > 0)
        old_cost = new_cost
        ok_all = ok_all & ok
        if bool(converged | ~ok_all):  # the loop's one host fetch per iteration
            break
    spans.count("tracker.gn_iters", step + 1)
    return T, ok_all


def opt_pose_ray_dist_sim3(cfg: TrackingCfg, Xf, Xk, T_WCf, T_WCk, Qk, valid):
    """Uncalibrated ray+distance GN (tracker.py:414-465).

    Xf: (HW, 3) frame points gathered at kf pixels; Xk: (HW, 3) kf points;
    Qk: (HW, 1); valid: (HW, 1) bool — folded into the weights.
    """
    sqrtQ = torch.sqrt(Qk) * valid.to(Qk.dtype)
    sqrt_info = torch.cat([(sqrtQ / cfg.sigma_ray).expand(-1, 3), sqrtQ / cfg.sigma_dist], dim=-1)
    info = sqrt_info * sqrt_info
    rd_k = point_to_ray_dist(Xk)

    def hg(T_CkCf):
        pW = lie.sim3_act(T_CkCf, Xf)
        d = torch.linalg.norm(pW, dim=-1, keepdim=True)
        r = pW / d
        err = rd_k - torch.cat([r, d], dim=-1)  # (n, 4)
        w = info * huber(sqrt_info * err, cfg.huber_k)  # (n, 4)
        H, g, cost_sum = reduce_sim3_system(
            ray_dist_drd_cols(r, d[:, 0]),
            [w[:, i] for i in range(4)],
            [err[:, i] for i in range(4)],
            pW,
        )
        return H, g, 0.5 * cost_sum

    T_CkCf0 = lie.sim3_rel(T_WCk, T_WCf)
    T_CkCf, ok = _gn_loop_fused(cfg, T_CkCf0, hg)
    return lie.sim3_mul(T_WCk, T_CkCf), T_CkCf, ok


def opt_pose_calib_sim3(cfg: TrackingCfg, Xf, Xk, T_WCf, T_WCk, Qk, valid, meas_k,
                        valid_meas_k, K, img_size):
    """Calibrated pixel + log-depth GN (tracker.py:467-517).

    Xf: (HW, 3) ray-constrained frame points gathered at kf pixels; Xk the
    kf points; meas_k (HW, 3) [u, v, log z] of the kf; K (3, 3). Each
    iteration whitens, Huber-weights and reduces ``A^T A`` and ``-A^T b``
    over the (HW, 3, 7) Jacobian (the JAX package's ``_solve_step``)."""
    sqrtQ = torch.sqrt(Qk) * valid.to(Qk.dtype)
    sqrt_info = torch.cat([(sqrtQ / cfg.sigma_pixel).expand(-1, 2), sqrtQ / cfg.sigma_depth], dim=-1)

    def hg(T_CkCf):
        Xf_Ck, dX_dT = act_Sim3(T_CkCf, Xf, jacobian=True)
        pz, dpz_dX, valid_proj = project_calib(
            Xf_Ck, K, img_size, jacobian=True, border=cfg.pixel_border, z_eps=cfg.depth_eps)
        si = (valid_proj & valid_meas_k).to(sqrt_info.dtype) * sqrt_info
        r = meas_k - pz
        J = -(dpz_dX @ dX_dT)  # (n, 3, 7)
        rsi = si * torch.sqrt(huber(si * r, cfg.huber_k))
        A = (rsi[..., None] * J).reshape(-1, 7)
        b = (rsi * r).reshape(-1)
        return A.T @ A, -(A.T @ b), 0.5 * torch.dot(b, b)

    T_CkCf0 = lie.sim3_rel(T_WCk, T_WCf)
    T_CkCf, ok = _gn_loop_fused(cfg, T_CkCf0, hg)
    return lie.sim3_mul(T_WCk, T_CkCf), T_CkCf, ok


# ---------------------------------------------------------------------------
# full tracking step
# ---------------------------------------------------------------------------

@torch.no_grad()
def track_step(
    model,
    cfg: TrackingCfg,
    match_cfg,
    img_hw,
    kf: Frame,
    frame: Frame,
    idx_f2k_init: Optional[torch.Tensor],
    K: Optional[torch.Tensor] = None,
):
    """One tracked frame (FrameTracker.track, tracker.py:161-368): pair
    decode, matcher (prep | LM | occlusion gate + refine + score gate), then
    :func:`track_step_post`. Returns (kf_next, fused_frame, TrackResult).
    ``K`` (3, 3): the calibration, needed when ``cfg.use_calib``."""
    with spans.span("tracker.track_step"):
        res11, res21 = inference_mod.decode_asymmetric(
            model, frame.feat, frame.pos, kf.feat, kf.pos, img_hw)
        cold_cfg, warm_cfg = matching.split_match_cfg(dict(match_cfg))
        mc = dict(warm_cfg if idx_f2k_init is not None else cold_cfg)
        X11, X21 = res11["pts3d"], res21["pts3d"]
        rays, tgt, p0 = matching.prep_for_iter_proj(X11, X21, idx_f2k_init)
        p1f, converged = matching.iter_proj(
            rays, tgt, p0,
            max_iter=mc.get("max_iter", 10),
            lambda_init=mc.get("lambda_init", 1e-8),
            cost_thresh=mc.get("convergence_thresh", 1e-6),
        )
        idx_f2k, valid_match_k = matching._match_post_project(
            X11, X21, res11["desc"], res21["desc"], p1f, converged,
            dist_thresh=mc.get("dist_thresh", 1e-1),
            radius=mc.get("radius", 3),
            dilation_max=mc.get("dilation_max", 5),
            ft_matching_threshold=mc.get("ft_matching_threshold", 0.8),
            refine_impl=mc.get("refine_impl", "auto"),
        )
        return track_step_post(cfg, img_hw, kf, frame, res11, res21, idx_f2k, valid_match_k, K)


@torch.no_grad()
def track_step_post(
    cfg: TrackingCfg,
    img_hw,
    kf: Frame,
    frame: Frame,
    res11,
    res21,
    idx_f2k_b: torch.Tensor,  # (1, HW) raw projective match
    valid_match_k_b: torch.Tensor,  # (1, HW, 1)
    K: Optional[torch.Tensor] = None,
):
    """Everything after decode+match: gating, fnn fallback, GN, pointmap
    fusion, new-KF select (tracker.py:177-368)."""
    if cfg.use_calib and K is None:
        raise ValueError("calibrated tracking needs K")
    h, w = img_hw
    hw = h * w
    out = inference_mod.asym_out(res11, res21, idx_f2k_b, valid_match_k_b, img_hw)

    # fuse the frame's fresh pointmap (tracker.py:177)
    Xn, Cn, Nn, Un = frame_mod.update_pointmap(
        frame.X_canon, frame.C, frame.N, frame.N_updates, out.Xff, out.Cff,
        cfg.filtering_mode, cfg.filtering_score,
    )
    frame = dataclasses.replace(frame, X_canon=Xn, C=Cn, N=Nn, N_updates=Un)

    idx_f2k = out.idx_f2k[0]  # (HW,)
    valid_match_k = out.valid_match_k[0]  # (HW, 1)

    Cf_avg = frame.average_conf()
    Ck_avg = kf.average_conf()
    # one row gather for everything indexed by idx_f2k
    frame_cols = torch.cat([out.Qff, Cf_avg, frame.X_canon], dim=-1)  # (HW, 5)

    def gates(idx, valid_m):
        g = frame_cols[idx.long().clamp(0, hw - 1)]  # clamped read, as JAX indexing
        Qk = torch.sqrt(g[:, 0:1] * out.Qkf)
        Cf = g[:, 1:2]
        v_opt = valid_m & (Cf > cfg.C_conf) & (Ck_avg > cfg.C_conf) & (Qk > cfg.Q_conf)
        v_kf = valid_m & (Qk > cfg.Q_conf)
        return g, Qk, v_opt, v_kf, torch.mean(v_opt.float())

    gathered, Qk, valid_opt, valid_kf, match_frac = gates(idx_f2k, valid_match_k)

    used_fnn = torch.zeros((), dtype=torch.bool, device=idx_f2k.device)
    if cfg.use_fnn:
        # descriptor reciprocal-NN fallback when projective matching is too
        # sparse (tracker.py:222-272)
        fallback = match_frac < cfg.min_match_frac
        if bool(fallback):
            xy1, xy2, conv = fast_reciprocal_nns(out.Dff, out.Dkf, h, w, subsample=cfg.fnn_subsample)
            # slot hw is the drop sentinel for unconverged seeds; duplicate
            # targets keep an unspecified writer (as the JAX scatter)
            tgt = torch.where(conv, xy2.long(), hw)
            idx_f2k = torch.zeros(hw + 1, dtype=torch.int32, device=tgt.device).scatter_(0, tgt, xy1)[:hw]
            valid_match_k = torch.zeros(hw + 1, dtype=torch.bool, device=tgt.device).scatter_(
                0, tgt, torch.ones_like(conv))[:hw, None]
            gathered, Qk, valid_opt, valid_kf, match_frac = gates(idx_f2k, valid_match_k)
        used_fnn = fallback

    accept_thresh = torch.where(used_fnn, cfg.min_match_frac_fnn, cfg.min_match_frac)

    # points & poses (tracker.py:370-395)
    if cfg.use_calib:
        Xf_all = constrain_points_to_ray(img_hw, frame.X_canon[None], K)[0]
        Xk = constrain_points_to_ray(img_hw, kf.X_canon[None], K)[0]
        zk = Xk[..., 2:3]
        valid_meas_k = zk > cfg.depth_eps
        logz = torch.where(valid_meas_k, torch.log(torch.where(valid_meas_k, zk, 1.0)), 0.0)
        uv_k = get_pixel_coords(img_hw, dtype=Xk.dtype, device=Xk.device)
        meas_k = torch.where(valid_meas_k, torch.cat([uv_k, logz], dim=-1), 0.0)
        Xf = Xf_all[idx_f2k.long().clamp(0, hw - 1)]
        T_WCf_new, T_CkCf, ok = opt_pose_calib_sim3(
            cfg, Xf, Xk, frame.T_WC, kf.T_WC, Qk, valid_opt, meas_k, valid_meas_k, K, img_hw)
    else:
        Xf = gathered[:, 2:5]  # frame.X_canon rows, from the fused gather
        T_WCf_new, T_CkCf, ok = opt_pose_ray_dist_sim3(
            cfg, Xf, kf.X_canon, frame.T_WC, kf.T_WC, Qk, valid_opt)

    # reject the frame wholesale if matching was too sparse or GN failed
    accept = (match_frac >= accept_thresh) & ok
    T_WCf_final = torch.where(accept, T_WCf_new, frame.T_WC)
    frame = dataclasses.replace(frame, T_WC=T_WCf_final)

    # keyframe pointmap update: Xkk = T_CkCf . Xkf (tracker.py:325-328),
    # masked by acceptance
    Xkk = lie.sim3_act(T_CkCf, out.Xkf)
    Xu, Cu, Nu, Uu = frame_mod.update_pointmap(
        kf.X_canon, kf.C, kf.N, kf.N_updates, Xkk, out.Ckf,
        cfg.filtering_mode, cfg.filtering_score,
    )
    kf_upd = dataclasses.replace(
        kf,
        X_canon=torch.where(accept, Xu, kf.X_canon),
        C=torch.where(accept, Cu, kf.C),
        N=torch.where(accept, Nu, kf.N),
        N_updates=torch.where(accept, Uu, kf.N_updates),
    )

    # new-KF decision: unique valid matches / HW (tracker.py:330-331), by sort
    sorted_idx = torch.sort(torch.where(valid_kf[:, 0], idx_f2k, hw)).values
    firsts = torch.cat(
        [sorted_idx[:1] < hw, (sorted_idx[1:] != sorted_idx[:-1]) & (sorted_idx[1:] < hw)]
    )
    unique_frac = torch.sum(firsts.float()) / hw
    new_kf = (unique_frac < cfg.match_frac_thresh) & accept

    # active keyframe for the next frame, selected on the device
    kf_next = frame_mod.where_frame(new_kf, frame, kf_upd)

    flags = torch.cat(
        [
            torch.stack([match_frac, accept.float(), new_kf.float()]),
            T_WCf_final.float(),
            T_CkCf.float(),
            used_fnn.float()[None],
        ]
    )
    return kf_next, frame, TrackResult(
        flags=flags, idx_f2k=idx_f2k[None],
        pair_half=(idx_f2k_b, valid_match_k_b, out.Qff[None], out.Qkf[None]))
