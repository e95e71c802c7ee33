"""Scale-only pose graph: align VO translation deltas to wheel odometry.

Behavioral spec: ``mast3r_slam/pgo.py`` — ``PoseGraph`` (:130-278) with the
default ``OdomResidualScaleOnly`` residual (:26-79): one global scalar ``s``
minimizing ``sum_i || s * t(T_i^-1 T_{i+1}) - t(O_i^-1 O_{i+1}) ||^2`` over
consecutive frame pairs, where T are VO poses and O odometry poses. The JAX
package's ``slam/pgo.py`` is the reference of this port.

The problem is linear in ``s``, so it is solved in closed form, ``s =
<dt_vo, dt_odom> / <dt_vo, dt_vo>``: a few tensor ops over the ring, no host
fetch (``ok`` stays a device bool). The reference's final per-frame scale
smoothing multiplies every frame's scale by ``s``, which is applied
directly.

The ring is a small dataclass of device tensors written IN PLACE, with the
frame count a host int (the host decides every append), like the keyframe
store (:mod:`.frame`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import lie


@dataclasses.dataclass
class PoseGraphState:
    """Ring buffer of frame VO poses + odometry poses (pgo.py:140-146)."""

    Twc: torch.Tensor  # (B, 7) SE3 frame poses (scale stripped)
    Todom: torch.Tensor  # (B, 7) SE3 odometry poses
    scale: torch.Tensor  # (B, 1) per-frame smoothed scale
    n_total: int = 0  # frames ever added

    @property
    def capacity(self) -> int:
        return self.Twc.shape[0]


def make_pose_graph(buffer_size: int = 300, dtype=torch.float32, device="cpu") -> PoseGraphState:
    ident = lie.se3_identity((buffer_size,), dtype=dtype, device=device)
    return PoseGraphState(Twc=ident, Todom=ident.clone(),
                          scale=torch.ones((buffer_size, 1), dtype=dtype, device=device))


def pgo_add_frame(state: PoseGraphState, T_WC_sim3, odom_se3) -> PoseGraphState:
    """Append the frame pose (+ odometry pose) to the ring in place
    (pgo.py:173-185). ``T_WC_sim3`` (8,) and ``odom_se3`` (7,): tensors or
    arrays, cast to the ring's type on its device."""
    slot = state.n_total % state.capacity
    T = torch.as_tensor(T_WC_sim3).to(state.Twc.device, state.Twc.dtype)
    state.Twc[slot] = T[:7]
    state.Todom[slot] = torch.as_tensor(odom_se3).to(state.Todom.device, state.Todom.dtype)[:7]
    state.scale[slot, 0] = T[7]
    state.n_total += 1
    return state


def pgo_optimize(state: PoseGraphState):
    """Solve for the global VO-to-odometry scale (pgo.py:222-278).

    Returns (state, s, ok): ``s`` a 0-d tensor (1 while not ok), ``ok`` a
    0-d bool tensor on the ring's device. Consecutive deltas beyond the live
    window are masked; it needs more than 10 frames, like the reference
    (:226-227). With a full ring the slot order mixes the wrap point into one
    delta, as in the reference (1 of 300). The per-frame scales are set to
    ``s`` in place where ok."""
    n = min(state.n_total, state.capacity)
    B = state.capacity
    dT_vo = lie.se3_mul(lie.se3_inv(state.Twc[:-1]), state.Twc[1:])
    dT_od = lie.se3_mul(lie.se3_inv(state.Todom[:-1]), state.Todom[1:])
    t_vo, t_od = dT_vo[..., :3], dT_od[..., :3]

    valid = (torch.arange(B - 1, device=t_vo.device) + 1) < n
    w = valid.to(t_vo.dtype)[:, None]
    num = torch.sum(w * t_vo * t_od)
    den = torch.sum(w * t_vo * t_vo)
    ok = (den > 1e-12) & (state.n_total > 10)
    s = torch.where(ok, num / torch.clamp(den, min=1e-12), torch.ones_like(num))
    state.scale.copy_(torch.where(ok, s.expand_as(state.scale), state.scale))
    return state, s, ok


def apply_pgo_scale_(T_WC: torch.Tensor, n_size: int, s: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Write the map gauge ``g = 1 / s_pgo`` into every live keyframe's
    Sim(3) scale channel, in place, where ``ok`` (the reference's
    post-optimize write-back, tracker.py:347-353 + pgo.py:195-202).

    Convention (the JAX package's ``_apply_pgo_scale``, a deliberate
    divergence from the reference): the scale channel stores the map gauge,
    world units per metric unit, the convention of the BA odometry residual
    (``t_pred = (1/s_j) Ri^T (tj - ti)``), so metric translation = t / s.
    The PGO solves s_pgo = metric per world unit, hence ``1 / s_pgo``.
    Conditional on the device: no host fetch, a no-op while ``ok`` is
    False. ``n_size`` live slots (the ring's host count)."""
    g = 1.0 / torch.clamp(s.to(T_WC.dtype), min=1e-8)
    live = torch.arange(T_WC.shape[0], device=T_WC.device) < n_size
    T_WC[:, 7] = torch.where(ok & live, g, T_WC[:, 7])
    return T_WC


def pgo_optimize_full(Twc, Twc_prior_inv, Todom_inv, prior_weight, odom_weight, lc_edges, lc_T,
                      lc_active, iters: int = 10):
    """Full Sim(3) pose-graph optimization (the reference's ``OdomResidual``
    variant, pgo.py:82-128, unused by its default config but part of the
    API): every pose is optimized so that consecutive deltas agree with both
    the VO prior and the odometry measurement, plus optional loop-closure
    terms.

    Residual per consecutive pair i:
        r_i = w_p * log((T_i^-1 T_{i+1}) * Twc_prior_inv_i)
            + w_o * log((T_i^-1 T_{i+1}) * Todom_inv_i)
    Loop-closure rows ``log((T_a^-1 T_b) * T_lc)`` per active edge are added
    into the row of their source pose, as the reference's broadcast add.

    Damped Gauss-Newton on the left tangent of every pose, all in f64 (the
    BA's solve type; nothing pins a pose, so the damping alone holds the
    gauge and an f32 solve would wander along it): the Jacobian by
    forward-mode AD (``torch.func.jacfwd``) of the residual, the damped
    normal equations Cholesky-solved; a step is kept only where it lowers
    the cost. Returns the poses in their input type.

    Args: Twc (N, 8) Sim3; *_inv (N-1, 8) Sim3; weights (N-1, 7) or
    scalars; lc_edges (L, 2) int; lc_T (L, 8); lc_active (L,) bool.
    Returns (Twc_new, final_cost)."""
    N = Twc.shape[0]
    dtype = Twc.dtype
    f64 = lambda x: torch.as_tensor(x, device=Twc.device).to(torch.float64)  # noqa: E731
    Twc, Twc_prior_inv, Todom_inv, lc_T = f64(Twc), f64(Twc_prior_inv), f64(Todom_inv), f64(lc_T)
    prior_weight, odom_weight = f64(prior_weight), f64(odom_weight)
    src = torch.clamp(lc_edges[:, 0].long(), 0, N - 2)
    a_idx, b_idx = lc_edges[:, 0].long(), lc_edges[:, 1].long()
    lc_w = lc_active.to(torch.float64)[:, None]

    def residual(xi_flat):
        T = lie.sim3_retr(Twc, xi_flat.reshape(N, 7))
        dT = lie.sim3_mul(lie.sim3_inv(T[:-1]), T[1:])
        r_prior = lie.sim3_log(lie.sim3_mul(dT, Twc_prior_inv))
        r_odom = lie.sim3_log(lie.sim3_mul(dT, Todom_inv))
        r = r_prior * prior_weight + r_odom * odom_weight
        dlc = lie.sim3_mul(lie.sim3_inv(T[a_idx]), T[b_idx])
        r_lc = lie.sim3_log(lie.sim3_mul(dlc, lc_T)) * lc_w
        return r.index_add(0, src, r_lc).reshape(-1)

    jac = torch.func.jacfwd(residual)
    eye = torch.eye(N * 7, dtype=torch.float64, device=Twc.device)
    xi = torch.zeros((N * 7,), dtype=torch.float64, device=Twc.device)
    lam = torch.ones((), dtype=torch.float64, device=Twc.device) * 1e-6
    cost = None
    for _ in range(iters):
        r = residual(xi)
        J = jac(xi)  # ((N-1)*7, N*7)
        H = J.T @ J + lam * eye
        g = -(J.T @ r)
        L, info = torch.linalg.cholesky_ex(H)
        ok = (info == 0) & torch.all(torch.isfinite(L))
        dx = torch.cholesky_solve(g[:, None], torch.where(ok, L, eye))[:, 0]
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        cost = torch.sum(residual(xi + dx) ** 2)
        accept = cost < torch.sum(r ** 2)
        xi = torch.where(accept, xi + dx, xi)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return lie.sim3_retr(Twc, xi.reshape(N, 7)).to(dtype), cost
