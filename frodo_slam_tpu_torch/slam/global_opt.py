"""Backend global bundle adjustment: Sim(3) ray alignment over keyframes.

Behavioral spec: ``mast3r_slam/global_opt.py`` ``FactorGraph`` with the
upstream per-edge confidence storage (``global_opt_bk0.py:107-147``); the
ray-alignment residual of ``gn_kernels.cu:576-907``; the odometry SE(3)-log
constraint of ``gn_kernels.cu:1106-1290`` (with an exact Jacobian); the scale
prior of ``gn_kernels.cu:1716-1790``; the outer loop
``gauss_newton_rays_odom_cuda`` (:1792-1934); the calibrated pixel +
log-depth residual of ``calib_proj_kernel`` (:2295-2608) with its outer loop
``gauss_newton_calib_cuda`` (:2610-2702); the 3-D point alignment of
``point_align_kernel`` (:1936-2204) with ``gauss_newton_points_cuda``
(:2206-2293), which only the disabled local mapper drives. The JAX package's
``slam/global_opt.py`` is the reference of this port.

Since ``Ji = -Jj``, each directed edge's 14x14 Hessian is
``[[A, -A], [-A, A]]`` with ``A = M^T B M``, where B is the 7x7 Gram of the
relative-pose Jacobian and ``M = AdjInv(T_i)``: only B and its gradient are
reduced over the points, by a Hopper kernel (its plain version on a CPU
tensor): the ray edges by :mod:`..ops.ba_reduce_kernel`, the calibrated
edges, which JAX reduces with XLA, by :mod:`..ops.calib_edge_kernel`. Each
residual (:func:`_ray_residual`, :func:`_calib_residual`,
:func:`_point_residual`) hands back B and g through one seam,
:func:`_edge_systems`, and the GN step (:func:`_gn_step`) applies M to them
(:func:`_adj_wrap`). The dense (7P x 7P) system is
assembled on the device and Cholesky-solved there: in f64 by default (the
reference's double Eigen solve, and the JAX package under x64), or, with
``BAConfig.solve_f64`` off (``tpu.x64_eval: false``, the real-time
configurations), in f32 with a larger damping and one step of iterative
refinement, as the JAX package solves with x64 off.

The GN loop stops early on the host: each iteration fetches one bool
(``|dx| >= delta_norm``), so a solve makes exactly one edge-kernel launch per
iteration it runs (one per edge part under a placement), and its result is
the JAX ``lax.while_loop``'s. On a card the step after the residual (the
wrap, the assembly, the damped Cholesky, the retraction: some 250 small
launches) is one CUDA graph replay an iteration, where the window allows it
(:func:`_graphs_engage`); the eager step is the CPU's path and the graph's
twin. While a profiler records, a solve adds its iterations, replays and
captures to the ``backend.solve_iters``, ``backend.step_replays`` and
``backend.step_captures`` counters of the span open around it, and the
calibrated solve its kernel launches to ``backend.calib_launches``.

Under a :class:`~..parallel.mesh.Placement` the edge rows are split over the
backend's devices (:func:`~..parallel.mesh.edge_parts`, the JAX package's
``_build_edge_systems``): each part's rows and the window's pointmaps are
copied to its device once a solve, only the poses (P x 8) move each
iteration, and the (E, 7, 7) / (E, 7) systems come back to the solve device
in row order, where the assembly and the Cholesky run once.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from functools import partial
from typing import NamedTuple, Optional

import torch

from ..ops import calib_edge_kernel, lie
from ..ops.ba_reduce_kernel import ray_edge_systems
from ..ops.calib_edge_kernel import calib_edge_systems
from ..ops.normal_eqs import edge_chunks, reduce_rel_systems, safe_cholesky
from ..ops.robust import huber
from ..parallel.mesh import edge_parts
from ..utils import spans


class BAConfig(NamedTuple):
    """Static BA parameters (config/base.yaml ``local_opt``)."""

    max_iters: int = 10
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    C_conf: float = 0.0
    Q_conf: float = 1.5
    delta_norm: float = 1e-8
    pin: int = 1
    sigma_odom_t: float = 1e-3
    sigma_odom_r: float = 1e-3
    sigma_scale_prior: float = 0.1
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: float = -10.0
    depth_eps: float = 1e-6
    sigma_point: float = 0.05  # point alignment (config/base.yaml:33,54)
    # ``tpu.x64_eval``: the window solve in f64 (the reference's double Eigen
    # solve), else in f32 with damping and one refinement step
    solve_f64: bool = True


class Edges(NamedTuple):
    """Padded directed visual edges (two rows per keyframe pair).

    ii/jj index into the window pose arrays. ``idx``: for each pixel k of
    frame jj, the matched linear pixel in frame ii. ``valid`` folds the match
    validity and the Q gate computed at insertion; ``Q`` is the combined
    confidence sqrt(Q_ii[idx] * Q_ji). ``XiT``/``w0`` cache the edge's
    pose-independent solver inputs (the matched points X[ii][idx],
    channel-major, and the gate/confidence sqrt-weight), built once at
    insertion; ``None`` makes the solver compute them (:func:`_edges_pre`).
    """

    ii: torch.Tensor  # (E,) int32
    jj: torch.Tensor  # (E,) int32
    idx: torch.Tensor  # (E, HW) int32
    valid: torch.Tensor  # (E, HW) bool
    Q: torch.Tensor  # (E, HW) f32
    active: torch.Tensor  # (E,) bool
    XiT: Optional[torch.Tensor] = None  # (E, 3, HW) f32
    w0: Optional[torch.Tensor] = None  # (E, HW) f32


class OdomEdges(NamedTuple):
    ii: torch.Tensor  # (O,) int32
    jj: torch.Tensor  # (O,) int32
    delta_T: torch.Tensor  # (O, 7) SE3 measured T_ij
    active: torch.Tensor  # (O,) bool


def empty_edges(e_max: int, hw: int, with_cache: bool = True, device="cpu") -> Edges:
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return Edges(
        ii=z(e_max, dt=torch.int32), jj=z(e_max, dt=torch.int32),
        idx=z(e_max, hw, dt=torch.int32), valid=z(e_max, hw, dt=torch.bool),
        Q=z(e_max, hw), active=z(e_max, dt=torch.bool),
        XiT=z(e_max, 3, hw) if with_cache else None,
        w0=z(e_max, hw) if with_cache else None,
    )


def empty_odom_edges(o_max: int, device="cpu") -> OdomEdges:
    return OdomEdges(
        ii=torch.zeros((o_max,), dtype=torch.int32, device=device),
        jj=torch.zeros((o_max,), dtype=torch.int32, device=device),
        delta_T=lie.se3_identity((o_max,), device=device),
        active=torch.zeros((o_max,), dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# per-edge Hessian blocks
# ---------------------------------------------------------------------------

def _adj_inv_matrix(T: torch.Tensor) -> torch.Tensor:
    """(..., 7, 7) matrix M with ``row @ M == sim3_apply_adj_inv(T, row)``."""
    eye = torch.eye(7, dtype=T.dtype, device=T.device)
    return lie.sim3_apply_adj_inv(T[..., None, :], eye)


def _edges_pre(cfg: BAConfig, X, C, edges: Edges):
    """Pose-independent per-edge inputs when the edge store carries no cache:
    the matched-point gather and the combined gate. Returns (XiT (E, 3, HW),
    w0 (E, HW)) with w0 = [valid & gates] * sqrt(Q); ``active`` is not folded
    in (the solver masks whole edges)."""
    E, HW = edges.idx.shape
    XC = torch.cat([X, C], dim=-1).reshape(-1, 4)  # one gather, not two
    rows = XC[(edges.ii.long()[:, None] * HW + edges.idx.long()).reshape(-1)].reshape(E, HW, 4)
    Xi, Ci = rows[..., :3], rows[..., 3]
    Cj = C[edges.jj.long()][..., 0]
    ok = edges.valid & (edges.Q > cfg.Q_conf) & (Ci > cfg.C_conf) & (Cj > cfg.C_conf)
    w0 = ok.to(X.dtype) * torch.sqrt(edges.Q).to(X.dtype)
    return Xi.transpose(1, 2), w0


def _edge_cache(cfg: BAConfig, X, C, edges: Edges):
    """(XiT, w0): the cached pair when the edge store has it, else
    :func:`_edges_pre`."""
    if edges.XiT is not None:
        return edges.XiT, edges.w0
    return _edges_pre(cfg, X, C, edges)


def _xj_rows(X, jj):
    """Frame j's points of each edge row, channel-major (E, 3, HW): the
    point residual's one copy a solve. The ray and calibrated residuals make
    none: their kernels read X through ``jj``."""
    return X.transpose(1, 2)[jj.long()]


def _ray_residual(cfg: BAConfig, T, ii, jj, XiT, w0, active, X, n_active=None):
    """Ray edges (gn_kernels.cu:576-907) -> (B (E, 7, 7), g (E, 7)) through
    :func:`ray_edge_systems` (the kernel on the card, its plain version on
    the CPU): ONE launch reduces every live edge, Xj read from the window's
    pointmaps X (P, HW, 3) through ``jj``; each edge's relative [sR | t] is
    plain tensor code (it lies outside the TPU kernel too)."""
    dt = XiT.dtype
    scal = lie.sim3_rel_sRt(T[ii.long()], T[jj.long()]).to(dt)
    return ray_edge_systems(scal, XiT, w0.to(dt), X.to(dt), jj, active,
                            sigma_ray=float(cfg.sigma_ray), sigma_dist=float(cfg.sigma_dist),
                            n_active=n_active)


def _calib_residual(cfg: BAConfig, img_hw, T, ii, jj, idx, XiT, w0, active, X, K, n_active=None):
    """Calibrated pixel + log-depth edges (calib_proj_kernel,
    gn_kernels.cu:2295-2608) -> (B (E, 7, 7), g (E, 7)) through
    :func:`calib_edge_systems` (the kernel on the card, its plain version on
    the CPU): ONE launch reduces every live edge from the window poses, each
    edge's relative Sim(3) formed inside, Xj read through ``jj``. Residual
    [u - u_meas, v - v_meas, log z_j - log z_i] with pinhole K (3, 3), where
    (u_meas, v_meas) is the matched pixel ``idx`` in frame i. Xi enters
    through its depth alone, which ray-constraining preserves: so the cached
    insertion-time ``XiT`` serves a solve on constrained pointmaps (the JAX
    package's invariant)."""
    dt = XiT.dtype
    intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(dt)
    return calib_edge_systems(T.to(dt), intr, XiT, w0.to(dt), X.to(dt), ii, jj, idx, active, img_hw=img_hw,
                              sigma_pixel=float(cfg.sigma_pixel), sigma_depth=float(cfg.sigma_depth),
                              pixel_border=float(cfg.pixel_border), depth_eps=float(cfg.depth_eps),
                              n_active=n_active)


def _point_residual(cfg: BAConfig, T, ii, jj, XiT, w0, XjT, n_active=None):
    """3-D point-alignment edges (point_align_kernel, gn_kernels.cu:1936-2204)
    -> (B (E, 7, 7), g (E, 7)): residual ``Sim3(T_ij) Xj - Xi`` with D = I,
    Huber-weighted with sqrt-weight ``w0 / sigma_point``. Plain tensor code
    over chunks of edges, like the calibrated edges' plain version (the JAX
    package reduces it with XLA too)."""
    E, _, N = XiT.shape
    dt = XiT.dtype
    Tij = lie.sim3_rel(T[ii.long()], T[jj.long()]).to(dt)
    B = torch.empty((E, 7, 7), dtype=dt, device=XiT.device)
    g = torch.empty((E, 7), dtype=dt, device=XiT.device)
    eye = torch.eye(3, dtype=dt, device=XiT.device)
    for sl in edge_chunks(E, N):
        P = lie.sim3_act(Tij[sl, None, :], XjT[sl].transpose(1, 2))  # (c, N, 3) in frame i
        err = P - XiT[sl].transpose(1, 2)
        sqrt_w = (w0[sl] / cfg.sigma_point)[..., None].expand_as(err)
        w = huber(sqrt_w * err) * sqrt_w * sqrt_w
        B[sl], g[sl] = reduce_rel_systems(eye.expand(*err.shape, 3), w, err, P)
    return B, g


def _parts(E: int, device, placement):
    """The edge rows' (lo, hi, device) parts: :func:`edge_parts` under a
    placement, else one part on ``device``."""
    return [(0, E, device)] if placement is None else edge_parts(E, placement)


def _split(E: int, device, placement) -> bool:
    """Whether the rows leave ``device``: more than one part, or one
    elsewhere."""
    parts = _parts(E, device, placement)
    return len(parts) > 1 or parts[0][2] != device


def _edge_systems(residual, T_WC, ii, jj, rows, shared=(), n_active: Optional[int] = None,
                  placement=None):
    """``systems(T) -> (B (E, 7, 7), g (E, 7))`` on T_WC's device, each
    row's system in its edge's relative frame: the one seam of the three
    residuals, whose GN step (:func:`_gn_step`) then applies
    :func:`_adj_wrap`. ``residual(T, ii, jj, *rows, *shared, n_active=) ->
    (B, g)``. ``ii``, ``jj`` (E,) are taken as int32; ``rows`` are per-edge
    tensors, ``shared`` whole ones (the pointmaps, K). A placement splits
    the rows over its devices (:func:`edge_parts`; see the module
    docstring), each part on its device; without one there is one part.
    ``n_active`` (the live prefix as the host knows it; None: all) becomes
    each part's own live-row count, the kernels' sizing hint."""
    E, device = ii.shape[0], T_WC.device
    ii, jj = ii.to(torch.int32), jj.to(torch.int32)

    def make(lo, hi, d):
        live = None if n_active is None else max(0, min(n_active, hi) - lo)
        part = (tuple(t[lo:hi].to(d).contiguous() for t in (ii, jj, *rows))
                + tuple(t.to(d).contiguous() for t in shared))
        return lambda T: residual(T, *part, n_active=live)

    fns = [(make(lo, hi, d), d) for lo, hi, d in _parts(E, device, placement)]
    if not _split(E, device, placement):
        return fns[0][0]

    def systems(T):
        out = [fn(T.to(d)) for fn, d in fns]
        return (torch.cat([B.to(device) for B, _ in out]), torch.cat([g.to(device) for _, g in out]))

    return systems


def _adj_wrap(T, ii, B, g):
    """(A (E, 7, 7), gj (E, 7)) in T's type: M = AdjInv(T_i) takes each
    row's relative-frame (B, g) to A = M^T B M, gj = M^T g (in B's type)."""
    M = _adj_inv_matrix(T[ii.long()]).to(B.dtype)
    A = torch.einsum("eba,ebc,ecd->ead", M, B, M)
    gj = torch.einsum("eba,eb->ea", M, g)
    return A.to(T.dtype), gj.to(T.dtype)


# ---------------------------------------------------------------------------
# odometry factors
# ---------------------------------------------------------------------------

def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _odom_terms(Ti, Tj, delta_T):
    """The pieces of the odometry SE(3)-log residual (gn_kernels.cu:1144-1177)
    r = log_SE3(T_meas^-1 T_pred), with R_ij = Ri^T Rj and the
    scale-corrected t' = (1/s_j) Ri^T (tj - ti): ``Rm^T``, ``A = Rm^T Ri^T``,
    ``1/s_j`` (1e6 at s_j = 0), ``Rj``, ``t_err = A (1/s_j) (tj - ti) - Rm^T
    tm`` and ``R_err = A Rj``, with R = ``quat_to_R(q)`` as the residual uses
    it: for a quaternion off unit norm (|q|^2 = n; composing stored poses
    drifts it) that is ``n R(q/|q|) + (1 - n) I``, not a rotation."""
    RmT = lie.quat_to_R(delta_T[..., 3:7]).transpose(-1, -2)
    A = RmT @ lie.quat_to_R(lie.sim3_q(Ti)).transpose(-1, -2)
    Rj = lie.quat_to_R(lie.sim3_q(Tj))
    sj = lie.sim3_s(Tj)
    sj_inv = torch.where(sj == 0.0, 1e6, 1.0 / sj)
    t_err = _mv(A, sj_inv * (lie.sim3_t(Tj) - lie.sim3_t(Ti))) - _mv(RmT, delta_T[..., :3])
    return RmT, A, sj_inv, Rj, t_err, A @ Rj


def _jl_inv_coeffs(theta_sq):
    """``b`` of ``Jl^-1(phi) = I - Phi/2 + b Phi^2``, b = 1/theta^2 -
    (1 + cos theta) / (2 theta sin theta), and ``c = b'(theta) / theta``;
    their Taylor series below theta^2 = 0.1, where the closed forms cancel
    (truncation there < 1e-13)."""
    small = theta_sq < 0.1
    t2 = torch.where(small, 1.0, theta_sq)
    t = torch.sqrt(t2)
    sin, one_m_cos = torch.sin(t), 1.0 - torch.cos(t)
    s2, s4 = theta_sq, theta_sq * theta_sq
    b = torch.where(small, 1 / 12 + s2 / 720 + s4 / 30240 + s2 * s4 / 1209600,
                    1.0 / t2 - (2.0 - one_m_cos) / (2.0 * t * sin))
    c = torch.where(small, 1 / 360 + s2 / 7560 + s4 / 201600 + s2 * s4 / 5987520,
                    -2.0 / (t2 * t2) + (1.0 + sin / t) / (2.0 * t2 * one_m_cos))
    return b, c


def _rotation_log_jvp(R, dR, phi):
    """d phi for ``phi = so3_log(R_to_quat(R))`` along tangents ``dR`` (O, C,
    3, 3) at R (O, 3, 3), any 3x3 R (not only rotations): the selected
    Shepperd candidate c (:func:`lie.quat_candidates`) is linear in R, q = +-c / |c|, so dq = +-(dc - q
    (q . dc)) / |c|; the rotation it applies on the left, delta = 2 vec(dq
    q*), gives d phi = Jl^-1(phi) delta. Returns (O, 3, C)."""
    cands = lie.quat_candidates(R)
    best = lie.quat_candidate_index(cands)  # the candidate R_to_quat picks
    rows = torch.arange(R.shape[0], device=R.device)
    c = cands[rows, best]  # (O, 4)
    dc = lie.quat_candidates(dR, 0.0)[rows, :, best]  # (O, C, 4)
    norm = torch.linalg.norm(c, dim=-1, keepdim=True)
    q = c / norm
    sign = torch.where(q[:, 3:4] < 0, -1.0, 1.0).to(q.dtype)
    dq = sign[:, None] * (dc - q[:, None] * torch.sum(q[:, None] * dc, -1, keepdim=True)) / norm[:, None]
    delta = 2.0 * lie.quat_mul(dq, lie.quat_inv(sign * q)[:, None])[..., :3]  # (O, C, 3)
    b, _ = _jl_inv_coeffs(torch.sum(phi * phi, dim=-1)[:, None, None])
    Phi = lie.skew(phi)
    Jli = torch.eye(3, dtype=R.dtype, device=R.device) - 0.5 * Phi + b * (Phi @ Phi)
    return Jli @ delta.transpose(1, 2)


def _odom_jacobian(Ti, Tj, delta_T):
    """Residual r (O, 6) and its exact Jacobian J (O, 6, 14) under the
    solver's left retraction of (pose_i, pose_j), in closed form.

    At xi = 0 the retraction moves a pose by dt = tau + omega x t + sigma t,
    dq = omega q / 2 (|q| kept), ds = sigma s. With R(q) = n R^ + (1 - n) I
    (see :func:`_odom_terms`), dRj = [omega_j]x (Rj - (1 - n_j) I) and
    d(Ri^T) = -(Ri^T - (1 - n_i) I) [omega_i]x, which give d t_err and
    dR_err; :func:`_rotation_log_jvp` maps dR_err to d phi. With (rho, phi)
    = log_SE3(t_err, R_err), rho = Jl^-1(phi) t_err: d rho = Jl^-1(phi) d
    t_err + D d phi, D = d(Jl^-1(phi) t)/d phi = skew(t)/2 + b ((phi.t) I +
    phi t^T - 2 t phi^T) + c (phi x (phi x t)) phi^T. At unit quaternions
    d phi reduces to Jl^-1(phi) A (omega_j - omega_i)."""
    RmT, A, sj_inv, Rj, t_err, R_err = _odom_terms(Ti, Tj, delta_T)
    r = lie.se3_log(torch.cat([t_err, lie.R_to_quat(R_err)], dim=-1))
    phi = r[:, 3:]
    ti, tj = lie.sim3_t(Ti), lie.sim3_t(Tj)
    n_i = torch.sum(lie.sim3_q(Ti) ** 2, dim=-1)[:, None, None]
    n_j = torch.sum(lie.sim3_q(Tj) ** 2, dim=-1)[:, None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    An = A - (1.0 - n_i) * RmT  # -d(A)/d omega_i = An [.]x
    K = sj_inv[:, :, None] * A
    Kn = sj_inv[:, :, None] * An
    # d t_err/d sigma_j: d(1/s_j) = -1/s_j, but 0 where the 1e6 guard holds
    d_sj = torch.where(lie.sim3_s(Tj) == 0.0, _mv(K, tj), _mv(K, ti))
    # columns (tau, omega, sigma) of pose i, then of pose j
    dt = torch.cat([-K, Kn @ lie.skew(tj - ti) + K @ lie.skew(ti), -_mv(K, ti)[..., None],
                    K, -K @ lie.skew(tj), d_sj[..., None]], dim=-1)
    E = lie.skew(eye)  # (3, 3, 3): E[k] = [e_k]x
    dR_i = -An[:, None] @ E[None] @ Rj[:, None]  # (O, 3, 3, 3): d R_err / d omega_i,k
    dR_j = A[:, None] @ E[None] @ (Rj - (1.0 - n_j) * eye)[:, None]
    J_om = _rotation_log_jvp(R_err, torch.cat([dR_i, dR_j], dim=1), phi)  # (O, 3, 6)
    z3, z1 = torch.zeros_like(A), torch.zeros_like(A[..., :1])
    J_phi = torch.cat([z3, J_om[..., :3], z1, z3, J_om[..., 3:], z1], dim=-1)

    b, c = _jl_inv_coeffs(torch.sum(phi * phi, dim=-1)[:, None, None])
    Phi = lie.skew(phi)
    Jli = eye - 0.5 * Phi + b * (Phi @ Phi)
    outer = lambda u, v: u[:, :, None] * v[:, None, :]  # noqa: E731
    pt = torch.sum(phi * t_err, dim=-1)[:, None, None]
    D = (0.5 * lie.skew(t_err) + b * (pt * eye + outer(phi, t_err) - 2.0 * outer(t_err, phi))
         + c * outer(_mv(Phi, _mv(Phi, t_err)), phi))
    return r, torch.cat([Jli @ dt + D @ J_phi, J_phi], dim=1)


def _odom_edge_system(cfg: BAConfig, T_WC, edge_ii, edge_jj, delta_T):
    """Odometry constraints -> (H (O, 14, 14), g (O, 14)), ordered
    (pose_i, pose_j), for index tensors ``edge_ii``/``edge_jj`` (O,) and
    ``delta_T`` (O, 7); ints and one (7,) give one (14, 14), (14,).

    The Jacobian is exact (the reference's hand-derived adjoint is
    first-order near identity only; see the JAX package's docstring). The
    JAX package takes ``jacfwd`` of the residual; here it is the closed form
    of :func:`_odom_jacobian`: a few dozen tensor ops per GN iteration for
    all rows, where forward-mode AD cost ~1,900 eager kernels. With
    ``cfg.solve_f64`` it runs in f64 whatever the poses' type; without, in
    the poses' type, as the JAX package's x64-off program does."""
    single = not torch.is_tensor(edge_ii) or edge_ii.dim() == 0
    ii = torch.as_tensor(edge_ii, device=T_WC.device).reshape(-1)
    jj = torch.as_tensor(edge_jj, device=T_WC.device).reshape(-1)
    dt = torch.float64 if cfg.solve_f64 else T_WC.dtype
    T = T_WC.to(dt)
    r, J = _odom_jacobian(T[ii], T[jj], delta_T.to(dt).reshape(-1, 7))
    w = torch.cat([
        huber(r[:, :3] / cfg.sigma_odom_t) / cfg.sigma_odom_t ** 2,
        huber(r[:, 3:] / cfg.sigma_odom_r) / cfg.sigma_odom_r ** 2,
    ], dim=-1)
    H = torch.einsum("oak,oa,oal->okl", J, w, J)
    g = torch.einsum("oak,oa->ok", J, w * r)
    return (H[0], g[0]) if single else (H, g)


def _odom_systems(cfg: BAConfig, T_WC, odom: OdomEdges):
    """Every odometry row's (H, g), inactive rows zeroed: (O, 14, 14), (O, 14)."""
    Ho, go = _odom_edge_system(cfg, T_WC, odom.ii.long(), odom.jj.long(), odom.delta_T)
    m = odom.active.to(Ho.dtype)
    return Ho * m[:, None, None], go * m[:, None]


# ---------------------------------------------------------------------------
# GN solver
# ---------------------------------------------------------------------------

def _scatter_block(H, g, blocks, gvecs, ii_opt, jj_opt, p_opt):
    """Add per-edge 7x7 blocks into the dense (7P, 7P) system in place;
    negative opt indices (pinned poses) are masked (SparseBlock semantics,
    gn_kernels.cu:83-122). On the card the add order of colliding blocks
    varies from run to run."""
    i_safe = torch.clamp(ii_opt, min=0).long()
    j_safe = torch.clamp(jj_opt, min=0).long()
    if blocks is not None:
        mask = ((ii_opt >= 0) & (jj_opt >= 0)).to(H.dtype)
        r7 = torch.arange(7, device=H.device)
        H.view(p_opt, 7, p_opt, 7).index_put_(
            (i_safe[:, None, None], r7[None, :, None], j_safe[:, None, None], r7[None, None, :]),
            mask[:, None, None] * blocks, accumulate=True)
    if gvecs is not None:
        gmask = (ii_opt >= 0).to(g.dtype)
        g.view(p_opt, 7).index_put_((i_safe,), gmask[:, None] * gvecs, accumulate=True)
    return H, g


def _newton_step(H, g, eye):
    """dx = -H^-1 g by a damped Cholesky solve in the dtype of ``eye``, the
    identity of H's size (JAX ``global_opt.py:613-633``). f64: damping 1e-8
    x max(max diag H, 1) (the reference's double Eigen solve). f32: damping
    1e-6 x the same and one step of iterative refinement, dx += H^-1 (-g - H
    dx), computed in f32 as JAX computes it. A failed factorization gives
    dx = 0, with no host sync."""
    f64 = eye.dtype == torch.float64
    Hs, gs = H.to(eye.dtype), g.to(eye.dtype)[:, None]
    Hs = Hs + (1e-8 if f64 else 1e-6) * torch.clamp(torch.max(torch.diagonal(Hs)), min=1.0) * eye
    L, ok = safe_cholesky(Hs, eye)
    dx = -torch.cholesky_solve(gs, L)
    if not f64:
        dx = dx + torch.cholesky_solve(-gs - Hs @ dx, L)
    return torch.where(ok, dx[:, 0], 0.0)


class _Lin(NamedTuple):
    """A window's index and mask tensors, made once a solve (the step reads
    them every iteration): the edge rows' ``ii`` (E,) int32; the dense
    system's block rows / columns ``Hi``, ``Hj`` (4E + 4O,) and gradient
    rows ``gi`` (2E + 2O,) among the free poses (pinned ones negative); the
    live rows ``active`` (E,); the scale targets ``s_bar`` (P,); the free
    poses ``free`` (P,); the scale entries ``diag_idx`` (P - num_fix,) of
    the diagonal."""

    ii: torch.Tensor
    Hi: torch.Tensor
    Hj: torch.Tensor
    gi: torch.Tensor
    active: torch.Tensor
    s_bar: torch.Tensor
    free: torch.Tensor
    diag_idx: torch.Tensor


def _lin(num_fix: int, p: int, edges: Edges, odom: OdomEdges, s_bar) -> _Lin:
    dev = edges.ii.device
    ii_opt, jj_opt = edges.ii - num_fix, edges.jj - num_fix
    oi_opt, oj_opt = odom.ii - num_fix, odom.jj - num_fix
    return _Lin(
        ii=edges.ii.to(torch.int32),
        Hi=torch.cat([ii_opt, ii_opt, jj_opt, jj_opt, oi_opt, oi_opt, oj_opt, oj_opt]),
        Hj=torch.cat([ii_opt, jj_opt, ii_opt, jj_opt, oi_opt, oj_opt, oi_opt, oj_opt]),
        gi=torch.cat([ii_opt, jj_opt, oi_opt, oj_opt]),
        active=edges.active, s_bar=s_bar,
        free=torch.arange(p, device=dev) >= num_fix,
        diag_idx=torch.arange(p - num_fix, device=dev) * 7 + 6)


def _gn_step(num_fix: int, info_sp: float, lin: _Lin, eye, T, B, g, odom_systems=None):
    """One GN step after the residual: the AdjInv wrap of the rows' (B, g)
    (:func:`_adj_wrap`), the dead rows masked, the dense (7P', 7P') normal
    equations with the odometry blocks ``odom_systems`` ((O, 14, 14), (O,
    14); None: no rows) and the scale priors, the damped Cholesky solve in
    ``eye``'s type (:func:`_newton_step`) and the left retraction of the
    free poses. Returns (T_out, |dx|). Launches only, no host sync: a CUDA
    graph can hold it (:class:`_StepGraph`)."""
    p_opt = T.shape[0] - num_fix
    A_all, gj_all = _adj_wrap(T, lin.ii, B, g)
    m = lin.active.to(A_all.dtype)
    A_all = A_all * m[:, None, None]
    gj_all = gj_all * m[:, None]
    if odom_systems is None:  # no odometry rows: nothing to linearize
        Ho = A_all.new_zeros((0, 14, 14))
        go = A_all.new_zeros((0, 14))
    else:
        Ho, go = (t.to(A_all.dtype) for t in odom_systems)

    H = torch.zeros((7 * p_opt, 7 * p_opt), dtype=A_all.dtype, device=T.device)
    gv = torch.zeros((7 * p_opt,), dtype=A_all.dtype, device=T.device)
    # Ji = -Jj: H_ii = H_jj = A, H_ij = H_ji = -A; g_i = -gj, g_j = gj
    blocks = torch.cat([A_all, -A_all, -A_all, A_all, Ho[:, :7, :7], Ho[:, :7, 7:],
                        Ho[:, 7:, :7], Ho[:, 7:, 7:]])
    _scatter_block(H, None, blocks, None, lin.Hi, lin.Hj, p_opt)
    _scatter_block(H, gv, None, torch.cat([-gj_all, gj_all, go[:, :7], go[:, 7:]]),
                   lin.gi, lin.gi, p_opt)

    # scale priors: r = log(s / s_bar), unit Jacobian on the scale DoF
    s = T[:, 7]
    sp_valid = (lin.s_bar > 1e-6) & (s > 1e-6) & lin.free
    r_s = torch.where(sp_valid, torch.log(torch.clamp(s, min=1e-12)
                                          / torch.clamp(lin.s_bar, min=1e-12)), 0.0)
    sp_w = torch.where(sp_valid[num_fix:], info_sp, 0.0).to(H.dtype)
    H[lin.diag_idx, lin.diag_idx] += sp_w
    gv[lin.diag_idx] += sp_w * r_s[num_fix:].to(H.dtype)

    dx = _newton_step(H, gv, eye).reshape(p_opt, 7).to(T.dtype)

    T_out = T.clone()
    T_out[num_fix:] = lie.sim3_retr(T[num_fix:], dx)
    return T_out, torch.linalg.norm(dx.reshape(-1))


# ---------------------------------------------------------------------------
# the GN step as a CUDA graph
# ---------------------------------------------------------------------------

MAX_STEP_GRAPHS = 16  # window shapes kept; a cell meets a handful (pose and pair buckets)

_step_graphs: "OrderedDict[tuple, _StepGraph]" = OrderedDict()
_step_graphs_lock = threading.Lock()  # the cache
_capture_lock = threading.Lock()  # one capture at a time in the process
_capture_streams: dict = {}


def _graphs_engage(device, n_odom: int, split: bool) -> bool:
    """The GN step runs as a CUDA graph on a card, for a window whose edge
    rows stay on the solve device and that has no odometry rows (their
    systems copy a host-built vector, which a capture cannot hold)."""
    return device.type == "cuda" and not split and n_odom == 0


class _StepGraph:
    """One window shape's captured :func:`_gn_step`: static inputs, the
    graph, its outputs. Held by one solve at a time (``lock``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graph = None

    def capture(self, step, lin: _Lin, eye, T, B, g):
        """Capture ``step`` on a side stream of T's device, into a pool of
        the graph's own, over static copies of the inputs' shapes. Without
        ``torch.cuda.graph``'s device sync, collection and cache flush: a
        frontend thread may be launching meanwhile (its calls are not
        captured: ``thread_local``)."""
        dev = T.device
        self.lin = _Lin(*(t.clone() for t in lin))
        self.eye, self.T, self.B, self.g = eye.clone(), T.clone(), B.clone(), g.clone()
        with _capture_lock:
            stream = _capture_streams.get(dev)
            if stream is None:
                stream = _capture_streams[dev] = torch.cuda.Stream(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = step(self.lin, self.eye, self.T, self.B, self.g)
                finally:
                    graph.capture_end()
        self.graph = graph

    def replay(self, lin: Optional[_Lin], T, B, g):
        """The step on (T, B, g) and, when given, a new window's ``lin``:
        copies into the static inputs, one replay. Returns the static
        (T_out, |dx|), valid until the next replay."""
        if lin is not None:
            for dst, src in zip(self.lin, lin):
                dst.copy_(src)
        self.T.copy_(T)
        self.B.copy_(B)
        self.g.copy_(g)
        self.graph.replay()
        return self.out


def _step_graph(key) -> Optional[_StepGraph]:
    """The cache's graph of ``key``, taken (its lock held), or None when
    another solve holds it. A new key gets an empty entry; past
    :data:`MAX_STEP_GRAPHS` the least recently used free entry goes."""
    with _step_graphs_lock:
        entry = _step_graphs.get(key)
        if entry is None:
            entry = _step_graphs[key] = _StepGraph()
            excess = len(_step_graphs) - MAX_STEP_GRAPHS
            for old in [k for k in _step_graphs if k != key]:
                if excess > 0 and _step_graphs[old].lock.acquire(blocking=False):
                    del _step_graphs[old]
                    excess -= 1
        _step_graphs.move_to_end(key)
        return entry if entry.lock.acquire(blocking=False) else None


def _solve_gn(cfg: BAConfig, num_fix: int, T_WC, edges: Edges, odom: OdomEdges, s_bar,
              edge_systems, stats: Optional[dict] = None, split: bool = False):
    """Outer GN loop (gauss_newton_rays_odom_cuda, gn_kernels.cu:1792-1934):
    per iteration, every edge system (``edge_systems``, see
    :func:`_edge_systems`), then :func:`_gn_step`: the dense normal
    equations with the odometry and scale-prior blocks, a damped Cholesky
    solve on the device (:func:`_newton_step`, f64 or f32 by
    ``cfg.solve_f64``), the left retraction of the free poses. Stops after
    the iteration whose step norm fell below ``delta_norm`` (one host fetch
    per iteration).

    Where :func:`_graphs_engage` (a card, rows not ``split`` off the solve
    device, no odometry rows), the step is one CUDA graph replay, the
    residual staying eager before it: at a window shape (device, poses,
    rows, ``num_fix``, the systems', poses' and solve's types) met first,
    iteration 1 runs eagerly (it also warms the solver's library handles)
    and the step is captured before iteration 2; the graphs are kept for
    the process. ``stats``, if given, receives the iteration count, the
    replays and the captures; while a profiler records they are added to
    the counters ``backend.solve_iters``, ``backend.step_replays`` and
    ``backend.step_captures`` of the span open around the solve."""
    p = T_WC.shape[0]
    n_odom = odom.ii.shape[0]
    lin = _lin(num_fix, p, edges, odom, s_bar)
    eye = torch.eye(7 * (p - num_fix), dtype=torch.float64 if cfg.solve_f64 else torch.float32,
                    device=T_WC.device)
    info_sp = 1.0 / cfg.sigma_scale_prior ** 2
    step = partial(_gn_step, num_fix, info_sp)
    graphed = _graphs_engage(T_WC.device, n_odom, split)
    entry = None
    replays = captures = 0
    T = T_WC
    it = 0
    try:
        while it < cfg.max_iters:
            B, g = edge_systems(T)
            if graphed and entry is None:
                key = (T.device, p, B.shape[0], num_fix, B.dtype, T.dtype, eye.dtype, info_sp)
                entry = _step_graph(key)
                graphed = entry is not None
            if graphed and entry.graph is None and it > 0:
                entry.capture(step, lin, eye, T, B, g)
                captures += 1
            if graphed and entry.graph is not None:
                T, dn = entry.replay(lin if replays == 0 else None, T, B, g)
                replays += 1
            else:
                odom_systems = _odom_systems(cfg, T, odom) if n_odom else None
                T, dn = step(lin, eye, T, B, g, odom_systems)
            it += 1
            if not bool(dn >= cfg.delta_norm):  # the loop's one host fetch; NaN stops too
                break
        if replays:
            T = T.clone()  # the graph's output buffer is the next solve's
    finally:
        if entry is not None:
            entry.lock.release()
    if stats is not None:
        stats.update(iters=it, step_replays=replays, step_captures=captures)
    spans.count("backend.solve_iters", it)
    spans.count("backend.step_replays", replays)
    spans.count("backend.step_captures", captures)
    return T


@torch.no_grad()
def solve_gn_rays(cfg: BAConfig, num_fix: int, T_WC, X, C, edges: Edges, odom: OdomEdges,
                  s_bar, stats: Optional[dict] = None, n_active: Optional[int] = None,
                  placement=None):
    """Global ray-alignment GN with odometry factors and scale priors
    (gauss_newton_rays_odom_cuda, gn_kernels.cu:1792-1934).

    T_WC (P, 8) window poses, X (P, HW, 3), C (P, HW, 1), s_bar (P,) scale
    targets (<= 0 disables). f32 edge systems for f32 inputs; the solve in
    f64 (the reference's double Eigen solve) or, without ``cfg.solve_f64``,
    in f32 with one refinement step (:func:`_newton_step`). ``n_active``:
    the live edge rows (a prefix) as the host knows them, a sizing hint of
    the kernel (None: all rows). ``placement``: split the edge rows over
    the backend's devices (each part's kernel sized by its own live rows).
    Returns the updated (P, 8) poses."""
    XiT, w0 = _edge_cache(cfg, X, C, edges)
    systems = _edge_systems(partial(_ray_residual, cfg), T_WC, edges.ii, edges.jj,
                            (XiT, w0, edges.active), (X,), n_active, placement)
    return _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, systems, stats=stats,
                     split=_split(edges.ii.shape[0], T_WC.device, placement))


@torch.no_grad()
def solve_gn_calib(cfg: BAConfig, num_fix: int, img_hw, T_WC, X, C, K, edges: Edges,
                   odom: OdomEdges, s_bar, stats: Optional[dict] = None, n_active: Optional[int] = None,
                   placement=None):
    """Calibrated pixel + log-depth global GN (gauss_newton_calib_cuda,
    gn_kernels.cu:2610-2702; caller global_opt.py:288-341) with the same
    outer loop, odometry rows, scale priors, live-row hint and edge split as
    :func:`solve_gn_rays`. X (P, HW, 3) is already ray-constrained
    (global_opt.py:298-300); K (3, 3)."""
    XiT, w0 = _edge_cache(cfg, X, C, edges)
    launched = calib_edge_kernel.calib_edge_systems.launches
    systems = _edge_systems(partial(_calib_residual, cfg, img_hw), T_WC, edges.ii, edges.jj,
                            (edges.idx, XiT, w0, edges.active), (X, K), n_active, placement)
    T = _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, systems, stats=stats,
                  split=_split(edges.ii.shape[0], T_WC.device, placement))
    spans.count("backend.calib_launches", calib_edge_kernel.calib_edge_systems.launches - launched)
    return T


@torch.no_grad()
def solve_gn_points(cfg: BAConfig, num_fix: int, T_WC, X, C, edges: Edges, odom: OdomEdges, s_bar,
                    stats: Optional[dict] = None, placement=None):
    """3-D point-alignment global GN (gauss_newton_points_cuda,
    gn_kernels.cu:2206-2293; exported at gn.cpp:152-160, driven by the
    disabled local mapper local_mapping.py:190-206) with the same outer
    loop, odometry rows, scale priors and edge split as
    :func:`solve_gn_rays`."""
    XiT, w0 = _edge_cache(cfg, X, C, edges)
    systems = _edge_systems(partial(_point_residual, cfg), T_WC, edges.ii, edges.jj,
                            (XiT, w0, _xj_rows(X, edges.jj)), placement=placement)
    return _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, systems, stats=stats,
                     split=_split(edges.ii.shape[0], T_WC.device, placement))
