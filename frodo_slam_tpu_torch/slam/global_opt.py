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
:func:`_point_residual`) hands back B and g, and one seam,
:func:`_edge_systems`, applies M to them. The dense (7P x 7P) system is
assembled on the device and Cholesky-solved there: in f64 by default (the
reference's double Eigen solve, and the JAX package under x64), or, with
``BAConfig.solve_f64`` off (``tpu.x64_eval: false``, the real-time
configurations), in f32 with a larger damping and one step of iterative
refinement, as the JAX package solves with x64 off.

The GN loop stops early on the host: each iteration fetches one bool
(``|dx| >= delta_norm``), so a solve makes exactly one edge-kernel launch per
iteration it runs (one per edge part under a placement), and its result is
the JAX ``lax.while_loop``'s. While a profiler records, a solve adds its
iterations to the ``backend.solve_iters`` counter of the span open around it,
and the calibrated solve its kernel launches to ``backend.calib_launches``.

Under a :class:`~..parallel.mesh.Placement` the edge rows are split over the
backend's devices (:func:`~..parallel.mesh.edge_parts`, the JAX package's
``_build_edge_systems``): each part's rows and the window's pointmaps are
copied to its device once a solve, only the poses (P x 8) move each
iteration, and the (E, 7, 7) / (E, 7) systems come back to the solve device
in row order, where the assembly and the Cholesky run once.
"""

from __future__ import annotations

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


def _ray_residual(cfg: BAConfig, T, Ti, ii, jj, XiT, w0, active, X, n_active=None):
    """Ray edges (gn_kernels.cu:576-907) -> (B (E, 7, 7), g (E, 7)) through
    :func:`ray_edge_systems` (the kernel on the card, its plain version on
    the CPU): ONE launch reduces every live edge, Xj read from the window's
    pointmaps X (P, HW, 3) through ``jj``; each edge's relative [sR | t] is
    plain tensor code (it lies outside the TPU kernel too)."""
    dt = XiT.dtype
    scal = lie.sim3_rel_sRt(Ti, T[jj.long()]).to(dt)
    return ray_edge_systems(scal, XiT, w0.to(dt), X.to(dt), jj, active,
                            sigma_ray=float(cfg.sigma_ray), sigma_dist=float(cfg.sigma_dist),
                            n_active=n_active)


def _calib_residual(cfg: BAConfig, img_hw, T, Ti, ii, jj, idx, XiT, w0, active, X, K, n_active=None):
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


def _point_residual(cfg: BAConfig, T, Ti, ii, jj, XiT, w0, XjT, n_active=None):
    """3-D point-alignment edges (point_align_kernel, gn_kernels.cu:1936-2204)
    -> (B (E, 7, 7), g (E, 7)): residual ``Sim3(T_ij) Xj - Xi`` with D = I,
    Huber-weighted with sqrt-weight ``w0 / sigma_point``. Plain tensor code
    over chunks of edges, like the calibrated edges' plain version (the JAX
    package reduces it with XLA too)."""
    E, _, N = XiT.shape
    dt = XiT.dtype
    Tij = lie.sim3_rel(Ti, T[jj.long()]).to(dt)
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


def _edge_systems(residual, T_WC, ii, jj, rows, shared=(), n_active: Optional[int] = None,
                  placement=None):
    """``systems(T) -> (A (E, 7, 7), gj (E, 7))`` on T_WC's device: the one
    seam of the three residuals. ``residual(T, Ti, ii, jj, *rows, *shared,
    n_active=) -> (B, g)`` gives each row's system in the edge's relative
    frame; M = AdjInv(T_i) takes it to A = M^T B M, gj = M^T g (in B's type,
    then in T's). ``ii``, ``jj`` (E,) are taken as int32; ``rows`` are
    per-edge tensors, ``shared`` whole ones (the pointmaps, K). A placement
    splits the rows over its devices (:func:`edge_parts`; see the module
    docstring), each part on its device; without one there is one part.
    ``n_active`` (the live prefix as the host knows it; None: all) becomes
    each part's own live-row count, the kernels' sizing hint."""
    E, device = ii.shape[0], T_WC.device
    ii, jj = ii.to(torch.int32), jj.to(torch.int32)
    parts = [(0, E, device)] if placement is None else edge_parts(E, placement)

    def make(lo, hi, d):
        live = None if n_active is None else max(0, min(n_active, hi) - lo)
        part = (tuple(t[lo:hi].to(d).contiguous() for t in (ii, jj, *rows))
                + tuple(t.to(d).contiguous() for t in shared))

        def fn(T):
            Ti = T[part[0].long()]
            B, g = residual(T, Ti, *part, n_active=live)
            M = _adj_inv_matrix(Ti).to(B.dtype)
            A = torch.einsum("eba,ebc,ecd->ead", M, B, M)
            gj = torch.einsum("eba,eb->ea", M, g)
            return A.to(T.dtype), gj.to(T.dtype)

        return fn

    fns = [(make(lo, hi, d), d) for lo, hi, d in parts]
    if len(fns) == 1 and parts[0][2] == device:
        return fns[0][0]

    def systems(T):
        out = [fn(T.to(d)) for fn, d in fns]
        return (torch.cat([A.to(device) for A, _ in out]), torch.cat([g.to(device) for _, g in out]))

    return systems


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


def _solve_gn(cfg: BAConfig, num_fix: int, T_WC, edges: Edges, odom: OdomEdges, s_bar,
              edge_systems, stats: Optional[dict] = None):
    """Outer GN loop (gauss_newton_rays_odom_cuda, gn_kernels.cu:1792-1934):
    per iteration, every edge system, the dense normal equations with the
    odometry and scale-prior blocks, a damped Cholesky solve on the device
    (:func:`_newton_step`, f64 or f32 by ``cfg.solve_f64``), the left
    retraction of the free poses. Stops after the iteration whose step norm
    fell below ``delta_norm`` (one host fetch per iteration). ``stats``, if
    given, receives the iteration count."""
    p = T_WC.shape[0]
    p_opt = p - num_fix
    dev = T_WC.device
    ii_opt, jj_opt = edges.ii - num_fix, edges.jj - num_fix
    oi_opt, oj_opt = odom.ii - num_fix, odom.jj - num_fix
    Hi = torch.cat([ii_opt, ii_opt, jj_opt, jj_opt, oi_opt, oi_opt, oj_opt, oj_opt])
    Hj = torch.cat([ii_opt, jj_opt, ii_opt, jj_opt, oi_opt, oj_opt, oi_opt, oj_opt])
    gi = torch.cat([ii_opt, jj_opt, oi_opt, oj_opt])
    amask = edges.active
    info_sp = 1.0 / cfg.sigma_scale_prior ** 2
    diag_idx = torch.arange(p_opt, device=dev) * 7 + 6
    free = torch.arange(p, device=dev) >= num_fix
    eye = torch.eye(7 * p_opt, dtype=torch.float64 if cfg.solve_f64 else torch.float32, device=dev)

    def iteration(T_in):
        A_all, gj_all = edge_systems(T_in)
        m = amask.to(A_all.dtype)
        A_all = A_all * m[:, None, None]
        gj_all = gj_all * m[:, None]
        if odom.ii.shape[0]:
            Ho, go = _odom_systems(cfg, T_in, odom)
            Ho, go = Ho.to(A_all.dtype), go.to(A_all.dtype)
        else:  # no odometry rows: nothing to linearize
            Ho = A_all.new_zeros((0, 14, 14))
            go = A_all.new_zeros((0, 14))

        H = torch.zeros((7 * p_opt, 7 * p_opt), dtype=A_all.dtype, device=dev)
        g = torch.zeros((7 * p_opt,), dtype=A_all.dtype, device=dev)
        # Ji = -Jj: H_ii = H_jj = A, H_ij = H_ji = -A; g_i = -gj, g_j = gj
        blocks = torch.cat([A_all, -A_all, -A_all, A_all, Ho[:, :7, :7], Ho[:, :7, 7:],
                            Ho[:, 7:, :7], Ho[:, 7:, 7:]])
        _scatter_block(H, None, blocks, None, Hi, Hj, p_opt)
        _scatter_block(H, g, None, torch.cat([-gj_all, gj_all, go[:, :7], go[:, 7:]]),
                       gi, gi, p_opt)

        # scale priors: r = log(s / s_bar), unit Jacobian on the scale DoF
        s = T_in[:, 7]
        sp_valid = (s_bar > 1e-6) & (s > 1e-6) & free
        r_s = torch.where(sp_valid, torch.log(torch.clamp(s, min=1e-12)
                                              / torch.clamp(s_bar, min=1e-12)), 0.0)
        sp_w = torch.where(sp_valid[num_fix:], info_sp, 0.0).to(H.dtype)
        H[diag_idx, diag_idx] += sp_w
        g[diag_idx] += sp_w * r_s[num_fix:].to(H.dtype)

        dx = _newton_step(H, g, eye).reshape(p_opt, 7).to(T_in.dtype)

        T_out = T_in.clone()
        T_out[num_fix:] = lie.sim3_retr(T_in[num_fix:], dx)
        return T_out, torch.linalg.norm(dx.reshape(-1))

    T = T_WC
    it = 0
    while it < cfg.max_iters:
        T, dn = iteration(T)
        it += 1
        if not bool(dn >= cfg.delta_norm):  # the loop's one host fetch; NaN stops too
            break
    if stats is not None:
        stats["iters"] = it
    spans.count("backend.solve_iters", it)
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
    return _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, systems, stats=stats)


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
    T = _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, systems, stats=stats)
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
    return _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, systems, stats=stats)
