"""Backend global bundle adjustment: Sim(3) ray alignment over keyframes.

Behavioral spec: ``mast3r_slam/global_opt.py`` ``FactorGraph`` with the
upstream per-edge confidence storage (``global_opt_bk0.py:107-147``); the
ray-alignment residual of ``gn_kernels.cu:576-907``; the odometry SE(3)-log
constraint of ``gn_kernels.cu:1106-1290`` (with an exact Jacobian); the scale
prior of ``gn_kernels.cu:1716-1790``; the outer loop
``gauss_newton_rays_odom_cuda`` (:1792-1934); the calibrated pixel +
log-depth residual of ``calib_proj_kernel`` (:2295-2608) with its outer loop
``gauss_newton_calib_cuda`` (:2610-2702). The JAX package's
``slam/global_opt.py`` is the reference of this port.

Since ``Ji = -Jj``, each directed edge's 14x14 Hessian is
``[[A, -A], [-A, A]]`` with ``A = M^T B M``, where B is the 7x7 Gram of the
relative-pose Jacobian and ``M = AdjInv(T_i)``: only B and its gradient are
reduced over the points, by the Hopper kernel of :mod:`..ops.ba_reduce_kernel`
(its plain version on a CPU tensor); the calibrated edges, which JAX reduces
with XLA too, are batched tensor code over chunks of edges
(:func:`_calib_edge_systems`). The dense (7P x 7P) system is assembled
on the device and Cholesky-solved there in f64 (the reference's double Eigen
solve, and the JAX package under x64).

The GN loop stops early on the host: each iteration fetches one bool
(``|dx| >= delta_norm``), so a solve makes exactly one edge-kernel launch per
iteration it runs, and its result is the JAX ``lax.while_loop``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import lie
from ..ops.ba_reduce_kernel import ray_edge_systems
from ..ops.robust import huber


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


# points per step of the calibrated edge reduction: bounds its (c, N, 3, 8)
# Jacobian-and-residual rows to ~190 MB in f32 (10 edges at 512x384)
CALIB_CHUNK_POINTS = 1 << 21
# each edge's sum over its rows is split into this many batched products: one
# (7 x 3N) by (3N x 8) product per edge keeps a card to one tile per edge
CALIB_REDUCE_SPLIT = 128


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


def _edge_inputs(cfg: BAConfig, X, C, edges: Edges):
    """(XiT, w0, XjT): the cached pair when the edge store has it, else
    :func:`_edges_pre`; XjT is frame j's points, channel-major."""
    if edges.XiT is not None:
        XiT, w0 = edges.XiT, edges.w0
    else:
        XiT, w0 = _edges_pre(cfg, X, C, edges)
    XjT = X.transpose(1, 2)[edges.jj.long()]  # (E, 3, HW)
    return XiT, w0, XjT


def _kernel_ray_fn(cfg: BAConfig):
    """Ray edge systems through :func:`ray_edge_systems` (the kernel on the
    card, its plain version on the CPU): per GN iteration ONE launch reduces
    every edge; the per-edge Sim(3) scalars and the 7x7 AdjInv products stay
    plain tensor code (they lie outside the TPU kernel too). Returns
    ``fn(T, xs) -> (A (E, 7, 7), gj (E, 7))`` with xs = (ii, jj, XiT, w0, XjT)."""

    def fn(T_WC_in, xs):
        ii, jj, XiT, w0, XjT = xs
        Ti = T_WC_in[ii.long()]
        Tij = lie.sim3_rel(Ti, T_WC_in[jj.long()])
        sR = Tij[:, 7, None, None] * lie.quat_to_R(Tij[:, 3:7])
        dt = XiT.dtype
        scal = torch.cat([sR.reshape(-1, 9), Tij[:, :3]], dim=-1).to(dt)
        B, g = ray_edge_systems(scal, XiT, XjT.to(dt), w0.to(dt),
                                sigma_ray=float(cfg.sigma_ray), sigma_dist=float(cfg.sigma_dist))
        M = _adj_inv_matrix(Ti).to(dt)
        A = torch.einsum("eba,ebc,ecd->ead", M, B, M)
        gj = torch.einsum("eba,eb->ea", M, g)
        return A.to(T_WC_in.dtype), gj.to(T_WC_in.dtype)

    return fn


def _reduce_rel_systems(D, w, err, P):
    """Per-edge 7x7 Gram and gradient of residual rows ``D . [I | -skew(P) | P]``
    summed over the points: D (c, N, R, 3), w and err (c, N, R), P (c, N, 3).
    Row r of the Jacobian is ``[d_r, P x d_r, d_r . P]``; with the residual as
    an eighth column, one batched product ``(w J)^T [J | err]``, split along
    the points (:data:`CALIB_REDUCE_SPLIT`), gives both sums.
    Returns (B (c, 7, 7), g (c, 7))."""
    c, N, R, _ = D.shape
    Pb = P[:, :, None, :].expand_as(D)
    Ja = torch.cat([D, torch.linalg.cross(Pb, D, dim=-1), (D * Pb).sum(-1, keepdim=True),
                    err[..., None]], dim=-1)  # (c, N, R, 8)
    split = math.gcd(N * R, CALIB_REDUCE_SPLIT)
    Ja = Ja.reshape(c * split, N * R // split, 8)
    Jw = Ja[..., :7] * w.reshape(c * split, -1, 1)
    G = (Jw.transpose(1, 2) @ Ja).reshape(c, split, 7, 8).sum(1)
    return G[..., :7], G[..., 7]


def _calib_edge_systems(cfg: BAConfig, img_hw, K, T_WC, ii, jj, idx, XiT, w0, XjT):
    """Calibrated pixel + log-depth edges (calib_proj_kernel,
    gn_kernels.cu:2295-2608) -> (A (E, 7, 7), gj (E, 7)). Residual
    [u - u_meas, v - v_meas, log z_j - log z_i] with pinhole K, where
    (u_meas, v_meas) is the matched pixel ``idx`` in frame i; a point counts
    when both depths exceed ``depth_eps`` and the projection lies inside the
    pixel border. Xi enters through its depth alone, which ray-constraining
    preserves: so the cached insertion-time ``XiT`` serves a solve on
    constrained pointmaps (the JAX package's invariant)."""
    height, width = img_hw
    E, _, N = XiT.shape
    dt = XiT.dtype
    fx, fy, cx, cy = (K[0, 0].to(dt), K[1, 1].to(dt), K[0, 2].to(dt), K[1, 2].to(dt))
    Ti = T_WC[ii.long()]
    Tij = lie.sim3_rel(Ti, T_WC[jj.long()]).to(dt)
    M = _adj_inv_matrix(Ti).to(dt)
    A = torch.empty((E, 7, 7), dtype=dt, device=XiT.device)
    gj = torch.empty((E, 7), dtype=dt, device=XiT.device)
    step = max(1, CALIB_CHUNK_POINTS // max(N, 1))
    for e0 in range(0, E, step):
        sl = slice(e0, min(E, e0 + step))
        P = lie.sim3_act(Tij[sl, None, :], XjT[sl].transpose(1, 2))  # (c, N, 3) in frame i
        zi = XiT[sl, 2]
        valid_z = (P[..., 2] > cfg.depth_eps) & (zi > cfg.depth_eps)
        z_inv = torch.where(valid_z, 1.0 / torch.where(valid_z, P[..., 2], 1.0), 0.0)
        x_div_z = P[..., 0] * z_inv
        y_div_z = P[..., 1] * z_inv
        u = fx * x_div_z + cx
        v = fy * y_div_z + cy
        ids = idx[sl].long()
        u_t = (ids % width).to(dt)
        v_t = torch.div(ids, width, rounding_mode="floor").to(dt)
        valid_u = (u > cfg.pixel_border) & (u < width - 1 - cfg.pixel_border)
        valid_v = (v > cfg.pixel_border) & (v < height - 1 - cfg.pixel_border)
        zj_log = torch.where(valid_z, torch.log(torch.where(valid_z, P[..., 2], 1.0)), 0.0)
        zi_log = torch.where(valid_z, torch.log(torch.clamp(zi, min=cfg.depth_eps)), 0.0)
        err = torch.stack([u - u_t, v - v_t, zj_log - zi_log], dim=-1)  # (c, N, 3)
        okf = (valid_u & valid_v & valid_z).to(dt) * w0[sl]
        sw_pix = okf / cfg.sigma_pixel
        sqrt_w = torch.stack([sw_pix, sw_pix, okf / cfg.sigma_depth], dim=-1)
        w = huber(sqrt_w * err) * sqrt_w * sqrt_w
        # D = d[u, v, log z]/dP (gn_kernels.cu:2486-2545)
        zeros = torch.zeros_like(z_inv)
        D = torch.stack([
            torch.stack([fx * z_inv, zeros, -fx * x_div_z * z_inv], dim=-1),
            torch.stack([zeros, fy * z_inv, -fy * y_div_z * z_inv], dim=-1),
            torch.stack([zeros, zeros, z_inv], dim=-1),
        ], dim=-2)  # (c, N, 3, 3)
        B, g = _reduce_rel_systems(D, w, err, P)
        A[sl] = torch.einsum("eba,ebc,ecd->ead", M[sl], B, M[sl])
        gj[sl] = torch.einsum("eba,eb->ea", M[sl], g)
    return A.to(T_WC.dtype), gj.to(T_WC.dtype)


# ---------------------------------------------------------------------------
# odometry factors
# ---------------------------------------------------------------------------

def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _odom_terms(Ti, Tj, delta_T):
    """The pieces of the odometry SE(3)-log residual (gn_kernels.cu:1144-1177)
    r = log_SE3(T_meas^-1 T_pred), with R_ij = Ri^T Rj and the
    scale-corrected t' = (1/s_j) Ri^T (tj - ti): ``A = Rm^T Ri^T``, ``1/s_j``
    (1e6 at s_j = 0), ``t_err = A (1/s_j) (tj - ti) - Rm^T tm`` and
    ``R_err = A Rj``."""
    RmT = lie.quat_to_R(delta_T[..., 3:7]).transpose(-1, -2)
    A = RmT @ lie.quat_to_R(lie.sim3_q(Ti)).transpose(-1, -2)
    sj = lie.sim3_s(Tj)
    sj_inv = torch.where(sj == 0.0, 1e6, 1.0 / sj)
    t_err = _mv(A, sj_inv * (lie.sim3_t(Tj) - lie.sim3_t(Ti))) - _mv(RmT, delta_T[..., :3])
    return A, sj_inv, t_err, A @ lie.quat_to_R(lie.sim3_q(Tj))


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


def _odom_jacobian(Ti, Tj, delta_T):
    """Residual r (O, 6) and its exact Jacobian J (O, 6, 14) under the
    solver's left retraction of (pose_i, pose_j), in closed form.

    At xi = 0 the retraction moves a pose by dt = tau + omega x t + sigma t,
    dR = skew(omega) R, ds = sigma s, which gives d t_err and the left
    perturbation dR_err = skew(A (omega_j - omega_i)) R_err. With
    (rho, phi) = log_SE3(t_err, R_err), rho = Jl^-1(phi) t_err:
    d phi = Jl^-1(phi) dR_err and d rho = Jl^-1(phi) d t_err + D d phi,
    D = d(Jl^-1(phi) t)/d phi = skew(t)/2 + b ((phi.t) I + phi t^T - 2 t phi^T)
    + c (phi x (phi x t)) phi^T."""
    A, sj_inv, t_err, R_err = _odom_terms(Ti, Tj, delta_T)
    r = lie.se3_log(torch.cat([t_err, lie.R_to_quat(R_err)], dim=-1))
    phi = r[:, 3:]
    ti, tj = lie.sim3_t(Ti), lie.sim3_t(Tj)
    K = sj_inv[:, :, None] * A
    Kt = K @ lie.skew(tj)
    # d t_err/d sigma_j: d(1/s_j) = -1/s_j, but 0 where the 1e6 guard holds
    d_sj = torch.where(lie.sim3_s(Tj) == 0.0, _mv(K, tj), _mv(K, ti))
    # columns (tau, omega, sigma) of pose i, then of pose j
    dt = torch.cat([-K, Kt, -_mv(K, ti)[..., None], K, -Kt, d_sj[..., None]], dim=-1)
    z3, z1 = torch.zeros_like(A), torch.zeros_like(A[..., :1])
    dR = torch.cat([z3, -A, z1, z3, A, z1], dim=-1)

    b, c = _jl_inv_coeffs(torch.sum(phi * phi, dim=-1)[:, None, None])
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Phi = lie.skew(phi)
    Jli = eye - 0.5 * Phi + b * (Phi @ Phi)
    outer = lambda u, v: u[:, :, None] * v[:, None, :]  # noqa: E731
    pt = torch.sum(phi * t_err, dim=-1)[:, None, None]
    D = (0.5 * lie.skew(t_err) + b * (pt * eye + outer(phi, t_err) - 2.0 * outer(t_err, phi))
         + c * outer(_mv(Phi, _mv(Phi, t_err)), phi))
    J_phi = Jli @ dR
    return r, torch.cat([Jli @ dt + D @ J_phi, J_phi], dim=1)


def _odom_edge_system(cfg: BAConfig, T_WC, edge_ii, edge_jj, delta_T):
    """Odometry constraints -> (H (O, 14, 14), g (O, 14)) in f64, ordered
    (pose_i, pose_j), for index tensors ``edge_ii``/``edge_jj`` (O,) and
    ``delta_T`` (O, 7); ints and one (7,) give one (14, 14), (14,).

    The Jacobian is exact (the reference's hand-derived adjoint is
    first-order near identity only; see the JAX package's docstring). The
    JAX package takes ``jacfwd`` of the residual; here it is the closed form
    of :func:`_odom_jacobian`, in f64 whatever the poses' type: a few dozen
    tensor ops per GN iteration for all rows, where forward-mode AD cost
    ~1,900 eager kernels."""
    single = not torch.is_tensor(edge_ii) or edge_ii.dim() == 0
    ii = torch.as_tensor(edge_ii, device=T_WC.device).reshape(-1)
    jj = torch.as_tensor(edge_jj, device=T_WC.device).reshape(-1)
    T = T_WC.to(torch.float64)
    r, J = _odom_jacobian(T[ii], T[jj], delta_T.to(torch.float64).reshape(-1, 7))
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


def _solve_gn(cfg: BAConfig, num_fix: int, T_WC, edges: Edges, odom: OdomEdges, s_bar,
              edge_systems, stats: Optional[dict] = None):
    """Outer GN loop (gauss_newton_rays_odom_cuda, gn_kernels.cu:1792-1934):
    per iteration, every edge system, the dense normal equations with the
    odometry and scale-prior blocks, a damped f64 Cholesky solve on the
    device, the left retraction of the free poses. Stops after the
    iteration whose step norm fell below ``delta_norm`` (one host fetch per
    iteration). ``stats``, if given, receives the iteration count."""
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
    eye = torch.eye(7 * p_opt, dtype=torch.float64, device=dev)

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

        # damped Cholesky; a failed factorization gives dx = 0, no host sync
        Hs, gs = H.to(torch.float64), g.to(torch.float64)
        Hs = Hs + 1e-8 * torch.clamp(torch.max(torch.diagonal(Hs)), min=1.0) * eye
        L, info = torch.linalg.cholesky_ex(Hs)
        ok = (info == 0) & torch.all(torch.isfinite(L))
        L = torch.where(ok, L, eye)
        dx = -torch.cholesky_solve(gs[:, None], L)[:, 0]
        dx = torch.where(ok, dx, 0.0).reshape(p_opt, 7).to(T_in.dtype)

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
    return T


@torch.no_grad()
def solve_gn_rays(cfg: BAConfig, num_fix: int, T_WC, X, C, edges: Edges, odom: OdomEdges,
                  s_bar, stats: Optional[dict] = None):
    """Global ray-alignment GN with odometry factors and scale priors
    (gauss_newton_rays_odom_cuda, gn_kernels.cu:1792-1934).

    T_WC (P, 8) window poses, X (P, HW, 3), C (P, HW, 1), s_bar (P,) scale
    targets (<= 0 disables). f32 edge systems for f32 inputs, an f64 solve
    (the reference's double Eigen solve). Returns the updated (P, 8) poses."""
    XiT, w0, XjT = _edge_inputs(cfg, X, C, edges)
    xs = (edges.ii, edges.jj, XiT, w0, XjT)
    fn = _kernel_ray_fn(cfg)
    return _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar, lambda T: fn(T, xs), stats=stats)


@torch.no_grad()
def solve_gn_calib(cfg: BAConfig, num_fix: int, img_hw, T_WC, X, C, K, edges: Edges,
                   odom: OdomEdges, s_bar, stats: Optional[dict] = None):
    """Calibrated pixel + log-depth global GN (gauss_newton_calib_cuda,
    gn_kernels.cu:2610-2702; caller global_opt.py:288-341) with the same
    outer loop, odometry rows and scale priors as :func:`solve_gn_rays`.
    X (P, HW, 3) is already ray-constrained (global_opt.py:298-300); K (3, 3)."""
    XiT, w0, XjT = _edge_inputs(cfg, X, C, edges)
    return _solve_gn(cfg, num_fix, T_WC, edges, odom, s_bar,
                     lambda T: _calib_edge_systems(cfg, img_hw, K, T, edges.ii, edges.jj, edges.idx,
                                                   XiT, w0, XjT), stats=stats)
