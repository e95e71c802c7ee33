"""SO(3) / SE(3) / Sim(3) Lie groups on PyTorch tensors.

Conventions (identical to the reference's lietorch + CUDA device math,
``mast3r_slam/backend/src/gn_kernels.cu:220-480``):

- Quaternions stored ``[qx, qy, qz, qw]`` (scalar last), Hamilton product.
- SE(3) stored as 7-vector ``[t(3), q(4)]``.
- Sim(3) stored as 8-vector ``[t(3), q(4), s]``.
- Sim(3) tangent is 7-dim ``[tau(3), phi(3), sigma]``.
- Group action: ``Y = s * R(q) * X + t`` (gn_kernels.cu:249-261).
- ``retr(xi, T) = exp(xi) * T`` — *left* retraction (gn_kernels.cu:434-455).

Shape-polymorphic over leading batch dims. Small-angle branches use the same
series expansions as the reference, selected with ``torch.where`` on
numerically-safe operands, so no branch ever syncs with the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------

def quat_mul(qi: torch.Tensor, qj: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``qi * qj`` with scalar-last storage (quat_comp,
    gn_kernels.cu:220-226)."""
    xi, yi, zi, wi = qi.unbind(-1)
    xj, yj, zj, wj = qj.unbind(-1)
    return torch.stack(
        [
            wi * xj + xi * wj + yi * zj - zi * yj,
            wi * yj - xi * zj + yi * wj + zi * xj,
            wi * zj + xi * yj - yi * xj + zi * wj,
            wi * wj - xi * xj - yi * yj - zi * zj,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (gn_kernels.cu:229-235)."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_act(q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``X`` by unit quaternion ``q`` (gn_kernels.cu:237-247)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, X)
    return X + qw * uv + _cross(qv, uv)


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion to rotation matrix, rows last-two dims."""
    x, y, z, w = q.unbind(-1)
    rows = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return rows.reshape(*q.shape[:-1], 3, 3)


def quat_candidates(R: torch.Tensor, one=1.0) -> torch.Tensor:
    """The four Shepperd quaternion candidates of R (..., 4, 4), scalar-last:
    linear in R's entries plus ``one`` (1 for a matrix, 0 for a tangent dR).
    Candidate k's magnitude term is its entry ``(k + 3) % 4``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, one + tr], dim=-1)
    q1 = torch.stack([one + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    q2 = torch.stack([m01 + m10, one - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    q3 = torch.stack([m02 + m20, m12 + m21, one - m00 - m11 + m22, m10 - m01], dim=-1)
    return torch.stack([q0, q1, q2, q3], dim=-2)


def quat_candidate_index(cands: torch.Tensor) -> torch.Tensor:
    """Index of the best-conditioned candidate (the largest magnitude term)."""
    return torch.argmax(cands[..., [0, 1, 2, 3], [3, 0, 1, 2]], dim=-1)


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to unit quaternion (scalar-last), branch-free: the
    four Shepperd candidates, best-conditioned one picked."""
    cands = quat_candidates(R)  # (..., 4cand, 4)
    best = quat_candidate_index(cands)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of 3-vector(s)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    rows = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return rows.reshape(*v.shape[:-1], 3, 3)


def _eye3(like: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*batch_shape, 3, 3)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle to quaternion, small-angle series per gn_kernels.cu:341-363."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    imag = torch.where(
        small,
        0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
        torch.sin(0.5 * theta_safe) / theta_safe,
    )
    real = torch.where(
        small,
        1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
        torch.cos(0.5 * theta_safe),
    )
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion to axis-angle."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qv = qv * sign
    qw = qw * sign
    nv = torch.linalg.norm(qv, dim=-1, keepdim=True)
    small = nv < _EPS
    nv_safe = torch.where(small, torch.ones_like(nv), nv)
    angle = 2.0 * torch.atan2(nv, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), angle / nv_safe)
    return scale * qv


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi)."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta_sq)
    Phi = skew(phi)
    Phi2 = Phi @ Phi
    small = theta_sq < _EPS
    one = torch.ones_like(theta_sq)
    theta_safe = torch.where(small, one, theta)
    A = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1 - torch.cos(theta_safe)) / torch.where(small, one, theta_sq))
    B = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta_safe - torch.sin(theta_safe)) / torch.where(small, one, theta_sq * theta_safe),
    )
    return _eye3(phi, Phi.shape[:-2]) + A * Phi + B * Phi2


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian, matching ``Jl_inv`` (gn_kernels.cu:1042-1073)."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta_sq)
    Phi = skew(phi)
    Phi2 = Phi @ Phi
    small = theta_sq < _EPS
    one = torch.ones_like(theta_sq)
    theta_safe = torch.where(small, one, theta)
    sin_t = torch.sin(theta_safe)
    cos_t = torch.cos(theta_safe)
    factor2 = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / torch.where(small, one, theta_sq)
        - (1.0 + cos_t) / torch.where(small, one, 2.0 * theta_safe * sin_t),
    )
    return _eye3(phi, Phi.shape[:-2]) - 0.5 * Phi + factor2 * Phi2


# ---------------------------------------------------------------------------
# SE(3): 7-vector [t, q]
# ---------------------------------------------------------------------------

def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    out = torch.zeros((*shape, 7), dtype=dtype, device=device)
    out[..., 6] = 1.0
    return out


def se3_t(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def se3_q(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def se3_mul(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    t = se3_t(Ti) + quat_act(se3_q(Ti), se3_t(Tj))
    q = quat_mul(se3_q(Ti), se3_q(Tj))
    return torch.cat([t, q], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    qinv = quat_inv(se3_q(T))
    t = -quat_act(qinv, se3_t(T))
    return torch.cat([t, qinv], dim=-1)


def se3_act(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return quat_act(se3_q(T), X) + se3_t(T)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [rho, phi] -> SE(3)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> [rho, phi], matching ``logSE3`` (gn_kernels.cu:1076-1084)."""
    phi = so3_log(se3_q(T))
    rho = (so3_left_jacobian_inv(phi) @ se3_t(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_to_matrix(T: torch.Tensor) -> torch.Tensor:
    M = torch.zeros((*T.shape[:-1], 4, 4), dtype=T.dtype, device=T.device)
    M[..., :3, :3] = quat_to_R(se3_q(T))
    M[..., :3, 3] = se3_t(T)
    M[..., 3, 3] = 1.0
    return M


def se3_from_matrix(M: torch.Tensor) -> torch.Tensor:
    q = R_to_quat(M[..., :3, :3])
    return torch.cat([M[..., :3, 3], q], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3): 8-vector [t, q, s]
# ---------------------------------------------------------------------------

def sim3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    out = torch.zeros((*shape, 8), dtype=dtype, device=device)
    out[..., 6] = 1.0
    out[..., 7] = 1.0
    return out


def sim3_t(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def sim3_q(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def sim3_s(T: torch.Tensor) -> torch.Tensor:
    return T[..., 7:8]


def sim3_act(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Y = s R X + t`` with X (..., 3) broadcast against T (..., 8)."""
    return sim3_s(T) * quat_act(sim3_q(T), X) + sim3_t(T)


def sim3_mul(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """Composition: (t,q,s)_i * (t,q,s)_j."""
    t = sim3_t(Ti) + sim3_s(Ti) * quat_act(sim3_q(Ti), sim3_t(Tj))
    q = quat_mul(sim3_q(Ti), sim3_q(Tj))
    s = sim3_s(Ti) * sim3_s(Tj)
    return torch.cat([t, q, s], dim=-1)


def sim3_inv(T: torch.Tensor) -> torch.Tensor:
    qinv = quat_inv(sim3_q(T))
    s_inv = 1.0 / sim3_s(T)
    t = -s_inv * quat_act(qinv, sim3_t(T))
    return torch.cat([t, qinv, s_inv], dim=-1)


def sim3_rel(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """Relative pose ``T_i^{-1} * T_j`` (relSim3, gn_kernels.cu:294-314)."""
    si_inv = 1.0 / sim3_s(Ti)
    s = si_inv * sim3_s(Tj)
    qi_inv = quat_inv(sim3_q(Ti))
    q = quat_mul(qi_inv, sim3_q(Tj))
    t = si_inv * quat_act(qi_inv, sim3_t(Tj) - sim3_t(Ti))
    return torch.cat([t, q, s], dim=-1)


def sim3_rel_sRt(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """``T_i^{-1} * T_j`` as ``[sR (row-major) | t]`` (..., 12), sR = s
    ``quat_to_R(q)`` (for a quaternion off unit norm not a rotation): the
    relative pose as the backend's edge reductions apply it to points."""
    Tij = sim3_rel(Ti, Tj)
    sR = sim3_s(Tij)[..., None] * quat_to_R(sim3_q(Tij))
    return torch.cat([sR.reshape(*sR.shape[:-2], 9), sim3_t(Tij)], dim=-1)


def _sim3_W_coeffs(theta_sq, sigma):
    """Coefficients (C, A, B) of W = C I + A Phi + B Phi^2.

    Mirrors lietorch rxso3 via expSim3 (gn_kernels.cu:388-415). The four-way
    branch structure (|sigma| ~ 0 x |theta| ~ 0) is reproduced with nested
    ``where``.
    """
    one = torch.ones_like(sigma)
    half = 0.5 * one
    theta = torch.sqrt(theta_sq)
    scale = torch.exp(sigma)

    small_sigma = torch.abs(sigma) < _EPS
    small_theta = torch.abs(theta) < _EPS

    sigma_safe = torch.where(small_sigma, torch.ones_like(sigma), sigma)
    theta_safe = torch.where(small_theta, torch.ones_like(theta), theta)
    theta_sq_safe = torch.where(small_theta, torch.ones_like(theta_sq), theta_sq)

    C = torch.where(small_sigma, one, (scale - one) / sigma_safe)

    # small sigma
    A_ss_lt = half
    B_ss_lt = one / 6.0
    A_ss = (one - torch.cos(theta_safe)) / theta_sq_safe
    B_ss = (theta_safe - torch.sin(theta_safe)) / (theta_sq_safe * theta_safe)

    # large sigma
    sigma_sq = sigma_safe * sigma_safe
    A_ls_lt = ((sigma_safe - one) * scale + one) / sigma_sq
    B_ls_lt = (scale * half * sigma_sq + scale - one - sigma_safe * scale) / (
        sigma_sq * sigma_safe
    )
    a = scale * torch.sin(theta_safe)
    b = scale * torch.cos(theta_safe)
    c = theta_sq_safe + sigma_sq
    A_ls = (a * sigma_safe + (one - b) * theta_safe) / (theta_safe * c)
    B_ls = (C - ((b - one) * sigma_safe + a * theta_safe) / c) / theta_sq_safe

    A = torch.where(
        small_sigma,
        torch.where(small_theta, A_ss_lt, A_ss),
        torch.where(small_theta, A_ls_lt, A_ls),
    )
    B = torch.where(
        small_sigma,
        torch.where(small_theta, B_ss_lt, B_ss),
        torch.where(small_theta, B_ls_lt, B_ls),
    )
    return C, A, B


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    C, A, B = _sim3_W_coeffs(theta_sq, sigma)
    Phi = skew(phi)
    Phi2 = Phi @ Phi
    eye = _eye3(phi, Phi.shape[:-2])
    return C[..., None] * eye + A[..., None] * Phi + B[..., None] * Phi2


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [tau, phi, sigma] -> Sim(3) (expSim3, gn_kernels.cu:365-432)."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = so3_exp(phi)
    s = torch.exp(sigma)
    W = _sim3_W(phi, sigma)
    t = (W @ tau[..., None])[..., 0]
    return torch.cat([t, q, s], dim=-1)


def sim3_log(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) -> tangent [tau, phi, sigma]: inverse of :func:`sim3_exp`."""
    phi = so3_log(sim3_q(T))
    sigma = torch.log(sim3_s(T))
    W = _sim3_W(phi, sigma)
    tau = torch.linalg.solve(W, sim3_t(T)[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_retr(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left retraction ``exp(xi) * T`` (retrSim3, gn_kernels.cu:434-455)."""
    return sim3_mul(sim3_exp(xi), T)


def sim3_retr_right(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right retraction ``T * exp(xi)`` (retrSim3Right, gn_kernels.cu:457-480)."""
    return sim3_mul(T, sim3_exp(xi))


def sim3_apply_adj_inv(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Row-vector times inverse adjoint: ``Y = X @ Adj(T)^{-1}`` for 7-dim
    covectors ordered [tau, omega, sigma] (apply_Sim3_adj_inv,
    gn_kernels.cu:319-339)."""
    t, q, s = sim3_t(T), sim3_q(T), sim3_s(T)
    s_inv = 1.0 / s
    a, b, c = X[..., :3], X[..., 3:6], X[..., 6:7]
    Ra = quat_act(q, a)
    y1 = s_inv * Ra
    y2 = quat_act(q, b) + s_inv * _cross(t, Ra)
    y3 = c + s_inv * torch.sum(t * Ra, dim=-1, keepdim=True)
    return torch.cat([y1, y2, y3], dim=-1)


def sim3_to_matrix(T: torch.Tensor) -> torch.Tensor:
    M = torch.zeros((*T.shape[:-1], 4, 4), dtype=T.dtype, device=T.device)
    M[..., :3, :3] = sim3_s(T)[..., None] * quat_to_R(sim3_q(T))
    M[..., :3, 3] = sim3_t(T)
    M[..., 3, 3] = 1.0
    return M


def sim3_from_matrix(M: torch.Tensor) -> torch.Tensor:
    sR = M[..., :3, :3]
    s = torch.linalg.det(sR) ** (1.0 / 3.0)
    q = R_to_quat(sR / s[..., None, None])
    return torch.cat([M[..., :3, 3], q, s[..., None]], dim=-1)


def sim3_to_se3(T: torch.Tensor) -> torch.Tensor:
    """Drop the scale (TUM-format export, evaluate.py:40)."""
    return T[..., :7]
