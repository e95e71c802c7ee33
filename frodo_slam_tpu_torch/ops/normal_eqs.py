"""Sim(3) normal-equation reduction for residuals with Jacobian ``D . G``.

Every Sim(3) alignment residual here (tracking ray+distance, and the
backend's later) has a Jacobian that factors as ``J = D . G`` with
``G = [I | -skew(P) | P]`` (3x7) and ``D`` the residual's derivative wrt the
transformed point (R x 3 per point) — the structure the reference CUDA
kernels exploit row by row (gn_kernels.cu:749-858).

The JAX package scalar-expands the tiny R/3/3 dims because einsums over them
padded to the TPU's matrix tile; on the card the plain per-point product and
one einsum per output are the natural form, with the same outputs.

The backend's plain per-edge reductions (the calibrated edges' plain
version, the point-alignment residual) share :func:`reduce_rel_systems` and
its chunking over edges (:func:`edge_chunks`); the tracker's and the window
solve's Cholesky share :func:`safe_cholesky`.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

# points per step of the chunked per-edge reductions: bounds their
# (c, N, R, 8) Jacobian-and-residual rows to ~190 MB in f32 (10 edges at
# 512x384, R = 3)
EDGE_CHUNK_POINTS = 1 << 21
# each edge's sum over its rows is split into this many batched products: one
# (7 x 3N) by (3N x 8) product per edge keeps a card to one tile per edge
REL_REDUCE_SPLIT = 128


def reduce_sim3_system(
    drd_cols: Sequence[Sequence[torch.Tensor]],
    w_cols: Sequence[torch.Tensor],
    err_cols: Sequence[torch.Tensor],
    P: torch.Tensor,
):
    """Reduce weighted normal equations for residual rows ``D . G``.

    Args:
        drd_cols: R x 3 nested sequence of (n,) columns — ``D[d][a]`` is
            d(residual_d)/dP_a.
        w_cols: R columns of robust information weights.
        err_cols: R columns of residuals.
        P: (n, 3) transformed points (defines G).

    Returns:
        (B, g, cost): the 7x7 Gram ``G^T D^T W D G`` summed over points, the
        7-vector ``G^T D^T (w . err)``, and ``sum(w . err^2)`` (un-halved).
    """
    R = len(drd_cols)
    if len(w_cols) != R or len(err_cols) != R:
        raise ValueError("reduce_sim3_system: one weight and one error column per residual row")
    D = torch.stack([torch.stack(list(row), dim=-1) for row in drd_cols], dim=1)  # (n, R, 3)
    w = torch.stack(list(w_cols), dim=-1)  # (n, R)
    err = torch.stack(list(err_cols), dim=-1)  # (n, R)
    n = P.shape[0]
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(n, 3, 3)
    px, py, pz = P.unbind(-1)
    o = torch.zeros_like(px)
    neg_skew = torch.stack([o, pz, -py, -pz, o, px, py, -px, o], dim=-1).reshape(n, 3, 3)
    G = torch.cat([eye, neg_skew, P[:, :, None]], dim=-1)  # (n, 3, 7)
    J = torch.bmm(D, G)  # (n, R, 7)
    we = w * err
    B = torch.einsum("nri,nr,nrj->ij", J, w, J)
    g = torch.einsum("nri,nr->i", J, we)
    return B, g, torch.sum(we * err)


def ray_dist_drd_cols(r: torch.Tensor, d: torch.Tensor) -> List[List[torch.Tensor]]:
    """D columns for the [unit-ray (3), distance (1)] residual: rows are
    ``dnorm = (I - r r^T)/d`` (symmetric) and ``r^T`` (geometry.py:17-34)."""
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    inv_d = 1.0 / d
    D00 = (1.0 - rx * rx) * inv_d
    D01 = (-rx * ry) * inv_d
    D02 = (-rx * rz) * inv_d
    D11 = (1.0 - ry * ry) * inv_d
    D12 = (-ry * rz) * inv_d
    D22 = (1.0 - rz * rz) * inv_d
    return [[D00, D01, D02], [D01, D11, D12], [D02, D12, D22], [rx, ry, rz]]


def cols_from_array(drd: torch.Tensor) -> List[List[torch.Tensor]]:
    """(n, R, 3) materialized D -> nested column view."""
    return [[drd[:, d, a] for a in range(3)] for d in range(drd.shape[1])]


def edge_chunks(n_edges: int, n_pts: int) -> List[slice]:
    """Slices of ``n_edges`` edges of ``n_pts`` points each, at most
    :data:`EDGE_CHUNK_POINTS` points (and at least one edge) a slice."""
    step = max(1, EDGE_CHUNK_POINTS // max(n_pts, 1))
    return [slice(e0, min(n_edges, e0 + step)) for e0 in range(0, n_edges, step)]


def reduce_rel_systems(D, w, err, P):
    """Per-edge 7x7 Gram and gradient of residual rows ``D . [I | -skew(P) | P]``
    summed over the points: D (c, N, R, 3), w and err (c, N, R), P (c, N, 3).
    Row r of the Jacobian is ``[d_r, P x d_r, d_r . P]``; with the residual as
    an eighth column, one batched product ``(w J)^T [J | err]``, split along
    the points (:data:`REL_REDUCE_SPLIT`), gives both sums.
    Returns (B (c, 7, 7), g (c, 7))."""
    c, N, R, _ = D.shape
    Pb = P[:, :, None, :].expand_as(D)
    Ja = torch.cat([D, torch.linalg.cross(Pb, D, dim=-1), (D * Pb).sum(-1, keepdim=True),
                    err[..., None]], dim=-1)  # (c, N, R, 8)
    split = math.gcd(N * R, REL_REDUCE_SPLIT)
    Ja = Ja.reshape(c * split, N * R // split, 8)
    Jw = Ja[..., :7] * w.reshape(c * split, -1, 1)
    G = (Jw.transpose(1, 2) @ Ja).reshape(c, split, 7, 8).sum(1)
    return G[..., :7], G[..., 7]


def safe_cholesky(H: torch.Tensor, eye: torch.Tensor):
    """(L, ok): a Cholesky that never raises. A non-PD or non-finite H gives
    ok False and ``eye``, the identity of H's size and type, in place of L
    (JAX's cholesky returns NaN there); the caller builds ``eye``, once a
    solve where it can."""
    L, info = torch.linalg.cholesky_ex(H)
    ok = (info == 0) & torch.all(torch.isfinite(L))
    return torch.where(ok, L, eye), ok
