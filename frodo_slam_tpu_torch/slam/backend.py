"""Backend orchestration: factor-graph bookkeeping around the GN solver.

Behavioral spec: ``mast3r_slam/global_opt.py`` ``FactorGraph`` host logic —
``add_factors`` edge gating (:69-141), ``add_odometry_factors`` (:55-67),
ring-buffer edge eviction ``_materialise_edges`` (:143-178), unique-window
construction and pin semantics (:180-224, gn_kernels.cu:208-212) — with the
JAX package's ``slam/backend.py`` as the reference of this port.

Edges live in fixed-capacity padded device tensors (:class:`Edges`,
:class:`OdomEdges`) that are written IN PLACE, row by row, where the JAX
package donates and rebuilds the buffers. The host keeps small mirrors
(python lists of logical (ii, jj) keyframe pairs) for gating, eviction and
window membership, so no decision there waits on the device except the gate
fractions of a non-consecutive pair.

Under a :class:`~..parallel.mesh.Placement` the graph lives on the
placement's solve device: its edge and odometry rows, the window tensors and
the solve (split over the backend's devices, see :mod:`.global_opt`). The
pair decode runs on per-rank replicas of the decoder and heads built from
the model at construction (:func:`~..parallel.mesh.backend_replicas`), the
pair batch split over the ranks. Every read of the keyframe store gathers on
the store's device and copies the rows to the graph's (:meth:`BackendGraph._gather`),
and the write-back returns the poses to the store's device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import matching
from ..ops.geometry import constrain_points_to_ray
from ..utils import spans
from ..utils.log import get_logger
from ..parallel.mesh import backend_replicas
from . import frame as frame_mod
from .frame import KeyframeStore
from .global_opt import (BAConfig, Edges, OdomEdges, empty_edges, empty_odom_edges, solve_gn_calib,
                         solve_gn_rays)
from .inference import decode_asymmetric, match_symmetric_split

log = get_logger("backend")


def write_pair_rows(edges: Edges, r0: int, i: int, j: int, idx_i2j, idx_j2i,
                    valid_j, valid_i, Qj, Qi, cache=None) -> Edges:
    """Write both directed rows of one pair in place. ``cache``: optional
    (XiT_r0, w0_r0, XiT_r1, w0_r1) from :func:`_ingest_pairs`, the edge's
    pose-independent solver inputs (see :class:`Edges`)."""
    r1 = r0 + 1
    edges.ii[r0], edges.ii[r1] = i, j
    edges.jj[r0], edges.jj[r1] = j, i
    edges.idx[r0], edges.idx[r1] = idx_i2j.to(torch.int32), idx_j2i.to(torch.int32)
    edges.valid[r0], edges.valid[r1] = valid_j, valid_i
    edges.Q[r0], edges.Q[r1] = Qj.to(edges.Q.dtype), Qi.to(edges.Q.dtype)
    edges.active[r0:r1 + 1] = True
    if cache is not None and edges.XiT is not None:
        XiT_r0, w0_r0, XiT_r1, w0_r1 = cache
        edges.XiT[r0], edges.XiT[r1] = XiT_r0, XiT_r1
        edges.w0[r0], edges.w0[r1] = w0_r0, w0_r1
    return edges


def _invert_match(idx_j2i, valid_match_i):
    """Approximate inverse of a dense match: ``idx_j2i`` maps each query
    pixel p to a target pixel; the result maps each target pixel back to p
    (identity where no valid inverse exists; when several sources hit one
    target, one of them wins, unspecified which).

    Returns ``(idx_seed, seeded)``; ``seeded`` (b, hw) marks pixels that
    received a genuine inverse. Invalid sources go to the drop slot ``hw``."""
    b, hw = idx_j2i.shape
    dev = idx_j2i.device
    ident = torch.arange(hw, dtype=torch.int32, device=dev).expand(b, hw)
    src = torch.where(valid_match_i[..., 0], idx_j2i.long(), hw)
    # value ident + 1, 0 meaning "hole"; one extra column takes the drops
    packed = torch.zeros((b, hw + 1), dtype=torch.int32, device=dev)
    packed.scatter_(1, src, ident + 1)
    packed = packed[:, :hw]
    seeded = packed > 0
    return torch.where(seeded, packed - 1, ident), seeded


def _ingest_pairs(q_conf_gate, q_conf_ba, c_conf, X_i, C_i, n_i, X_j, C_j, n_j,
                  idx_i2j, idx_j2i, valid_match_j, valid_match_i, Qii, Qjj, Qji, Qij):
    """Gating and the pose-independent edge cache for a batch of pairs, with
    the gate's Q lookup and the cache's point lookup in one row gather.

    Combined confidences and bidirectional gating follow
    global_opt_bk0.py:107-147. ``n_*``: fusion counts normalizing the stored
    confidence sums. Shapes: X_* (N, HW, 3), C_* (N, HW, 1), n_* (N,),
    idx_* (N, HW), valid_match_* (N, HW, 1), Q** (N, HW, 1).
    Returns (Qj, Qi, valid_j, valid_i, fracs, XiT_r0, w0_r0, XiT_r1, w0_r1).
    """
    Cin = C_i[..., 0] / torch.clamp(n_i, min=1)[:, None].to(C_i.dtype)
    Cjn = C_j[..., 0] / torch.clamp(n_j, min=1)[:, None].to(C_j.dtype)

    def one_dir(X_a, C_a, Q_aa, C_b, Q_ba, idx, valid_match):
        table = torch.cat([X_a, C_a[..., None], Q_aa], dim=-1)  # (N, HW, 5)
        rows = torch.gather(table, 1, idx.long()[..., None].expand(-1, -1, 5))
        Xg, Cg, Qg = rows[..., :3], rows[..., 3], rows[..., 4]
        Qcomb = torch.sqrt(Qg * Q_ba[..., 0])
        valid = valid_match[..., 0] & (Qcomb > q_conf_gate)
        ok = valid & (Qcomb > q_conf_ba) & (Cg > c_conf) & (C_b > c_conf)
        w0 = ok.to(X_a.dtype) * torch.sqrt(Qcomb)
        return Qcomb, valid, Xg.transpose(1, 2), w0

    Qj, valid_j, XiT_r0, w0_r0 = one_dir(X_i, Cin, Qii, Cjn, Qji, idx_i2j, valid_match_j)
    Qi, valid_i, XiT_r1, w0_r1 = one_dir(X_j, Cjn, Qjj, Cin, Qij, idx_j2i, valid_match_i)
    fracs = torch.stack([valid_j.float().mean(1), valid_i.float().mean(1)], dim=-1)
    return (Qj[..., None], Qi[..., None], valid_j[..., None], valid_i[..., None],
            fracs, XiT_r0, w0_r0, XiT_r1, w0_r1)


def consecutive_half_rows(model, match_cfg, img_hw, gates, feat_i, pos_i, feat_j, pos_j, half,
                          side_i, side_j):
    """The two rows of the consecutive edge (i, j), reusing the tracker's
    half of the pair decode (``TrackResult.pair_half`` of the frame that
    became keyframe ``j``: decode(j, i) and its match). Only decode(i, j)
    and one match remain. With ``seed_consecutive`` (default on) that match
    is seeded with the inverse of the tracker's match and keeps only
    genuinely seeded pixels.

    ``gates``: (Q_conf gate, BA Q_conf, C_conf) of :func:`_ingest_pairs`;
    ``side_*``: (X (1, HW, 3), C (1, HW, 1), n (1,)) of keyframe i / j.
    Returns (idx_i2j, idx_j2i, valid_j, valid_i, Qj, Qi, cache), the pair's
    rows as :func:`write_pair_rows` takes them."""
    idx_j2i, valid_match_i, Qjj, Qij = half
    hw = img_hw[0] * img_hw[1]
    res11, res21 = decode_asymmetric(model, feat_i, pos_i, feat_j, pos_j, img_hw)
    mc = dict(match_cfg)
    if bool(mc.get("seed_consecutive", True)):
        idx_seed, seeded = _invert_match(idx_j2i, valid_match_i)
        idx_i2j, valid_match_j = matching.match(
            res11["pts3d"], res21["pts3d"], res11["desc"], res21["desc"], idx_seed,
            **matching.seed_match_cfg(mc))
        valid_match_j = valid_match_j & seeded[..., None]
    else:
        cold_cfg, _ = matching.split_match_cfg(mc)
        idx_i2j, valid_match_j = matching.match(
            res11["pts3d"], res21["pts3d"], res11["desc"], res21["desc"], None, **cold_cfg)
    flat1 = lambda x: x.reshape(1, hw, 1)  # noqa: E731
    (Qj, Qi, valid_j, valid_i, _fracs, XiT_r0, w0_r0, XiT_r1, w0_r1) = _ingest_pairs(
        *gates, *side_i, *side_j, idx_i2j, idx_j2i, valid_match_j, valid_match_i,
        flat1(res11["desc_conf"]), Qjj, flat1(res21["desc_conf"]), Qij)
    return (idx_i2j[0], idx_j2i[0], valid_j[0, :, 0], valid_i[0, :, 0], Qj[0, :, 0], Qi[0, :, 0],
            (XiT_r0[0], w0_r0[0], XiT_r1[0], w0_r1[0]))


def _shift_pair_rows(edges: Edges, pair_idx: int) -> Edges:
    """Evict pair ``pair_idx`` in place: later rows move down by two and the
    freed tail rows are zeroed."""
    r = 2 * pair_idx
    for a in edges:
        if a is None:
            continue
        a[r:-2] = a[r + 2:].clone()
        a[-2:] = 0
    return edges


class BackendGraph:
    """Host-side factor graph over a :class:`KeyframeStore`.

    ``model`` is the MASt3R module. ``self.replicas`` decode the pairs, one
    a dp rank: without a ``placement`` that is ``[model]`` and its
    parameters' device is the graph's; with one, the graph lives on
    ``placement.solve_device`` and the replicas are per-rank copies of the
    model's decoder and heads. ``K`` (3, 3), the calibration, picks the
    window solve's residual once: with it the calibrated pixel/log-depth
    solve, without it the ray alignment (:meth:`solve_window`)."""

    def __init__(self, model, cfg: BAConfig, match_cfg: tuple, img_hw: Tuple[int, int],
                 max_edges: int = 64, max_odom: int = 64, Q_conf: float = 1.5,
                 min_match_frac: float = 0.1, placement=None, K: Optional[torch.Tensor] = None):
        self.model = model
        self.placement = placement
        if placement is None:
            self.replicas = [model]
            self.device = next(model.parameters()).device
        else:
            self.replicas = backend_replicas(model, placement)
            self.device = placement.solve_device
        self.K = None if K is None else K.to(self.device)
        self.cfg = cfg
        self.match_cfg = match_cfg
        self.img_hw = img_hw
        self.hw = img_hw[0] * img_hw[1]
        self.Q_conf = Q_conf
        self.min_match_frac = min_match_frac
        self.max_edges = max_edges
        self.max_odom = max_odom
        self.edges = empty_edges(2 * max_edges, self.hw, device=self.device)  # two rows a pair
        self.odom = empty_odom_edges(max_odom, device=self.device)
        # host mirrors: logical keyframe indices per stored pair / odom edge
        self._pairs: List[Tuple[int, int]] = []
        self._odom_pairs: List[Tuple[int, int]] = []
        self._n_odom = 0
        self.evict_fallback_count = 0  # non-consecutive (loop) evictions
        self.last_solve: dict = {}  # GN iterations, poses and edge rows of the last solve

    def reset(self):
        self.edges = empty_edges(2 * self.max_edges, self.hw, device=self.device)
        self.odom = empty_odom_edges(self.max_odom, device=self.device)
        self._pairs = []
        self._odom_pairs = []
        self._n_odom = 0

    # -- edge insertion ----------------------------------------------------

    def add_odometry_factors(self, ii: int, jj: int, delta_T):
        """(global_opt.py:55-67): ``delta_T`` is the measured SE3 T_ii_jj."""
        slot = self._n_odom % self.max_odom
        self.odom.ii[slot] = ii
        self.odom.jj[slot] = jj
        self.odom.delta_T[slot] = torch.as_tensor(np.asarray(delta_T)[:7], dtype=torch.float32)
        self.odom.active[slot] = True
        if slot < len(self._odom_pairs):
            self._odom_pairs[slot] = (ii, jj)
        else:
            self._odom_pairs.append((ii, jj))
        self._n_odom += 1

    def _gather(self, slots, *ts):
        """Rows ``slots`` of the store tensors ``ts``, gathered on the
        store's device (one index) and copied to the graph's."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=ts[0].device)
        return [t[idx].to(self.device) for t in ts]

    def _ingest(self, store: KeyframeStore, slots_i, slots_j, idx_i2j, idx_j2i,
                valid_match_j, valid_match_i, Qii, Qjj, Qji, Qij):
        return _ingest_pairs(
            self.Q_conf, self.cfg.Q_conf, self.cfg.C_conf,
            *self._gather(slots_i, store.X_canon, store.C, store.N),
            *self._gather(slots_j, store.X_canon, store.C, store.N),
            idx_i2j, idx_j2i, valid_match_j, valid_match_i, Qii, Qjj, Qji, Qij)

    @torch.no_grad()
    def add_factors(self, store: KeyframeStore, ii: List[int], jj: List[int],
                    min_match_frac: Optional[float] = None, is_reloc: bool = False) -> bool:
        """Batched symmetric decode + match + bidirectional gating
        (global_opt.py:69-141). ``ii``/``jj`` are logical keyframe indices.
        Returns True if any edge was accepted."""
        if not ii:
            return False
        mmf = self.min_match_frac if min_match_frac is None else min_match_frac
        slots_i = [int(i) % store.capacity for i in ii]
        slots_j = [int(j) % store.capacity for j in jj]
        feat_i, = self._gather(slots_i, store.feat)
        feat_j, = self._gather(slots_j, store.feat)
        pos = store.pos.to(self.device)[None].expand(len(ii), *store.pos.shape)
        (idx_i2j, idx_j2i, valid_match_j, valid_match_i,
         Qii, Qjj, Qji, Qij) = match_symmetric_split(self.replicas, self.placement, self.match_cfg,
                                                     feat_i, pos, feat_j, pos, self.img_hw)
        (Qj, Qi, valid_j, valid_i, fracs, XiT_r0, w0_r0, XiT_r1, w0_r1) = self._ingest(
            store, slots_i, slots_j, idx_i2j, idx_j2i, valid_match_j, valid_match_i,
            Qii, Qjj, Qji, Qij)
        # the gate fractions decide only for reloc attempts and loop-closure
        # pairs; consecutive edges are inserted unconditionally
        # (global_opt.py:117-127), so skip the fetch when nothing gates
        need_fracs = is_reloc or any(i != j - 1 for i, j in zip(ii, jj))
        if need_fracs:
            fracs = fracs.cpu().numpy()
        added = False
        for n, (i, j) in enumerate(zip(ii, jj)):
            bad = need_fracs and float(fracs[n].min()) < mmf
            if bad and is_reloc:
                return False
            if bad and i != j - 1:
                continue
            self._insert_pair(i, j, idx_i2j[n], idx_j2i[n], valid_j[n, :, 0], valid_i[n, :, 0],
                              Qj[n, :, 0], Qi[n, :, 0],
                              cache=(XiT_r0[n], w0_r0[n], XiT_r1[n], w0_r1[n]))
            added = True
        return added

    @torch.no_grad()
    def add_consecutive_half(self, store: KeyframeStore, i: int, j: int, half) -> bool:
        """Insert the consecutive edge (i, j) from the tracker's half of the
        pair decode (:func:`consecutive_half_rows`). ``half`` may live on the
        tracker's device."""
        slot_i = int(i) % store.capacity
        slot_j = int(j) % store.capacity
        pos = store.pos.to(self.device)[None]
        feat, = self._gather([slot_i, slot_j], store.feat)
        *rows, cache = consecutive_half_rows(
            self.replicas[0], self.match_cfg, self.img_hw, (self.Q_conf, self.cfg.Q_conf, self.cfg.C_conf),
            feat[:1], pos, feat[1:], pos, tuple(t.to(self.device) for t in half),
            self._gather([slot_i], store.X_canon, store.C, store.N),
            self._gather([slot_j], store.X_canon, store.C, store.N))
        self._insert_pair(i, j, *rows, cache=cache)
        return True

    def _insert_pair(self, i, j, idx_i2j, idx_j2i, valid_j, valid_i, Qj, Qi, cache=None):
        """Write the two directed rows of pair (i, j); evict a pair first
        when full."""
        if len(self._pairs) >= self.max_edges:
            evict = self._pick_evict()
            self._pairs.pop(evict)
            self._shift_rows(evict)
        pair_slot = len(self._pairs)
        self._pairs.append((int(i), int(j)))
        write_pair_rows(self.edges, 2 * pair_slot, int(i), int(j), idx_i2j, idx_j2i,
                        valid_j, valid_i, Qj, Qi, cache=cache)

    def _pick_evict(self) -> int:
        """Under capacity pressure evict the oldest CONSECUTIVE pair that
        does not touch the two newest keyframes: loop closures are scarce and
        precious. Fall back to the globally oldest pair, counted and logged
        (raise ``tpu.max_edges`` if this fires in practice)."""
        newest = max(max(i, j) for i, j in self._pairs)
        for k, (pi, pj) in enumerate(self._pairs):
            if pi == pj - 1 and pj < newest - 1:
                return k
        self.evict_fallback_count += 1
        log.warning(
            "edge eviction fallback: no old consecutive pair at max_edges=%d; "
            "evicting pair %s (loop closure) — count=%d",
            self.max_edges, self._pairs[0], self.evict_fallback_count)
        return 0

    def _shift_rows(self, pair_idx: int):
        """Compact the padded rows after evicting pair ``pair_idx``."""
        _shift_pair_rows(self.edges, pair_idx)

    def remove_dead_edges(self, oldest_alive: int):
        """Drop edges touching overwritten ring slots (_materialise_edges,
        global_opt.py:143-178), compacting the survivors to the front."""
        keep = [k for k, (i, j) in enumerate(self._pairs)
                if i >= oldest_alive and j >= oldest_alive]
        if len(keep) != len(self._pairs):
            rows = torch.as_tensor([r for k in keep for r in (2 * k, 2 * k + 1)],
                                   dtype=torch.long, device=self.device)
            for a in self.edges:
                if a is not None:
                    a[: len(rows)] = a[rows]
                    a[len(rows):] = 0
            self._pairs = [self._pairs[k] for k in keep]
        keep_o = [k for k, (i, j) in enumerate(self._odom_pairs)
                  if i >= oldest_alive and j >= oldest_alive]
        if len(keep_o) != len(self._odom_pairs):
            rows = torch.as_tensor(keep_o, dtype=torch.long, device=self.device)
            for a in self.odom:
                a[: len(rows)] = a[rows]
                a[len(rows):] = 0
            self._odom_pairs = [self._odom_pairs[k] for k in keep_o]
            self._n_odom = len(self._odom_pairs)

    # -- solve ---------------------------------------------------------------

    def unique_kf_idx(self) -> List[int]:
        return sorted({k for p in self._pairs for k in p})

    def _build_window(self, store: KeyframeStore, s_bar: Optional[np.ndarray]):
        """Compact the live keyframes and edges into padded window tensors
        (global_opt.py:226-252). Poses pad to a power-of-two bucket (>= 8);
        the edge rows handed to the solver are the live prefix cut at a
        power-of-two pair bucket, so a solve streams what is live, not the
        store's capacity. Returns None when there is nothing to optimize."""
        self.remove_dead_edges(max(0, store.n_total - store.capacity))
        uniq = self.unique_kf_idx()
        if len(uniq) <= self.cfg.pin:
            return None
        p = len(uniq)
        bucket = 8
        while bucket < p:
            bucket *= 2
        pad = bucket - p
        kf_to_win = {k: n for n, k in enumerate(uniq)}

        slots = [k % store.capacity for k in uniq] + [uniq[-1] % store.capacity] * pad
        T_win, X_win, C_win, N_win = self._gather(slots, store.T_WC, store.X_canon, store.C, store.N)
        C_win = C_win / torch.clamp(N_win, min=1)[:, None, None].to(C_win.dtype)

        ebucket = 8
        while ebucket < len(self._pairs):
            ebucket *= 2
        rows = 2 * min(ebucket, self.max_edges)
        # window endpoints from the host mirrors; padded rows point at 0 and
        # are inactive
        e_ii = [0] * rows
        e_jj = [0] * rows
        for k, (pi, pj) in enumerate(self._pairs):
            e_ii[2 * k], e_jj[2 * k] = kf_to_win[pi], kf_to_win[pj]
            e_ii[2 * k + 1], e_jj[2 * k + 1] = e_jj[2 * k], e_ii[2 * k]
        as_i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=self.device)  # noqa: E731
        e = self.edges
        edges_win = Edges(ii=as_i32(e_ii), jj=as_i32(e_jj), idx=e.idx[:rows],
                          valid=e.valid[:rows], Q=e.Q[:rows], active=e.active[:rows],
                          XiT=None if e.XiT is None else e.XiT[:rows],
                          w0=None if e.w0 is None else e.w0[:rows])
        # odometry rows whose endpoints fell out of the window are disabled;
        # only the written slots (len(_odom_pairs)) can be active, so the
        # window carries those alone (the JAX package hands the solver all
        # max_odom slots): with no odometry the solve skips the factor
        n_o = len(self._odom_pairs)
        o_ii = [kf_to_win.get(int(oi), 0) for oi, _ in self._odom_pairs]
        o_jj = [kf_to_win.get(int(oj), 0) for _, oj in self._odom_pairs]
        o_act = [int(oi) in kf_to_win and int(oj) in kf_to_win for oi, oj in self._odom_pairs]
        odom_win = OdomEdges(ii=as_i32(o_ii), jj=as_i32(o_jj), delta_T=self.odom.delta_T[:n_o],
                             active=torch.as_tensor(o_act, dtype=torch.bool, device=self.device))
        vals = [-1.0] * bucket
        if s_bar is not None:
            vals = [float(s_bar[k]) if k < len(s_bar) else -1.0 for k in uniq] + [-1.0] * pad
        sb = torch.as_tensor(vals, dtype=torch.float32, device=self.device)
        return uniq, p, T_win, X_win, C_win, edges_win, odom_win, sb

    def _write_back(self, store: KeyframeStore, uniq, p, T_new) -> KeyframeStore:
        """Write the free poses back (global_opt.py:285-286), in place, on
        the store's device."""
        free = uniq[self.cfg.pin: p]
        if free:
            frame_mod.kf_update_T_WCs(store, T_new[self.cfg.pin: p],
                                      [k % store.capacity for k in free])
        return store

    def solve_window(self, store: KeyframeStore, s_bar: Optional[np.ndarray] = None):
        """Build the compacted window and run its GN (global_opt.py:226-341):
        with the graph's ``K`` the calibrated solve, the window's points
        constrained to their pixel rays first (:298-300); without, the
        ray-alignment solve. Returns ``(uniq, p, T_new)`` without writing
        back, so a threaded caller can merge into a store that advanced
        meanwhile; None when there is nothing to optimize."""
        with spans.span("backend.window"):
            win = self._build_window(store, s_bar)
            if win is None:
                return None
            uniq, p, T_win, X_win, C_win, edges_win, odom_win, sb = win
            if self.K is not None:
                X_win = constrain_points_to_ray(self.img_hw, X_win, self.K)
        stats: dict = {}
        # the live rows are the first 2 * len(_pairs): the kernels' sizing hint
        kw = dict(stats=stats, n_active=2 * len(self._pairs), placement=self.placement)
        with spans.span("backend.solve_rays" if self.K is None else "backend.solve_calib"):
            if self.K is None:
                T_new = solve_gn_rays(self.cfg, self.cfg.pin, T_win, X_win, C_win, edges_win, odom_win, sb, **kw)
            else:
                T_new = solve_gn_calib(self.cfg, self.cfg.pin, self.img_hw, T_win, X_win, C_win, self.K,
                                       edges_win, odom_win, sb, **kw)
        self.last_solve = dict(stats, poses=p, edge_rows=int(edges_win.ii.shape[0]))
        return uniq, p, T_new

    def solve_GN(self, store: KeyframeStore, s_bar: Optional[np.ndarray] = None) -> KeyframeStore:
        """:meth:`solve_window` and the immediate write-back (the serialized
        path)."""
        out = self.solve_window(store, s_bar)
        if out is None:
            return store
        return self._write_back(store, *out)
