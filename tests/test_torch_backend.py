"""PyTorch port vs JAX package: the backend factor graph (edge insertion,
gating, eviction, window build, window solve), the symmetric pair decode
+ match and the tracker's consecutive-edge half, on the same numpy inputs.

Bars: integers and masks exact, floats atol 1e-6 (solved poses 1e-5);
where the real matcher runs, match agreement >= 0.97 (the pair decode is
batch-size sensitive at float level; tests/test_global_opt.py:554-562).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.config import make_config as j_make_config
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.slam import backend as jbe
from frodo_slam_tpu.slam import frame as jframe
from frodo_slam_tpu.slam import global_opt as jgo
from frodo_slam_tpu.slam import inference as jinf
from frodo_slam_tpu.slam import tracker as jtr
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.ops import matching as tmatching
from frodo_slam_tpu_torch.slam import backend as tbe
from frodo_slam_tpu_torch.slam import frame as tframe
from frodo_slam_tpu_torch.slam import global_opt as tgo
from frodo_slam_tpu_torch.slam import inference as tinf
from frodo_slam_tpu_torch.slam import tracker as ttr

from test_torch_global_opt import make_world, perturb

torch.set_num_threads(1)

H, W = 32, 64
HW = H * W


@pytest.fixture(scope="module")
def tiny():
    """Converted random tiny weights with shared heads and decoders, so
    identical features decode consistently and the matcher finds matches."""
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]
    params["dec_blocks2"] = params["dec_blocks"]
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    return params, jcfg, model


def _match_cfg(**kw):
    mc = dict(j_make_config().matching, refine_impl="gather", **kw)
    return tuple(sorted(mc.items()))


def _graphs(tiny, h=H, w=W, max_edges=8, max_odom=4, match_cfg=(), K=None, **cfg_kw):
    """JAX and port graphs of the same configuration; ``K``, the port
    graph's calibration (None: a ray graph)."""
    params, jcfg, model = tiny
    jg = jbe.BackendGraph(params, jcfg, jgo.BAConfig(**cfg_kw), match_cfg, (h, w),
                          max_edges=max_edges, max_odom=max_odom)
    tg = tbe.BackendGraph(model, tgo.BAConfig(**cfg_kw), match_cfg, (h, w),
                          max_edges=max_edges, max_odom=max_odom, K=K)
    return jg, tg


def _payload(rng, hw):
    """(idx_i2j, idx_j2i, valid_j, valid_i, Qj, Qi) numpy rows of one pair."""
    return (rng.integers(0, hw, hw).astype(np.int32), rng.integers(0, hw, hw).astype(np.int32),
            rng.uniform(size=hw) > 0.1, rng.uniform(size=hw) > 0.1,
            rng.uniform(0, 4, hw).astype(np.float32), rng.uniform(0, 4, hw).astype(np.float32))


def _cache(rng, hw):
    return tuple(rng.normal(size=s).astype(np.float32) for s in ((3, hw), (hw,), (3, hw), (hw,)))


def _insert_both(jg, tg, i, j, rng, hw):
    p, c = _payload(rng, hw), _cache(rng, hw)
    jg._insert_pair(i, j, *(jnp.asarray(a) for a in p), cache=tuple(jnp.asarray(a) for a in c))
    tg._insert_pair(i, j, *(torch.from_numpy(a) for a in p),
                    cache=tuple(torch.from_numpy(a) for a in c))


def _assert_edges_equal(je, te, rows=None):
    for f in jgo.Edges._fields:
        a, b = getattr(je, f), getattr(te, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy()[:rows], np.asarray(a)[:rows], err_msg=f)


def test_invert_match_matches_jax():
    """Exact ``seeded``; exact values at targets that exactly one valid
    source hits (a colliding target keeps an unspecified winner)."""
    rng = np.random.default_rng(0)
    b, hw = 2, 300
    idx = rng.integers(0, hw, (b, hw)).astype(np.int32)
    valid = rng.uniform(size=(b, hw, 1)) > 0.3
    sj, seeded_j = jbe._invert_match(jnp.asarray(idx), jnp.asarray(valid))
    st, seeded_t = tbe._invert_match(torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(seeded_t.numpy(), np.asarray(seeded_j))
    assert st.dtype == torch.int32
    for r in range(b):
        hits = np.bincount(idx[r][valid[r, :, 0]], minlength=hw)
        unique = hits == 1
        np.testing.assert_array_equal(st.numpy()[r][unique], np.asarray(sj)[r][unique])
        np.testing.assert_array_equal(st.numpy()[r][hits == 0], np.arange(hw)[hits == 0])
        assert unique.sum() > 50 and (hits > 1).sum() > 10  # both cases exercised


def test_ingest_pairs_matches_jax():
    rng = np.random.default_rng(1)
    n, hw = 2, 257
    f = lambda *s: rng.uniform(0.2, 3.0, s).astype(np.float32)  # noqa: E731
    args = [f(n, hw, 3), f(n, hw, 1), np.array([1, 3], np.int32),
            f(n, hw, 3), f(n, hw, 1), np.array([0, 2], np.int32),
            rng.integers(0, hw, (n, hw)).astype(np.int32), rng.integers(0, hw, (n, hw)).astype(np.int32),
            rng.uniform(size=(n, hw, 1)) > 0.2, rng.uniform(size=(n, hw, 1)) > 0.2,
            f(n, hw, 1), f(n, hw, 1), f(n, hw, 1), f(n, hw, 1)]
    gates = (1.2, 1.5, 0.4)
    out_j = jbe._ingest_pairs(*(jnp.float32(g) for g in gates), *(jnp.asarray(a) for a in args))
    out_t = tbe._ingest_pairs(*gates, *(torch.from_numpy(a) for a in args))
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), k
        if a.dtype == bool:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(k))
        else:
            np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=1e-6, err_msg=str(k))


def test_insert_shift_and_dead_edge_removal_match_jax(tiny):
    """Row writes, eviction shifts (with the fallback) and dead-edge
    compaction leave the same edge store and mirrors on both sides."""
    jg, tg = _graphs(tiny, 4, 8, max_edges=3, max_odom=3)
    rng = np.random.default_rng(2)
    for i, j in [(0, 5), (1, 6), (2, 7), (3, 8), (2, 3), (3, 4), (4, 5), (1, 2), (8, 9)]:
        _insert_both(jg, tg, i, j, rng, 32)
        assert tg._pairs == jg._pairs
        _assert_edges_equal(jg.edges, tg.edges)
    for k in range(4):  # odom ring wrap
        d = rng.normal(size=7).astype(np.float32)
        jg.add_odometry_factors(k, k + 1, d)
        tg.add_odometry_factors(k, k + 1, d)
    assert tg.evict_fallback_count == jg.evict_fallback_count > 0
    jg.remove_dead_edges(2)
    tg.remove_dead_edges(2)
    assert tg._pairs == jg._pairs and tg._odom_pairs == jg._odom_pairs
    assert tg._n_odom == jg._n_odom
    _assert_edges_equal(jg.edges, tg.edges)
    for f in jgo.OdomEdges._fields:
        np.testing.assert_array_equal(getattr(tg.odom, f).numpy(), np.asarray(getattr(jg.odom, f)))


def _stores(n_kf, hw, X, T, cap=16, n_tok=2, enc_dim=4, feat=None, pos=None):
    js = jframe.make_keyframe_store(cap, hw, n_tok=n_tok, enc_dim=enc_dim)
    js = dataclasses.replace(
        js, T_WC=js.T_WC.at[:n_kf].set(jnp.asarray(T)), X_canon=js.X_canon.at[:n_kf].set(jnp.asarray(X)),
        C=js.C.at[:n_kf].set(5.0), N=js.N.at[:n_kf].set(1),
        n_size=jnp.int32(n_kf), n_total=jnp.int32(n_kf))
    ts = tframe.make_keyframe_store(cap, hw, n_tok, enc_dim)
    ts.T_WC[:n_kf] = torch.from_numpy(T)
    ts.X_canon[:n_kf] = torch.from_numpy(X)
    ts.C[:n_kf] = 5.0
    ts.N[:n_kf] = 1
    ts.n_size = ts.n_total = n_kf
    if feat is not None:
        js = dataclasses.replace(js, feat=js.feat.at[:n_kf].set(jnp.asarray(feat)), pos=jnp.asarray(pos))
        ts.feat[:n_kf] = torch.from_numpy(feat)
        ts.pos.copy_(torch.from_numpy(pos))
    return js, ts


def test_build_window_matches_jax_and_host_mirror(tiny):
    """The window (poses, points, confidences, bucketed edge rows, odometry
    rows, scale targets) equals JAX's; its endpoints, derived from the host
    mirrors, agree with the rows written on the device (the check of
    tests/test_global_opt.py:408)."""
    n_kf, h, w = 10, 8, 16
    hw = h * w
    jg, tg = _graphs(tiny, h, w, max_edges=6, max_odom=4, max_iters=1)
    rng = np.random.default_rng(4)
    for i, j in [(1, 7)] + [(i, i + 1) for i in range(n_kf - 1)]:
        _insert_both(jg, tg, i, j, rng, hw)
    for k in range(5):
        jg.add_odometry_factors(k, k + 1, np.asarray([0, 0, 0, 0, 0, 0, 1.0]))
        tg.add_odometry_factors(k, k + 1, np.asarray([0, 0, 0, 0, 0, 0, 1.0]))
    T = perturb(make_world(4, n_kf, 8)[0], 5).astype(np.float32)
    X = rng.normal(size=(n_kf, hw, 3)).astype(np.float32)
    js, ts = _stores(n_kf, hw, X, T)
    s_bar = np.linspace(0.5, 2.0, n_kf).astype(np.float32)
    wj, wt = jg._build_window(js, s_bar), tg._build_window(ts, s_bar)
    assert wt[0] == wj[0] and wt[1] == wj[1]
    for a, b in zip(wj[2:5], wt[2:5]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    _assert_edges_equal(wj[5], wt[5])
    # the port's window carries the written odometry slots only; JAX's rows
    # beyond them are never active
    n_o = len(tg._odom_pairs)
    assert wt[6].ii.shape[0] == n_o == 4 and not np.asarray(wj[6].active)[n_o:].any()
    for f in jgo.OdomEdges._fields:
        np.testing.assert_array_equal(getattr(wt[6], f).numpy(), np.asarray(getattr(wj[6], f))[:n_o])
    np.testing.assert_array_equal(wt[7].numpy(), np.asarray(wj[7]))

    uniq, kf_to_win = wt[0], {k: n for n, k in enumerate(wt[0])}
    n_rows = 2 * len(tg._pairs)
    for r in range(n_rows):
        assert int(wt[5].ii[r]) == kf_to_win[int(tg.edges.ii[r])]
        assert int(wt[5].jj[r]) == kf_to_win[int(tg.edges.jj[r])]
    assert not tg.edges.active[n_rows:wt[5].ii.shape[0]].any()
    assert len(uniq) == wt[1]


def test_eviction_protects_loop_closures_and_window_converges(tiny):
    """Capacity pressure evicts the oldest consecutive pairs, never the loop
    closures, and the bucketed window solve over the survivors converges
    (tests/test_global_opt.py:321)."""
    n_kf, h, w = 14, 16, 32
    hw = h * w
    T_true, X = make_world(3, n_kf, hw)
    _, tg = _graphs(tiny, h, w, max_edges=32, max_iters=20, delta_norm=1e-12)
    tg.edges = tgo.empty_edges(64, hw, with_cache=False)
    tg.max_edges = 8
    ident = torch.arange(hw, dtype=torch.int32)
    ones, q = torch.ones(hw, dtype=torch.bool), torch.full((hw,), 4.0)
    for i, j in [(0, 5), (2, 9)] + [(i, i + 1) for i in range(n_kf - 1)]:
        tg._insert_pair(i, j, ident, ident, ones, ones, q, q)
    assert len(tg._pairs) == 8 and (0, 5) in tg._pairs and (2, 9) in tg._pairs
    assert (0, 1) not in tg._pairs and (1, 2) not in tg._pairs
    assert tg.evict_fallback_count == 0

    T_init = perturb(T_true, 8).astype(np.float32)
    _, ts = _stores(n_kf, hw, X.astype(np.float32), T_init)
    uniq, p, T_new = tg.solve_window(ts)
    assert tg.last_solve["edge_rows"] == 16 and tg.last_solve["iters"] >= 1
    kf_to_win = {k: n for n, k in enumerate(uniq)}
    from frodo_slam_tpu_torch.ops import lie as tlie
    Tt, Ti = torch.from_numpy(T_true), torch.from_numpy(T_init.astype(np.float64))
    for i, j in tg._pairs:
        rel = tlie.sim3_rel(T_new[kf_to_win[i]].double(), T_new[kf_to_win[j]].double())
        err = float(torch.linalg.norm(rel - tlie.sim3_rel(Tt[i], Tt[j])))
        err0 = float(torch.linalg.norm(tlie.sim3_rel(Ti[i], Ti[j]) - tlie.sim3_rel(Tt[i], Tt[j])))
        assert err < max(0.2 * err0, 1e-3), (i, j, err0, err)


def test_eviction_fallback_is_counted_and_logged(tiny, caplog):
    _, tg = _graphs(tiny, 4, 8, max_edges=3)
    rng = np.random.default_rng(5)
    for i, j in [(0, 5), (1, 6), (2, 7)]:
        tg._insert_pair(i, j, *(torch.from_numpy(a) for a in _payload(rng, 32)))
    with caplog.at_level(logging.WARNING):
        tg._insert_pair(3, 8, *(torch.from_numpy(a) for a in _payload(rng, 32)))
    assert tg.evict_fallback_count == 1 and (0, 5) not in tg._pairs
    assert any("eviction fallback" in r.message for r in caplog.records)
    tg._insert_pair(1, 2, *(torch.from_numpy(a) for a in _payload(rng, 32)))
    n_fb = tg.evict_fallback_count
    tg._insert_pair(4, 9, *(torch.from_numpy(a) for a in _payload(rng, 32)))
    assert tg.evict_fallback_count == n_fb and (1, 2) not in tg._pairs


def _feat_stores(jcfg, n_kf, T, X, seed=0):
    n_tok = (H // 16) * (W // 16)
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n_kf, n_tok, jcfg.enc_embed_dim)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H // 16), np.arange(W // 16), indexing="ij")
    pos = np.stack([yy, xx], -1).reshape(n_tok, 2).astype(np.int32)
    return _stores(n_kf, HW, X, T, cap=8, n_tok=n_tok, enc_dim=jcfg.enc_embed_dim,
                   feat=feat, pos=pos)


def test_backend_graph_with_fixed_match_matches_jax(tiny, monkeypatch):
    """add_factors (consecutive and loop pairs, the gate fetch) + window
    solve with ``match_symmetric`` replaced on both sides by one fixed
    numpy match: edge store, mirrors, window and solved poses equal JAX."""
    params, jcfg, model = tiny
    n_kf = 4
    T_true, X = make_world(6, n_kf, HW)
    T0 = perturb(T_true, 7).astype(np.float32)
    js, ts = _feat_stores(jcfg, n_kf, T0, X.astype(np.float32))
    rng = np.random.default_rng(8)

    def fixed(n):
        idx = np.clip(np.arange(HW)[None] + rng.integers(-1, 2, (2, n, HW)), 0, HW - 1)
        valid = rng.uniform(size=(2, n, HW, 1)) > 0.1
        Q = rng.uniform(1.0, 4.0, (4, n, HW, 1)).astype(np.float32)
        return (idx[0].astype(np.int32), idx[1].astype(np.int32), valid[0], valid[1], *Q)

    calls = [fixed(2), fixed(1)]
    state = {"j": 0, "t": 0}

    def fake(side, conv):
        def fn(*a, **k):
            out = calls[state[side]]
            state[side] += 1
            return tuple(conv(x) for x in out)
        return fn

    monkeypatch.setattr(jbe, "match_symmetric", fake("j", jnp.asarray))
    # the port's backend reaches it through inference.match_symmetric_split
    monkeypatch.setattr(tinf, "match_symmetric", fake("t", torch.from_numpy))
    mc = _match_cfg()
    jg, tg = _graphs(tiny, match_cfg=mc, max_edges=4, max_odom=2, max_iters=10, Q_conf=1.5)
    for g, s in ((jg, js), (tg, ts)):
        assert g.add_factors(s, [0, 1], [1, 2])
        g.add_factors(s, [0], [3], min_match_frac=0.5)  # a loop pair: gated on the fetch
    assert tg._pairs == jg._pairs and len(tg._pairs) == 3
    for f in ("ii", "jj", "idx", "valid", "active"):
        np.testing.assert_array_equal(getattr(tg.edges, f).numpy(), np.asarray(getattr(jg.edges, f)))
    for f in ("Q", "XiT", "w0"):
        np.testing.assert_allclose(getattr(tg.edges, f).numpy(), np.asarray(getattr(jg.edges, f)),
                                   atol=1e-6, rtol=1e-6)
    uj, pj, Tj = jg.solve_window_rays(js)
    ut, pt, Tt = tg.solve_window(ts)
    assert (ut, pt) == (uj, pj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    tg._write_back(ts, ut, pt, Tt)
    np.testing.assert_allclose(ts.T_WC[:n_kf].numpy(), np.asarray(Tj)[:n_kf], atol=1e-5)


def test_match_symmetric_and_add_factors_agree_with_jax(tiny):
    """The real symmetric decode + cold match (f32 refine on both sides):
    decoded Q maps close, edge matches agree on >= 97% of pixels."""
    params, jcfg, model = tiny
    n_kf = 3
    T_true, X = make_world(9, n_kf, HW)
    js, ts = _feat_stores(jcfg, n_kf, T_true.astype(np.float32), X.astype(np.float32), seed=1)
    mc = _match_cfg()
    outj = jinf.match_symmetric(params, jcfg, dict(mc), js.feat[:2], js.pos[None].repeat(2, 0),
                                js.feat[1:3], js.pos[None].repeat(2, 0), (H, W))
    outt = tinf.match_symmetric(model, mc, ts.feat[:2], ts.pos[None].expand(2, -1, -1),
                                ts.feat[1:3], ts.pos[None].expand(2, -1, -1), (H, W))
    for k in (0, 1):
        assert (outt[k].numpy() == np.asarray(outj[k])).mean() >= 0.97
    for k in range(4, 8):
        np.testing.assert_allclose(outt[k].numpy(), np.asarray(outj[k]), rtol=1e-3, atol=1e-4)
    jg, tg = _graphs(tiny, match_cfg=mc, max_edges=4, max_odom=2, Q_conf=0.0)
    assert jg.add_factors(js, [0], [1]) and tg.add_factors(ts, [0], [1])
    assert (tg.edges.idx[:2].numpy() == np.asarray(jg.edges.idx[:2])).mean() >= 0.97


def test_add_consecutive_half_matches_add_factors(tiny):
    """The half-reuse path writes the same two rows as the symmetric path,
    statistically (tests/test_global_opt.py:481), seed_consecutive off."""
    params, jcfg, model = tiny
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(2, HW, 3)) + [0, 0, 5.0]).astype(np.float32)
    T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (2, 1))
    _, ts = _feat_stores(jcfg, 2, T, X)
    mc = _match_cfg(seed_consecutive=False)
    g_full = tbe.BackendGraph(model, tgo.BAConfig(max_iters=2), mc, (H, W), max_edges=4, max_odom=2)
    assert g_full.add_factors(ts, [0], [1])
    pos = ts.pos[None]
    res11, res21 = tinf.decode_asymmetric(model, ts.feat[1][None], pos, ts.feat[0][None], pos, (H, W))
    cold, _ = tmatching.split_match_cfg(dict(mc))
    idx_j2i, valid_i = tmatching.match(res11["pts3d"], res21["pts3d"], res11["desc"],
                                       res21["desc"], None, **cold)
    half = (idx_j2i, valid_i, res11["desc_conf"].reshape(1, HW, 1),
            res21["desc_conf"].reshape(1, HW, 1))
    g_half = tbe.BackendGraph(model, tgo.BAConfig(max_iters=2), mc, (H, W), max_edges=4, max_odom=2)
    assert g_half.add_consecutive_half(ts, 0, 1, half)
    assert g_full._pairs == g_half._pairs == [(0, 1)]
    for f in ("ii", "jj", "active"):
        assert torch.equal(getattr(g_full.edges, f)[:2], getattr(g_half.edges, f)[:2])
    agree = (g_full.edges.idx[:2] == g_half.edges.idx[:2]).numpy()
    assert agree.mean() > 0.97
    vf, vh = g_full.edges.valid[:2].numpy(), g_half.edges.valid[:2].numpy()
    assert (vf == vh)[agree].mean() > 0.999
    for f in ("Q", "w0"):
        np.testing.assert_allclose(getattr(g_full.edges, f)[:2].numpy()[agree],
                                   getattr(g_half.edges, f)[:2].numpy()[agree], atol=1e-3)


def test_track_result_pair_half_matches_jax(tiny):
    """TrackResult.pair_half (the raw pre-fnn projective half) on the same
    frame: match agreement >= 0.97, Q maps atol 1e-4."""
    params, jcfg, model = tiny
    img = np.random.default_rng(1).normal(size=(1, H, W, 3)).astype(np.float32)
    fj, pj = jmast3r.encode_image(params, jcfg, jnp.asarray(img))
    ft, pt = tmast3r.encode_image(model, torch.from_numpy(img))
    match_cfg = (("dilation_max", 2), ("max_iter", 6), ("radius", 2), ("refine_impl", "gather"))
    cfg_kw = dict(max_iters=10, Q_conf=0.0, match_frac_thresh=1.1, min_match_frac=0.0)

    Xj, Cj = jinf.decode_mono(params, jcfg, fj, pj, (H, W))
    kfj = jframe.make_empty_frame(0, jnp.asarray(img), fj, pj)
    kfj = dataclasses.replace(kfj, **dict(zip(("X_canon", "C", "N", "N_updates"), jframe.update_pointmap(
        kfj.X_canon, kfj.C, kfj.N, kfj.N_updates, Xj, Cj))))
    _, _, rj = jtr.track_step(params, jcfg, jtr.TrackingCfg(**cfg_kw), match_cfg, (H, W), kfj,
                              jframe.make_empty_frame(1, jnp.asarray(img), fj, pj), None)
    Xt, Ct = tinf.decode_mono(model, ft, pt, (H, W))
    kft = tframe.make_empty_frame(0, torch.from_numpy(img), ft, pt)
    kft = dataclasses.replace(kft, **dict(zip(("X_canon", "C", "N", "N_updates"), tframe.update_pointmap(
        kft.X_canon, kft.C, kft.N, kft.N_updates, Xt, Ct))))
    _, _, rt = ttr.track_step(model, ttr.TrackingCfg(**cfg_kw), match_cfg, (H, W), kft,
                              tframe.make_empty_frame(1, torch.from_numpy(img), ft, pt), None)
    (ij, vj, qfj, qkj), (it, vt, qft, qkt) = rj.pair_half, rt.pair_half
    assert tuple(it.shape) == (1, HW) and tuple(vt.shape) == (1, HW, 1)
    assert tuple(qft.shape) == tuple(qkt.shape) == (1, HW, 1)
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.97
    assert (vt.numpy() == np.asarray(vj)).mean() >= 0.97
    np.testing.assert_allclose(qft.numpy(), np.asarray(qfj), atol=1e-4)
    np.testing.assert_allclose(qkt.numpy(), np.asarray(qkj), atol=1e-4)


def test_kf_update_and_snapshot(tiny):
    store = tframe.make_keyframe_store(4, 8, 2, 4)
    T = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    tframe.kf_update_T_WCs(store, T, [3, 1])
    assert torch.equal(store.T_WC[3], T[0]) and torch.equal(store.T_WC[1], T[1])
    snap = tframe.kf_snapshot(store, store.T_WC.device)
    store.T_WC[0] = 7.0
    store.X_canon[2] = 1.0
    assert snap.T_WC[0, 0] == 0.0 and snap.X_canon[2].abs().sum() == 0
    assert snap.capacity == store.capacity and snap.n_total == store.n_total
