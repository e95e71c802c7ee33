"""PyTorch port vs JAX package: the calibrated tracker and backend, on the
same numpy inputs.

- ``opt_pose_calib_sim3``: f32 GN on both sides, poses atol 1e-5 (the same
  f32 operations summed in another order);
- the calibrated residual through the edge-system seam (``_edge_systems``)
  and the AdjInv wrap (``_adj_wrap``):
  f64 on both sides, each edge's A and gj within 1e-9 of that edge's
  largest entry (rounding only);
- ``solve_gn_calib`` and ``BackendGraph.solve_window`` (built with and
  without K, against JAX's ``solve_window_calib`` / ``solve_window_rays``):
  f32 edge systems and an f64 solve on both sides (the JAX suite runs under
  x64), poses atol 1e-5; the one-way world of tests/test_global_opt.py:159
  is recovered to that test's 5e-3;
- ``SLAM`` with a calibration, backend on: flags exact, poses atol 1e-4 (the
  bar of tests/test_torch_system.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.config import make_config as j_make_config
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.slam import global_opt as jgo
from frodo_slam_tpu.slam import tracker as jtr
from frodo_slam_tpu.slam.system import SLAM as JSLAM
from frodo_slam_tpu_torch.config import make_config as t_make_config
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.ops import lie as tlie
from frodo_slam_tpu_torch.ops import normal_eqs
from frodo_slam_tpu_torch.slam import global_opt as tgo
from frodo_slam_tpu_torch.slam import tracker as ttr
from frodo_slam_tpu_torch.slam.system import SLAM as TSLAM
from frodo_slam_tpu_torch.utils import spans

from test_torch_backend import _graphs, _stores, tiny  # noqa: F401  (fixture)
from test_torch_global_opt import j_edges, t_edges

torch.set_num_threads(1)

K = np.array([[20.0, 0, 16.0], [0, 22.0, 8.0], [0, 0, 1]])


def _backproject(h, w, z, K):
    v, u = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    x = (u.reshape(-1) - K[0, 2]) / K[0, 0]
    y = (v.reshape(-1) - K[1, 2]) / K[1, 1]
    return z[:, None] * np.stack([x, y, np.ones_like(x)], -1)


def calib_world(seed=4, h=16, w=32, n_kf=3):
    """The world of tests/test_global_opt.py:159: frame 0's pointmap
    backprojected from random depths (pixel-consistent), frames k the same
    points seen through the true relative pose; poses perturbed from the
    truth, frame 0 pinned. Returns (T_true, T_init, X) f64."""
    rng = np.random.default_rng(seed)
    X0 = _backproject(h, w, rng.uniform(4.0, 8.0, h * w), K)
    xis = rng.normal(size=(n_kf, 7)) * np.array([0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.03])
    xis[0] = 0.0
    T_true = tlie.sim3_exp(torch.from_numpy(xis))
    X = torch.stack([tlie.sim3_act(tlie.sim3_inv(tlie.sim3_rel(T_true[0], T_true[k])),
                                   torch.from_numpy(X0)) for k in range(n_kf)])
    noise = rng.normal(size=(n_kf, 7)) * np.array([0.03] * 3 + [0.01] * 3 + [0.01])
    noise[0] = 0.0
    T_init = tlie.sim3_retr(T_true, torch.from_numpy(noise))
    return T_true.numpy(), T_init.numpy(), X.numpy()


def one_way_edges(n_kf, hw):
    e = n_kf - 1
    return dict(ii=np.zeros(e, np.int32), jj=np.arange(1, n_kf, dtype=np.int32),
                idx=np.tile(np.arange(hw, dtype=np.int32), (e, 1)), valid=np.ones((e, hw), bool),
                Q=np.full((e, hw), 4.0, np.float32), active=np.ones(e, bool))


def calib_systems(cfg, img_hw, K, T, ii, jj, idx, XiT, w0, X, active):
    """The calibrated residual's (A, gj) at poses T through the solves' one
    edge-system seam (``_edge_systems``) and the step's AdjInv wrap
    (``_adj_wrap``)."""
    B, g = tgo._edge_systems(partial(tgo._calib_residual, cfg, img_hw), T, ii, jj, (idx, XiT, w0, active),
                             (X, K))(T)
    return tgo._adj_wrap(T, ii, B, g)


def test_calib_edge_systems_match_jax_f64():
    """Random matches, gates and weights (so masked, border and off-pixel
    points all occur), f64 on both sides."""
    h, w, n_kf = 16, 32, 4
    hw = h * w
    rng = np.random.default_rng(7)
    _, T, X = calib_world(7, h, w, n_kf)
    T = tlie.sim3_retr(torch.from_numpy(T), torch.from_numpy(
        rng.normal(size=(n_kf, 7)) * 0.05)).numpy()
    ii = np.array([0, 1, 1, 2, 3, 0], np.int32)
    jj = np.array([1, 0, 2, 3, 2, 3], np.int32)
    idx = rng.integers(0, hw, (6, hw)).astype(np.int32)
    XiT = np.swapaxes(X[ii], 1, 2) * rng.uniform(0.9, 1.1, (6, 1, hw))
    XiT[:, 2, :7] = -1.0  # behind the camera: masked by depth_eps
    w0 = rng.uniform(0, 2, (6, hw)) * (rng.uniform(size=(6, hw)) > 0.2)
    cfg = dict(sigma_pixel=1.0, sigma_depth=10.0, pixel_border=-2.0, depth_eps=1e-6)
    jfn = jax.vmap(lambda i, j, ix, Xi, w0_, Xj: jgo._calib_edge_system(
        jgo.BAConfig(**cfg), (h, w), jnp.asarray(K), jnp.asarray(T), i, j, ix, Xi, w0_, Xj))
    Aj, gj = jfn(jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(idx),
                 jnp.asarray(np.swapaxes(XiT, 1, 2)), jnp.asarray(w0), jnp.asarray(X[jj]))
    tens = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    # the port reads frame j's points through jj from the window's X
    At, gt = calib_systems(tgo.BAConfig(**cfg), (h, w), tens(K), tens(T), tens(ii), tens(jj), tens(idx),
                           tens(XiT), tens(w0), tens(X), torch.ones(6, dtype=torch.bool))
    assert At.dtype == torch.float64
    for got, want in ((At.numpy(), np.asarray(Aj)), (gt.numpy(), np.asarray(gj))):
        scale = np.abs(want.reshape(6, -1)).max(1)
        err = np.abs(got - want).reshape(6, -1).max(1)
        assert (scale > 0).all() and (err <= 1e-9 * scale).all(), err / scale


def test_calib_edge_chunks_equal_one_step(monkeypatch):
    """Chunking over edges (EDGE_CHUNK_POINTS) changes no result."""
    h, w, n_kf = 8, 16, 4
    _, T, X = calib_world(3, h, w, n_kf)
    d = one_way_edges(n_kf, h * w)
    args = (tgo.BAConfig(), (h, w), torch.from_numpy(K), torch.from_numpy(T),
            torch.from_numpy(d["ii"]), torch.from_numpy(d["jj"]), torch.from_numpy(d["idx"]),
            torch.from_numpy(np.ascontiguousarray(np.swapaxes(X[d["ii"]], 1, 2))),
            torch.ones(n_kf - 1, h * w, dtype=torch.float64), torch.from_numpy(X),
            torch.from_numpy(d["active"]))
    A1, g1 = calib_systems(*args)
    monkeypatch.setattr(normal_eqs, "EDGE_CHUNK_POINTS", h * w)  # one edge per step
    A2, g2 = calib_systems(*args)
    torch.testing.assert_close(A2, A1, rtol=1e-12, atol=0)
    torch.testing.assert_close(g2, g1, rtol=1e-12, atol=0)


def test_solve_gn_calib_matches_jax():
    h, w, n_kf = 16, 32, 3
    hw = h * w
    T_true, T_init, X = calib_world(4, h, w, n_kf)
    d = one_way_edges(n_kf, hw)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    C = np.full((n_kf, hw, 1), 5.0, np.float32)
    kw = dict(max_iters=30, pin=1, delta_norm=1e-12, sigma_pixel=1.0, sigma_depth=10.0)
    o = dict(ii=np.zeros(1, np.int32), jj=np.zeros(1, np.int32),
             delta_T=np.array([[0, 0, 0, 0, 0, 0, 1.0]], np.float32), active=np.zeros(1, bool))
    T_j = jgo.solve_gn_calib(jgo.BAConfig(**kw), 1, (h, w), jnp.asarray(f32(T_init)),
                             jnp.asarray(f32(X)), jnp.asarray(C), jnp.asarray(f32(K)), j_edges(d),
                             jgo.OdomEdges(**{k: jnp.asarray(v) for k, v in o.items()}),
                             jnp.full((n_kf,), -1.0, jnp.float32))
    stats = {}
    T_t = tgo.solve_gn_calib(tgo.BAConfig(**kw), 1, (h, w), torch.from_numpy(f32(T_init)),
                             torch.from_numpy(f32(X)), torch.from_numpy(C), torch.from_numpy(f32(K)),
                             t_edges(d), tgo.OdomEdges(**{k: torch.from_numpy(v) for k, v in o.items()}),
                             torch.full((n_kf,), -1.0), stats=stats)
    assert T_t.dtype == torch.float32 and 1 <= stats["iters"] <= 30
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    Tt = torch.from_numpy(T_true)
    for k in range(1, n_kf):
        np.testing.assert_allclose(tlie.sim3_rel(T_t[0].double(), T_t[k].double()).numpy(),
                                   tlie.sim3_rel(Tt[0], Tt[k]).numpy(), atol=5e-3)


def _window_graphs(tiny, K_t=None):
    """JAX and port graphs over one store of a four-keyframe calibrated
    world, with four pairs of identity matches and no insertion cache (the
    edge inputs are gathered from the window's points). The port's graph
    holds the calibration ``K_t`` when it is given. Returns (jg, tg, js, ts)."""
    h, w, n_kf = 16, 32, 4
    hw = h * w
    _, T_init, X = calib_world(9, h, w, n_kf)
    jg, tg = _graphs(tiny, h, w, max_edges=8, max_iters=10, delta_norm=1e-12, K=K_t)
    jg.edges = jgo.empty_edges(16, hw, with_cache=False)
    tg.edges = tgo.empty_edges(16, hw, with_cache=False)
    ident = np.arange(hw, dtype=np.int32)
    ones, q = np.ones(hw, bool), np.full(hw, 4.0, np.float32)
    for i, j in [(0, 1), (1, 2), (2, 3), (0, 3)]:
        p = (ident, ident, ones, ones, q, q)
        jg._insert_pair(i, j, *(jnp.asarray(a) for a in p))
        tg._insert_pair(i, j, *(torch.from_numpy(a) for a in p))
    js, ts = _stores(n_kf, hw, X.astype(np.float32), T_init.astype(np.float32))
    return jg, tg, js, ts


def test_solve_window_calib_matches_jax(tiny):
    """BackendGraph.solve_window of a graph built with K, on a store: the
    window's points are ray-constrained, the edge inputs gathered from them
    (no insertion cache), the poses returned unwritten; the same on both
    sides (JAX: ``solve_window_calib``). ``solve_GN`` writes the free poses
    back."""
    jg, tg, js, ts = _window_graphs(tiny, torch.from_numpy(K).float())
    uj, pj, Tj = jg.solve_window_calib(js, jnp.asarray(K, jnp.float32))
    ut, pt, Tn = tg.solve_window(ts)
    assert (ut, pt) == (uj, pj) == ([0, 1, 2, 3], 4)
    assert tg.last_solve["iters"] >= 1 and tg.last_solve["poses"] == 4
    np.testing.assert_allclose(Tn.numpy()[:pt], np.asarray(Tj)[:pj], atol=1e-5)
    before = ts.T_WC[:pt].clone()
    tg.solve_GN(ts)
    assert torch.equal(ts.T_WC[0], before[0]) and not torch.equal(ts.T_WC[1:pt], before[1:])


@pytest.mark.parametrize("calib", [False, True], ids=["rays", "calib"])
def test_solve_window_picks_its_residual_from_K(tiny, calib):
    """The window solve's one choice of residual, made where the graph is
    built: with K, ``solve_window`` opens ``backend.solve_calib`` and solves
    as JAX's ``solve_window_calib``; without, it opens ``backend.solve_rays``
    and solves as JAX's ``solve_window_rays``. The same store; poses atol
    1e-5; the solve span counts the solve's iterations."""
    from torch.profiler import ProfilerActivity, profile

    jg, tg, js, ts = _window_graphs(tiny, torch.from_numpy(K).float() if calib else None)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ut, pt, Tn = tg.solve_window(ts)
    recs = spans.records()
    spans.clear()
    solves = [r for r in recs if r["name"].startswith("backend.solve_")]
    assert [r["name"] for r in solves] == ["backend.solve_calib" if calib else "backend.solve_rays"]
    assert "backend.window" in [r["name"] for r in recs]
    assert solves[0]["counters"]["backend.solve_iters"] == tg.last_solve["iters"] >= 1
    uj, pj, Tj = jg.solve_window_calib(js, jnp.asarray(K, jnp.float32)) if calib else jg.solve_window_rays(js)
    assert (ut, pt) == (uj, pj) == ([0, 1, 2, 3], 4)
    np.testing.assert_allclose(Tn.numpy()[:pt], np.asarray(Tj)[:pj], atol=1e-5)


def test_opt_pose_calib_matches_jax():
    """Keyframe pixels backprojected from depth, the frame's points the same
    world through a perturbed relative pose plus noise, a tenth masked."""
    h, w = 16, 32
    hw = h * w
    rng = np.random.default_rng(11)
    Xk = _backproject(h, w, rng.uniform(3.0, 6.0, hw), K)
    T_true = tlie.sim3_exp(torch.from_numpy(rng.normal(size=7) * 0.03))
    Xf = tlie.sim3_act(tlie.sim3_inv(T_true), torch.from_numpy(Xk)).numpy()
    Xf = Xf + 0.002 * rng.normal(size=Xf.shape)
    Qk = rng.uniform(1.0, 4.0, (hw, 1))
    valid = rng.uniform(size=(hw, 1)) > 0.1
    z = Xk[:, 2:3]
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"), -1).reshape(-1, 2)
    meas = np.concatenate([uv, np.log(z)], -1)
    valid_meas = z > 1e-6
    T_WCk = tlie.sim3_exp(torch.from_numpy(rng.normal(size=7) * 0.1)).numpy()
    T_WCf = T_WCk.copy()
    args = [Xf, Xk, T_WCf, T_WCk, Qk, valid, meas, valid_meas, K]
    f32 = [a if a.dtype == bool else a.astype(np.float32) for a in args]
    jc = jtr.TrackingCfg(max_iters=20, use_calib=True)
    tc = ttr.TrackingCfg(max_iters=20, use_calib=True)
    outj = jtr.opt_pose_calib_sim3(jc, *(jnp.asarray(a) for a in f32), (h, w))
    outt = ttr.opt_pose_calib_sim3(tc, *(torch.from_numpy(a) for a in f32), (h, w))
    assert bool(outt[2]) == bool(outj[2]) is True
    for a, b in zip(outj[:2], outt[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    T_rel = tlie.sim3_rel(torch.from_numpy(T_WCk).double(), outt[0].double())
    np.testing.assert_allclose(T_rel.numpy(), T_true.numpy(), atol=5e-3)


CALIB_OVERRIDES = dict(
    use_calib=True,
    matching={"refine_impl": "gather"},
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 3},
    tpu={"max_keyframes": 8, "max_edges": 8, "max_odom_edges": 8},
)


@pytest.mark.parametrize("single_thread", [True, False], ids=["serialized", "threaded"])
def test_calibrated_slam_matches_jax(tiny, single_thread):
    """SLAM(calib=K_frame, use_calib) with the backend on: every identical
    frame tracks through opt_pose_calib_sim3 and becomes a keyframe whose
    task runs the calibrated window solve; keyframe images are kept."""
    params, jcfg, model = tiny
    H, W = 32, 64
    Kf = np.array([[60.0, 0, 32.0], [0, 60.0, 16.0], [0, 0, 1.0]])
    js = JSLAM(j_make_config(**CALIB_OVERRIDES), params, jcfg, (H, W), calib=Kf, use_backend=True,
               use_reloc=False, single_thread=single_thread, keep_keyframe_images=True)
    ts = TSLAM(t_make_config(**CALIB_OVERRIDES), model, (H, W), calib=Kf, use_backend=True,
               single_thread=single_thread, device="cpu", keep_keyframe_images=True)
    assert ts.tcfg.use_calib and js.tcfg.use_calib
    solves = []
    assert ts.backend.K is not None
    real = ts.backend.solve_window
    ts.backend.solve_window = lambda *a, **k: solves.append(1) or real(*a, **k)
    img = np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)
    for i in range(4):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i))
        assert (okt, kft) == (okj, kfj) == (True, True), f"frame {i}"
        if single_thread:
            np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4, err_msg=f"frame {i}")
    ts.terminate()
    js.terminate()
    assert len(solves) == 3
    np.testing.assert_allclose(ts.keyframe_poses()[1], js.keyframe_poses()[1], atol=1e-4)
    assert len(ts.kf_images) == len(js.kf_images) == 4
    for a, b in zip(ts.kf_images, js.kf_images):
        assert a.dtype == np.uint8 and a.shape == (H, W, 3)
        np.testing.assert_array_equal(a, np.asarray(b))
