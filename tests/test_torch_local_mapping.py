"""PyTorch port vs JAX package: the point-alignment solve
(``global_opt.solve_gn_points``) and the local mapper's factor graph
(``slam/local_mapping.py``), on the same numpy inputs.

Bars: solved poses atol 1e-5 against JAX (f32 edge systems, f64 solve on
both sides, as the JAX suite runs with x64 on), and the truth within JAX's
own test tolerance (``tests/test_global_opt.py:133``, 2e-3); the factor
graph's pairs and rows equal (``tests/test_global_opt.py:219``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.slam import global_opt as jgo
from frodo_slam_tpu.slam.local_mapping import LocalFactorGraph as JGraph
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.ops import lie as tlie
from frodo_slam_tpu_torch.slam import global_opt as tgo
from frodo_slam_tpu_torch.slam.local_mapping import LocalFactorGraph as TGraph
from frodo_slam_tpu_torch.slam.local_mapping import LocalMapOptimizer

from test_torch_global_opt import consecutive_edges, j_edges, make_world, perturb, t_edges

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,with_odom", [(2, False), (5, True)], ids=["points", "points_odometry"])
def test_solve_gn_points_matches_jax(seed, with_odom):
    n_kf, hw = 4, 512
    T_true, X = make_world(seed, n_kf, hw)
    T0 = perturb(T_true, seed + 1).astype(np.float32)
    X, C = X.astype(np.float32), np.full((n_kf, hw, 1), 5.0, np.float32)
    d = consecutive_edges(n_kf, hw)
    # the true odometry measurement in the factor's convention (t / s_j)
    Ti, Tj = torch.from_numpy(T_true[1]), torch.from_numpy(T_true[2])
    t_meas = tlie.quat_act(tlie.quat_inv(Ti[3:7]), Tj[:3] - Ti[:3]) / Tj[7]
    delta = torch.cat([t_meas, tlie.quat_mul(tlie.quat_inv(Ti[3:7]), Tj[3:7])])
    o = dict(ii=np.asarray([1], np.int32), jj=np.asarray([2], np.int32),
             delta_T=delta.numpy().astype(np.float32)[None], active=np.asarray([with_odom]))
    sb = np.full(n_kf, -1.0, np.float32)
    kw = dict(max_iters=20, pin=1, delta_norm=1e-10, sigma_point=0.05)
    T_j = jgo.solve_gn_points(jgo.BAConfig(**kw), 1, jnp.asarray(T0), jnp.asarray(X), jnp.asarray(C), j_edges(d),
                              jgo.OdomEdges(**{k: jnp.asarray(v) for k, v in o.items()}), jnp.asarray(sb))
    stats = {}
    T_t = tgo.solve_gn_points(tgo.BAConfig(**kw), 1, torch.from_numpy(T0), torch.from_numpy(X),
                              torch.from_numpy(C), t_edges(d),
                              tgo.OdomEdges(**{k: torch.from_numpy(v) for k, v in o.items()}),
                              torch.from_numpy(sb), stats=stats)
    assert T_t.dtype == torch.float32 and 1 <= stats["iters"] <= 20
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    Tt, To = torch.from_numpy(T_true), T_t.double()
    for k in range(1, n_kf):
        np.testing.assert_allclose(tlie.sim3_rel(To[0], To[k]).numpy(), tlie.sim3_rel(Tt[0], Tt[k]).numpy(),
                                   atol=2e-3, err_msg=f"kf {k}")


def test_point_edge_systems_match_jax():
    """One linearization: every directed edge's (A, gj) at perturbed poses,
    within 1e-4 of each edge's largest entry."""
    n_kf, hw = 4, 640
    T_true, X = make_world(0, n_kf, hw)
    T = perturb(T_true, 3, pin=0).astype(np.float32)
    X, C = X.astype(np.float32), np.full((n_kf, hw, 1), 5.0, np.float32)
    d = consecutive_edges(n_kf, hw)
    d["Q"] = np.random.default_rng(1).uniform(0.0, 4.0, d["Q"].shape).astype(np.float32)
    cfg_t, cfg_j = tgo.BAConfig(), jgo.BAConfig()
    XiT, w0, XjT = tgo._edge_inputs(cfg_t, torch.from_numpy(X), torch.from_numpy(C), t_edges(d))
    A, g = tgo._point_edge_systems(cfg_t, torch.from_numpy(T), torch.from_numpy(d["ii"]),
                                   torch.from_numpy(d["jj"]), XiT, w0, XjT)
    jXiT, jw0, jXjT = jgo._edge_inputs(cfg_j, jnp.asarray(X), jnp.asarray(C), j_edges(d))
    Aj, gj = jax.vmap(lambda ii, jj, xi, w, xj: jgo._point_edge_system(
        cfg_j, jnp.asarray(T), ii, jj, xi.T, w, xj.T))(jnp.asarray(d["ii"]), jnp.asarray(d["jj"]), jXiT, jw0, jXjT)
    for e in range(A.shape[0]):
        scale = float(np.abs(np.asarray(Aj[e])).max())
        np.testing.assert_allclose(A[e].numpy(), np.asarray(Aj[e]), atol=1e-4 * scale)
        np.testing.assert_allclose(g[e].numpy(), np.asarray(gj[e]), atol=1e-4 * scale)


def _payload(hw, lib):
    if lib == "jax":
        return (jnp.zeros(hw, jnp.int32), jnp.zeros(hw, jnp.int32), jnp.ones(hw, bool), jnp.ones(hw, bool),
                jnp.ones(hw), jnp.ones(hw))
    return (torch.zeros(hw, dtype=torch.int32), torch.zeros(hw, dtype=torch.int32),
            torch.ones(hw, dtype=torch.bool), torch.ones(hw, dtype=torch.bool), torch.ones(hw), torch.ones(hw))


def test_local_factor_graph_window_matches_jax():
    """Replace-on-duplicate and window eviction (local_mapping.py:28-32,
    95-104): pairs and edge rows as JAX's after each step."""
    hw = 8
    jparams = jmast3r.init_params(jax.random.PRNGKey(0), jmast3r.tiny_config())
    jg = JGraph(jparams, jmast3r.tiny_config(), jgo.BAConfig(max_iters=1, pin=1), (), (4, 2), max_edges=8,
                window_size=3)
    jg.hw = hw
    jg.edges = jgo.empty_edges(16, hw)
    model = tmast3r.init_model(tmast3r.tiny_config(), seed=0, device="cpu")
    tg = TGraph(model, tgo.BAConfig(max_iters=1, pin=1), (), (4, 2), max_edges=8, window_size=3)
    assert tg.edges.idx.shape == (16, hw)

    def check():
        assert tg._pairs == jg._pairs
        for f in ("ii", "jj", "active", "valid"):
            np.testing.assert_array_equal(getattr(tg.edges, f).numpy(), np.asarray(getattr(jg.edges, f)))

    for (i, j) in [(0, 1), (1, 2), (0, 1)]:  # the duplicate replaces
        jg._insert_pair(i, j, *_payload(hw, "jax"))
        tg._insert_pair(i, j, *_payload(hw, "torch"))
        check()
    assert tg._pairs == [(1, 2), (0, 1)]
    jg._insert_pair(2, 3, *_payload(hw, "jax"))
    tg._insert_pair(2, 3, *_payload(hw, "torch"))
    jg.remove_factors_i(0)
    tg.remove_factors_i(0)
    check()
    assert tg._pairs == [(1, 2), (2, 3)] and bool(tg.edges.active[:4].all())
    tg.enforce_window(newest=5)  # window [3..5]: evicts everything touching < 3
    jg.enforce_window(newest=5)
    check()
    assert tg._pairs == [] and not bool(tg.edges.active.any())


def test_local_map_optimizer_disabled_by_default():
    model = tmast3r.init_model(tmast3r.tiny_config(), seed=0, device="cpu")
    opt = LocalMapOptimizer(TGraph(model, tgo.BAConfig(), (), (4, 2), max_edges=4))
    assert not opt.enabled and opt.offset_to_current == (-1, -2, -5)
    store = object()
    assert opt.on_new_keyframe(store, 3) is store
