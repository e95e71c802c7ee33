"""PyTorch port vs JAX package: the backend's ray-edge reduction, the
odometry factor and the whole ray-alignment GN (``solve_gn_rays``), on the
same numpy inputs.

Tolerances: the ray reduction per edge within 1e-4 x that edge's largest
entry in f32 (two summation orders), 1e-9 relative in f64; the odometry
system rtol 1e-9 in f64 (the port's closed-form Jacobian vs JAX's
forward-mode AD), and within 1e-7 of central differences; solved poses atol
1e-5 (f32 edge systems, f64 solve on both sides, as the JAX suite runs with
x64 on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.ops.ba_reduce_pallas import ray_edge_systems_pallas
from frodo_slam_tpu.slam import global_opt as jgo
from frodo_slam_tpu_torch.ops import ba_reduce_kernel as brk
from frodo_slam_tpu_torch.ops import lie as tlie
from frodo_slam_tpu_torch.slam import global_opt as tgo

torch.set_num_threads(1)

SCALE = np.array([0.05] * 3 + [0.02] * 3 + [0.01])


def make_world(seed, n_kf=4, hw=512):
    """Ground-truth Sim(3) poses and per-keyframe pointmaps of one world point
    cloud, every keyframe seeing the same cloud (identity matches): the
    numpy counterpart of tests/test_global_opt.py ``_make_world``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.0, 2.0, (hw, 3)) + np.array([0.0, 0.0, 6.0])
    xis = rng.normal(size=(n_kf, 7)) * np.array([0.3, 0.3, 0.3, 0.15, 0.15, 0.15, 0.05])
    T = tlie.sim3_exp(torch.from_numpy(xis))
    X = tlie.sim3_act(tlie.sim3_inv(T)[:, None, :], torch.from_numpy(pts)[None])
    return T.numpy(), X.numpy()


def perturb(T, seed, scale=SCALE, pin=1):
    noise = np.random.default_rng(seed).normal(size=(T.shape[0], 7)) * scale
    noise[:pin] = 0.0
    return tlie.sim3_retr(torch.from_numpy(T), torch.from_numpy(noise)).numpy()


def consecutive_edges(n_kf, hw):
    """Both directed rows of every consecutive pair, identity matches, Q 4."""
    ii, jj = [], []
    for i in range(n_kf - 1):
        ii += [i, i + 1]
        jj += [i + 1, i]
    e = len(ii)
    return dict(ii=np.asarray(ii, np.int32), jj=np.asarray(jj, np.int32),
                idx=np.tile(np.arange(hw, dtype=np.int32), (e, 1)),
                valid=np.ones((e, hw), bool), Q=np.full((e, hw), 4.0, np.float32),
                active=np.ones((e,), bool))


def j_edges(d):
    return jgo.Edges(**{k: jnp.asarray(v) for k, v in d.items()})


def t_edges(d):
    return tgo.Edges(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def odom_dict(ii, jj, delta):
    return dict(ii=np.asarray(ii, np.int32), jj=np.asarray(jj, np.int32),
                delta_T=np.asarray(delta, np.float32), active=np.ones(len(ii), bool))


def _scal(T, ii, jj):
    """Per-edge [sR | t] of the relative pose T_i^-1 T_j, numpy f64."""
    T = torch.from_numpy(np.asarray(T, np.float64))
    Tij = tlie.sim3_rel(T[ii], T[jj])
    sR = Tij[:, 7, None, None] * tlie.quat_to_R(Tij[:, 3:7])
    return torch.cat([sR.reshape(-1, 9), Tij[:, :3]], dim=-1).numpy()


def _gated_world():
    """The world of tests/test_ba_reduce_pallas.py:41-82: n_kf 4, hw 640 (not
    a multiple of the Pallas tile: its pad path), random Q, invalid points,
    random matches, one inactive edge."""
    n_kf, hw = 4, 640
    T_true, X = make_world(0, n_kf, hw)
    rng = np.random.default_rng(3)
    d = consecutive_edges(n_kf, hw)
    d.update(Q=rng.uniform(0.0, 4.0, d["Q"].shape).astype(np.float32),
             valid=rng.uniform(size=d["valid"].shape) > 0.2,
             idx=rng.integers(0, hw, d["idx"].shape).astype(np.int32))
    d["active"][-1] = False
    T = perturb(T_true, 5, pin=0).astype(np.float32)
    return T, X.astype(np.float32), np.full((n_kf, hw, 1), 5.0, np.float32), d


def test_edges_pre_matches_jax():
    T, X, C, d = _gated_world()
    cfg = jgo.BAConfig()
    XiT_j, w0_j = jgo._edges_pre(cfg, jnp.asarray(X), jnp.asarray(C), j_edges(d))
    XiT_t, w0_t = tgo._edges_pre(tgo.BAConfig(), torch.from_numpy(X), torch.from_numpy(C),
                                 t_edges(d))
    np.testing.assert_array_equal(XiT_t.numpy(), np.asarray(XiT_j))
    np.testing.assert_allclose(w0_t.numpy(), np.asarray(w0_j), rtol=1e-6)


def _stale_world():
    """``_gated_world`` with its inactive last row made stale (another jj,
    nonzero weights, as an evicted pair leaves it) and a fifth frame read
    by no row, so two rows share every jj. Returns (T, X, XiT, w0, d)."""
    T, X, C, d = _gated_world()
    XiT, w0 = tgo._edges_pre(tgo.BAConfig(), torch.from_numpy(X), torch.from_numpy(C), t_edges(d))
    XiT, w0 = XiT.contiguous().numpy().copy(), w0.numpy().copy()
    d["jj"][-1] = 0
    w0[-1] = np.random.default_rng(4).uniform(0.5, 2.0, w0.shape[1])
    X = np.concatenate([X, X[:1] + 1.0])
    T = np.concatenate([T, T[:1]])
    return T, X, XiT, w0, d


def test_ray_plain_matches_jax_pallas_interpret():
    """The plain version (what the kernel is held against on the card),
    reading Xj through jj, vs the Pallas kernel in interpret mode fed the
    gathered XjT, f32, on the same inputs: live rows per edge within 1e-4 x
    that edge's largest entry; the stale inactive row exactly 0."""
    T, X, XiT, w0, d = _stale_world()
    XjT = np.ascontiguousarray(np.swapaxes(X, 1, 2)[d["jj"]])
    scal = _scal(T, d["ii"], d["jj"]).astype(np.float32)
    kw = dict(sigma_ray=0.003, sigma_dist=10.0)
    Bj, gj = ray_edge_systems_pallas(*(jnp.asarray(a) for a in (scal, XiT, XjT, w0)),
                                     interpret=True, **kw)
    Bt, gt = brk.ray_edge_systems_plain(*(torch.from_numpy(a) for a in (scal, XiT, w0, X, d["jj"],
                                                                       d["active"])), **kw)
    live = d["active"]
    assert len(set(d["jj"][live])) < live.sum()  # rows share a frame
    for got, want in ((Bt.numpy(), np.asarray(Bj)), (gt.numpy(), np.asarray(gj))):
        E = want.shape[0]
        scale = np.abs(want.reshape(E, -1)).max(1)
        err = np.abs(got - want).reshape(E, -1).max(1)
        assert (err[live] <= 1e-4 * scale[live]).all(), err / scale
        assert not got[~live].any() and np.abs(want[~live]).max() > 0


def test_ray_fn_f64_matches_jax_edge_system():
    """The kernel edge function (plain version on the CPU, then AdjInv) in
    f64 vs the JAX per-edge D.G form, also f64 under the suite's x64:
    rtol 1e-9 (atol 1e-9 x the edge's largest entry for entries that cancel
    to ~0 in one form and are literal zeros in the other) on the live
    edges; the inactive edge 0."""
    T, X, C, d = _gated_world()
    T, X, C = T.astype(np.float64), X.astype(np.float64), C.astype(np.float64)
    d = dict(d, Q=d["Q"].astype(np.float64))
    XiT, w0 = jgo._edges_pre(jgo.BAConfig(), jnp.asarray(X), jnp.asarray(C), j_edges(d))
    XiT, w0 = np.asarray(XiT), np.asarray(w0)
    xs = tuple(torch.from_numpy(np.array(a)) for a in (d["ii"], d["jj"], XiT, w0, X, d["active"]))
    A_t, g_t = tgo._kernel_ray_fn(tgo.BAConfig())(torch.from_numpy(T), xs)
    assert A_t.dtype == torch.float64
    for e in range(len(d["ii"])):
        if not d["active"][e]:
            assert torch.count_nonzero(A_t[e]) == 0 and torch.count_nonzero(g_t[e]) == 0
            continue
        A_j, g_j = jgo._ray_edge_system(jgo.BAConfig(), jnp.asarray(T), d["ii"][e], d["jj"][e],
                                        jnp.asarray(XiT[e].T), jnp.asarray(w0[e]),
                                        jnp.asarray(X[d["jj"][e]]))
        for got, want in ((A_t[e].numpy(), np.asarray(A_j)), (g_t[e].numpy(), np.asarray(g_j))):
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_solve_gn_rays_reads_xj_through_jj(monkeypatch):
    """The ray solve makes no (E, 3, N) copy of X: the XjT gather of
    ``_edge_inputs`` is never reached, and every GN iteration hands the
    kernel the window's own pointmaps with jj, active and the live-row
    hint."""
    kw, T0, X, C, d, o, sb, _ = _case("rays")
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731

    def no_gather(*a, **k):
        raise AssertionError("the ray solve gathered XjT")

    calls = []
    real = tgo.ray_edge_systems

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(tgo, "_edge_inputs", no_gather)
    monkeypatch.setattr(tgo, "ray_edge_systems", spy)
    X_t = f32(X)
    stats = {}
    tgo.solve_gn_rays(tgo.BAConfig(**kw), 1, f32(T0), X_t, f32(C), t_edges(d),
                      tgo.OdomEdges(**{k: torch.from_numpy(v) for k, v in o.items()}), f32(sb),
                      stats=stats, n_active=4)
    assert len(calls) == stats["iters"] >= 1
    for a, k in calls:
        scal, XiT, w0, Xk, jj, active = a
        assert Xk is X_t and jj.dtype == torch.int32 and active.dtype == torch.bool
        assert XiT.shape == (jj.shape[0], 3, X.shape[1]) and k["n_active"] == 4


def _odom_poses(seed, angle=None):
    """Three f64 poses with non-unit scales and a measured T_12. ``angle``
    None: a general measurement; else the measurement is the predicted
    relative pose up to a rotation error of that angle (and 1e-3 in t), the
    near-identity residual of identical frames."""
    rng = np.random.default_rng(seed)
    T = perturb(make_world(seed, 3, 8)[0], seed + 10, scale=SCALE * 8, pin=0)
    T[:, 7] = rng.uniform(0.5, 2.0, 3)
    if angle is None:
        return T, np.concatenate([rng.normal(size=3) * 0.3,
                                  tlie.so3_exp(torch.from_numpy(rng.normal(size=3) * 0.2)).numpy()])
    Tt = torch.from_numpy(T)
    t_pred = tlie.quat_act(tlie.quat_inv(Tt[1, 3:7]), Tt[2, :3] - Tt[1, :3]) / Tt[2, 7]
    q_pred = tlie.quat_mul(tlie.quat_inv(Tt[1, 3:7]), Tt[2, 3:7])
    axis = rng.normal(size=3)
    q_err = tlie.so3_exp(torch.from_numpy(axis / np.linalg.norm(axis) * angle))
    dT = torch.cat([t_pred + 1e-3 * torch.from_numpy(rng.normal(size=3)), tlie.quat_mul(q_pred, q_err)])
    return T, dT.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_odom_edge_system_matches_jax(seed):
    """Exact odometry Jacobian (port: closed form; JAX: forward-mode AD) at
    general poses with non-unit scales, f64."""
    T, dT = _odom_poses(seed)
    Hj, gj = jgo._odom_edge_system(jgo.BAConfig(), jnp.asarray(T), 1, 2, jnp.asarray(dT))
    Ht, gt = tgo._odom_edge_system(tgo.BAConfig(), torch.from_numpy(T), 1, 2, torch.from_numpy(dT))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("angle", [0.0, 1e-4, 0.05, 0.5])
def test_odom_edge_system_near_identity_matches_jax(angle):
    """The same near a measurement that (almost) agrees with the poses: the
    rotation error on either side of the series/closed-form switches of the
    log's Jacobian. The Huber weights are then quadratic, so H is compared
    relative to its largest entry."""
    T, dT = _odom_poses(3, angle)
    Hj, gj = jgo._odom_edge_system(jgo.BAConfig(), jnp.asarray(T), 1, 2, jnp.asarray(dT))
    Ht, gt = tgo._odom_edge_system(tgo.BAConfig(), torch.from_numpy(T), 1, 2, torch.from_numpy(dT))
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-9, atol=1e-12 * np.abs(Hj).max())
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-9, atol=1e-12 * np.abs(Hj).max())


@pytest.mark.parametrize("drift", [1e-5, -3e-4, 1e-2])
def test_odom_edge_system_off_unit_quaternions_matches_jax(drift):
    """Stored quaternions drift off unit norm (composing a pose with another's
    conjugate multiplies their norms); the residual then reads ``quat_to_R``
    of the drifted quaternions, and the Jacobian must follow it exactly, as
    JAX's forward-mode AD does. Both poses' and the measurement's
    quaternions scaled by 1 + drift, f64, near and away from the
    measurement."""
    for angle in (None, 1e-4):
        T, dT = _odom_poses(5, angle)
        T[1:, 3:7] *= 1.0 + drift
        T[2, 3:7] *= 1.0 + drift
        dT = dT * np.asarray([1.0] * 3 + [1.0 + drift] * 4)
        Hj, gj = jgo._odom_edge_system(jgo.BAConfig(), jnp.asarray(T), 1, 2, jnp.asarray(dT))
        Ht, gt = tgo._odom_edge_system(tgo.BAConfig(), torch.from_numpy(T), 1, 2, torch.from_numpy(dT))
        Hj, gj = np.asarray(Hj), np.asarray(gj)
        np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-9, atol=1e-12 * np.abs(Hj).max())
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-9, atol=1e-12 * np.abs(Hj).max())


@pytest.mark.parametrize("angle", [None, 0.0, 0.3])
def test_odom_jacobian_matches_finite_differences(angle):
    """The closed-form Jacobian against central differences of the
    residual it returns, under the left retraction, batched over two rows."""
    T, dT = _odom_poses(4, angle)
    T[2, 3:7] *= 1.0 + 1e-3  # a drifted quaternion (see the test above)
    T = torch.from_numpy(T)
    dT = torch.from_numpy(np.stack([dT, dT]))
    ii, jj = torch.tensor([1, 0]), torch.tensor([2, 2])
    r, J = tgo._odom_jacobian(T[ii], T[jj], dT)
    h = 1e-6
    J_fd = torch.zeros_like(J)
    for k in range(14):
        e = torch.zeros(2, 14, dtype=torch.float64)
        e[:, k] = h

        def res(sign):
            Ti = tlie.sim3_retr(T[ii], sign * e[:, :7])
            Tj = tlie.sim3_retr(T[jj], sign * e[:, 7:])
            return tgo._odom_jacobian(Ti, Tj, dT)[0]

        J_fd[:, :, k] = (res(1.0) - res(-1.0)) / (2 * h)
    np.testing.assert_allclose(J.numpy(), J_fd.numpy(), atol=1e-7)


def _case(name):
    """The worlds of tests/test_global_opt.py:56 (rays), :85 (scale prior),
    :104 (odometry). Returns (kw for BAConfig, T_init, X, C, edges, odom,
    s_bar, check) with ``check(T_opt)`` JAX's own test assertion."""
    if name == "rays":
        n_kf, hw = 4, 512
        T_true, X = make_world(0, n_kf, hw)
        T0 = perturb(T_true, 1)
        odom = odom_dict([0], [0], [[0, 0, 0, 0, 0, 0, 1.0]])
        odom["active"][:] = False

        def check(T_opt):
            T_opt = torch.from_numpy(np.asarray(T_opt, np.float64))
            Tt = torch.from_numpy(T_true)
            for k in range(1, n_kf):
                np.testing.assert_allclose(tlie.sim3_rel(T_opt[0], T_opt[k]).numpy(),
                                           tlie.sim3_rel(Tt[0], Tt[k]).numpy(), atol=2e-3)

        return (dict(max_iters=20, pin=1, delta_norm=1e-10), T0, X, np.full((n_kf, hw, 1), 5.0),
                consecutive_edges(n_kf, hw), odom, np.full(n_kf, -1.0), check)
    if name == "scale_prior":
        n_kf, hw = 3, 8
        d = consecutive_edges(n_kf, hw)
        d["valid"][:] = False
        odom = odom_dict([0], [0], [[0, 0, 0, 0, 0, 0, 1.0]])
        odom["active"][:] = False

        def check(T_opt):
            assert abs(float(T_opt[0, 7]) - 1.0) < 1e-6
            np.testing.assert_allclose(float(T_opt[1, 7]), 2.0, rtol=1e-3)
            np.testing.assert_allclose(float(T_opt[2, 7]), 0.5, rtol=1e-3)

        return (dict(max_iters=15, pin=1, sigma_scale_prior=0.1, delta_norm=1e-12, C_conf=1.0),
                np.tile(tlie.sim3_identity().numpy(), (n_kf, 1)), np.ones((n_kf, hw, 3)),
                np.zeros((n_kf, hw, 1)), d, odom, np.array([2.0, 2.0, 0.5]), check)
    assert name == "odometry"
    n_kf, hw = 2, 8
    t_meas = np.array([1.0, 0.0, 0.0])
    q_meas = tlie.so3_exp(torch.tensor([0.0, 0.0, 0.1], dtype=torch.float64)).numpy()
    d = {k: v.numpy() for k, v in tgo.empty_edges(2, hw)._asdict().items()}

    def check(T_opt):
        T_opt = torch.from_numpy(np.asarray(T_opt, np.float64))
        rel = tlie.sim3_rel(T_opt[0], T_opt[1]).numpy()
        np.testing.assert_allclose(rel[:3], t_meas, atol=1e-3)
        np.testing.assert_allclose(rel[3:7], q_meas, atol=1e-3)

    return (dict(max_iters=30, pin=1, delta_norm=1e-12, C_conf=1.0, sigma_odom_t=1e-3,
                 sigma_odom_r=1e-3),
            np.tile(tlie.sim3_identity().numpy(), (n_kf, 1)), np.ones((n_kf, hw, 3)),
            np.zeros((n_kf, hw, 1)), d, odom_dict([0], [1], [np.concatenate([t_meas, q_meas])]),
            np.full(n_kf, -1.0), check)


@pytest.mark.parametrize("name", ["rays", "scale_prior", "odometry"])
def test_solve_gn_rays_matches_jax(name):
    """The whole solve on both sides (JAX: its x64 suite's xla edge path, f32
    edge systems, f64 solve; port: the kernel's plain version on the CPU,
    f64 solve): poses atol 1e-5, and the port recovers the truth to JAX's own
    test tolerances."""
    kw, T0, X, C, d, o, sb, check = _case(name)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    T_j = jgo.solve_gn_rays(jgo.BAConfig(**kw), 1, jnp.asarray(f32(T0)), jnp.asarray(f32(X)),
                            jnp.asarray(f32(C)), j_edges(d), jgo.OdomEdges(**{
                                k: jnp.asarray(v) for k, v in o.items()}), jnp.asarray(f32(sb)))
    stats = {}
    T_t = tgo.solve_gn_rays(tgo.BAConfig(**kw), 1, torch.from_numpy(f32(T0)),
                            torch.from_numpy(f32(X)), torch.from_numpy(f32(C)), t_edges(d),
                            tgo.OdomEdges(**{k: torch.from_numpy(v) for k, v in o.items()}),
                            torch.from_numpy(f32(sb)), stats=stats)
    assert T_t.dtype == torch.float32 and 1 <= stats["iters"] <= kw["max_iters"]
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    check(T_t.numpy())


def test_failed_factorization_leaves_poses_unchanged():
    """A negative-definite system fails the Cholesky: dx = 0, the poses stay
    as they were and finite, and the loop stops after that iteration."""
    n_kf, hw = 3, 8
    T = torch.from_numpy(perturb(make_world(0, n_kf, hw)[0], 2).astype(np.float32))
    e = tgo.Edges(**{k: torch.from_numpy(v) for k, v in consecutive_edges(n_kf, hw).items()})
    E = e.ii.shape[0]
    neg = lambda T_in: (-1e6 * torch.eye(7).expand(E, 7, 7), torch.ones(E, 7))  # noqa: E731
    stats = {}
    T_out = tgo._solve_gn(tgo.BAConfig(max_iters=5), 1, T, e, tgo.empty_odom_edges(2),
                          torch.full((n_kf,), -1.0), neg, stats=stats)
    assert torch.equal(T_out, T) and torch.isfinite(T_out).all()
    assert stats["iters"] == 1


def test_scatter_block_masks_pinned_and_accumulates():
    p_opt = 3
    H = torch.zeros(7 * p_opt, 7 * p_opt, dtype=torch.float64)
    g = torch.zeros(7 * p_opt, dtype=torch.float64)
    blocks = torch.arange(4 * 49, dtype=torch.float64).reshape(4, 7, 7)
    ii = torch.tensor([0, 0, -1, 2])
    jj = torch.tensor([1, 1, 0, 2])
    tgo._scatter_block(H, g, blocks, blocks[:, 0], ii, jj, p_opt)
    H4 = H.view(p_opt, 7, p_opt, 7)
    assert torch.equal(H4[0, :, 1], blocks[0] + blocks[1])  # colliding blocks add up
    assert torch.equal(H4[2, :, 2], blocks[3])
    assert torch.count_nonzero(H4[:, :, 0]) == 0  # the pinned row's block is masked
    assert torch.equal(g.view(p_opt, 7)[0], blocks[0, 0] + blocks[1, 0])
