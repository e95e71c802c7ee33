"""PyTorch port vs JAX package: the scale-only pose graph (``slam/pgo.py``),
its write-back into the keyframe scale channel, and the full Sim(3) pose
graph, on the same numpy inputs pinned to f32 (the JAX suite runs with x64
on). Bars: ``s`` within 1e-6 relative and ``ok`` equal; the scale channel
bitwise; the full graph's poses within 1e-4 and its cost within 1e-4
relative. The full graph pins no pose, so its damping alone holds the
gauge: the port solves it in f64 (as its BA), and JAX gets the same f32
values as f64 arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.ops import lie as jlie
from frodo_slam_tpu.slam import pgo as jpgo
from frodo_slam_tpu.slam.system import _apply_pgo_scale
from frodo_slam_tpu_torch.ops import lie as tlie
from frodo_slam_tpu_torch.slam import pgo as tpgo

torch.set_num_threads(1)


def _frames(seed, n, true_scale=2.5, yaw=True):
    """VO Sim(3) poses (translation divided by the true scale, a non-unit
    scale channel) and metric SE(3) odometry poses, f32."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(size=(n, 3)) * 0.1, axis=0)
    out = []
    for i in range(n):
        q = tlie.so3_exp(torch.from_numpy(rng.normal(size=3) * 0.2 if yaw else np.zeros(3))).numpy()
        T_vo = np.concatenate([pos[i] / true_scale, q, [rng.uniform(0.8, 1.2)]]).astype(np.float32)
        T_od = np.concatenate([pos[i], q]).astype(np.float32)
        out.append((T_vo, T_od))
    return out


@pytest.mark.parametrize("cap,n", [(64, 20), (16, 5), (16, 11), (8, 30)],
                         ids=["recover", "under_11", "eleven", "wrapped"])
def test_pgo_add_optimize_matches_jax(cap, n):
    """A seeded ring: recovery of the global scale (``tests/test_aux.py:13``),
    the under-11-frames no-op (``:33``), the first ok frame count, and a ring
    wrapped several times."""
    js, ts = jpgo.make_pose_graph(cap), tpgo.make_pose_graph(cap)
    for T_vo, T_od in _frames(cap + n, n):
        js = jpgo.pgo_add_frame(js, jnp.asarray(T_vo), jnp.asarray(T_od))
        tpgo.pgo_add_frame(ts, torch.from_numpy(T_vo), torch.from_numpy(T_od))
    np.testing.assert_array_equal(ts.Twc.numpy(), np.asarray(js.Twc))
    np.testing.assert_array_equal(ts.Todom.numpy(), np.asarray(js.Todom))
    assert ts.n_total == int(js.n_total) == n
    js, sj, okj = jpgo.pgo_optimize(js)
    ts, st, okt = tpgo.pgo_optimize(ts)
    assert bool(okt) == bool(okj) == (n > 10)
    assert st.dtype == torch.float32 and okt.dtype == torch.bool
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
    np.testing.assert_allclose(ts.scale.numpy(), np.asarray(js.scale), rtol=1e-6)
    if n <= 10:
        assert float(st) == 1.0
    elif cap == 64:
        np.testing.assert_allclose(float(st), 2.5, rtol=1e-4)


def test_pgo_zero_motion_is_not_ok():
    """No VO motion: the denominator is 0, ``ok`` False, ``s`` 1."""
    ts = tpgo.make_pose_graph(16)
    for _ in range(12):
        tpgo.pgo_add_frame(ts, torch.ones(8), torch.tensor([0, 0, 0, 0, 0, 0, 1.0]))
    _, s, ok = tpgo.pgo_optimize(ts)
    assert not bool(ok) and float(s) == 1.0


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("n_size", [0, 3, 8])
def test_apply_pgo_scale_bitwise(ok, n_size):
    rng = np.random.default_rng(n_size)
    T = rng.normal(size=(8, 8)).astype(np.float32)
    T[:, 7] = rng.uniform(0.5, 2.0, 8)
    s = np.float32(rng.uniform(0.3, 3.0))
    want = np.asarray(_apply_pgo_scale(jnp.asarray(T), jnp.asarray(n_size, jnp.int32), jnp.asarray(s),
                                       jnp.asarray(ok)))
    Tt = torch.from_numpy(T.copy())
    got = tpgo.apply_pgo_scale_(Tt, n_size, torch.tensor(s), torch.tensor(ok))
    assert got is Tt
    np.testing.assert_array_equal(got.numpy()[:, 7], want[:, 7])
    np.testing.assert_array_equal(got.numpy()[:, :7], T[:, :7])


def _chain(seed, N=5, lc=False):
    rng = np.random.default_rng(seed)
    T = [tlie.sim3_identity()]
    for _ in range(1, N):
        T.append(tlie.sim3_mul(T[-1], tlie.sim3_exp(torch.from_numpy(rng.normal(size=7) * 0.1).float())))
    T_gt = torch.stack(T)
    meas_inv = tlie.sim3_inv(tlie.sim3_mul(tlie.sim3_inv(T_gt[:-1]), T_gt[1:]))
    noise = torch.from_numpy(rng.normal(size=(N, 7)) * 0.05).float()
    noise[0] = 0
    T_noisy = tlie.sim3_retr(T_gt, noise)
    w = torch.ones((N - 1, 7))
    if lc:  # a loop closure 0 -> N-1 at its true relative pose, active
        edges = torch.tensor([[0, N - 1]], dtype=torch.int32)
        lc_T = tlie.sim3_inv(tlie.sim3_rel(T_gt[0], T_gt[N - 1]))[None]
        active = torch.ones((1,), dtype=torch.bool)
    else:
        edges = torch.zeros((1, 2), dtype=torch.int32)
        lc_T = tlie.sim3_identity()[None]
        active = torch.zeros((1,), dtype=torch.bool)
    return T_gt, T_noisy, meas_inv, w, edges, lc_T, active


@pytest.mark.parametrize("lc", [False, True], ids=["chain", "loop_closure"])
def test_pgo_optimize_full_matches_jax(lc):
    """``pgo_optimize_full`` (``tests/test_aux.py:421``): noisy poses, exact
    deltas; the cost falls below 5% of the start, poses and cost as JAX's."""
    T_gt, T_noisy, meas_inv, w, edges, lc_T, active = _chain(0, lc=lc)
    args = (T_noisy, meas_inv, meas_inv, w, w, edges, lc_T, active)
    T_t, c_t = tpgo.pgo_optimize_full(*args, iters=10)
    T_j, c_j = jpgo.pgo_optimize_full(*[jnp.asarray(a.numpy().astype(np.float64) if a.is_floating_point()
                                                    else a.numpy()) for a in args], iters=10)
    assert T_t.dtype == torch.float32 and torch.isfinite(T_t).all()
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-4, atol=1e-10)

    def cost(Tp):
        d = jax.vmap(jlie.sim3_mul)(jax.vmap(jlie.sim3_inv)(Tp[:-1]), Tp[1:])
        r = jax.vmap(jlie.sim3_log)(jax.vmap(jlie.sim3_mul)(d, jnp.asarray(meas_inv.numpy())))
        return float(jnp.sum(r * r))

    assert cost(jnp.asarray(T_t.numpy())) < 0.05 * cost(jnp.asarray(T_noisy.numpy()))
