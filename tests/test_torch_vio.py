"""PyTorch port vs JAX package: the robot VIO mode of ``SLAM``
(``local_opt_mode``: odometry factors, the scale-only PGO and its gauge
write-back, ``local_opt.sigma_ray_odom_mode``) and the height prior, through
``grab_rgb``; checkpoints, ``reset``, the metric poses.

Parity runs:
- tiny_config with converted weights (shared heads: identical frames
  track), every frame a keyframe, an odometry pose per frame, 12 frames so
  that the PGO goes live (it needs more than 10), serialized: per-frame
  ``(ok, new_kf)`` equal, poses and keyframe poses (scale channel included)
  within 1e-4; the PGO scale within 1e-6 of JAX's ``pgo_optimize`` on the
  port's ring, and within 2e-5 of the JAX run's (the VO poses it reads carry
  the f32 difference of the window solves' ray sums, ~2e-6 a solve).
- the height prior live: after four frames, every live keyframe's stored
  pointmap is replaced by the same ground plane in both packages and one more
  backend task runs (the edges made identity matches on it): every
  non-degenerate RANSAC hypothesis is the plane, so
  the packages' different random draws fit the same height. Bars: the scale
  targets within 1e-5 (all live), poses and scale channels within 1e-4.
"""

import types

import jax
import numpy as np
import pytest
import torch

H, W = 32, 64

# the success fixture of tests/test_system.py:41-54, odometry mode; the
# tracking GN runs to its fixed point (with the default stopping rule, a step
# under 1e-3, one package may stop an iteration before the other)
OVERRIDES = dict(
    matching={"refine_impl": "gather"},
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 30,
              "rel_error": 1e-9, "delta_norm": 1e-9},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 2},
    tpu={"max_keyframes": 16, "max_edges": 16, "max_odom_edges": 16},
)


def _odom(i):
    """Wheel odometry moving 1 cm a frame while the frames stay identical:
    the rays and the odometry disagree, so the window solve settles on a
    compromise whose f32 edge sums differ between the packages by ~2e-6 a
    solve; a small step keeps that under the bars after 12 solves."""
    return np.array([0.01 * i, 0.002 * i, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32)


def _img(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    from frodo_slam_tpu.models import mast3r as jmast3r

    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]
    params["dec_blocks2"] = params["dec_blocks"]
    return params, jcfg


def _port_model(params):
    from frodo_slam_tpu_torch.models import convert as tconvert
    from frodo_slam_tpu_torch.models import mast3r as tmast3r

    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    return model


def _port_slam(model, single_thread=True, local_opt_mode=True, db=None, **over):
    from frodo_slam_tpu_torch.config import make_config
    from frodo_slam_tpu_torch.slam.system import SLAM

    ov = {k: dict(v) for k, v in OVERRIDES.items()}
    for k, v in over.items():
        ov.setdefault(k, {}).update(v)
    return SLAM(make_config(**ov), model, (H, W), retrieval_db=db, use_backend=True, use_reloc=False,
                single_thread=single_thread, local_opt_mode=local_opt_mode, device="cpu")


def test_vio_slam_matches_jax(weights):
    from frodo_slam_tpu.config import make_config as j_make_config
    from frodo_slam_tpu.slam.system import SLAM as JSLAM

    params, jcfg = weights
    torch.set_num_threads(1)
    js = JSLAM(j_make_config(**OVERRIDES), params, jcfg, (H, W), retrieval_db=None, use_backend=True,
               use_reloc=False, single_thread=True, local_opt_mode=True)
    ts = _port_slam(_port_model(params))
    assert ts.ba_cfg.sigma_ray == js.ba_cfg.sigma_ray == 0.1
    img = _img()
    for i in range(12):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))
        assert (okt, kft) == (okj, kfj) == (True, True), f"frame {i}"
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4, err_msg=f"frame {i}")
    assert ts.pgo.n_total == int(js.pgo.n_total) == 11
    assert ts.backend._odom_pairs == js.backend._odom_pairs and ts.backend._pairs == js.backend._pairs
    s_t, s_j = float(ts.pgo.scale[0, 0]), float(js.pgo.scale[0, 0])
    assert s_t != 1.0, "the PGO never went live"
    np.testing.assert_allclose(s_t, s_j, rtol=2e-5)
    from frodo_slam_tpu.slam import pgo as jpgo

    ring = jpgo.PoseGraphState(Twc=jax.numpy.asarray(ts.pgo.Twc.numpy()),
                               Todom=jax.numpy.asarray(ts.pgo.Todom.numpy()),
                               scale=jax.numpy.ones((ts.pgo.capacity, 1), jax.numpy.float32),
                               n_total=jax.numpy.asarray(ts.pgo.n_total, jax.numpy.int32))
    _, s_ring, ok_ring = jpgo.pgo_optimize(ring)
    assert bool(ok_ring)
    np.testing.assert_allclose(s_t, float(s_ring), rtol=1e-6)
    (st, pt), (sj, pj) = ts.keyframe_poses(), js.keyframe_poses()
    assert st == sj and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, atol=1e-4)  # the scale channel (column 7) included
    assert np.abs(pt[1:, 7] - 1.0).max() > 1e-3  # the gauge was written
    mt, mj = ts.metric_keyframe_poses()[1], js.metric_keyframe_poses()[1]
    np.testing.assert_allclose(mt, mj, atol=1e-3)
    np.testing.assert_allclose(mt[:, :3], pt[:, :3] / pt[:, 7:8], rtol=1e-6)
    ts.terminate()
    js.terminate()


def test_sigma_ray_odom_mode_weights_the_window_solve(weights, monkeypatch):
    """``local_opt.sigma_ray_odom_mode`` (0.1) weights the rays of every window
    solve in the VIO mode; ``local_opt.sigma_ray`` (0.003) otherwise."""
    from frodo_slam_tpu_torch.slam import global_opt as tgo

    seen = []
    real = tgo.ray_edge_systems

    def spy(*a, sigma_ray, **k):
        seen.append(sigma_ray)
        return real(*a, sigma_ray=sigma_ray, **k)

    monkeypatch.setattr(tgo, "ray_edge_systems", spy)
    model = _port_model(weights[0])
    for mode, want in ((False, 0.003), (True, 0.1)):
        seen.clear()
        slam = _port_slam(model, local_opt_mode=mode)
        for i in range(3):
            slam.grab_rgb(_img(), timestamp=float(i), odom_pose=_odom(i))
        assert seen and set(seen) == {want}, (mode, seen)


def test_height_prior_fits_are_cached(weights, monkeypatch):
    """The port of ``tests/test_system.py:474``: each keyframe's plane fit
    runs at most twice (its first task, and after its final fused pointmap
    is written back at the next keyframe), only the region's rows are
    fetched, and a task over an unchanged window refits nothing."""
    slam = _port_slam(_port_model(weights[0]), local_opt_mode=False,
                      height_prior={"enabled": True, "camera_height": 0.5, "rect": [[4, 20], [60, 31]],
                                    "ransac_iters": 50})
    assert slam.height_prior_enabled
    calls = []
    real_run_points = slam.plane_estimator.run_points

    def counting(pts, idx=None):
        calls.append(np.asarray(pts).shape)
        return real_run_points(pts, idx)

    monkeypatch.setattr(slam.plane_estimator, "run_points", counting)
    for i in range(6):
        ok, _, new_kf = slam.grab_rgb(_img(), timestamp=float(i))
        assert ok and new_kf
    n_kf = slam.store.n_size
    assert n_kf == 6
    assert n_kf - 1 <= len(calls) <= 2 * n_kf, calls
    assert all(s[0] <= slam.plane_estimator.max_subsample and s[0] < H * W for s in calls)
    n_before = len(calls)
    slam.backend.add_odometry_factors(n_kf - 2, n_kf - 1, np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32))
    slam._backend_step(n_kf - 1, None)
    assert len(calls) == n_before, "a task over a clean window refit cached keyframes"


def test_height_prior_cache_skips_fits_invalidated_after_the_copy(weights):
    """A threaded task fits the keyframes of its copy of the store; a
    keyframe whose stored pointmap the frontend rewrote after the copy
    (invalidating its fit) is fitted for this task but not cached."""
    slam = _port_slam(_port_model(weights[0]), local_opt_mode=False,
                      height_prior={"enabled": True, "ransac_iters": 20})
    for i in range(3):
        slam.grab_rgb(_img(), timestamp=float(i))
    gen_at_copy = slam._hp_gen
    with slam._backend_lock:
        slam._hp_invalidate(2)  # the frontend writes keyframe 2 back after the copy
    slam._hp_cache.clear()
    s_bar = slam._height_prior_s_bar(slam.store, gen_at_copy)
    assert len(s_bar) == 3 and set(slam._hp_cache) == {0, 1}
    slam._height_prior_s_bar(slam.store, slam._hp_gen)  # a later task caches it
    assert set(slam._hp_cache) == {0, 1, 2}


def test_reset_clears_pgo_and_height_prior_cache(weights):
    from frodo_slam_tpu_torch.slam.frame import Mode
    from frodo_slam_tpu_torch.slam.system import SLAM, VIO

    assert VIO is SLAM
    slam = _port_slam(_port_model(weights[0]), height_prior={"enabled": True, "ransac_iters": 20})
    for i in range(4):
        slam.grab_rgb(_img(), timestamp=float(i), odom_pose=_odom(i))
    assert slam.pgo.n_total == 3 and slam._hp_cache
    cap = slam.pgo.capacity
    slam.reset()
    assert slam.pgo.n_total == 0 and slam.pgo.capacity == cap and slam._hp_cache == {}
    assert torch.equal(slam.pgo.scale, torch.ones_like(slam.pgo.scale))
    assert slam.mode == Mode.INIT and len(slam.atlas) == 1
    # without the gauge written, metric poses equal the poses
    fresh = _port_slam(_port_model(weights[0]), local_opt_mode=False)
    for i in range(3):
        fresh.grab_rgb(_img(), timestamp=float(i))
    np.testing.assert_array_equal(fresh.metric_keyframe_poses()[1], fresh.keyframe_poses()[1])


def test_checkpoint_roundtrip(weights, tmp_path):
    """The port of ``tests/test_aux.py:374``, the PGO included: a restored
    SLAM has the same store, edge and odometry rows, PGO ring, retrieval
    database and host bookkeeping, and keeps tracking."""
    from frodo_slam_tpu_torch.retrieval.asmk import Codebook
    from frodo_slam_tpu_torch.retrieval.database import RetrievalDatabase
    from frodo_slam_tpu_torch.retrieval.model import RetrievalHead
    from frodo_slam_tpu_torch.utils.checkpoint import load_slam_state, save_slam_state

    model = _port_model(weights[0])
    dim = model.cfg.enc_embed_dim

    def build():
        head = RetrievalHead.init(torch.Generator().manual_seed(1), backbone_dim=dim, hdims=[dim], nfeat=8,
                                  device="cpu")
        db = RetrievalDatabase(head, Codebook.random(np.random.default_rng(0), 64, dim, device="cpu"))
        return _port_slam(model, db=db)

    slam = build()
    for i in range(4):
        slam.grab_rgb(_img(), timestamp=float(i), odom_pose=_odom(i))
    ckpt = save_slam_state(slam, str(tmp_path / "state.npz"))
    slam2 = build()
    load_slam_state(slam2, ckpt)
    for f in ("frame_id", "T_WC", "X_canon", "C", "feat", "pos", "N", "N_updates"):
        assert torch.equal(getattr(slam2.store, f), getattr(slam.store, f)), f
    assert (slam2.store.n_size, slam2.store.n_total) == (slam.store.n_size, slam.store.n_total) == (4, 4)
    for a, b in zip(slam2.backend.edges + slam2.backend.odom, slam.backend.edges + slam.backend.odom):
        assert torch.equal(a, b)
    assert slam2.backend._pairs == slam.backend._pairs and slam2.backend._odom_pairs == slam.backend._odom_pairs
    assert slam2.backend._n_odom == slam.backend._n_odom == 3
    for f in ("Twc", "Todom", "scale"):
        assert torch.equal(getattr(slam2.pgo, f), getattr(slam.pgo, f)), f
    assert slam2.pgo.n_total == slam.pgo.n_total == 3
    assert slam2.retrieval.kf_ids == slam.retrieval.kf_ids and slam2.retrieval.kf_counter == 4
    assert slam2.kf_timestamps == slam.kf_timestamps and slam2.mode == slam.mode
    np.testing.assert_array_equal(slam2.current_T_WC, slam.current_T_WC)
    ok, pose, _ = slam2.grab_rgb(_img(), timestamp=4.0, odom_pose=_odom(4))
    assert ok and np.all(np.isfinite(pose))


def test_threaded_vio_finishes_with_finite_poses(weights):
    slam = _port_slam(_port_model(weights[0]), single_thread=False,
                      height_prior={"enabled": True, "ransac_iters": 20})
    for i in range(6):
        ok, T, _ = slam.grab_rgb(_img(), timestamp=float(i), odom_pose=_odom(i))
        assert ok and np.isfinite(T).all()
    slam.terminate()
    assert slam._backend_worker is None and slam._backend_tasks.unfinished_tasks == 0
    stamps, poses = slam.keyframe_poses()
    assert len(stamps) == 6 and np.isfinite(poses).all() and np.isfinite(slam.metric_keyframe_poses()[1]).all()
    assert len(slam.backend._odom_pairs) == 5 and slam.pgo.n_total == 5


def test_visualize_raises_naming_its_item(weights, tmp_path, monkeypatch):
    """``run_vio.run_dataset(visualize=True)`` serves the live viewer during
    the replay and stops it after (the test keeps the name it had while the
    port raised): a threaded VIO run, every frame a keyframe, so that the
    backend worker writes the store while the viewer reads it."""
    import pathlib
    import pickle

    from frodo_slam_tpu_torch import loader as tloader
    from frodo_slam_tpu_torch import run_vio
    from frodo_slam_tpu_torch.data import image as timage
    from frodo_slam_tpu_torch.slam import system as tsystem
    from test_torch_viz import check_served_and_stopped, spy_viewers

    model = _port_model(weights[0])
    monkeypatch.setattr(tloader, "load_mast3r", lambda *a, **k: (model, model.cfg))
    real = timage.resize_img
    for mod in (timage, tsystem):
        monkeypatch.setattr(mod, "resize_img", lambda img, size=512, **kw: real(img, W, **kw))
    frame = (_img()[:, :, ::-1] * 255).astype(np.uint8)  # BGR, as recorded
    session = tmp_path / "session_mini.pkl"
    with open(session, "wb") as f:
        pickle.dump([{"timestamp": 0.1 * i, "frame": frame, "pose": _odom(i)} for i in range(4)], f)
    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = tmp_path / "vio_viz.yaml"
    cfg.write_text(f'inherit: "{root / "configs" / "base.yaml"}"\nsingle_thread: false\n'
                   + "".join(f"{k}: {v}\n" for k, v in OVERRIDES.items()))
    viewers = spy_viewers(monkeypatch)
    args = types.SimpleNamespace(dataset=str(session), config=str(cfg), calib=None, weights=None,
                                 no_retrieval=True, use_odometry=True, wall_clock=False, every_n_frames=1,
                                 visualize=True, use_multiple_gpu=False)
    slam = run_vio.run_dataset(args, device="cpu")
    check_served_and_stopped(viewers, n_gates=4)
    assert viewers[0].slam is slam and not slam.single_thread and slam.store.n_total == 4
    assert slam._backend_worker is None and len(slam.backend._odom_pairs) == 3


# ---------------------------------------------------------------------------
# live scale targets: a ground plane written into both stores
# ---------------------------------------------------------------------------

CAMERA_HEIGHT = 2.0  # metric; the plane below lies at 1 world unit: the gauge 0.5


def _ground_pointmap():
    """A ground plane y = 1 ahead of the camera, row-major over (H, W), far
    rows at the top."""
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    z = 2.0 + (H - 1 - vv) / 4.0
    return np.stack([(uu - W / 2) / 8.0, np.ones_like(uu), z], -1).reshape(H * W, 3)


def test_height_prior_live_targets_match_jax(weights):
    """Both packages track and solve four frames in the VIO mode, then every
    live keyframe's stored pointmap is replaced by the same ground plane,
    each edge by identity matches on it, and one more backend task runs with
    the height prior on: every
    non-degenerate RANSAC hypothesis is the plane, so the packages'
    different random draws fit the same height and the scale targets are
    live (h / camera_height = 0.5) in both. Bars: targets within 1e-5, poses
    and scale channels within 1e-4, and the scale prior moved the scales."""
    import dataclasses

    from frodo_slam_tpu.config import make_config as j_make_config
    from frodo_slam_tpu.slam.system import SLAM as JSLAM

    params, jcfg = weights
    torch.set_num_threads(1)
    hp = {"enabled": True, "camera_height": CAMERA_HEIGHT, "ransac_iters": 100, "dist_thresh": 0.02}
    ov = {k: dict(v) for k, v in OVERRIDES.items()}
    ov["height_prior"] = hp
    js = JSLAM(j_make_config(**ov), params, jcfg, (H, W), retrieval_db=None, use_backend=True,
               use_reloc=False, single_thread=True, local_opt_mode=True)
    ts = _port_slam(_port_model(params), height_prior=hp)
    # the random-weight pointmaps are no plane: the prior waits for the plane
    js.height_prior_enabled = ts.height_prior_enabled = False
    img = _img()
    for i in range(4):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i), odom_pose=_odom(i))
        assert (okt, kft) == (okj, kfj) == (True, True)
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    n = ts.store.n_size
    before = ts.keyframe_poses()[1]
    plane = _ground_pointmap()
    js.store = dataclasses.replace(js.store, X_canon=js.store.X_canon.at[:n].set(jax.numpy.asarray(plane)))
    ts.store.X_canon[:n] = torch.from_numpy(plane)
    # and the edges follow: identity matches on the plane, every point
    # weighted sqrt(Q = 4) (the cached XiT = X_i[idx] and w0, see Edges)
    rows = 2 * len(ts.backend._pairs)
    syn = dict(idx=np.tile(np.arange(H * W, dtype=np.int32), (rows, 1)), valid=np.ones((rows, H * W), bool),
               Q=np.full((rows, H * W), 4.0, np.float32), w0=np.full((rows, H * W), 2.0, np.float32),
               XiT=np.tile(plane.T[None], (rows, 1, 1)))
    for k, v in syn.items():
        getattr(ts.backend.edges, k)[:rows] = torch.from_numpy(v)
    js.backend.edges = js.backend.edges._replace(**{k: getattr(js.backend.edges, k).at[:rows].set(v)
                                                    for k, v in syn.items()})
    targets = {}
    for name, slam in (("jax", js), ("port", ts)):
        slam.height_prior_enabled = True
        real = slam._height_prior_s_bar
        slam._height_prior_s_bar = lambda store, *a, _r=real, _n=name: targets.setdefault(_n, _r(store, *a))
        slam._backend_step(n - 1, None)
    np.testing.assert_allclose(targets["port"], targets["jax"], atol=1e-5)
    assert (targets["port"] > 0).sum() == n, targets  # every keyframe's target is live
    np.testing.assert_allclose(targets["port"], 1.0 / CAMERA_HEIGHT, atol=1e-4)
    assert len(ts._hp_cache) == len(js._hp_cache) == n
    (st, pt), (sj, pj) = ts.keyframe_poses(), js.keyframe_poses()
    assert st == sj and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    assert np.abs(pt[1:, 7] - before[1:, 7]).max() > 1e-3  # the scale prior pulled the scales
    ts.terminate()
    js.terminate()
