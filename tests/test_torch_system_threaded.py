"""The port's threaded keyframe backend (``SLAM(single_thread=False)``), the
ports of tests/test_system.py:147, :172, :239 and :296: no deadlock,
``terminate()`` joins the worker, the frontend keeps tracking while a
(slowed) solve runs, and the queue never drops a task. On the CPU at
``tiny_config``, shared heads and identical frames, so every frame tracks.
"""

import threading
import time

import numpy as np
import pytest
import torch

from frodo_slam_tpu_torch.config import make_config
from frodo_slam_tpu_torch.models import mast3r
from frodo_slam_tpu_torch.slam.system import SLAM

torch.set_num_threads(1)

H, W = 32, 64


@pytest.fixture(scope="module")
def model():
    m = mast3r.init_model(mast3r.tiny_config(), seed=0, device="cpu")
    m.downstream_head2.load_state_dict(m.downstream_head1.state_dict())
    m.dec_blocks2.load_state_dict(m.dec_blocks.state_dict())
    return m


def _img(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _slam(model, **tpu):
    cfg = make_config(
        matching={"refine_impl": "gather"},
        tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0,
                  "max_iters": 10},
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 2},
        tpu={"max_keyframes": 8, "max_edges": 8, "max_odom_edges": 8, **tpu},
    )
    return SLAM(cfg, model, (H, W), use_backend=True, single_thread=False, device="cpu")


def _slow(slam, seconds, started=None, finished=None, solves=None):
    real = slam.backend.solve_window

    def slow_solve(store, s_bar=None):
        if started is not None:
            started.set()
        time.sleep(seconds)
        out = real(store, s_bar)
        if solves is not None:
            solves.append(time.time())
        if finished is not None:
            finished.set()
        return out

    slam.backend.solve_window = slow_solve


def test_threaded_backend_joins_and_matches_serialized(model):
    """Same success path as the serialized backend, no deadlock,
    terminate() joins; with no concurrent frames the final keyframe poses
    equal the serialized run's."""
    img = _img(0)
    slam = _slam(model)
    ser = SLAM(slam.cfg, model, (H, W), use_backend=True, single_thread=True, device="cpu")
    for i in range(4):
        ok, pose, _ = slam.grab_rgb(img, timestamp=float(i))
        assert ok and np.all(np.isfinite(pose))
        slam._join_backend()  # one task at a time: the serialized order
        ser.grab_rgb(img, timestamp=float(i))
    slam.terminate()
    assert slam._backend_tasks.unfinished_tasks == 0 and slam._backend_worker is None
    assert slam.backend._pairs == ser.backend._pairs == [(0, 1), (1, 2), (2, 3)]
    np.testing.assert_allclose(slam.keyframe_poses()[1], ser.keyframe_poses()[1], atol=1e-6)


def test_threaded_overlap_placement_matches_serialized(model):
    """``overlap`` with the tracker on slot 0 and the backend on dp = 2
    ranks (slots 1 and 2 of three CPU aliases), threaded: the replicas share
    no parameter storage with the tracker's model, every task's store copy
    goes to the solve device, and the run joins and equals the serialized
    unplaced run (poses atol 1e-5: split decode sums differ in rounding)."""
    from frodo_slam_tpu_torch.parallel import mesh

    pl = mesh.make_placement(2, 1, [torch.device("cpu")] * 3, first_slot=1)
    img = _img(0)
    slam = SLAM(_slam(model).cfg, model, (H, W), use_backend=True, single_thread=False, device="cpu",
                placement=pl)
    ser = SLAM(slam.cfg, model, (H, W), use_backend=True, single_thread=True, device="cpu")
    own = {p.untyped_storage().data_ptr() for p in model.parameters()}
    assert len(slam.backend.replicas) == 2
    for rep in slam.backend.replicas:
        assert not own & {p.untyped_storage().data_ptr() for p in rep.parameters()}
    for i in range(4):
        ok, pose, _ = slam.grab_rgb(img, timestamp=float(i))
        assert ok and np.all(np.isfinite(pose))
        slam._join_backend()
        ser.grab_rgb(img, timestamp=float(i))
    slam.backend.add_factors(slam.store, [0, 1, 2], [3, 3, 3])  # three pairs padded over two ranks
    ser.backend.add_factors(ser.store, [0, 1, 2], [3, 3, 3])
    slam.terminate()
    assert slam._backend_tasks.unfinished_tasks == 0 and slam._backend_worker is None
    assert slam.backend._pairs == ser.backend._pairs
    np.testing.assert_allclose(slam.keyframe_poses()[1], ser.keyframe_poses()[1], atol=1e-5)


def test_threaded_backend_overlaps_tracking(model):
    """Frames tracked while a slowed solve is in flight: the lock does not
    serialize them, and the solved poses still merge back."""
    slam = _slam(model)
    started, finished = threading.Event(), threading.Event()
    _slow(slam, 1.5, started, finished)
    img = _img(0)
    slam.grab_rgb(img, timestamp=0.0)
    slam.tcfg = slam.tcfg._replace(match_frac_thresh=0.0)
    ok, _, new_kf = slam.grab_rgb(img, timestamp=1.0)
    assert ok and not new_kf
    slam.tcfg = slam.tcfg._replace(match_frac_thresh=1.1)
    ok, _, new_kf = slam.grab_rgb(img, timestamp=2.0)
    assert ok and new_kf
    assert started.wait(timeout=30.0)
    slam.tcfg = slam.tcfg._replace(match_frac_thresh=0.0)
    tracked_during_solve = 0
    t0 = time.time()
    while not finished.is_set() and time.time() - t0 < 15.0:
        ok, pose, new_kf = slam.grab_rgb(img, timestamp=time.time())
        assert ok and not new_kf and np.all(np.isfinite(pose))
        if not finished.is_set():
            tracked_during_solve += 1
    assert tracked_during_solve >= 1, "frontend blocked for the whole backend solve"
    assert finished.is_set(), "backend solve never completed"
    slam.terminate()
    assert torch.isfinite(slam.store.T_WC[: slam.store.n_size]).all()


def test_threaded_backend_queues_without_blocking_frontend(model):
    """With solves far slower than the keyframe cadence, grab_rgb stays
    fast (tasks pile up) and every queued task solves by terminate()."""
    slam = _slam(model, max_keyframes=16, max_edges=32)
    solves = []
    _slow(slam, 2.0, solves=solves)
    img = _img(0)
    slam.grab_rgb(img, timestamp=0.0)
    ok, _, new_kf = slam.grab_rgb(img, timestamp=1.0)
    assert ok and new_kf
    lat = []
    n_tasks = 3
    for i in range(n_tasks):
        t0 = time.time()
        ok, pose, new_kf = slam.grab_rgb(img, timestamp=2.0 + i)
        lat.append(time.time() - t0)
        assert ok and new_kf and np.all(np.isfinite(pose))
    assert min(lat) < 1.5, f"frontend stalled a full solve on every keyframe: {lat}"
    assert slam._backend_tasks.qsize() + len(solves) >= 2
    slam.terminate()
    assert slam._backend_tasks.unfinished_tasks == 0
    assert len(solves) == n_tasks + 1, "queued tasks were lost"
    assert torch.isfinite(slam.store.T_WC[: slam.store.n_size]).all()


def test_threaded_backend_queue_never_drops_under_overload(model):
    """``backend_queue_max`` only warns: every task runs, in keyframe order."""
    slam = _slam(model, max_keyframes=32, max_edges=64, backend_queue_max=2)
    _slow(slam, 0.5)
    started = []

    def counting_step(idx, odom_factor, *rest, _real=slam._backend_step):
        started.append(idx)
        return _real(idx, odom_factor, *rest)

    slam._backend_step = counting_step
    img = _img(0)
    slam.grab_rgb(img, timestamp=0.0)
    for i in range(8):
        ok, _, new_kf = slam.grab_rgb(img, timestamp=1.0 + i)
        assert ok and new_kf
    slam.terminate()
    assert slam._backend_tasks.unfinished_tasks == 0
    assert started == list(range(1, len(slam.kf_timestamps)))


def test_failed_backend_task_is_logged_and_worker_survives(model, caplog):
    """A task that raises is logged at ERROR by the worker (what a caller
    checks), and the next task still runs."""
    slam = _slam(model)
    real = slam.backend.solve_window
    calls = []

    def flaky(store, s_bar=None):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(store, s_bar)

    slam.backend.solve_window = flaky
    img = _img(0)
    with caplog.at_level("ERROR"):
        for i in range(3):
            slam.grab_rgb(img, timestamp=float(i))
        slam.terminate()
    assert len(calls) == 2
    assert any("backend task kf=1 failed" in r.getMessage() for r in caplog.records)
