"""PyTorch port vs JAX package: the live map viewer (``viz/web.py``) and the
headless renders (``viz/visualization.py``).

Both packages' viewers read the same store contents, made from a seed: a
wrapped ring (capacity 4, five keyframes appended), poses with a rotation,
translation and scale, confidences and counts that the gate cuts, and
factor-graph pairs of which some left the ring. Bars: ``/state.json`` poses
atol 1e-6, its edges and counts exact; ``/points.bin`` atol 1e-5, with the
subsample draw run (``max_points`` under the gated count) and not run;
``export_state`` arrays exact; ``SLAMViewer._world_points`` atol 1e-5.

Behaviour: the page, 404 and the 403 of a foreign ``Origin``; a control
sequence gives the same pause and step state in both viewers;
``wait_if_paused`` releases exactly one frame per step; the snapshot waits
for the store's lock; a failing snapshot is counted and logged and the
server keeps serving; ``run_visualization`` re-renders only when the
keyframe count changes; the PNG renders. Every HTTP call and join has a
timeout, and every viewer is stopped in a ``finally`` block.

:func:`spy_viewers` is shared with the runner tests: it records the viewers
a runner builds, and makes each fetch its own state over HTTP at every
frame gate, so that a test sees the viewer serve during the run.
"""

import dataclasses
import json
import logging
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.slam import frame as jframe
from frodo_slam_tpu.viz import visualization as jviz
from frodo_slam_tpu.viz import web as jweb
from frodo_slam_tpu_torch.slam import frame as tframe
from frodo_slam_tpu_torch.viz import visualization as tviz
from frodo_slam_tpu_torch.viz import web as tweb

torch.set_num_threads(1)

CAP, HW = 4, 24
PAIRS = [(0, 1), (1, 2), (2, 4), (3, 4), (1, 4)]  # (0, 1) left the ring
FRAMES = 9
TIMEOUT = 20.0


def _contents(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(CAP, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([rng.normal(size=(CAP, 3)), q, rng.uniform(0.5, 2.0, (CAP, 1))], axis=1)
    return dict(T_WC=T.astype(np.float32),
                X_canon=rng.uniform(-1, 1, (CAP, HW, 3)).astype(np.float32),
                C=rng.uniform(0, 4, (CAP, HW, 1)).astype(np.float32),
                N=rng.integers(0, 4, CAP).astype(np.int32),
                frame_id=np.arange(10, 10 + CAP, dtype=np.int32))


def _gated_count(c, thr=1.5):
    return int((c["C"][..., 0] / np.maximum(c["N"][:, None], 1) > thr).sum())


def port_slam(c, n_total=5):
    store = tframe.make_keyframe_store(CAP, HW, 2, 8, device="cpu")
    for k, v in c.items():
        getattr(store, k).copy_(torch.from_numpy(v))
    store.n_size, store.n_total = min(n_total, CAP), n_total
    return types.SimpleNamespace(store=store, frame_count=FRAMES, _backend_lock=threading.Lock(),
                                 backend=types.SimpleNamespace(_pairs=list(PAIRS)))


def jax_slam(c, n_total=5):
    store = dataclasses.replace(jframe.make_keyframe_store(CAP, HW, 2, 8),
                                **{k: jnp.asarray(v) for k, v in c.items()},
                                n_size=jnp.asarray(min(n_total, CAP), jnp.int32),
                                n_total=jnp.asarray(n_total, jnp.int32))
    return types.SimpleNamespace(store=store, frame_count=FRAMES,
                                 backend=types.SimpleNamespace(_pairs=list(PAIRS)))


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT).read()


def _status(port, path, method="GET", body=None, origin=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    if origin is not None:
        req.add_header("Origin", origin)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _settled(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _served_state(port):
    """The first snapshot's ``/state.json`` and ``/points.bin``."""
    assert _settled(lambda: json.loads(_get(port, "/state.json"))["version"] > 0)
    return json.loads(_get(port, "/state.json")), np.frombuffer(_get(port, "/points.bin"), np.float32)


def spy_viewers(monkeypatch):
    """Record every port viewer a runner builds (bound to a free port); at
    each frame gate it waits for its first snapshot, then fetches its own
    ``/state.json`` and ``/points.bin`` of one snapshot version and keeps
    them in ``served``. The viewer publishes both under one lock with a new
    version, so points read between two reads of the same version belong to
    it; the snapshot thread may publish between the requests, and then the
    spy reads again."""
    created = []

    class SpyViewer(tweb.WebViewer):
        def __init__(self, slam, port=8090, **kw):
            super().__init__(slam, port=0, **kw)
            self.served = []
            created.append(self)

        def wait_if_paused(self, poll_s=0.05):
            assert _settled(lambda: self._version > 0)
            got = []

            def one_version():
                state = json.loads(_get(self.port, "/state.json"))
                n_bytes = len(_get(self.port, "/points.bin"))
                got[:] = [(state, n_bytes)]
                return json.loads(_get(self.port, "/state.json"))["version"] == state["version"]

            assert _settled(one_version)
            self.served.append(got[0])
            return super().wait_if_paused(poll_s)

    monkeypatch.setattr(tweb, "WebViewer", SpyViewer)
    return created


def check_served_and_stopped(created, n_gates):
    """One viewer, which served consistent state at each of ``n_gates`` frame
    gates, counted no error, and is stopped: no thread, no listening socket."""
    viewer, = created
    assert len(viewer.served) == n_gates and viewer.errors == 0
    for state, n_bytes in viewer.served:
        assert state["version"] >= 1 and state["frames"] >= 0 and not state["paused"]
        assert len(state["T_WC"]) == state["n_kf"] and n_bytes == 16 * state["n_points"]
    assert viewer._threads == [] and viewer.snapshot_log
    with pytest.raises(OSError):
        _get(viewer.port, "/state.json")


# ---------------------------------------------------------------------------
# parity with the JAX viewer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_points", [25, 400_000])
def test_served_state_and_points_match_jax(max_points):
    c = _contents()
    gated = _gated_count(c)
    assert 25 < gated < CAP * HW  # the gate cuts, and 25 makes the draw run
    views = [jweb.WebViewer(jax_slam(c), port=0, interval_s=0.05, max_points=max_points),
             tweb.WebViewer(port_slam(c), port=0, interval_s=0.05, max_points=max_points)]
    try:
        for v in views:
            v.start()
        (js, jp), (ts, tp) = _served_state(views[0]._server.server_address[1]), _served_state(views[1].port)
    finally:
        for v in views:
            v.stop()
    assert views[1].errors == 0
    for key in ("version", "n_kf", "frames", "n_points", "edges", "paused", "conf_threshold"):
        assert ts[key] == js[key], key
    assert ts["edges"] == [[0, 1], [1, 3], [2, 3], [0, 3]] and ts["n_kf"] == CAP
    assert ts["n_points"] == min(gated, max_points)
    np.testing.assert_allclose(np.asarray(ts["T_WC"]), np.asarray(js["T_WC"]), atol=1e-6, rtol=0)
    assert tp.shape == jp.shape == (4 * ts["n_points"],)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)


def test_export_state_and_world_points_match_jax(tmp_path):
    c = _contents(1)
    tslam, jslam = port_slam(c), jax_slam(c)
    got = np.load(tviz.export_state(tslam, str(tmp_path / "port.npz")))
    want = np.load(jviz.export_state(jslam, str(tmp_path / "jax.npz")))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["T_WC"].shape == (CAP, 8)
    for view in (dict(), dict(conf_threshold=0.5, max_points=30)):
        pt, ct = tviz.SLAMViewer(**view)._world_points(tslam)
        pj, cj = jviz.SLAMViewer(**view)._world_points(jslam)
        assert pt.shape == pj.shape and ct.shape == cj.shape
        np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
        np.testing.assert_allclose(ct, cj, atol=1e-5, rtol=0)


def test_control_sequence_matches_jax():
    msgs = [{"action": "pause"}, {"action": "step"}, {"action": "step"}, {"action": "toggle"},
            {"action": "toggle"}, {"action": "step"}, {"action": "resume"}, {"action": "step"},
            {"conf_threshold": 2.5}, {"action": "bogus"}, {"action": "pause", "conf_threshold": "0.5"},
            {"teleop": "w"}, {"action": "toggle"}]
    keys = {"j": [], "t": []}
    c = _contents()
    views = {"j": jweb.WebViewer(jax_slam(c), teleop_cb=keys["j"].append),
             "t": tweb.WebViewer(port_slam(c), teleop_cb=keys["t"].append)}
    for msg in msgs:
        for v in views.values():
            v.apply_control(msg)
        j, t = views["j"], views["t"]
        assert (t.paused, t._steps, t.conf_threshold, t._resume.is_set()) == \
            (j.paused, j._steps, j.conf_threshold, j._resume.is_set()), msg
    assert keys["t"] == keys["j"] == ["w"]


# ---------------------------------------------------------------------------
# behaviour of the port's viewer
# ---------------------------------------------------------------------------

def test_page_404_and_foreign_origin():
    v = tweb.WebViewer(port_slam(_contents()), port=0, interval_s=3600).start()
    try:
        port = v.port
        assert port == v._server.server_address[1] and port != 0
        html = _get(port, "/")
        assert b"frodo-slam-tpu live map" in html and b'<canvas id="c">' in html
        assert _status(port, "/nope") == 404
        assert _status(port, "/nope", "POST", b"{}") == 404
        pause = json.dumps({"action": "pause"}).encode()
        assert _status(port, "/control", "POST", pause, origin="http://evil.example") == 403
        assert not v.paused
        assert _status(port, "/control", "POST", pause, origin=f"http://127.0.0.1:{port}") == 200
        assert v.paused and json.loads(_get(port, "/state.json"))["paused"] is True
        assert _status(port, "/control", "POST", b"{not json") == 400
        assert _status(port, "/control", "POST", json.dumps({"action": "resume"}).encode()) == 200
        assert not v.paused
    finally:
        v.stop()


def test_wait_if_paused_releases_one_frame_per_step():
    v = tweb.WebViewer(port_slam(_contents()))
    frames = [0]
    stop = threading.Event()

    def loop():  # the runner's frame loop
        while not stop.is_set():
            v.wait_if_paused(poll_s=0.01)
            frames[0] += 1
            time.sleep(0.002)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        v.apply_control({"action": "pause"})
        assert _settled(lambda: v.holding)
        n0 = frames[0]
        time.sleep(0.2)
        assert frames[0] == n0 and v.holding
        released = 0
        for steps in (1, 2):  # one step, then two queued steps
            for _ in range(steps):
                v.apply_control({"action": "step"})
            released += steps
            assert _settled(lambda: frames[0] == n0 + released and v.holding)
            time.sleep(0.2)
            assert frames[0] == n0 + released, "a step released more than one frame"
        v.apply_control({"action": "resume"})
        assert _settled(lambda: frames[0] > n0 + 10) and not v.holding
    finally:
        stop.set()
        v.stop()  # releases a held frame
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()


def test_snapshot_waits_for_the_store_lock():
    """The snapshot copies the live slots under ``_backend_lock``: while a
    writer holds it, no snapshot is taken."""
    slam = port_slam(_contents())
    v = tweb.WebViewer(slam)
    with slam._backend_lock:
        t = threading.Thread(target=v._snapshot, daemon=True)
        t.start()
        time.sleep(0.2)
        assert t.is_alive() and v._version == 0
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and v._version == 1 and v._state["n_kf"] == CAP
    # a later in-place write leaves the served snapshot alone
    served = v._points.copy()
    slam.store.X_canon.add_(100.0)
    np.testing.assert_array_equal(v._points, served)
    read_ms, ms, n_bytes = v.snapshot_log[-1]
    assert 0 <= read_ms <= ms and n_bytes == (v._points.size + CAP * 8) * 4


def test_failed_snapshot_is_counted_and_logged(caplog):
    class Broken:
        device = torch.device("cpu")

        def __getitem__(self, idx):
            raise RuntimeError("torn store")

    slam = port_slam(_contents())
    slam.store = types.SimpleNamespace(n_total=2, n_size=2, capacity=CAP, T_WC=Broken())

    def teleop(key):
        raise ValueError("robot unreachable")

    caplog.set_level(logging.ERROR, logger="frodo_slam_tpu_torch.viz.web")
    v = tweb.WebViewer(slam, port=0, interval_s=0.05, teleop_cb=teleop).start()
    try:
        assert _settled(lambda: v.errors >= 2)  # the loop goes on after a failure
        assert json.loads(_get(v.port, "/state.json"))["version"] == 0
        n = v.errors
        v.apply_control({"teleop": "w"})
        assert v.errors > n
    finally:
        v.stop()
    failed = [r for r in caplog.records if r.getMessage() == "viewer snapshot failed"]
    assert failed and failed[0].exc_info and "torn store" in caplog.text
    assert any(r.getMessage() == "teleop callback failed" and r.exc_info for r in caplog.records)


def test_run_visualization_renders_only_on_new_keyframes(tmp_path):
    pytest.importorskip("matplotlib")
    slam = port_slam(_contents())
    t = tviz.run_visualization(slam, str(tmp_path), interval_s=0.05)
    try:
        assert _settled(lambda: len(list(tmp_path.glob("map_*.png"))) == 1)
        time.sleep(0.4)
        assert len(list(tmp_path.glob("map_*.png"))) == 1
        slam.store.n_total += 1  # a new keyframe wraps the ring once more
        assert _settled(lambda: len(list(tmp_path.glob("map_*.png"))) == 2)
        time.sleep(0.4)
        assert sorted(p.name for p in tmp_path.glob("map_*.png")) == ["map_00000.png", "map_00001.png"]
    finally:
        t.stop_event.set()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()


def test_renders_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    slam = port_slam(_contents())
    viewer = tviz.SLAMViewer(conf_threshold=0.0)
    paths = [viewer.render(slam, str(tmp_path / "map.png")),
             viewer.plot_trajectories({"a": np.random.default_rng(0).normal(size=(6, 3)),
                                       "b": np.zeros((4, 2))}, str(tmp_path / "traj.png"))]
    img = np.random.default_rng(1).uniform(0, 1, (32, 48, 3))
    uv = np.random.default_rng(2).uniform(0, 30, (250, 2))
    paths.append(tviz.visualize_matches(uv, uv + 1, img, (img * 255).astype(np.uint8), str(tmp_path / "m.png")))
    for p in paths:
        assert p.endswith(".png") and (tmp_path / p.rsplit("/", 1)[1]).stat().st_size > 1000
