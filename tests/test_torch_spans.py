"""The port's own spans and counters (``frodo_slam_tpu_torch.utils.spans``):
nothing recorded, allocated or clocked while no profiler records; under a
profiler, every span and counter of a frame and of a backend task, with its
frame id, parent and thread, on the profiler's clock. Tiny width on the CPU,
shared heads and identical frames, so every frame tracks and (threshold 1.1)
becomes a keyframe with a backend task."""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from frodo_slam_tpu_torch.config import make_config
from frodo_slam_tpu_torch.models import mast3r
from frodo_slam_tpu_torch.slam import tracker
from frodo_slam_tpu_torch.slam.system import SLAM
from frodo_slam_tpu_torch.utils import spans

torch.set_num_threads(1)

H, W = 32, 64
N_FRAMES = 4
OVERRIDES = dict(
    matching={"refine_impl": "gather"},
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 2},
    tpu={"max_keyframes": 8, "max_edges": 8, "max_odom_edges": 8},
)
# inline: the calibrated backend on the frontend's thread, grab_rgb (the tum
# cells); threaded: the ray backend on its worker beside the pipelined
# frontend (the stream cell)
SESSIONS = {"inline": dict(single_thread=True, calib=True, pipelined=False),
            "threaded": dict(single_thread=False, calib=False, pipelined=True)}
FRAME_SPANS = {"frame.dispatch", "frame.preprocess", "model.encode", "tracker.track_step", "model.decode",
               "frame.finalize"}
TASK_SPANS = {"backend.task", "backend.pairs", "backend.window", "backend.merge"}


@pytest.fixture(scope="module")
def model():
    m = mast3r.init_model(mast3r.tiny_config(), seed=0, device="cpu")
    m.downstream_head2.load_state_dict(m.downstream_head1.state_dict())
    m.dec_blocks2.load_state_dict(m.dec_blocks.state_dict())
    return m


def _session(model, single_thread, calib, pipelined):
    """N_FRAMES identical frames through a fresh SLAM; returns what each
    frame returned, in frame order, and the GN's evaluations per loop."""
    ov = dict(OVERRIDES, use_calib=calib)
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 16.0], [0, 0, 1.0]]) if calib else None
    slam = SLAM(make_config(**ov), model, (H, W), calib=K, use_backend=True, single_thread=single_thread,
                device="cpu")
    img = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    out = []
    for i in range(N_FRAMES):
        r = slam.grab_rgb_pipelined(img, timestamp=float(i)) if pipelined else slam.grab_rgb(img, timestamp=float(i))
        if r is not None:
            out.append(r)
    if pipelined:
        out.append(slam.flush())
    slam.terminate()
    return out


@pytest.fixture(scope="module")
def runs(model):
    """Per session: the records of an unprofiled run, then those of a
    profiled one with the GN's evaluations counted by a wrapped ``hg_fn``."""
    real = tracker._gn_loop_fused
    out = {}
    for name, kw in SESSIONS.items():
        spans.clear()
        _session(model, **kw)
        off = spans.records()
        evals = []

        def counting(cfg, T, hg_fn):
            n = [0]

            def hg(T_):
                n[0] += 1
                return hg_fn(T_)
            res = real(cfg, T, hg)
            evals.append(n[0])
            return res

        tracker._gn_loop_fused = counting
        try:
            spans.clear()
            with profile(activities=[ProfilerActivity.CPU]):
                results = _session(model, **kw)
        finally:
            tracker._gn_loop_fused = real
        out[name] = dict(off=off, on=spans.records(), results=results, evals=evals, main=threading.get_native_id())
    spans.clear()
    return out


@pytest.mark.parametrize("session", list(SESSIONS))
def test_off_records_nothing(runs, session):
    assert runs[session]["off"] == []
    assert spans.span("frame.dispatch") is spans.span("backend.task", frame=3, kf=1) is spans._OFF
    lock = threading.Lock()
    assert spans.held(lock, "frame.lock_wait_ns") is lock
    assert spans.count("tracker.gn_iters", 3) is None and spans.stamp() is None


def test_off_allocates_nothing_and_reads_no_clock(monkeypatch):
    class NoClock:
        def time_ns(self):
            raise AssertionError("a clock was read while no profiler records")

    monkeypatch.setattr(spans, "time", NoClock())
    lock = threading.Lock()

    def calls(n):
        for _ in range(n):
            with spans.span("frame.dispatch", frame=7):
                spans.count("tracker.gn_iters", 5)
                with spans.held(lock, "frame.lock_wait_ns"):
                    pass
            spans.stamp()

    def same_loop_without_spans(n, off=spans._OFF):
        for _ in range(n):
            with off:
                len("tracker.gn_iters")
                with lock:
                    pass
            len("")

    def peak(loop, n):
        loop(100)
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            loop(n)
            now, top = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert now == before
        return top - before

    # the loop's own iterator is all that either allocates
    assert peak(calls, 10_000) <= peak(same_loop_without_spans, 10_000)
    assert spans.records() == []


@pytest.mark.parametrize("session", list(SESSIONS))
def test_on_records_every_span_with_frame_parent_and_thread(runs, session):
    r = runs[session]
    recs = r["on"]
    by_id = {x["id"]: x for x in recs}
    names = {x["name"] for x in recs}
    threaded = not SESSIONS[session]["single_thread"]
    solve = "backend.solve_calib" if SESSIONS[session]["calib"] else "backend.solve_rays"
    want = FRAME_SPANS | TASK_SPANS | {solve} | ({"backend.snapshot"} if threaded else set())
    assert names == want, names ^ want

    def parent(x):
        return by_id[x["parent"]]["name"] if x["parent"] is not None else None

    dispatch = sorted((x for x in recs if x["name"] == "frame.dispatch"), key=lambda x: x["start_ns"])
    assert [x["frame"] for x in dispatch] == list(range(N_FRAMES))
    finalize = sorted((x for x in recs if x["name"] == "frame.finalize"), key=lambda x: x["start_ns"])
    assert [x["frame"] for x in finalize] == list(range(1, N_FRAMES))  # frame 0 is the map's init
    tasks = [x for x in recs if x["name"] == "backend.task"]
    worker = {x["thread"] for x in tasks}
    assert len(worker) == 1 and (worker != {r["main"]}) == threaded
    for x in recs:
        assert x["start_ns"] <= x["end_ns"]
        assert x["frame"] is not None, x
        p = parent(x)
        if p is not None:
            q = by_id[x["parent"]]
            assert q["thread"] == x["thread"] and q["frame"] == x["frame"]
            assert q["start_ns"] <= x["start_ns"] and x["end_ns"] <= q["end_ns"]
        n = x["name"]
        if n in FRAME_SPANS and p != "backend.pairs":
            assert x["thread"] == r["main"], n
        if n in ("frame.dispatch", "frame.finalize"):
            assert p is None
        elif n in ("frame.preprocess", "model.encode", "tracker.track_step"):
            assert p == "frame.dispatch", (n, p)
        elif n == "model.decode":  # the map's init, the tracker's pair, a task's missing direction
            assert p == "frame.dispatch" if x["frame"] == 0 else p in ("tracker.track_step", "backend.pairs"), p
        elif n == "backend.task":
            assert p == (None if threaded else "frame.finalize")
        else:
            assert p == "backend.task", (n, p)
            assert x["thread"] in worker
    # the frontend's lock waits land on its own spans, the task's on the task
    waits = [x for x in recs if "frame.lock_wait_ns" in x["counters"]]
    assert {x["name"] for x in waits} >= {"frame.dispatch"} and all(x["thread"] == r["main"] for x in waits)
    assert all(x["counters"]["frame.lock_wait_ns"] >= 0 for x in waits)
    assert all("backend.lock_wait_ns" in x["counters"] for x in tasks)


@pytest.mark.parametrize("session", list(SESSIONS))
def test_backend_task_points_to_the_frame_that_made_its_keyframe(runs, session):
    r = runs[session]
    made = [i for i, (ok, _, kf) in enumerate(r["results"]) if i >= 1 and ok and kf]
    assert made == list(range(1, N_FRAMES))
    tasks = sorted((x for x in r["on"] if x["name"] == "backend.task"), key=lambda x: x["attrs"]["kf"])
    assert [x["attrs"]["cause"] for x in tasks] == made
    assert [x["frame"] for x in tasks] == made
    assert [x["attrs"]["kf"] for x in tasks] == list(range(1, N_FRAMES))


@pytest.mark.parametrize("session", list(SESSIONS))
def test_gn_iterations_counted(runs, session):
    r = runs[session]
    steps = sorted((x for x in r["on"] if x["name"] == "tracker.track_step"), key=lambda x: x["start_ns"])
    counted = [x["counters"]["tracker.gn_iters"] for x in steps]
    assert counted == r["evals"] and len(counted) == N_FRAMES - 1
    assert all(1 <= n <= OVERRIDES["tracking"]["max_iters"] for n in counted)


@pytest.mark.parametrize("session", list(SESSIONS))
def test_queued_stamp_precedes_the_task(runs, session):
    tasks = [x for x in runs[session]["on"] if x["name"] == "backend.task"]
    assert tasks
    for x in tasks:
        q = x["attrs"]["queued_ns"]
        if SESSIONS[session]["single_thread"]:
            assert q is None
        else:
            assert q is not None and q <= x["start_ns"]


def test_span_shares_the_profilers_clock():
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("clock.check", frame=0):
            with torch.profiler.record_function("clock.check"):
                torch.ones(4).sum()
    mine = [x for x in spans.records() if x["name"] == "clock.check"]
    theirs = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.check"]
    spans.clear()
    assert len(mine) == 1 and len(theirs) == 1
    assert abs(theirs[0].start_ns() - mine[0]["start_ns"]) < 1_000_000
    assert mine[0]["start_ns"] <= theirs[0].start_ns() + theirs[0].duration_ns() <= mine[0]["end_ns"] + 1_000_000


def test_held_counts_the_wait_and_a_lone_counter_is_kept():
    spans.clear()
    lock = threading.Lock()
    taken, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            taken.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    with profile(activities=[ProfilerActivity.CPU]):
        t.start()
        assert taken.wait(5.0)
        threading.Timer(0.05, release.set).start()
        with spans.span("frame.dispatch", frame=11):
            with spans.held(lock, "frame.lock_wait_ns"):
                assert lock.locked()
        assert not lock.locked()
        spans.count("tracker.gn_iters", 2)  # no span open: recorded alone
    t.join(5.0)
    assert not t.is_alive()
    recs = spans.records()
    spans.clear()
    (d,) = [x for x in recs if x["name"] == "frame.dispatch"]
    assert d["frame"] == 11 and d["counters"]["frame.lock_wait_ns"] >= 40e6
    (c,) = [x for x in recs if x["name"] == "tracker.gn_iters"]
    assert c["counters"] == {"tracker.gn_iters": 2} and c["parent"] is None


def test_buffer_keeps_the_newest(monkeypatch):
    from collections import deque

    monkeypatch.setattr(spans, "_records", deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with spans.span("frame.dispatch", frame=i):
                pass
    assert [x["frame"] for x in spans.records()] == [2, 3, 4]
    spans.clear()
    assert spans.records() == []
