"""The benchmark's readers of the program's own spans and counters
(``slambench/metrics/{preprocess_ms,gn_iters_per_frame,lock_wait_ms,
queue_wait_ms,kf_task_ms,solve_iters,solve_graph_share}.py``) on the records of a traced
run of a cell at tiny width on the CPU (``slambench.run.run_cell`` with ``trace`` on, as
``--trace 1`` runs it), and None where the slice holds nothing to read;
``solve_graph_share`` also on hand-made solve records."""

import sys
import time

import pytest
import torch

from frodo_slam_tpu_torch.utils import spans
from slambench import run
from slambench.tests.tiny import tiny_cell

torch.set_num_threads(1)

SEED = 2 ** 31 + 7  # more than 32 signed bits hold
READERS = ["preprocess_ms", "gn_iters_per_frame", "lock_wait_ms", "queue_wait_ms", "kf_task_ms", "solve_iters",
           "solve_graph_share"]


@pytest.fixture(scope="module", params=["stream288.kf-burst", "tum384.track"])
def traced(request):
    spans.clear()
    c = tiny_cell(request.param)
    r = run.run_cell(c, SEED, 1.0, True, "cpu", time.time())
    assert run.judge(r["checks"], c["limits"])[0]
    listed = {m["name"] for m in c["per_layer"]}
    out = {name: run.load_metric(name).read(r["summary"]) for name in READERS}
    yield request.param, c, r["summary"], listed, out
    spans.clear()


def test_each_reader_reads_in_the_cells_its_entry_names(traced):
    workload, c, s, listed, out = traced
    assert set(READERS) & listed <= {k for k, v in out.items() if v is not None}
    assert s["slice_frames"] == c["traffic"]["trace_frames"]
    assert 0 < out["preprocess_ms"] < run.load_metric("track_host_ms").read(s)
    # identical frames: the first GN step lands, the second confirms it
    assert 1 <= out["gn_iters_per_frame"] <= int(c["config"]["tracking"]["max_iters"])


def test_backend_readers(traced):
    workload, c, s, listed, out = traced
    if workload == "tum384.track":  # no keyframe after the first: no backend task
        assert out["kf_task_ms"] is None and out["queue_wait_ms"] is None and out["solve_iters"] is None
        assert out["solve_graph_share"] is None
        return
    assert out["kf_task_ms"] >= run.load_metric("solve_ms").read(s) > 0
    assert out["queue_wait_ms"] > 0 and out["lock_wait_ms"] >= 0
    assert 1 <= out["solve_iters"] <= int(c["config"]["local_opt"]["max_iters"])
    assert out["solve_graph_share"] == 0.0  # the CPU runs the eager step


def test_none_without_records_or_without_the_program_spans(monkeypatch):
    s = {"slice_frames": 6, "window_s": 1.0}
    spans.clear()
    assert all(run.load_metric(name).read(s) is None for name in READERS)
    # a program that has no spans module (the parent of the change that added it)
    monkeypatch.setitem(sys.modules, "frodo_slam_tpu_torch.utils.spans", None)
    assert all(run.load_metric(name).read(s) is None for name in READERS)


def _solve_record(name, **counters):
    return {"id": 0, "name": name, "frame": None, "start_ns": 0, "end_ns": 1, "thread": 0, "parent": None,
            "attrs": {}, "counters": counters}


@pytest.mark.parametrize("solves,want", [
    # a new shape's capture solve, then two at its cached shape: 28 replays of 30 iterations
    ([("backend.solve_calib", dict(solve_iters=10, step_replays=9, step_captures=1)),
      ("backend.solve_calib", dict(solve_iters=10, step_replays=10, step_captures=0)),
      ("backend.solve_rays", dict(solve_iters=10, step_replays=9))], 28 / 30),
    ([("backend.solve_rays", dict(solve_iters=4, step_replays=0, step_captures=0))], 0.0),
    ([("backend.solve_calib", dict(solve_iters=10))], None),  # a program without the counter
    ([("backend.task", dict(step_replays=3, solve_iters=3))], None),  # not a solve span
    ([("backend.solve_calib", dict(solve_iters=0, step_replays=0))], None),  # no iteration
])
def test_solve_graph_share_on_hand_made_records(monkeypatch, solves, want):
    import frodo_slam_tpu_torch.utils.spans as program_spans

    records = [_solve_record(name, **{"backend." + k: v for k, v in c.items()}) for name, c in solves]
    monkeypatch.setattr(program_spans, "records", lambda: records)
    got = run.load_metric("solve_graph_share").read({"slice_frames": 6, "window_s": 1.0})
    assert got == (None if want is None else pytest.approx(want))
