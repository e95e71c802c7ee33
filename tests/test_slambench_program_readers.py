"""The benchmark's readers of the program's own spans and counters
(``slambench/metrics/{preprocess_ms,gn_iters_per_frame,lock_wait_ms,
queue_wait_ms,kf_task_ms,solve_iters}.py``) on the records of a traced run of a cell at
tiny width on the CPU (``slambench.run.run_cell`` with ``trace`` on, as
``--trace 1`` runs it), and None where the slice holds nothing to read."""

import sys
import time

import pytest
import torch

from frodo_slam_tpu_torch.utils import spans
from slambench import run
from slambench.tests.tiny import tiny_cell

torch.set_num_threads(1)

SEED = 2 ** 31 + 7  # more than 32 signed bits hold
READERS = ["preprocess_ms", "gn_iters_per_frame", "lock_wait_ms", "queue_wait_ms", "kf_task_ms", "solve_iters"]


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
        return
    assert out["kf_task_ms"] >= run.load_metric("solve_ms").read(s) > 0
    assert out["queue_wait_ms"] > 0 and out["lock_wait_ms"] >= 0
    assert 1 <= out["solve_iters"] <= int(c["config"]["local_opt"]["max_iters"])


def test_none_without_records_or_without_the_program_spans(monkeypatch):
    s = {"slice_frames": 6, "window_s": 1.0}
    spans.clear()
    assert all(run.load_metric(name).read(s) is None for name in READERS)
    # a program that has no spans module (the parent of the change that added it)
    monkeypatch.setitem(sys.modules, "frodo_slam_tpu_torch.utils.spans", None)
    assert all(run.load_metric(name).read(s) is None for name in READERS)
