"""Spans, recorders and the reading of a traced window.

In a ``--trace 1`` run the harness wraps the port's functions at the names
through which their callers look them up, each call inside a
``torch.profiler.record_function`` span of its own name, and records the
arguments that the kernels' bounds need. A name that is gone fails the
run. :func:`summarize` reduces the profiler's events to what the per-layer
readers under ``metrics/`` take: device intervals, kernel time by name,
device time under each span, host time of each span, synchronisations.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict
from typing import Dict

import torch

# span name -> (module, attribute): where the port's callers look it up
SPANS = {
    "model.encode": ("frodo_slam_tpu_torch.models.mast3r", "encode_image"),
    "model.decode": ("frodo_slam_tpu_torch.models.mast3r", "decode_and_heads"),
    "tracker.track_step": ("frodo_slam_tpu_torch.slam.system", "track_step"),
    "backend.solve_rays": ("frodo_slam_tpu_torch.slam.backend", "solve_gn_rays"),
    "backend.solve_calib": ("frodo_slam_tpu_torch.slam.backend", "solve_gn_calib"),
}
# kernels whose calls are recorded: (module, attribute) -> record kind
RECORDED = {
    ("frodo_slam_tpu_torch.models.layers", "flash_attention"): "attention",
    ("frodo_slam_tpu_torch.slam.global_opt", "ray_edge_systems"): "ray",
}
# the hand-written kernels' device names
KERNEL_NAMES = {"attention": ("flash_fwd",), "ray": ("ray_edge_kernel",)}


class Tracer:
    """Installs the span wrappers and recorders; ``on`` gates recording, so
    that only the traced slice is counted."""

    def __init__(self):
        self.on = False
        self.host = defaultdict(list)  # span -> host seconds of each call
        self.calls = defaultdict(list)  # record kind -> call arguments
        self._undo = []
        self._lock = threading.Lock()

    def install(self):
        try:
            for span, (mod, attr) in SPANS.items():
                self._wrap(mod, attr, self._span(span))
            for (mod, attr), kind in RECORDED.items():
                self._wrap(mod, attr, self._recorder(kind))
        except RuntimeError:
            self.uninstall()
            raise
        return self

    def uninstall(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo = []

    def _wrap(self, mod, attr, make):
        module = importlib.import_module(mod)
        fn = getattr(module, attr, None)
        if fn is None:
            raise RuntimeError(f"trace: {mod}.{attr} is gone; the span cannot be placed")
        setattr(module, attr, make(fn))
        self._undo.append((module, attr, fn))

    def _span(self, name):
        def make(fn):
            def wrapped(*a, **k):
                if not self.on:
                    return fn(*a, **k)
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    out = fn(*a, **k)
                with self._lock:
                    self.host[name].append(time.perf_counter() - t0)
                return out
            return wrapped
        return make

    def _recorder(self, kind):
        def make(fn):
            def wrapped(*a, **k):
                if self.on:
                    with self._lock:
                        self.calls[kind].append(_call_args(kind, a))
                return fn(*a, **k)
            return wrapped
        return make


def _call_args(kind, a):
    if kind == "attention":
        q, k = a[0], a[1]
        B, H, Nq, D = q.shape
        return (B, H, Nq, k.shape[2], D, q.element_size())
    # ray_edge_systems(scal, XiT, w0, X, jj, active, ...): the live rows and
    # frames are counted after the window, from copies
    XiT, jj, active = a[1], a[4], a[5]
    return (jj.detach().clone(), active.detach().clone(), XiT.shape[0], XiT.shape[2], XiT.element_size())


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kineto_events(prof):
    """(name, on_device, start s, end s, correlation, linked correlation,
    thread) of every event of the trace, read from the profiler's raw
    results: building ``prof.events()`` for a session's million events
    takes minutes."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:  # a recorded trace in the tests
        return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                 e.id, e.linked_correlation_id, e.thread) for e in prof.events()]
    cuda = DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9,
             e.correlation_id(), e.linked_correlation_id(), e.start_thread_id()) for e in raw.events()]


def summarize(prof, tracer: Tracer, window_s: float) -> Dict:
    """What the readers take from one traced slice. Times in seconds.

    A kernel belongs to the innermost span that was open on the host
    thread when the operation that launched it started (the trace links
    each kernel to that operation by its correlation id)."""
    import numpy as np

    span_names = set(SPANS)
    dev, spans = [], defaultdict(list)
    by_name = defaultdict(float)
    frontend = {}
    syncs = 0
    for name, on_dev, s, t, corr, linked, thread in _kineto_events(prof):
        if on_dev:
            if name not in span_names:  # the spans' own marks on the device timeline
                dev.append((s, t, name, linked))
                by_name[name] += t - s
            continue
        if "Synchronize" in name:
            syncs += 1
        if name in span_names:
            spans[thread].append((s, t, name))
        if linked == 0:
            frontend[corr] = (s, thread)
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]

    span_dev = defaultdict(float)
    per_thread = defaultdict(list)  # thread -> (launch time, device seconds)
    for s, t, _, linked in kernels:
        f = frontend.get(linked)
        if f is not None:
            per_thread[f[1]].append((f[0], t - s))
    for thread, sp in spans.items():
        launches = sorted(per_thread.get(thread, []))
        if not launches:
            continue
        times = np.array([x[0] for x in launches])
        dur = np.array([x[1] for x in launches])
        taken = np.zeros(len(times), bool)
        for s, t, name in sorted(sp, key=lambda x: x[1] - x[0]):  # innermost first
            lo, hi = np.searchsorted(times, s), np.searchsorted(times, t, side="right")
            free = ~taken[lo:hi]
            span_dev[name] += float(dur[lo:hi][free].sum())
            taken[lo:hi] = True

    merged = _merge([(s, t) for s, t, _, _ in dev])
    busy = sum(t - s for s, t in merged)
    longest = sorted(((s1 - t0, 0.5 * (t0 + s1)) for (_, t0), (s1, _) in zip(merged, merged[1:])),
                     reverse=True)[:10]
    all_spans = [x for sp in spans.values() for x in sp]
    gaps = []
    for g, mid in longest:  # labelled by the innermost span the host was in
        inner = [x for x in all_spans if x[0] <= mid <= x[1]]
        gaps.append((g, min(inner, key=lambda x: x[1] - x[0])[2] if inner else "outside spans"))
    kernel_time = {kind: sum(t - s for s, t, n, _ in kernels if any(k in n for k in names))
                   for kind, names in KERNEL_NAMES.items()}
    return {
        "window_s": window_s,
        "busy_s": busy,
        "launches": len(kernels),
        "syncs": syncs,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[label, g] for g, label in gaps],
        "span_device_s": dict(span_dev),
        "span_host_s": {k: list(v) for k, v in tracer.host.items()},
        "kernel_time_s": kernel_time,
        "calls": tracer.calls,
    }


def ray_counts(call) -> tuple:
    """(A live rows, D distinct frames they read, E rows, N points, itemsize)
    of one recorded ray-kernel call."""
    jj, active, E, N, itemsize = call
    return int(active.sum()), int(torch.unique(jj[active]).numel()), E, N, itemsize
