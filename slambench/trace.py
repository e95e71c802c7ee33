"""The reading of a traced window.

The spans come from the program: ``frodo_slam_tpu_torch.utils.spans``
records its own (``model.encode``, ``model.decode``, ``tracker.track_step``,
``backend.solve_rays``, ``frame.preprocess`` and the rest) while a
``torch.profiler`` records, on the profiler's clock, with the native id of
the thread that opened each. The harness wraps none of the port's
functions for them, so they survive a CUDA graph of the model, whose
replay makes no Python call.

One recorder stays: :class:`Tracer` wraps ``global_opt.ray_edge_systems``,
which runs inside the window solve, for the live rows and frames that the
ray kernel's bound needs. A name that is gone fails the run.

:func:`summarize` reduces the profiler's events and the program's records
to what the per-layer readers under ``metrics/`` take: device intervals,
kernel time by name, device time under each program span, host time of
each program span, synchronisations, the model's forwards by batch (the
forwards are the records of the spans that the cell's architecture names,
its ``MODEL_SPANS``).
"""

from __future__ import annotations

import importlib
import threading
from collections import Counter, defaultdict
from typing import Dict, List

import torch

# the recorded kernel: (module, attribute) -> record kind
RECORDED = {("frodo_slam_tpu_torch.slam.global_opt", "ray_edge_systems"): "ray"}
# the hand-written kernels' device names
KERNEL_NAMES = {"attention": ("flash_fwd",), "ray": ("ray_edge_kernel",)}


class Tracer:
    """Installs the ray recorder; ``on`` gates recording, so that only the
    traced slice is counted."""

    def __init__(self):
        self.on = False
        self.calls = defaultdict(list)  # record kind -> call arguments
        self._undo = []
        self._lock = threading.Lock()

    def install(self):
        try:
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
            raise RuntimeError(f"trace: {mod}.{attr} is gone; the recorder cannot be placed")
        setattr(module, attr, make(fn))
        self._undo.append((module, attr, fn))

    def _recorder(self, kind):
        def make(fn):
            def wrapped(*a, **k):
                if self.on:
                    with self._lock:
                        self.calls[kind].append(_ray_args(a))
                return fn(*a, **k)
            return wrapped
        return make


def _ray_args(a):
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


def _kind(e, cuda) -> str:
    """``device``, ``annotation`` (a ``record_function`` mark, on either
    timeline), ``runtime`` (a CUDA runtime or driver call: ``cuda*``,
    ``cu*``; an operator's name has its namespace, ``aten::``) or ``host``."""
    if e.is_user_annotation():
        return "annotation"
    if e.device_type() == cuda:
        return "device"
    return "runtime" if e.name().startswith("cu") else "host"


def _kineto_events(prof):
    """(name, kind, start s, end s, correlation, thread) of every event of
    the trace, read from the profiler's raw results: building
    ``prof.events()`` for a session's million events takes minutes. A
    kernel shares its correlation with the runtime call that launched it
    (``cudaLaunchKernel``, or ``cudaGraphLaunch`` for a graph's kernels).
    A runtime call's thread is its resource id: the launching thread's
    native id where the profiler has met that thread, else the id that
    CUPTI gives it (PyTorch 2.11 sets ``start_thread_id`` to 1 for every
    event of the trace, and records no operator on a thread that the
    profiler was not started on)."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    return [(e.name(), _kind(e, cuda), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9,
             e.correlation_id(), e.device_resource_id()) for e in prof.profiler.kineto_results.events()]


def _thread_map(runtime_by_thread, spans_by_thread):
    """Trace thread -> program thread (native id), and how each was found:
    ``native`` where the trace's id is the program's own, else
    ``enclosure``: of the program threads not matched natively (of all,
    where none is left), the one whose spans enclose the most of that
    thread's runtime calls."""
    import numpy as np

    tops = {p: np.array(_merge([(s, t) for s, t, _ in sp])) for p, sp in spans_by_thread.items()}
    out, how = {}, Counter()
    for tt in runtime_by_thread:
        if tt in spans_by_thread:
            out[tt] = tt
            how["native"] += 1
    free = {p: iv for p, iv in tops.items() if p not in out} or tops
    for tt, times in runtime_by_thread.items():
        if tt in out:
            continue
        t = np.sort(np.asarray(times))
        best, n_best = None, 0
        for p, iv in free.items():
            n = int((np.searchsorted(t, iv[:, 1], side="right") - np.searchsorted(t, iv[:, 0])).sum())
            if n > n_best:
                best, n_best = p, n
        if best is not None:
            out[tt] = best
            how["enclosure"] += 1
    return out, dict(how)


def _owners(times, spans):
    """For sorted launch times on one thread, the index into ``spans`` of
    the innermost span open at each (-1 outside every span). Spans nest,
    so the innermost is the shortest of those that hold the time."""
    import numpy as np

    own = np.full(len(times), -1)
    for i in sorted(range(len(spans)), key=lambda i: spans[i][1] - spans[i][0]):  # innermost first
        s, t, _ = spans[i]
        seg = own[np.searchsorted(times, s): np.searchsorted(times, t, side="right")]
        seg[seg < 0] = i
    return own


def summarize(prof, tracer: Tracer, window_s: float, records: List[Dict], model_spans) -> Dict:
    """What the readers take from one traced slice: the profiler's trace and
    the program's span ``records`` of the same slice, whose spans named in
    ``model_spans`` hold a forward of the model each (attribute ``batch``, 1
    if absent). Times in seconds.

    A kernel belongs to the innermost program span that was open on its
    launching thread when the runtime call that launched it started (the
    trace links each kernel to that call by its correlation id; a graph's
    kernels to its ``cudaGraphLaunch``)."""
    dev = []
    by_name = defaultdict(float)
    runtime = {}  # correlation -> (start s, trace thread)
    syncs = 0
    for name, kind, s, t, corr, thread in _kineto_events(prof):
        if kind == "device":
            dev.append((s, t, name, corr))
            by_name[name] += t - s
        elif kind != "annotation":
            if "Synchronize" in name:
                syncs += 1
            if kind == "runtime":
                runtime[corr] = (s, thread)
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]

    spans_by_thread = defaultdict(list)  # native thread -> (start s, end s, name)
    host = defaultdict(list)
    model_calls = Counter()
    for r in records:
        if r["start_ns"] == r["end_ns"] and r["name"] in r["counters"]:
            continue  # a counter recorded outside any span
        s, t = r["start_ns"] * 1e-9, r["end_ns"] * 1e-9
        spans_by_thread[r["thread"]].append((s, t, r["name"]))
        host[r["name"]].append(t - s)
        if r["name"] in model_spans:
            model_calls[(r["name"], int(r["attrs"].get("batch", 1)))] += 1

    launched = defaultdict(list)  # trace thread -> (launch s, device s, kernel name)
    unlinked = 0
    for s, t, name, corr in kernels:
        call = runtime.get(corr)
        if call is None:
            unlinked += 1
        else:
            launched[call[1]].append((call[0], t - s, name))
    tmap, how = _thread_map({tt: [x[0] for x in v] for tt, v in launched.items()}, spans_by_thread)

    span_dev = defaultdict(float)
    attn = [0, 0]  # attention launches inside a model span, all of them
    for tt, ks in launched.items():
        ks.sort()
        sp = spans_by_thread.get(tmap.get(tt), [])
        for (_, d, name), o in zip(ks, _owners([k[0] for k in ks], sp)):
            if o >= 0:
                span_dev[sp[o][2]] += d
            if any(n in name for n in KERNEL_NAMES["attention"]):
                attn[1] += 1
                attn[0] += int(o >= 0 and sp[o][2] in model_spans)

    merged = _merge([(s, t) for s, t, _, _ in dev])
    busy = sum(t - s for s, t in merged)
    longest = sorted(((s1 - t0, 0.5 * (t0 + s1)) for (_, t0), (s1, _) in zip(merged, merged[1:])),
                     reverse=True)[:10]
    all_spans = [x for sp in spans_by_thread.values() for x in sp]
    gaps = []
    for g, mid in longest:  # labelled by the innermost program span open then, on any thread
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
        "span_host_s": dict(host),
        "kernel_time_s": kernel_time,
        "model_calls": [[name, b, n] for (name, b), n in sorted(model_calls.items())],
        "model_spans": list(model_spans),
        "calls": tracer.calls,
        # how the spans met the trace: kernels without a runtime call, how
        # trace threads were matched, the attention launches' share in a model span
        "linking": {"unlinked_kernels": unlinked, "threads": how,
                    "attn_in_model": attn[0] / attn[1] if attn[1] else None},
    }


def ray_counts(call) -> tuple:
    """(A live rows, D distinct frames they read, E rows, N points, itemsize)
    of one recorded ray-kernel call."""
    jj, active, E, N, itemsize = call
    return int(active.sum()), int(torch.unique(jj[active]).numel()), E, N, itemsize
