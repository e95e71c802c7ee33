"""The per-layer readers and the trace reduction on a recorded slice."""

import importlib
import time
import types

import pytest
import torch
import yaml

from slambench import run, trace, yardstick

VIT_L = dict(patch_size=16, enc_embed_dim=1024, enc_depth=24, enc_num_heads=16, dec_embed_dim=768,
             dec_depth=12, dec_num_heads=12)
# the configuration's whole model section, for the frame's FLOP count
MODEL = yaml.safe_load((run.ROOT / "slambench/configs/mast3r-vitl-384x512-tum-calib.yaml").read_text())["model"]
MODEL_SPANS = ("model.encode", "model.decode")

# a recorded slice: 4 frames, 3 keyframe tasks, 0.5 s
SLICE = {
    "window_s": 0.5, "busy_s": 0.2, "launches": 4000, "syncs": 60,
    "span_device_s": {"model.encode": 0.04, "model.decode": 0.08},
    "span_host_s": {"tracker.track_step": [0.1, 0.3, 0.2], "backend.solve_calib": [0.02, 0.01, 0.05, 0.03]},
    "kernel_time_s": {"attention": 0.01, "ray": 0.0},
    "model_calls": [["model.decode", 1, 7], ["model.encode", 1, 4]], "model_spans": list(MODEL_SPANS),
    "arch": "mast3r", "arch_root": str(run.ROOT),
    "model_shape": {"widths": MODEL, "img_hw": (384, 512), "dtype": "bfloat16"},
    "calls": {},
    "slice_frames": 4, "slice_kf_tasks": 3,
}


def read(name, s=SLICE):
    return run.load_metric(name).read(s)


def test_readers_arithmetic():
    assert read("device_idle_pct") == pytest.approx(60.0)
    fl = yardstick.model_flops(MODEL, (384, 512))  # 1.5102 TFLOP a frame, 0.9871 a pair decode
    assert read("mfu_pct") == pytest.approx(100 * (4 * fl["total"] + 3 * (fl["total"] - fl["encode"])) / 0.5 / 989e12)
    assert read("launches_per_frame") == 1000 and read("syncs_per_frame") == 15
    assert read("model_dev_ms") == pytest.approx(30.0)
    assert read("track_host_ms") == pytest.approx(200.0)
    assert read("solve_ms") == pytest.approx(25.0)
    # 4 encodes (24 calls at 16 heads) and 7 pair decodes (48 calls at 12 heads), 768 tokens
    bound = 4 * 24 * yardstick.attention_bound(1, 16, 768, 768, 64, 2) \
        + 7 * 48 * yardstick.attention_bound(1, 12, 768, 768, 64, 2)
    assert read("attn_roofline_pct") == pytest.approx(100 * bound / 0.01)
    assert read("ray_roofline_pct") is None  # no ray call: nothing to read, never 0


def test_readers_read_none_where_the_slice_holds_nothing():
    empty = dict(SLICE, span_device_s={}, span_host_s={}, model_calls=[], kernel_time_s={"attention": 0.0})
    for name in ("model_dev_ms", "track_host_ms", "solve_ms", "attn_roofline_pct", "ray_roofline_pct"):
        assert read(name, empty) is None, name
    # forwards but no attention kernel on the device (the CPU): None, not 0
    assert read("attn_roofline_pct", dict(SLICE, kernel_time_s={"attention": 0.0})) is None


def test_bounds_by_hand():
    # 4 B H Nq Nk D at 989 TFLOP/s vs 2 bytes (2 Nq + 2 Nk) D B H at 3.35 TB/s
    assert yardstick.attention_bound(1, 16, 768, 768, 64, 2) == pytest.approx(4 * 16 * 768 * 768 * 64 / 989e12)
    assert yardstick.attention_bound(1, 1, 8, 8, 64, 2) == pytest.approx(2 * 32 * 64 / 3.35e12)
    nbytes = 4 * (126 * 147456 * 4 + 64 * 147456 * 3 + 128 * 68)
    assert yardstick.ray_bound(126, 64, 128, 147456, 4) == pytest.approx(
        max(nbytes / 3.35e12, 126 * 147456 * yardstick.RAY_FLOPS_PER_POINT / 67e12))


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_attention_bound_by_hand(batch):
    # ViT-L at 384x512: 768 tokens, head dim 64, bf16; both parts bound by operations
    b = yardstick.forward_attention_bound(VIT_L, (384, 512), batch, "bfloat16")
    assert b["encode"] == pytest.approx(24 * 4 * batch * 16 * 768 ** 2 * 64 / 989e12)
    assert b["decode"] == pytest.approx(2 * 12 * 2 * 4 * batch * 12 * 768 ** 2 * 64 / 989e12)
    # 288x512: 576 tokens; f32 at the f32 peak
    b = yardstick.forward_attention_bound(VIT_L, (288, 512), batch, "float32")
    assert b["encode"] == pytest.approx(24 * 4 * batch * 16 * 576 ** 2 * 64 / 67e12)
    # a tiny forward is bound by its bytes: q, k, v read once, o written, 2 bytes each
    tiny = dict(VIT_L, enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=48, dec_num_heads=2)
    b = yardstick.forward_attention_bound(tiny, (64, 128), batch, "bfloat16")
    assert b["encode"] == pytest.approx(2 * 2 * batch * 2 * 4 * 32 * 32 / 3.35e12)
    assert b["decode"] == pytest.approx(48 * 2 * batch * 2 * 4 * 32 * 24 / 3.35e12)


def _ev(name, s, e, kind="cpu_op", corr=0, thread=1):
    """One raw event of the profiler's results (the methods that PyTorch
    2.11's ``_KinetoEvent`` has), times in microseconds."""
    from torch.autograd import DeviceType

    dev = kind in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
    return types.SimpleNamespace(
        name=lambda: name, is_user_annotation=lambda: kind in ("user_annotation", "gpu_user_annotation"),
        device_type=lambda: DeviceType.CUDA if dev else DeviceType.CPU, start_ns=lambda: int(s * 1000),
        duration_ns=lambda: int((e - s) * 1000), correlation_id=lambda: corr, start_thread_id=lambda: 1,
        device_resource_id=lambda: thread)


def _rec(name, s, e, thread, attrs=None, counters=None):
    return {"id": 0, "name": name, "frame": 1, "start_ns": int(s * 1000), "end_ns": int(e * 1000),
            "thread": thread, "parent": None, "attrs": attrs or {}, "counters": counters or {}}


A, B = 101, 202  # two program threads (native ids)
# the frontend thread A: a frame with its preprocess, an encode, a track step
# holding a pair decode; the backend thread B: a task holding a solve
RECORDS = [
    _rec("frame.dispatch", 0, 400, A), _rec("frame.preprocess", 5, 60, A),
    _rec("model.encode", 65, 200, A, {"batch": 2}), _rec("tracker.track_step", 210, 390, A),
    _rec("model.decode", 220, 290, A),  # no batch attribute: batch 1
    _rec("backend.task", 100, 500, B), _rec("backend.solve_calib", 345, 480, B),
    _rec("frame.lock_wait_ns", 50, 50, A, counters={"frame.lock_wait_ns": 7}),  # a counter, no span
]
# the trace: A's runtime calls carry its native id, B's an id of CUPTI's
# (7: a thread the profiler was not started on, whose launches lie inside
# A's spans too); a graph's kernels share their cudaGraphLaunch's correlation
EVENTS = [
    _ev("cudaMemcpyAsync", 20, 22, "cuda_runtime", 14, A), _ev("Memcpy HtoD (Pageable -> Device)", 25, 30,
                                                               "gpu_memcpy", 14),
    _ev("cudaLaunchKernel", 40, 41, "cuda_runtime", 15, A), _ev("normalize_kernel", 45, 50, "kernel", 15),
    _ev("cudaLaunchKernel", 80, 81, "cuda_runtime", 11, A), _ev("flash_fwd_wgmma<4, 3>", 90, 100, "kernel", 11),
    _ev("cudaGraphLaunch", 230, 232, "cuda_runtime", 12, A),
    _ev("flash_fwd_wgmma<4, 3>", 240, 250, "kernel", 12), _ev("sm90_gemm", 250, 270, "kernel", 12),
    _ev("cudaLaunchKernel", 320, 321, "cuda_runtime", 13, A), _ev("vectorized_add", 330, 340, "kernel", 13),
    _ev("cudaLaunchKernel", 360, 361, "cuda_runtime", 16, 7), _ev("solve_kernel", 360, 380, "kernel", 16),
    _ev("cudaStreamSynchronize", 470, 480, "cuda_runtime", 17, 7),
    _ev("aten::mm", 500, 510, "cpu_op", 11, 1),  # a host op whose id meets a runtime call's
    _ev("user.mark", 0, 1000, "user_annotation", 30, 1), _ev("user.mark", 0, 1000, "gpu_user_annotation", 30),
    _ev("lost_kernel", 600, 610, "kernel", 99), _ev("Memset (Device)", 700, 705, "gpu_memset", 98),
]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_summarize_program_spans_on_a_recorded_trace():
    s = trace.summarize(_prof(EVENTS), trace.Tracer(), 800e-6, RECORDS, MODEL_SPANS)
    us = pytest.approx
    assert s["busy_s"] == us(95e-6) and s["launches"] == 7 and s["syncs"] == 1
    # each kernel to the innermost span open on its launching thread when
    # its runtime call started; the graph's two kernels to the pair decode
    assert s["span_device_s"] == {"frame.preprocess": us(5e-6), "model.encode": us(10e-6),
                                  "model.decode": us(30e-6), "tracker.track_step": us(10e-6),
                                  "backend.solve_calib": us(20e-6)}
    assert s["kernel_time_s"]["attention"] == us(20e-6)
    assert s["span_host_s"]["tracker.track_step"] == [us(180e-6)]
    assert s["span_host_s"]["backend.solve_calib"] == [us(135e-6)]
    assert "frame.lock_wait_ns" not in s["span_host_s"]
    assert s["model_calls"] == [["model.decode", 1, 1], ["model.encode", 2, 1]]
    assert s["linking"] == {"unlinked_kernels": 1, "threads": {"native": 1, "enclosure": 1}, "attn_in_model": 1.0}
    # each gap by the innermost program span open at its midpoint, on any thread
    assert s["idle_gaps"] == [["backend.task", us(220e-6)], ["model.encode", us(140e-6)],
                              ["outside spans", us(90e-6)], ["tracker.track_step", us(60e-6)],
                              ["model.encode", us(40e-6)], ["backend.solve_calib", us(20e-6)],
                              ["frame.preprocess", us(15e-6)]]
    assert s["device_ops"][0][1] == us(20e-6)


def test_summarize_without_program_spans():
    # a program without its own spans: the device readings stand, the
    # span readings hold nothing, and the readers read None
    s = trace.summarize(_prof(EVENTS), trace.Tracer(), 800e-6, [], MODEL_SPANS)
    assert s["launches"] == 7 and s["span_device_s"] == {} and s["span_host_s"] == {} and s["model_calls"] == []
    assert all(label == "outside spans" for label, _ in s["idle_gaps"])
    assert s["linking"]["attn_in_model"] == 0.0
    s.update(slice_frames=4, **{k: SLICE[k] for k in ("model_shape", "arch", "arch_root")})
    for name in ("model_dev_ms", "track_host_ms", "solve_ms", "attn_roofline_pct"):
        assert read(name, s) is None


def test_tracer_fails_loudly_when_a_name_is_gone(monkeypatch):
    import frodo_slam_tpu_torch.slam.global_opt as global_opt

    monkeypatch.delattr(global_opt, "ray_edge_systems")
    with pytest.raises(RuntimeError, match="ray_edge_systems is gone"):
        trace.Tracer().install()


def test_ray_counts():
    jj = torch.tensor([1, 0, 1, 2], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    assert trace.ray_counts((jj, active, 4, 100, 4)) == (3, 2, 4, 100, 4)


# the names a traced run leaves alone: the program's own spans stand for them
UNWRAPPED = [("frodo_slam_tpu_torch.models.mast3r", "encode_image"),
             ("frodo_slam_tpu_torch.models.mast3r", "decode_and_heads"),
             ("frodo_slam_tpu_torch.slam.system", "track_step"),
             ("frodo_slam_tpu_torch.slam.backend", "solve_gn_rays"),
             ("frodo_slam_tpu_torch.slam.backend", "solve_gn_calib"),
             ("frodo_slam_tpu_torch.models.layers", "flash_attention")]


@pytest.fixture(scope="module")
def traced_tiny():
    """A traced tiny run of ``tum384.kf-every`` on the CPU, with a wrapper of
    the test's own on ``layers.flash_attention`` that records every call,
    and the six names as the traced slice sees them."""
    from tiny import tiny_cell

    layers = importlib.import_module("frodo_slam_tpu_torch.models.layers")
    calls, seen = [], {}
    orig, orig_profiler = layers.flash_attention, trace.profiler

    def recording(q, k, v, *a, **kw):
        calls.append((*q.shape[:3], k.shape[2], q.shape[3], q.element_size()))
        return orig(q, k, v, *a, **kw)

    def profiler():  # the slice starts: the harness has installed what it installs
        seen.update({(m, n): getattr(importlib.import_module(m), n) for m, n in UNWRAPPED})
        calls.clear()
        return orig_profiler()

    layers.flash_attention, trace.profiler = recording, profiler
    before = {(m, n): getattr(importlib.import_module(m), n) for m, n in UNWRAPPED}
    try:
        c = tiny_cell("tum384.kf-every")
        r = run.run_cell(c, 2 ** 31 + 33, 1.0, True, "cpu", time.time())
        n_calls = len(calls)
    finally:
        layers.flash_attention, trace.profiler = orig, orig_profiler
    return c, r, before, seen, calls[:n_calls]


def test_traced_run_installs_no_wrapper_on_the_program(traced_tiny):
    _, r, before, seen, _ = traced_tiny
    assert seen and all(seen[k] is before[k] for k in UNWRAPPED), [k for k in UNWRAPPED if seen[k] is not before[k]]
    assert run.judge(r["checks"], traced_tiny[0]["limits"])[0]


def test_work_count_equals_the_calls_bound_on_a_tiny_traced_run(traced_tiny):
    c, r, _, _, calls = traced_tiny
    s = r["summary"]
    # every model call at batch 1; the forwards' work is the calls' bound
    assert {b for _, b, _ in s["model_calls"]} == {1} and calls
    assert {x[0] for x in calls} == {1}
    n = {name: k for name, _, k in s["model_calls"]}
    m = c["config"]["model"]
    assert len(calls) == n["model.encode"] * m["enc_depth"] + n["model.decode"] * 4 * m["dec_depth"]
    per_call = sum(yardstick.attention_bound(*x) for x in calls)
    assert read("attn_roofline_pct", dict(s, kernel_time_s={"attention": 1.0})) == pytest.approx(100 * per_call)
