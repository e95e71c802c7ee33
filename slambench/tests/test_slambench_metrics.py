"""The per-layer readers and the trace reduction on a recorded slice."""

import types

import pytest
import torch

from slambench import run, trace, yardstick

# a recorded slice: 4 frames, 3 keyframe tasks, 0.5 s
SLICE = {
    "window_s": 0.5, "busy_s": 0.2, "launches": 4000, "syncs": 60,
    "span_device_s": {"model.encode": 0.04, "model.decode": 0.08},
    "span_host_s": {"tracker.track_step": [0.1, 0.3, 0.2], "backend.solve_calib": [0.02, 0.01, 0.05, 0.03]},
    "kernel_time_s": {"attention": 0.01, "ray": 0.0},
    "calls": {"attention": [(1, 16, 768, 768, 64, 2)] * 20},
    "slice_frames": 4, "slice_kf_tasks": 3, "flops_frame": 1.5e12, "flops_backend_decode": 1.0e12,
    "bf16_peak": 989e12,
}


def read(name, s=SLICE):
    return run.load_metric(name).read(s)


def test_readers_arithmetic():
    assert read("device_idle_pct") == pytest.approx(60.0)
    assert read("mfu_pct") == pytest.approx(100 * (4 * 1.5e12 + 3 * 1.0e12) / 0.5 / 989e12)
    assert read("launches_per_frame") == 1000 and read("syncs_per_frame") == 15
    assert read("model_dev_ms") == pytest.approx(30.0)
    assert read("track_host_ms") == pytest.approx(200.0)
    assert read("solve_ms") == pytest.approx(25.0)
    bound = yardstick.attention_bound(1, 16, 768, 768, 64, 2)
    assert read("attn_roofline_pct") == pytest.approx(100 * 20 * bound / 0.01)
    assert read("ray_roofline_pct") is None  # no ray call: nothing to read, never 0


def test_bounds_by_hand():
    # 4 B H Nq Nk D at 989 TFLOP/s vs 2 bytes (2 Nq + 2 Nk) D B H at 3.35 TB/s
    assert yardstick.attention_bound(1, 16, 768, 768, 64, 2) == pytest.approx(4 * 16 * 768 * 768 * 64 / 989e12)
    assert yardstick.attention_bound(1, 1, 8, 8, 64, 2) == pytest.approx(2 * 32 * 64 / 3.35e12)
    nbytes = 4 * (126 * 147456 * 4 + 64 * 147456 * 3 + 128 * 68)
    assert yardstick.ray_bound(126, 64, 128, 147456, 4) == pytest.approx(
        max(nbytes / 3.35e12, 126 * 147456 * yardstick.RAY_FLOPS_PER_POINT / 67e12))


def _ev(name, s, e, dev=False, id=0, linked=0, thread=1):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=s, end=e), id=id, linked_correlation_id=linked,
        thread=thread, device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def test_summarize_a_recorded_trace():
    # the host: a track step holding an encode; a matmul under the encode,
    # an add under the track step only, and a worker thread's op outside
    # any span of its own, all launching kernels (linked by correlation)
    events = [
        _ev("tracker.track_step", 0, 150, id=1), _ev("model.encode", 5, 100, id=2),
        _ev("aten::mm", 10, 20, id=3), _ev("aten::add", 120, 130, id=4),
        _ev("aten::mul", 12, 14, id=5, thread=2),
        _ev("cudaStreamSynchronize", 60, 90, id=6, linked=3),
        _ev("model.encode", 20, 90, dev=True),  # a span's own mark on the device
        _ev("ampere_gemm", 20, 50, dev=True, linked=3), _ev("flash_fwd_wgmma<4, 3>", 55, 65, dev=True, linked=3),
        _ev("Memcpy DtoH (Device -> Pinned)", 80, 85, dev=True, linked=3),
        _ev("vectorized_add", 200, 210, dev=True, linked=4), _ev("mul_kernel", 300, 301, dev=True, linked=5)]
    prof = types.SimpleNamespace(events=lambda: events)
    s = trace.summarize(prof, trace.Tracer(), window_s=400e-6)
    assert s["busy_s"] == pytest.approx(56e-6)
    assert s["launches"] == 4 and s["syncs"] == 1
    assert s["span_device_s"] == {"model.encode": pytest.approx(40e-6), "tracker.track_step": pytest.approx(10e-6)}
    assert s["kernel_time_s"]["attention"] == pytest.approx(10e-6)
    assert s["idle_gaps"][0] == ["tracker.track_step", pytest.approx(115e-6)]
    assert s["idle_gaps"][1] == ["outside spans", pytest.approx(90e-6)]
    assert s["device_ops"][0] == ("ampere_gemm", pytest.approx(30e-6))


def test_tracer_fails_loudly_when_a_name_is_gone(monkeypatch):
    import frodo_slam_tpu_torch.slam.system as system

    monkeypatch.delattr(system, "track_step")
    with pytest.raises(RuntimeError, match="track_step is gone"):
        trace.Tracer().install()


def test_ray_counts():
    jj = torch.tensor([1, 0, 1, 2], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    assert trace.ray_counts((jj, active, 4, 100, 4)) == (3, 2, 4, 100, 4)
