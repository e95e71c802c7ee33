"""The readers survive a CUDA graph of the model: the tiny model's encode,
captured once and replayed inside the program's ``model.encode`` span
under the profiler, is read from the program's span and the trace alone
(no Python call of the model's functions happens in the replay). Needs
the card: ``python3 -m pytest slambench/tests -q -m card``."""

import dataclasses
import math
import time

import pytest
import torch

from slambench import run, trace
from tiny import TINY

SEED = 2 ** 31 + 57


@pytest.mark.card
def test_readers_survive_a_cuda_graph_of_the_encode():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import yaml

    from frodo_slam_tpu_torch.models import mast3r
    from frodo_slam_tpu_torch.utils import spans
    from slambench import weights

    path = run.ROOT / "slambench/configs/mast3r-vitl-384x512-tum-calib.yaml"
    m = dict(yaml.safe_load(path.read_text())["model"], **TINY)
    keys = {f.name for f in dataclasses.fields(mast3r.MASt3RConfig)}
    cfg = mast3r.MASt3RConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items() if k in keys},
                              dtype=torch.bfloat16, head_dtype=torch.float32)
    with torch.device("meta"):
        model = mast3r.MASt3R(cfg)
    model.load_state_dict(weights.make(m, SEED, "cuda"), strict=True, assign=True)
    model.eval()
    hw = (96, 128)
    img = torch.randn((1, *hw, 3), generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds and loads the kernels, outside the capture
        for _ in range(2):
            mast3r.encode_image(model, img)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        feat, _ = mast3r.encode_image(model, img)
    eager = mast3r.encode_image(model, img)[0]
    torch.cuda.synchronize()

    spans.clear()
    t0 = time.perf_counter()
    with trace.profiler() as prof:
        with spans.span("model.encode", batch=1):
            graph.replay()
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    s = trace.summarize(prof, trace.Tracer(), window, spans.records(), ("model.encode", "model.decode"))
    assert (feat - eager).abs().max() <= 1e-2 * eager.abs().max()

    kernel_s = s["busy_s"]
    print(f"graph replay: {s['launches']} kernels, device {kernel_s * 1e3:.4f} ms, span_device_s "
          f"{s['span_device_s']}, attention {s['kernel_time_s']['attention'] * 1e6:.2f} us, "
          f"linking {s['linking']}, model_calls {s['model_calls']}")
    # every replayed kernel belongs to the span the replay ran in
    assert s["launches"] > 0 and s["linking"]["unlinked_kernels"] == 0
    assert set(s["span_device_s"]) == {"model.encode"} and s["span_device_s"]["model.encode"] > 0
    assert s["linking"]["attn_in_model"] == 1.0
    assert s["kernel_time_s"]["attention"] > 0 and s["model_calls"] == [["model.encode", 1, 1]]
    s.update(slice_frames=1, arch="mast3r", arch_root=str(run.ROOT),
             model_shape={"widths": m, "img_hw": hw, "dtype": "bfloat16"})
    pct = run.load_metric("attn_roofline_pct").read(s)
    dev_ms = run.load_metric("model_dev_ms").read(s)
    print(f"graph replay: attn_roofline_pct {pct!r}, model_dev_ms {dev_ms!r}")
    assert pct is not None and math.isfinite(pct) and 0 < pct <= 100
    assert dev_ms == pytest.approx(1e3 * s["span_device_s"]["model.encode"])
