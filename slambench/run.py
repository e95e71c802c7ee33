"""The benchmark of ``frodo_slam_tpu_torch``'s SLAM system on the card.

    python -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``: set-up (imports, the weights
made on the card from the seed, one warm-up session on the cell's own
shapes, in which the port loads its kernels from ``build/kernels`` or
builds them there), then a closed loop of frames
through ``SLAM`` for ``--seconds`` (whole sessions: the session in flight
when the time is up is finished), then the comparison with the plain
reference that decides ``correct``, then one JSON line. Everything a cell
needs is found by name: ``configs/<config>.yaml``, ``traffic/<traffic>.json``,
``limits/<config>.json``, ``metrics/<metric>.py`` and, from the
configuration's ``model.arch`` (``mast3r`` where absent),
``archs/<arch>.py``: the model, its seeded weights, the plain reference, the
heads the probe hooks and the frozen work counts.

Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()  # before the heavy imports: set-up starts here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from .archs import arch_name, load_arch  # noqa: E402
from .probe import Probe  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "frodo_slam_tpu"}


# ---------------------------------------------------------------------------
# the cell, found by name
# ---------------------------------------------------------------------------

def load_cell(workload: str, root: pathlib.Path = ROOT) -> Dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and metrics (dicts of BENCHMARK.json's entries),
    its architecture's name and the root it is found under."""
    import yaml

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "slambench"
    config = yaml.safe_load((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{cell['config']}.json").read_text())
    arch = arch_name(config)
    load_arch(arch, root)  # an unknown architecture fails here, with its name and path

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell, "config_entry": conf, "config": config, "config_path": root / conf["file"],
        "traffic": traffic, "limits": limits, "arch": arch, "root": root,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The reader ``metrics/<name>.py``: its ``read(ctx)`` gives the value
    or None when the slice holds nothing to read."""
    path = root / "slambench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

class System:
    """The port's model and SLAM for one configuration, on ``device``; the
    model, its weights and the rest of what the harness takes from it come
    from the configuration's architecture (``self.arch``)."""

    def __init__(self, c: Dict, seed: int, device):
        import torch

        from frodo_slam_tpu_torch.config import make_config, merge_config
        from frodo_slam_tpu_torch.data.datasets import Intrinsics
        from frodo_slam_tpu_torch.data.image import resize_img
        self.arch = load_arch(c["arch"], c["root"])
        self.device = torch.device(device)
        self.widths = c["config"]["model"]
        cfg = make_config(str(c["config_path"]))
        cfg["tracking"]["match_frac_thresh"] = float(c["traffic"]["match_frac_thresh"])
        if c.get("slam_overrides"):  # studies only: the program's own lower-precision paths
            cfg = type(cfg)(merge_config(cfg, c["slam_overrides"]))
        self.cfg = cfg
        cam = c["config"]["camera"]
        self.cam_hw = (int(cam["height"]), int(cam["width"]))
        self.long_side = int(cam["long_side"])
        self.img_hw = tuple(resize_img(np.zeros((*self.cam_hw, 3), np.float32), self.long_side)["img"].shape[1:3])
        self.calib = None
        if cfg["use_calib"]:
            self.calib = Intrinsics.from_calib(self.long_side, self.cam_hw[1], self.cam_hw[0],
                                               np.asarray(c["config"]["calibration"], np.float64),
                                               use_calib=True, center_principal_point=True).K_frame
        dtype = getattr(torch, cfg["tpu"]["dtype"])
        head_dtype = getattr(torch, cfg["tpu"]["head_dtype"])
        served_head = getattr(torch, c["config"]["tpu"]["head_dtype"])
        sd = self.arch.make_weights(self.widths, seed, self.device, dtype=dtype, head_dtype=served_head)
        self.model = self.arch.build_model(self.widths, sd, dtype=dtype, head_dtype=head_dtype)
        self.pipelined = bool(cfg["tpu"].get("pipelined_frontend", False))
        self.cuda = self.device.type == "cuda"
        self.base_bytes = torch.cuda.memory_allocated(self.device) if self.cuda else 0

    def check_freed(self):
        """No session's map outlives it: once a session's system is freed,
        the card holds the weights and what the libraries keep for good (a
        worker thread's cuBLAS workspaces, 64 MiB), never a map (the
        keyframe and edge stores alone are over 3 GB)."""
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)
            left = torch.cuda.memory_allocated(self.device) - self.base_bytes
            if left > 256 << 20:
                raise RuntimeError(f"a finished session left {left} bytes allocated on the card")

    def slam(self):
        from frodo_slam_tpu_torch.slam.system import SLAM

        return SLAM(self.cfg, self.model, self.img_hw, calib=self.calib, retrieval_db=None,
                    use_backend=True, use_reloc=False, single_thread=bool(self.cfg["single_thread"]),
                    device=self.device)


def session_images(cam_hw, seed: int, n: int) -> List[np.ndarray]:
    """``n`` camera frames (h, w, 3) uint8, image i from the seed and i."""
    from .yardstick import wave_field

    h, w = cam_hw
    return [wave_field(np.random.default_rng([seed % 2 ** 63, i]), h, w) for i in range(n)]


def run_session(system: System, image: np.ndarray, n_frames: Optional[int], deadline: Optional[float],
                probe=None, n_decodes: int = 0, rng=None) -> Dict:
    """One session on a fresh map: frames of ``image`` until ``n_frames``
    (or, with None, until ``deadline``), each handed in as the camera or a
    dataset delivers it (f32 in [0, 1]) when the previous call returned;
    then the flush, the backend drained and stopped, the map read back, and
    the system freed. Returns what the session produced, with what
    ``probe`` (:class:`~slambench.probe.Probe`, ``n_decodes`` backend
    decodes due) kept of it."""
    from frodo_slam_tpu_torch.viz.visualization import read_map

    if probe is not None:
        probe.begin(n_decodes, rng)
    slam = system.slam()
    results = []
    now = time.perf_counter
    i = 0
    while (n_frames is None and now() < deadline) or (n_frames is not None and i < n_frames):
        frame = image.astype(np.float32) / 255.0
        if system.pipelined:
            out = slam.grab_rgb_pipelined(frame, timestamp=float(i))
        else:
            out = slam.grab_rgb(frame, timestamp=float(i))
        if out is not None:
            results.append(out)
        i += 1
    out = slam.flush()
    if out is not None:
        results.append(out)
    slam.terminate()
    snap = read_map(slam)  # the store's live slots and the backend's pairs, as the map viewer reads them
    _, poses = slam.keyframe_poses()
    a = slam.active_kf
    sess = {
        "n_submitted": i,
        "frames": [(bool(ok), np.array(T, np.float64), bool(kf)) for ok, T, kf in results],
        "poses": poses.astype(np.float64),
        "X": snap.X_canon.cpu().numpy(), "C": snap.C.cpu().numpy(), "N": snap.N.cpu().numpy(),
        "active": (a.X_canon.cpu().numpy(), a.C.cpu().numpy(), int(a.N)),
        "pairs": list(snap.pairs),
        "solve_poses": int(slam.backend.last_solve.get("poses", 0)),
    }
    if probe is not None:
        sess.update(probe.end())
    del slam, snap, a
    gc.collect()
    system.check_freed()
    return sess


def card(device) -> Dict:
    import torch

    out = {"platform": "gpu" if device.type == "cuda" else device.type, "count": 1}
    if device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(device)
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                  f"--id={device.index or 0}"], capture_output=True, text=True, timeout=20)
            out["power_limit"] = smi.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out["power_limit"] = "unknown"
    else:
        out["kind"] = "cpu"
    return out


def run_cell(c: Dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             hooks: Optional[Dict] = None) -> Dict:
    """One run: set-up, warm-up, the window, the comparison. Returns the
    result's fields. ``hooks`` (tests only) may patch the system under test
    after set-up (``after_setup``)."""
    import torch

    from frodo_slam_tpu_torch.utils import spans

    from . import reference, trace as trace_mod

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    traffic = c["traffic"]
    session_len = traffic.get("session_frames")
    system = System(c, seed, device)
    arch = system.arch
    images = session_images(system.cam_hw, seed, int(traffic["images"]) + 1)
    warm_img = images.pop()  # the warm-up's own image, never judged
    run_session(system, warm_img, int(traffic["warmup_frames"]), None)
    if hooks and "after_setup" in hooks:
        hooks["after_setup"](system)
    sync()
    setup_s = time.time() - t_start

    tracer = trace_mod.Tracer().install() if trace else None
    probe = Probe(arch.head_modules(system.model)).install()
    thresh = float(traffic["match_frac_thresh"])
    prof = None
    sessions, slice_info = [], None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while True:
        img_idx = k % len(images)
        traced = trace and k == 0
        if traced:
            spans.clear()  # the program's spans of this slice only
            prof = trace_mod.profiler()
            prof.__enter__()
            tracer.on = True
            ts = time.perf_counter()
        n = int(traffic["trace_frames"]) if traced and session_len is None else session_len
        due = len(reference.expected_session(n, thresh)["slot_N"]) - 1 if n else 0
        t_sess = time.perf_counter()
        sess = run_session(system, images[img_idx], n, deadline, probe, due,
                           np.random.default_rng([seed % 2 ** 63, 7, k]))
        sess["image"] = img_idx
        sess["seconds"] = time.perf_counter() - t_sess
        sessions.append(sess)
        if traced:
            tracer.on = False
            slice_info = {"seconds": time.perf_counter() - ts, "frames": len(sess["frames"]),
                          "kf_tasks": sum(1 for _, _, kf in sess["frames"][1:] if kf)}
            prof.__exit__(None, None, None)
        k += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    probe.uninstall()
    del probe  # it holds the model's head modules
    if tracer is not None:
        tracer.uninstall()

    frames_done = sum(len(s["frames"]) for s in sessions)
    for k, s in enumerate(sessions):  # the first after the warm-up against the later ones
        print(f"slambench: session {k}: {len(s['frames'])} frames in {s['seconds']:.3f} s", file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    dev = card(device)
    dev["memory_peak_bytes"] = peak
    metrics = {
        "fps": frames_done / window_s,
        "peak_gb": peak / 1e9,
        "setup_s": setup_s,
    }

    summary = None
    if trace:
        t_sum = time.perf_counter()
        summary = trace_mod.summarize(prof, tracer, slice_info["seconds"], spans.records(), arch.MODEL_SPANS)
        print(f"slambench: the trace of {slice_info['frames']} frames read in "
              f"{time.perf_counter() - t_sum:.1f} s; spans and trace: {json.dumps(summary['linking'])}",
              file=sys.stderr)
        # the readers look the work counts up in the cell's architecture
        summary.update(slice_frames=slice_info["frames"], slice_kf_tasks=slice_info["kf_tasks"],
                       arch=c["arch"], arch_root=str(c["root"]),
                       model_shape={"widths": system.widths, "img_hw": system.img_hw,
                                    "dtype": c["config"]["tpu"]["dtype"]})
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        del prof

    # the program's state freed before the reference runs
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    m = c["config"]["model"]
    ref_sd = arch.make_weights(m, seed, device, dtype=getattr(torch, c["config"]["tpu"]["dtype"]),
                               head_dtype=getattr(torch, c["config"]["tpu"]["head_dtype"]))
    ref, ref_bf16 = arch.make_reference(ref_sd, m), arch.make_reference(ref_sd, m, precision="bf16")
    del ref_sd
    refs = {}
    for s in sessions:
        if s["image"] not in refs:
            net = arch.net_input(images[s["image"]], int(c["config"]["camera"]["long_side"]))
            refs[s["image"]] = (*arch.ref_views(ref, net, device), arch.ref_views(ref_bf16, net, device)[0])
    checks = reference.compare(sessions, refs, thresh)
    checks["head_rel_err"] = arch.head_err(ref, [h for s in sessions for h in s["heads"]], device)
    return {"metrics": metrics, "device": dev, "checks": checks, "summary": summary,
            "attempted": sum(s["n_submitted"] for s in sessions),
            "failed": sum(s["n_submitted"] - sum(1 for ok, _, _ in s["frames"] if ok) for s in sessions)}


def judge(checks: Dict, limits: Dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number at or under its limit passes."""
    out = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the port builds its kernels into build/kernels; a Triton or
    # torch-extension build that a later version adds caches there too
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    c = load_cell(args.workload)
    import torch

    need = int(c["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"slambench: the cell needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    r = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        print(f"slambench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3

    correct, shown = judge(r["checks"], c["limits"])
    units = {m["name"]: m["unit"] for m in c["end_to_end"] + c["per_layer"]}
    if args.trace:
        metrics = {}
        for m in c["per_layer"]:
            v = load_metric(m["name"]).read(r["summary"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": r["metrics"][m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"] if r["metrics"].get(m["name"]) is not None}
    line = {"correct": bool(correct), "attempted": r["attempted"], "failed": r["failed"],
            "metrics": metrics, "device": r["device"]}
    if args.trace:
        s = r["summary"]
        line["breakdown"] = {"device_ops": [[n, t] for n, t in s["device_ops"]],
                             "idle_gaps": [[n, t] for n, t in s["idle_gaps"]]}
    line["checks"] = shown
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
