"""Frames per second through the committed dataset runner, on the card.

    python -m frodo_slam_tpu_torch.tools.cli_fps [--frames 128]
        [--config configs/bench_cli.yaml] [--keep] [--device cuda]

The port's counterpart of the JAX package's ``scripts/cli_fps.py``. It
writes one synthetic frame (the bench's smooth wave field, the JAX script's
numpy draws) ``--frames`` times into an image folder, and runs
``python -m frodo_slam_tpu_torch.main --dataset <folder> --config
configs/bench_cli.yaml --no-retrieval --max-frames N`` on it with random
weights whose decoders and heads are shared (``FRODO_RANDOM_SHARE_DECODER``).
``bench_cli.yaml`` is the bench's numerics: f32 heads, ``tpu.x64_eval:
false`` (the f32 window solve with one refinement step), the threaded
backend and the pipelined frontend, the tracking gates off. It prints one
JSON line: the JAX script's keys (the mean of the runner's ``FPS:`` prints
after the first window, which carries the warm-up), the numerics the
runner resolved, and the card's name and power limit. A runner that fails,
or prints no ``FPS:`` line, makes the tool exit non-zero.

Regime note (the JAX script's): random weights give no geometric
consistency between different images, so the real system would treat every
such frame as tracking loss. The one random-weights regime the unmodified
system tracks is IDENTICAL frames, whose unique-match fraction (~1.0) never
starts a keyframe: the number is the track-only regime, and no backend
solve runs in it.

``--device cpu`` runs the runner on the CPU (``FRODO_DEVICE=cpu``); with
``FRODO_ENTRY_TINY=1`` in the environment the random model is the tiny
configuration. The folder is written under the temporary directory
(``cli_fps_*``) and removed unless ``--keep``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import PIL.Image

REPO = pathlib.Path(__file__).resolve().parents[2]


def make_frames(out_dir: pathlib.Path, n: int, h: int = 288, w: int = 512) -> None:
    """The bench's smooth wave field as uint8 PNGs, one IDENTICAL frame
    repeated (see the regime note)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.zeros((h, w, 3), np.float32)
    for _ in range(8):
        fy, fx = rng.uniform(0.2, 3.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        base += np.sin(fy * yy[..., None] / h * 2 * np.pi + fx * xx[..., None] / w * 2 * np.pi + ph) \
            * rng.uniform(0.1, 0.4)
    base += rng.normal(size=base.shape).astype(np.float32) * 0.05
    img = ((np.clip(base, -1, 1) * 0.5 + 0.5) * 255).astype(np.uint8)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        PIL.Image.fromarray(img).save(out_dir / f"{i:05d}.png")


def card() -> str:
    """``name, power limit`` of the first card as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"


def parse(stdout: str, stderr: str) -> dict:
    """The runner's ``FPS:`` windows and the numerics it logged."""
    fps = [float(m) for m in re.findall(r"FPS: ([0-9.]+)", stdout)]
    x64 = re.findall(r"tpu\.x64_eval=(True|False)", stderr)
    return {"windows": fps, "x64_eval": (x64[-1] == "True") if x64 else None}


def runner_cmd(seq: pathlib.Path, config: str, frames: int) -> list:
    """The committed runner's command line over the folder ``seq``."""
    return [sys.executable, "-m", "frodo_slam_tpu_torch.main", "--dataset", str(seq), "--config", config,
            "--no-retrieval", "--max-frames", str(frames)]


def measure(frames: int = 128, config: str = str(REPO / "configs/bench_cli.yaml"), device: str = "cuda",
            keep: bool = False, timeout: float = 3000):
    """Write the folder, run the runner on it, and parse its prints.
    Returns (the JSON line's dict, the runner's CompletedProcess)."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="cli_fps_"))
    seq = root / "seq"
    make_frames(seq, frames)
    env = dict(os.environ, FRODO_RANDOM_SHARE_DECODER="1", FRODO_DEVICE=device)
    try:
        proc = subprocess.run(runner_cmd(seq, config, frames), cwd=str(REPO), env=env,
                              capture_output=True, text=True, timeout=timeout)
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    got = parse(proc.stdout, proc.stderr)
    fps = got["windows"]
    steady = fps[1:] if len(fps) > 1 else fps  # the first window carries the warm-up
    line = {
        "metric": "cli_track_fps_vitL_288x512",
        "value": float(np.mean(steady)) if steady else None,
        "unit": "frames/s",
        "windows": fps,
        "frames": frames,
        "config": str(config),
        "rc": proc.returncode,
        "x64_eval": got["x64_eval"],
        "device": device,
        "card": card() if device == "cuda" else "cpu",
    }
    return line, proc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FPS through the port's dataset runner")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--config", default=str(REPO / "configs/bench_cli.yaml"))
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    line, proc = measure(args.frames, args.config, args.device, args.keep)
    sys.stderr.write(proc.stderr[-2000:])
    print(json.dumps(line), flush=True)
    return 0 if line["rc"] == 0 and line["value"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
