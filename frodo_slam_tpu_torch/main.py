"""Headless dataset SLAM runner (the reference's ``main.py`` CLI contract).

    python -m frodo_slam_tpu_torch.main --dataset <path> --config <yaml>
        [--calib <yaml>] [--save-as <name>] [--no-retrieval] [--weights <ckpt>]

The port's copy of the JAX package's ``main.py:22-189``: the upstream loop
(mono init -> track -> backend on new keyframes -> reloc or new map on loss) over a
TUM, EuRoC, ETH3D, 7-Scenes or image-folder sequence, on the card unless
``run(args, device="cpu")``. Outputs as the eval scripts expect them:
``logs/<save-as>/<seq>.txt`` (TUM trajectory), ``<seq>.ply``, keyframe PNGs
and ``<seq>.meta.json``.

Retrieval and relocalization are on unless ``--no-retrieval``
(:func:`~frodo_slam_tpu_torch.loader.load_retriever`; without trained
retrieval assets a random head and codebook, recorded as
``"retrieval": "random-fallback"`` in the meta file, with a warning).

Differences from the JAX runner: ``tpu.x64_eval`` is accepted and has no
effect (the port's window solve is always f64); ``tpu.placement`` is
ignored on one card (ROADMAP.md §1 "Multi-GPU placement"). ``--viz`` raises
``NotImplementedError`` naming its ROADMAP.md §1 item.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from .utils.log import get_logger

log = get_logger("main")


def run(args, device=None) -> dict:
    import yaml

    from . import loader
    from .config import make_config
    from .data import datasets
    from .data.prefetch import PrefetchLoader
    from .models import mast3r
    from .slam.system import SLAM
    from .utils import evaluate

    if getattr(args, "viz", False):
        raise NotImplementedError(
            'the live viewer (--viz) is ROADMAP.md §1 "The rest of the entry points and IO"')

    cfg = make_config(args.config)
    log.info('tpu.placement %r ignored: the port runs on one card (ROADMAP.md §1 "Multi-GPU placement")',
             cfg["tpu"].get("placement"))
    calib_yaml = None
    if args.calib:
        with open(args.calib) as f:
            calib_yaml = yaml.safe_load(f)
        cfg["use_calib"] = True

    center = bool(cfg["dataset"]["center_principle_point"])
    dataset = datasets.load_dataset(args.dataset, use_calib=bool(cfg["use_calib"]),
                                    center_principal_point=center,
                                    subsample=int(cfg["dataset"]["subsample"]))
    if calib_yaml is not None:
        # the --calib yaml overrides the dataset's intrinsics (reference
        # main.py:175-184: width/height/calibration keys)
        dataset.use_calibration = True
        dataset.camera_intrinsics = datasets.Intrinsics.from_calib(
            dataset.img_size, int(calib_yaml["width"]), int(calib_yaml["height"]),
            list(calib_yaml["calibration"]), use_calib=True, center_principal_point=center)
    (h, w), _ = dataset.get_img_shape()

    # compute knobs first, so the one-time weight cast uses the final types
    model_cfg = loader.apply_model_knobs(mast3r.MASt3RConfig(), cfg)
    model, model_cfg = loader.load_mast3r(args.weights, cfg=model_cfg, device=device)
    retrieval = None if args.no_retrieval else loader.load_retriever(model_cfg, device=device)
    calib = dataset.camera_intrinsics.K_frame if (cfg["use_calib"] and dataset.has_calib()) else None

    slam = SLAM(cfg, model, (h, w), calib=calib, retrieval_db=retrieval, use_backend=True,
                use_reloc=retrieval is not None, single_thread=bool(cfg["single_thread"]), device=device,
                # the reference saves keyframe PNGs with every --save-as run (main.py:332)
                keep_keyframe_images=bool(args.save_as))

    frames = PrefetchLoader(dataset, slam.preprocess, slam.device, depth=3, max_frames=args.max_frames)
    fps_t0, fps_count = time.time(), 0

    def tick():
        nonlocal fps_t0, fps_count
        fps_count += 1
        if fps_count == 30:
            print(f"FPS: {fps_count / (time.time() - fps_t0):.2f}")
            fps_t0, fps_count = time.time(), 0

    if bool(cfg["tpu"].get("pipelined_frontend", False)):
        # one-frame-pipelined frontend: each frame's flags fetch overlaps the
        # next frame's device work (grab_rgb_pipelined)
        for timestamp, dev_img in frames:
            slam.grab_rgb_pipelined(dev_img, timestamp=float(timestamp))
            tick()
        slam.flush()
    else:
        # one-frame lookahead: grab_rgb enqueues the NEXT frame's encode
        # before its blocking flags fetch
        pending = None
        for timestamp, dev_img in frames:
            if pending is not None:
                slam.grab_rgb(pending[1], timestamp=float(pending[0]), next_img=dev_img)
                tick()
            pending = (timestamp, dev_img)
        if pending is not None:
            slam.grab_rgb(pending[1], timestamp=float(pending[0]))
    slam.terminate()

    retrieval_mode = ("none" if retrieval is None
                      else "random-fallback" if retrieval.degraded else "real")
    if retrieval_mode == "random-fallback":
        print("WARNING: retrieval is running on RANDOM fallback assets — "
              "loop closures are meaningless; pass --no-retrieval or provide "
              "the trained retrieval checkpoint+codebook")

    out = {"retrieval": retrieval_mode}
    if args.save_as and dataset.save_results:
        seq = pathlib.Path(args.dataset).name or "seq"
        logdir = pathlib.Path("logs") / args.save_as
        logdir.mkdir(parents=True, exist_ok=True)
        n_live = int(slam.store.n_size)
        meta = {"sequence": seq, "config": str(args.config), "use_calib": bool(cfg["use_calib"]),
                "retrieval": retrieval_mode, "frames": slam.frame_count, "keyframes": n_live}
        with open(logdir / f"{seq}.meta.json", "w") as f:
            json.dump(meta, f, indent=1)
        stamps, poses = slam.keyframe_poses()
        out["traj"] = str(evaluate.save_traj(logdir, f"{seq}.txt", stamps, poses))
        store = slam.store
        rows = torch.as_tensor([k % store.capacity for k in range(store.n_total - n_live, store.n_total)],
                               device=store.X_canon.device)
        X = store.X_canon[rows].cpu().numpy()
        C = store.C[rows].cpu().numpy() / np.maximum(store.N[rows].cpu().numpy(), 1)[:, None, None]
        evaluate.save_reconstruction(logdir, f"{seq}.ply", poses, X, np.zeros_like(X), C)
        out["ply"] = str(logdir / f"{seq}.ply")
        # keyframe PNG dump (reference main.py:332, evaluate.py:73-85)
        evaluate.save_keyframes(logdir / "keyframes" / seq, stamps, slam.kf_images[-len(stamps):])
        out["keyframes"] = str(logdir / "keyframes" / seq)
    return out


def build_parser():
    p = argparse.ArgumentParser(description="frodo-slam-tpu dataset runner (PyTorch/CUDA port)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--config", default="configs/base.yaml")
    p.add_argument("--calib", default=None)
    p.add_argument("--save-as", dest="save_as", default=None)
    p.add_argument("--no-viz", action="store_true", default=True)
    p.add_argument("--viz", action="store_true",
                   help='the live viewer (ROADMAP.md §1 "The rest of the entry points and IO")')
    p.add_argument("--viz-port", type=int, default=8090)
    p.add_argument("--weights", default=None)
    p.add_argument("--no-retrieval", action="store_true")
    p.add_argument("--max-frames", type=int, default=None)
    return p


if __name__ == "__main__":
    from .utils.log import configure

    configure("logs/slam.log")
    run(build_parser().parse_args())
