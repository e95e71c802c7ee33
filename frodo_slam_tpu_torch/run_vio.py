"""Robot / recorded-session VIO runner (the reference's ``run_vio.py``).

    python -m frodo_slam_tpu_torch.run_vio --dataset <session.pkl> [--use_odometry]
        [--config configs/base_no_fnn.yaml] [--calib <yaml>] [--every_n_frames 4]
        [--wall-clock] [--no-retrieval] [--weights <ckpt>] [--visualize]

The port's copy of the JAX package's ``run_vio.py`` (CLI contract of the
reference, run_vio.py:245-277): ``--dataset`` replays a recorded session
(:class:`~.slam.odometry.OdometryData`: a pickle of ``{"timestamp",
"frame" (BGR uint8), "pose" (SE3 7-vector)}`` rows) through ``SLAM`` in the
robot VIO mode, with the odometry poses when ``--use_odometry``; ``--robot``
polls the live robot. It runs on the card unless ``run_dataset(args,
device="cpu")``. ``--visualize`` serves the live map viewer
(:class:`~.viz.web.WebViewer`) from the first frame on; the replay honours
its pause and step controls once per frame, and the viewer stops with the
run.

``tpu.placement`` places the backend on the other cards when there are
several (:func:`~.parallel.mesh.default_placement`); ``--use_multiple_gpu``
sets it to ``overlap`` (the reference's backend on a second GPU,
run_vio.py:111-114). On one card, or with ``device="cpu"``, there is no
placement.

``tpu.x64_eval`` picks the window solve's numerics
(:func:`~.config.apply_x64_knob`), with the JAX runner's defaults: the
replay runs the f64 solve, the live robot the f32 solve with one refinement
step (real-time numerics); an explicit value in the config wins.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .utils.log import get_logger

log = get_logger("run_vio")


def _load_calib_K(args, cfg):
    """The network-crop K from a ``--calib`` yaml, and ``use_calib`` on
    (reference run_vio.py:94-110: the raw frames stay un-remapped; only
    ``K_frame`` is handed to the VIO)."""
    calib_path = getattr(args, "calib", None)
    if not calib_path:
        return None
    import yaml

    from .data.datasets import Intrinsics

    with open(calib_path) as f:
        intr = yaml.safe_load(f)
    ci = Intrinsics.from_calib(512, int(intr["width"]), int(intr["height"]), list(intr["calibration"]),
                               use_calib=True)
    cfg["use_calib"] = True
    return ci.K_frame


def _setup(args, device, x64_default: bool):
    """Config, calibration, model and placement, as both entry points load
    them; ``tpu.x64_eval`` resolved with the entry point's default."""
    from . import loader
    from .config import apply_x64_knob, make_config
    from .models import mast3r
    from .parallel import mesh

    cfg = make_config(args.config)
    if getattr(args, "use_multiple_gpu", False):
        cfg["tpu"]["placement"] = "overlap"  # the reference's --use_multiple_gpu
    apply_x64_knob(cfg, entry_default=x64_default)
    K_frame = _load_calib_K(args, cfg)
    model_cfg = loader.apply_model_knobs(mast3r.MASt3RConfig(), cfg)
    model, model_cfg = loader.load_mast3r(args.weights, cfg=model_cfg, device=device)
    retrieval = None if args.no_retrieval else loader.load_retriever(model_cfg, device=device)
    placement = mesh.default_placement(str(cfg["tpu"].get("placement", "overlap")),
                                       mesh.visible_devices(device))
    return cfg, K_frame, model, retrieval, placement


def _make_slam(cfg, K_frame, model, retrieval, placement, img, single_thread, local_opt_mode, device):
    """The SLAM at the frame's network shape (the long side resized to 512)."""
    from .data import image as image_mod
    from .slam.system import SLAM

    shaped = image_mod.resize_img(img, 512)
    h, w = int(shaped["true_shape"][0][0]), int(shaped["true_shape"][0][1])
    return SLAM(cfg, model, (h, w), calib=K_frame, retrieval_db=retrieval, use_backend=True,
                use_reloc=retrieval is not None, single_thread=single_thread,
                local_opt_mode=local_opt_mode, device=device, placement=placement)


def _start_viewer(slam, args):
    """The live viewer over ``slam`` when ``--visualize``, else None; on
    ``args.viz_port`` where the caller sets one (the CLI binds 8090, as the
    JAX runner does)."""
    if not getattr(args, "visualize", False):
        return None
    from .viz.web import WebViewer

    viewer = WebViewer(slam, port=int(getattr(args, "viz_port", 8090))).start()
    print(f"live viewer: http://127.0.0.1:{viewer.port}/")
    return viewer


def _grab(slam, cfg, img, ts, odom_pose):
    if bool(cfg["tpu"].get("pipelined_frontend", False)):
        return slam.grab_rgb_pipelined(img, timestamp=ts, odom_pose=odom_pose)
    return slam.grab_rgb(img, timestamp=ts, odom_pose=odom_pose)


def run_dataset(args, device=None):
    """Replay a recorded session (run_vio.py:172-242). Returns the
    terminated ``SLAM`` (None for an empty session)."""
    from .slam.odometry import OdometryData

    # the replay defaults to the f64 solve (JAX run_vio.py:54)
    cfg, K_frame, model, retrieval, placement = _setup(args, device, x64_default=True)
    data = OdometryData(args.dataset, wall_clock=args.wall_clock, use_odometry=args.use_odometry)
    slam = viewer = None
    i = 0
    fps_t0, fps_count = time.time(), 0
    try:
        while True:
            ts, frame_img, odom_pose = data.get_frame_and_pose()
            if frame_img is None:
                break
            i += 1
            if i % args.every_n_frames != 0:
                continue
            img = np.asarray(frame_img[:, :, ::-1], np.float32) / 255.0  # BGR -> RGB
            if slam is None:
                slam = _make_slam(cfg, K_frame, model, retrieval, placement, img,
                                  bool(cfg["single_thread"]), args.use_odometry, device)
                viewer = _start_viewer(slam, args)
            if viewer is not None:
                viewer.wait_if_paused()  # the browser's pause/step control
            _grab(slam, cfg, img, ts, odom_pose)
            fps_count += 1
            if fps_count == 30:
                print(f"FPS: {fps_count / (time.time() - fps_t0):.2f}")
                fps_t0, fps_count = time.time(), 0
        if slam is not None:
            slam.terminate()
    finally:
        if viewer is not None:
            viewer.stop()
    return slam


def run_robot(args, device=None):  # pragma: no cover - hardware
    """Live robot mode (run_vio.py:67-170): poll odometry + camera; the
    backend threaded, the VIO mode on."""
    from .slam.odometry import StraightOrSpinOdometry

    # the live robot runs the real-time numerics unless the config says
    # otherwise (JAX run_vio.py:123)
    cfg, K_frame, model, retrieval, placement = _setup(args, device, x64_default=False)
    odo = StraightOrSpinOdometry(robot_type=args.robot_type)
    odo.start()
    slam = viewer = None
    try:
        while True:
            ts, frame_img, odom_pose = odo.get_frame_and_pose()
            if frame_img is None:
                time.sleep(0.01)
                continue
            img = np.asarray(frame_img[:, :, ::-1], np.float32) / 255.0
            if slam is None:
                slam = _make_slam(cfg, K_frame, model, retrieval, placement, img, False, True, device)
                viewer = _start_viewer(slam, args)
            _grab(slam, cfg, img, ts, odom_pose if args.use_odometry else None)
    finally:
        odo.stop()
        if viewer is not None:
            viewer.stop()
        if slam is not None:
            slam.terminate()


def build_parser():
    p = argparse.ArgumentParser(description="frodo-slam-tpu VIO runner (PyTorch/CUDA port)")
    p.add_argument("--robot", action="store_true")
    p.add_argument("--robot-type", default="mini")
    p.add_argument("--dataset", default=None, help="recorded odometry .pkl")
    p.add_argument("--config", default="configs/base_no_fnn.yaml")
    p.add_argument("--calib", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--visualize", action="store_true", help="serve the live map viewer during the run")
    p.add_argument("--use_odometry", action="store_true")
    p.add_argument("--wall-clock", action="store_true")
    p.add_argument("--every_n_frames", type=int, default=4)  # run_vio.py:218
    p.add_argument("--no-retrieval", action="store_true")
    p.add_argument("--use_multiple_gpu", action="store_true",
                   help="tpu.placement=overlap: the tracker keeps the first card, the backend "
                        "runs on the others (no effect on one card)")
    return p


if __name__ == "__main__":
    from .utils.log import configure

    configure("logs/vio.log")  # run_vio.py:272 file-sink contract
    args = build_parser().parse_args()
    if args.robot:
        run_robot(args)
    else:
        if not args.dataset:
            raise SystemExit("--dataset or --robot required")
        run_dataset(args)
