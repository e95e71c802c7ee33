"""The SLAM system: one host process driving the model, matcher, tracker and
keyframe backend on the card.

Behavioral spec: ``mast3r_slam/vio.py`` — ``VIO.__init__`` (:163-256),
``grab_rgb`` (:287-346), tracking-loss map reset (:321-328, :258-277), the
``run_backend`` worker (:75-161) — with the upstream main-loop semantics
(mono init -> track -> queue backend -> reset on repeated loss) and the JAX
package's ``SLAM`` as the reference of this port.

The backend runs on keyframe creation: synchronously (``single_thread``,
the reference's eval mode) or on one worker thread that drains an unbounded
task queue while the frontend keeps tracking. Both threads enqueue on the
same (default) CUDA stream, so device work is ordered by host submission. A
threaded task reads a copy of the keyframe store taken under the lock (the
store is written in place; the JAX package's immutable arrays give it that
snapshot for free) and merges its solved poses back under the lock.

With a calibration (``use_calib`` and ``calib``) the tracker and the window
solve take the calibrated pixel + log-depth residuals. With a retrieval
database every keyframe is inserted (the map's first one too, and every
keyframe carries its index explicitly, ``RetrievalDatabase.kf_ids``), each
backend task turns the keyframes retrieved for its keyframe into loop-closure
edges, and a lost frame relocalizes against the retrieved keyframes
(vio.py:29-72) before the loss counter resets the map.

The robot VIO mode (``local_opt_mode``, the reference's ``VIO`` class): each
new keyframe with an odometry pose feeds the scale-only pose graph
(:mod:`.pgo`), whose gauge is written into the live keyframes' Sim(3) scale
channel on the device, and the window solve weights its rays with
``local_opt.sigma_ray_odom_mode``. With ``height_prior.enabled`` every
window solve gets per-keyframe scale targets from a ground-plane fit
(:mod:`.height_prior`), cached per keyframe. Each frame costs one fetch of
the 20-float flags vector plus the tracker's own small fetches; each backend
solve one small fetch per GN iteration (see global_opt.py), and each plane
fit one fetch of its region's rows.

``tpu.x64_eval`` (resolved by the entry point, True where absent) picks
the window solve's numerics, ``BAConfig.solve_f64``: f64, or f32 with one
refinement step (the real-time configurations).

With a :class:`~..parallel.mesh.Placement` (config ``tpu.placement``, see
:func:`~..parallel.mesh.default_placement`) the tracker, the keyframe store,
the PGO, the height prior and the retrieval database stay on ``device``
(the placement's tracker device) and the backend runs on the placement's
grid: its own replicas of the decoder and heads, its edges and solves on the
solve device. A threaded task copies the store straight onto the solve
device; every backend result is moved back to ``device`` where it meets the
frontend's state.
"""

from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.image import resize_img
from ..models import mast3r
from ..ops import lie
from ..utils import spans
from ..utils.device import indexed, resolve_device, set_f32_contract
from ..utils.log import get_logger
from . import frame as frame_mod
from .backend import BackendGraph
from .frame import Mode
from .global_opt import BAConfig
from .height_prior import RectanglePlaneEstimator, corners_from_mask_file
from .inference import decode_mono
from .pgo import apply_pgo_scale_, make_pose_graph, pgo_add_frame, pgo_optimize
from .tracker import TrackingCfg, track_step

log = get_logger("slam")

LOCK_WAIT = "frame.lock_wait_ns"  # the frontend's waits for _backend_lock
TASK_LOCK_WAIT = "backend.lock_wait_ns"  # a backend task's


def preprocess_image(img: np.ndarray, img_hw: Tuple[int, int], portrait: bool) -> np.ndarray:
    """One frame (H, W, 3) in [0, 1] -> the (1, h, w, 3) ImgNorm'd network
    input in the landscape storage shape ``img_hw``: resized to its long
    side unless it already has the network shape, and transposed when the
    true shape is portrait (``SLAM.preprocess``)."""
    h, w = img_hw
    true_shape = (w, h) if portrait else (h, w)
    normalized = False
    if img.shape[:2] != true_shape and img.shape[:2] != (h, w):
        img = resize_img(img, max(img_hw))["img"][0]  # ImgNorm'd
        normalized = True
    if portrait and img.shape[:2] == true_shape:
        img = np.swapaxes(img, 0, 1)
    if not normalized:
        img = (img.astype(np.float32) - 0.5) / 0.5 if img.max() <= 1.0 else img
    return img[None] if img.ndim == 3 else img


class SLAM:
    """Single-process SLAM system (``VIO`` class API of the reference).

    ``model`` is a :class:`~frodo_slam_tpu_torch.models.mast3r.MASt3R` on
    ``device``; ``device=None`` means the card and raises when there is none.
    ``local_opt_mode``: the robot VIO mode (scale-only PGO on odometry).
    ``placement``: the backend on its own devices (None: on ``device``).
    """

    def __init__(
        self,
        cfg: Config,
        model: mast3r.MASt3R,
        img_hw: Tuple[int, int],
        calib: Optional[np.ndarray] = None,
        retrieval_db=None,
        use_backend: bool = True,
        use_reloc: bool = True,
        single_thread: bool = True,
        local_opt_mode: bool = False,
        device=None,
        keep_keyframe_images: bool = False,
        placement=None,
    ):
        self.device = resolve_device(device)
        set_f32_contract()
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model lives on {model_dev}, SLAM runs on {self.device}")
        if placement is not None and placement.tracker != indexed(self.device):
            raise ValueError(f"the placement's tracker is {placement.tracker}, SLAM runs on {self.device}")
        self.placement = placement

        self.cfg = cfg
        # portrait input (true height > width): store every image/map
        # transposed into landscape layout and flag the model so its patch
        # embed / heads transpose in and out (ManyAR_PatchEmbed +
        # transpose_to_landscape). A shallow copy shares the weights.
        self.portrait = img_hw[0] > img_hw[1]
        if self.portrait:
            img_hw = (img_hw[1], img_hw[0])
            model = copy.copy(model)
            model.cfg = dataclasses.replace(model.cfg, portrait=True)
        self.model = model
        self.model_cfg = model.cfg
        self.img_hw = img_hw
        self.hw = img_hw[0] * img_hw[1]
        self.use_backend = use_backend
        self.use_reloc = use_reloc
        self.single_thread = single_thread
        self.local_opt_mode = local_opt_mode
        self.retrieval = retrieval_db

        t = cfg.tracking
        self.tcfg = TrackingCfg(
            min_match_frac=float(t.min_match_frac),
            use_fnn=bool(t.get("use_fnn", False)),
            min_match_frac_fnn=float(t.get("min_match_frac_fnn", 0.0008)),
            max_iters=int(t.max_iters),
            C_conf=float(t.C_conf),
            Q_conf=float(t.Q_conf),
            rel_error=float(t.rel_error),
            delta_norm=float(t.delta_norm),
            huber_k=float(t.huber),
            match_frac_thresh=float(t.match_frac_thresh),
            sigma_ray=float(t.sigma_ray),
            sigma_dist=float(t.sigma_dist),
            sigma_pixel=float(t.sigma_pixel),
            sigma_depth=float(t.sigma_depth),
            pixel_border=float(t.pixel_border),
            depth_eps=float(t.depth_eps),
            filtering_mode=str(t.filtering_mode),
            filtering_score=str(t.get("filtering_score", "median")),
            use_calib=bool(cfg.use_calib) and calib is not None,
        )
        self.K = None if calib is None else torch.as_tensor(
            np.asarray(calib), dtype=torch.float32).to(self.device)
        self.match_cfg = tuple(sorted(dict(cfg.matching).items()))
        lo = cfg.local_opt
        self.ba_cfg = BAConfig(
            max_iters=int(lo.max_iters),
            # odometry mode weights rays looser (configs/base.yaml:92)
            sigma_ray=float(lo.get("sigma_ray_odom_mode", lo.sigma_ray)) if local_opt_mode
            else float(lo.sigma_ray),
            sigma_dist=float(lo.sigma_dist),
            C_conf=float(lo.C_conf),
            Q_conf=float(lo.Q_conf),
            delta_norm=float(lo.delta_norm),
            pin=int(lo.pin),
            sigma_odom_t=float(lo.get("sigma_odom_t", 1e-3)),
            sigma_odom_r=float(lo.get("sigma_odom_r", 1e-3)),
            sigma_scale_prior=float(lo.get("sigma_scale_prior", 0.1)),
            sigma_pixel=float(lo.sigma_pixel),
            sigma_depth=float(lo.sigma_depth),
            pixel_border=float(lo.pixel_border),
            depth_eps=float(lo.depth_eps),
            # tpu.x64_eval as the entry point resolved it; a SLAM built from a
            # config that leaves it out solves in f64
            solve_f64=bool(cfg["tpu"].get("x64_eval", True)),
        )

        self._n_tok = (img_hw[0] // self.model_cfg.patch_size) * (img_hw[1] // self.model_cfg.patch_size)
        self.store = self._new_store()
        # the edge store is ~1.9 GB at ViT-L width and production capacities:
        # only a system with the backend on allocates it
        self.backend = BackendGraph(
            self.model, self.ba_cfg, self.match_cfg, img_hw,
            max_edges=int(cfg.tpu.max_edges), max_odom=int(cfg.tpu.max_odom_edges),
            Q_conf=float(lo.Q_conf), min_match_frac=float(lo.min_match_frac), placement=placement,
        ) if use_backend else None

        self.pgo = make_pose_graph(int(cfg.tpu.max_keyframes), device=self.device)
        hp = cfg.height_prior
        self.height_prior_enabled = bool(hp.enabled)
        rect = hp.get("rect", None)
        corners = None
        if rect:
            (x0, y0), (x1, y1) = rect
            corners = ((int(x0), int(y0)), (int(x1), int(y1)))
        if corners is None and hp.get("mask_file", None):
            # the reference's interactively picked pickled region
            # (height_prior.py:36-43 + config/rect_mask.pkl)
            corners = corners_from_mask_file(str(hp.mask_file))
        self.plane_estimator = RectanglePlaneEstimator(
            corners=corners, max_tilt_deg=float(hp.tilt_max_deg),
            ransac_iterations=int(hp.ransac_iters), inlier_thresh=float(hp.get("dist_thresh", 0.04)))
        self.camera_height = float(hp.camera_height)
        # per-keyframe plane-fit cache (logical keyframe index -> gauge
        # target) and the fit region's storage rows (a device index, built
        # at the first fit); each invalidation is numbered, so that a
        # threaded task never caches a fit of a pointmap that changed after
        # its copy of the store was taken
        self._hp_cache: dict = {}
        self._hp_gen = 0
        self._hp_gen_of: dict = {}  # keyframe -> number of its last invalidation
        self._hp_region_idx = None

        self.mode = Mode.INIT
        self.frame_count = 0
        self.loss_track_counter = 0
        self.kf_timestamps: List[float] = []
        # host uint8 keyframe images, for the keyframe PNG dump (main.py)
        self.keep_keyframe_images = bool(keep_keyframe_images)
        self.kf_images: List[np.ndarray] = []
        self.atlas: List[dict] = []  # finished maps (main.py:187-239)
        self.active_kf: Optional[frame_mod.Frame] = None  # streaming KF state
        self.current_T_WC = lie.sim3_identity().numpy()
        self.last_odom_pose: Optional[np.ndarray] = None
        self._idx_f2k = None
        self.last_track = None
        self._encode_cache = None  # (img_obj, dev_img, feat, pos) lookahead
        # one-frame pipelined frontend state (grab_rgb_pipelined/flush)
        self._pending = None
        self._pending_result = None

        # Backend tasks QUEUE and the frontend never blocks on a solve (the
        # reference's unbounded task list, vio.py:109-115). One worker thread
        # drains the queue serially; tasks are never dropped, since each
        # carries its keyframe's consecutive edge and odometry factor.
        # ``backend_queue_max`` is a backlog warning threshold only.
        self._backend_lock = threading.Lock()  # guards store, active_kf, current pose
        # held by the worker around each task: relocalization waits out the
        # in-flight task under it, never the pending backlog (the reference
        # backend services RELOC before popping optimizer tasks, vio.py:102-107)
        self._backend_exec_lock = threading.Lock()
        # held by a relocalization from its start: the worker starts no new
        # task past it, so the relocalization runs right after the in-flight
        # task however the threads are scheduled (a lock hands over in no
        # fixed order: the worker could take the exec lock again first)
        self._reloc_gate = threading.Lock()
        self._backend_tasks: queue.Queue = queue.Queue()
        self._backend_queue_max = int(cfg.tpu.get("backend_queue_max", 8))
        self._backend_worker: Optional[threading.Thread] = None
        self._map_epoch = 0  # bumped on reset(); stale backend merges are dropped
        self._half_reuse = bool(cfg.tpu.get("consecutive_half_reuse", True))
        # write the active keyframe's fused pointmap back into the store every
        # frame (the reference's tracker.py:325-328) instead of at keyframe
        # rate, one frame of fusion behind (the default)
        self._kf_sync_per_frame = bool(cfg.tpu.get("kf_sync_per_frame", False))

    def _new_store(self) -> frame_mod.KeyframeStore:
        return frame_mod.make_keyframe_store(
            int(self.cfg.tpu.max_keyframes), self.hw, self._n_tok,
            self.model_cfg.enc_embed_dim, device=self.device)

    # -- lifecycle -----------------------------------------------------------

    def reset(self):
        """Full map reset on tracking loss (vio.py:258-277): new keyframe
        buffer, backend and retrieval cleared, mode back to INIT. The
        finished map is kept in ``self.atlas`` (main.py:227-239). Pending
        backend tasks reference the dead map: they are discarded, the
        in-flight one is waited out (its merge is dropped by the epoch
        guard)."""
        self._join_backend(discard_pending=True)
        self._map_epoch += 1
        if self.store.n_size > 0:
            stamps, poses = self.keyframe_poses()
            self.atlas.append({"timestamps": stamps, "T_WC": poses,
                               "images": self.kf_images[-len(stamps):]})
            log.warning("map reset: archiving %d keyframes to atlas #%d",
                        len(stamps), len(self.atlas))
        self.store = None  # free the old ring before allocating the new one
        self.store = self._new_store()
        if self.backend is not None:
            self.backend.reset()
        if self.retrieval is not None:
            self.retrieval.reset()
        self.pgo = make_pose_graph(self.pgo.capacity, device=self.device)
        self._hp_cache, self._hp_gen_of = {}, {}
        self.mode = Mode.INIT
        self.loss_track_counter = 0
        self.kf_timestamps = []
        self.kf_images = []
        self._pending = None
        self._pending_result = None
        self._idx_f2k = None
        self.last_odom_pose = None
        self.active_kf = None

    def terminate(self):
        if self._pending is not None or self._pending_result is not None:
            self.flush()
        self.mode = Mode.TERMINATED
        self._join_backend()
        if self._backend_worker is not None:
            if self._backend_worker.is_alive():
                self._backend_tasks.put(None)  # stop sentinel
            self._backend_worker.join()
            self._backend_worker = None

    def _join_backend(self, discard_pending: bool = False):
        """Wait until the backend is idle (queue drained, no task running),
        without a deadline: mutating state under a running task is a data
        race. ``discard_pending`` first drops queued, unstarted tasks."""
        q = self._backend_tasks
        if discard_pending:
            while True:
                try:
                    task = q.get_nowait()
                except queue.Empty:
                    break
                q.task_done()
                if task is not None:
                    log.warning("map reset: discarded pending backend task kf=%s", task[0])
        waited = 0.0
        with q.all_tasks_done:
            while q.unfinished_tasks:
                if not q.all_tasks_done.wait(timeout=60.0):
                    waited += 60.0
                    log.warning("backend task still running after %.0fs; waiting", waited)

    def _backend_worker_loop(self):
        """Drain the task queue serially (run_backend loop, vio.py:86-157).
        A failed task is logged and the loop goes on."""
        while True:
            task = self._backend_tasks.get()
            try:
                if task is None:
                    return
                with self._reloc_gate:
                    pass
                with self._backend_exec_lock:
                    self._backend_step(*task)
            except Exception:
                log.exception("backend task kf=%s failed", task[0])
            finally:
                self._backend_tasks.task_done()

    # -- frame path ----------------------------------------------------------

    def preprocess(self, img: np.ndarray) -> np.ndarray:
        """Host preprocessing: resize/normalize to the network input (and
        transpose portrait frames into the landscape storage layout)."""
        return preprocess_image(img, self.img_hw, self.portrait)

    def _make_frame(self, img, T_WC) -> frame_mod.Frame:
        if self._encode_cache is not None and self._encode_cache[0] is img:
            # encode was dispatched last frame (grab_rgb next_img lookahead)
            _, dev_img, feat, pos = self._encode_cache
            self._encode_cache = None
        else:
            dev_img, feat, pos = self._encode_frame(img)
        return frame_mod.make_empty_frame(self.frame_count, dev_img, feat, pos, T_WC=T_WC)

    def _encode_frame(self, img):
        """Preprocess + upload + ViT encode for one frame."""
        if isinstance(img, torch.Tensor) and img.dim() == 4:
            dev_img = img.to(self.device)  # pre-uploaded by a loader
        else:
            with spans.span("frame.preprocess"):
                host = np.ascontiguousarray(self.preprocess(np.asarray(img)), dtype=np.float32)
                dev_img = torch.from_numpy(host).to(self.device, non_blocking=True)
        feat, pos = mast3r.encode_image(self.model, dev_img)
        return dev_img, feat, pos

    def _capture_kf_image(self, frame: frame_mod.Frame):
        """Fetch and denormalize the new keyframe's image into the host list
        (the reference keeps ``uimg`` per keyframe, frame.py:17-44)."""
        if not self.keep_keyframe_images:
            return
        img = frame.img[0].cpu().numpy()  # ImgNorm'd (H, W, 3)
        if self.portrait:
            img = np.swapaxes(img, 0, 1)
        self.kf_images.append((np.clip(img * 0.5 + 0.5, 0.0, 1.0) * 255).astype(np.uint8))

    def init_tracking(self, frame: frame_mod.Frame, timestamp: float):
        """Mono-inference map init (tracker.py:137-155)."""
        X, C = decode_mono(self.model, frame.feat, frame.pos, self.img_hw)
        Xn, Cn, Nn, Un = frame_mod.update_pointmap(
            frame.X_canon, frame.C, frame.N, frame.N_updates, X, C,
            self.tcfg.filtering_mode, self.tcfg.filtering_score,
        )
        frame = dataclasses.replace(frame, X_canon=Xn, C=Cn, N=Nn, N_updates=Un)
        with spans.held(self._backend_lock, LOCK_WAIT):
            self.active_kf = frame
            self.store = frame_mod.kf_append(self.store, frame)
        self.kf_timestamps.append(timestamp)
        self._capture_kf_image(frame)
        if self.retrieval is not None:
            self.retrieval.update(frame.feat, add_after_query=True, k=int(self.cfg.retrieval.k),
                                  min_thresh=float(self.cfg.retrieval.min_thresh),
                                  kf_id=len(self.kf_timestamps) - 1)
        self.mode = Mode.TRACKING
        self.current_T_WC = frame.T_WC.cpu().numpy()

    def grab_rgb(self, img: np.ndarray, timestamp: Optional[float] = None,
                 odom_pose: Optional[np.ndarray] = None, next_img=None):
        """Process one RGB frame (vio.py:287-346).

        ``odom_pose``: optional (7+,) SE3 odometry reading [t, q]; between
        consecutive keyframes it becomes a backend odometry factor.
        ``next_img``: optional lookahead frame whose encode is enqueued after
        this frame's tracking work and before the flags fetch; pass the same
        object to the next call.

        Returns (success, T_WC (8,) Sim3, new_kf).
        """
        timestamp = time.time() if timestamp is None else timestamp
        pend = self._dispatch_track(img, timestamp, odom_pose, next_img)
        if pend is None:  # INIT path resolved synchronously
            return True, self.current_T_WC, True
        return self._finalize_track(pend)

    def grab_rgb_pipelined(self, img: np.ndarray, timestamp: Optional[float] = None,
                           odom_pose: Optional[np.ndarray] = None):
        """One-frame-deep pipelined frontend: returns the PREVIOUS frame's
        result (or None on the very first call) after enqueuing this frame's
        device work. All host bookkeeping of a frame happens before the next
        frame's work is enqueued, so keyframe selection is exactly the
        sequential semantics, one frame deferred. Call :meth:`flush` after
        the last frame."""
        timestamp = time.time() if timestamp is None else timestamp
        out = self.flush()
        pend = self._dispatch_track(img, timestamp, odom_pose, None)
        if pend is None:
            self._pending_result = (True, self.current_T_WC, True)
        else:
            self._pending = pend
        return out

    def flush(self):
        """Resolve the pending pipelined frame, if any (grab_rgb_pipelined)."""
        if self._pending_result is not None:
            out, self._pending_result = self._pending_result, None
            return out
        if self._pending is None:
            return None
        pend, self._pending = self._pending, None
        return self._finalize_track(pend)

    def _dispatch_track(self, img, timestamp, odom_pose, next_img):
        """Device half of a frame: encode + tracking work. Returns the pending
        tuple for :meth:`_finalize_track`, or None for an INIT frame."""
        with spans.span("frame.dispatch", frame=self.frame_count):
            T_WC = torch.as_tensor(self.current_T_WC, dtype=torch.float32).to(self.device)
            frame = self._make_frame(img, T_WC)

            if self.mode == Mode.INIT:
                if next_img is not None:
                    self._encode_cache = (next_img, *self._encode_frame(next_img))
                self.init_tracking(frame, timestamp)
                self.last_odom_pose = odom_pose
                self.frame_count += 1
                return None

            with spans.held(self._backend_lock, LOCK_WAIT):  # a backend merge may replace active_kf
                prev_kf = self.active_kf
                kf_next, fused, res = track_step(
                    self.model, self.tcfg, self.match_cfg, self.img_hw,
                    self.active_kf, frame, self._idx_f2k, self.K,
                )
                self.active_kf = kf_next
            self._idx_f2k = res.idx_f2k
            self.last_track = res
            if next_img is not None:
                self._encode_cache = (next_img, *self._encode_frame(next_img))
            return (frame, prev_kf, fused, res, timestamp, odom_pose)

    def _finalize_track(self, pend):
        """Host half: ONE flags fetch, then all bookkeeping (keyframe
        write-back/append, loss/reset, backend task)."""
        # the pending frame's id: frame_count counts a frame when it is finalized
        with spans.span("frame.finalize", frame=self.frame_count):
            frame, prev_kf, fused, res, timestamp, odom_pose = pend
            flags = res.flags.cpu().numpy()  # ONE fetch serves every flag below
            ok = bool(flags[1] > 0)
            new_kf = bool(flags[2] > 0)
            used_fnn = bool(flags[19] > 0)
            if ok and not new_kf and self._kf_sync_per_frame:
                with spans.held(self._backend_lock, LOCK_WAIT):
                    frame_mod.kf_write_pointmap(self.store, self.store.last_slot(), self.active_kf)
                    self._hp_invalidate(len(self.kf_timestamps) - 1)
            if new_kf:
                with spans.held(self._backend_lock, LOCK_WAIT):
                    # sync the outgoing keyframe's fused pointmap into its slot
                    # (the reference writes it back every frame,
                    # tracker.py:325-328; here at keyframe rate like the JAX
                    # package), then append the new keyframe, both in place.
                    # The outgoing keyframe's stored pointmap just changed: its
                    # cached plane fit is stale.
                    frame_mod.kf_write_pointmap(self.store, self.store.last_slot(), prev_kf)
                    self._hp_invalidate(len(self.kf_timestamps) - 1)
                    self.store = frame_mod.kf_append(self.store, fused)

            if not ok:
                self._idx_f2k = None
                self.loss_track_counter += 1
                log.info("tracking failed at t=%.3f (consecutive losses: %d, "
                         "match_frac=%.4f)", timestamp, self.loss_track_counter,
                         float(flags[0]))
                relocalized = False
                if (self.use_reloc and self.retrieval is not None and self.backend is not None
                        and len(self.kf_timestamps) > 1):
                    relocalized = self._relocalize(frame, timestamp)
                if relocalized:
                    log.info("relocalized at t=%.3f", timestamp)
                    self.loss_track_counter = 0
                    ok = True
                elif self.loss_track_counter >= int(self.cfg.tracking.new_map_after_loss_track_N):
                    self.reset()
                    self.init_tracking(frame, timestamp)
                    self.frame_count += 1
                    return False, self.current_T_WC, True
            else:
                self.loss_track_counter = 0
                self.current_T_WC = flags[3:11].copy()
                if new_kf:
                    self.kf_timestamps.append(timestamp)
                    self._capture_kf_image(fused)
                    self._idx_f2k = None
                    odom_factor = None
                    if (odom_pose is not None and self.last_odom_pose is not None
                            and len(self.kf_timestamps) > 1):
                        delta = lie.se3_mul(
                            lie.se3_inv(torch.as_tensor(np.asarray(self.last_odom_pose)[:7],
                                                        dtype=torch.float32)),
                            torch.as_tensor(np.asarray(odom_pose)[:7], dtype=torch.float32))
                        n = len(self.kf_timestamps)
                        odom_factor = (n - 2, n - 1, delta.numpy())
                        self.last_odom_pose = odom_pose
                    if self.local_opt_mode and odom_pose is not None:
                        self._pgo_step(odom_pose)
                    if self.use_backend:
                        # consecutive-edge half reuse: hand the backend the
                        # tracker's direction of this pair's decode + match, not
                        # when the fnn fallback fired (the raw projective match
                        # was too sparse: the backend cold-matches both)
                        half = res.pair_half if self._half_reuse and not used_fnn else None
                        self._run_backend(len(self.kf_timestamps) - 1, odom_factor, half)
            if odom_pose is not None and self.last_odom_pose is None:
                self.last_odom_pose = odom_pose

            self.frame_count += 1
            return ok, self.current_T_WC, new_kf

    def _pgo_step(self, odom_pose):
        """Add the new keyframe's tracked pose and odometry pose to the
        scale-only pose graph, solve it, and write the map gauge ``1 / s``
        into the live keyframes' scale channel (the reference applies its
        PGO result through get_kf_poses + update_T_WCs, tracker.py:347-353,
        pgo.py:195-202): the exported SE(3) trajectory stays at VO gauge,
        the pose scales carry the gauge, so the metric trajectory is t / s.
        Conditional on the device, no host fetch; a no-op until the graph
        has more than 10 frames. The store is written in place, so the
        write-back holds the lock a threaded backend merge takes."""
        pgo_add_frame(self.pgo, torch.as_tensor(self.current_T_WC),
                      torch.as_tensor(np.asarray(odom_pose)[:7]))
        _, s, pgo_ok = pgo_optimize(self.pgo)
        with spans.held(self._backend_lock, LOCK_WAIT):
            apply_pgo_scale_(self.store.T_WC, self.store.n_size, s, pgo_ok)

    # -- backend ---------------------------------------------------------------

    @torch.no_grad()
    def _backend_step(self, idx: int, odom_factor, pair_half=None, cause=None, queued_ns=None):
        """One backend task (run_backend loop body, vio.py:109-157).

        Threaded, the task reads a copy of the store taken under the lock and
        merges the solved window poses back under the lock at the end, so the
        frontend keeps tracking through the decode, match and solve. In
        single_thread mode the same code runs on the frontend thread on the
        live store (the serialized eval contract).

        ``cause``: the frame whose tracking made keyframe ``idx``;
        ``queued_ns``: when the task was queued (:func:`..utils.spans.stamp`)."""
        with spans.span("backend.task", frame=cause, kf=idx, cause=cause, queued_ns=queued_ns):
            with spans.held(self._backend_lock, TASK_LOCK_WAIT):
                if self.single_thread:
                    store = self.store
                else:
                    with spans.span("backend.snapshot"):
                        store = frame_mod.kf_snapshot(self.store, device=self.backend.device)
                epoch, hp_gen = self._map_epoch, self._hp_gen

            with spans.span("backend.pairs"):
                kf_set = {idx - 1} if idx >= 1 else set()
                if self.retrieval is not None:
                    # the keyframes retrieved for this one become loop-closure edges
                    feat = store.feat[idx % store.capacity][None].to(self.device)
                    kf_set.update(self.retrieval.update(
                        feat, add_after_query=True, k=int(self.cfg.retrieval.k),
                        min_thresh=float(self.cfg.retrieval.min_thresh), kf_id=idx))
                    kf_set.discard(idx)
                if pair_half is not None and idx >= 1 and (idx - 1) in kf_set:
                    # the tracker already decoded and matched its direction of this
                    # consecutive pair: only the missing direction is computed
                    self.backend.add_consecutive_half(store, idx - 1, idx, pair_half)
                    kf_set.discard(idx - 1)
                kf_list = sorted(kf_set)
                if kf_list:
                    self.backend.add_factors(store, kf_list, [idx] * len(kf_list))
                if odom_factor is not None:
                    self.backend.add_odometry_factors(*odom_factor)

            win = self._solve_window(store, self._height_prior_s_bar(store, hp_gen))
            if win is None:
                return
            uniq, p, T_new = win

            with spans.span("backend.merge"), spans.held(self._backend_lock, TASK_LOCK_WAIT):
                if epoch != self._map_epoch:
                    return  # the map was reset while we solved: drop the result
                pin = self.ba_cfg.pin
                live_total = self.store.n_total
                live_oldest = max(0, live_total - self.store.capacity)
                free = [(n, k) for n, k in enumerate(uniq[:p])
                        if n >= pin and live_oldest <= k < live_total]
                if free:
                    rows = torch.as_tensor([n for n, _ in free], device=T_new.device)
                    frame_mod.kf_update_T_WCs(self.store, T_new[rows],
                                              [k % self.store.capacity for _, k in free])
                # the backend moved the newest keyframe's pose: refresh the
                # streaming active-KF state so the next track uses it. Threaded,
                # the newest live keyframe may postdate the copy; merge only when
                # it was part of the solved window.
                n_latest = len(self.kf_timestamps) - 1
                if n_latest in uniq[:p]:
                    w = uniq.index(n_latest)
                    self.active_kf = dataclasses.replace(self.active_kf, T_WC=T_new[w].to(self.device))
                    if self.single_thread or n_latest == idx:
                        self.current_T_WC = T_new[w].cpu().numpy()

    def _solve_window(self, store, s_bar=None):
        """The window solve of a backend task: calibrated pixel/log-depth GN
        with a calibration, ray alignment otherwise (vio.py:154-157), with
        the scale targets ``s_bar`` (per logical keyframe, <= 0 off).
        Returns (uniq, p, T_new) or None."""
        if self.tcfg.use_calib:
            return self.backend.solve_window_calib(store, self.K, s_bar)
        return self.backend.solve_window_rays(store, s_bar)

    def _hp_invalidate(self, k: int):
        """Drop keyframe ``k``'s cached fit (its stored pointmap changed);
        under ``_backend_lock``."""
        self._hp_gen += 1
        self._hp_gen_of[k] = self._hp_gen
        self._hp_cache.pop(k, None)

    def _height_prior_s_bar(self, store, hp_gen=None):
        """Per-keyframe metric-scale targets from the ground-plane fit
        (global_opt.py:212-224), or None with the prior off.

        Unlike the reference, which refits every window keyframe's plane on
        every backend task, fits are cached per keyframe and invalidated when
        the keyframe's stored pointmap changes (the fused write-back at the
        next keyframe, see ``_finalize_track``), and only the fit region's
        rows (at most ``max_subsample``) are gathered on the device and
        fetched; the fit runs on them on the host. A task therefore refits
        only the one or two dirty keyframes, whatever the window's size.
        ``hp_gen``: the invalidation count when ``store`` was copied; a fit
        of a keyframe invalidated since is used but not cached."""
        if not self.height_prior_enabled:
            return None
        uniq = self.backend.unique_kf_idx()
        if not uniq:
            return None
        h, w = self.img_hw
        if self._hp_region_idx is None:
            true_hw = (w, h) if self.portrait else (h, w)
            flat_true = self.plane_estimator.region_indices(true_hw)
            if self.portrait:
                # the region is selected in TRUE-image pixels; storage is
                # landscape-transposed (storage[x, y] = true[y, x]), so the
                # true flat index y * true_w + x maps to storage x * w + y
                flat_true = (flat_true % h) * w + flat_true // h
            self._hp_region_idx = torch.as_tensor(flat_true, dtype=torch.long, device=self.device)
        s_bar = np.full(max(uniq) + 1, -1.0, np.float32)
        for k in uniq:
            v = self._hp_cache.get(k)
            if v is None:
                rows = self._hp_region_idx.to(store.X_canon.device)
                pts = store.X_canon[int(k) % store.capacity][rows].cpu().numpy()
                h_bar = self.plane_estimator.run_points(pts)
                # gauge-target convention: see height_prior.scale_targets
                v = float(h_bar / self.camera_height) if (h_bar is not None and h_bar > 1e-6) else -1.0
                with self._backend_lock:
                    if hp_gen is None or self._hp_gen_of.get(k, 0) <= hp_gen:
                        self._hp_cache[k] = v
            s_bar[k] = v
        return s_bar

    def _run_backend(self, idx: int, odom_factor, pair_half=None):
        # the task's cause is the frame being finalized (frame_count)
        if self.single_thread:
            self._backend_step(idx, odom_factor, pair_half, self.frame_count)
            return
        # never block the frontend: enqueue and return (vio.py:333-343)
        if self._backend_tasks.qsize() >= self._backend_queue_max:
            log.warning("backend backlog: %d tasks pending (solves slower than the "
                        "keyframe cadence)", self._backend_tasks.qsize())
        if self._backend_worker is None or not self._backend_worker.is_alive():
            self._backend_worker = threading.Thread(
                target=self._backend_worker_loop, daemon=True, name="frodo-backend")
            self._backend_worker.start()
        self._backend_tasks.put((idx, odom_factor, pair_half, self.frame_count, spans.stamp()))

    # -- relocalization ---------------------------------------------------------

    def _relocalize(self, frame: frame_mod.Frame, timestamp: float) -> bool:
        """Retrieval-seeded relocalization (vio.py:29-72): append the lost
        frame as a tentative keyframe, gate its edges to the retrieved
        keyframes strictly, pop it on failure; on success seed its pose
        from the first retrieved keyframe and solve the window.

        Runs on the frontend thread under the worker's per-task lock, so it
        waits out only the task in flight and preempts the pending backlog
        (``_reloc_gate`` keeps the worker from starting another task first).
        The pending tasks stay valid: relocalization appends a keyframe and
        resets nothing, and retrieval ids are explicit (``kf_ids``), so the
        out-of-order insertion cannot skew later retrievals."""
        with self._reloc_gate, self._backend_exec_lock, self._backend_lock:
            rcfg = self.cfg.retrieval
            retrieved = self.retrieval.update(frame.feat, add_after_query=False, k=int(rcfg.k),
                                              min_thresh=float(rcfg.min_thresh))
            if not retrieved:
                return False
            self.store = frame_mod.kf_append(self.store, frame)
            self.kf_timestamps.append(timestamp)
            n_kf = len(self.kf_timestamps)
            ok = self.backend.add_factors(
                self.store, [n_kf - 1] * len(retrieved), list(retrieved),
                min_match_frac=float(self.cfg.reloc.min_match_frac),
                is_reloc=bool(self.cfg.reloc.strict))
            if not ok:
                # pop the tentative keyframe (vio.py:63-65)
                self.store.n_total -= 1
                self.store.n_size -= 1
                self.kf_timestamps.pop()
                return False
            self._capture_kf_image(frame)
            self.retrieval.update(frame.feat, add_after_query=True, k=int(rcfg.k),
                                  min_thresh=float(rcfg.min_thresh), kf_id=n_kf - 1)
            # seed the pose from the first retrieved keyframe (vio.py:66)
            last = self.store.last_slot()
            seed = self.store.T_WC[int(retrieved[0]) % self.store.capacity].clone()
            frame_mod.kf_update_T_WCs(self.store, seed[None], [last])
            win = self._solve_window(self.store)
            if win is not None:
                self.backend._write_back(self.store, *win)
            T_WC = self.store.T_WC[last].clone()
            self.current_T_WC = T_WC.cpu().numpy()
            self.active_kf = dataclasses.replace(frame, T_WC=T_WC)
        return True

    # -- export -----------------------------------------------------------------

    def keyframe_poses(self) -> Tuple[List[float], np.ndarray]:
        """(timestamps, (N, 8) Sim3 poses) of live keyframes, oldest first."""
        with self._backend_lock:
            n = self.store.n_size
            total = self.store.n_total
            slots = [k % self.store.capacity for k in range(max(0, total - n), total)]
            poses = self.store.T_WC[torch.as_tensor(slots, dtype=torch.long,
                                                    device=self.device)].cpu().numpy()
        return self.kf_timestamps[-n:] if n else [], poses

    def metric_keyframe_poses(self) -> Tuple[List[float], np.ndarray]:
        """(timestamps, (N, 8) poses) with translations in metric units,
        t / s, where the Sim(3) scale channel s is the map gauge (world units
        per metric unit, see :func:`.pgo.apply_pgo_scale_`). The scale-only
        PGO and the BA's odometry factors estimate it; with neither active s
        stays 1 and this equals :meth:`keyframe_poses`."""
        stamps, poses = self.keyframe_poses()
        out = poses.copy()
        out[:, :3] = poses[:, :3] / np.maximum(poses[:, 7:8], 1e-8)
        return stamps, out

    def get_pose(self) -> np.ndarray:
        return self.current_T_WC


VIO = SLAM  # the reference's class name (vio.py:163)
