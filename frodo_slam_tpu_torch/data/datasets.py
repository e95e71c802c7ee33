"""Dataset ingestion: TUM / EuRoC / ETH3D / 7-Scenes / image folders.

Behavioral spec: ``mast3r_slam/dataloader.py`` — per-dataset file layouts,
hard-coded calibrations (TUM fr1/2/3, dataloader.py:76-88; 7-Scenes :145),
the EuRoC always-undistort policy (:92-116), the ``Intrinsics`` rescale to
the 512-long-edge crop (:277-317) and the path-keyword dispatch (:320-338);
the JAX package's ``data/datasets.py`` is the reference of this port.

The port reads images with PIL and undistorts in numpy: the machines the
port runs on need not have OpenCV. :func:`optimal_new_camera_matrix`,
:func:`undistort_rectify_map` and :func:`remap_bilinear` reproduce
``cv2.getOptimalNewCameraMatrix(alpha=0)``, ``cv2.initUndistortRectifyMap``
(radial-tangential k1, k2, p1, p2, k3) and ``cv2.remap(INTER_LINEAR)`` with a
zero border, as OpenCV 5 computes them. MP4 input and the live
cameras are ROADMAP.md §1 "The rest of the entry points and IO".
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Optional, Sequence

import numpy as np
import PIL.Image

from .image import resize_img


def natsorted(paths: Sequence) -> List:
    """Natural sort (numeric-aware)."""

    def key(p):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


# ---------------------------------------------------------------------------
# undistortion (OpenCV's calibration and remap, in numpy)
# ---------------------------------------------------------------------------

def _dist12(distortion) -> np.ndarray:
    """OpenCV's coefficient order k1, k2, p1, p2[, k3[, k4, k5, k6[, s1..s4]]],
    zero-padded to 12."""
    d = np.zeros(12)
    dist = np.asarray(distortion, np.float64).reshape(-1)
    d[: len(dist)] = dist
    return d


def _distort(x, y, d):
    """Normalised undistorted -> distorted coordinates (the forward model of
    initUndistortRectifyMap)."""
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((d[4] * r2 + d[1]) * r2 + d[0]) * r2) / (1 + ((d[7] * r2 + d[6]) * r2 + d[5]) * r2)
    xd = x * kr + d[2] * _2xy + d[3] * (r2 + 2 * x2) + d[8] * r2 + d[9] * r2 * r2
    yd = y * kr + d[2] * (r2 + 2 * y2) + d[3] * _2xy + d[10] * r2 + d[11] * r2 * r2
    return xd, yd


def undistort_points(uv: np.ndarray, K: np.ndarray, distortion, P: Optional[np.ndarray] = None,
                     iters: int = 5) -> np.ndarray:
    """``cv2.undistortPoints`` with its default 5 fixed-point iterations:
    pixels (n, 2) -> normalised coordinates, or pixels of ``P``."""
    d = _dist12(distortion)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = (uv[:, 0] - cx) / fx
    y0 = (uv[:, 1] - cy) / fy
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = (1 + ((d[7] * r2 + d[6]) * r2 + d[5]) * r2) / (1 + ((d[4] * r2 + d[1]) * r2 + d[0]) * r2)
        bad = icdist < 0  # outside the model's range: the distorted point
        dx = 2 * d[2] * x * y + d[3] * (r2 + 2 * x * x) + d[8] * r2 + d[9] * r2 * r2
        dy = d[2] * (r2 + 2 * y * y) + 2 * d[3] * x * y + d[10] * r2 + d[11] * r2 * r2
        x = np.where(bad, x0, (x0 - dx) * icdist)
        y = np.where(bad, y0, (y0 - dy) * icdist)
    if P is None:
        return np.stack([x, y], -1)
    return np.stack([P[0, 0] * x + P[0, 2], P[1, 1] * y + P[1, 2]], -1)


def _undistort_rectangles(K, distortion, W, H, P=None, n=9):
    """Inscribed and circumscribed rectangles (x, y, w, h) of the undistorted
    image border, from an n x n grid of pixels (getUndistortRectangles)."""
    xs = np.arange(n) * (W - 1) / (n - 1)
    ys = np.arange(n) * (H - 1) / (n - 1)
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    pts = undistort_points(grid, K, distortion, P).reshape(n, n, 2)  # [y, x]
    px, py = pts[..., 0], pts[..., 1]
    ix0, ix1 = px[:, 0].max(), px[:, -1].min()
    iy0, iy1 = py[0, :].max(), py[-1, :].min()
    ox0, ox1, oy0, oy1 = px.min(), px.max(), py.min(), py.max()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def optimal_new_camera_matrix(K: np.ndarray, distortion, W: int, H: int,
                              center_principal_point: bool) -> np.ndarray:
    """``cv2.getOptimalNewCameraMatrix(K, dist, (W, H), alpha=0, (W, H),
    centerPrincipalPoint)``: the new camera keeps only valid pixels."""
    K = np.asarray(K, np.float64)
    M = K.copy()
    if center_principal_point:
        cx0, cy0 = K[0, 2], K[1, 2]
        cx, cy = (W - 1) * 0.5, (H - 1) * 0.5  # OpenCV 5's pixel-centre convention
        (ix, iy, iw, ih), _ = _undistort_rectangles(K, distortion, W, H, P=K)
        s = max(cx / (cx0 - ix), cy / (cy0 - iy), cx / (ix + iw - cx0), cy / (iy + ih - cy0))
        M[0, 0] *= s
        M[1, 1] *= s
        M[0, 2], M[1, 2] = cx, cy
    else:
        (ix, iy, iw, ih), _ = _undistort_rectangles(K, distortion, W, H)
        fx0, fy0 = (W - 1) / iw, (H - 1) / ih
        M[0, 0], M[1, 1] = fx0, fy0
        M[0, 2], M[1, 2] = -fx0 * ix, -fy0 * iy
    return M


def undistort_rectify_map(K: np.ndarray, distortion, K_new: np.ndarray, W: int, H: int):
    """``cv2.initUndistortRectifyMap(K, dist, None, K_new, (W, H), CV_32FC1)``:
    for every pixel of the undistorted image, its source pixel. Returns
    (mapx, mapy), (H, W) f32."""
    d = _dist12(distortion)
    iK = np.linalg.inv(np.asarray(K_new, np.float64))
    v, u = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    X = iK[0, 0] * u + iK[0, 1] * v + iK[0, 2]
    Y = iK[1, 0] * u + iK[1, 1] * v + iK[1, 2]
    Wh = iK[2, 0] * u + iK[2, 1] * v + iK[2, 2]
    xd, yd = _distort(X / Wh, Y / Wh, d)
    mapx = K[0, 0] * xd + K[0, 2]
    mapy = K[1, 1] * yd + K[1, 2]
    return mapx.astype(np.float32), mapy.astype(np.float32)


def remap_bilinear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, mapx, mapy, INTER_LINEAR)`` with a zero border for a
    uint8 image, as OpenCV 5 computes it: bilinear weights in floating point
    at the exact source coordinates, out-of-image neighbours contributing 0,
    the sum rounded to nearest."""
    if img.dtype != np.uint8:
        raise ValueError(f"remap_bilinear takes uint8 images, got {img.dtype}")
    fx = mapx.astype(np.float64)
    fy = mapy.astype(np.float64)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    ax, ay = fx - x0, fy - y0
    h, w = img.shape[:2]
    src = img[..., None] if img.ndim == 2 else img
    acc = np.zeros(mapx.shape + (src.shape[2],))
    for dy, wy in ((0, 1 - ay), (1, ay)):
        for dx, wx in ((0, 1 - ax), (1, ax)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            pix = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            acc += (wy * wx * inside)[..., None] * pix
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


class Intrinsics:
    """Camera intrinsics + undistortion maps + K rescaled to the network
    crop (dataloader.py:277-317)."""

    def __init__(self, img_size, W, H, K_orig, K, distortion, mapx, mapy):
        self.img_size = img_size
        self.W, self.H = W, H
        self.K_orig = K_orig
        self.K = K
        self.distortion = distortion
        self.mapx = mapx
        self.mapy = mapy
        _, (scale_w, scale_h, half_crop_w, half_crop_h) = resize_img(
            np.zeros((H, W, 3)), self.img_size, return_transformation=True
        )
        self.K_frame = self.K.copy()
        self.K_frame[0, 0] = self.K[0, 0] / scale_w
        self.K_frame[1, 1] = self.K[1, 1] / scale_h
        self.K_frame[0, 2] = self.K[0, 2] / scale_w - half_crop_w
        self.K_frame[1, 2] = self.K[1, 2] / scale_h - half_crop_h

    def remap(self, img: np.ndarray) -> np.ndarray:
        return remap_bilinear(img, self.mapx, self.mapy)

    @staticmethod
    def from_calib(img_size, W, H, calib, use_calib: bool, center_principal_point: bool = True,
                   always_undistort: bool = False) -> Optional["Intrinsics"]:
        if not use_calib and not always_undistort:
            return None
        fx, fy, cx, cy = calib[:4]
        distortion = np.zeros(4)
        if len(calib) > 4:
            distortion = np.array(calib[4:])
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        K_opt = optimal_new_camera_matrix(K, distortion, W, H, center_principal_point)
        mapx, mapy = undistort_rectify_map(K, distortion, K_opt, W, H)
        return Intrinsics(img_size, W, H, K, K_opt, distortion, mapx, mapy)


class MonocularDataset:
    """Indexable (timestamp, rgb float image in [0, 1]) (dataloader.py:20-64)."""

    def __init__(self, use_calib: bool = False, center_principal_point: bool = True):
        self.dtype = np.float32
        self.rgb_files: List = []
        self.timestamps: List = []
        self.img_size = 512
        self.camera_intrinsics: Optional[Intrinsics] = None
        self.use_calibration = use_calib
        self.center_principal_point = center_principal_point
        self.save_results = True

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, idx):
        img = self.get_image(idx)
        return self.get_timestamp(idx), img

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def read_img(self, idx) -> np.ndarray:
        with PIL.Image.open(self.rgb_files[idx]) as im:
            return np.asarray(im.convert("RGB"))

    def get_image(self, idx):
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img.astype(self.dtype) / 255.0

    def get_img_shape(self):
        img = self.read_img(0)
        out = resize_img(img.astype(self.dtype) / 255.0, self.img_size)
        return tuple(out["img"][0].shape[:2]), img.shape[:2]

    def subsample(self, subsample: int):
        self.rgb_files = self.rgb_files[::subsample]
        self.timestamps = self.timestamps[::subsample]

    def has_calib(self):
        return self.camera_intrinsics is not None


class TUMDataset(MonocularDataset):
    """TUM-RGBD: rgb.txt listing + per-freiburg calibration (dataloader.py:67-90)."""

    def __init__(self, dataset_path, use_calib=False, center_principal_point=True):
        super().__init__(use_calib, center_principal_point)
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(self.dataset_path / "rgb.txt", delimiter=" ", dtype=str)
        self.rgb_files = [self.dataset_path / f for f in tstamp_rgb[:, 1]]
        self.timestamps = list(tstamp_rgb[:, 0])

        match = re.search(r"freiburg(\d+)", str(dataset_path))
        idx = int(match.group(1)) if match else 1
        calib = {
            1: [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
            2: [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172],
            3: [535.4, 539.2, 320.1, 247.6],
        }[idx]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, np.array(calib), use_calib, center_principal_point
        )


class EurocDataset(MonocularDataset):
    """EuRoC MAV cam0; always undistorts (dataloader.py:92-116)."""

    def __init__(self, dataset_path, use_calib=False, center_principal_point=True):
        super().__init__(use_calib, center_principal_point)
        import yaml

        self.use_calibration = True
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(self.dataset_path / "mav0/cam0/data.csv", delimiter=",", dtype=str)
        self.rgb_files = [self.dataset_path / "mav0/cam0/data" / f for f in tstamp_rgb[:, 1]]
        self.timestamps = list(tstamp_rgb[:, 0])
        with open(self.dataset_path / "mav0/cam0/sensor.yaml") as f:
            cam0 = yaml.safe_load(f)
        W, H = cam0["resolution"]
        calib = [*cam0["intrinsics"], *cam0["distortion_coefficients"]]
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H, np.array(calib), use_calib, center_principal_point,
            always_undistort=True,
        )

    def read_img(self, idx):
        with PIL.Image.open(self.rgb_files[idx]) as im:
            gray = np.asarray(im.convert("L"))
        return np.repeat(gray[..., None], 3, axis=-1)


class ETH3DDataset(MonocularDataset):
    """ETH3D SLAM: rgb.txt + calibration.txt (dataloader.py:119-135)."""

    def __init__(self, dataset_path, use_calib=False, center_principal_point=True):
        super().__init__(use_calib, center_principal_point)
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(self.dataset_path / "rgb.txt", delimiter=" ", dtype=str)
        self.rgb_files = [self.dataset_path / f for f in tstamp_rgb[:, 1]]
        self.timestamps = list(tstamp_rgb[:, 0])
        calibration = np.loadtxt(self.dataset_path / "calibration.txt", dtype=np.float32)
        _, (H, W) = self.get_img_shape()
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H, calibration, use_calib, center_principal_point
        )


class SevenScenesDataset(MonocularDataset):
    """7-Scenes seq-01 color frames, fixed calibration (dataloader.py:137-148)."""

    def __init__(self, dataset_path, use_calib=False, center_principal_point=True):
        super().__init__(use_calib, center_principal_point)
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = natsorted((self.dataset_path / "seq-01").glob("*.color.png"))
        self.timestamps = list(np.arange(len(self.rgb_files), dtype=self.dtype))
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, [585.0, 585.0, 320.0, 240.0], use_calib,
            center_principal_point,
        )


class RGBFiles(MonocularDataset):
    """Folder of images at 30 fps (dataloader.py:268-274)."""

    def __init__(self, dataset_path, **kw):
        super().__init__(use_calib=False)
        self.dataset_path = pathlib.Path(dataset_path)
        files = []
        for pat in ("*.jpg", "*.jpeg", "*.png"):  # the reference globs jpg only
            files += self.dataset_path.glob(pat)
        self.rgb_files = natsorted(files)
        self.timestamps = list(np.arange(len(self.rgb_files), dtype=self.dtype) / 30.0)


def load_dataset(dataset_path: str, use_calib: bool = False,
                 center_principal_point: bool = True, subsample: int = 1):
    """Path-keyword dispatch (dataloader.py:320-338)."""
    parts = str(dataset_path).split("/")
    kw = dict(use_calib=use_calib, center_principal_point=center_principal_point)
    if "tum" in parts:
        ds = TUMDataset(dataset_path, **kw)
    elif "euroc" in parts:
        ds = EurocDataset(dataset_path, **kw)
    elif "eth3d" in parts:
        ds = ETH3DDataset(dataset_path, **kw)
    elif "7-scenes" in parts:
        ds = SevenScenesDataset(dataset_path, **kw)
    elif "realsense" in parts or "webcam" in parts:
        raise NotImplementedError(
            'live cameras (realsense, webcam) are ROADMAP.md §1 "The rest of the entry points and IO"')
    elif parts[-1].split(".")[-1].lower() in ("mp4", "avi", "mov"):
        raise NotImplementedError('video input (MP4Dataset) is ROADMAP.md §1 "The rest of the entry points and IO"')
    else:
        ds = RGBFiles(dataset_path)
    if subsample > 1:
        ds.subsample(subsample)
    return ds
