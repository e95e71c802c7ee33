"""PyTorch port vs JAX package: dataset ingestion.

The port undistorts in numpy (no OpenCV); the JAX package calls
``cv2.getOptimalNewCameraMatrix``, ``cv2.initUndistortRectifyMap`` and
``cv2.remap``. Same calibrations, same images:

- ``K`` and ``K_frame``: rtol 1e-9 (the same f64 arithmetic up to the order
  of a few operations);
- the undistortion maps: within 1e-3 px (OpenCV rounds its f64 map to f32,
  as the port does; the rest is operation order);
- the remapped uint8 image: within one grey level everywhere and equal on
  at least 99% of the pixels (OpenCV's bilinear weights are fixed point,
  1/32 steps; the port's are floating point).

Then the path-keyword dispatch, the timestamps and ``get_img_shape`` on
synthetic TUM, EuRoC, ETH3D, 7-Scenes and image-folder layouts.
"""

import pathlib

import numpy as np
import PIL.Image
import pytest

cv2 = pytest.importorskip("cv2")

from frodo_slam_tpu.data import datasets as jds  # noqa: E402
from frodo_slam_tpu_torch.data import datasets as tds  # noqa: E402

TUM_CALIB = {
    1: [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
    2: [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172],
    3: [535.4, 539.2, 320.1, 247.6],
}
EUROC_CALIB = [458.654, 457.296, 367.215, 248.375,
               -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
CAMERAS = {f"tum_fr{k}": (640, 480, v) for k, v in TUM_CALIB.items()}
CAMERAS["euroc"] = (752, 480, EUROC_CALIB)


def _texture(h, w, seed=0):
    """A smooth colour texture plus noise, uint8 (H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 17.0 + c) * np.cos(yy / 23.0 - c) for c in range(3)], -1)
    img = 127.5 + 100 * base + rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("center", [True, False], ids=["centered", "uncentered"])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_intrinsics_match_opencv(cam, center):
    W, H, calib = CAMERAS[cam]
    want = jds.Intrinsics.from_calib(512, W, H, np.array(calib), True, center)
    got = tds.Intrinsics.from_calib(512, W, H, np.array(calib), True, center)
    np.testing.assert_allclose(got.K, want.K, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.K_frame, want.K_frame, rtol=1e-9, atol=1e-9)
    assert got.mapx.dtype == np.float32 and got.mapx.shape == want.mapx.shape == (H, W)
    assert np.abs(got.mapx - want.mapx).max() <= 1e-3
    assert np.abs(got.mapy - want.mapy).max() <= 1e-3
    img = _texture(H, W)
    a, b = got.remap(img).astype(int), want.remap(img).astype(int)
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.99


def test_no_calibration_without_use_calib():
    assert tds.Intrinsics.from_calib(512, 640, 480, TUM_CALIB[1], False) is None
    assert tds.Intrinsics.from_calib(512, 752, 480, EUROC_CALIB, False, always_undistort=True) is not None


def test_undistort_points_inverts_the_forward_model():
    """cv2.undistortPoints with 5 iterations, point by point."""
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1.0]])
    d = np.array(TUM_CALIB[1][4:])
    uv = np.random.default_rng(1).uniform([0, 0], [640, 480], (50, 2))
    want = cv2.undistortPoints(uv[:, None, :], K, d).reshape(-1, 2)
    np.testing.assert_allclose(tds.undistort_points(uv, K, d), want, atol=1e-9)


def test_natsorted():
    names = ["f10.png", "f2.png", "f1.png", "g0.png"]
    assert tds.natsorted(names) == jds.natsorted(names) == ["f1.png", "f2.png", "f10.png", "g0.png"]


# ---------------------------------------------------------------------------
# synthetic layouts
# ---------------------------------------------------------------------------

def _write_png(path: pathlib.Path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    PIL.Image.fromarray(img).save(path)


def _tum(root: pathlib.Path, n=3, fr=1):
    d = root / "tum" / f"rgbd_dataset_freiburg{fr}_desk"
    lines = ["# color images", "# file: 'rgbd_dataset_freiburg1_desk.bag'", "# timestamp filename"]
    for i in range(n):
        ts = f"{1305031452.791720 + i / 30:.6f}"
        _write_png(d / "rgb" / f"{ts}.png", _texture(480, 640, i))
        lines.append(f"{ts} rgb/{ts}.png")
    (d / "rgb.txt").write_text("\n".join(lines) + "\n")
    return d


def _eth3d(root: pathlib.Path, n=3):
    d = root / "eth3d" / "table_3"
    lines = []
    for i in range(n):
        _write_png(d / "rgb" / f"{i}.png", _texture(464, 739, i))
        lines.append(f"{100.5 + i} rgb/{i}.png")
    (d / "rgb.txt").write_text("\n".join(lines) + "\n")
    (d / "calibration.txt").write_text("726.21 726.21 359.2 234.9\n")
    return d


def _seven_scenes(root: pathlib.Path, n=3):
    d = root / "7-scenes" / "chess"
    for i in (0, 10, 2)[:n]:
        _write_png(d / "seq-01" / f"frame-{i:06d}.color.png", _texture(480, 640, i))
    return d


def _euroc(root: pathlib.Path, n=3):
    d = root / "euroc" / "MH_01_easy"
    cam = d / "mav0" / "cam0"
    lines = ["#timestamp [ns],filename"]
    for i in range(n):
        ts = 1403636579763555584 + i * 50000000
        _write_png(cam / "data" / f"{ts}.png", _texture(480, 752, i)[..., 0])  # grayscale
        lines.append(f"{ts},{ts}.png")
    (cam / "data.csv").write_text("\n".join(lines) + "\n")
    (cam / "sensor.yaml").write_text(
        "resolution: [752, 480]\n"
        f"intrinsics: {EUROC_CALIB[:4]}\n"
        f"distortion_coefficients: {EUROC_CALIB[4:]}\n")
    return d


def _folder(root: pathlib.Path, n=3):
    d = root / "frames"
    for i in range(n):
        _write_png(d / f"{i}.png", _texture(300, 400, i))
    return d


LAYOUTS = {"tum": (_tum, tds.TUMDataset), "eth3d": (_eth3d, tds.ETH3DDataset),
           "7-scenes": (_seven_scenes, tds.SevenScenesDataset), "euroc": (_euroc, tds.EurocDataset),
           "folder": (_folder, tds.RGBFiles)}


@pytest.mark.parametrize("use_calib", [False, True], ids=["raw", "calib"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_dataset_matches_jax(tmp_path, layout, use_calib):
    """Dispatch, frame list, timestamps, shapes, calibration and the first
    image agree with the JAX package's loader (cv2 reads)."""
    make, cls = LAYOUTS[layout]
    path = str(make(tmp_path))
    got = tds.load_dataset(path, use_calib=use_calib)
    want = jds.load_dataset(path, use_calib=use_calib)
    assert type(got) is cls and type(want).__name__ == cls.__name__
    assert len(got) == len(want) == 3
    assert [str(p) for p in got.rgb_files] == [str(p) for p in want.rgb_files]
    assert list(map(str, got.timestamps)) == list(map(str, want.timestamps))
    assert got.get_img_shape() == want.get_img_shape()
    assert got.has_calib() == want.has_calib()
    if got.has_calib():
        np.testing.assert_allclose(got.camera_intrinsics.K_frame, want.camera_intrinsics.K_frame,
                                   rtol=1e-9)
    ts, img = got[1]
    ts_j, img_j = want[1]
    assert ts == ts_j and img.dtype == img_j.dtype == np.float32 and img.shape == img_j.shape
    assert np.abs(img - img_j).max() <= 1 / 255 + 1e-7  # one grey level (remap rounding)


def test_tum_shape_is_512x384(tmp_path):
    """640x480 TUM frames become the 384x512 network input: 768 tokens."""
    ds = tds.load_dataset(str(_tum(tmp_path, n=2)), use_calib=True)
    assert ds.get_img_shape() == ((384, 512), (480, 640))


def test_subsample(tmp_path):
    path = str(_tum(tmp_path, n=3))
    got = tds.load_dataset(path, subsample=2)
    want = jds.load_dataset(path, subsample=2)
    assert list(map(str, got.timestamps)) == list(map(str, want.timestamps)) and len(got) == 2


@pytest.mark.parametrize("path", ["data/realsense", "data/webcam", "data/clip.mp4", "data/clip.MOV"])
def test_live_and_video_inputs_name_their_roadmap_item(path):
    with pytest.raises(NotImplementedError, match="The rest of the entry points and IO"):
        tds.load_dataset(path)
