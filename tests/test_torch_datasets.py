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
synthetic TUM, EuRoC, ETH3D, 7-Scenes and image-folder layouts; video files
(a clip written here with OpenCV) and the live cameras (fake OpenCV and
RealSense modules) through both packages, which both read them with OpenCV.
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


# ---------------------------------------------------------------------------
# video files and live cameras (OpenCV, as in the JAX package)
# ---------------------------------------------------------------------------

def _write_clip(path: pathlib.Path, n=7, h=48, w=64, fps=10.0):
    """A short mp4v clip whose frames differ (a moving bar, a grey ramp)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    for i in range(n):
        img = np.full((h, w, 3), 20 + 30 * i, np.uint8)
        img[:, 6 * i:6 * i + 8] = (255, 40, 0)
        writer.write(img)
    writer.release()


class _FakeCapture:
    """A camera that returns numbered BGR frames."""

    def __init__(self, index):
        self.index, self.n = index, 0

    def read(self):
        self.n += 1
        return True, np.full((24, 32, 3), (self.n, 2 * self.n, 3 * self.n), np.uint8)


def _fake_cv2():
    import types

    return types.SimpleNamespace(VideoCapture=_FakeCapture, COLOR_BGR2RGB=4,
                                 cvtColor=lambda img, code: img[..., ::-1].copy())


def _fake_realsense():
    """pyrealsense2 as RealsenseDataset calls it: a pipeline of numbered
    640x480 BGR frames with millisecond timestamps."""
    import types

    class Frameset:
        def __init__(self, n):
            self.n = n

        def get_timestamp(self):
            return 1000.0 + 33.0 * self.n

        def get_color_frame(self):
            data = np.full((480, 640, 3), (self.n, 7, 200), np.uint8)
            return types.SimpleNamespace(get_data=lambda: data)

    class Pipeline:
        n = 0

        def start(self, cfg):
            return types.SimpleNamespace(get_stream=lambda s: s)

        def wait_for_frames(self):
            self.n += 1
            return Frameset(self.n)

    intr = types.SimpleNamespace(fx=600.0, fy=610.0, ppx=318.0, ppy=242.0)
    return types.SimpleNamespace(
        pipeline=Pipeline, stream=types.SimpleNamespace(color="color"),
        format=types.SimpleNamespace(bgr8="bgr8"),
        config=lambda: types.SimpleNamespace(enable_stream=lambda *a: None),
        video_stream_profile=lambda s: types.SimpleNamespace(get_intrinsics=lambda: intr))


@pytest.mark.parametrize("path", ["data/realsense", "data/webcam", "data/clip.mp4", "data/clip.MOV"])
def test_live_and_video_inputs_name_their_roadmap_item(path, tmp_path, monkeypatch):
    """Video files and live cameras reach their classes in both packages and
    read alike (the test keeps the name it had while the port raised for
    them). A clip written here is read through both ``load_dataset``s, with
    ``subsample`` 1 and 2: lengths, timestamps and frames equal. The cameras
    run against fake ``cv2`` / ``pyrealsense2`` modules: the same frames,
    timestamps and calibration."""
    import sys

    if path.startswith("data/clip"):
        clip = tmp_path / path
        _write_clip(clip)
        for sub in (1, 2):
            got, want = tds.load_dataset(str(clip), subsample=sub), jds.load_dataset(str(clip), subsample=sub)
            assert type(got) is tds.MP4Dataset and type(want).__name__ == "MP4Dataset"
            assert len(got) == len(want) == 7 // sub and got.fps == want.fps == 10.0
            assert got.get_img_shape() == want.get_img_shape() == ((384, 512), (48, 64))
            for i in range(len(got)):
                (ts, img), (ts_j, img_j) = got[i], want[i]
                assert ts == ts_j == i * sub / 10.0
                assert img.dtype == img_j.dtype == np.float32
                np.testing.assert_array_equal(img, img_j)
            assert not np.array_equal(got[0][1], got[1][1])
        return
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2())
    monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense())
    for use_calib in (False, True):
        got = tds.load_dataset(path, use_calib=use_calib)
        want = jds.load_dataset(path, use_calib=use_calib)
        assert type(got).__name__ == type(want).__name__ == ("RealsenseDataset" if "realsense" in path
                                                             else "WebcamDataset")
        assert len(got) == len(want) == 999999 and got.save_results is want.save_results is False
        assert got.has_calib() == want.has_calib() == (use_calib and "realsense" in path)
        if got.has_calib():
            np.testing.assert_allclose(got.camera_intrinsics.K_frame, want.camera_intrinsics.K_frame, rtol=1e-9)
        for i in range(3):
            (ts, img), (ts_j, img_j) = got[i], want[i]
            assert ts == ts_j
            np.testing.assert_array_equal(img, img_j)
        assert got.timestamps == want.timestamps and len(got.timestamps) == 3


@pytest.mark.parametrize("path,missing", [("data/clip.mp4", "cv2"), ("data/webcam", "cv2"),
                                          ("data/realsense", "cv2"), ("data/realsense", "pyrealsense2")])
def test_video_and_cameras_name_the_module_they_miss(path, missing, monkeypatch):
    """Without OpenCV (or the RealSense SDK) the class raises an
    ``ImportError`` that names the module; nothing falls back."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2())
    monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense())
    monkeypatch.setitem(sys.modules, missing, None)
    with pytest.raises(ImportError, match=missing):
        tds.load_dataset(path)
