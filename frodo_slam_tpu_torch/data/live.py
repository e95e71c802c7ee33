"""Live sensors: RealSense and webcam.

The port's copy of the JAX package's ``data/live.py`` (reference
``mast3r_slam/dataloader.py:151-229``). Both need OpenCV, and the RealSense
its SDK: each class imports them when it is built, so the package imports
without them, and building one where they are missing raises an
``ImportError`` that names the module.
"""

from __future__ import annotations

import numpy as np

from .datasets import Intrinsics, MonocularDataset, opencv


class RealsenseDataset(MonocularDataset):
    """640x480 BGR colour stream at 30 FPS; with ``use_calib`` the camera's
    own intrinsics."""

    def __init__(self, use_calib: bool = False):
        super().__init__(use_calib)
        self._cv2 = opencv()
        import pyrealsense2 as rs

        self.pipeline = rs.pipeline()
        self.h, self.w = 480, 640
        self.rs_config = rs.config()
        self.rs_config.enable_stream(rs.stream.color, self.w, self.h, rs.format.bgr8, 30)
        self.profile = self.pipeline.start(self.rs_config)
        self.rgb_profile = rs.video_stream_profile(self.profile.get_stream(rs.stream.color))
        self.save_results = False
        if self.use_calibration:
            intr = self.rgb_profile.get_intrinsics()
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, self.w, self.h, [intr.fx, intr.fy, intr.ppx, intr.ppy], True
            )

    def __len__(self):
        return 999999

    def read_img(self, idx):
        frameset = self.pipeline.wait_for_frames()
        self.timestamps.append(frameset.get_timestamp() / 1000)
        rgb = np.asanyarray(frameset.get_color_frame().get_data())
        return self._cv2.cvtColor(rgb, self._cv2.COLOR_BGR2RGB)


class WebcamDataset(MonocularDataset):
    """The first camera OpenCV finds; timestamps at 30 FPS."""

    def __init__(self):
        super().__init__(use_calib=False)
        self._cv2 = opencv()
        self.cap = self._cv2.VideoCapture(-1)
        self.save_results = False

    def __len__(self):
        return 999999

    def read_img(self, idx):
        ret, img = self.cap.read()
        if not ret:
            raise ValueError("failed to read webcam frame")
        self.timestamps.append(idx / 30)
        return self._cv2.cvtColor(img, self._cv2.COLOR_BGR2RGB)
