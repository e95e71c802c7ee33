"""Host-side prefetch: read, undistort, resize and upload frames ahead of the card.

The port's copy of the JAX package's ``data/prefetch.py``: one host thread
runs the dataset read and ``SLAM.preprocess`` for the next ``depth`` frames
and uploads each result from pinned memory with ``non_blocking``, while the
main thread's frame is in flight on the card. An error in the thread is
raised in the consumer, at the frame where it happened.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class PrefetchLoader:
    """Iterates (timestamp, (1, H, W, 3) f32 tensor on ``device``) with up to
    ``depth`` frames ready ahead.

    ``dataset``: indexable returning (timestamp, rgb float [0, 1]);
    ``preprocess``: host function from that image to the normalized
    (1, H, W, 3) array to upload.
    """

    def __init__(self, dataset, preprocess, device, depth: int = 2,
                 max_frames: Optional[int] = None):
        self.dataset = dataset
        self.preprocess = preprocess
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self.n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True, name="frodo-prefetch")

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        if self.device.type != "cuda":
            return host.to(self.device)
        # the caching host allocator keeps the pinned block until the copy ends
        return host.pin_memory().to(self.device, non_blocking=True)

    def _put(self, item) -> bool:
        """Blocking put that gives up once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        for i in range(self.n):
            if self._stop.is_set():
                return
            try:
                ts, img = self.dataset[i]
                item = (ts, self._upload(self.preprocess(img)), None)
            except Exception as e:  # raised again in the consumer
                self._put((None, None, e))
                return
            if not self._put(item):
                return
        self._put(None)

    def __iter__(self) -> Iterator[Tuple[float, torch.Tensor]]:
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                ts, dev, err = item
                if err is not None:
                    raise err
                yield ts, dev
        finally:
            self._stop.set()
            self._thread.join()
