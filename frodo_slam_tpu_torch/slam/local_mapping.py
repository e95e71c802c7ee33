"""Windowed in-tracker factor graph (local mapping).

Behavioral spec: ``mast3r_slam/local_mapping.py`` — a factor dict keyed
``(i, j)`` with replace-on-duplicate (:95-104), window eviction
``remove_factors_i`` (:28-32), and a windowed ray-alignment GN solve
(:151-216) — driven by ``LocalMapOptimizer`` (tracker.py:27-105), which the
reference ships *disabled* (``enabled = False``, tracker.py:51). The JAX
package's ``slam/local_mapping.py`` is the reference of this port. Enabled,
its solve is the backend's :meth:`BackendGraph.solve_GN_rays`, so it runs
the ray kernel, and a ``placement`` keyword reaches the graph as the
backend's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .backend import BackendGraph
from .frame import KeyframeStore


class LocalFactorGraph(BackendGraph):
    """BackendGraph with (i, j)-keyed replacement and window eviction."""

    def __init__(self, *args, window_size: int = 16, **kw):
        super().__init__(*args, **kw)
        self.window_size = window_size

    def _insert_pair(self, i, j, *payload, **kw):
        # replace-on-duplicate (local_mapping.py:95-104)
        key = (int(i), int(j))
        if key in self._pairs:
            k = self._pairs.index(key)
            self._pairs.pop(k)
            self._shift_rows(k)
        super()._insert_pair(i, j, *payload, **kw)

    def remove_factors_i(self, i: int):
        """Evict every factor touching keyframe ``i`` (local_mapping.py:28-32),
        compacting the survivors to the front, in place."""
        keep = [k for k, (a, b) in enumerate(self._pairs) if a != i and b != i]
        if len(keep) == len(self._pairs):
            return
        rows = torch.as_tensor([r for k in keep for r in (2 * k, 2 * k + 1)], dtype=torch.long,
                               device=self.device)
        for a in self.edges:
            if a is not None:
                a[: len(rows)] = a[rows]
                a[len(rows):] = 0
        self._pairs = [self._pairs[k] for k in keep]

    def enforce_window(self, newest: int):
        """Keep only factors inside the sliding window ending at ``newest``."""
        oldest = newest - self.window_size + 1
        for i in sorted({k for p in self._pairs for k in p}):
            if i < oldest:
                self.remove_factors_i(i)


class LocalMapOptimizer:
    """Per-keyframe local windowed optimization (tracker.py:27-105).

    Disabled by default, exactly like the reference (tracker.py:51).
    ``offset_to_current`` selects which past keyframes get an edge to the
    new one (tracker.py:96-105)."""

    def __init__(self, graph: LocalFactorGraph, enabled: bool = False,
                 offset_to_current: Tuple[int, ...] = (-1, -2, -5)):
        self.graph = graph
        self.enabled = enabled
        self.offset_to_current = offset_to_current

    def on_new_keyframe(self, store: KeyframeStore, idx: int,
                        s_bar: Optional[np.ndarray] = None) -> KeyframeStore:
        if not self.enabled:
            return store
        ii = [idx + off for off in self.offset_to_current if idx + off >= 0]
        if not ii:
            return store
        self.graph.add_factors(store, ii, [idx] * len(ii))
        self.graph.enforce_window(idx)
        return self.graph.solve_GN_rays(store, s_bar)
