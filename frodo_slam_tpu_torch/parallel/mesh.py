"""Multi-card placement: one process that addresses a list of devices.

The port's counterpart of the JAX package's ``parallel/mesh.py``. There, one
program gets a (dp, tp) ``Mesh``, the parameters and the pair batch get
layouts, and XLA inserts the collectives. Here the process names its devices
itself. A :class:`Placement` puts the per-frame tracker on one device and the
backend on a (dp, tp) grid of devices:

- every dp rank holds its own replica of the decoder and the heads, with the
  layers the JAX package splits over ``tp`` split over the rank's devices
  (:func:`backend_replicas`, :class:`~..models.mast3r.BackendReplica`);
- a pair batch is padded to a multiple of dp and split over the ranks
  (:func:`split_batch`), and the results come back in pair order
  (:func:`gather_batch`);
- a window solve splits its edge rows over the grid (:func:`edge_parts`) and
  assembles and factors the normal equations once, on the solve device.

Copies between devices are ``Tensor.to``. The device list may name one device
more than once ("aliases"): on one card, or on the CPU in the tests, every
split then runs at its real shapes. Slots (positions in the list) tell
aliases apart.

The JAX package's ``tpu.mesh: {dp, tp}`` config leaf is read nowhere there,
and nowhere here either.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from ..utils.device import indexed
from ..utils.log import get_logger

log = get_logger("placement")

PLACEMENTS = ("overlap", "shared")


@dataclasses.dataclass(frozen=True)
class Placement:
    """The backend's (dp, tp) grid, as slots into ``devices`` (a list that
    may repeat a device). The tracker keeps slot 0, as the JAX package's
    ``default_mesh`` keeps it on device 0."""

    devices: Tuple[torch.device, ...]
    grid_slots: Tuple[Tuple[int, ...], ...]  # (dp, tp)

    @property
    def dp(self) -> int:
        return len(self.grid_slots)

    @property
    def tp(self) -> int:
        return len(self.grid_slots[0])

    @property
    def tracker(self) -> torch.device:
        return self.devices[0]

    @property
    def grid(self) -> Tuple[Tuple[torch.device, ...], ...]:
        return tuple(tuple(self.devices[s] for s in row) for row in self.grid_slots)

    @property
    def rank_devices(self) -> Tuple[torch.device, ...]:
        """Each dp rank's first device: where its pair batch, its
        non-split layers and its matcher run."""
        return tuple(row[0] for row in self.grid)

    @property
    def solve_device(self) -> torch.device:
        """Where the backend keeps its edges and solves its windows (grid[0][0])."""
        return self.grid[0][0]

    @property
    def backend_slots(self) -> Tuple[int, ...]:
        return tuple(s for row in self.grid_slots for s in row)


def _checked(device) -> torch.device:
    """``device`` as a torch.device that exists here (an unindexed "cuda"
    is the current card); raises for one that does not."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"placement: no support for device {d}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if (d.index or 0) >= n:
        raise ValueError(f"placement: device {d} does not exist ({n} CUDA devices)")
    return indexed(d)


def make_placement(dp: int, tp: int, devices: Sequence, first_slot: int = 0) -> Placement:
    """The backend on the (dp, tp) grid of ``devices[first_slot:first_slot +
    dp * tp]`` (dp-major, as ``make_mesh`` reshapes), the tracker on
    ``devices[0]``. Raises on too few devices."""
    devices = tuple(_checked(d) for d in devices)
    if dp < 1 or tp < 1:
        raise ValueError(f"placement: dp={dp}, tp={tp}")
    n = dp * tp
    if len(devices) - first_slot < n:
        raise ValueError(f"placement: need {n} devices from slot {first_slot}, have {len(devices)}")
    grid = tuple(tuple(range(first_slot + r * tp, first_slot + (r + 1) * tp)) for r in range(dp))
    return Placement(devices, grid)


def visible_devices(device=None) -> List[torch.device]:
    """The devices an entry point may place work on: every card for
    ``device=None`` (or an unindexed "cuda"), else the one device named
    (so ``device="cpu"`` gives one device, and no placement)."""
    if device is None or str(device) == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(device)]


def default_placement(placement: str = "overlap", devices=None):
    """The layout the entry points hand to ``SLAM(placement=...)``, or None
    on one device (config ``tpu.placement``; JAX ``default_mesh``):

    - ``"overlap"``: the tracker keeps ``devices[0]`` to itself, the backend
      covers ``devices[1:]`` with tp = 2 if their count is even, else 1 (the
      reference's backend on a second GPU, run_vio.py:111-114);
    - ``"shared"``: the backend covers every device (tp = 2 if their count is
      even), and the tracker shares ``devices[0]`` with the backend's first
      rank.

    ``devices=None``: every card (:func:`visible_devices`)."""
    if placement not in PLACEMENTS:
        raise ValueError(f"tpu.placement {placement!r} is not one of {PLACEMENTS}")
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if n <= 1:
        log.info("placement %s: %d device, tracker and backend together", placement, n)
        return None
    if placement == "overlap":
        rest = n - 1
        tp = 2 if rest % 2 == 0 else 1
        out = make_placement(rest // tp, tp, devices, first_slot=1)
    else:
        tp = 2 if n % 2 == 0 else 1
        out = make_placement(n // tp, tp, devices)
    log.info("placement %s over %d devices: tracker on slot 0 (%s), backend dp=%d tp=%d on slots %s",
             placement, n, out.tracker, out.dp, out.tp, list(out.backend_slots))
    return out


def pad_to(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` with copies of its last row appended until its first dimension
    is a multiple of ``dp`` (the JAX backend's padding, backend.py:232-246)."""
    pad = (-x.shape[0]) % dp
    if not pad:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def split_batch(x: torch.Tensor, placement: Placement) -> List[torch.Tensor]:
    """``x`` (B, ...) padded to a multiple of dp and cut into dp equal
    chunks, chunk r on rank r's first device."""
    chunks = pad_to(x, placement.dp).chunk(placement.dp)
    return [c.to(d) for c, d in zip(chunks, placement.rank_devices)]


def gather_batch(parts: Sequence[torch.Tensor], device, n: int, dim: int = 0) -> torch.Tensor:
    """The ranks' outputs joined on ``device`` in rank order along ``dim``,
    cut to the ``n`` real rows (padded rows are never read)."""
    return torch.cat([p.to(device) for p in parts], dim=dim).narrow(dim, 0, n)


def edge_parts(E: int, placement: Placement) -> List[Tuple[int, int, torch.device]]:
    """Row ranges of a window's E edge rows and their devices (JAX
    ``_build_edge_systems``, global_opt.py:485-540): over every grid device
    when dp * tp divides E, else over the ranks when dp does, else one part
    on the solve device."""
    flat = [d for row in placement.grid for d in row]
    if E % len(flat) == 0:
        devs = flat
    elif E % placement.dp == 0:
        devs = list(placement.rank_devices)
    else:
        devs = [placement.solve_device]
    step = E // len(devs)
    return [(k * step, (k + 1) * step, d) for k, d in enumerate(devs)]


def backend_replicas(model, placement: Placement) -> list:
    """One :class:`~..models.mast3r.BackendReplica` of ``model`` per dp rank,
    each split over its rank's tp devices; no parameter storage is shared
    with ``model``."""
    from ..models.mast3r import BackendReplica

    return [BackendReplica(model, row) for row in placement.grid]
