"""Frame and keyframe state on the device.

Behavioral spec: ``mast3r_slam/frame.py`` — the ``Frame`` dataclass (:17-44),
pointmap fusion filters (:101-165), and the 300-slot keyframe ring buffer
(``SharedKeyframes`` :360-575).

All keyframe state lives in one :class:`KeyframeStore` of fixed-shape device
tensors owned by the host process. Unlike the JAX package (immutable arrays,
every write a new buffer), slot writes here are IN PLACE: a keyframe append
copies one slot, not the ~1.4 GB store at ViT-L width. The ring counters are
host ints (the host decides every append), so no append waits on the device.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from ..ops.lie import sim3_identity


class Mode(enum.Enum):
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


# ---------------------------------------------------------------------------
# pointmap fusion filters (frame.py:101-165)
# ---------------------------------------------------------------------------

def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over all elements with the JAX package's semantics: for an even
    count, the two middle values averaged as ``lo*0.5 + hi*0.5`` (jnp.median's
    linear quantile). ``torch.median`` would return the lower one."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    lo = s[(n - 1) // 2]
    hi = s[n // 2]
    return lo * 0.5 + hi * 0.5 if n % 2 == 0 else lo


def filtering_score(C: torch.Tensor, score_mode: str = "median") -> torch.Tensor:
    """Scalar confidence score of one observation (``Frame.get_score``,
    reference frame.py:93-99)."""
    if score_mode == "median":
        return _median(C)
    if score_mode == "mean":
        return torch.mean(C)
    raise ValueError(f"unknown filtering_score {score_mode}")


def update_pointmap(
    X_old: torch.Tensor,
    C_old: torch.Tensor,
    N: torch.Tensor,
    N_updates: torch.Tensor,
    X: torch.Tensor,
    C: torch.Tensor,
    mode: str = "weighted_pointmap",
    score_mode: str = "median",
):
    """Fuse a new pointmap observation into the canonical pointmap.

    ``N``/``N_updates`` are int32 0-d tensors, so no branch waits on the
    host. First observation (N_updates == 0) always initializes. Returns
    (X_new, C_new, N_new, N_updates_new).
    """
    first_obs = N_updates == 0
    one = torch.ones_like(N)

    if mode == "first":
        # the reference replaces on N_updates == 1 — it keeps the FIRST
        # post-init observation (frame.py:113-116)
        take_new = N_updates <= 1
        X_new = torch.where(take_new, X, X_old)
        C_new = torch.where(take_new, C, C_old)
        N_new = torch.where(take_new, one, N)
    elif mode == "recent":
        X_new, C_new = X, C
        N_new = one
    elif mode == "best_score":
        # replacement copies C wholesale, so the carried score always equals
        # get_score(stored C): recompute it instead of threading it through
        better = filtering_score(C, score_mode) > filtering_score(C_old, score_mode)
        take_new = first_obs | better
        X_new = torch.where(take_new, X, X_old)
        C_new = torch.where(take_new, C, C_old)
        N_new = torch.where(take_new, one, N)
    elif mode == "indep_conf":
        mask = C > C_old
        X_new = torch.where(first_obs, X, torch.where(mask, X, X_old))
        C_new = torch.where(first_obs, C, torch.where(mask, C, C_old))
        N_new = one
    elif mode == "weighted_pointmap":
        Xw = (C_old * X_old + C * X) / (C_old + C)
        X_new = torch.where(first_obs, X, Xw)
        C_new = torch.where(first_obs, C, C_old + C)
        N_new = torch.where(first_obs, one, N + 1)
    elif mode == "weighted_spherical":
        def to_sph(P):
            r = torch.linalg.norm(P, dim=-1, keepdim=True)
            x, y, z = P.split(1, dim=-1)
            return torch.cat([r, torch.atan2(y, x), torch.arccos(z / r)], dim=-1)

        def to_cart(s):
            r, phi, theta = s.split(1, dim=-1)
            st = torch.sin(theta)
            return torch.cat(
                [r * st * torch.cos(phi), r * st * torch.sin(phi), r * torch.cos(theta)], dim=-1
            )

        sph = (C_old * to_sph(X_old) + C * to_sph(X)) / (C_old + C)
        X_new = torch.where(first_obs, X, to_cart(sph))
        C_new = torch.where(first_obs, C, C_old + C)
        N_new = torch.where(first_obs, one, N + 1)
    else:
        raise ValueError(f"unknown filtering_mode {mode}")

    return X_new, C_new, N_new, N_updates + 1


# ---------------------------------------------------------------------------
# Frame
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Frame:
    """Per-frame state (frame.py:17-44), all device tensors."""

    frame_id: torch.Tensor  # int32 0-d
    img: torch.Tensor  # (1, H, W, 3) ImgNorm'd
    T_WC: torch.Tensor  # (8,) Sim3
    X_canon: torch.Tensor  # (HW, 3)
    C: torch.Tensor  # (HW, 1)
    feat: torch.Tensor  # (1, N_tok, enc_dim)
    pos: torch.Tensor  # (1, N_tok, 2)
    N: torch.Tensor  # int32 0-d
    N_updates: torch.Tensor  # int32 0-d

    def average_conf(self) -> torch.Tensor:
        """C / N (frame.py:167-168)."""
        return self.C / torch.clamp(self.N, min=1).to(self.C.dtype)


def make_empty_frame(frame_id, img, feat, pos, T_WC=None) -> Frame:
    hw = img.shape[1] * img.shape[2]
    dev = img.device
    return Frame(
        frame_id=torch.tensor(frame_id, dtype=torch.int32, device=dev),
        img=img,
        T_WC=sim3_identity(device=dev) if T_WC is None else T_WC,
        X_canon=torch.zeros((hw, 3), dtype=torch.float32, device=dev),
        C=torch.zeros((hw, 1), dtype=torch.float32, device=dev),
        feat=feat,
        pos=pos,
        N=torch.zeros((), dtype=torch.int32, device=dev),
        N_updates=torch.zeros((), dtype=torch.int32, device=dev),
    )


def where_frame(cond: torch.Tensor, a: Frame, b: Frame) -> Frame:
    """Field-wise ``torch.where(cond, a, b)`` over two frames (the device-side
    select of the JAX package's tree-mapped where)."""
    return Frame(**{f.name: torch.where(cond, getattr(a, f.name), getattr(b, f.name))
                    for f in dataclasses.fields(Frame)})


# ---------------------------------------------------------------------------
# Keyframe store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KeyframeStore:
    """Fixed-capacity keyframe ring buffer as device tensors.

    Mirrors ``SharedKeyframes`` (frame.py:360-575): capacity ``buffer``
    (default 300), slot index = n_total % buffer when full. ``n_size`` (live
    slots) and ``n_total`` (appends ever) are host ints.
    """

    frame_id: torch.Tensor  # (K,) int32
    T_WC: torch.Tensor  # (K, 8)
    X_canon: torch.Tensor  # (K, HW, 3)
    C: torch.Tensor  # (K, HW, 1)
    feat: torch.Tensor  # (K, N_tok, enc_dim)
    pos: torch.Tensor  # (N_tok, 2) shared grid positions
    N: torch.Tensor  # (K,) int32
    N_updates: torch.Tensor  # (K,) int32
    n_size: int = 0
    n_total: int = 0

    @property
    def capacity(self) -> int:
        return self.T_WC.shape[0]

    def slot_of(self, kf_index: int) -> int:
        """Map logical keyframe index (0..n_total-1) to a physical slot."""
        return kf_index % self.capacity

    def last_slot(self) -> int:
        return self.slot_of(self.n_total - 1)


def make_keyframe_store(capacity: int, hw: int, n_tok: int, enc_dim: int,
                        dtype=torch.float32, device="cpu") -> KeyframeStore:
    return KeyframeStore(
        frame_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        T_WC=sim3_identity(dtype=dtype, device=device).expand(capacity, 8).clone(),
        X_canon=torch.zeros((capacity, hw, 3), dtype=dtype, device=device),
        C=torch.zeros((capacity, hw, 1), dtype=dtype, device=device),
        feat=torch.zeros((capacity, n_tok, enc_dim), dtype=dtype, device=device),
        pos=torch.zeros((n_tok, 2), dtype=torch.int32, device=device),
        N=torch.zeros((capacity,), dtype=torch.int32, device=device),
        N_updates=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def kf_append(store: KeyframeStore, frame: Frame) -> KeyframeStore:
    """Append a frame as a keyframe in place (SharedKeyframes.append,
    frame.py:443-466); overwrites the oldest slot when full."""
    slot = store.slot_of(store.n_total)
    store.frame_id[slot] = frame.frame_id
    store.T_WC[slot] = frame.T_WC
    store.X_canon[slot] = frame.X_canon
    store.C[slot] = frame.C
    store.feat[slot] = frame.feat[0]
    store.pos.copy_(frame.pos[0])
    store.N[slot] = frame.N
    store.N_updates[slot] = frame.N_updates
    store.n_size = min(store.n_size + 1, store.capacity)
    store.n_total += 1
    return store


def kf_write_pointmap(store: KeyframeStore, slot: int, frame: Frame) -> KeyframeStore:
    """Write a keyframe's fused pointmap state back into its slot, in place."""
    store.X_canon[slot] = frame.X_canon
    store.C[slot] = frame.C
    store.N[slot] = frame.N
    store.N_updates[slot] = frame.N_updates
    return store


def kf_update_T_WCs(store: KeyframeStore, T_WCs: torch.Tensor, slots) -> KeyframeStore:
    """Write backend-optimized poses into their slots, in place
    (SharedKeyframes.update_T_WCs, frame.py:568-575)."""
    slots = torch.as_tensor(slots, dtype=torch.long, device=store.T_WC.device)
    store.T_WC[slots] = T_WCs.to(store.T_WC.dtype)
    return store


def kf_snapshot(store: KeyframeStore) -> KeyframeStore:
    """A copy of the store that later in-place writes to ``store`` do not
    reach: what the JAX package gets for free from immutable arrays, for a
    backend task that reads the store while the frontend writes it."""
    return dataclasses.replace(
        store, **{f.name: getattr(store, f.name).clone()
                  for f in dataclasses.fields(store) if isinstance(getattr(store, f.name), torch.Tensor)})


def kf_get_frame(store: KeyframeStore, slot: int) -> Frame:
    """Materialize one keyframe slot as a Frame view (no img)."""
    return Frame(
        frame_id=store.frame_id[slot],
        img=torch.zeros((1, 1, 1, 3), dtype=store.T_WC.dtype, device=store.T_WC.device),
        T_WC=store.T_WC[slot],
        X_canon=store.X_canon[slot],
        C=store.C[slot],
        feat=store.feat[slot][None],
        pos=store.pos[None],
        N=store.N[slot],
        N_updates=store.N_updates[slot],
    )
