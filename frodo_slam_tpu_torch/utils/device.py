"""Device selection and the f32 numerics contract of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points run on ``cuda`` unless the
    caller asks for the CPU. No card and no explicit device raises instead
    of falling back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path"
            )
        device = "cuda"
    return torch.device(device)


def indexed(device) -> torch.device:
    """``device`` with its card's index (an unindexed "cuda" is the current
    card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def set_f32_contract() -> None:
    """The f32 heads are the reference contract (config ``tpu.head_dtype``).
    A float32 matmul already runs in full f32 on the card, but cuDNN runs
    float32 convolutions (the DPT head) in TF32 unless told not to: turn
    both off so f32 means f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
