"""Image preprocessing: the reference's exact resize/crop/normalize recipe.

Spec: ``mast3r_slam/mast3r_utils.py:369-460`` (``_resize_pil_image`` /
``resize_img``) and ImgNorm = Normalize(mean=0.5, std=0.5)
(``dust3r/utils/image.py:23``). Host-side numpy, identical to the JAX
package's copy; the dataset loaders, ``Intrinsics``, ``data/prefetch.py``
and the tools take it. A frame that ``SLAM`` resizes goes to the card as it
is and takes the device path, ``ops/resample_kernel.py`` (PIL's resampler as
a CUDA kernel, and its plain twin on CPU tensors), bitwise equal to
:func:`resize_img`; both take their geometry from :func:`resize_geometry`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import PIL.Image


class ImgNormStats(NamedTuple):
    mean: float = 0.5
    std: float = 0.5


class Geometry(NamedTuple):
    """What :func:`resize_img` does to a (H1, W1) image: resize to
    ``size_wh`` with Lanczos (``lanczos``, when shrinking) or bicubic, then
    crop the box ``crop`` (left, top, right, bottom) of the resized image."""
    size_wh: Tuple[int, int]
    lanczos: bool
    crop: Tuple[int, int, int, int]


def resize_geometry(H1: int, W1: int, size: int = 512, square_ok: bool = False) -> Geometry:
    """The resize and the crop :func:`resize_img` applies to a (H1, W1)
    image (``mast3r_utils.py:369-460``, with ``_resize_pil_image``)."""
    if not (size == 224 or size % 16 == 0):
        raise ValueError(f"resize_img: size {size} must be 224 or a multiple of 16")
    long_edge = round(size * max(W1 / H1, H1 / W1)) if size == 224 else size
    S = max(W1, H1)
    W, H = (int(round(x * long_edge / S)) for x in (W1, H1))
    cx, cy = W // 2, H // 2
    if size == 224:
        half = min(cx, cy)
        crop = (cx - half, cy - half, cx + half, cy + half)
    else:
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if not square_ok and W == H:
            halfh = int(3 * halfw / 4)
        crop = (cx - halfw, cy - halfh, cx + halfw, cy + halfh)
    return Geometry((W, H), S > long_edge, crop)


def resize_img(img: np.ndarray, size: int = 512, square_ok: bool = False,
               return_transformation: bool = False):
    """Resize long edge to ``size``, center-crop to multiples of 16, ImgNorm.

    ``img``: float array (H, W, 3) in [0, 1]. Returns dict with
    - ``img``: (1, H', W', 3) float32 normalized (channel-last)
    - ``true_shape``: (1, 2) int32 [H', W']
    - ``unnormalized_img``: (H', W', 3) uint8
    and optionally the (scale_w, scale_h, half_crop_w, half_crop_h) transform
    used by Intrinsics rescaling (mast3r_utils.py:448-455).
    """
    # 224 keeps the reference's square-crop special case; any other size
    # follows the 512-long-edge path (sizes below 512 are used by tests)
    H1, W1 = img.shape[:2]
    geo = resize_geometry(H1, W1, size, square_ok)
    pil = PIL.Image.fromarray(np.uint8(img * 255))
    pil = pil.resize(geo.size_wh, PIL.Image.LANCZOS if geo.lanczos else PIL.Image.BICUBIC)
    W, H = pil.size
    pil = pil.crop(geo.crop)

    arr = np.asarray(pil)
    normed = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
    res = dict(
        img=normed[None],  # (1, H', W', 3)
        true_shape=np.int32([pil.size[::-1]]),
        unnormalized_img=arr,
    )
    if return_transformation:
        scale_w = W1 / W
        scale_h = H1 / H
        half_crop_w = (W - pil.size[0]) / 2
        half_crop_h = (H - pil.size[1]) / 2
        return res, (scale_w, scale_h, half_crop_w, half_crop_h)
    return res
