"""A frame's resize, crop and ImgNorm on the device: the plain twin and the kernel.

On the CPU: the plain twin (``resample_kernel.resize_normalize_plain``) is
bitwise PIL's resize as ``data/image.py`` ``resize_img`` runs it (Lanczos on
480x640 -> 384x512, 360x640 -> 288x512, 720x1280 -> 288x512 and a portrait
640x480 -> 512x384; bicubic on the upscale 240x320 -> 384x512), on random
bytes, all 0, all 255 and a one-pixel checkerboard; an axis that keeps its
size takes PIL's skipped pass; the quantisation ``np.uint8(img * 255)`` and
ImgNorm over all 256 values; ``system.preprocess_to_device`` on the CPU is
bitwise ``preprocess_image``, for landscape and portrait frames, f32 and f64
frames and frames at the network shape, and two different frames in a row
each get their own output.

On the card (``-m cuda``; no JAX imported, so it runs where JAX is not
installed):

    python -m pytest --noconftest -m cuda tests/test_torch_resample.py -q

the kernel is bitwise equal to the twin on those frames, in two counted
launches, on f32 and uint8 input, and two frames uploaded through pinned
memory back to back, behind a busy card, each get their own output.
"""

import numpy as np
import PIL.Image
import pytest
import torch

from frodo_slam_tpu_torch.data.image import resize_img
from frodo_slam_tpu_torch.ops import resample_kernel as rk
from frodo_slam_tpu_torch.slam.system import preprocess_image, preprocess_to_device
from frodo_slam_tpu_torch.tools import kernel_cases

torch.set_num_threads(1)

CPU = torch.device("cpu")
# (frame h, w): the downscales, the bicubic upscale, a portrait frame
SHAPES = list(kernel_cases.RESAMPLE_SHAPES) + [(240, 320), (640, 480)]


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _same(a, b):
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kind", kernel_cases.RESAMPLE_KINDS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_twin_is_pils_resize(hw, kind):
    """The twin's network input is ``resize_img``'s, bit for bit."""
    frame = kernel_cases.resample_frame(*hw, kind, sum(hw), CPU)
    want = resize_img(frame.numpy(), 512)["img"]
    p = rk.plan(hw, 512)
    assert p.filt == (rk.BICUBIC if max(hw) < 512 else rk.LANCZOS)
    got = rk.resize_normalize(frame, 512)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert _same(got, want)


def test_one_axis_keeps_its_size():
    """PIL skips the pass of an axis that keeps its size; the identity table
    gives the same bytes (here the height stays, the width shrinks)."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 256, (37, 50, 3), dtype=np.uint8)
    want = np.asarray(PIL.Image.fromarray(u).resize((20, 37), PIL.Image.LANCZOS))
    bounds, kk = rk.coeffs(37, 37, rk.LANCZOS)
    assert (bounds[:, 1] == 1).all() and (kk == 1 << rk.PRECISION_BITS).all()
    p = rk.Plan((37, 20), (0, 0), (37, 20), rk.LANCZOS, (0, 37))
    got = rk.resize_normalize_plain(torch.from_numpy(u), p)
    assert _same(got[0], (want.astype(np.float32) / 255.0 - 0.5) / 0.5)


def test_quantise_and_normalise_every_value():
    """``np.uint8(x * 255)`` of f32 frames (each u / 255, and values just
    below and above it) and ImgNorm of every byte, bit for bit."""
    u = np.arange(256, dtype=np.float32)
    for x in (u / 255.0, np.nextafter(u / 255.0, np.float32(0)), np.nextafter(u / 255.0, np.float32(1)),
              (u + 0.5) / 255.0, np.random.default_rng(0).random(4096, dtype=np.float32)):
        x = np.clip(x, 0, 1).astype(np.float32)
        assert np.array_equal(rk.quantise_plain(torch.from_numpy(x)).numpy(), np.uint8(x * 255))
    b = np.arange(256, dtype=np.uint8)
    assert _same(rk.normalize_plain(torch.from_numpy(b)), (b.astype(np.float32) / 255.0 - 0.5) / 0.5)


# (frame h, w, SLAM's img_hw as the runner hands it, dtype): landscape and
# portrait frames resized, an f64 frame (quantised on the host), frames at
# the network shape in either layout (the host branch)
DEVICE_CASES = [((480, 640), (384, 512), np.float32), ((640, 480), (512, 384), np.float32),
                ((360, 640), (288, 512), np.float64), ((240, 320), (384, 512), np.float32),
                ((384, 512), (384, 512), np.float32), ((512, 384), (512, 384), np.float32),
                ((384, 512), (512, 384), np.float32)]


@pytest.mark.parametrize("case", DEVICE_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1][0]}x{c[1][1]}-"
                                                            f"{np.dtype(c[2]).name}")
def test_preprocess_to_device_is_preprocess_image(case):
    """``SLAM``'s device path on the CPU (the twin) against the host path."""
    (fh, fw), img_hw, dtype = case
    frame = kernel_cases.resample_frame(fh, fw, "random", fh + fw, CPU).numpy().astype(dtype)
    portrait = img_hw[0] > img_hw[1]
    store_hw = img_hw[::-1] if portrait else img_hw  # SLAM.img_hw: the landscape storage shape
    want = preprocess_image(frame, store_hw, portrait)
    got = preprocess_to_device(frame, store_hw, portrait, CPU)
    assert got.shape == (1, *store_hw, 3)
    assert _same(got, want)


def test_consecutive_frames_get_their_own_output():
    """Two different frames in a row: each output is its own frame's, and
    the second call leaves the first output as it was."""
    a = kernel_cases.resample_frame(480, 640, "random", 1, CPU).numpy()
    b = kernel_cases.resample_frame(480, 640, "checker", 2, CPU).numpy()
    out_a = preprocess_to_device(a, (384, 512), False, CPU)
    kept = out_a.clone()
    out_b = preprocess_to_device(b, (384, 512), False, CPU)
    assert out_a.data_ptr() != out_b.data_ptr()
    assert torch.equal(out_a, kept) and not torch.equal(out_a, out_b)
    assert _same(out_a, preprocess_image(a, (384, 512), False))
    assert _same(out_b, preprocess_image(b, (384, 512), False))


def test_no_kernel_off_cpu_and_cuda():
    frame = torch.zeros((480, 640, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        rk.resize_normalize(frame, 512)
    with pytest.raises(ValueError, match="not f32 or uint8"):
        rk.resize_normalize(torch.zeros((480, 640, 3), dtype=torch.float64), 512)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the resample kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kernel_cases.RESAMPLE_KINDS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_kernel_equals_twin_on_card(card, hw, kind):
    """Bitwise the twin's output, in two counted launches, from f32 and from
    uint8 frames, landscape and transposed."""
    frame = kernel_cases.resample_frame(*hw, kind, sum(hw), CPU)
    for src in (frame, rk.quantise_plain(frame)):
        for transpose in (False, True):
            want = rk.resize_normalize(src, 512, transpose)
            before = rk.resample.launches
            got = rk.resize_normalize(src.to(card), 512, transpose)
            torch.cuda.synchronize()
            assert rk.resample.launches == before + 2
            assert _same(got.cpu(), want)


@pytest.mark.cuda
def test_quantise_and_normalise_every_value_on_card(card):
    """Every f32 u / 255 (and its neighbours) through a frame of one row:
    the kernel's bytes and ImgNorm are the twin's."""
    u = np.arange(256, dtype=np.float32)
    x = np.stack([u / 255.0, np.nextafter(u / 255.0, np.float32(0)), np.nextafter(u / 255.0, np.float32(1))], -1)
    frame = torch.from_numpy(np.clip(x, 0, 1).astype(np.float32)[None].repeat(2, 0).copy())  # (2, 256, 3)
    p = rk.Plan((2, 256), (0, 0), (2, 256), rk.LANCZOS, (0, 2))  # identity on both axes
    want = rk.resize_normalize_plain(frame, p)
    assert _same(want[0, 0], (np.uint8(frame[0].numpy() * 255).astype(np.float32) / 255.0 - 0.5) / 0.5)
    got = rk.resample(frame.to(card), p)
    assert _same(got.cpu(), want)


@pytest.mark.cuda
def test_two_frames_in_flight_on_card(card):
    """Two different frames uploaded through pinned memory and resized back
    to back while the card is still busy: each output is its own frame's."""
    a = kernel_cases.resample_frame(480, 640, "random", 11, CPU).numpy()
    b = kernel_cases.resample_frame(480, 640, "random", 12, CPU).numpy()
    want_a = preprocess_image(a, (384, 512), False)
    want_b = preprocess_image(b, (384, 512), False)
    preprocess_to_device(a, (384, 512), False, card)  # tables and pinned blocks made
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))  # the copies below wait behind ~50 ms of work
    out_a = preprocess_to_device(a, (384, 512), False, card)
    out_b = preprocess_to_device(b, (384, 512), False, card)
    a[:] = 0  # the caller's arrays may change once the call returns
    b[:] = 0
    torch.cuda.synchronize()
    assert _same(out_a.cpu(), want_a) and _same(out_b.cpu(), want_b)
