"""What the kernels' wrappers decide on the host, checked on the CPU.

- The attention wrapper's TMA plan (``attention_kernel.tma_plan``) on every
  view the model hands the kernel: the qkv split, the cross-attention
  projections, the RoPE outputs, at ViT-L widths (encoder 16 x 64, decoder
  12 x 64), batch 1 and the backend's 2 and 4, and the tiny configurations'
  heads (32 and 24). Each is readable in place (16-byte aligned base,
  16-byte multiple strides) or, where it is not, goes through the padded
  copy, whose plan is legal and whose view holds the same values.
- The refine kernel's tile plan (``refine_kernel.refine_tile_plan``): the
  query grid's width for n = h * w and for other n, and the CTA grid
  covering every query once (the kernel's index arithmetic, replayed in
  numpy); the CTA size agrees with the CUDA source's.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from frodo_slam_tpu_torch.models import layers
from frodo_slam_tpu_torch.ops import attention_kernel as ak
from frodo_slam_tpu_torch.ops import refine_kernel as rk

torch.set_num_threads(1)

CSRC = pathlib.Path(rk.__file__).resolve().parents[1] / "csrc"


def _legal(plan, t):
    """The plan describes ``t`` and TMA can read it: dims (D, N, H, B),
    16-byte multiple strides below 2^40, 16-byte aligned base."""
    B, H, N, D = t.shape
    assert plan["dims"] == (D, N, H, B)
    assert t.data_ptr() % 16 == 0
    for size, st, own in zip((N, H, B), plan["strides"], (t.stride(2), t.stride(1), t.stride(0))):
        nbytes = st * t.element_size()
        assert nbytes > 0 and nbytes % 16 == 0 and nbytes < 1 << 40
        if size > 1:
            assert st == own  # a stepped dimension keeps the view's own stride


def _record_views(module, *inputs):
    """Run ``module`` on the CPU and return the (q, k, v) it passed to the
    attention kernel."""
    seen = []
    real = layers.flash_attention

    def spy(q, k, v):
        seen.append((q, k, v))
        return real(q, k, v)

    layers.flash_attention = spy
    try:
        with torch.no_grad():
            module(*inputs)
    finally:
        layers.flash_attention = real
    assert len(seen) == 1
    return seen[0]


def _pos(b, n):
    gw = 32
    idx = torch.arange(n)
    return torch.stack([idx // gw, idx % gw], -1)[None].expand(b, n, 2)


# (width, heads, tokens, batch): the ViT-L encoder (16 x 64) at 512x384 and
# 288x512, the decoder (12 x 64) at both and in the backend's batches of 2
# and 4, and the tiny configurations' encoder (2 x 32) and decoder (2 x 24)
VIEW_CASES = [(1024, 16, 768, 1), (1024, 16, 576, 1), (768, 12, 768, 1), (768, 12, 576, 1),
              (768, 12, 768, 2), (768, 12, 768, 4), (64, 2, 8, 1), (48, 2, 8, 2)]


@pytest.mark.parametrize("rope", [None, 100.0], ids=["no_rope", "rope"])
@pytest.mark.parametrize("dim,heads,n,b", VIEW_CASES, ids=lambda x: str(x))
def test_self_attention_views_are_read_in_place(dim, heads, n, b, rope):
    """The qkv split (q, k, v strided into one (B, N, 3, H, D) buffer) and
    the RoPE outputs (contiguous) need no copy."""
    attn = layers.Attention(dim, heads, rope).to(torch.bfloat16)
    x = torch.randn((b, n, dim), dtype=torch.bfloat16)
    q, k, v = _record_views(attn, x, _pos(b, n))
    for t in (q, k, v):
        plan = ak.tma_plan(t.shape, t.stride(), t.data_ptr(), t.element_size())
        assert plan is not None, (t.shape, t.stride())
        _legal(plan, t)
    # v is always the strided split, never a copy
    assert v.stride(2) == 3 * dim and v.stride(1) == dim // heads


@pytest.mark.parametrize("rope", [None, 100.0], ids=["no_rope", "rope"])
@pytest.mark.parametrize("dim,heads,n,b", VIEW_CASES, ids=lambda x: str(x))
def test_cross_attention_views_are_read_in_place(dim, heads, n, b, rope):
    """The cross-attention projections ((B, N, H, D) transposed views) and
    their RoPE outputs need no copy; Nq may differ from Nk."""
    attn = layers.CrossAttention(dim, heads, rope).to(torch.bfloat16)
    nk = n + 64
    q_in = torch.randn((b, n, dim), dtype=torch.bfloat16)
    kv_in = torch.randn((b, nk, dim), dtype=torch.bfloat16)
    q, k, v = _record_views(attn, q_in, kv_in, kv_in, _pos(b, n), _pos(b, nk))
    assert q.shape[2] == n and k.shape[2] == nk
    for t in (q, k, v):
        plan = ak.tma_plan(t.shape, t.stride(), t.data_ptr(), t.element_size())
        assert plan is not None, (t.shape, t.stride())
        _legal(plan, t)


@pytest.mark.parametrize("case", ["odd_head_dim", "misaligned_base", "odd_token_stride"])
def test_views_tma_cannot_read_take_a_padded_copy(case):
    """Where the base or a stride is not TMA-legal the plan says so, and the
    padded copy is legal and holds the same values."""
    if case == "odd_head_dim":  # 20 bf16 = 40-byte rows
        t = torch.randn((1, 2, 50, 20)).bfloat16()
    elif case == "misaligned_base":
        t = torch.randn((1, 2, 50 * 64 + 1)).bfloat16()[:, :, 1:].reshape(1, 2, 50, 64)
    else:  # tokens 68 elements = 136 bytes apart
        t = torch.randn((1, 2, 50, 68)).bfloat16()[..., :64]
    assert ak.tma_plan(t.shape, t.stride(), t.data_ptr(), t.element_size()) is None
    copy, plan = ak._tma_operand(t)
    assert plan is not None
    _legal(plan, copy)
    assert torch.equal(copy, t)


def test_size_one_dims_get_legal_strides():
    """A dimension of size 1 is never stepped: whatever stride the view
    carries there (here 1 element, from an expand), the plan's is legal."""
    t = torch.randn((1, 1, 40, 64)).bfloat16().as_strided((1, 1, 40, 64), (1, 1, 64, 1))
    plan = ak.tma_plan(t.shape, t.stride(), t.data_ptr(), t.element_size())
    _legal(plan, t)


def test_head_dim_limit_matches_the_kernel():
    """The wrapper's head-dim limit is the kernel's: two 64-wide halves."""
    src = (CSRC / "flash_attention.cu").read_text()
    assert ak.MAX_HEAD_DIM == 128
    assert "if (D < 1 || D > 128) return 1;" in src
    assert "launch_bf16<1, 3>" in src and "launch_bf16<2, 2>" in src


# ---------------------------------------------------------------------------
# refine tiles
# ---------------------------------------------------------------------------

def _constant(name):
    src = (CSRC / "refine_matches.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_refine_constants_match_the_source():
    """The tile plan's CTA size is the kernel's."""
    assert rk.TILE_THREADS == _constant("kThreads")


def _queries_of(h, w, n):
    """Replay the kernel's thread -> query mapping over the plan's grid."""
    plan = rk.refine_tile_plan(h, w, n)
    gx, gy = plan["grid"]
    tw, th = plan["tile_w"], plan["tile_h"]
    assert tw * th == rk.TILE_THREADS
    tid = np.arange(rk.TILE_THREADS)
    seen = []
    for by in range(gy):
        for bx in range(gx):
            x = bx * tw + tid % tw
            y = by * th + tid // tw
            k = y * plan["gw"] + x
            seen.append(k[(x < plan["gw"]) & (k < n)])
    return plan, np.concatenate(seen)


@pytest.mark.parametrize("h,w", [(384, 512), (288, 512), (96, 128), (48, 64), (40, 72), (7, 13)])
def test_refine_tiles_follow_the_raster_when_n_is_hw(h, w):
    plan, ks = _queries_of(h, w, h * w)
    assert plan["gw"] == w and (plan["tile_w"], plan["tile_h"]) == (32, 12)
    assert np.array_equal(np.sort(ks), np.arange(h * w))


@pytest.mark.parametrize("h,w,n", [(48, 64, 1000), (48, 64, 1), (9, 13, 100), (384, 512, 5000)])
def test_refine_tiles_are_1d_otherwise(h, w, n):
    plan, ks = _queries_of(h, w, n)
    assert plan["gw"] == n and (plan["tile_w"], plan["tile_h"]) == (rk.TILE_THREADS, 1)
    assert np.array_equal(np.sort(ks), np.arange(n))
