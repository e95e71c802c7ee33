"""The kernel modules on their own (PyTorch and numpy only, no JAX, so the
card-only tests also run where JAX is not installed):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q   # on the card

The refine plain version is held against a scalar numpy transcription of the
reference kernel (matching_kernels.cu:25-85); on the card the Hopper kernel
is held against the plain version, bitwise. The ray-edge kernel is held
against its plain version in f64 (its plain version is held against the JAX
package in tests/test_torch_global_opt.py). The attention kernel is held
against its plain version within a bar of the output's largest magnitude
(its plain version is held against the JAX package in
tests/test_torch_attention.py).
"""

import numpy as np
import pytest
import torch

from frodo_slam_tpu_torch.ops import attention_kernel as ak
from frodo_slam_tpu_torch.ops import ba_reduce_kernel as brk
from frodo_slam_tpu_torch.ops import kernel_build
from frodo_slam_tpu_torch.ops import refine_kernel as rk

torch.set_num_threads(1)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def np_refine(D11, D21, p1, radius, dilation_max):
    """Scalar refine on one batch element; f32 sequential dot over channels.
    Returns (p_new, scores, in-image probe count)."""
    h, w, f = D11.shape
    n = p1.shape[0]
    p_new = np.zeros((n, 2), np.int32)
    scores = np.zeros(n, np.float32)
    probes = 0
    for k in range(n):
        u0, v0 = int(p1[k, 0]), int(p1[k, 1])
        best = np.float32(-np.inf)
        ub, vb = u0, v0
        for d in range(dilation_max, 0, -1):
            rd = radius * d
            for i in range(0, 2 * rd + 1, d):
                for j in range(0, 2 * rd + 1, d):
                    u, v = u0 - rd + i, v0 - rd + j
                    if 0 <= u < w and 0 <= v < h:
                        probes += 1
                        sc = np.float32(0.0)
                        for c in range(f):
                            sc = np.float32(sc + np.float32(D21[k, c] * D11[v, u, c]))
                        if sc > best:
                            best, ub, vb = sc, u, v
            u0, v0 = ub, vb
        p_new[k] = (ub, vb)
        scores[k] = best
    return p_new, scores, probes


def _inputs(seed, h, w, f=24, jitter=3, b=1):
    rng = np.random.default_rng(seed)
    D11 = rng.normal(size=(b, h, w, f)).astype(np.float32)
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    n = h * w
    D21 = (D11.reshape(b, n, f) + 0.05 * rng.normal(size=(b, n, f))).astype(np.float32)
    grid = np.stack([np.arange(n) % w, np.arange(n) // w], -1)[None].repeat(b, 0)
    p1 = np.clip(grid + rng.integers(-jitter, jitter + 1, size=grid.shape), 0, [w - 1, h - 1])
    return D11, D21, p1.astype(np.int32)


@pytest.mark.parametrize("radius,dilation_max,f", [(2, 3, 24), (3, 2, 8), (1, 1, 24)])
def test_refine_plain_matches_scalar_oracle(radius, dilation_max, f):
    """bf16 plain version == the scalar transcription on bf16-rounded inputs:
    indices exact, scores exact (same f32 operations in the same order)."""
    D11, D21, p1 = _inputs(radius * 10 + dilation_max, 9, 13, f)
    pt, st, nprobe = rk.refine_matches_plain(
        torch.from_numpy(D11), torch.from_numpy(D21), torch.from_numpy(p1),
        radius=radius, dilation_max=dilation_max, count_probes=True)
    po, so, no = np_refine(_bf16(D11[0]), _bf16(D21[0]), p1[0], radius, dilation_max)
    np.testing.assert_array_equal(pt.numpy()[0], po)
    np.testing.assert_array_equal(st.numpy()[0], so)
    assert int(nprobe) == no


def test_refine_plain_dilation_zero_is_identity():
    D11, D21, p1 = _inputs(3, 6, 7)
    pt, st = rk.refine_matches_plain(torch.from_numpy(D11), torch.from_numpy(D21),
                                     torch.from_numpy(p1), radius=3, dilation_max=0)
    np.testing.assert_array_equal(pt.numpy(), p1)
    assert np.isneginf(st.numpy()).all()


def test_library_path_tracks_source_and_flags():
    """The build cache key covers the source and the nvcc flags, so a stale
    library is never loaded after either changes."""
    path = rk.library_path()
    assert path.parent.name == "kernels" and path.parent.parent.name == "build"
    assert path.name.startswith("librefine_matches_") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in rk.NVCC_FLAGS
    assert "--use_fast_math" not in rk.NVCC_FLAGS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the refine kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("radius,dilation_max,jitter,b", [(3, 5, 20, 2), (2, 3, 1, 1), (3, 0, 4, 1)])
def test_refine_kernel_equals_plain_on_card(card, radius, dilation_max, jitter, b):
    """Kernel vs bf16 plain version on the card: bitwise equal indices and
    scores, one counted launch per call; border seeds and collisions included."""
    D11, D21, p1 = _inputs(7, 48, 64, jitter=jitter, b=b)
    args = tuple(torch.from_numpy(a).to(card) for a in (D11, D21, p1))
    before = rk.refine_matches.launches
    pk, sk = rk.refine_matches(*args, radius=radius, dilation_max=dilation_max)
    torch.cuda.synchronize()
    assert rk.refine_matches.launches == before + 1
    pp, sp = rk.refine_matches_plain(*args, radius=radius, dilation_max=dilation_max)
    assert pk.dtype == torch.int32 and sk.dtype == torch.float32
    assert torch.equal(pk, pp)
    assert torch.equal(sk, sp)


@pytest.mark.cuda
def test_refine_kernel_rejects_bad_inputs(card):
    D11, D21, p1 = (torch.from_numpy(a).to(card) for a in _inputs(8, 8, 8))
    with pytest.raises(ValueError):
        rk.refine_matches(D11[..., :8], D21[..., :8], p1)  # the kernel takes f = 24
    with pytest.raises(ValueError):
        rk.refine_matches(D11, D21, p1[:, :5])
    with pytest.raises(ValueError):
        rk.refine_matches(D11, D21.cpu(), p1)


# ---------------------------------------------------------------------------
# ray_edge_systems (the backend's ray-edge normal equations)
# ---------------------------------------------------------------------------

def _ray_inputs(seed, E, N, dtype=np.float32):
    """Per-edge relative Sim(3)s near identity, points around z = 5, weights
    in [0, 2) with a zeroed prefix and a fully masked last edge."""
    rng = np.random.default_rng(seed)
    scal = 0.3 * rng.normal(size=(E, 12))
    scal[:, [0, 4, 8]] += 1.0
    off = np.array([0.0, 0.0, 5.0])[None, :, None]
    XiT = rng.normal(size=(E, 3, N)) + off
    XjT = rng.normal(size=(E, 3, N)) + off
    w0 = rng.uniform(0, 2, size=(E, N))
    w0[:, : N // 10] = 0.0
    w0[-1] = 0.0
    return tuple(a.astype(dtype) for a in (scal, XiT, XjT, w0))


def test_ray_plain_masked_edge_is_exactly_zero():
    args = tuple(torch.from_numpy(a) for a in _ray_inputs(0, 3, 300))
    args[1][-1, :, :7] = 0.0  # all-zero pad points: guarded norms stay finite
    args[2][-1, :, :7] = 0.0
    B, g = brk.ray_edge_systems_plain(*args, sigma_ray=0.003, sigma_dist=10.0)
    assert torch.isfinite(B).all() and torch.isfinite(g).all()
    assert torch.count_nonzero(B[-1]) == 0 and torch.count_nonzero(g[-1]) == 0
    assert torch.equal(B, B.transpose(1, 2))


def test_ray_library_path_tracks_source():
    path = kernel_build.library_path(brk._SRC)
    assert path.name.startswith("libray_edge_systems_") and path.parent == kernel_build.BUILD_DIR
    assert rk.library_path().parent == path.parent


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-4), (np.float64, 1e-10)])
@pytest.mark.parametrize("E,N", [(5, 9000), (3, 4096), (2, 100)])
def test_ray_kernel_matches_plain_on_card(card, dtype, rel, E, N):
    """Kernel vs the f64 plain version: per edge, |dB| and |dg| within
    ``rel`` x that edge's largest entry (f32: a different summation order;
    f64: rounding only). Two calls are bitwise equal; one launch per call."""
    args = tuple(torch.from_numpy(a).to(card) for a in _ray_inputs(1, E, N, dtype))
    kw = dict(sigma_ray=0.003, sigma_dist=10.0)
    before = brk.ray_edge_systems.launches
    Bk, gk = brk.ray_edge_systems(*args, **kw)
    Bk2, gk2 = brk.ray_edge_systems(*args, **kw)
    torch.cuda.synchronize()
    assert brk.ray_edge_systems.launches == before + 2
    assert Bk.dtype == args[1].dtype
    assert torch.equal(Bk, Bk2) and torch.equal(gk, gk2)
    Bp, gp = brk.ray_edge_systems_plain(*(a.double() for a in args), **kw)
    for got, want in ((Bk.double(), Bp), (gk.double(), gp)):
        scale = want.reshape(E, -1).abs().amax(1).clamp(min=1e-30)
        err = (got - want).reshape(E, -1).abs().amax(1)
        assert (err <= rel * scale).all(), (err / scale).tolist()
    assert torch.count_nonzero(Bk[-1]) == 0 and torch.count_nonzero(gk[-1]) == 0


@pytest.mark.cuda
def test_ray_kernel_rejects_bad_inputs(card):
    args = [torch.from_numpy(a).to(card) for a in _ray_inputs(2, 2, 64)]
    kw = dict(sigma_ray=0.003, sigma_dist=10.0)
    with pytest.raises(ValueError):
        brk.ray_edge_systems(args[0], args[1], args[2][:, :, :10], args[3], **kw)
    with pytest.raises(ValueError):
        brk.ray_edge_systems(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        brk.ray_edge_systems(*(a.half() for a in args), **kw)


# (B, H, Nq, Nk, D): head dims 64 / 32 / 24, N in {48, 64, 100}, Nq != Nk,
# B*H > 1, and the encoder's and a ragged shape at ViT-L width
ATTN_SHAPES = [(2, 3, 48, 48, 64), (1, 4, 64, 100, 32), (2, 2, 100, 64, 24), (1, 2, 100, 100, 64),
               (3, 1, 48, 64, 32), (1, 16, 768, 768, 64), (1, 12, 700, 640, 64)]


def _attn_inputs(shape, seed):
    B, H, Nq, Nk, D = shape
    rng = np.random.default_rng(seed)
    return (2.0 * rng.normal(size=(B, H, Nq, D)).astype(np.float32),
            rng.normal(size=(B, H, Nk, D)).astype(np.float32),
            rng.normal(size=(B, H, Nk, D)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype,bar", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_attention_kernel_matches_plain_on_card(card, shape, dtype, bar):
    """Kernel vs plain version on the card, within ``bar`` x the output's
    largest magnitude (bf16: P and the output rounded at other places; f32:
    summation order); one counted launch per call."""
    q, k, v = (torch.from_numpy(a).to(card, dtype) for a in _attn_inputs(shape, 1))
    before = ak.flash_attention.launches
    got = ak.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ak.flash_attention.launches == before + 1 and got.dtype == dtype
    want = ak.flash_attention_plain(q, k, v)
    scale = max(float(want.float().abs().max()), 1.0)
    assert float((got.float() - want.float()).abs().max()) <= bar * scale


@pytest.mark.cuda
def test_attention_kernel_takes_strided_views_and_rejects_bad_inputs(card):
    """The qkv projection's strided views go in without a copy and give the
    contiguous result; bad types, shapes and head dims raise."""
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16) for a in _attn_inputs((2, 3, 48, 48, 64), 2))
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)  # (B, N, 3, H, D)
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    torch.testing.assert_close(ak.flash_attention(*views), ak.flash_attention(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ak.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        ak.flash_attention(q, k[:, :, :10], v)
    big = torch.zeros((1, 1, 8, 136), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ak.flash_attention(big, big, big)
