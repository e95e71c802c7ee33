"""The kernel modules on their own (PyTorch and numpy only, no JAX, so the
card-only tests also run where JAX is not installed):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q   # on the card

The refine plain version is held against a scalar numpy transcription of the
reference kernel (matching_kernels.cu:25-85); on the card the Hopper kernel
is held against the plain version, bitwise, on random and smooth-warp seeds,
tiles at the border, tiles whose seeds spread apart, two batch elements,
1-D tiles, radius 1-3 and dilation 0-5. The ray-edge kernel is held
against its plain version in f64 on the window cases of
tools/kernel_cases.py, N off the tile, zero live rows, P = 1 and stale
inactive rows (its plain version is held against the JAX package in
tests/test_torch_global_opt.py). The calibrated edge kernel is held
against its plain version in f32 and f64 on the window buckets of
tools/kernel_cases.py at 384x512 and at an odd N, with masked points of
every kind, stale inactive rows and a window with no live row (its plain
version is held against the JAX package in tests/test_torch_calib.py).
The attention kernel is held
against its plain version within a bar of the output's largest magnitude
(its plain version is held against the JAX package in
tests/test_torch_attention.py).
"""

import numpy as np
import pytest
import torch

from frodo_slam_tpu_torch.ops import attention_kernel as ak
from frodo_slam_tpu_torch.ops import ba_reduce_kernel as brk
from frodo_slam_tpu_torch.ops import calib_edge_kernel as cek
from frodo_slam_tpu_torch.ops import kernel_build
from frodo_slam_tpu_torch.ops import refine_kernel as rk
from frodo_slam_tpu_torch.tools import kernel_cases

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


@pytest.mark.parametrize("h,w", [(24, 32), (48, 64)])
@pytest.mark.parametrize("case", kernel_cases.REFINE_CASES)
def test_refine_cases_are_what_they_say(case, h, w):
    """The seeded cases that chip_smoke, kernel_ab and the card tests run:
    the kernel's shapes and types, unit descriptors, in-image seeds, the
    same case from the same seed; identity_pm20's seeds within 20 px of
    their own pixel, collisions' on a 4-pixel lattice (16 queries a seed),
    smooth_warp's within 2 px of a 1 degree, 1% scale, (3, -2) px warp of
    it (plus rounding)."""
    D11, D21, p1 = kernel_cases.refine_case(case, h, w, 3, "cpu")
    n = h * w
    assert D11.shape == (1, h, w, 24) and D21.shape == (1, n, 24) and p1.shape == (1, n, 2)
    assert p1.dtype == torch.int32
    torch.testing.assert_close(D11.norm(dim=-1), torch.ones(1, h, w))
    assert (p1 >= 0).all() and (p1[..., 0] < w).all() and (p1[..., 1] < h).all()
    for a, b in zip((D11, D21, p1), kernel_cases.refine_case(case, h, w, 3, "cpu")):
        assert torch.equal(a, b)
    grid = np.stack([np.arange(n) % w, np.arange(n) // w], -1)
    off = np.abs(p1[0].numpy() - grid).max(-1)
    if case == "identity_pm20":
        assert off.max() <= 20 and off.max() > 10
    elif case == "collisions":
        assert (p1 % 4 == 0).all() and off.max() <= 3
        assert torch.unique(p1[0, :, 1] * w + p1[0, :, 0]).numel() == n // 16
    else:
        warp = np.hypot(w / 2, h / 2) * abs(1.01 * np.exp(1j * np.radians(1.0)) - 1)
        assert off.max() <= warp + 3 + 2 + 1


@pytest.mark.parametrize("h,w", [(24, 32), (48, 64)])
def test_smooth_warp_is_solved_by_the_refine(h, w):
    """smooth_warp stands in for the LM projection of a rigid scene: from
    its seeds the refine reaches each query's true match (a score near 1,
    the seeds' own near 0.9) for nearly every query."""
    D11, D21, p1 = kernel_cases.refine_case("smooth_warp", h, w, 0, "cpu")
    _, scores = rk.refine_matches_plain(D11, D21, p1, radius=3, dilation_max=5)
    lin = (p1[0, :, 1] * w + p1[0, :, 0]).long()
    at_seed = (D11.reshape(-1, 24)[lin].bfloat16().float() * D21[0].bfloat16().float()).sum(-1)
    assert float(at_seed.median()) < 0.95
    assert float(scores.median()) > 0.99 and float((scores > 0.9).float().mean()) > 0.95


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


def _smooth_inputs(card, seed, h, w, b=1, far_every=0):
    """Smooth-warp refine inputs (``kernel_cases.refine_case``): ``b`` of
    them (seeds ``seed``, ``seed + 1``, ...) stacked into one batch.
    ``far_every``: every such query's seed also moves 40 px right and down
    (clipped to the image), so a tile's queries probe windows far apart."""
    cases = [kernel_cases.refine_case("smooth_warp", h, w, seed + i, card) for i in range(b)]
    D11, D21, p1 = (torch.cat(x) for x in zip(*cases))
    if far_every:
        p1[:, ::far_every] += 40
        p1 = torch.minimum(p1, torch.tensor([w - 1, h - 1], dtype=p1.dtype, device=card))
    return D11, D21, p1


def _refine_on_card(D11, D21, p1, radius, dilation_max):
    """Kernel vs bf16 plain version: bitwise, one counted launch."""
    before = rk.refine_matches.launches
    pk, sk = rk.refine_matches(D11, D21, p1, radius=radius, dilation_max=dilation_max)
    torch.cuda.synchronize()
    assert rk.refine_matches.launches == before + 1
    pp, sp = rk.refine_matches_plain(D11, D21, p1, radius=radius, dilation_max=dilation_max)
    assert torch.equal(pk, pp)
    assert torch.equal(sk, sp)
    return pk


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(96, 128), (384, 512)])
def test_refine_kernel_smooth_warp_on_card(card, h, w):
    """The main path's kind of seeds: bitwise equal."""
    _refine_on_card(*_smooth_inputs(card, 11, h, w), 3, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["border", "spread", "batch2", "one_d"])
def test_refine_kernel_tiles_on_card(card, case):
    """Tiles at the image border (seeds pushed onto the edges), tiles whose
    seeds spread apart (every third seed 40 px away), two batch elements,
    and 1-D tiles (n != h * w): all bitwise equal."""
    h, w = 80, 104
    if case == "border":
        D11, D21, p1 = _smooth_inputs(card, 12, h, w)
        p1[0, ::2, 0] = torch.where(p1[0, ::2, 0] < w // 2, 0, w - 1).to(p1.dtype)
        p1[0, 1::2, 1] = torch.where(p1[0, 1::2, 1] < h // 2, 0, h - 1).to(p1.dtype)
    elif case == "spread":
        D11, D21, p1 = _smooth_inputs(card, 13, h, w, far_every=3)
    elif case == "batch2":
        D11, D21, p1 = _smooth_inputs(card, 14, h, w, b=2)
    else:
        D11, D21, p1 = _smooth_inputs(card, 15, h, w)
        D21, p1 = D21[:, :3001], p1[:, :3001]
    _refine_on_card(D11, D21, p1, 3, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("dilation_max", [0, 1, 2, 3, 4, 5])
def test_refine_kernel_radius_and_dilation_on_card(card, radius, dilation_max):
    _refine_on_card(*_smooth_inputs(card, 20 + radius, 40, 72), radius, dilation_max)


@pytest.mark.cuda
def test_refine_kernel_rejects_bad_inputs(card):
    D11, D21, p1 = (torch.from_numpy(a).to(card) for a in _inputs(8, 8, 8))
    with pytest.raises(ValueError):
        rk.refine_matches(D11[..., :8], D21[..., :8], p1)  # the kernel takes f = 24
    with pytest.raises(ValueError):
        rk.refine_matches(D11, D21, p1[:, :5])
    with pytest.raises(ValueError):
        rk.refine_matches(D11, D21.cpu(), p1)
    with pytest.raises(ValueError):
        rk.refine_matches(D11, D21, p1, radius=4)  # the radius is a template: 0..3


# ---------------------------------------------------------------------------
# ray_edge_systems (the backend's ray-edge normal equations)
# ---------------------------------------------------------------------------

RAY_KW = dict(sigma_ray=0.003, sigma_dist=10.0)


def _ray_inputs(seed, E, N, P=4, dtype=np.float32, n_live=None):
    """Per-edge relative Sim(3)s near identity, pointmaps X (P, N, 3) around
    z = 5, Xi near X[jj], weights in [0, 2) with a zeroed prefix; the last
    live row fully masked; rows from ``n_live`` on inactive, with stale
    nonzero data. Returns (scal, XiT, w0, X, jj, active)."""
    rng = np.random.default_rng(seed)
    n_live = E if n_live is None else n_live
    scal = 0.3 * rng.normal(size=(E, 12))
    scal[:, [0, 4, 8]] += 1.0
    X = rng.normal(size=(P, N, 3))
    X[..., 2] += 5.0
    jj = (np.arange(E) * 3 + 1) % P  # repeats once E > P
    XiT = np.swapaxes(X[jj], 1, 2) + 0.05 * rng.normal(size=(E, 3, N))
    w0 = rng.uniform(0, 2, size=(E, N))
    w0[:, : N // 10] = 0.0
    if n_live:
        w0[n_live - 1] = 0.0
    active = np.arange(E) < n_live
    return (*(torch.from_numpy(a.astype(dtype)) for a in (scal, XiT, w0, X)),
            torch.from_numpy(jj.astype(np.int32)), torch.from_numpy(active))


def test_ray_plain_masked_edge_is_exactly_zero():
    """A live row with zero weights and all-zero pad points, and an inactive
    row holding NaNs and a jj outside the window: both exactly 0, the rest
    finite and B symmetric."""
    scal, XiT, w0, X, jj, active = _ray_inputs(0, 4, 300, n_live=3)
    XiT[2, :, :7] = 0.0  # all-zero pad points: guarded norms stay finite
    X[jj[2], :7] = 0.0
    XiT[3] = float("nan")
    jj[3] = 99
    B, g = brk.ray_edge_systems_plain(scal, XiT, w0, X, jj, active, **RAY_KW)
    assert torch.isfinite(B).all() and torch.isfinite(g).all()
    for e in (2, 3):
        assert torch.count_nonzero(B[e]) == 0 and torch.count_nonzero(g[e]) == 0
    assert torch.count_nonzero(B[0]) > 0
    assert torch.equal(B, B.transpose(1, 2))


def test_ray_plain_reads_xj_through_jj():
    """Row e of the plain version is the system of X[jj[e]]: the same as a
    one-frame call with that frame alone (f64: only the batching differs)."""
    scal, XiT, w0, X, jj, active = _ray_inputs(1, 6, 200, P=3, dtype=np.float64)
    B, g = brk.ray_edge_systems_plain(scal, XiT, w0, X, jj, active, **RAY_KW)
    for e in range(6):
        sl = slice(e, e + 1)
        Be, ge = brk.ray_edge_systems_plain(scal[sl], XiT[sl], w0[sl], X[jj[sl].long()],
                                            torch.zeros(1, dtype=torch.int32), active[sl], **RAY_KW)
        torch.testing.assert_close(B[e], Be[0], rtol=1e-12, atol=0)
        torch.testing.assert_close(g[e], ge[0], rtol=1e-12, atol=0)


@pytest.mark.parametrize("N,n_active,slots,itemsize", [
    (147456, 8, 264, 4), (147456, 16, 264, 4), (147456, 22, 264, 4), (147456, 512, 264, 4),
    (147456, 32, 132, 8), (9000, 1, 264, 4), (100, 3, 264, 8), (0, 4, 264, 4)])
def test_ray_plan_covers_every_tile_in_one_wave(N, n_active, slots, itemsize):
    """The chunks cover every tile of a row exactly (no empty chunk), and
    the live rows make at most one wave of CTAs where they can."""
    chunks, per = brk.ray_plan(N, n_active, slots, itemsize)
    tiles = -(-N // (brk.TILE_BYTES // itemsize))
    assert chunks >= 1 and per >= 1
    if tiles:
        assert (chunks - 1) * per < tiles <= chunks * per
    if n_active <= slots:
        assert chunks * n_active <= slots
    if tiles >= slots // n_active:
        assert chunks * n_active > slots // 2  # the wave is at least half full


@pytest.mark.parametrize("case,A,D", [("win16_4p", 8, 5), ("win16_8p", 16, 9), ("win32_11p", 22, 11),
                                      ("all16", 16, 16), ("all32", 32, 16)])
def test_ray_cases_are_what_they_say(case, A, D):
    """The seeded ray cases of chip_smoke and kernel_ab: the kernel's types
    and shapes, the window build's row order (two rows a pair, live rows
    first), stale nonzero inactive rows, the same case from the same seed."""
    scal, XiT, w0, X, jj, active = kernel_cases.ray_case(case, 3, "cpu", n_pts=640)
    E = scal.shape[0]
    assert XiT.shape == (E, 3, 640) and w0.shape == (E, 640) and X.shape[1:] == (640, 3)
    assert jj.dtype == torch.int32 and active.dtype == torch.bool
    assert kernel_cases.ray_counts(jj, active) == (A, D)
    assert torch.equal(active, torch.arange(E) < A)
    assert ((jj >= 0) & (jj < X.shape[0])).all()
    if A < E:
        assert torch.count_nonzero(w0[~active]) > 0 and torch.count_nonzero(XiT[~active]) > 0
    if case.startswith("win"):  # consecutive pairs (k, k + 1): rows j = k + 1, then j = k
        n = 2 * (A // 2 - (case == "win32_11p"))
        assert torch.equal(jj[0:n:2], jj[1:n:2] + 1)
    for a, b in zip((scal, XiT, w0, X, jj, active), kernel_cases.ray_case(case, 3, "cpu", n_pts=640)):
        assert torch.equal(a, b)


def test_ray_library_path_tracks_source():
    path = kernel_build.library_path(brk._SRC)
    assert path.name.startswith("libray_edge_systems_") and path.parent == kernel_build.BUILD_DIR
    assert rk.library_path().parent == path.parent


def _ray_check(args, dtype, rel, n_active=None):
    """Kernel vs the f64 plain version: per live edge, |dB| and |dg| within
    ``rel`` x that edge's largest entry (f32: a different summation order;
    f64: rounding only); inactive rows exactly 0; two calls bitwise equal;
    one counted launch per call."""
    before = brk.ray_edge_systems.launches
    Bk, gk = brk.ray_edge_systems(*args, **RAY_KW, n_active=n_active)
    Bk2, gk2 = brk.ray_edge_systems(*args, **RAY_KW, n_active=n_active)
    torch.cuda.synchronize()
    assert brk.ray_edge_systems.launches == before + 2
    assert Bk.dtype == dtype and gk.dtype == dtype
    assert torch.equal(Bk, Bk2) and torch.equal(gk, gk2)
    scal, XiT, w0, X, jj, active = args
    Bp, gp = brk.ray_edge_systems_plain(scal.double(), XiT.double(), w0.double(), X.double(), jj,
                                        active, **RAY_KW)
    live = active.cpu()
    for got, want in ((Bk.double(), Bp), (gk.double(), gp)):
        E = want.shape[0]
        scale = want.reshape(E, -1).abs().amax(1).clamp(min=1e-30)
        err = (got - want).reshape(E, -1).abs().amax(1)
        assert (err[live] <= rel * scale[live]).all(), (err / scale).tolist()
        assert torch.count_nonzero(got[~live]) == 0
    return Bk, gk


# (case, N): the window shapes the main path makes, all-active rows with
# repeated jj, N off the 512-point tile, under one tile, and not a multiple
# of 4 points (rows not 16-byte aligned: the ring filled by plain loads)
RAY_CARD_CASES = [("win16_4p", 9000), ("win32_11p", 9000), ("win16_8p", 100), ("all16", 4096),
                  ("all32", 9001), ("win32_11p", 147456)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("case,N", RAY_CARD_CASES)
def test_ray_kernel_matches_plain_on_card(card, dtype, rel, case, N):
    args = kernel_cases.ray_case(case, 1, card, n_pts=N, dtype=dtype)
    A = int(args[5].sum())
    _ray_check(args, dtype, rel, n_active=A)
    _ray_check(args, dtype, rel, n_active=1)  # the most chunks a row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("E,N,P,n_live", [(5, 9000, 4, 5), (3, 4096, 1, 3), (4, 2000, 3, 0), (6, 1, 2, 4)])
def test_ray_kernel_small_windows_on_card(card, dtype, rel, E, N, P, n_live):
    """P = 1, zero live rows (B = g = 0, still one launch), one point, a
    masked live row and stale inactive rows whose jj lies outside the window
    (the kernel must not read it)."""
    args = [t.to(card) for t in _ray_inputs(2, E, N, P, np.float64 if dtype == torch.float64
                                            else np.float32, n_live=n_live)]
    args[4][n_live:] = 1000
    Bk, gk = _ray_check(tuple(args), dtype, rel)
    if n_live == 0:
        assert torch.count_nonzero(Bk) == 0 and torch.count_nonzero(gk) == 0


@pytest.mark.cuda
def test_ray_kernel_rejects_bad_inputs(card):
    args = [t.to(card) for t in _ray_inputs(2, 2, 64)]
    with pytest.raises(ValueError):
        brk.ray_edge_systems(args[0], args[1], args[2][:, :10], *args[3:], **RAY_KW)
    with pytest.raises(ValueError):
        brk.ray_edge_systems(args[0].double(), *args[1:], **RAY_KW)
    with pytest.raises(ValueError):
        brk.ray_edge_systems(*(a.half() for a in args[:4]), *args[4:], **RAY_KW)
    with pytest.raises(ValueError):  # jj must be int32, active bool
        brk.ray_edge_systems(*args[:4], args[4].long(), args[5], **RAY_KW)
    with pytest.raises(ValueError):
        brk.ray_edge_systems(*args[:5], args[5].to(torch.uint8), **RAY_KW)
    with pytest.raises(ValueError):  # X must be (P, N, 3)
        brk.ray_edge_systems(*args[:3], args[3].transpose(1, 2).contiguous(), *args[4:], **RAY_KW)
    with pytest.raises(ValueError):  # the kernel reads contiguous rows
        brk.ray_edge_systems(args[0], args[1].transpose(0, 1).contiguous().transpose(0, 1), *args[2:],
                             **RAY_KW)


# ---------------------------------------------------------------------------
# calib_edge_systems (the backend's calibrated edge normal equations)
# ---------------------------------------------------------------------------

CALIB_KW = dict(sigma_pixel=1.0, sigma_depth=10.0, pixel_border=-10.0, depth_eps=1e-6)


def _calib_args(case, seed, device, hw=kernel_cases.CALIB_HW, dtype=torch.float32, stale=None):
    """A case of ``kernel_cases.calib_case``; ``stale``: the inactive rows'
    ii and jj set to it, outside the window, and their data to NaN (the
    kernel must read neither)."""
    args = list(kernel_cases.calib_case(case, seed, device, hw, dtype))
    if stale is not None:
        dead = ~args[8]
        args[5][dead] = args[6][dead] = stale
        for k in (2, 3):
            args[k][dead] = float("nan")
    return tuple(args)


def test_calib_plain_dead_rows_zero_and_poses_through_ii_jj():
    """Inactive rows holding NaNs and an ii and jj outside the window are
    exactly 0; a live row e is the two-frame call's with T and X at
    (ii[e], jj[e]) (f64: only the batching differs); the weights and masks
    leave every live row's B finite and symmetric."""
    hw = (12, 16)
    args = _calib_args("win16", 0, "cpu", hw, torch.float64, stale=99)
    T, intr, XiT, w0, X, ii, jj, idx, active = args
    B, g = cek.calib_edge_systems_plain(*args, img_hw=hw, **CALIB_KW)
    assert torch.count_nonzero(B[~active]) == 0 and torch.count_nonzero(g[~active]) == 0
    assert torch.isfinite(B).all() and torch.isfinite(g).all() and torch.equal(B, B.transpose(1, 2))
    for e in (0, 5, 13):
        sl = slice(e, e + 1)
        two = torch.stack([ii[e], jj[e]]).long()
        Be, ge = cek.calib_edge_systems_plain(T[two], intr, XiT[sl], w0[sl], X[two],
                                              torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
                                              idx[sl], active[sl], img_hw=hw, **CALIB_KW)
        torch.testing.assert_close(B[e], Be[0], rtol=1e-12, atol=0)
        torch.testing.assert_close(g[e], ge[0], rtol=1e-12, atol=0)
        assert torch.count_nonzero(B[e]) > 0


@pytest.mark.parametrize("case", list(kernel_cases.CALIB_CASES))
def test_calib_cases_are_what_they_say(case):
    """The seeded calibrated cases of chip_smoke and the card tests: the
    kernel's types and shapes, consecutive pairs first (rows j = k + 1,
    then j = k), matches inside the frame, the masked points there, the
    same case from the same seed."""
    hw = (24, 32)
    n = hw[0] * hw[1]
    E, A, P = kernel_cases.CALIB_CASES[case]
    args = kernel_cases.calib_case(case, 3, "cpu", hw)
    T, intr, XiT, w0, X, ii, jj, idx, active = args
    assert T.shape == (P, 8) and intr.shape == (4,) and XiT.shape == (E, 3, n) and w0.shape == (E, n)
    assert X.shape == (P, n, 3) and idx.shape == (E, n) and ii.dtype == jj.dtype == idx.dtype == torch.int32
    assert torch.equal(active, torch.arange(E) < A) and ((ii >= 0) & (ii < P) & (jj >= 0) & (jj < P)).all()
    assert torch.equal(jj[0:A:2], ii[0:A:2] + 1) and torch.equal(ii[1:A:2], jj[0:A:2])
    assert torch.equal(jj[1:A:2], ii[0:A:2]) and ((idx >= 0) & (idx < n)).all()
    norms = T[:, 3:7].norm(dim=1)
    assert (norms != 1.0).all() and ((norms - 1.0).abs() < 1e-2).all()  # off unit norm, slightly
    assert (X[..., 2] < 0).any() and (XiT[:, 2] == 0).any() and (w0 == 0).any()
    for a, b in zip(args, kernel_cases.calib_case(case, 3, "cpu", hw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,n_active,slots", [(196608, 14, 264), (196608, 62, 264), (196608, 2, 132),
                                              (9021, 30, 264), (100, 1, 264), (0, 4, 264)])
def test_calib_plan_covers_every_point_in_one_wave(N, n_active, slots):
    chunks, pts = cek.calib_plan(N, n_active, slots)
    assert chunks >= 1 and pts >= 1 and pts % (brk.TILE_BYTES // 4) == 0
    if N:
        assert (chunks - 1) * pts < N <= chunks * pts
    if n_active <= slots:
        assert chunks * n_active <= slots


def test_calib_library_path_tracks_source():
    path = kernel_build.library_path(cek._SRC)
    assert path.name.startswith("libcalib_edge_systems_") and path.parent == kernel_build.BUILD_DIR


def _calib_check(args, hw, dtype, rel, n_active=None):
    """Kernel vs the f64 plain version: per live edge, |dB| and |dg| within
    ``rel`` x that edge's largest entry (f32: the ray kernel's bar; f64:
    rounding only); inactive rows exactly 0; two calls bitwise equal; one
    counted launch per call."""
    before = cek.calib_edge_systems.launches
    Bk, gk = cek.calib_edge_systems(*args, img_hw=hw, **CALIB_KW, n_active=n_active)
    Bk2, gk2 = cek.calib_edge_systems(*args, img_hw=hw, **CALIB_KW, n_active=n_active)
    torch.cuda.synchronize()
    assert cek.calib_edge_systems.launches == before + 2
    assert Bk.dtype == dtype and gk.dtype == dtype
    assert torch.equal(Bk, Bk2) and torch.equal(gk, gk2)
    d64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    Bp, gp = cek.calib_edge_systems_plain(*d64, img_hw=hw, **CALIB_KW)
    live = args[8].cpu()
    for got, want in ((Bk.double(), Bp), (gk.double(), gp)):
        E = want.shape[0]
        scale = want.reshape(E, -1).abs().amax(1).clamp(min=1e-30)
        err = (got - want).reshape(E, -1).abs().amax(1).cpu()
        assert (err[live] <= rel * scale.cpu()[live]).all(), (err / scale.cpu()).tolist()
        assert torch.count_nonzero(got[~live.to(got.device)]) == 0
    return Bk, gk


# (case, hw): the window buckets of a 32-frame session at 384x512, and an
# odd N (97 x 93) whose rows end inside a chunk
CALIB_CARD_CASES = [("win16", (384, 512)), ("win32", (384, 512)), ("win64", (384, 512)), ("win32", (97, 93))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("case,hw", CALIB_CARD_CASES)
def test_calib_kernel_matches_plain_on_card(card, dtype, rel, case, hw):
    """Points behind the camera, off the pixel border, with z_i = 0 and with
    w0 = 0 in every row; poses whose quaternions are off unit norm; stale
    inactive rows whose ii and jj lie outside the window and whose data are
    NaN."""
    args = _calib_args(case, 1, card, hw, dtype, stale=1000)
    A = int(args[8].sum())
    _calib_check(args, hw, dtype, rel, n_active=A)
    _calib_check(args, hw, dtype, rel, n_active=1)  # the most chunks a row


@pytest.mark.cuda
def test_calib_kernel_dead_window_on_card(card):
    """No live row: B = g = 0, still one launch."""
    args = list(_calib_args("win16", 2, card, (24, 32)))
    args[8][:] = False
    Bk, gk = _calib_check(tuple(args), (24, 32), torch.float32, 1e-4, n_active=0)
    assert torch.count_nonzero(Bk) == 0 and torch.count_nonzero(gk) == 0


@pytest.mark.cuda
def test_calib_kernel_rejects_bad_inputs(card):
    hw = (24, 32)
    args = _calib_args("win16", 2, card, hw)
    kw = dict(img_hw=hw, **CALIB_KW)
    bad = [
        (args[0][:, :7],) + args[1:],  # T must be (P, 8)
        (args[0][:-1],) + args[1:],  # a pose for every frame of X
        (args[0].double(),) + args[1:],  # one type throughout
        tuple(a.half() if a.is_floating_point() else a for a in args),  # f32 or f64 only
        args[:3] + (args[3][:, :10],) + args[4:],
        args[:4] + (args[4].transpose(1, 2).contiguous(),) + args[5:],  # X must be (P, N, 3)
        args[:5] + (args[5].long(),) + args[6:],  # ii int32
        args[:6] + (args[6].long(),) + args[7:],  # jj int32
        args[:7] + (args[7].long(), args[8]),  # idx int32
        args[:8] + (args[8].to(torch.uint8),),  # active bool
        args[:2] + (args[2].transpose(0, 1).contiguous().transpose(0, 1),) + args[3:],  # contiguous rows
        args[:1] + (args[1].cpu(),) + args[2:],  # one device
    ]
    for a in bad:
        with pytest.raises(ValueError):
            cek.calib_edge_systems(*a, **kw)


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
@pytest.mark.parametrize("D", [24, 32, 64, 20, 100, 128])
def test_attention_kernel_qkv_views_ragged_on_card(card, D):
    """bf16 at head dims 24/32/64 (one 64-wide half), 100/128 (two halves)
    and 20 (rows TMA cannot read: the padded copy), q, k, v as strided views
    of one (B, N, 3, H, D) buffer, a ragged N = 700 and Nq != Nk: within the
    bar of the plain version, and equal to the same call on contiguous
    copies."""
    B, H, Nq, Nk = 2, 3, 700, 640
    rng = np.random.default_rng(D)
    qkv = torch.from_numpy(rng.normal(size=(B, Nq, 3, H, D)).astype(np.float32)).to(card, torch.bfloat16)
    q = qkv[:, :, 0].transpose(1, 2)
    k, v = (qkv[:, :Nk, i].transpose(1, 2) for i in (1, 2))
    got = ak.flash_attention(q, k, v)
    again = ak.flash_attention(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    want = ak.flash_attention_plain(q, k, v)
    scale = max(float(want.float().abs().max()), 1.0)
    assert float((got.float() - want.float()).abs().max()) <= 1e-2 * scale
    assert torch.equal(got, again)


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


@pytest.mark.cuda
def test_attention_kernel_on_a_second_card(card):
    """The bf16 kernel needs more than 48 KB of dynamic shared memory, an
    attribute each device holds for itself: after a launch on card 0, a
    launch on card 1 (where a placement runs the backend) must run and
    agree with the plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the attribute is per device, one card cannot show it")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in _attn_inputs((1, 6, 576, 576, 64), 2))
        got = ak.flash_attention(q, k, v)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        want = ak.flash_attention_plain(q, k, v)
        scale = max(float(want.float().abs().max()), 1.0)
        assert float((got.float() - want.float()).abs().max()) <= 1e-2 * scale


@pytest.mark.cuda
def test_retrieval_on_card_matches_cpu(card):
    """The retrieval head and the codebook quantization (f32 products, TF32
    off) on the card against the same on the CPU: attention within 1e-5
    relative and whitened projections within 1e-4, the top-300 the same but
    for swapped near ties; word indices equal but for near ties (both
    distances within 1e-5 relative); a database on each device returns the
    same keyframes."""
    from frodo_slam_tpu_torch.retrieval.asmk import Codebook
    from frodo_slam_tpu_torch.retrieval.database import RetrievalDatabase
    from frodo_slam_tpu_torch.retrieval.model import RetrievalHead, how_select_local, projector
    from frodo_slam_tpu_torch.utils.device import set_f32_contract

    set_f32_contract()
    dbs = []
    for dev in ("cpu", card):
        head = RetrievalHead.init(torch.Generator().manual_seed(1), 1024, [1024], 300, device=dev)
        cb = Codebook.random(np.random.default_rng(0), 65536, 1024, device=dev)
        dbs.append(RetrievalDatabase(head, cb))
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(1, 576, 1024)).astype(np.float32) for _ in range(4)]

    def parts(head, x):
        proj = projector(head.projector, head.prewhiten(x))
        return torch.linalg.norm(proj, dim=-1)[0].cpu(), head.postwhiten(proj)[0].cpu()

    (a_c, p_c), (a_g, p_g) = parts(dbs[0].head, torch.from_numpy(feats[0])), \
        parts(dbs[1].head, torch.from_numpy(feats[0]).to(card))
    torch.testing.assert_close(a_g, a_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_g, p_c, rtol=0, atol=1e-4)
    _, _, i_c = how_select_local(p_c[None], a_c[None], 300)
    _, _, i_g = how_select_local(p_g[None], a_g[None], 300)
    swapped = i_c[0] != i_g[0]
    torch.testing.assert_close(a_c[i_g[0][swapped]], a_c[i_c[0][swapped]], rtol=1e-5, atol=0)

    f_cpu = dbs[0].head.prep_features(torch.from_numpy(feats[0]))[0]
    i_cpu, i_card = dbs[0].codebook.quantize(f_cpu, 5), dbs[1].codebook.quantize(f_cpu, 5)
    diff = i_cpu != i_card
    if diff.any():
        c = dbs[0].codebook.centroids.astype(np.float64)
        q = f_cpu.numpy().astype(np.float64)
        rows, cols = np.nonzero(diff)
        d = lambda idx: ((q[rows] - c[idx[rows, cols]]) ** 2).sum(-1)  # noqa: E731
        np.testing.assert_allclose(d(i_card), d(i_cpu), rtol=1e-5)
    assert diff.mean() < 0.01
    for i, f in enumerate(feats + [feats[1] + 0.01 * rng.normal(size=feats[1].shape).astype(np.float32)]):
        got = [db.update(torch.from_numpy(f).to(db.codebook.device), True, k=3, min_thresh=5e-3, kf_id=i)
               for db in dbs]
        assert got[0] == got[1], (i, got)
