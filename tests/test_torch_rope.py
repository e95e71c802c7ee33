"""RoPE2D: the tables a forward builds once, the plain twin, the kernel.

On the CPU: ``rope2d_plain`` on ``rope_tables`` is bitwise the former
per-call RoPE (tables rebuilt in every call; transcribed below) and
``apply_rope2d``, in f32 and bf16, and matches the JAX package's
``apply_rope2d`` (f32: atol 2e-6 on outputs up to ~8, the two libraries'
cos and sin differ in the last bit; bf16: one rounding of the output, 2^-8
relative, since XLA may keep the products in f32). Cases: a self-attention
grid, cross-attention with different q and k grids, portrait positions. The
in-place CPU path writes into the qkv split and leaves v alone; one
``rope2d_`` call per attention and shard; the ``model.rope_launches``
counter; the vector width the wrapper picks.

On the card (``-m cuda``; no JAX imported at module level, so it runs
where JAX is not installed):

    python -m pytest --noconftest -m cuda tests/test_torch_rope.py -q

the kernel is bitwise equal to ``rope2d_plain`` at the model's shapes, on
the strided qkv views and on contiguous projections, bf16 and f32, inside a
``TensorParallel`` shard and through the tiny model's encoder and decoders,
and it launches once per attention.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from frodo_slam_tpu_torch.models import layers, mast3r
from frodo_slam_tpu_torch.ops import attention_kernel as ak
from frodo_slam_tpu_torch.ops import rope_kernel as rk
from frodo_slam_tpu_torch.tools import kernel_cases
from frodo_slam_tpu_torch.utils import spans

torch.set_num_threads(1)

BASE = 100.0


def _per_call_rope(tokens, pos, base=BASE):
    """The former ``layers.apply_rope2d``: tables rebuilt from ``pos`` in
    every call, then the rotation."""
    half = tokens.shape[-1] // 2
    y_tok, x_tok = tokens[..., :half], tokens[..., half:]
    cos_y, sin_y = layers._rope_cos_sin(pos[..., 0], half, base, tokens.dtype)
    cos_x, sin_x = layers._rope_cos_sin(pos[..., 1], half, base, tokens.dtype)
    cos_y, sin_y, cos_x, sin_x = (t[:, None] for t in (cos_y, sin_y, cos_x, sin_x))
    y_tok = y_tok * cos_y + rk._rotate_half(y_tok) * sin_y
    x_tok = x_tok * cos_x + rk._rotate_half(x_tok) * sin_x
    return torch.cat([y_tok, x_tok], dim=-1)


def _grid_pos(gh, gw, b=1, portrait=False):
    """(b, gh*gw, 2) int32 (y, x) in raster order; ``portrait``: the grid of
    a transposed image (gw x gh, tall), as the patch embed makes it."""
    if portrait:
        gh, gw = gw, gh
    yy, xx = torch.meshgrid(torch.arange(gh), torch.arange(gw), indexing="ij")
    return torch.stack([yy, xx], -1).reshape(1, gh * gw, 2).expand(b, gh * gw, 2).to(torch.int32)


def _tokens(b, h, n, d, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn((b, h, n, d), generator=g)).to(dtype)


# (name, B, H, D, q grid, k grid, portrait): self-attention grids, cross
# attention with different grids, portrait positions
CASES = [("self_4x12", 2, 2, 32, (4, 12), (4, 12), False),
         ("self_8x8_d24", 1, 3, 24, (8, 8), (8, 8), False),
         ("cross_4x6_3x8", 2, 2, 64, (4, 6), (3, 8), False),
         ("portrait_3x5", 2, 2, 32, (3, 5), (3, 5), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_on_tables_is_the_per_call_rope(case, dtype):
    """``rope2d_plain`` on tables built once, ``apply_rope2d`` and the
    in-place CPU ``rope2d_`` are bitwise the former per-call RoPE, for q on
    its grid and k on the other's."""
    _, B, H, D, qg, kg, portrait = case
    qpos, kpos = _grid_pos(*qg, B, portrait), _grid_pos(*kg, B, portrait)
    q, k = _tokens(B, H, qpos.shape[1], D, 1, dtype), _tokens(B, H, kpos.shape[1], D, 2, dtype)
    tq, tk = (layers.rope_tables(p, D, BASE, dtype) for p in (qpos, kpos))
    assert tq.shape == (B, qpos.shape[1], 4, D // 2) and tq.dtype == dtype
    want_q, want_k = _per_call_rope(q, qpos), _per_call_rope(k, kpos)
    assert torch.equal(rk.rope2d_plain(q, tq), want_q)
    assert torch.equal(rk.rope2d_plain(k, tk), want_k)
    assert torch.equal(layers.apply_rope2d(q, qpos, BASE), want_q)
    rk.rope2d_(q, k, tq, tk)
    assert torch.equal(q, want_q) and torch.equal(k, want_k)


def test_tables_are_the_per_axis_cos_sin():
    """Table rows are cos_y, sin_y, cos_x, sin_x of the per-axis tables."""
    pos = _grid_pos(5, 7, 2)
    t = layers.rope_tables(pos, 64, BASE, torch.bfloat16)
    cy, sy = layers._rope_cos_sin(pos[..., 0], 32, BASE, torch.bfloat16)
    cx, sx = layers._rope_cos_sin(pos[..., 1], 32, BASE, torch.bfloat16)
    for i, want in enumerate((cy, sy, cx, sx)):
        assert torch.equal(t[:, :, i], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_matches_jax_rope(case, dtype):
    """The plain twin on the tables against the JAX package's RoPE on the
    same numpy inputs."""
    import jax.numpy as jnp

    from frodo_slam_tpu.models import layers as jlayers

    _, B, H, D, qg, kg, portrait = case
    for i, grid in enumerate((qg, kg)):
        pos = _grid_pos(*grid, B, portrait)
        t32 = _tokens(B, H, pos.shape[1], D, 3 + i)
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        got = rk.rope2d_plain(t32.to(tdt), layers.rope_tables(pos, D, BASE, tdt)).float().numpy()
        want = np.asarray(jlayers.apply_rope2d(jnp.asarray(t32.numpy(), jdt), jnp.asarray(pos.numpy()), BASE),
                          np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=0, rtol=2.0 ** -8 + 1e-6)


def test_cpu_rope_writes_into_the_qkv_split():
    """An attention's q and k are rotated in place inside the qkv
    projection's output; v keeps its values."""
    b, n, h, d = 2, 12, 2, 32
    qkv = _tokens(b, n, 3 * h, d, 5).reshape(b, n, 3, h, d)
    before = qkv.clone()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    table = layers.rope_tables(_grid_pos(3, 4, b), d, BASE, torch.float32)
    rk.rope2d_(q, k, table, table)
    assert torch.equal(qkv[:, :, 2], before[:, :, 2])
    assert torch.equal(q, rk.rope2d_plain(before[:, :, 0].transpose(1, 2), table))
    assert torch.equal(k, rk.rope2d_plain(before[:, :, 1].transpose(1, 2), table))


def test_no_kernel_off_cpu_and_cuda():
    q = torch.empty((1, 1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        rk.rope2d_(q, q, q, q)


# (what, D, element size, pointers, strides, vector): ViT-L's qkv split and
# cross projections in bf16 (16-byte vectors), the tiny heads in f32, a
# token stride that is odd, a base that is 2-byte aligned only
VEC_CASES = [("vitl_qkv_bf16", 64, 2, [0, 2048, 0, 0], [768 * 3072, 64, 3072, 0, 64, 3072, 0, 128, 32], 8),
             ("vitl_cross_bf16", 64, 2, [0, 0, 0, 0], [768 * 768, 64, 768, 0, 64, 768, 0, 128, 32], 8),
             ("tiny_enc_f32", 32, 4, [0, 256, 0, 0], [8 * 192, 32, 192, 0, 32, 192, 0, 64, 16], 4),
             ("tiny_dec_f32", 24, 4, [0, 192, 0, 0], [8 * 144, 24, 144, 0, 24, 144, 0, 48, 12], 2),
             ("odd_token_stride", 64, 2, [0, 0, 0, 0], [0, 64, 1027, 0, 64, 1024, 0, 128, 32], 1),
             ("base_2_bytes", 64, 2, [2, 0, 0, 0], [0, 64, 1024, 0, 64, 1024, 0, 128, 32], 1),
             ("base_4_bytes", 64, 2, [4, 0, 0, 0], [0, 64, 1024, 0, 64, 1024, 0, 128, 32], 2)]


@pytest.mark.parametrize("case", VEC_CASES, ids=lambda c: c[0])
def test_vector_width(case):
    _, D, esize, ptrs, strides, want = case
    assert rk.rope_vec(D, esize, ptrs, strides) == want


def test_size_one_dims_do_not_bound_the_vector():
    """A dim of size 1 is never stepped: its stride is passed as 0, and a
    table of batch 1 is read with batch stride 0."""
    t = torch.empty((1, 1, 40, 64)).as_strided((1, 1, 40, 64), (3, 1, 64, 1))
    table = torch.empty((1, 40, 4, 32))
    assert rk._strides("q", t, table, 1, 1, 64) == ([0, 0, 64], [0, 128, 32])
    t2 = torch.empty((2, 3, 40, 64))
    assert rk._strides("k", t2, table, 2, 3, 64) == ([7680, 2560, 64], [0, 128, 32])


def test_wrapper_checks_shapes_and_tables():
    """What the kernel does not take raises before any launch."""
    t = torch.empty((2, 3, 40, 64))
    table = torch.empty((2, 40, 4, 32))
    with pytest.raises(ValueError, match="unit stride along the head dim"):
        rk._strides("q", t.transpose(2, 3).contiguous().transpose(2, 3), table, 2, 3, 64)
    with pytest.raises(ValueError, match="table"):
        rk._strides("q", t, table[:, :39], 2, 3, 64)
    with pytest.raises(ValueError, match="table"):
        rk._strides("q", t, table[..., :31], 2, 3, 64)
    with pytest.raises(ValueError, match="table is torch.float64"):
        rk._strides("q", t, table.double(), 2, 3, 64)


def _counting(monkeypatch, launch=False):
    """Replace the layers' ``rope2d_`` by the CPU path that counts its calls
    (and, with ``launch``, adds each to the thread's launches, as a launch
    on the card does)."""
    calls = []
    real = layers.rope2d_

    def spy(q, k, tq, tk):
        calls.append(tuple(q.shape))
        real(q, k, tq, tk)
        if launch:
            rk._local.launches = rk.thread_launches() + 1

    monkeypatch.setattr(layers, "rope2d_", spy)
    return calls


@pytest.fixture(scope="module")
def deep_tiny():
    """Tiny widths at ViT-L depths: 24 encoder blocks, 2 x 12 decoder blocks."""
    return mast3r.init_model(mast3r.tiny_config(enc_depth=24), seed=0, device="cpu")


def test_one_rope_call_per_attention(monkeypatch, deep_tiny):
    """24 in one encode, 48 in one pair decode (self and cross attention of
    both decoders), 96 when the backend's replica splits each over 2."""
    calls = _counting(monkeypatch)
    img = torch.randn((1, 32, 64, 3))
    feat, pos = mast3r.encode_image(deep_tiny, img)
    assert len(calls) == 24
    calls.clear()
    mast3r.decode_and_heads(deep_tiny, feat, pos, feat, pos, (32, 64))
    assert len(calls) == 48
    calls.clear()
    rep = mast3r.BackendReplica(deep_tiny, [torch.device("cpu")] * 2)
    mast3r.decode_and_heads(rep, feat, pos, feat, pos, (32, 64))
    assert len(calls) == 96 and {s[1] for s in calls} == {1}


def test_rope_launches_counter(monkeypatch, deep_tiny):
    """Under a profiler, ``model.rope_launches`` on ``model.encode`` and
    ``model.decode`` counts the calling thread's launches of that forward
    (here each call stands in for one)."""
    _counting(monkeypatch, launch=True)
    img = torch.randn((1, 32, 64, 3))
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        feat, pos = mast3r.encode_image(deep_tiny, img)
        mast3r.decode_and_heads(deep_tiny, feat, pos, feat, pos, (32, 64))
    recs = spans.records()
    spans.clear()
    got = {r["name"]: r["counters"].get("model.rope_launches") for r in recs}
    assert got == {"model.encode": 24, "model.decode": 48}


def test_cpu_forward_counts_no_launch(deep_tiny):
    """On the CPU nothing launches: the counter reads 0."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        mast3r.encode_image(deep_tiny, torch.randn((1, 32, 64, 3)))
    (enc,) = spans.records()
    spans.clear()
    assert enc["counters"] == {"model.rope_launches": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RoPE kernel has no CPU mode")
    return torch.device("cuda")


def _plain_rope_(q, k, tq, tk):
    q.copy_(rk.rope2d_plain(q, tq))
    k.copy_(rk.rope2d_plain(k, tk))


# (B, H, Nq, Nk, D, dtype, layout; kernel_cases.rope_case): ViT-L's heads at 768 and 576 tokens,
# batch 1 and 2, 12 and 16 heads, on the qkv split and on projections
# (Nq != Nk there); the tiny configurations' f32 heads 24 and 32
CARD_CASES = [(B, H, N, N, 64, torch.bfloat16, lay) for B in (1, 2) for H in (12, 16) for N in (768, 576)
              for lay in ("qkv", "proj")]
CARD_CASES += [(1, 12, 768, 576, 64, torch.bfloat16, "proj"), (2, 2, 96, 96, 32, torch.float32, "qkv"),
               (2, 2, 96, 80, 24, torch.float32, "proj"), (1, 2, 100, 100, 24, torch.float32, "qkv"),
               (1, 3, 50, 70, 32, torch.float32, "proj")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c[:5])) + f"-{str(c[5])[6:]}-{c[6]}")
def test_kernel_equals_plain_on_card(card, case):
    """Bitwise equal to the plain twin, in place, one counted launch; the
    rotated views stay readable by the attention kernel in place."""
    B, H, Nq, Nk, D, dtype, layout = case
    q, k, tq, tk = kernel_cases.rope_case(B, H, Nq, Nk, D, dtype, layout, sum(case[:5]), card)
    want_q, want_k = rk.rope2d_plain(q, tq), rk.rope2d_plain(k, tk)
    ptr_q, stride_q = q.data_ptr(), q.stride()
    before = rk.rope2d_.launches
    rk.rope2d_(q, k, tq, tk)
    torch.cuda.synchronize()
    assert rk.rope2d_.launches == before + 1
    assert torch.equal(q, want_q) and torch.equal(k, want_k)
    assert q.data_ptr() == ptr_q and q.stride() == stride_q
    if dtype == torch.bfloat16:
        assert ak.tma_plan(q.shape, q.stride(), q.data_ptr(), q.element_size()) is not None


@pytest.mark.cuda
def test_kernel_takes_a_batch_one_table_on_card(card):
    """One table of batch 1 serves every batch element."""
    q, k, _, _ = kernel_cases.rope_case(3, 4, 64, 64, 64, torch.bfloat16, "qkv", 0, card)
    t1 = layers.rope_tables(_grid_pos(8, 8, 1).to(card), 64, BASE, torch.bfloat16)
    want_q, want_k = rk.rope2d_plain(q, t1), rk.rope2d_plain(k, t1)
    rk.rope2d_(q, k, t1, t1)
    assert torch.equal(q, want_q) and torch.equal(k, want_k)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take_on_card(card):
    q, k, t, _ = kernel_cases.rope_case(1, 2, 16, 16, 64, torch.bfloat16, "proj", 0, card)
    with pytest.raises(ValueError, match="multiple of 4"):
        rk.rope2d_(q[..., :62], k[..., :62], t[..., :31], t[..., :31])
    with pytest.raises(ValueError, match="table"):
        rk.rope2d_(q, k, t.float(), t)
    with pytest.raises(ValueError, match="table"):
        rk.rope2d_(q, k, t[:, :8], t)
    with pytest.raises(ValueError, match="bf16 or f32"):
        rk.rope2d_(q.half(), k.half(), t.half(), t.half())


def _tp_modules(dim, heads, device, dtype):
    torch.manual_seed(dim)
    att = layers.Attention(dim, heads, BASE).to(device, dtype)
    cross = layers.CrossAttention(dim, heads, BASE).to(device, dtype)
    return att, cross


@pytest.mark.cuda
@pytest.mark.parametrize("dim,heads,n,b", [(768, 12, 576, 1), (768, 12, 576, 2)])
def test_kernel_in_a_tensor_parallel_shard_on_card(card, monkeypatch, dim, heads, n, b):
    """Self- and cross-attention split over two aliases of the card: the
    kernel path's output is bitwise the plain RoPE path's."""
    att, cross = _tp_modules(dim, heads, card, torch.bfloat16)
    devs = [card, card]
    s_att, s_cross = layers.split_attention(att, devs), layers.split_cross_attention(cross, devs)
    x = torch.randn((b, n, dim), device=card).bfloat16()
    y = torch.randn((b, n, dim), device=card).bfloat16()
    tx = layers.rope_tables(_grid_pos(18, 32, b).to(card), dim // heads, BASE, torch.bfloat16)
    ty = layers.rope_tables(_grid_pos(18, 32, b).flip(1).to(card), dim // heads, BASE, torch.bfloat16)
    before = rk.rope2d_.launches
    with torch.no_grad():
        got = (s_att(x, tx), s_cross(x, y, y, tx, ty))
    assert rk.rope2d_.launches == before + 4
    monkeypatch.setattr(layers, "rope2d_", _plain_rope_)
    with torch.no_grad():
        want = (s_att(x, tx), s_cross(x, y, y, tx, ty))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_model_launches_once_per_attention_on_card(card, monkeypatch, dtype):
    """At ViT-L depths (tiny widths) an encode launches the kernel 24 times
    and a pair decode 48, once per attention, and the counter says so; the
    outputs are bitwise those of the plain RoPE path."""
    model = mast3r.init_model(mast3r.tiny_config(enc_depth=24, dtype=dtype), seed=0, device=card)
    img = torch.randn((1, 32, 64, 3), device=card)
    l0, a0 = rk.rope2d_.launches, ak.flash_attention.launches
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        feat, pos = mast3r.encode_image(model, img)
        l1, a1 = rk.rope2d_.launches, ak.flash_attention.launches
        mast3r.decode_and_heads(model, feat, pos, feat, pos, (32, 64))
    torch.cuda.synchronize()
    assert (l1 - l0, a1 - a0) == (24, 24)
    assert (rk.rope2d_.launches - l1, ak.flash_attention.launches - a1) == (48, 48)
    counted = {r["name"]: r["counters"].get("model.rope_launches") for r in spans.records()}
    spans.clear()
    assert counted == {"model.encode": 24, "model.decode": 48}
    hooks = mast3r.decode(model, feat, pos, feat.flip(1), pos)
    monkeypatch.setattr(layers, "rope2d_", _plain_rope_)
    feat_p, _ = mast3r.encode_image(model, img)
    hooks_p = mast3r.decode(model, feat_p, pos, feat_p.flip(1), pos)
    assert torch.equal(feat, feat_p)
    assert all(torch.equal(h, hp) for view, view_p in zip(hooks, hooks_p) for h, hp in zip(view, view_p))
