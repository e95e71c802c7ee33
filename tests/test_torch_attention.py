"""PyTorch port vs JAX package: attention.

The plain version of the port's flash-attention kernel (what the kernel is
held against on the card, chip_smoke.py phase ``attention``) against the
reference of the TPU library kernel, ``mha_reference`` (same module as
``flash_attention``), and against ``jax.nn.dot_product_attention`` (the
package's "xla" path), on the same numpy inputs; then the port's
``Attention`` and ``CrossAttention`` modules with RoPE (their tables from
``rope_tables``) against the JAX package's ``attention`` /
``cross_attention``.

Tolerances: f32 atol 2e-6 (one softmax, sums in another order). bf16: the
plain version rounds only P and the output to bf16 (JAX's placement), while
both JAX references also round the logits (|s| up to ~12 here, so an error
up to 12 x 2^-9 in an exponent) and the softmax to bf16: atol 0.1 on
outputs of magnitude <= ~3; against JAX's reference run in f32 on the same
bf16 inputs, atol 1.6e-2 (P's and the output's rounding only). The modules:
rtol and atol 1e-5 in f32 (outputs up to ~7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from frodo_slam_tpu.models import layers as jlayers
from frodo_slam_tpu_torch.models import layers as tlayers
from frodo_slam_tpu_torch.ops import attention_kernel as ak

torch.set_num_threads(1)

# (B, H, Nq, Nk, D): head dims 64 / 32 / 24, N in {48, 64, 100}, Nq != Nk, B*H > 1
SHAPES = [(2, 3, 48, 48, 64), (1, 4, 64, 100, 32), (2, 2, 100, 64, 24), (1, 2, 100, 100, 64),
          (3, 1, 48, 64, 32)]


def _inputs(shape, seed):
    B, H, Nq, Nk, D = shape
    rng = np.random.default_rng(seed)
    return (2.0 * rng.normal(size=(B, H, Nq, D)).astype(np.float32),
            rng.normal(size=(B, H, Nk, D)).astype(np.float32),
            rng.normal(size=(B, H, Nk, D)).astype(np.float32))


def _jax_refs(q, k, v, dtype):
    qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = mha_reference(qj, kj, vj, None, sm_scale=scale)
    xla = jax.nn.dot_product_attention(*(a.transpose(0, 2, 1, 3) for a in (qj, kj, vj)))
    return np.asarray(ref, np.float32), np.asarray(xla.transpose(0, 2, 1, 3), np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_references(shape, dtype):
    q, k, v = _inputs(shape, sum(shape))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = ak.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))  # CPU: plain
    assert out.dtype == tdt and tuple(out.shape) == shape[:3] + shape[4:]
    got = out.float().numpy()
    ref, xla = _jax_refs(q, k, v, jdt)
    atol = 2e-6 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(got, xla, atol=atol, rtol=0)
    if dtype == "bfloat16":
        # JAX's reference in f32 on the bf16-rounded inputs: only P's and the
        # output's rounding separate the two
        qb, kb, vb = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v))
        ref32, _ = _jax_refs(qb, kb, vb, jnp.float32)
        np.testing.assert_allclose(got, ref32, atol=1.6e-2, rtol=0)


def test_plain_rounds_p_before_pv():
    """bf16: P is rounded to v's type unnormalised, before P V (the JAX
    kernel's ``p.astype(v.dtype)``), and the output is q's type."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs((1, 1, 8, 8, 16), 0))
    s = (q.float() @ k.float().transpose(-1, -2)) / 4.0  # 1/sqrt(16)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = ((p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    torch.testing.assert_close(ak.flash_attention_plain(q, k, v), want, rtol=0, atol=0)


def _linear_params(rng, d_in, d_out):
    return {"w": (0.2 * rng.normal(size=(d_in, d_out))).astype(np.float32),
            "b": (0.1 * rng.normal(size=d_out)).astype(np.float32)}


def _load(mod, p):
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(p["w"].T))
        mod.bias.copy_(torch.from_numpy(p["b"]))


def _pos(gh, gw, b):
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    return np.broadcast_to(np.stack([yy, xx], -1).reshape(1, gh * gw, 2), (b, gh * gw, 2)).astype(np.int32)


@pytest.mark.parametrize("dim,heads,grid", [(64, 2, (4, 12)), (48, 2, (8, 8)), (96, 3, (5, 20))])
def test_attention_modules_match_jax(dim, heads, grid):
    """Self-attention (48, 64 and 100 tokens) and cross-attention with RoPE
    base 100, f32, batch 2: rtol and atol 1e-5 (linears and the softmax in
    another order)."""
    rng = np.random.default_rng(dim)
    n = grid[0] * grid[1]
    x = rng.normal(size=(2, n, dim)).astype(np.float32)
    y = rng.normal(size=(2, n, dim)).astype(np.float32)
    pos = _pos(*grid, 2)
    pa = {"qkv": _linear_params(rng, dim, 3 * dim), "proj": _linear_params(rng, dim, dim)}
    pc = {k: _linear_params(rng, dim, dim) for k in ("projq", "projk", "projv", "proj")}

    att = tlayers.Attention(dim, heads, 100.0)
    _load(att.qkv, pa["qkv"])
    _load(att.proj, pa["proj"])
    cross = tlayers.CrossAttention(dim, heads, 100.0)
    for name in ("projq", "projk", "projv", "proj"):
        _load(getattr(cross, name), pc[name])

    rope = tlayers.rope_tables(torch.from_numpy(pos), dim // heads, 100.0, torch.float32)
    jp = jax.tree.map(jnp.asarray, pa)
    want = jlayers.attention(jp, jnp.asarray(x), jnp.asarray(pos), heads, 100.0)
    with torch.no_grad():
        got = att(torch.from_numpy(x), rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    jc = jax.tree.map(jnp.asarray, pc)
    want = jlayers.cross_attention(jc, jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
                                   jnp.asarray(pos), jnp.asarray(pos), heads, 100.0)
    with torch.no_grad():
        got = cross(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(y), rope, rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_impl_is_one_function(impl):
    """Both of the JAX package's ``attention_impl`` values load into the
    port's config; anything else raises."""
    from frodo_slam_tpu_torch.models import mast3r as tmast3r

    assert tmast3r.tiny_config(attention_impl=impl).attention_impl == impl
    with pytest.raises(ValueError, match="attention_impl"):
        tmast3r.tiny_config(attention_impl="flash")
