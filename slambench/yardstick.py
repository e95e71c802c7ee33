"""The benchmark's frozen arithmetic: the frame generator, the model's FLOP
count, the kernels' bounds and the card's peaks.

Copies, so that a later change to the program cannot move the yardstick.
Sources, at commit b64ca557ffdbf94bf8f014549b988da65a7ba2ce where no other
is named:

- :func:`wave_field`: ``frodo_slam_tpu_torch/tools/bench.py``
  ``synthetic_frames`` (its base image, before the per-frame cut);
- :func:`model_flops` and its helpers: ``frodo_slam_tpu_torch/models/mast3r.py``
  ``model_flops`` (:348), over the widths of a configuration file instead of
  the program's config class;
- :func:`attention_bound` and :func:`ray_bound`: ``chip_smoke.py``
  (:355 and :503), with ``FLOPS_PER_POINT`` from
  ``frodo_slam_tpu_torch/ops/ba_reduce_kernel.py`` (:58);
- :func:`forward_attention_bound`: the attention calls of one forward as
  ``frodo_slam_tpu_torch/models/mast3r.py`` makes them at commit
  3ef0cb73c13949013c35e84f170fc196eae51777 (``encode_image``: one an
  encoder block; ``decode``: a self- and a cross-attention a block of each
  of the two decoders);
- the peaks: NVIDIA's H100 SXM data sheet (dense rates, 700 W).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
F64_OPS_PER_S = 34e12  # f64 outside the tensor cores
# operations a point of the ray kernel's Huber-weighted Gram
# (ba_reduce_kernel.py:58)
RAY_FLOPS_PER_POINT = 18 + 16 + 10 + 30 + 18 + 19 + 4 + 2 * 55 + 2 * 19


def wave_field(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth textured image, (h, w, 3) uint8: a sum of eight
    low-frequency waves and mild noise (``synthetic_frames``' draws, at
    offset 0), mapped from [-1, 1] to 0..255."""
    yy, xx = np.mgrid[0: h + 8, 0: w + 8].astype(np.float32)
    base = np.zeros((h + 8, w + 8, 3), np.float32)
    for _ in range(8):
        fy, fx = rng.uniform(0.2, 3.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        base += np.sin(fy * yy[..., None] / h * 2 * np.pi + fx * xx[..., None] / w * 2 * np.pi + ph) \
            * rng.uniform(0.1, 0.4)
    base += rng.normal(size=base.shape).astype(np.float32) * 0.05
    base = np.clip(base, -1, 1)[:h, :w]
    return np.rint((base + 1.0) * 127.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# model FLOP count (mast3r.py:301-372), widths from the configuration file
# ---------------------------------------------------------------------------

def _attention_block_flops(n_q: int, n_kv: int, dim: int, cross: bool) -> int:
    proj = 2 * n_q * dim * dim * 2 + 2 * n_kv * dim * dim * 2 if cross else 2 * n_q * dim * 4 * dim
    return proj + 2 * 2 * n_q * n_kv * dim


def _mlp_flops(n: int, d_in: int, d_hidden: int, d_out: int) -> int:
    return 2 * n * d_hidden * (d_in + d_out)


def _conv_flops(h: int, w: int, c_in: int, c_out: int, k: int = 1, stride: int = 1) -> int:
    def taps(n):
        n_out = (n + 2 * (k // 2) - k) // stride + 1
        return sum(1 for i in range(n_out) for t in range(k) if 0 <= stride * i - k // 2 + t < n)

    return 2 * taps(h) * taps(w) * c_in * c_out


def _dpt_flops(m: Dict, gh: int, gw: int) -> int:
    L, F = m["dpt_layer_dims"], m["dpt_feature_dim"]
    last = F // 2
    dims = (m["enc_embed_dim"],) + (m["dec_embed_dim"],) * 3
    h4, w4 = (gh - 1) // 2 + 1, (gw - 1) // 2 + 1
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (h4, w4)]
    f = (_conv_flops(gh, gw, dims[0], L[0]) + 2 * gh * gw * L[0] * 16 * L[0]
         + _conv_flops(gh, gw, dims[1], L[1]) + 2 * gh * gw * L[1] * 4 * L[1]
         + _conv_flops(gh, gw, dims[2], L[2])
         + _conv_flops(gh, gw, dims[3], L[3]) + _conv_flops(gh, gw, L[3], L[3], 3, stride=2))
    f += sum(_conv_flops(h, w, L[i], F, 3) for i, (h, w) in enumerate(sizes))
    rcu = lambda h, w: 2 * _conv_flops(h, w, F, F, 3)  # noqa: E731
    for i, (h, w) in enumerate(sizes):
        f += rcu(h, w) * (1 if i == 3 else 2) + _conv_flops(2 * h, 2 * w, F, F)
    h1, w1 = 2 * sizes[0][0], 2 * sizes[0][1]
    return (f + _conv_flops(h1, w1, F, F // 2, 3) + _conv_flops(2 * h1, 2 * w1, F // 2, last, 3)
            + _conv_flops(2 * h1, 2 * w1, last, 4))


def model_flops(m: Dict, img_hw) -> Dict[str, int]:
    """Operations of one encode and one pair decode with both heads, from
    the widths ``m`` (a configuration file's ``model`` section). Keys
    ``encode``, ``decoder``, ``dpt``, ``local_features`` and ``total``."""
    p = m["patch_size"]
    gh, gw = img_hw[0] // p, img_hw[1] // p
    n, de, dd = gh * gw, m["enc_embed_dim"], m["dec_embed_dim"]
    ratio = m["mlp_ratio"]
    patch = 2 * n * 3 * p ** 2 * de
    enc_block = _attention_block_flops(n, n, de, False) + _mlp_flops(n, de, int(ratio * de), de)
    dec_block = (_attention_block_flops(n, n, dd, False) + _attention_block_flops(n, n, dd, True)
                 + _mlp_flops(n, dd, int(ratio * dd), dd))
    idim = de + dd
    local = _mlp_flops(n, idim, 4 * idim, (m["local_feat_dim"] + 1) * p ** 2)
    out = {
        "encode": patch + m["enc_depth"] * enc_block,
        "decoder": 2 * (2 * n * de * dd + m["dec_depth"] * dec_block),
        "dpt": 2 * _dpt_flops(m, gh, gw),
        "local_features": 2 * local,
    }
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# kernel bounds (chip_smoke.py:355, :503)
# ---------------------------------------------------------------------------

def attention_bound(B: int, H: int, Nq: int, Nk: int, D: int, itemsize: int) -> float:
    """Least seconds for one attention call: 4 B H Nq Nk D operations at the
    type's peak (bf16 for 2-byte operands, f32 otherwise) against q, k, v
    read once and o written once at the memory rate."""
    t_bytes = itemsize * B * H * (2 * Nq + 2 * Nk) * D / HBM_BYTES_PER_S
    peak = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    t_ops = 4.0 * B * H * Nq * Nk * D / peak
    return max(t_ops, t_bytes)


def ray_bound(A: int, D: int, E: int, N: int, itemsize: int) -> float:
    """Least seconds for one ray-kernel call with ``A`` live rows over ``D``
    distinct frames of ``N`` points (``E`` rows in all): each live row's Xi
    and w0 read once, each frame's points once, every row's 12 scalars and
    its B and g written, against A N RAY_FLOPS_PER_POINT operations at the
    f32 (or f64) peak outside the tensor cores."""
    nbytes = itemsize * (A * N * 4 + D * N * 3 + E * 12 + E * 56)
    peak = F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, A * N * RAY_FLOPS_PER_POINT / peak)


ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def forward_attention_bound(m: Dict, img_hw, batch: int, dtype: str) -> Dict[str, float]:
    """Least seconds of the attention calls of one forward at batch
    ``batch``, from the widths ``m`` (a configuration file's ``model``
    section), the network's image size and the transformer's ``dtype``
    (``tpu.dtype``): ``encode`` sums :func:`attention_bound` over the
    ``enc_depth`` calls of one encode, ``decode`` over the ``2 dec_depth``
    self- and cross-attentions of each of a pair decode's two views, all
    over the ``n`` tokens of the image."""
    p = m["patch_size"]
    n = (img_hw[0] // p) * (img_hw[1] // p)
    size = ITEMSIZE[dtype]
    enc = attention_bound(batch, m["enc_num_heads"], n, n, m["enc_embed_dim"] // m["enc_num_heads"], size)
    dec = attention_bound(batch, m["dec_num_heads"], n, n, m["dec_embed_dim"] // m["dec_num_heads"], size)
    return {"encode": m["enc_depth"] * enc, "decode": 2 * m["dec_depth"] * 2 * dec}
