"""PyTorch port vs JAX package: the retrieval stack (``retrieval/``, the host
popcount kernels, ``loader.load_retriever`` and ``head_fingerprint``).

The same numpy inputs, made from a seed, go through both packages. Bars:
packing, hamming distances, aggregation and codebook indices bitwise (where
f32 product order flips a near tie, both distances lie within 1e-5
relative); ``prep_features`` within atol 1e-4 with equal top-k indices;
inverted-file ranks equal and scores within 1e-9; the built host kernels
bitwise equal to their numpy plain versions (1e-12 for the accumulated
scores); database results equal over a sequence with revisits; state arrays
and head digests equal. The JAX ``tests/test_retrieval.py`` cases are
restated against the port at the end.

The JAX package scores alpha = 3 in f32 on its numpy path and in f64 in its
native kernel (``native/asmk_kernels.cpp``, built by ``make -C native``),
which the port's ``csrc/asmk_kernels.cpp`` copies. Where a test holds scores
at 1e-9 it runs the JAX package's native branch with the port's built
library of that source (the same three C functions); the numpy branch is
held at 1e-6.
"""

import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu import loader as jloader
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.retrieval import asmk as jasmk
from frodo_slam_tpu.retrieval import model as jmodel
from frodo_slam_tpu.retrieval.database import RetrievalDatabase as JDatabase
from frodo_slam_tpu_torch import loader as tloader
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.retrieval import asmk as tasmk
from frodo_slam_tpu_torch.retrieval import database as tdatabase
from frodo_slam_tpu_torch.retrieval import model as tmodel
from frodo_slam_tpu_torch.utils import native as tnative

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_native_branch(monkeypatch):
    """The JAX package's asmk module on its native branch, fed the port's
    library of the same C source."""
    monkeypatch.setattr(jasmk, "_native", tnative)
    monkeypatch.setattr(jasmk, "_native_hamming", tnative.hamming_cdist_packed)


@pytest.fixture
def jax_numpy_branch(monkeypatch):
    monkeypatch.setattr(jasmk, "_native", None)
    monkeypatch.setattr(jasmk, "_native_hamming", None)


def _heads(backbone_dim, hdims, nfeat, seed=0):
    """A JAX head (f32 numpy leaves) and the port's head with its weights."""
    jhead = jmodel.RetrievalHead.init(jax.random.PRNGKey(seed), backbone_dim=backbone_dim,
                                      hdims=list(hdims), nfeat=nfeat)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jhead.params)
    rng = np.random.default_rng(seed)
    # non-trivial whiteners, so that both are exercised
    for name, dim in (("prewhiten", backbone_dim), ("postwhiten", hdims[-1])):
        params[name] = {"m": rng.normal(size=(1, dim)).astype(np.float32) * 0.1,
                        "p": (np.eye(dim) + 0.05 * rng.normal(size=(dim, dim))).astype(np.float32)}
    for layer in params["projector"]["layers"]:
        layer["ln"]["scale"] = (1.0 + 0.1 * rng.normal(size=layer["ln"]["scale"].shape)).astype(np.float32)
        layer["ln"]["bias"] = (0.1 * rng.normal(size=layer["ln"]["bias"].shape)).astype(np.float32)
    jhead = jmodel.RetrievalHead(params, nfeat=nfeat)
    thead = tmodel.RetrievalHead(backbone_dim, hdims, nfeat)
    thead.load_state_dict(tconvert.retrieval_state_dict_from_jax(params))
    return jhead, thead.eval()


def _codebooks(size, dim, seed=0, scale=1.0):
    c = np.random.default_rng(seed).normal(size=(size, dim)).astype(np.float32) * scale
    return jasmk.Codebook(c), tasmk.Codebook(c, device="cpu")


# ---------------------------------------------------------------------------
# host kernels and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 70), (5, 32), (300, 1024), (1, 1)])
def test_binarize_and_pack_bitwise(shape):
    v = np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32)
    v[0, 0] = 0.0  # zero is not > 0
    want = jasmk.binarize_and_pack(v)
    np.testing.assert_array_equal(tasmk.binarize_and_pack(v), want)
    np.testing.assert_array_equal(tasmk.binarize_and_pack_plain(v), want)


@pytest.mark.parametrize("dim", [64, 1024])
def test_hamming_cdist_bitwise(jax_numpy_branch, dim):
    rng = np.random.default_rng(dim)
    a = jasmk.binarize_and_pack(rng.normal(size=(7, dim)).astype(np.float32))
    b = jasmk.binarize_and_pack(rng.normal(size=(11, dim)).astype(np.float32))
    want = jasmk.hamming_cdist_packed(a, b, dim)
    np.testing.assert_array_equal(tasmk.hamming_cdist_packed(a, b, dim), want)
    np.testing.assert_array_equal(tasmk.hamming_cdist_packed_plain(a, b, dim), want)


def test_built_kernels_match_their_plain_versions():
    """The g++-built library against the numpy plain versions: bitwise for
    pack and hamming, 1e-12 for the accumulated scores, at a dimension that
    is not a multiple of 32 and one that is not a power of two."""
    rng = np.random.default_rng(0)
    for d in (70, 96, 1024):
        vecs = rng.normal(size=(9, d)).astype(np.float32)
        np.testing.assert_array_equal(tnative.binarize_and_pack_2d(vecs), tasmk.binarize_and_pack_plain(vecs))
        a = tasmk.binarize_and_pack_plain(rng.normal(size=(4, d)).astype(np.float32))
        b = tasmk.binarize_and_pack_plain(rng.normal(size=(40, d)).astype(np.float32))
        np.testing.assert_array_equal(tnative.hamming_cdist_packed(a, b, d),
                                      tasmk.hamming_cdist_packed_plain(a, b, d))
        imids = rng.integers(0, 5, size=b.shape[0]).astype(np.int64)
        norm = np.abs(rng.normal(size=5)) + 1.0
        for thr in (0.0, -1.0, 0.1):
            got, want = np.zeros(5), np.zeros(5)
            tnative.asmk_accumulate_word(a[0], b, imids, d, thr, norm, got)
            tasmk.asmk_accumulate_word_plain(a[0], b, imids, d, thr, norm, want)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
            assert thr > 0 or (got != 0).any()


def test_native_wrappers_reject_bad_inputs():
    a = np.zeros((2, 2), np.uint32)
    with pytest.raises(ValueError):
        tnative.hamming_cdist_packed(a, np.zeros((2, 3), np.uint32), 64)
    with pytest.raises(ValueError):
        tnative.asmk_accumulate_word(a[0], a, np.array([0, 5]), 64, 0.0, np.ones(2), np.zeros(2))
    with pytest.raises(ValueError):  # scores must be written in place: f64
        tnative.asmk_accumulate_word(a[0], a, np.array([0, 1]), 64, 0.0, np.ones(2), np.zeros(2, np.float32))


def test_host_library_builds_into_build_kernels():
    seconds, _ = tnative.build()
    path = tnative.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("libasmk_kernels_") and seconds >= 0.0


# ---------------------------------------------------------------------------
# codebook, aggregation, inverted file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,dim,k", [(128, 16, 3), (4096, 64, 5), (512, 32, 1)])
def test_quantize_indices(size, dim, k):
    jcb, tcb = _codebooks(size, dim, seed=size)
    q = np.random.default_rng(dim).normal(size=(300, dim)).astype(np.float32)
    want = jcb.quantize(q, k)
    got = tcb.quantize(q, k)
    assert got.dtype == np.int32 and got.shape == want.shape
    diff = got != want
    if diff.any():
        # only a flipped near-tie may differ: both picks equally near
        d2 = ((q[:, None].astype(np.float64) - tcb.centroids[None].astype(np.float64)) ** 2).sum(-1)
        rows, cols = np.nonzero(diff)
        a = d2[rows, got[rows, cols]]
        b = d2[rows, want[rows, cols]]
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert diff.mean() < 0.01
    np.testing.assert_array_equal(tcb.quantize(torch.from_numpy(q), k), got)  # a tensor input too


def test_aggregate_image_bitwise():
    jcb, tcb = _codebooks(64, 32, seed=3, scale=3.0)
    rng = np.random.default_rng(4)
    des = rng.normal(size=(40, 32)).astype(np.float32)
    words = rng.integers(0, 64, size=(40, 5))
    ja, ju = jasmk.aggregate_image(jcb, des, words)
    ta, tu = tasmk.aggregate_image(tcb, des, words)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(ta, ja)


def _ivfs(n_images=12, n_words=32, dim=64, seed=5):
    rng = np.random.default_rng(seed)
    j, t = jasmk.InvertedFile(n_words, dim), tasmk.InvertedFile(n_words, dim)
    for im in range(n_images):
        n = int(rng.integers(3, 9))
        des = jasmk.binarize_and_pack(rng.normal(size=(n, dim)).astype(np.float32))
        words = rng.choice(n_words, size=n, replace=False)
        j.add(des, words, np.full(n, im))
        t.add(des, words, np.full(n, im))
    q = jasmk.binarize_and_pack(rng.normal(size=(10, dim)).astype(np.float32))
    qw = rng.choice(n_words, size=10, replace=False)
    return j, t, q, qw


@pytest.mark.parametrize("alpha,thr", [(3.0, 0.0), (3.0, -1.0), (1.0, 0.0)])
def test_inverted_file_search(jax_native_branch, alpha, thr):
    j, t, q, qw = _ivfs()
    np.testing.assert_array_equal(t.norm_factor, j.norm_factor)
    jr, js = j.search(q, qw, alpha=alpha, similarity_threshold=thr, topk=None)
    tr, ts = t.search(q, qw, alpha=alpha, similarity_threshold=thr, topk=5)
    np.testing.assert_array_equal(tr, jr[:5])
    np.testing.assert_allclose(ts, js[:5], rtol=0, atol=1e-9)


def test_inverted_file_search_vs_jax_numpy_branch(jax_numpy_branch):
    """The JAX package's numpy branch cubes the similarity in f32: within
    1e-6 relative of the port's f64 cube."""
    j, t, q, qw = _ivfs(seed=6)
    jr, js = j.search(q, qw, alpha=3.0, similarity_threshold=0.0, topk=None)
    tr, ts = t.search(q, qw, alpha=3.0, similarity_threshold=0.0, topk=None)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone_dim,hdims,nfeat", [(32, (32,), 8), (64, (48, 32), 16), (64, (64,), 300)])
def test_prep_features(backbone_dim, hdims, nfeat):
    jhead, thead = _heads(backbone_dim, hdims, nfeat)
    feat = np.random.default_rng(7).normal(size=(2, 96, backbone_dim)).astype(np.float32)
    want = np.asarray(jhead.prep_features(jnp.asarray(feat)))
    got = thead.prep_features(torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape == (2, min(nfeat, 96), hdims[-1])
    np.testing.assert_allclose(got, want, atol=1e-4)

    # the top-k indices of the attention, each package's own path
    p = jhead.params
    pre = jmodel.whitener(p["prewhiten"], jnp.asarray(feat))
    _, _, j_idx = jmodel.how_select_local(pre, jnp.linalg.norm(jmodel.projector(p["projector"], pre), axis=-1),
                                          nfeat)
    tpre = thead.prewhiten(torch.from_numpy(feat))
    _, _, t_idx = tmodel.how_select_local(
        tpre, torch.linalg.norm(tmodel.projector(thead.projector, tpre), dim=-1), nfeat)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_head_fingerprint_equal_digests():
    for hdims in ((32,), (48, 32)):
        jhead, thead = _heads(32, hdims, 8, seed=len(hdims))
        assert tloader.head_fingerprint(thead) == jloader.head_fingerprint(jhead)
    # and the untouched random-init JAX head
    jhead = jmodel.RetrievalHead.init(jax.random.PRNGKey(3), backbone_dim=16, hdims=[24, 16], nfeat=8)
    thead = tmodel.RetrievalHead(16, (24, 16), 8)
    thead.load_state_dict(tconvert.retrieval_state_dict_from_jax(jax.tree.map(np.asarray, jhead.params)))
    assert tloader.head_fingerprint(thead) == jloader.head_fingerprint(jhead)


def test_convert_retrieval_checkpoint_loads_reference_names():
    """A reference checkpoint's state dict (``projector.{3i}``, LN at
    ``3i + 1``) loads into the head; the JAX converter reads the same dict."""
    rng = np.random.default_rng(8)
    hdims = [24, 16]
    sd = {"prewhiten.m": rng.normal(size=(1, 16)), "prewhiten.p": rng.normal(size=(16, 16)),
          "postwhiten.m": rng.normal(size=(1, 16)), "postwhiten.p": rng.normal(size=(16, 16)),
          "projector.0.weight": rng.normal(size=(24, 16)), "projector.0.bias": rng.normal(size=24),
          "projector.1.weight": rng.normal(size=24), "projector.1.bias": rng.normal(size=24),
          "projector.3.weight": rng.normal(size=(16, 24)), "projector.3.bias": rng.normal(size=16),
          "unrelated.weight": rng.normal(size=3)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    thead = tmodel.RetrievalHead(16, hdims, 8)
    thead.load_state_dict(tmodel.convert_retrieval_checkpoint(sd, hdims))
    jhead = jmodel.RetrievalHead(jmodel.convert_retrieval_checkpoint(sd, hdims), nfeat=8)
    feat = rng.normal(size=(1, 20, 16)).astype(np.float32)
    np.testing.assert_allclose(thead.prep_features(torch.from_numpy(feat)).numpy(),
                               np.asarray(jhead.prep_features(jnp.asarray(feat))), atol=1e-4)
    assert tloader.head_fingerprint(thead) == jloader.head_fingerprint(jhead)


# ---------------------------------------------------------------------------
# database
# ---------------------------------------------------------------------------

def _dbs(dim=32, words=64, nfeat=16):
    jhead, thead = _heads(dim, (dim,), nfeat, seed=2)
    jcb, tcb = _codebooks(words, dim, seed=2, scale=3.0)
    return JDatabase(jhead, jcb), tdatabase.RetrievalDatabase(thead, tcb)


def _place(seed, dim=32, noise=0.0):
    f = np.random.default_rng(seed).normal(size=(1, 24, dim)).astype(np.float32)
    if noise:
        f += np.random.default_rng(1000 + seed).normal(size=f.shape).astype(np.float32) * noise
    return f


# (place, noise, add_after_query, kf_id): six places inserted out of
# keyframe order, revisits queried with and without insertion
SEQUENCE = [(0, 0.0, True, 0), (1, 0.0, True, 1), (2, 0.0, True, 7), (3, 0.0, True, 2),
            (1, 0.02, False, None), (4, 0.0, True, 3), (2, 0.02, True, 4), (5, 0.0, True, 5),
            (0, 0.05, False, None), (3, 0.02, True, 6), (5, 0.3, False, None), (9, 0.0, False, None)]


def test_database_update_matches_jax(jax_native_branch):
    jdb, tdb = _dbs()
    got, want = [], []
    for place, noise, add, kf_id in SEQUENCE:
        f = _place(place, noise=noise)
        want.append(jdb.update(jnp.asarray(f), add_after_query=add, k=3, min_thresh=5e-3, kf_id=kf_id))
        got.append(tdb.update(torch.from_numpy(f), add_after_query=add, k=3, min_thresh=5e-3, kf_id=kf_id))
    assert got == want
    # every revisit retrieves its place
    assert 1 in got[4] and 7 in got[6] and 0 in got[8] and 2 in got[9] and 5 in got[10]
    assert tdb.kf_ids == jdb.kf_ids and tdb.kf_counter == jdb.kf_counter == 8

    ts, js = tdb.state_arrays(), jdb.state_arrays()
    assert ts.keys() == js.keys()
    for key in ts:
        np.testing.assert_array_equal(np.asarray(ts[key]), np.asarray(js[key]), err_msg=key)

    # round trip through the arrays: equal arrays, equal answers, keeps growing
    t2 = _dbs()[1]
    t2.load_state_arrays({k: np.asarray(v) for k, v in js.items()})
    for key, v in t2.state_arrays().items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(ts[key]), err_msg=key)
    q = torch.from_numpy(_place(3, noise=0.01))
    assert t2.update(q, False, k=3, min_thresh=0.0) == tdb.update(q, False, k=3, min_thresh=0.0)
    t2.update(torch.from_numpy(_place(11)), True, k=3, min_thresh=5e-3, kf_id=11)
    assert t2.update(torch.from_numpy(_place(11, noise=0.01)), False, k=1, min_thresh=0.0) == [11]

    tdb.reset()
    assert tdb.kf_counter == 0 and tdb.kf_ids == [] and tdb.ivf.n_images == 0
    assert tdb.update(q, True, k=3) == []


def test_load_retriever_random_fallback_is_degraded():
    cfg = tmast3r.tiny_config()
    with pytest.warns(UserWarning, match="random"):
        db = tloader.load_retriever(cfg, path="no/such/retrieval.pth", device="cpu")
    assert db.degraded and db.codebook.size == 4096 and db.codebook.dim == cfg.enc_embed_dim
    assert db.codebook.device.type == "cpu" and db.head.prewhiten.p.device.type == "cpu"
    again = tloader.load_retriever(cfg, path="no/such/retrieval.pth", device="cpu")
    assert tloader.head_fingerprint(again.head) == tloader.head_fingerprint(db.head)  # seeded
    np.testing.assert_array_equal(again.codebook.centroids, db.codebook.centroids)


def test_load_retriever_reads_a_reference_checkpoint(tmp_path):
    """A retrieval ``.pth`` (state dict under "model") and its codebook
    pickle beside it: a real head, so a pickle without a fingerprint is
    trusted, as in the JAX package."""
    jhead, thead = _heads(32, (1024,), 300, seed=4)
    ckpt = tmp_path / "ret_trainingfree.pth"
    torch.save({"model": {k: v.clone() for k, v in thead.state_dict().items()}}, ckpt)
    cents = np.random.default_rng(0).normal(size=(16, 1024)).astype(np.float32)
    with open(tmp_path / "ret_codebook.pkl", "wb") as f:
        pickle.dump({"centroids": cents}, f)
    db = tloader.load_retriever(tmast3r.tiny_config(), path=str(ckpt), device="cpu")
    assert not db.degraded and db.codebook.size == 16
    assert tloader.head_fingerprint(db.head) == jloader.head_fingerprint(jhead)


# ---------------------------------------------------------------------------
# tests/test_retrieval.py, restated against the port
# ---------------------------------------------------------------------------

def test_binarize_and_pack_matches_cython_docstring():
    v = np.zeros((1, 10), np.float32)
    v[0, 0] = 1.0  # bit 0 -> MSB
    assert tasmk.binarize_and_pack(v)[0, 0] == np.uint32(1 << 31)
    v[0, 9] = 1.0
    assert tasmk.binarize_and_pack(v)[0, 0] == np.uint32((1 << 31) | (1 << 22))


def test_hamming_cdist_packed_docstring_example():
    a = np.array([[3], [1]], np.uint32)
    b = np.array([[1], [2]], np.uint32)
    np.testing.assert_allclose(tasmk.hamming_cdist_packed(a, b, 2), [[0.5, 0.5], [0.0, 1.0]])


def test_quantize_matches_bruteforce():
    rng = np.random.default_rng(0)
    cb = tasmk.Codebook(rng.normal(size=(128, 16)).astype(np.float32), device="cpu")
    q = rng.normal(size=(40, 16)).astype(np.float32)
    idx = cb.quantize(q, 3)
    d2 = ((q[:, None] - cb.centroids[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(np.argsort(d2, axis=1)[:, :3], axis=1))


def test_aggregate_residual_sign():
    rng = np.random.default_rng(1)
    cb = tasmk.Codebook(np.zeros((4, 8), np.float32), device="cpu")
    des = np.abs(rng.normal(size=(5, 8))).astype(np.float32)  # all positive
    ades, uids = tasmk.aggregate_image(cb, des, np.zeros((5, 1), np.int64))
    assert uids.tolist() == [0]
    assert ades[0, 0] == np.uint32(sum(1 << (31 - k) for k in range(8)))


def _place_db(dim=32):
    rng = np.random.default_rng(2)
    head = tmodel.RetrievalHead.init(torch.Generator().manual_seed(0), backbone_dim=dim, hdims=[dim],
                                     nfeat=16, device="cpu")
    cb = tasmk.Codebook(rng.normal(size=(64, dim)).astype(np.float32) * 3, device="cpu")
    return tdatabase.RetrievalDatabase(head, cb)


def _fake_feat(seed, dim=32, noise=0.0):
    f = np.random.default_rng(seed).normal(size=(1, 24, dim)).astype(np.float32)
    if noise:
        f += np.random.default_rng(99).normal(size=f.shape).astype(np.float32) * noise
    return torch.from_numpy(f)


def test_database_revisit_ranks_first():
    db = _place_db()
    for s in range(4):
        db.update(_fake_feat(s), add_after_query=True, k=3, min_thresh=5e-3)
    assert db.kf_counter == 4
    got = db.update(_fake_feat(1, noise=0.01), add_after_query=False, k=1, min_thresh=0.0)
    assert got and got[0] == 1, got


def test_database_explicit_kf_ids():
    db = _place_db()
    for kf in (0, 7, 1, 2):  # a relocalization jumped the queue with kf 7
        db.update(_fake_feat(kf), add_after_query=True, k=3, min_thresh=5e-3, kf_id=kf)
    assert db.update(_fake_feat(7, noise=0.01), add_after_query=False, k=1, min_thresh=0.0) == [7]
    assert db.update(_fake_feat(1, noise=0.01), add_after_query=False, k=1, min_thresh=0.0) == [1]


def test_database_state_roundtrip():
    db = _place_db()
    for kf in range(4):
        db.update(_fake_feat(kf), add_after_query=True, k=3, min_thresh=5e-3, kf_id=kf)
    db2 = _place_db()
    db2.load_state_arrays({k: np.asarray(v) for k, v in db.state_arrays().items()})
    assert db2.kf_counter == db.kf_counter and db2.kf_ids == db.kf_ids
    q = _fake_feat(1, noise=0.01)
    assert (db2.update(q, add_after_query=False, k=1, min_thresh=0.0)
            == db.update(q, add_after_query=False, k=1, min_thresh=0.0) == [1])
    db2.update(_fake_feat(9), add_after_query=True, k=3, min_thresh=5e-3, kf_id=9)
    assert db2.update(_fake_feat(9, noise=0.01), add_after_query=False, k=1, min_thresh=0.0) == [9]


def test_ivf_norm_factor():
    ivf = tasmk.InvertedFile(8, 32)
    des = tasmk.binarize_and_pack(np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32))
    ivf.add(des, np.array([0, 1, 2]), np.array([0, 0, 0]))
    assert ivf.n_images == 1 and ivf.norm_factor[0] == 3
    with pytest.raises(ValueError, match="consecutive"):
        ivf.add(des, np.array([0, 1, 2]), np.array([0, 0, 0]))


def test_trained_codebook_roundtrip(tmp_path):
    """A scripts/train_codebook.py pickle bound to the port's random head
    loads as a non-degraded database; one without a fingerprint beside a
    random head is degraded."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from train_codebook import minibatch_kmeans
    finally:
        sys.path.remove(str(ROOT / "scripts"))

    rng = np.random.default_rng(0)
    cfg = tmast3r.tiny_config()
    head = tloader.load_retriever(cfg, device="cpu").head
    feats = rng.normal(size=(2000, head.dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    centroids = minibatch_kmeans(rng, feats, k=64, iters=5, batch=512)
    cb_file = tmp_path / "my_codebook.pkl"
    with open(cb_file, "wb") as f:
        pickle.dump({"centroids": centroids, "head_fingerprint": tloader.head_fingerprint(head)}, f)
    db = tloader.load_retriever(cfg, codebook_path=str(cb_file), device="cpu")
    assert not db.degraded and db.codebook.size == 64

    cb_file2 = tmp_path / "foreign_codebook.pkl"
    with open(cb_file2, "wb") as f:
        pickle.dump({"centroids": centroids}, f)
    with pytest.warns(UserWarning, match="degraded"):
        db2 = tloader.load_retriever(cfg, codebook_path=str(cb_file2), device="cpu")
    assert db2.degraded


def test_jax_tiny_config_widths_match():
    assert tmast3r.tiny_config().enc_embed_dim == jmast3r.tiny_config().enc_embed_dim
