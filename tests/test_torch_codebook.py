"""PyTorch port vs JAX package: the ASMK codebook trainer
(``frodo_slam_tpu_torch/tools/train_codebook.py`` vs
``scripts/train_codebook.py``).

- ``minibatch_kmeans`` on the same numpy draws as the JAX script's, with
  more features than centroids (Lloyd runs) and with fewer (the tiled and
  noised branch): centroids atol 1e-5.
- The assignment scores a near tie in f64: it equals the f64 argmax on
  data with near-duplicate centroids, so the card and the CPU pick alike.
- Feature collection: the features a running ``SLAM`` hands its retrieval
  database, against the JAX package's ``resize_img`` + ``encode_image`` +
  ``prep_features`` at tiny_config with converted weights, landscape and
  portrait frames (atol 1e-4, the bar of ``prep_features`` in
  ``test_torch_retrieval.py``).
- The CLI on a PNG folder writes a pickle that ``load_retriever`` loads as
  not degraded, beside the head it was trained against.

The JAX script has no package; it is imported as ``tests/test_retrieval.py``
imports it. Its own ``iter_images`` cannot run (it passes ``load_dataset`` an
``img_size`` it does not take), so the feature test calls the JAX package's
functions it would have called.
"""

import json
import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from frodo_slam_tpu.data.image import resize_img as j_resize_img
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.retrieval import model as jmodel
from frodo_slam_tpu_torch import loader as tloader
from frodo_slam_tpu_torch.data import datasets as tds
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.retrieval import model as tmodel
from frodo_slam_tpu_torch.tools import train_codebook as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from train_codebook import minibatch_kmeans as j_kmeans  # noqa: E402

torch.set_num_threads(1)


def _unit_feats(n, d, seed):
    f = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


@pytest.mark.parametrize("n,k,d,iters,batch", [(600, 32, 16, 4, 256), (3000, 64, 64, 5, 1024),
                                               (500, 16, 8, 3, 10_000), (20, 32, 16, 3, 256),
                                               (32, 32, 8, 2, 64)])
def test_minibatch_kmeans_matches_jax(n, k, d, iters, batch):
    feats = _unit_feats(n, d, seed=n)
    want = j_kmeans(np.random.default_rng(5), feats, k, iters=iters, batch=batch)
    got = ttrain.minibatch_kmeans(np.random.default_rng(5), torch.from_numpy(feats), k, iters=iters,
                                  batch=batch, chunk=100)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (k, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if n > k:
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-6)


def test_assignment_is_the_f64_argmax_on_near_ties():
    rng = np.random.default_rng(0)
    d = 64
    base = _unit_feats(40, d, seed=1)
    # pairs of centroids a hair apart: rows near them tie in f32
    cents = np.concatenate([base, base + 1e-6 * rng.normal(size=base.shape)]).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    x = (base[rng.integers(0, 40, 500)] + 0.05 * rng.normal(size=(500, d))).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    top2 = np.sort(x @ cents.T, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] < 2 * d * 2.0 ** -23).sum() > 100  # near ties in f32
    got = ttrain._assign(torch.from_numpy(x), torch.from_numpy(cents), chunk=128).numpy()
    want = np.argmax(x.astype(np.float64) @ cents.astype(np.float64).T, axis=1)
    np.testing.assert_array_equal(got, want)


def _png_folder(tmp_path, n=3, h=48, w=80):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        PIL.Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(d / f"{i:03d}.png")
    return d


@pytest.fixture(scope="module")
def tiny():
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    dim = jcfg.enc_embed_dim
    jhead = jmodel.RetrievalHead.init(jax.random.PRNGKey(3), backbone_dim=dim, hdims=[dim], nfeat=40)
    hparams = jax.tree.map(lambda x: np.asarray(x, np.float32), jhead.params)
    thead = tmodel.RetrievalHead(dim, [dim], 40)
    thead.load_state_dict(tconvert.retrieval_state_dict_from_jax(hparams))
    return params, jcfg, jmodel.RetrievalHead(hparams, nfeat=40), model, thead.eval()


@pytest.mark.parametrize("portrait", [False, True])
def test_collected_features_match_jax(tmp_path, tiny, portrait):
    params, jcfg, jhead, model, thead = tiny
    folder = _png_folder(tmp_path, h=80 if portrait else 48, w=48 if portrait else 80)
    ds = tds.load_dataset(str(folder))
    got = ttrain.collect_features(model, thead, ds, max_images=2)
    want = []
    for i in (0, 1):  # 3 images, 2 wanted: a step of 1
        img = np.asarray(PIL.Image.open(folder / f"{i:03d}.png").convert("RGB")).astype(np.float32) / 255.0
        x = j_resize_img(img, 512)["img"]
        feat, _ = jmast3r.encode_image(params, jcfg, jnp.asarray(x))
        want.append(np.asarray(jhead.prep_features(feat)[0]))
    want = np.concatenate(want)
    want /= np.maximum(np.linalg.norm(want, axis=1, keepdims=True), 1e-12)
    assert tuple(got.shape) == want.shape == (2 * 40, jcfg.enc_embed_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cli_writes_a_codebook_that_loads_not_degraded(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FRODO_ENTRY_TINY", "1")
    monkeypatch.chdir(tmp_path)  # the default checkpoint paths do not exist here
    folder = _png_folder(tmp_path, n=4)
    out = tmp_path / "cb" / "codebook.pkl"
    with pytest.warns(UserWarning):  # random weights and head: no checkpoint
        summary = ttrain.main(["--dataset", str(folder), "--out", str(out), "--centroids", "64",
                               "--iters", "3", "--max-images", "3", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["images"] == 3 and summary["features"] == 3 * 300 and summary["centroids"] == [64, 64]
    with open(out, "rb") as f:
        data = pickle.load(f)
    assert data["centroids"].dtype == np.float32 and data["centroids"].shape == (64, 64)
    np.testing.assert_allclose(np.linalg.norm(data["centroids"], axis=1), 1.0, atol=1e-5)
    db = tloader.load_retriever(tmast3r.tiny_config(), codebook_path=str(out), device="cpu")
    assert not db.degraded and db.codebook.size == 64
    assert data["head_fingerprint"] == tloader.head_fingerprint(db.head)
