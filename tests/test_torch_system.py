"""PyTorch port vs JAX package: the whole system through ``SLAM.grab_rgb``
at ``tiny_config`` with converted weights and the f32 refine
(``matching.refine_impl: gather``) on both sides. The frontend alone goes
INIT -> TRACK -> three losses -> map reset -> TRACK; with the keyframe
backend on (serialized), every identical frame becomes a keyframe and a
backend task, with and without odometry.

Bars: per-frame ``ok`` / ``new_kf`` exact, poses atol 1e-4, atlas equal,
edge and odometry counts equal.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from frodo_slam_tpu.config import make_config as j_make_config
from frodo_slam_tpu.data.image import resize_img as j_resize_img
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.slam.system import SLAM as JSLAM
from frodo_slam_tpu_torch import loader as tloader
from frodo_slam_tpu_torch.config import make_config as t_make_config
from frodo_slam_tpu_torch.data.image import resize_img as t_resize_img
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.slam.frame import Mode
from frodo_slam_tpu_torch.slam.system import SLAM as TSLAM

torch.set_num_threads(1)

H, W = 32, 64
# Q_conf 0: random weights give low descriptor confidences. A min_match_frac_fnn
# above what the fnn fallback finds on unrelated frames makes B, C, D fail.
OVERRIDES = dict(
    matching={"refine_impl": "gather"},
    tracking={"max_iters": 10, "Q_conf": 0.0, "min_match_frac_fnn": 0.05},
    tpu={"max_keyframes": 8},
)


def _overrides(match_frac_thresh=0.333):
    out = {k: dict(v) for k, v in OVERRIDES.items()}
    out["tracking"]["match_frac_thresh"] = match_frac_thresh
    return out


def _imgs():
    """A, A, A (tracks), B, C, D (three losses -> reset, re-init on D), D."""
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(4))
    return [a, a, a, b, c, d, d]


@pytest.fixture(scope="module")
def weights():
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]  # shared heads: identical frames track
    params["dec_blocks2"] = params["dec_blocks"]
    return params, jcfg


def _port_slam(weights, match_frac_thresh=1.1):
    params, _ = weights
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    return TSLAM(t_make_config(**_overrides(match_frac_thresh)), model, (H, W), use_backend=False,
                 device="cpu")


@pytest.mark.parametrize("match_frac_thresh", [0.333, 1.1])
def test_grab_rgb_matches_jax_slam(weights, match_frac_thresh):
    """0.333 (default): tracked frames stay on the keyframe; 1.1: every
    tracked frame becomes a keyframe (write-back + append)."""
    params, jcfg = weights
    js = JSLAM(j_make_config(**_overrides(match_frac_thresh)), params, jcfg, (H, W),
               use_backend=False, use_reloc=False)
    ts = _port_slam(weights, match_frac_thresh)
    flags = []
    for i, img in enumerate(_imgs()):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i))
        assert (okt, kft) == (okj, kfj), f"frame {i}"
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4, err_msg=f"frame {i}")
        flags.append((okt, kft))
    kf = match_frac_thresh > 1
    assert flags == [(True, True), (True, kf), (True, kf), (False, False), (False, False),
                     (False, True), (True, kf)]
    # three losses reset the map once
    assert len(ts.atlas) == len(js.atlas) == 1
    np.testing.assert_allclose(ts.atlas[0]["T_WC"], js.atlas[0]["T_WC"], atol=1e-4)
    assert ts.atlas[0]["timestamps"] == js.atlas[0]["timestamps"]
    assert ts.mode == Mode.TRACKING and ts.store.n_total == int(js.store.n_total)
    st, pt = ts.keyframe_poses()
    sj, pj = js.keyframe_poses()
    assert st == sj
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    ts.terminate()
    js.terminate()


def test_grab_rgb_pipelined_equals_grab_rgb(weights):
    seq = _port_slam(weights)
    pipe = _port_slam(weights)
    want = [seq.grab_rgb(img, timestamp=float(i)) for i, img in enumerate(_imgs())]
    got = [pipe.grab_rgb_pipelined(img, timestamp=float(i)) for i, img in enumerate(_imgs())]
    assert got[0] is None
    got = got[1:] + [pipe.flush()]
    assert pipe.flush() is None
    for (ok_w, T_w, kf_w), (ok_g, T_g, kf_g) in zip(want, got):
        assert (ok_g, kf_g) == (ok_w, kf_w)
        np.testing.assert_array_equal(T_g, T_w)
    assert len(pipe.atlas) == len(seq.atlas)


def test_next_img_lookahead_equals_plain(weights):
    plain = _port_slam(weights)
    ahead = _port_slam(weights)
    imgs = _imgs()[:4]
    for i, img in enumerate(imgs):
        want = plain.grab_rgb(img, timestamp=float(i))
        nxt = imgs[i + 1] if i + 1 < len(imgs) else None
        got = ahead.grab_rgb(img, timestamp=float(i), next_img=nxt)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])


def test_unported_options_raise(weights):
    params, _ = weights
    model = tmast3r.MASt3R(tmast3r.tiny_config())
    cfg = t_make_config()
    with pytest.raises(NotImplementedError, match='ROADMAP.md §1 "Frodo extras"'):
        TSLAM(cfg, model, (H, W), device="cpu", local_opt_mode=True)
    with pytest.raises(NotImplementedError, match='ROADMAP.md §1 "Frodo extras"'):
        TSLAM(t_make_config(height_prior={"enabled": True}), model, (H, W), device="cpu")
    # retrieval and relocalization are ported: a database builds, reloc on by default
    db = tloader.load_retriever(tmast3r.tiny_config(), path="no/such/retrieval.pth", device="cpu")
    slam = TSLAM(cfg, model, (H, W), retrieval_db=db, use_reloc=True, device="cpu")
    assert slam.retrieval is db and slam.use_reloc
    assert TSLAM(cfg, model, (H, W), device="cpu").use_reloc
    slam.grab_rgb(_imgs()[0], timestamp=0.0)  # map init inserts the first keyframe
    assert db.kf_counter == 1 and db.kf_ids == [0]
    slam.reset()  # a map reset clears the database
    assert db.kf_counter == 0 and db.kf_ids == [] and db.ivf.n_images == 0
    # the calibrated tracker and solve are ported: a calibration now builds
    slam = TSLAM(t_make_config(use_calib=True), model, (H, W), calib=np.eye(3), device="cpu")
    assert slam.tcfg.use_calib and tuple(slam.K.shape) == (3, 3)


# the success fixture of tests/test_system.py:41-54: shared heads, identical
# frames, every frame a keyframe; no retrieval database
BACKEND_OVERRIDES = dict(
    matching={"refine_impl": "gather"},
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 2},
    tpu={"max_keyframes": 8, "max_edges": 8, "max_odom_edges": 8},
)


def _backend_pair(weights, tracking=None, **tpu):
    params, jcfg = weights
    ov = {k: dict(v) for k, v in BACKEND_OVERRIDES.items()}
    ov["tpu"].update(tpu)
    ov["tracking"].update(tracking or {})
    js = JSLAM(j_make_config(**ov), params, jcfg, (H, W), retrieval_db=None, use_backend=True,
               use_reloc=False, single_thread=True)
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    ts = TSLAM(t_make_config(**ov), model, (H, W), use_backend=True, single_thread=True,
               device="cpu")
    return js, ts


def _odom(i):
    return np.array([0.1 * i, 0.02 * i, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0], np.float32)


@pytest.mark.parametrize("with_odom", [False, True], ids=["rays", "odometry"])
def test_backend_serialized_matches_jax_slam(weights, with_odom):
    """``SLAM(use_backend=True, single_thread=True)``: five identical frames,
    each a keyframe whose backend task inserts the consecutive edge (the
    tracker's half reused) and solves the window; with ``odom_pose`` per
    frame, odometry factors join the solve."""
    js, ts = _backend_pair(weights)
    img = _imgs()[0]
    for i in range(5):
        odom = _odom(i) if with_odom else None
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i), odom_pose=odom)
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i), odom_pose=odom)
        assert (okt, kft) == (okj, kfj) == (True, True), f"frame {i}"
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4, err_msg=f"frame {i}")
    assert len(ts.backend._pairs) == len(js.backend._pairs) == 4
    assert ts.backend._pairs == js.backend._pairs
    assert ts.backend._n_odom == js.backend._n_odom == (4 if with_odom else 0)
    st, pt = ts.keyframe_poses()
    sj, pj = js.keyframe_poses()
    assert st == sj and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    if with_odom:  # the odometry moved the keyframes off the rays' identity
        assert np.abs(pt[1:, :3]).max() > 1e-3
    ts.terminate()
    js.terminate()


@pytest.mark.parametrize("knob", ["no_half_reuse", "kf_sync_per_frame"])
def test_backend_knobs_match_jax(weights, knob):
    """``tpu.consecutive_half_reuse: false``: the backend decodes and matches
    both directions of the consecutive pair (add_factors).
    ``tpu.kf_sync_per_frame: true`` with the default keyframe threshold:
    tracked frames that stay on the keyframe write its fused pointmap back
    into the store every frame."""
    if knob == "no_half_reuse":
        js, ts = _backend_pair(weights, consecutive_half_reuse=False)
    else:
        js, ts = _backend_pair(weights, tracking={"match_frac_thresh": 0.333},
                               kf_sync_per_frame=True)
    img = _imgs()[0]
    for i in range(3):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i))
        assert (okt, kft) == (okj, kfj)
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    if knob == "no_half_reuse":
        assert ts.backend._pairs == js.backend._pairs == [(0, 1), (1, 2)]
    else:
        assert ts.store.n_total == int(js.store.n_total) == 1
        assert int(ts.store.N[0]) == int(js.store.N[0]) == 3  # fused twice after init
        # fused through T_CkCf, which agrees to 1e-4 (GN in f32), on points up to ~10
        np.testing.assert_allclose(ts.store.X_canon[0].numpy(), np.asarray(js.store.X_canon[0]),
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ts.keyframe_poses()[1], js.keyframe_poses()[1], atol=1e-4)


CONFIGS = sorted((pathlib.Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", [None] + CONFIGS, ids=lambda p: "defaults" if p is None else p.name)
def test_config_copy_loads_the_same_tree(path):
    """The port's own config loader reads every config file into the JAX
    package's tree."""
    arg = None if path is None else str(path)
    assert dict(t_make_config(arg)) == dict(j_make_config(arg))


@pytest.mark.parametrize("hw,size", [((480, 640), 512), ((300, 300), 224), ((200, 380), 128)])
def test_resize_img_copy_matches(hw, size):
    img = np.random.default_rng(hw[0]).uniform(size=(*hw, 3)).astype(np.float32)
    rj, tj = j_resize_img(img, size, return_transformation=True)
    rt, tt = t_resize_img(img, size, return_transformation=True)
    assert tj == tt
    for k in rj:
        np.testing.assert_array_equal(rt[k], rj[k])


def test_portrait_frames_match_jax_slam(weights):
    """Portrait input (height > width): stored transposed into the landscape
    layout, the model flagged portrait (a shallow copy sharing the weights)."""
    params, jcfg = weights
    ov = _overrides(1.1)
    js = JSLAM(j_make_config(**ov), params, jcfg, (W, H), use_backend=False, use_reloc=False)
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    ts = TSLAM(t_make_config(**ov), model, (W, H), use_backend=False, device="cpu")
    assert ts.portrait and ts.model.cfg.portrait and not model.cfg.portrait
    assert ts.model.enc_norm.weight is model.enc_norm.weight
    a, b = (np.swapaxes(x, 0, 1).copy() for x in _imgs()[2:4])
    for i, img in enumerate([a, a, b]):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i))
        assert (okt, kft) == (okj, kfj), f"frame {i}"
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    assert ts.store.n_total == int(js.store.n_total) == 2
