"""Multi-card placement of the port (``frodo_slam_tpu_torch.parallel.mesh``)
against the JAX package's ``parallel/mesh.py`` paths, in the JAX tests'
8-virtual-device process (tests/conftest.py): the port's device lists are
aliases of the CPU (slots 0-7), JAX's the eight virtual devices.

Bars: the placement rules equal ``default_mesh``'s at n = 1..8; the split
parameters equal the tp layout of ``_pspec_for_path`` on the decoder and
heads; the f32 tp-split decode within 1e-5 of the port's unsplit decode
(relative to each output's largest magnitude, floor 1) and within the model
parity bar of tests/test_torch_model.py (rtol 1e-3, atol 1e-4) of JAX's
sharded decode; bf16 split within 0.1 of the unsplit decode (same scale)
and within twice the unsplit bf16 decode's own distance to the f32 decode;
the real symmetric matcher split over dp ranks agrees with JAX's padded
sharded matcher and with the port's unsplit matcher on >= 97% of matches
(tests/test_torch_backend.py's bar: the projective matcher turns the decode's
float-level batch-size sensitivity into a few flipped matches; 99.6% measured
against the unsplit port); edge-split solves within
1e-5 of JAX's mesh solve and of the port's unsplit solve; ``SLAM`` with a
(4, 2) placement as JAX's ``test_slam_with_device_mesh``: flags and pairs
equal, poses within 1e-4 (tests/test_torch_system.py's bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frodo_slam_tpu.config import make_config as j_make_config
from frodo_slam_tpu.models import mast3r as jmast3r
from frodo_slam_tpu.parallel import mesh as jmesh
from frodo_slam_tpu.slam import global_opt as jgo
from frodo_slam_tpu.slam import inference as jinf
from frodo_slam_tpu.slam.system import SLAM as JSLAM
from frodo_slam_tpu_torch.config import make_config as t_make_config
from frodo_slam_tpu_torch.models import convert as tconvert
from frodo_slam_tpu_torch.models import mast3r as tmast3r
from frodo_slam_tpu_torch.models.layers import TensorParallel
from frodo_slam_tpu_torch.parallel import mesh as tmesh
from frodo_slam_tpu_torch.slam import backend as tbe
from frodo_slam_tpu_torch.slam import frame as tframe
from frodo_slam_tpu_torch.slam import global_opt as tgo
from frodo_slam_tpu_torch.slam import inference as tinf
from frodo_slam_tpu_torch.slam.system import SLAM as TSLAM
from frodo_slam_tpu_torch.tools import dryrun_multichip
from frodo_slam_tpu_torch.utils import checkpoint

from test_torch_calib import K as CALIB_K
from test_torch_calib import calib_world, one_way_edges
from test_torch_global_opt import consecutive_edges, j_edges, make_world, perturb, t_edges

torch.set_num_threads(1)

H, W = 32, 64
CPU = torch.device("cpu")
CPU8 = [CPU] * 8
# default_mesh's rules by hand: n -> (dp, tp, first backend slot), None on one device
RULES = {
    "overlap": {1: None, 2: (1, 1, 1), 3: (1, 2, 1), 4: (3, 1, 1), 5: (2, 2, 1), 6: (5, 1, 1),
                7: (3, 2, 1), 8: (7, 1, 1)},
    "shared": {1: None, 2: (1, 2, 0), 3: (3, 1, 0), 4: (2, 2, 0), 5: (5, 1, 0), 6: (3, 2, 0),
               7: (7, 1, 0), 8: (4, 2, 0)},
}


@pytest.fixture(scope="module")
def tiny():
    """Converted random tiny weights, shared heads and decoders (identical
    features decode consistently), f32 numpy on the JAX side."""
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]
    params["dec_blocks2"] = params["dec_blocks"]
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    return params, jcfg, model


def _mesh_slots(m):
    return np.vectorize(lambda d: d.id)(m.devices)


# ---------------------------------------------------------------------------
# the placement rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["overlap", "shared"])
def test_default_placement_matches_jax_default_mesh(placement):
    jm = jmesh.default_mesh(placement)
    tp = tmesh.default_placement(placement, CPU8)
    assert (tp.dp, tp.tp) == (jm.shape["dp"], jm.shape["tp"])
    np.testing.assert_array_equal(np.asarray(tp.grid_slots), _mesh_slots(jm))
    assert tp.tracker == tp.devices[0] == CPU and tp.solve_device == CPU


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("placement", ["overlap", "shared"])
def test_default_placement_rule_table(monkeypatch, placement, n):
    """The rule table at n devices, and JAX ``default_mesh`` seeing the
    first n of its virtual devices."""
    real = jax.devices()
    monkeypatch.setattr(jmesh.jax, "devices", lambda *a: real[:n])
    jm = jmesh.default_mesh(placement)
    tp = tmesh.default_placement(placement, [CPU] * n)
    want = RULES[placement][n]
    if want is None:
        assert tp is None and jm is None
        return
    dp, t, first = want
    assert (tp.dp, tp.tp) == (dp, t) == (jm.shape["dp"], jm.shape["tp"])
    assert tp.grid_slots == tuple(tuple(range(first + r * t, first + (r + 1) * t)) for r in range(dp))
    np.testing.assert_array_equal(np.asarray(tp.grid_slots), _mesh_slots(jm))
    assert tp.tracker == tp.devices[0]
    assert (0 in tp.backend_slots) == (placement == "shared")


def test_placement_refuses_what_it_cannot_place():
    with pytest.raises(ValueError, match="need 8 devices"):
        tmesh.make_placement(4, 2, [CPU] * 7)
    with pytest.raises(ValueError, match="does not exist"):
        tmesh.make_placement(1, 2, ["cpu", f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(ValueError, match="tpu.placement"):
        tmesh.default_placement("everywhere", CPU8)
    assert tmesh.visible_devices("cpu") == [CPU]
    assert tmesh.default_placement("overlap", tmesh.visible_devices("cpu")) is None


def test_pad_split_gather_batch():
    pl = tmesh.make_placement(4, 2, CPU8)
    x = torch.arange(3 * 2).reshape(3, 2)
    padded = tmesh.pad_to(x, 4)
    assert torch.equal(padded, torch.cat([x, x[-1:]]))
    assert tmesh.pad_to(x, 3) is x
    parts = tmesh.split_batch(x, pl)
    assert [tuple(p.shape) for p in parts] == [(1, 2)] * 4 and torch.equal(parts[3], x[2:])
    assert torch.equal(tmesh.gather_batch(parts, CPU, 3), x)
    assert torch.equal(tmesh.gather_batch([p.T for p in parts], CPU, 3, dim=1), x.T)


@pytest.mark.parametrize("E,parts", [(16, 8), (12, 4), (6, 1), (8, 8)])
def test_edge_parts_rule(E, parts):
    """JAX ``_build_edge_systems``: every device when dp * tp divides E, the
    dp ranks when dp does, else one part on the solve device."""
    pl = tmesh.make_placement(4, 2, CPU8)
    got = tmesh.edge_parts(E, pl)
    assert len(got) == parts and got[0][0] == 0 and got[-1][1] == E
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


# ---------------------------------------------------------------------------
# the tensor-parallel decoder
# ---------------------------------------------------------------------------

def _jax_path(name: str) -> str:
    """A port parameter name -> the JAX params path (stacked layers, no index)."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    path = "/".join(parts).replace("downstream_head", "head").replace("head_local_features", "catmlp/mlp")
    return path.replace("/weight", "/w").replace("/bias", "/b")


def test_split_parameters_equal_jax_tp_layout(tiny):
    """The parameters the replica actually splits (shard 0's shapes against
    the model's), mapped to JAX paths, are the decoder and head leaves that
    ``_pspec_for_path`` shards over ``tp``, with the same axis."""
    params, _, model = tiny
    rep = tmast3r.BackendReplica(model, [CPU, CPU])
    port = set()
    for path, mod in rep.named_modules():
        if isinstance(mod, TensorParallel):
            for name, p in mod.shards[0].named_parameters():
                full = model.get_parameter(f"{path}.{name}")
                if p.dim() == 2 and p.shape != full.shape:
                    port.add((_jax_path(f"{path}.{name}"), "out" if p.shape[0] < full.shape[0] else "in"))
    jax_set = set()
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        path = jmesh._path_str(kp)
        if not path.startswith(("dec_blocks", "head1", "head2")):
            continue
        spec = tuple(jmesh._pspec_for_path(path, np.ndim(leaf)))
        if "tp" in spec:
            jax_set.add((path, "out" if spec[-1] == "tp" else "in"))
    assert port == jax_set and len(port) == 20


def test_replica_shares_no_storage_and_keeps_head_width(tiny):
    _, _, model = tiny
    reps = tmesh.backend_replicas(model, tmesh.make_placement(2, 2, [CPU] * 4))
    own = {p.untyped_storage().data_ptr() for p in model.parameters()}
    for rep in reps:
        assert not own & {p.untyped_storage().data_ptr() for p in rep.parameters()}
        assert not hasattr(rep, "enc_blocks") and not hasattr(rep, "patch_embed")
        attn = rep.dec_blocks[0].attn
        assert attn.shards[0].num_heads == model.cfg.dec_num_heads // 2
        assert attn.shards[0].head_dim == model.dec_blocks[0].attn.head_dim
        # row-split projections: no bias in the shards, the whole bias once
        assert attn.shards[0].proj.bias is None
        torch.testing.assert_close(attn.bias, model.dec_blocks[0].attn.proj.bias, rtol=0, atol=0)


def _pair_batch(jcfg, n, seed=0):
    n_tok = (H // 16) * (W // 16)
    rng = np.random.default_rng(seed)
    fi = rng.normal(size=(n, n_tok, jcfg.enc_embed_dim)).astype(np.float32)
    fj = rng.normal(size=(n, n_tok, jcfg.enc_embed_dim)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H // 16), np.arange(W // 16), indexing="ij")
    pos = np.broadcast_to(np.stack([yy, xx], -1).reshape(1, n_tok, 2).astype(np.int32), (n, n_tok, 2))
    return fi, fj, np.ascontiguousarray(pos)


def _rel(a, b):
    b = torch.as_tensor(np.asarray(b, np.float32))
    return float((torch.as_tensor(np.asarray(a, np.float32)) - b).abs().max() / max(float(b.abs().max()), 1.0))


def test_tp_split_decode_matches_jax_sharded_decode(tiny):
    params, jcfg, model = tiny
    fi, fj, pos = _pair_batch(jcfg, 4)
    m = jmesh.make_mesh(4, 2)
    jp = jmesh.shard_params(params, m)
    with m:
        J = jax.jit(jinf.decode_symmetric_batch, static_argnames=("cfg", "img_hw"))(
            jp, jcfg, *(jmesh.shard_batch(jnp.asarray(a), m) for a in (fi, pos, fj, pos)), (H, W))
    pl = tmesh.make_placement(4, 2, CPU8)
    reps = tmesh.backend_replicas(model, pl)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    S = tinf.decode_symmetric_split(reps, pl, t(fi), t(pos), t(fj), t(pos), (H, W))
    U = tinf.decode_symmetric_batch(model, t(fi), t(pos), t(fj), t(pos), (H, W))
    for s, u, j in zip(S, U, J):
        assert s.shape == u.shape and s.device == CPU
        assert _rel(s, u) <= 1e-5
        np.testing.assert_allclose(s.numpy(), np.asarray(j), rtol=1e-3, atol=1e-4)


def test_tp_split_decode_bf16_bar(tiny):
    """The bar chip_smoke holds the ViT-L split decode to, at tiny width:
    partial sums rounded to bf16 move the outputs by about bf16's own noise."""
    _, _, model = tiny
    m16 = tmast3r.MASt3R(tmast3r.tiny_config(dtype=torch.bfloat16)).eval()
    m16.load_state_dict(model.state_dict())
    m16.cast_transformer_()
    fi, fj, pos = (torch.from_numpy(a) for a in _pair_batch(model.cfg, 2, seed=3))
    pl = tmesh.make_placement(2, 2, [CPU] * 4)
    S = tinf.decode_symmetric_split(tmesh.backend_replicas(m16, pl), pl, fi, pos, fj, pos, (H, W))
    U = tinf.decode_symmetric_batch(m16, fi, pos, fj, pos, (H, W))
    F = tinf.decode_symmetric_batch(model, fi, pos, fj, pos, (H, W))
    for s, u, f in zip(S, U, F):
        assert _rel(s, u) <= 0.1
        assert _rel(s, f) <= 2 * max(_rel(u, f), 1e-3)


def test_padded_dp_split_match_matches_jax_padded_shard_batch(tiny):
    """Three pairs over dp = 4: JAX pads to four with a copy of the last
    pair, shards the batch and drops the padded row (backend.py:232-246);
    the port's split over four ranks gives the same edges."""
    params, jcfg, model = tiny
    fi, fj, pos = _pair_batch(jcfg, 3, seed=1)
    mc = tuple(sorted(dict(j_make_config().matching, refine_impl="gather").items()))
    m = jmesh.make_mesh(4, 2)
    pad = lambda a: np.concatenate([a, a[-1:]])  # noqa: E731
    with m:
        J = jinf.match_symmetric(jmesh.shard_params(params, m), jcfg, dict(mc),
                                 *(jmesh.shard_batch(jnp.asarray(pad(a)), m) for a in (fi, pos, fj, pos)),
                                 (H, W))
    J = [np.asarray(a)[:3] for a in J]
    pl = tmesh.make_placement(4, 2, CPU8)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    S = tinf.match_symmetric_split(tmesh.backend_replicas(model, pl), pl, mc, t(fi), t(pos), t(fj), t(pos),
                                   (H, W))
    U = tinf.match_symmetric(model, mc, t(fi), t(pos), t(fj), t(pos), (H, W))
    assert [tuple(s.shape) for s in S] == [tuple(u.shape) for u in U] and S[0].shape[0] == 3
    for k in (0, 1):
        assert (S[k].numpy() == J[k]).mean() >= 0.97
        assert (S[k] == U[k]).float().mean() >= 0.97
    for k in range(4, 8):
        np.testing.assert_allclose(S[k].numpy(), J[k], rtol=1e-3, atol=1e-4)
        assert _rel(S[k], U[k]) <= 1e-5


def test_backend_add_factors_under_placement_matches_jax_mesh(tiny):
    """``BackendGraph(placement=)`` vs JAX ``BackendGraph(mesh=)``: three
    pairs padded over dp = 4, the same pairs accepted, the edges' matches
    agree (>= 97%), then the split window solve."""
    from frodo_slam_tpu.slam import backend as jbe

    from test_torch_backend import _feat_stores

    params, jcfg, model = tiny
    T_true, X = make_world(9, 4, H * W)
    js, ts = _feat_stores(jcfg, 4, T_true.astype(np.float32), X.astype(np.float32), seed=2)
    mc = tuple(sorted(dict(j_make_config().matching, refine_impl="gather").items()))
    jg = jbe.BackendGraph(params, jcfg, jgo.BAConfig(Q_conf=0.0), mc, (H, W), max_edges=8, max_odom=2,
                          mesh=jmesh.make_mesh(4, 2))
    pl = tmesh.make_placement(4, 2, CPU8)
    tg = tbe.BackendGraph(model, tgo.BAConfig(Q_conf=0.0), mc, (H, W), max_edges=8, max_odom=2, placement=pl)
    assert tg.device == CPU and len(tg.replicas) == 4
    for g, s in ((jg, js), (tg, ts)):
        assert g.add_factors(s, [0, 1, 2], [1, 2, 3])
    assert tg._pairs == jg._pairs == [(0, 1), (1, 2), (2, 3)]
    assert (tg.edges.idx[:6].numpy() == np.asarray(jg.edges.idx[:6])).mean() >= 0.97
    uj, pj, Tj = jg.solve_window_rays(js)
    ut, pt, Tt = tg.solve_window(ts)
    assert (ut, pt) == (uj, pj) and np.isfinite(Tt.numpy()).all()


# ---------------------------------------------------------------------------
# the edge-split window solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_kf", [5, 7, 4], ids=["E8_all_devices", "E12_dp", "E6_unsplit"])
def test_edge_split_ray_solve_matches_jax_mesh_and_unsplit(n_kf):
    """tests/test_global_opt.py:287-318's world: E = 2 (n_kf - 1) directed
    rows over a (4, 2) grid."""
    hw = 512
    T_true, X = make_world(6, n_kf, hw)
    T0 = perturb(T_true, 8).astype(np.float32)
    X = X.astype(np.float32)
    C = np.full((n_kf, hw, 1), 5.0, np.float32)
    d = consecutive_edges(n_kf, hw)
    o = dict(ii=np.zeros(1, np.int32), jj=np.zeros(1, np.int32),
             delta_T=np.array([[0, 0, 0, 0, 0, 0, 1.0]], np.float32), active=np.zeros(1, bool))
    sb = np.full((n_kf,), -1.0, np.float32)
    T_j = jgo.solve_gn_rays(jgo.BAConfig(edge_impl="xla"), 1, jnp.asarray(T0), jnp.asarray(X),
                            jnp.asarray(C), j_edges(d), jgo.OdomEdges(**{k: jnp.asarray(v) for k, v in o.items()}),
                            jnp.asarray(sb), mesh=jmesh.make_mesh(4, 2))
    pl = tmesh.make_placement(4, 2, CPU8)
    calls = []
    real = tgo.ray_edge_systems

    def spy(*a, **k):
        calls.append(a[1].shape[0])
        return real(*a, **k)

    args = lambda: (tgo.BAConfig(), 1, torch.from_numpy(T0), torch.from_numpy(X), torch.from_numpy(C),  # noqa: E731
                    t_edges(d), tgo.OdomEdges(**{k: torch.from_numpy(v) for k, v in o.items()}),
                    torch.from_numpy(sb))
    stats = {}
    tgo.ray_edge_systems, saved = spy, tgo.ray_edge_systems
    try:
        T_s = tgo.solve_gn_rays(*args(), stats=stats, placement=pl)
    finally:
        tgo.ray_edge_systems = saved
    T_u = tgo.solve_gn_rays(*args())
    E = 2 * (n_kf - 1)
    n_parts = len(tmesh.edge_parts(E, pl))
    assert calls == [E // n_parts] * (n_parts * stats["iters"])
    np.testing.assert_allclose(T_s.numpy(), T_u.numpy(), atol=1e-5)
    np.testing.assert_allclose(T_s.numpy(), np.asarray(T_j), atol=1e-5)


def test_edge_split_calib_solve_matches_unsplit():
    h, w, n_kf = 16, 32, 5  # E = 4 one-way rows: split over the four dp ranks
    T_true, T_init, X = calib_world(4, h, w, n_kf)
    d = one_way_edges(n_kf, h * w)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    o = tgo.OdomEdges(ii=torch.zeros(1, dtype=torch.int32), jj=torch.zeros(1, dtype=torch.int32),
                      delta_T=torch.tensor([[0, 0, 0, 0, 0, 0, 1.0]]), active=torch.zeros(1, dtype=torch.bool))
    kw = dict(max_iters=30, pin=1, delta_norm=1e-12)
    pl = tmesh.make_placement(4, 2, CPU8)
    assert len(tmesh.edge_parts(4, pl)) == 4
    outs = [tgo.solve_gn_calib(tgo.BAConfig(**kw), 1, (h, w), f32(T_init), f32(X),
                               torch.full((n_kf, h * w, 1), 5.0), f32(CALIB_K), t_edges(d), o,
                               torch.full((n_kf,), -1.0), placement=p) for p in (pl, None)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-5)
    assert np.abs(outs[0].numpy() - T_init).max() > 1e-3  # the solve moved the poses


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------

BACKEND_OVERRIDES = dict(
    matching={"refine_impl": "gather"},
    tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 2},
    tpu={"max_keyframes": 8, "max_edges": 8, "max_odom_edges": 8},
)


def _img(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def test_slam_with_placement_matches_jax_device_mesh(tiny):
    """JAX ``test_slam_with_device_mesh`` (tests/test_system.py:120-145):
    the backend's pair decode dp/tp-split over a (4, 2) grid through
    ``SLAM.grab_rgb``."""
    params, jcfg, model = tiny
    js = JSLAM(j_make_config(**BACKEND_OVERRIDES), params, jcfg, (H, W), retrieval_db=None,
               use_backend=True, use_reloc=False, single_thread=True, mesh=jmesh.make_mesh(4, 2))
    ts = TSLAM(t_make_config(**BACKEND_OVERRIDES), model, (H, W), use_backend=True, single_thread=True,
               device="cpu", placement=tmesh.make_placement(4, 2, CPU8))
    assert ts.backend.placement.dp == 4 and len(ts.backend.replicas) == 4
    img = _img(0)
    for i in range(3):
        okj, Tj, kfj = js.grab_rgb(img, timestamp=float(i))
        okt, Tt, kft = ts.grab_rgb(img, timestamp=float(i))
        assert (okt, kft) == (okj, kfj) == (True, True) and np.isfinite(Tt).all()
        np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    assert ts.backend._pairs == js.backend._pairs and len(ts.backend._pairs) >= 1
    (st, pt), (sj, pj) = ts.keyframe_poses(), js.keyframe_poses()
    assert st == sj and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    ts.terminate()
    js.terminate()


def test_slam_refuses_a_placement_elsewhere(tiny):
    _, _, model = tiny
    pl = tmesh.make_placement(1, 2, CPU8)
    bad = dataclasses.replace(pl, devices=(torch.device("meta"),) + pl.devices[1:])
    with pytest.raises(ValueError, match="tracker"):
        TSLAM(t_make_config(**BACKEND_OVERRIDES), model, (H, W), device="cpu", placement=bad)


def test_snapshot_onto_a_device_and_checkpoint_under_placement(tiny, tmp_path):
    """``kf_snapshot(device=)`` copies every tensor (no shared storage); a
    checkpoint of a placed SLAM restores into a placed SLAM."""
    _, _, model = tiny
    store = tframe.make_keyframe_store(4, 8, 2, 4)
    snap = tframe.kf_snapshot(store, device=CPU)
    for f in dataclasses.fields(store):
        a = getattr(store, f.name)
        if isinstance(a, torch.Tensor):
            assert a.untyped_storage().data_ptr() != getattr(snap, f.name).untyped_storage().data_ptr()
    make = lambda: TSLAM(t_make_config(**BACKEND_OVERRIDES), model, (H, W), use_backend=True,  # noqa: E731
                         single_thread=True, device="cpu",
                         placement=tmesh.default_placement("overlap", [CPU] * 3))
    a = make()
    for i in range(3):
        a.grab_rgb(_img(0), timestamp=float(i))
    path = checkpoint.save_slam_state(a, str(tmp_path / "ck.npz"))
    b = make()
    checkpoint.load_slam_state(b, path)
    assert b.backend._pairs == a.backend._pairs
    for f in ("idx", "valid", "Q", "XiT", "w0", "active"):
        assert torch.equal(getattr(b.backend.edges, f), getattr(a.backend.edges, f))
    np.testing.assert_array_equal(b.keyframe_poses()[1], a.keyframe_poses()[1])
    assert b.grab_rgb(_img(0), timestamp=3.0)[0]


def test_dryrun_multichip_eight_cpu_slots():
    """The dry run at n = 8 on the CPU passes JAX's bars (it raises
    otherwise): tp 2, dp 4; overlap keeps slot 0 for the tracker."""
    out = dryrun_multichip.main(["--n", "8", "--device", "cpu"])
    assert (out["dp"], out["tp"]) == (4, 2) and out["edge_parts"] == 8
    assert out["match_frac"] > 0.8 and out["match_correct"] > 0.98
    assert out["ba_err_after"] < 0.2 * out["ba_err_before"]
    assert 0 not in out["overlap"]["backend_slots"] and out["overlap"]["backend_slots"] == list(range(1, 8))
