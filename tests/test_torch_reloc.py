"""PyTorch port vs JAX package: retrieval loop closure and relocalization
through ``SLAM.grab_rgb`` (the slice as a whole), and the threaded
relocalization's preemption of the backend backlog.

Parity: both packages' ``SLAM`` (the port's on the CPU) see one sequence on
the plane-world oracle of the synthetic harness (``scripts/eval_synthetic.py``
and its port ``frodo_slam_tpu_torch/tools/eval_synthetic.py``: real
nearest-pixel correspondences, a place signature in the encoder tokens), with
the same tiny weights (``convert.state_dict_from_jax``), the same retrieval
head (``convert.retrieval_state_dict_from_jax``) and codebook. Ten frames
along an arc, each a keyframe whose backend task adds the retrieved keyframes
as loop-closure edges; a frame far off the map (tracking fails, the strict
relocalization fails); a revisit of frame 1 (tracking fails against the last
keyframe, the relocalization succeeds) and of frame 2. The oracle patches the
model entry points module-wide and the JAX package caches its traces per
module, so the run is a subprocess: this file run as a script. Bars: per
frame ``(ok, new_kf)`` and ``loss_track_counter`` equal, every retrieval
result equal, the relocalization outcomes equal, ``backend._pairs`` equal
(loop edges included), poses within atol 1e-4 (the bar of
``test_backend_serialized_matches_jax_slam``). Retrieval keeps one keyframe
(``retrieval.k: 1``): the random head ranks the revisited place first but
not its neighbours, and the strict gate needs every retrieved pair to match.

The JAX package scores retrieval in f32 on its numpy branch; its native
branch, fed the port's library of the same C source, is the one held
bitwise (see ``test_torch_retrieval.py``).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 32, 64

OVERRIDES = dict(
    matching={"refine_impl": "gather"},
    # the tracking GN runs to its fixed point: with the default stopping rule
    # (a step under 1e-3) one package may stop an iteration before the other
    tracking={"min_match_frac": 0.1, "Q_conf": 0.0, "max_iters": 30, "match_frac_thresh": 1.1,
              "use_fnn": False, "rel_error": 1e-9, "delta_norm": 1e-9},
    local_opt={"Q_conf": 0.0, "min_match_frac": 0.2, "max_iters": 6},
    tpu={"max_keyframes": 32, "max_edges": 64, "max_odom_edges": 8},
    retrieval={"k": 1},
)


def _poses():
    from frodo_slam_tpu_torch.tools import eval_synthetic as tsynth

    T = tsynth.trajectory(10).numpy()
    far = T[5].copy()
    far[0] += 4.0  # 4 m sideways: a part of the plane the map never saw
    return [T[i] for i in range(10)] + [far, T[1], T[2]]


def _drive(slam, db, poses, encode):
    """Feed the poses' frames; record flags, match fractions, retrieval
    calls, relocalization outcomes."""
    calls, relocs, frames = [], [], []
    real_update, real_reloc = db.update, slam._relocalize

    def update(feat, add_after_query, k, min_thresh=0.0, kf_id=None):
        out = real_update(feat, add_after_query, k, min_thresh=min_thresh, kf_id=kf_id)
        calls.append([kf_id, bool(add_after_query), [int(i) for i in out]])
        return out

    def reloc(frame, timestamp):
        out = real_reloc(frame, timestamp)
        relocs.append([timestamp, bool(out)])
        return out

    db.update, slam._relocalize = update, reloc
    for t, P in enumerate(poses):
        ok, pose, new_kf = slam.grab_rgb(encode(P), timestamp=float(t))
        frames.append([bool(ok), bool(new_kf), int(slam.loss_track_counter),
                       [float(x) for x in np.asarray(pose)],
                       float(np.asarray(slam.last_track.flags)[0]) if t else 1.0])
    slam.terminate()
    stamps, kf_poses = slam.keyframe_poses()
    return {"frames": frames, "retrieval": calls, "reloc": relocs,
            "pairs": [[int(i), int(j)] for i, j in slam.backend._pairs],
            "kf_stamps": [float(s) for s in stamps], "kf_poses": np.asarray(kf_poses).tolist()}


def _run_both() -> dict:
    """Both packages on the plane-world sequence (run in a process of its own)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import eval_synthetic as jsynth  # the JAX harness: CPU platform, x64 on

    import jax

    from frodo_slam_tpu.config import make_config as j_make_config
    from frodo_slam_tpu.models import mast3r as jmast3r
    from frodo_slam_tpu.retrieval import asmk as jasmk
    from frodo_slam_tpu.retrieval.database import RetrievalDatabase as JDatabase
    from frodo_slam_tpu.retrieval.model import RetrievalHead as JHead
    from frodo_slam_tpu.slam.system import SLAM as JSLAM
    from frodo_slam_tpu_torch.config import make_config as t_make_config
    from frodo_slam_tpu_torch.models import convert as tconvert
    from frodo_slam_tpu_torch.models import mast3r as tmast3r
    from frodo_slam_tpu_torch.retrieval.asmk import Codebook as TCodebook
    from frodo_slam_tpu_torch.retrieval.database import RetrievalDatabase as TDatabase
    from frodo_slam_tpu_torch.retrieval.model import RetrievalHead as THead
    from frodo_slam_tpu_torch.slam.system import SLAM as TSLAM
    from frodo_slam_tpu_torch.tools import eval_synthetic as tsynth
    from frodo_slam_tpu_torch.utils import native as tnative

    torch.set_num_threads(1)
    jasmk._native, jasmk._native_hamming = tnative, tnative.hamming_cdist_packed
    jsynth.install_plane_oracle(tsynth.K_PLANE, 0.0, token_desc=True)
    tsynth.install_plane_oracle(tsynth.K_PLANE, 0.0, token_desc=True)

    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))

    jhead = JHead.init(jax.random.PRNGKey(1), backbone_dim=jcfg.enc_embed_dim, hdims=[jcfg.enc_embed_dim], nfeat=8)
    jhead.params = jax.tree.map(lambda x: np.asarray(x, np.float32), jhead.params)
    jdb = JDatabase(jhead, jasmk.Codebook.random(np.random.default_rng(0), 64, jcfg.enc_embed_dim))
    thead = THead(tcfg.enc_embed_dim, [tcfg.enc_embed_dim], nfeat=8)
    thead.load_state_dict(tconvert.retrieval_state_dict_from_jax(jhead.params))
    tdb = TDatabase(thead.eval(), TCodebook(jdb.codebook.centroids, device="cpu"))

    js = JSLAM(j_make_config(**OVERRIDES), params, jcfg, (H, W), retrieval_db=jdb, use_backend=True,
               use_reloc=True, single_thread=True)
    ts = TSLAM(t_make_config(**OVERRIDES), model, (H, W), retrieval_db=tdb, use_backend=True,
               use_reloc=True, single_thread=True, device="cpu")
    poses = _poses()
    return {"jax": _drive(js, jdb, poses, tsynth.encode_pose_image),
            "port": _drive(ts, tdb, poses, tsynth.encode_pose_image)}


@pytest.fixture(scope="module")
def both():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__], capture_output=True, text=True, timeout=900,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reloc_sequence_flags_match_jax(both):
    j, t = both["jax"], both["port"]
    flags = [f[:3] for f in t["frames"]]
    assert flags == [f[:3] for f in j["frames"]]
    assert [f[4] for f in t["frames"]] == [f[4] for f in j["frames"]]  # match fractions
    # ten keyframes; the far frame lost; the revisits relocalized
    assert flags[:10] == [[True, True, 0]] * 10
    assert flags[10] == [False, False, 1]
    assert flags[11][0] and flags[11][2] == 0
    assert t["reloc"] == j["reloc"]
    assert [ok for _, ok in t["reloc"]][:2] == [False, True]


def test_reloc_sequence_retrieval_and_pairs_match_jax(both):
    j, t = both["jax"], both["port"]
    assert t["retrieval"] == j["retrieval"]
    assert t["pairs"] == j["pairs"]
    loops = [(a, b) for a, b in t["pairs"] if abs(b - a) > 1]
    assert loops, t["pairs"]
    assert [10, 1] in t["pairs"]  # the relocalized keyframe's edge to the revisited one


def test_reloc_sequence_poses_match_jax(both):
    j, t = both["jax"], both["port"]
    np.testing.assert_allclose([f[3] for f in t["frames"]], [f[3] for f in j["frames"]], atol=1e-4)
    assert t["kf_stamps"] == j["kf_stamps"]
    np.testing.assert_allclose(t["kf_poses"], j["kf_poses"], atol=1e-4)
    assert np.isfinite(t["kf_poses"]).all()


# ---------------------------------------------------------------------------
# threaded: relocalization preempts the pending backlog
# ---------------------------------------------------------------------------

def test_reloc_preempts_pending_backend_tasks():
    """Relocalization waits out only the in-flight backend task, never the
    pending backlog (the reference backend services RELOC before popping
    optimizer tasks, vio.py:102-107), and the preempted tasks all run
    afterwards (JAX ``tests/test_system.py:340``). Ordered with events: the
    first solve holds the worker until the relocalization waits for it, so
    no step depends on how long anything takes."""
    import jax

    from frodo_slam_tpu.models import mast3r as jmast3r
    from frodo_slam_tpu_torch.config import make_config
    from frodo_slam_tpu_torch.models import convert as tconvert
    from frodo_slam_tpu_torch.models import mast3r as tmast3r
    from frodo_slam_tpu_torch.retrieval.asmk import Codebook
    from frodo_slam_tpu_torch.retrieval.database import RetrievalDatabase
    from frodo_slam_tpu_torch.retrieval.model import RetrievalHead
    from frodo_slam_tpu_torch.slam.system import SLAM

    torch.set_num_threads(1)
    jcfg = jmast3r.tiny_config()
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    params["head2"] = params["head1"]  # shared heads: identical frames track
    params["dec_blocks2"] = params["dec_blocks"]
    tcfg = tmast3r.tiny_config()
    model = tmast3r.MASt3R(tcfg).eval()
    model.load_state_dict(tconvert.state_dict_from_jax(params, tcfg))
    cfg = make_config(
        tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0, "max_iters": 10},
        local_opt={"Q_conf": 0.0, "min_match_frac": 0.0, "max_iters": 2},
        tpu={"max_keyframes": 16, "max_edges": 32, "max_odom_edges": 8})
    head = RetrievalHead.init(torch.Generator().manual_seed(1), backbone_dim=tcfg.enc_embed_dim,
                              hdims=[tcfg.enc_embed_dim], nfeat=8, device="cpu")
    db = RetrievalDatabase(head, Codebook.random(np.random.default_rng(0), 64, tcfg.enc_embed_dim, device="cpu"))
    slam = SLAM(cfg, model, (H, W), retrieval_db=db, use_backend=True, use_reloc=True,
                single_thread=False, device="cpu")

    order = []
    first_solve = threading.Event()
    release_first = threading.Event()
    real_solve = slam.backend.solve_window

    def gated_solve(store, s_bar=None):
        if not first_solve.is_set():
            first_solve.set()
            order.append("solve 1 holds")
            if not release_first.wait(timeout=120):
                raise RuntimeError("the first solve was never released")
        order.append("solve")
        return real_solve(store, s_bar)

    slam.backend.solve_window = gated_solve
    stats = []
    real_reloc = slam._relocalize

    def spying_reloc(frame, timestamp):
        q_before = slam._backend_tasks.qsize()
        order.append("reloc starts")
        out = real_reloc(frame, timestamp)
        order.append("reloc ends")
        stats.append((q_before, slam._backend_tasks.qsize(), out))
        return out

    slam._relocalize = spying_reloc

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    garbage = np.random.default_rng(99).uniform(0, 1, (H, W, 3)).astype(np.float32)
    slam.grab_rgb(img, timestamp=0.0)
    for i in range(4):  # four tasks: the first holds the worker, three pend
        ok, _, new_kf = slam.grab_rgb(img, timestamp=1.0 + i)
        assert ok and new_kf
    assert first_solve.wait(timeout=120)
    assert slam._backend_tasks.qsize() >= 2  # a real backlog exists

    # the garbage frame loses tracking: its relocalization waits for the
    # in-flight task on a thread of its own
    done = []
    lost = threading.Thread(target=lambda: done.append(slam.grab_rgb(garbage, timestamp=9.0)))
    lost.start()
    deadline = time.monotonic() + 120
    while not slam._reloc_gate.locked():  # the relocalization now waits for the in-flight task
        assert time.monotonic() < deadline and lost.is_alive()
        time.sleep(0.01)
    release_first.set()
    lost.join(timeout=120)
    assert not lost.is_alive() and done and done[0][0] is False

    (q_before, q_after, relocalized), = stats
    # the worker may have taken the next task off the queue: it waits at the gate
    assert q_before >= 2 and q_after >= q_before - 1, stats
    slam.terminate()  # the preempted tasks all run
    assert slam._backend_tasks.unfinished_tasks == 0 and slam._backend_worker is None
    # the in-flight task finished, then the relocalization, then the backlog
    assert order == ["solve 1 holds", "reloc starts", "solve", "reloc ends", "solve", "solve", "solve"], order
    poses = slam.keyframe_poses()[1]
    assert np.isfinite(poses).all() and poses.shape == (5, 8)


if __name__ == "__main__":
    print(json.dumps(_run_both()), flush=True)
