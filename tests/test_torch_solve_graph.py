"""The window solve's GN step as a CUDA graph (``global_opt._StepGraph``),
PyTorch only (no JAX), so the card tests also run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_solve_graph.py -q   # on the card

On the card the graphed solve is held against the eager chain on the same
window: calibrated f64 and ray f32 windows at pose buckets 8, 16 and 32,
pin 1, dead edge rows, perturbed non-identity poses, scale priors; poses
within 1e-10 of the largest pose entry in f64 and 1e-5 in f32 (the two
assemblies add colliding blocks in orders that vary from run to run), the
iteration counts equal. At a cached window shape every iteration replays
and nothing is captured; a capture on a worker thread while another thread
launches eager work succeeds with both results right; windows with
odometry rows or split edge rows keep the eager chain.

On the CPU: the engagement rule, the split rule, the cache's hold and
eviction, the step counters at 0 under a profiler, and the loop's step
equal to :func:`global_opt._gn_step` after the seam.
"""

import threading
from functools import partial

import numpy as np
import pytest
import torch

from frodo_slam_tpu_torch.ops import lie
from frodo_slam_tpu_torch.parallel import mesh
from frodo_slam_tpu_torch.slam import global_opt as tgo
from frodo_slam_tpu_torch.utils import spans

torch.set_num_threads(1)

HW = (16, 32)
K = torch.tensor([[20.0, 0.0, 16.0], [0.0, 22.0, 8.0], [0.0, 0.0, 1.0]], dtype=torch.float64)


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def window(kind: str, bucket: int, seed: int = 0, device="cpu"):
    """A window as ``BackendGraph._build_window`` pads it: ``bucket - 3``
    live keyframes seeing one scene (each a perturbed non-identity Sim(3)),
    padded to ``bucket`` poses with copies of the last; both rows of every
    consecutive pair and of one loop pair (0, 2), padded to a power-of-two
    pair count with dead rows that hold stale data. ``kind`` "calib": the
    pixel-consistent pointmaps of a (16, 32) camera, f64 edge inputs;
    "rays": f32. Returns the solve's keyword arguments."""
    rng = np.random.default_rng(seed)
    n = bucket - 3
    h, w = HW
    v, u = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    z = rng.uniform(4.0, 8.0, h * w)
    X0 = torch.from_numpy(z[:, None] * np.stack([(u.reshape(-1) - 16.0) / 20.0, (v.reshape(-1) - 8.0) / 22.0,
                                                  np.ones(h * w)], -1))
    xis = rng.normal(size=(n, 7)) * np.array([0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.03])
    T_true = lie.sim3_exp(torch.from_numpy(xis))
    X = torch.stack([lie.sim3_act(lie.sim3_inv(T_true[k])[None], lie.sim3_act(T_true[0][None], X0))
                     for k in range(n)])
    noise = rng.normal(size=(n, 7)) * np.array([0.03] * 3 + [0.01] * 3 + [0.01])
    noise[0] = 0.0
    T = lie.sim3_retr(T_true, torch.from_numpy(noise))
    pad = bucket - n
    T = torch.cat([T, T[-1:].expand(pad, 8)])
    X = torch.cat([X, X[-1:].expand(pad, -1, -1)])
    pairs = [(k, k + 1) for k in range(n - 1)] + [(0, 2)]
    rows = 2 * _bucket(len(pairs))
    ii = np.zeros(rows, np.int32)
    jj = np.zeros(rows, np.int32)
    for k, (a, b) in enumerate(pairs):
        ii[2 * k], jj[2 * k], ii[2 * k + 1], jj[2 * k + 1] = a, b, b, a
    live = 2 * len(pairs)
    ii[live:], jj[live:] = 1, 3  # stale endpoints of dead rows
    active = np.arange(rows) < live
    dt = torch.float64 if kind == "calib" else torch.float32
    hw = h * w
    idx = np.tile(np.arange(hw, dtype=np.int32), (rows, 1))
    C = torch.full((bucket, hw, 1), 5.0, dtype=dt)
    edges = tgo.Edges(ii=torch.from_numpy(ii), jj=torch.from_numpy(jj), idx=torch.from_numpy(idx),
                      valid=torch.from_numpy(rng.uniform(size=(rows, hw)) > 0.1),
                      Q=torch.from_numpy(rng.uniform(2.0, 4.0, (rows, hw)).astype(np.float32)),
                      active=torch.from_numpy(active))
    X = X.to(dt)
    XiT, w0 = tgo._edges_pre(tgo.BAConfig(), X, C, edges)
    edges = edges._replace(XiT=XiT.contiguous(), w0=w0.contiguous())
    s_bar = torch.cat([torch.ones(n), -torch.ones(pad)]).to(torch.float32)
    out = dict(T_WC=T.to(dt), X=X.contiguous(), C=C, edges=edges, odom=tgo.empty_odom_edges(0), s_bar=s_bar,
               n_active=live)
    if kind == "calib":
        out.update(img_hw=HW, K=K)
    dev = torch.device(device)

    def to(v):  # tensors and the edge tuples onto the device
        if torch.is_tensor(v):
            return v.to(dev)
        return type(v)(*(t.to(dev) for t in v)) if hasattr(v, "_fields") else v

    return {k: to(v) for k, v in out.items()}


def solve(kind: str, win: dict, stats=None, **cfg):
    cfg = tgo.BAConfig(solve_f64=(kind == "calib"), **cfg)
    if kind == "calib":
        return tgo.solve_gn_calib(cfg, cfg.pin, win["img_hw"], win["T_WC"], win["X"], win["C"], win["K"],
                                  win["edges"], win["odom"], win["s_bar"], stats=stats, n_active=win["n_active"])
    return tgo.solve_gn_rays(cfg, cfg.pin, win["T_WC"], win["X"], win["C"], win["edges"], win["odom"],
                             win["s_bar"], stats=stats, n_active=win["n_active"])


def eager(monkeypatch, kind, win, stats=None):
    with monkeypatch.context() as m:
        m.setattr(tgo, "_graphs_engage", lambda *a: False)
        return solve(kind, win, stats)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,n_odom,split,engages", [
    ("cuda", 0, False, True), ("cpu", 0, False, False), ("cuda", 3, False, False), ("cuda", 0, True, False)])
def test_graphs_engage_on_a_card_with_local_rows_and_no_odometry(device, n_odom, split, engages):
    assert tgo._graphs_engage(torch.device(device), n_odom, split) is engages


def test_split_follows_the_edge_parts():
    """Rows leave the solve device only where a placement splits them."""
    cpu = torch.device("cpu")
    assert not tgo._split(16, cpu, None)
    assert tgo._split(16, cpu, mesh.make_placement(2, 1, [cpu] * 2))
    assert not tgo._split(15, cpu, mesh.make_placement(2, 1, [cpu] * 2))  # one part, on the solve device


def test_step_graph_cache_holds_and_evicts(monkeypatch):
    """A taken entry is not handed out twice; released, the same entry
    returns; past ``MAX_STEP_GRAPHS`` the least recently used free entries
    go, a held one stays."""
    monkeypatch.setattr(tgo, "_step_graphs", type(tgo._step_graphs)())
    monkeypatch.setattr(tgo, "MAX_STEP_GRAPHS", 2)
    a = tgo._step_graph("a")
    assert a is not None and tgo._step_graph("a") is None
    a.lock.release()
    assert tgo._step_graph("a") is a  # held again from here on
    for key in ("b", "c", "d"):
        tgo._step_graph(key).lock.release()
    assert list(tgo._step_graphs) == ["a", "d"]  # "b" and "c" went, the held "a" stayed
    a.lock.release()
    tgo._step_graph("e").lock.release()
    assert list(tgo._step_graphs) == ["d", "e"]


def test_step_graph_cache_under_threads(monkeypatch):
    """Twelve threads take and release the entries of three keys over a
    cache of two, with a short switch interval: no entry is ever held by two
    threads at once, and every take that fails finds its entry held."""
    import sys

    monkeypatch.setattr(tgo, "_step_graphs", type(tgo._step_graphs)())
    monkeypatch.setattr(tgo, "MAX_STEP_GRAPHS", 2)
    holders, faults, guard = {}, [], threading.Lock()

    def work(n):
        for i in range(400):
            entry = tgo._step_graph(("k", (n + i) % 3))
            if entry is None:
                continue
            with guard:
                if id(entry) in holders:
                    faults.append((n, i))
                holders[id(entry)] = n
            with guard:
                del holders[id(entry)]
            entry.lock.release()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(n,)) for n in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not faults and not holders
    assert len(tgo._step_graphs) <= 3


@pytest.mark.parametrize("kind", ["calib", "rays"])
def test_step_counters_read_zero_on_cpu(kind):
    """On the CPU the solve runs the eager chain: its span carries
    ``backend.step_replays`` and ``backend.step_captures`` at 0 beside its
    iterations, and ``stats`` says the same."""
    win = window(kind, 8)
    stats = {}
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("backend.solve_" + kind):
            solve(kind, win, stats)
    rec = [r for r in spans.records() if r["name"] == "backend.solve_" + kind]
    spans.clear()
    assert stats["iters"] >= 2 and stats["step_replays"] == stats["step_captures"] == 0
    assert rec[0]["counters"]["backend.step_replays"] == 0
    assert rec[0]["counters"]["backend.step_captures"] == 0
    assert rec[0]["counters"]["backend.solve_iters"] == stats["iters"]


@pytest.mark.parametrize("kind", ["calib", "rays"])
def test_loop_step_is_the_seam_then_gn_step(kind):
    """One iteration of the solve equals the seam's (B, g) handed to
    ``_gn_step``: the step the graph captures is the eager chain's."""
    win = window(kind, 16, seed=1)
    got = solve(kind, win, max_iters=1)
    cfg = tgo.BAConfig(solve_f64=(kind == "calib"))
    e = win["edges"]
    if kind == "calib":
        residual = partial(tgo._calib_residual, cfg, win["img_hw"])
        rows, shared = (e.idx, e.XiT, e.w0, e.active), (win["X"], win["K"])
    else:
        residual = partial(tgo._ray_residual, cfg)
        rows, shared = (e.XiT, e.w0, e.active), (win["X"],)
    T = win["T_WC"]
    B, g = tgo._edge_systems(residual, T, e.ii, e.jj, rows, shared, win["n_active"])(T)
    p = T.shape[0]
    eye = torch.eye(7 * (p - 1), dtype=torch.float64 if cfg.solve_f64 else torch.float32)
    want, _ = tgo._gn_step(1, 1.0 / cfg.sigma_scale_prior ** 2, tgo._lin(1, p, e, win["odom"], win["s_bar"]),
                           eye, T, B, g)
    assert torch.equal(got, want)
    assert (got[1:] - T[1:]).abs().max() > 1e-4  # a real step


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GN step's CUDA graph has no CPU mode")
    monkeypatch.setattr(tgo, "_step_graphs", type(tgo._step_graphs)())  # a cache of this test's own
    return torch.device("cuda")


TOL = {"calib": 1e-10, "rays": 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [8, 16, 32])
@pytest.mark.parametrize("kind", ["calib", "rays"])
def test_graphed_solve_matches_eager_on_card(card, monkeypatch, kind, bucket):
    """The graphed solve against the eager chain on the same window: the
    first solve at the shape runs iteration 1 eagerly, captures once and
    replays the rest; a repeated solve replays every iteration and captures
    nothing; the poses agree within ``TOL`` of the largest pose entry and
    the iteration counts are equal."""
    win = window(kind, bucket, seed=bucket, device=card)
    st_e, st_1, st_2 = {}, {}, {}
    want = eager(monkeypatch, kind, win, st_e)
    first = solve(kind, win, st_1)
    again = solve(kind, win, st_2)
    torch.cuda.synchronize()
    assert st_e["step_replays"] == st_e["step_captures"] == 0
    assert st_1["iters"] == st_2["iters"] == st_e["iters"] >= 2
    assert st_1["step_captures"] == 1 and st_1["step_replays"] == st_1["iters"] - 1
    assert st_2["step_captures"] == 0 and st_2["step_replays"] == st_2["iters"]
    scale = float(want.abs().max())
    for got in (first, again):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert float((got - want).abs().max()) <= TOL[kind] * scale
    assert float((want[1:] - win["T_WC"][1:]).abs().max()) > 1e-4  # the solve moved the poses
    assert first.data_ptr() != again.data_ptr()  # the result is the caller's, not the graph's buffer


@pytest.mark.cuda
def test_step_counters_on_the_solve_span_on_card(card):
    """Under a profiler, a solve at a cached shape carries
    ``backend.step_replays`` equal to its ``backend.solve_iters`` and no
    ``backend.step_captures``."""
    win = window("calib", 16, device=card)
    solve("calib", win)  # the shape's capture
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("backend.solve_calib"):
            solve("calib", win)
    c = [r for r in spans.records() if r["name"] == "backend.solve_calib"][0]["counters"]
    spans.clear()
    assert c["backend.step_replays"] == c["backend.solve_iters"] >= 2
    assert c["backend.step_captures"] == 0
    assert c["backend.calib_launches"] == c["backend.solve_iters"]


@pytest.mark.cuda
def test_capture_on_a_worker_thread_beside_eager_launches(card, monkeypatch):
    """A worker thread's solve captures its step while the main thread
    keeps launching eager kernels and fetching their results: the capture
    succeeds, the worker's poses equal the eager chain's and the main
    thread's sums are right."""
    win = window("rays", 16, seed=5, device=card)
    want = eager(monkeypatch, "rays", win)
    out, done = {}, threading.Event()

    def worker():
        try:
            st = {}
            out["T"] = solve("rays", win, st)
            out["stats"] = st
        except BaseException as e:  # noqa: BLE001  (reported by the main thread)
            out["error"] = e
        finally:
            done.set()

    x = torch.arange(4096, dtype=torch.float64, device=card)
    sums = []
    t = threading.Thread(target=worker)
    t.start()
    while not done.is_set() or len(sums) < 8:
        y = torch.cumsum(x * 2.0, 0) - x
        sums.append(float(y[-1]))  # a host fetch on the main thread's stream
    t.join()
    assert "error" not in out, out.get("error")
    assert out["stats"]["step_captures"] == 1 and out["stats"]["step_replays"] == out["stats"]["iters"] - 1
    n = 4096
    assert all(s == 2.0 * n * (n - 1) / 2 - (n - 1) for s in sums)
    assert float((out["T"] - want).abs().max()) <= TOL["rays"] * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odometry", "split"])
def test_odometry_or_split_windows_stay_eager_on_card(card, case):
    """A window with odometry rows, or with its edge rows split over a
    placement's devices (aliases of the card), runs the eager chain: no
    replay, no capture."""
    win = window("rays", 8, device=card)
    cfg = tgo.BAConfig(solve_f64=False)
    kw = dict(stats={}, n_active=win["n_active"])
    odom = win["odom"]
    if case == "odometry":
        odom = tgo.OdomEdges(ii=torch.tensor([1], dtype=torch.int32, device=card),
                             jj=torch.tensor([2], dtype=torch.int32, device=card),
                             delta_T=lie.se3_identity((1,), device=card),
                             active=torch.ones(1, dtype=torch.bool, device=card))
    else:
        kw["placement"] = mesh.make_placement(2, 1, [card] * 2)
    T = tgo.solve_gn_rays(cfg, cfg.pin, win["T_WC"], win["X"], win["C"], win["edges"], odom, win["s_bar"], **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(T).all() and kw["stats"]["iters"] >= 1
    assert kw["stats"]["step_replays"] == kw["stats"]["step_captures"] == 0
    assert len(tgo._step_graphs) == 0
