#!/usr/bin/env python3
"""Kernel A/B on one card: the refine, attention and ray-edge kernels of
another tree (the parent commit) against this tree's, in the order P C C P.

    git archive <parent> | tar -x -C build/parent
    python3 kernel_ab.py --parent build/parent [--other build/<tree> ...]

Both trees' kernels are built from their own sources (each tree's
``build/kernels/``). Inputs come from ``frodo_slam_tpu_torch/tools/
kernel_cases.py`` and from the frontend's main path (chip_smoke's ``main``:
ViT-L widths, random weights from seed 0, smooth random 288x512 frames,
backend off; 4 frames, every refine and attention call's inputs copied as
the kernel got them). Prints one JSON line per result; needs a card.

``--other`` trees (any revision of the package) are timed beside, each
under its directory's name, in the order parent, this, others, and back.

- refine: ``identity_pm20`` and ``smooth_warp`` at 384x512 and 288x512
  (radius 3, dilation 5) and the main path's calls, with how coherent their
  seeds are; CUDA events, median of 20 calls.
- attention: the shapes the main paths launch (bf16, head dim 64; 50 calls
  queued behind a spin kernel, per call), with
  ``scaled_dot_product_attention`` timed beside them (a yardstick only: the
  port never calls it); each kernel's error against
  ``flash_attention_plain`` on those inputs and on the main path's own
  attention inputs (relative to max(1, the plain output's largest
  magnitude), the bar of the card tests).
- GN iterations per frame of the main path (12 frames, fresh SLAM, the same
  model) with each attention in the model: this tree's kernel, the parent's,
  the plain version, and this tree's again (is the count repeatable?).
- ray_edge_systems: the ray cases of ``kernel_cases`` (the window shapes
  and the all-active rows, N = 147,456) and the first call of every window
  solve of the backend path (chip_smoke's ``backend_main``, serialized: ViT-L
  with shared heads and decoders, 12 identical 288x512 frames, every frame a
  keyframe, odometry), inputs copied as the kernel got them. Device ms (50
  calls queued behind a spin kernel) and single-call ms (events around one
  call) for every tree, and for this tree's kernel with its chunks sized
  from all E rows in place of the live ones (``rows_E``); a tree whose
  kernel takes the gathered ``XjT`` (the earlier signature) gets it made
  outside its timed window; every tree's error of B and of g against the
  f64 plain version, per live edge.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import numpy as np

from frodo_slam_tpu_torch.ops import attention_kernel, ba_reduce_kernel, refine_kernel
from frodo_slam_tpu_torch.tools import kernel_cases

PKG = "frodo_slam_tpu_torch"
REFINE_GRIDS = [(384, 512), (288, 512)]
REFINE_AB_CASES = ("identity_pm20", "smooth_warp")
ATTN_SHAPES = [(1, 16, 768, 768, 64), (1, 16, 576, 576, 64), (2, 12, 768, 768, 64),
               (4, 12, 768, 768, 64), (1, 12, 768, 768, 64), (1, 12, 576, 576, 64)]


class Tree:
    """The kernel modules of one tree: ``ak`` attention, ``rk`` refine,
    ``bk`` the ray-edge reduction."""

    def __init__(self, ak, rk, bk):
        self.ak, self.rk, self.bk = ak, rk, bk
        # earlier trees: ray_edge_systems(scal, XiT, XjT, w0); now (scal, XiT, w0, X, jj, active)
        self.ray_reads_x = "X" in inspect.signature(bk.ray_edge_systems).parameters

    def modules(self):
        return (self.ak, self.rk, self.bk)

    def ray_call(self, scal, XiT, w0, X, jj, active, n_active=None):
        """A no-argument call of this tree's ray kernel on these inputs; an
        old kernel's XjT is gathered here, outside the timed call."""
        kw = dict(sigma_ray=0.003, sigma_dist=10.0)
        if self.ray_reads_x:
            return lambda: self.bk.ray_edge_systems(scal, XiT, w0, X, jj, active, n_active=n_active, **kw)
        XjT = X.transpose(1, 2)[jj.long()].contiguous()
        return lambda: self.bk.ray_edge_systems(scal, XiT, XjT, w0, **kw)


def load_tree(root: pathlib.Path) -> Tree:
    """The kernel modules of the package under ``root``, imported apart from
    this tree's (which stay in ``sys.modules``)."""
    ours = {k: sys.modules.pop(k) for k in list(sys.modules) if k == PKG or k.startswith(PKG + ".")}
    sys.path.insert(0, str(root))
    try:
        ak = importlib.import_module(f"{PKG}.ops.attention_kernel")
        rk = importlib.import_module(f"{PKG}.ops.refine_kernel")
        bk = importlib.import_module(f"{PKG}.ops.ba_reduce_kernel")
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]:
            sys.modules.pop(k)
        sys.modules.update(ours)
    if not pathlib.Path(ak.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"{ak.__file__} is not under {root}")
    return Tree(ak, rk, bk)


def palindrome(fns: dict, timer) -> dict:
    """Each of ``fns`` timed twice, in the order a b ... b a."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        out[k].append(timer(fns[k]))
    return out


def _main_path(dev, model, n_frames, patches=()):
    """Run the main path for ``n_frames`` on a fresh SLAM with ``patches``
    ((module, name, value)) applied."""
    from frodo_slam_tpu_torch.config import make_config
    from frodo_slam_tpu_torch.data.synthetic import smooth_random_frames
    from frodo_slam_tpu_torch.slam.system import SLAM

    slam = SLAM(make_config(), model, (288, 512), use_backend=False, device=dev)
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, fn in patches:
            setattr(m, n, fn)
        for i, img in enumerate(smooth_random_frames(n_frames, 288, 512)):
            slam.grab_rgb(img, timestamp=float(i))
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        slam.terminate()


def capture_main_path(dev, model, n_frames=4):
    """The refine and attention calls of the main path, inputs copied as the
    kernels received them: (refine calls, attention calls)."""
    from frodo_slam_tpu_torch.models import layers
    from frodo_slam_tpu_torch.ops import matching

    refines, attns = [], []
    real_refine, real_attn = matching.refine_matches, layers.flash_attention

    def spy_refine(D11, D21, p1, radius=3, dilation_max=5, **kw):
        refines.append((D11.clone(), D21.clone(), p1.clone(), radius, dilation_max))
        return real_refine(D11, D21, p1, radius, dilation_max, **kw)

    def spy_attn(q, k, v):
        attns.append((q.clone(), k.clone(), v.clone()))
        return real_attn(q, k, v)

    _main_path(dev, model, n_frames, [(matching, "refine_matches", spy_refine),
                                      (layers, "flash_attention", spy_attn)])
    return refines, attns


def capture_backend_path(dev, model, n_frames=12):
    """The first ray-kernel call of every window solve of the serialized
    backend path, inputs copied as the kernel received them (the model's
    heads and decoders shared, so that identical frames track)."""
    from frodo_slam_tpu_torch.config import make_config
    from frodo_slam_tpu_torch.data.synthetic import smooth_random_frames
    from frodo_slam_tpu_torch.slam import backend, global_opt
    from frodo_slam_tpu_torch.slam.system import SLAM

    model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
    model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    cfg = make_config(tracking={"match_frac_thresh": 1.1, "min_match_frac": 0.0, "Q_conf": 0.0,
                                "max_iters": 10},
                      local_opt={"Q_conf": 0.0, "min_match_frac": 0.0})
    slam = SLAM(cfg, model, (288, 512), use_backend=True, single_thread=True, device=dev)
    calls, first = [], [False]
    real_solve, real_ray = backend.solve_gn_rays, global_opt.ray_edge_systems

    def solve(*a, **k):
        first[0] = True
        return real_solve(*a, **k)

    def ray(scal, XiT, w0, X, jj, active, **k):
        if first[0]:
            calls.append((*(t.clone() for t in (scal, XiT, w0, X, jj, active)), k.get("n_active")))
            first[0] = False
        return real_ray(scal, XiT, w0, X, jj, active, **k)

    backend.solve_gn_rays, global_opt.ray_edge_systems = solve, ray
    try:
        img = smooth_random_frames(1, 288, 512, seed=3)[0]
        for i in range(n_frames):
            odom = np.array([0.05 * i, 0.01 * i, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32)
            slam.grab_rgb(img, timestamp=float(i), odom_pose=odom)
    finally:
        backend.solve_gn_rays, global_opt.ray_edge_systems = real_solve, real_ray
        slam.terminate()
    return calls


def ray_errors(trees, args, n_active):
    """Each tree's largest per-live-edge error of B and of g against the f64
    plain version, each over that edge's largest |entry| of B (of g). Near
    the optimum g is ~0 and f32 rounding dominates its error."""
    scal, XiT, w0, X, jj, live = args
    Bp, gp = ba_reduce_kernel.ray_edge_systems_plain(scal.double(), XiT.double(), w0.double(), X.double(),
                                                     jj, live, sigma_ray=0.003, sigma_dist=10.0)
    out = {"err_B": {}, "err_g": {}}
    for name, t in trees.items():
        B, g = t.ray_call(*args, n_active=n_active)()
        for key, got, want in (("err_B", B, Bp), ("err_g", g, gp)):
            E = want.shape[0]
            scale = want.reshape(E, -1).abs().amax(1).clamp(min=1e-300)
            err = (got.double() - want).reshape(E, -1).abs().amax(1) / scale
            out[key][name] = float(err[live].max())
    return out


def gn_iterations(dev, model, attention, n_frames=12):
    """GN iterations per frame of the main path with ``attention`` in the
    model (one ``safe_cholesky`` per iteration)."""
    from frodo_slam_tpu_torch.models import layers
    from frodo_slam_tpu_torch.slam import tracker
    from frodo_slam_tpu_torch.slam.system import SLAM

    per_frame = []
    real_chol, real_grab = tracker.safe_cholesky, SLAM.grab_rgb

    def counted(H, eye):
        per_frame[-1] += 1
        return real_chol(H, eye)

    def grab(self, *a, **k):
        per_frame.append(0)
        return real_grab(self, *a, **k)

    _main_path(dev, model, n_frames, [(tracker, "safe_cholesky", counted),
                                      (layers, "flash_attention", attention), (SLAM, "grab_rgb", grab)])
    return per_frame


def seed_stats(p1, h, w):
    """How coherent a call's seeds are: unique seeds, the share on the image
    border, and the median over 32 x 12 tiles of the centres' bounding box."""
    u, v = p1[0, :, 0].reshape(h, w), p1[0, :, 1].reshape(h, w)
    border = ((u == 0) | (u == w - 1) | (v == 0) | (v == h - 1)).float().mean()
    tu = u[: h // 12 * 12, : w // 32 * 32].reshape(h // 12, 12, w // 32, 32)
    tv = v[: h // 12 * 12, : w // 32 * 32].reshape(h // 12, 12, w // 32, 32)
    span = lambda t: (t.amax((1, 3)) - t.amin((1, 3)) + 1).float()  # noqa: E731
    area = (span(tu) * span(tv)).flatten()
    return dict(unique=int(torch.unique(u * w + v).numel()), border_share=float(border),
                tile_box_px_median=float(area.median()), tile_box_px_p90=float(area.quantile(0.9)))


def attention_errors(kernels: dict, q, k, v) -> dict:
    """Each kernel's largest error against the plain version, relative to
    max(1, the plain output's largest magnitude), and whether the kernels'
    outputs are bitwise equal."""
    want = attention_kernel.flash_attention_plain(q, k, v).float()
    scale = max(float(want.abs().max()), 1.0)
    outs = {name: fa(q, k, v) for name, fa in kernels.items()}
    errs = {name: float((o.float() - want).abs().max()) / scale for name, o in outs.items()}
    first, *rest = outs.values()
    return dict(err=errs, equal=all(torch.equal(first, o) for o in rest))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree (holds frodo_slam_tpu_torch/)")
    ap.add_argument("--other", action="append", default=[], help="root of a further tree to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}), flush=True)
    trees = {"parent": load_tree(pathlib.Path(args.parent)),
             "this": Tree(attention_kernel, refine_kernel, ba_reduce_kernel),
             **{pathlib.Path(o).name: load_tree(pathlib.Path(o)) for o in args.other}}
    with ThreadPoolExecutor(3 * len(trees)) as pool:
        list(pool.map(lambda mod: mod.build(), [mod for t in trees.values() for mod in t.modules()]))
    pak = trees["parent"].ak

    def ab(timer, call, prefix=""):
        """``call(tree)`` timed for every tree."""
        ms = palindrome({name: (lambda t=t: call(t)) for name, t in trees.items()}, timer)
        return {f"{prefix}parent_ms": ms.pop("parent"), f"{prefix}ms": ms.pop("this"),
                **{f"{prefix}{k}_ms": t for k, t in ms.items()}}

    def refine_ab(D11, D21, p1, radius, dmax):
        return ab(kernel_cases.cuda_ms, lambda t: t.rk.refine_matches(D11, D21, p1, radius, dmax))

    def ray_ab(args, n_active):
        """Device ms and single-call ms of every tree's ray kernel, and of
        this tree's with its chunks sized from all E rows (``rows_E``: no
        ``n_active``)."""
        calls = {name: t.ray_call(*args, n_active=n_active) for name, t in trees.items()}
        calls["rows_E"] = trees["this"].ray_call(*args)
        out = {}
        for prefix, timer in (("device_", kernel_cases.cuda_ms_queued), ("single_", kernel_cases.cuda_ms)):
            ms = palindrome(calls, timer)
            out.update({f"{prefix}parent_ms": ms.pop("parent"), f"{prefix}ms": ms.pop("this"),
                        **{f"{prefix}{k}_ms": t for k, t in ms.items()}})
        return out

    for k, case in enumerate(kernel_cases.RAY_WINDOW_CASES + kernel_cases.RAY_ALL_ACTIVE_CASES):
        args = kernel_cases.ray_case(case, k, dev)
        A, D = kernel_cases.ray_counts(args[4], args[5])
        print(json.dumps({"kernel": "ray_edge_systems", "case": case, "E": int(args[4].shape[0]), "A": A,
                          "D": D, **ray_ab(args, A), **ray_errors(trees, args, A)}), flush=True)
        del args
        torch.cuda.empty_cache()

    for h, w in REFINE_GRIDS:
        for seed, case in enumerate(kernel_cases.REFINE_CASES):
            if case not in REFINE_AB_CASES:
                continue
            D11, D21, p1 = kernel_cases.refine_case(case, h, w, seed, dev)
            print(json.dumps({"kernel": "refine_matches", "shape": [h, w], "case": case,
                              **refine_ab(D11, D21, p1, 3, 5)}), flush=True)

    from frodo_slam_tpu_torch.models import mast3r
    model = mast3r.init_model(mast3r.MASt3RConfig(), seed=0, device=dev)
    main_refines, main_attns = capture_main_path(dev, model)
    for j, (D11, D21, p1, radius, dmax) in enumerate(main_refines):
        b, h, w, _ = D11.shape
        print(json.dumps({"kernel": "refine_matches", "shape": [h, w], "case": f"main_path_call_{j}",
                          "radius": radius, "dilation_max": dmax, **refine_ab(D11, D21, p1, radius, dmax),
                          **seed_stats(p1, h, w)}), flush=True)
    del main_refines

    attns = {"parent": pak.flash_attention, "this": attention_kernel.flash_attention}
    for i, shape in enumerate(ATTN_SHAPES):
        q, k, v = kernel_cases.attention_case(*shape, torch.bfloat16, 100 + i, dev)
        ms = ab(kernel_cases.cuda_ms_queued, lambda t: t.ak.flash_attention(q, k, v))
        lib = kernel_cases.cuda_ms_queued(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        e = attention_errors(attns, q, k, v)
        print(json.dumps({"kernel": "flash_attention", "shape": list(shape), **ms,
                          "library_ms": lib, "parent_err": e["err"]["parent"],
                          "err": e["err"]["this"], "equal_to_parent": e["equal"]}), flush=True)
    errs = [attention_errors(attns, q, k, v) for q, k, v in main_attns]
    shapes = sorted({tuple(q.shape) + (k.shape[2],) for q, k, _ in main_attns})
    del main_attns
    pe = torch.tensor([e["err"]["parent"] for e in errs])
    te = torch.tensor([e["err"]["this"] for e in errs])
    print(json.dumps({"kernel": "flash_attention", "case": "main_path_calls", "calls": len(errs),
                      "shapes": shapes, "parent_err_max": float(pe.max()), "err_max": float(te.max()),
                      "parent_err_median": float(pe.median()), "err_median": float(te.median()),
                      "calls_this_err_above_parent": int((te > pe).sum()),
                      "calls_equal_to_parent": sum(e["equal"] for e in errs)}), flush=True)

    runs = [("this", attention_kernel.flash_attention), ("parent", pak.flash_attention),
            ("plain", attention_kernel.flash_attention_plain), ("this", attention_kernel.flash_attention)]
    for name, fa in runs:
        it = gn_iterations(dev, model, fa)
        print(json.dumps({"gn_iterations": name, "per_frame": it,
                          "mean_frames_2_to_11": sum(it[2:]) / len(it[2:])}), flush=True)

    for j, (*args, n_active) in enumerate(capture_backend_path(dev, model)):
        A, D = kernel_cases.ray_counts(args[4], args[5])
        print(json.dumps({"kernel": "ray_edge_systems", "case": f"backend_path_solve_{j}",
                          "E": int(args[4].shape[0]), "A": A, "D": D, "n_active": n_active,
                          "zero_weight_share": float((args[2][args[5]] == 0).float().mean()),
                          **ray_ab(args, n_active), **ray_errors(trees, args, n_active)}), flush=True)


if __name__ == "__main__":
    main()
