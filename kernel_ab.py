#!/usr/bin/env python3
"""Kernel A/B on one card: the refine and attention kernels of another tree
(the parent commit) against this tree's, in the order P C C P.

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
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from frodo_slam_tpu_torch.ops import attention_kernel, refine_kernel
from frodo_slam_tpu_torch.tools import kernel_cases

PKG = "frodo_slam_tpu_torch"
REFINE_GRIDS = [(384, 512), (288, 512)]
REFINE_AB_CASES = ("identity_pm20", "smooth_warp")
ATTN_SHAPES = [(1, 16, 768, 768, 64), (1, 16, 576, 576, 64), (2, 12, 768, 768, 64),
               (4, 12, 768, 768, 64), (1, 12, 768, 768, 64), (1, 12, 576, 576, 64)]


def load_tree(root: pathlib.Path):
    """The kernel modules of the package under ``root``, imported apart from
    this tree's (which stay in ``sys.modules``)."""
    ours = {k: sys.modules.pop(k) for k in list(sys.modules) if k == PKG or k.startswith(PKG + ".")}
    sys.path.insert(0, str(root))
    try:
        ak = importlib.import_module(f"{PKG}.ops.attention_kernel")
        rk = importlib.import_module(f"{PKG}.ops.refine_kernel")
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]:
            sys.modules.pop(k)
        sys.modules.update(ours)
    if not pathlib.Path(ak.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"{ak.__file__} is not under {root}")
    return ak, rk


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


def gn_iterations(dev, model, attention, n_frames=12):
    """GN iterations per frame of the main path with ``attention`` in the
    model (one ``_safe_cholesky`` per iteration)."""
    from frodo_slam_tpu_torch.models import layers
    from frodo_slam_tpu_torch.slam import tracker
    from frodo_slam_tpu_torch.slam.system import SLAM

    per_frame = []
    real_chol, real_grab = tracker._safe_cholesky, SLAM.grab_rgb

    def counted(H):
        per_frame[-1] += 1
        return real_chol(H)

    def grab(self, *a, **k):
        per_frame.append(0)
        return real_grab(self, *a, **k)

    _main_path(dev, model, n_frames, [(tracker, "_safe_cholesky", counted),
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
    trees = {"parent": load_tree(pathlib.Path(args.parent)), "this": (attention_kernel, refine_kernel),
             **{pathlib.Path(o).name: load_tree(pathlib.Path(o)) for o in args.other}}
    with ThreadPoolExecutor(2 * len(trees)) as pool:
        list(pool.map(lambda mod: mod.build(), [mod for pair in trees.values() for mod in pair]))
    pak = trees["parent"][0]

    def ab(timer, call):
        """``call(attention module, refine module)`` timed for every tree."""
        ms = palindrome({name: (lambda t=t: call(*t)) for name, t in trees.items()}, timer)
        return dict(parent_ms=ms.pop("parent"), ms=ms.pop("this"), **{f"{k}_ms": t for k, t in ms.items()})

    def refine_ab(D11, D21, p1, radius, dmax):
        return ab(kernel_cases.cuda_ms, lambda ak, rk: rk.refine_matches(D11, D21, p1, radius, dmax))

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
        ms = ab(kernel_cases.cuda_ms_queued, lambda ak, rk: ak.flash_attention(q, k, v))
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


if __name__ == "__main__":
    main()
