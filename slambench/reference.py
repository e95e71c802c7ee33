"""The plain reference that decides ``correct``, and the numbers it compares.

A frozen, functional copy of the MASt3R forward pass as the port computes
it (``frodo_slam_tpu_torch/models/{mast3r,layers,dpt}.py`` at commit
b64ca557ffdbf94bf8f014549b988da65a7ba2ce): a ViT encoder with RoPE2D, twin
cross-attending decoders, a DPT head and a cat-MLP descriptor head per view,
and the metric checkpoint's output activations. Plain PyTorch over a state
dict, no kernel, no cache: every matrix product in f32 with TF32 off, the
attention as a softmax of the full score matrix. Two departures from the
port's code that do not change the function: the bilinear resizes are
``F.interpolate`` (the port gathers four corners and interpolates), the
transposed convolutions ``F.conv_transpose2d``.

``precision="bf16"`` computes it as the configuration states it for the
transformer: every product's operands, every linear's, norm's, attention's
and residual's output rounded to bf16 (the products accumulated in f32),
the heads in f32. Its distance from the f32 reference is the rounding that
a sound bf16 transformer of these weights shows, and it sets the scale of
``pts_rel_ratio``.

``precision="control"`` computes the same function one step below each
precision that the configuration states: the transformer's products in fp8
(e4m3, one scale a tensor, f32 accumulation) where it states bf16, the
heads' convolutions and products in TF32 where it states f32 with TF32 off
(on a CPU, which has no TF32, the heads stay f32).

The SLAM side of the reference (:func:`expected_session`) follows from the
traffic: every frame of a session is one image and the decoders are shared,
so the reference's two views of every pair are equal (asserted), every
residual the tracker or the window solve can form is zero at the identity,
and every pose it gives is the identity. Each keyframe's fused pointmap is
the reference's pointmap, and its confidence the reference's confidence
times the number of observations fused into it, counted by the port's rules
(``slam/tracker.py`` ``track_step_post``, ``slam/system.py``
``_finalize_track``): a keyframe slot is written with the keyframe's state
as it was when the next keyframe was made, the active keyframe gains one
observation a tracked frame. Of the backend, each keyframe after the
first adds one consecutive pair to the factor graph and one pair decode of
the direction the tracker did not give it (both of whose views are the
reference's pointmap), and the last window solve spans every keyframe.
The solve's poses are the identity whatever it does with them, so this
traffic cannot tell a solve from one that returns its input.

The heads are judged apart, on the program's own inputs
(:func:`head_rel_err`): a stage-wise check, since no number of the
pointmaps separates f32 heads from bf16 ones under a bf16 transformer.

Nothing here imports the program.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Ref:
    """The reference network over state dict ``sd`` (any types; used in f32)
    with widths ``m``."""

    def __init__(self, sd: Dict[str, torch.Tensor], m: Dict, precision: str = "f32"):
        if precision not in ("f32", "bf16", "control"):
            raise ValueError(f"precision {precision!r}")
        self.sd = {k: v.float() for k, v in sd.items()}
        self.m = m
        same = lambda x: x  # noqa: E731
        self.q = {"control": _fp8, "bf16": _bf16}.get(precision, same)  # a product's operands
        self.r = _bf16 if precision == "bf16" else same  # a layer's output
        self.head_tf32 = precision == "control"
        self.head_dtype = torch.float32

    # -- transformer ---------------------------------------------------------

    def lin(self, name, x):
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        return self.r(self.q(x) @ self.q(w).T + self.r(b))

    def ln(self, name, x):
        return self.r(F.layer_norm(x, x.shape[-1:], self.sd[f"{name}.weight"], self.sd[f"{name}.bias"], 1e-6))

    def rope(self, t, pos):
        half = t.shape[-1] // 2
        inv = 1.0 / (self.m["rope_base"] ** (torch.arange(0, half, 2, dtype=torch.float32, device=t.device) / half))

        def rot(x, p):
            f = p.float()[..., None] * inv
            f = torch.cat([f, f], dim=-1)[:, None]
            x1, x2 = x.chunk(2, dim=-1)
            return x * torch.cos(f) + torch.cat([-x2, x1], dim=-1) * torch.sin(f)

        return self.r(torch.cat([rot(t[..., :half], pos[..., 0]), rot(t[..., half:], pos[..., 1])], dim=-1))

    def attend(self, q, k, v):
        s = (self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        p = torch.softmax(s, dim=-1)
        o = self.q(p) @ self.q(v)
        b, h, n, d = o.shape
        return self.r(o.transpose(1, 2).reshape(b, n, h * d))

    def self_attn(self, name, x, pos, heads):
        b, n, d = x.shape
        qkv = self.lin(f"{name}.qkv", x).reshape(b, n, 3, heads, d // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return self.lin(f"{name}.proj", self.attend(self.rope(q, pos), self.rope(k, pos), v))

    def cross_attn(self, name, x, y, xpos, ypos, heads):
        b, n, d = x.shape
        sh = lambda t: t.reshape(b, -1, heads, d // heads).transpose(1, 2)  # noqa: E731
        q = sh(self.lin(f"{name}.projq", x))
        k = sh(self.lin(f"{name}.projk", y))
        v = sh(self.lin(f"{name}.projv", y))
        return self.lin(f"{name}.proj", self.attend(self.rope(q, xpos), self.rope(k, ypos), v))

    def mlp(self, name, x):
        return self.lin(f"{name}.fc2", self.r(F.gelu(self.lin(f"{name}.fc1", x))))

    def encode(self, img):
        """(1, H, W, 3) ImgNorm'd -> tokens (1, N, De), pos (1, N, 2)."""
        m = self.m
        p = m["patch_size"]
        b, h, w, c = img.shape
        gh, gw = h // p, w // p
        x = img.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        kern = self.sd["patch_embed.proj.weight"].permute(2, 3, 1, 0).reshape(p * p * c, -1)
        x = self.r(self.q(x) @ self.q(kern) + self.r(self.sd["patch_embed.proj.bias"]))
        yy, xx = torch.meshgrid(torch.arange(gh, device=img.device), torch.arange(gw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, gh * gw, 2)
        for i in range(m["enc_depth"]):
            b_ = f"enc_blocks.{i}"
            x = self.r(x + self.self_attn(f"{b_}.attn", self.ln(f"{b_}.norm1", x), pos, m["enc_num_heads"]))
            x = self.r(x + self.mlp(f"{b_}.mlp", self.ln(f"{b_}.norm2", x)))
        return self.ln("enc_norm", x), pos

    def decode(self, f1, p1, f2, p2):
        m = self.m
        x1, x2 = self.lin("decoder_embed", f1), self.lin("decoder_embed", f2)
        hd = m["dec_num_heads"]
        ys1, ys2 = [], []

        def block(pre, x, y, xp, yp):
            x = self.r(x + self.self_attn(f"{pre}.attn", self.ln(f"{pre}.norm1", x), xp, hd))
            y_ = self.ln(f"{pre}.norm_y", y)
            x = self.r(x + self.cross_attn(f"{pre}.cross_attn", self.ln(f"{pre}.norm2", x), y_, xp, yp, hd))
            return self.r(x + self.mlp(f"{pre}.mlp", self.ln(f"{pre}.norm3", x)))

        for i in range(m["dec_depth"]):
            x1, x2 = block(f"dec_blocks.{i}", x1, x2, p1, p2), block(f"dec_blocks2.{i}", x2, x1, p2, p1)
            ys1.append(x1)
            ys2.append(x2)
        L = m["dec_depth"]
        hooks = (L * 2 // 4 - 1, L * 3 // 4 - 1)
        return ([f1, ys1[hooks[0]], ys1[hooks[1]], self.ln("dec_norm", ys1[-1])],
                [f2, ys2[hooks[0]], ys2[hooks[1]], self.ln("dec_norm", ys2[-1])])

    # -- heads ---------------------------------------------------------------

    def conv(self, name, x, stride=1, bias=True):
        w = self.sd[f"{name}.weight"].to(self.head_dtype)
        b = self.sd[f"{name}.bias"].to(self.head_dtype) if bias else None
        return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)

    def convT(self, name, x, k):
        w = self.sd[f"{name}.weight"].to(self.head_dtype)
        return F.conv_transpose2d(x, w, self.sd[f"{name}.bias"].to(self.head_dtype), stride=k)

    def dpt(self, pre, hooks, gh, gw):
        """The DPT head of ``pre`` on its four hook token maps (B, N, C):
        the map (B, H, W, 4) before the output activations."""
        hooks = [t.to(self.head_dtype) for t in hooks]
        b = hooks[0].shape[0]
        d = f"{pre}.dpt"
        ap = f"{d}.act_postprocess"
        maps = [t.transpose(1, 2).reshape(b, t.shape[-1], gh, gw) for t in hooks]
        l1 = self.convT(f"{ap}.0.1", self.conv(f"{ap}.0.0", maps[0]), 4)
        l2 = self.convT(f"{ap}.1.1", self.conv(f"{ap}.1.0", maps[1]), 2)
        l3 = self.conv(f"{ap}.2.0", maps[2])
        l4 = self.conv(f"{ap}.3.1", self.conv(f"{ap}.3.0", maps[3]), stride=2)
        layers = [self.conv(f"{d}.scratch.layer{i + 1}_rn", t, bias=False) for i, t in enumerate((l1, l2, l3, l4))]

        def rcu(name, x):
            out = self.conv(f"{name}.conv1", F.relu(x))
            return self.conv(f"{name}.conv2", F.relu(out)) + x

        def fuse(i, x, res=None):
            r = f"{d}.scratch.refinenet{i}"
            if res is not None:
                x = x + rcu(f"{r}.resConfUnit1", res)
            x = rcu(f"{r}.resConfUnit2", x)
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
            return self.conv(f"{r}.out_conv", x)

        path4 = fuse(4, layers[3])[:, :, : layers[2].shape[2], : layers[2].shape[3]]
        path1 = fuse(1, fuse(2, fuse(3, path4, layers[2]), layers[1]), layers[0])
        x = self.conv(f"{d}.head.0", path1)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        x = self.conv(f"{d}.head.4", F.relu(self.conv(f"{d}.head.2", x)))
        return x.permute(0, 2, 3, 1)

    def local_mlp(self, pre, t):
        """The local-feature MLP of ``pre`` on the encoder and last decoder
        tokens concatenated (B, N, De + Dd): (B, N, (d + 1) p p)."""
        mw = lambda n: self.sd[f"{pre}.head_local_features.{n}"].to(self.head_dtype)  # noqa: E731
        t = t.to(self.head_dtype)
        return F.gelu(t @ mw("fc1.weight").T + mw("fc1.bias")) @ mw("fc2.weight").T + mw("fc2.bias")

    def head(self, pre, hooks, gh, gw):
        pts_conf = self.dpt(pre, hooks, gh, gw)
        p, dl = self.m["patch_size"], self.m["local_feat_dim"]
        t = self.local_mlp(pre, torch.cat([hooks[0].to(self.head_dtype), hooks[3].to(self.head_dtype)], dim=-1))
        local = t.reshape(1, gh, gw, dl + 1, p, p).permute(0, 1, 4, 2, 5, 3).reshape(1, gh * p, gw * p, dl + 1)
        f = torch.cat([pts_conf, local], dim=-1).float()
        xyz = f[..., 0:3]
        n = torch.linalg.norm(xyz, dim=-1, keepdim=True)
        return {"pts3d": xyz / torch.clamp(n, min=1e-8) * torch.expm1(n), "conf": 1.0 + torch.exp(f[..., 3]),
                "desc_conf": torch.exp(f[..., 4 + dl])}

    @torch.no_grad()
    def pair(self, img: torch.Tensor, with_hooks: bool = False):
        """Both views of the pair (img, img): (res1, res2), each with
        ``pts3d`` (1, h, w, 3) and ``conf`` (1, h, w); with ``with_hooks``
        also the heads' inputs (hooks1, hooks2, gh, gw)."""
        feat, pos = self.encode(img)
        h1, h2 = self.decode(feat, pos, feat, pos)
        p = self.m["patch_size"]
        gh, gw = img.shape[1] // p, img.shape[2] // p
        set_f32_numerics(tf32=self.head_tf32)
        try:
            out = (self.head("downstream_head1", h1, gh, gw), self.head("downstream_head2", h2, gh, gw))
        finally:
            set_f32_numerics()
        return out + ((h1, h2, gh, gw),) if with_hooks else out

    @torch.no_grad()
    def head_calls(self, hooks1, hooks2, gh, gw) -> List[tuple]:
        """This network's head calls on the given head inputs, in the form
        :func:`head_rel_err` judges: (kind, head, inputs, output)."""
        set_f32_numerics(tf32=self.head_tf32)
        try:
            calls = []
            for pre, hooks in (("downstream_head1", hooks1), ("downstream_head2", hooks2)):
                hooks = [t.to(self.head_dtype) for t in hooks]
                calls.append(("dpt", pre, hooks, self.dpt(pre, hooks, gh, gw)))
                t = torch.cat([hooks[0], hooks[3]], dim=-1)
                calls.append(("mlp", pre, t, self.local_mlp(pre, t)))
            return calls
        finally:
            set_f32_numerics()


def network_input(frame_u8: np.ndarray, long_side: int = 512) -> np.ndarray:
    """The network input, (1, h, w, 3) f32, of a camera frame (H, W, 3)
    uint8 handed to the system as f32 in [0, 1]: resized so that its long
    side is ``long_side`` (Lanczos when shrinking, bicubic otherwise, from
    the frame's 8-bit form), centre-cropped to multiples of 16 and
    ImgNorm'd (mean 0.5, std 0.5); a frame already at that size is only
    normalised. A frozen copy of the port's ``data/image.py`` ``resize_img``
    and ``SLAM.preprocess`` (the reference's own recipe,
    ``mast3r_utils.py:369-460``)."""
    import PIL.Image

    img = frame_u8.astype(np.float32) / 255.0
    pil = PIL.Image.fromarray(np.uint8(img * 255))
    W1, H1 = pil.size
    S = max(W1, H1)
    interp = PIL.Image.LANCZOS if S > long_side else PIL.Image.BICUBIC
    pil = pil.resize(tuple(int(round(x * long_side / S)) for x in pil.size), interp)
    W, H = pil.size
    cx, cy = W // 2, H // 2
    halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
    if W == H:
        halfh = int(3 * halfw / 4)
    pil = pil.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))
    if pil.size == (W1, H1):
        return ((img - 0.5) / 0.5)[None]
    return ((np.asarray(pil).astype(np.float32) / 255.0 - 0.5) / 0.5)[None]


def reference_views(ref: Ref, net_img: np.ndarray, device):
    """A reference's pointmap and confidence of one session's image, (hw, 3)
    and (hw, 1) f64 on the host, after checking that its two views agree
    (the ground for every identity pose below)."""
    set_f32_numerics()
    r1, r2 = ref.pair(torch.as_tensor(net_img, device=device))
    if not (torch.equal(r1["pts3d"], r2["pts3d"]) and torch.equal(r1["conf"], r2["conf"])):
        raise RuntimeError("reference: the two views of an identical pair differ")
    X = r1["pts3d"].reshape(-1, 3).double().cpu().numpy()
    C = r1["conf"].reshape(-1, 1).double().cpu().numpy()
    return X, C


@torch.no_grad()
def head_rel_err(ref: Ref, calls: List[tuple], device) -> float:
    """The heads at the precision the configuration states, judged on the
    program's own inputs. ``calls``: (kind, head, inputs, output) of head
    calls that the timed path made, ``kind`` "dpt" (inputs: the four hook
    token maps, output: the DPT map before its activations) or "mlp"
    (inputs: the concatenated encoder and decoder tokens, output: the
    local-feature MLP's). The largest, over the calls, of
    ||output - ref(inputs)|| / ||ref(inputs)||, the reference's heads in f32
    with TF32 off on the inputs as the program cast them; inf with no call.
    The pointmaps' numbers cannot tell the heads' rounding from the bf16
    transformer's, which is ten times larger; this one takes the
    transformer out."""
    if not calls:
        return float("inf")
    set_f32_numerics()
    p = ref.m["patch_size"]
    worst = 0.0
    for kind, pre, inp, out in calls:
        out = out.to(device).float()
        if kind == "dpt":
            r = ref.dpt(pre, [t.to(device) for t in inp], out.shape[1] // p, out.shape[2] // p)
        else:
            r = ref.local_mlp(pre, inp.to(device))
        worst = max(worst, float(torch.linalg.norm(out - r) / torch.linalg.norm(r).clamp(min=1e-30)))
    return worst


def set_f32_numerics(tf32: bool = False):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def expected_session(n_frames: int, match_frac_thresh: float) -> Dict:
    """What a session of ``n_frames`` identical frames must give, by the
    port's rules: each frame's kf flag and, for the store's slots and the
    active keyframe, how many observations were fused (N). The first frame
    initialises the map (a keyframe, N 1). A later frame is a keyframe when
    its unique match fraction is under ``match_frac_thresh``; an identical
    pair matches every pixel to itself, a fraction in (0.333, 1], so under
    1.1 always and under 0.333 never."""
    kf_every = match_frac_thresh > 1.0
    flags = [True] + [kf_every] * (n_frames - 1)
    slots: List[int] = [1]
    active = 1
    for f in flags[1:]:
        if f:
            slots[-1] = active  # the outgoing keyframe as it was (prev_kf)
            slots.append(1)
            active = 1
        else:
            active += 1
    return {"kf_flags": flags, "slot_N": slots, "active_N": active}


def _sim3_dist(T: np.ndarray, scale: float) -> np.ndarray:
    """Distance of Sim(3) poses (..., 8) [t, q(xyzw), s] from the identity:
    translation over the scene's scale, plus the rotation angle, plus
    |log s|."""
    t = np.linalg.norm(T[..., :3], axis=-1) / scale
    w = np.clip(np.abs(T[..., 6]) / np.maximum(np.linalg.norm(T[..., 3:7], axis=-1), 1e-30), 0.0, 1.0)
    return t + 2.0 * np.arccos(w) + np.abs(np.log(np.maximum(T[..., 7], 1e-30)))


def compare(sessions: List[Dict], refs: Dict[int, tuple], match_frac_thresh: float) -> Dict[str, float]:
    """The numbers compared, over every session the window ran.

    ``sessions``: what the program produced, one dict a session: ``image``
    (index), ``frames`` [(ok, T_WC (8,), new_kf)], ``poses`` (K, 8) of the
    live keyframes, ``X`` (K, hw, 3), ``C`` (K, hw, 1), ``N`` (K,) of the
    store's slots, ``active`` (X, C, N) of the active keyframe, and of the
    backend: ``pairs`` (its factor graph's keyframe pairs at the session's
    end), ``decodes`` (its pair decodes), ``backend_views`` [(X (hw, 3),
    C (hw, 1))] (both views of a sample of those decodes) and
    ``solve_poses`` (the poses of its last window solve, 0 for none).
    ``refs``: image index -> (X, C, X_bf16): :func:`reference_views` of the
    f32 reference and the pointmap of the bf16 one.

    - ``pts_rel_p50`` / ``pts_rel_p90``: quantiles, over every pixel of
      every stored and active keyframe, of |X - X_ref| / |X_ref|;
    - ``pts_rel_ratio``: ``pts_rel_p50`` over the same median of the bf16
      reference (``refs``' third entry) on the same maps' images; the larger
      of that and the same ratio over the backend's sampled decodes. Seeds
      differ fivefold in how far any rounding moves the pointmaps (the
      control reads 0.04 to 0.31); the ratio takes that out;
    - ``conf_excess_rel_p50``: the median, over the pixels whose reference
      confidence is not saturated (C_ref - 1 >= 1e-3; C = 1 + exp(z) is 1
      to f32 rounding below), of |C / N - C_ref| / (C_ref - 1), the
      relative error of exp(z); 0 where every pixel is saturated; the
      larger of the map's and the backend's decodes';
    - ``pose_dist_max``: the largest distance of a returned or stored pose
      from the reference's identity (translation over the reference's
      median point distance);
    - ``discrete_mismatch``: frames without a result, frames not ok, kf
      flags, keyframe counts and fused-observation counts that differ from
      :func:`expected_session`; the backend's pairs that differ from one
      consecutive pair a keyframe after the first, its decodes that differ
      from one a pair, and a last window solve that does not cover every
      keyframe of the session.
    """
    groups = {"map": ([], [], []), "backend": ([], [], [])}  # rel X, rel X of bf16, rel C
    dists = []
    bad = 0
    for s in sessions:
        X_ref, C_ref, X_b = refs[s["image"]]
        norm = np.linalg.norm(X_ref, axis=-1)
        rel_b = np.linalg.norm(X_b - X_ref, axis=-1) / np.maximum(norm, 1e-12)
        live = C_ref[:, 0] - 1.0 >= 1e-3
        scale = float(np.median(norm))
        exp = expected_session(s["n_submitted"], match_frac_thresh)
        frames = s["frames"]
        bad += s["n_submitted"] - len(frames)
        bad += sum(1 for ok, _, _ in frames if not ok)
        bad += sum(1 for (_, _, kf), e in zip(frames, exp["kf_flags"]) if bool(kf) != e)
        k = len(s["poses"])
        n_kf = len(exp["slot_N"])
        bad += abs(k - n_kf)
        pairs = sorted(tuple(int(v) for v in pr) for pr in s["pairs"])
        want = [(i - 1, i) for i in range(1, n_kf)]
        bad += sum(1 for a, b in itertools.zip_longest(pairs, want) if a != b)
        bad += abs(int(s["decodes"]) - (n_kf - 1))
        bad += int(int(s["solve_poses"]) != (n_kf if n_kf > 1 else 0))
        maps = [(s["X"][i], s["C"][i], int(s["N"][i]), n, "map") for i, n in enumerate(exp["slot_N"][:k])]
        aX, aC, aN = s["active"]
        maps.append((aX, aC, int(aN), exp["active_N"], "map"))
        maps += [(X, C, 1, 1, "backend") for X, C in s["backend_views"]]
        for X, C, n_got, n_exp, g in maps:
            bad += int(n_got != n_exp)
            rX, rB, rC = groups[g]
            rX.append(np.linalg.norm(X.astype(np.float64) - X_ref, axis=-1) / np.maximum(norm, 1e-12))
            rB.append(rel_b)
            rC.append(np.abs(C[live, 0].astype(np.float64) / n_exp - C_ref[live, 0]) / (C_ref[live, 0] - 1.0))
        poses = [T for _, T, _ in frames] + list(s["poses"])
        dists.append(_sim3_dist(np.asarray(poses, np.float64), scale))
    ratio, conf = [], []
    for rX, rB, rC in groups.values():
        if rX:
            ratio.append(float(np.median(np.concatenate(rX)) / max(np.median(np.concatenate(rB)), 1e-30)))
            rC = np.concatenate(rC)
            conf.append(float(np.median(rC)) if rC.size else 0.0)
    rel_X = np.concatenate(groups["map"][0])
    dists = np.concatenate(dists)
    return {
        "pts_rel_p50": float(np.median(rel_X)),
        "pts_rel_p90": float(np.quantile(rel_X, 0.9)),
        "pts_rel_ratio": max(ratio),
        "conf_excess_rel_p50": max(conf),
        "pose_dist_max": float(dists.max()),
        "discrete_mismatch": float(bad),
    }
