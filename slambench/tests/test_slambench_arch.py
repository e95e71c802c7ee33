"""A second architecture comes in as files: a toy written only into a
temporary root (its module under ``slambench/archs/``, a configuration with
``model.arch: toy``, limits, a traffic mix and a ``BENCHMARK.json`` naming
it) is found by ``load_cell``, and the seam builds its model, weights and
reference, hooks its head, gives its counts and reads its work through the
repository's own readers. The repository's tree is left as it was."""

import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from slambench import run, yardstick
from slambench.probe import Probe

TOY = textwrap.dedent('''
    """A plain two-block ViT at patch 14 with a linear pointmap + confidence
    head: one view an image, its forward in one span."""
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    from slambench.yardstick import attention_bound, ITEMSIZE

    MODEL_SPANS = ("model.encode",)


    def param_specs(m):
        d, p = m["embed_dim"], m["patch_size"]
        out = [("patch.weight", (d, 3 * p * p)), ("patch.bias", (d,))]
        for i in range(m["depth"]):
            for name, o, k in (("qkv", 3 * d, d), ("proj", d, d), ("fc1", 4 * d, d), ("fc2", d, 4 * d)):
                out += [(f"blocks.{i}.{name}.weight", (o, k)), (f"blocks.{i}.{name}.bias", (o,))]
        return out + [("head.weight", (4 * p * p, d)), ("head.bias", (4 * p * p,))]


    def make_weights(m, seed, device, dtype=torch.float32, head_dtype=torch.float32):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        sd = {}
        for name, shape in param_specs(m):
            t = torch.empty(shape, dtype=head_dtype if name.startswith("head.") else dtype, device=device)
            t.normal_(generator=gen)
            sd[name] = t.mul_(shape[-1] ** -0.5) if len(shape) > 1 else t.zero_()
        return sd


    def _patches(img, p):
        b, h, w, c = img.shape
        x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)


    def _tokens(lin, m, img):
        x = lin("patch", _patches(img, m["patch_size"]))
        for i in range(m["depth"]):
            b, n, d = x.shape
            h = m["num_heads"]
            q, k, v = lin(f"blocks.{i}.qkv", x).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
            a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // h), -1) @ v
            x = x + lin(f"blocks.{i}.proj", a.transpose(1, 2).reshape(b, n, d))
            x = x + lin(f"blocks.{i}.fc2", F.gelu(lin(f"blocks.{i}.fc1", x)))
        return x


    def _views(out, p, gh, gw):
        f = out.reshape(1, gh, gw, p, p, 4).permute(0, 1, 3, 2, 4, 5).reshape(-1, 4).double()
        return f[:, :3] * 2.0 + torch.tensor([0.0, 0.0, 4.0], dtype=f.dtype), 1.0 + f[:, 3:].exp()


    class ToyNet(torch.nn.Module):
        """The program's model: the same function as modules."""

        def __init__(self, m, sd):
            super().__init__()
            self.m = m
            self.w = torch.nn.ParameterDict({k.replace(".", "_"): torch.nn.Parameter(v, requires_grad=False)
                                             for k, v in sd.items() if not k.startswith("head.")})
            self.head = torch.nn.Linear(m["embed_dim"], sd["head.weight"].shape[0])
            self.head.load_state_dict({"weight": sd["head.weight"], "bias": sd["head.bias"]})

        def forward(self, img):
            w = lambda n: self.w[n.replace(".", "_")]  # noqa: E731
            lin = lambda n, x: x @ w(f"{n}.weight").T + w(f"{n}.bias")  # noqa: E731
            p = self.m["patch_size"]
            return _views(self.head(_tokens(lin, self.m, img)), p, img.shape[1] // p, img.shape[2] // p)


    def build_model(m, sd, dtype, head_dtype):
        return ToyNet(m, sd).eval()


    class Ref:
        def __init__(self, sd, m, precision):
            self.sd, self.m = {k: v.float() for k, v in sd.items()}, m
            self.q = (lambda x: x.to(torch.bfloat16).float()) if precision != "f32" else (lambda x: x)

        def lin(self, name, x):
            return self.q(x) @ self.q(self.sd[f"{name}.weight"]).T + self.sd[f"{name}.bias"]

        def head(self, t):
            return t @ self.sd["head.weight"].T + self.sd["head.bias"]

        @torch.no_grad()
        def view(self, img):
            p = self.m["patch_size"]
            t = _tokens(self.lin, self.m, img)
            return _views(self.head(t), p, img.shape[1] // p, img.shape[2] // p), t


    def make_reference(sd, m, precision="f32"):
        return Ref(sd, m, precision)


    def net_input(frame_u8, long_side):
        """Centre-cropped to multiples of 14, ImgNorm'd."""
        h, w = frame_u8.shape[:2]
        y, x = (h % 14) // 2, (w % 14) // 2
        img = frame_u8[y: y + h - h % 14, x: x + w - w % 14].astype(np.float32) / 255.0
        return ((img - 0.5) / 0.5)[None]


    def ref_views(ref, net, device):
        (X, C), _ = ref.view(torch.as_tensor(net, device=device))
        return X.cpu().numpy(), C.cpu().numpy()


    def control_views(ref, ctrl, net, device):
        (X, C), t = ctrl.view(torch.as_tensor(net, device=device))
        return X.cpu().numpy(), C.cpu().numpy(), head_err(ref, [("mlp", "head", t, ctrl.head(t))], device)


    def head_modules(model):
        return [("mlp", "head", model.head)]


    @torch.no_grad()
    def head_err(ref, calls, device):
        if not calls:
            return float("inf")
        worst = 0.0
        for _, _, inp, out in calls:
            r = ref.head(inp.to(device).float())
            worst = max(worst, float(torch.linalg.norm(out.to(device).float() - r) / torch.linalg.norm(r)))
        return worst


    def flops(m, img_hw):
        p, d = m["patch_size"], m["embed_dim"]
        n = (img_hw[0] // p) * (img_hw[1] // p)
        block = 2 * n * d * 12 * d + 4 * n * n * d
        out = {"encode": 2 * n * 3 * p * p * d + m["depth"] * block, "head": 2 * n * d * 4 * p * p}
        out["total"] = out["encode"] + out["head"]
        return out


    def forward_bounds(m, img_hw, batch, dtype):
        p, d, h = m["patch_size"], m["embed_dim"], m["num_heads"]
        n = (img_hw[0] // p) * (img_hw[1] // p)
        return {"model.encode": m["depth"] * attention_bound(batch, h, n, n, d // h, ITEMSIZE[dtype])}
''')

CONFIG = textwrap.dedent('''
    model:
      arch: toy
      patch_size: 14
      embed_dim: 32
      depth: 2
      num_heads: 2
    camera: {height: 60, width: 80, long_side: 80}
    tpu: {dtype: float32, head_dtype: float32}
''')
SEED = 2 ** 31 + 77


def snapshot(root: pathlib.Path):
    return {p.relative_to(root).as_posix(): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in (root / "slambench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def toy_root(tmp_path):
    here = run.ROOT / "slambench"
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    sb = tmp_path / "slambench"
    for d in ("archs", "configs", "limits", "traffic"):
        (sb / d).mkdir(parents=True)
    (sb / "archs" / "toy.py").write_text(TOY)
    (sb / "configs" / "toy.yaml").write_text(CONFIG)
    (sb / "configs" / "nope.yaml").write_text(CONFIG.replace("arch: toy", "arch: nope"))
    (sb / "traffic" / "track.json").write_text((here / "traffic" / "track.json").read_text())
    limits = json.loads((here / "limits" / "mast3r-vitl-384x512-tum-calib.json").read_text())
    for conf in ("toy-vit", "nope-vit"):
        (sb / "limits" / f"{conf}.json").write_text(json.dumps(limits))
    readers = ("attn_roofline_pct", "mfu_pct", "model_dev_ms")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(dict(
        bench,
        configs=[{"name": f"{a}-vit", "source": "https://arxiv.org/abs/2010.11929",
                  "file": f"slambench/configs/{a}.yaml", "reduced": [], "why": "a toy"} for a in ("toy", "nope")],
        workloads=[{"name": f"{a}.track", "config": f"{a}-vit", "traffic": "track", "chips": 1, "why": "a toy"}
                   for a in ("toy", "nope")],
        per_layer=[dict(m, workloads=["toy.track"]) for m in bench["per_layer"] if m["name"] in readers])))
    before = snapshot(run.ROOT)
    yield tmp_path
    assert snapshot(run.ROOT) == before


def test_a_second_architecture_comes_in_as_files(toy_root):
    c = run.load_cell("toy.track", toy_root)
    assert c["arch"] == "toy" and c["root"] == toy_root
    assert [m["name"] for m in c["per_layer"]] == ["mfu_pct", "attn_roofline_pct", "model_dev_ms"]
    arch = run.load_arch(c["arch"], c["root"])
    m, cam = c["config"]["model"], c["config"]["camera"]

    # the model on the seeded weights, against its reference
    sd = arch.make_weights(m, SEED, "cpu", dtype=torch.float32, head_dtype=torch.float32)
    assert all(torch.equal(v, arch.make_weights(m, SEED, "cpu")[k]) for k, v in sd.items())
    model = arch.build_model(m, sd, torch.float32, torch.float32)
    frame = yardstick.wave_field(np.random.default_rng(SEED), cam["height"], cam["width"])
    net = arch.net_input(frame, cam["long_side"])
    assert net.shape == (1, 56, 70, 3)  # 14-px crops
    ref = arch.make_reference(sd, m)
    X, C = arch.ref_views(ref, net, "cpu")
    assert X.shape == (56 * 70, 3) and C.shape == (56 * 70, 1)

    # the probe hooks the architecture's head; its judge reads the program's calls
    probe = Probe(arch.head_modules(model)).install()
    try:
        probe.begin(0, None)
        with torch.no_grad():
            Xp, Cp = model(torch.as_tensor(net))
        kept = probe.end()
    finally:
        probe.uninstall()
    assert [(k, h) for k, h, _, _ in kept["heads"]] == [("mlp", "head")]
    assert arch.head_err(ref, kept["heads"], "cpu") < 1e-6
    assert np.allclose(Xp.numpy(), X, rtol=1e-5, atol=1e-5) and np.allclose(Cp.numpy(), C, rtol=1e-5)
    Xc, Cc, ctrl_err = arch.control_views(ref, arch.make_reference(sd, m, precision="control"), net, "cpu")
    assert np.abs(Xc - X).max() > 1e3 * np.abs(Xp.numpy() - X).max() and ctrl_err < 1e-6

    # its counts, read by the repository's readers through the seam
    hw = net.shape[1:3]
    bound = arch.forward_bounds(m, hw, 1, "float32")
    assert set(bound) == set(arch.MODEL_SPANS) == {"model.encode"}
    fl = arch.flops(m, hw)
    s = {"window_s": 0.5, "slice_frames": 4, "slice_kf_tasks": 0, "kernel_time_s": {"attention": 1e-3},
         "model_calls": [["model.encode", 1, 4]], "model_spans": list(arch.MODEL_SPANS),
         "span_device_s": {"model.encode": 0.02}, "arch": c["arch"], "arch_root": str(c["root"]),
         "model_shape": {"widths": m, "img_hw": hw, "dtype": "float32"}}
    assert run.load_metric("attn_roofline_pct").read(s) == pytest.approx(100 * 4 * bound["model.encode"] / 1e-3)
    assert run.load_metric("mfu_pct").read(s) == pytest.approx(100 * 4 * fl["total"] / 0.5 / 989e12)
    assert run.load_metric("model_dev_ms").read(s) == pytest.approx(5.0)


def test_an_unknown_architecture_fails_with_its_name(toy_root):
    with pytest.raises(SystemExit, match=r"no architecture 'nope': .*slambench/archs/nope\.py is not there"):
        run.load_cell("nope.track", toy_root)


def test_a_configuration_without_arch_runs_mast3r():
    for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]:
        c = run.load_cell(w["name"])
        assert "arch" not in c["config"]["model"] and c["arch"] == "mast3r" and c["root"] == run.ROOT
