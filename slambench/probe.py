"""What the harness keeps of the timed path for the comparison.

Installed on the system under test for the window, in every run:

- forward hooks on the head modules that the cell's architecture names
  (``head_modules`` of ``archs/<arch>.py``; MASt3R's: each head's DPT and
  local-feature MLP) keep the inputs and the output of the latest call of
  each, so that the reference's heads can be judged on the program's own
  inputs (the architecture's ``head_err``);
- a wrapper at the name through which the backend looks up its pair
  decode (``frodo_slam_tpu_torch.slam.backend.decode_asymmetric``) counts
  the decodes of a session and keeps both views' pointmaps and confidences
  of a sample of them: one drawn from the seed and the session's last.

Holding the latest head call only delays its freeing to the next call;
the sample's four maps are copied, a few MiB. At a session's end
:meth:`Probe.end` moves what it kept to the host. A name that is gone
fails the run.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np

BACKEND = ("frodo_slam_tpu_torch.slam.backend", "decode_asymmetric")


class Probe:
    """``heads``: the (kind, head, module) to hook, as the architecture's
    ``head_modules`` gives them."""

    def __init__(self, heads):
        self._modules = heads
        self._handles = []
        self._undo = None
        self._heads: Dict[tuple, tuple] = {}
        self._pick: set = set()
        self._views: List[tuple] = []
        self.decodes = 0

    def install(self) -> "Probe":
        for kind, pre, module in self._modules:
            self._handles.append(module.register_forward_hook(self._keep(kind, pre)))
        module = importlib.import_module(BACKEND[0])
        fn = getattr(module, BACKEND[1], None)
        if fn is None:
            self.uninstall()
            raise RuntimeError(f"probe: {BACKEND[0]}.{BACKEND[1]} is gone; the backend cannot be judged")

        def decode(*a, **k):
            res1, res2 = fn(*a, **k)
            if self.decodes in self._pick:
                self._views.append(tuple(r[key][0].detach().clone() for r in (res1, res2)
                                         for key in ("pts3d", "conf")))
            self.decodes += 1
            return res1, res2

        setattr(module, BACKEND[1], decode)
        self._undo = (module, fn)
        return self

    def uninstall(self):
        for h in self._handles:
            h.remove()
        self._handles = []
        if self._undo is not None:
            module, fn = self._undo
            setattr(module, BACKEND[1], fn)
            self._undo = None

    def _keep(self, kind, pre):
        def hook(module, args, output):
            inp = list(args[0]) if isinstance(args[0], (list, tuple)) else args[0]
            self._heads[(kind, pre)] = (inp, output)
        return hook

    def begin(self, n_decodes: int, rng: Optional[np.random.Generator]):
        """A new session, in which ``n_decodes`` backend decodes are due."""
        self._heads, self._views, self.decodes = {}, [], 0
        self._pick = set()
        if n_decodes > 0:
            self._pick = {int(rng.integers(n_decodes)), n_decodes - 1}

    def end(self) -> Dict:
        """What the session kept, on the host: ``heads`` [(kind, head,
        inputs (a tensor, or a list where the module took one), output)], ``decodes``, ``backend_views`` [(X (hw, 3), C (hw,
        1))], each view of each sampled decode."""
        heads = []
        for (kind, pre), (inp, out) in sorted(self._heads.items()):
            inp = [t.cpu() for t in inp] if isinstance(inp, list) else inp.cpu()
            heads.append((kind, pre, inp, out.cpu()))
        views = []
        for X1, C1, X2, C2 in self._views:
            for X, C in ((X1, C1), (X2, C2)):
                views.append((X.reshape(-1, 3).cpu().numpy(), C.reshape(-1, 1).cpu().numpy()))
        out = {"heads": heads, "decodes": self.decodes, "backend_views": views}
        self._heads, self._views = {}, []
        return out
