"""One caller that waits for each reply (closed loop) of SAM's ViT image
encoder as the field surrogate: the ``serve_vit`` driver's traffic,
inputs, image layout, window and traced stretch, with SAM's model and its
reference.

Traffic parameters (``benchmarks/traffic/<name>.json``): those of
``serve``. The traced stretch wraps no call of the program: the
per-layer metrics read the program's own ``pmc.samvit.*`` spans. The
check: the reference forward (``benchmarks/reference/samvit.py``) in
float64 of the sampled inputs against the program's u, v.
"""

from __future__ import annotations

import numpy as np
import torch

from ..harness.common import sync, tf32
from ..harness.weights import CHECK, sub_seed
from ..models import samvit as family
from ..reference import samvit as ref_net
from . import serve, serve_vit

KEYS = serve.KEYS


class Driver(serve_vit.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        self.m = family.dims(cfg)

    def setup(self) -> None:
        self.model, self.weights = family.build(self.cfg, self.seed,
                                                self.device)
        x = serve.make_inputs(self.tr["pool"], self.H, self.W, self.seed,
                              self.device, self.tr["batch"])
        self.x = x.reshape(len(x), self.tr["batch"], self.H, self.W, 7)
        with torch.no_grad():
            for i in range(self.tr["warm_forwards"]):
                self.model(self.x[i % len(self.x)])
        sync(self.device)
        self._rng = np.random.default_rng(sub_seed(self.seed, CHECK))

    def check(self, control: bool = False) -> dict:
        """Worst max|Δ| / max|reference| of u and v over the sampled
        forwards: of the program, or with ``control`` of the reference in
        float32 with TF32 on, against the float64 reference."""
        w64 = {k: v.double() for k, v in self.weights.items()}
        w32 = {k: v.float() for k, v in self.weights.items()}
        worst, l2, where = 0.0, 0.0, []
        with torch.no_grad():
            for _, j, u, v in self.kept:
                ur, vr = ref_net.forward(self.x[j].double(), w64, self.m)
                if control:
                    with tf32(True):
                        u, v = ref_net.forward(self.x[j].float(), w32,
                                               self.m)
                scale = max(float(ur.abs().max()), float(vr.abs().max()))
                du, dv = u.double() - ur, v.double() - vr
                worst = max(worst, max(float(du.abs().max()),
                                       float(dv.abs().max())) / scale)
                l2 = max(l2, float(torch.sqrt(
                    (du ** 2 + dv ** 2).sum() / (ur ** 2 + vr ** 2).sum())))
                k = int(du.abs().argmax())
                where.append([k // du.shape[-1], k % du.shape[-1],
                              float(du.abs().max()) / scale])
        self.look = {"uv_rel_l2": l2, "where_u": where}
        return {"uv_rel_max": worst}
