"""Plain reference of one training step of the flagship surrogate: the
batch assembled from the raw snapshot rows, the NewFluidNet forward, the
curl loss with loss scaling and the derivative term
(multigpu.py:122-194), its gradients by autograd, and Adam
(β = 0.9, 0.999, ε = 1e-8, no weight decay) written out by hand.
Nothing of the program is imported.
"""

from __future__ import annotations

import torch

from . import fluidnet
from .physics import fluidnet_input, velocity_scaler


def batch(rows: dict, xc, yc):
    """Raw snapshot rows {T, u, v (B, H, W); paras (B, 3)} → (x (B, H, W,
    7), y (B, 2, H, W)): the 7 input channels of each row's own
    (raq, fkt, fkp), and u, v over the row's velocity scaler."""
    xs, ys = [], []
    for i in range(rows["T"].shape[0]):
        raq, fkt, fkp = (float(a) for a in rows["paras"][i])
        x, _ = fluidnet_input(rows["T"][i:i + 1], xc, yc, raq, fkt, fkp)
        s = velocity_scaler(raq, fkt, fkp)
        xs.append(x)
        ys.append(torch.stack([rows["u"][i] / s, rows["v"][i] / s])[None])
    return torch.cat(xs), torch.cat(ys)


def _scaled_l1(t, p):
    sc = torch.clamp(1.0 / (t.amax(dim=(1, 2), keepdim=True)
                            - t.amin(dim=(1, 2), keepdim=True)), 1.0, 10.0)
    bc = torch.full(t.shape[1:], 11.0, dtype=t.dtype, device=t.device)
    bc[2:-2, 2:-2] = 1.0
    return torch.mean(torch.abs((t - p) * sc * bc))


def curl_loss(u, v, y):
    """Scaled boundary-weighted L1 of u and v, each plus the L1 of its
    one-sided derivative (×(H-2)), averaged, plus the mean |div u| on
    each of the four edges of the interior."""
    ut, vt = y[:, 0], y[:, 1]
    n = ut.shape[-2] - 2

    def d_y(f):
        return (f[..., 1:-1, :] - f[..., :-2, :]) * n

    def d_x(f):
        return (f[..., 1:-1] - f[..., :-2]) * n

    lu = _scaled_l1(ut, u) + torch.mean(torch.abs(d_y(ut) - d_y(u)))
    lv = _scaled_l1(vt, v) + torch.mean(torch.abs(d_x(vt) - d_x(v)))
    mass = torch.abs(0.5 * (u[..., 1:-1, 2:] - u[..., 1:-1, :-2])
                     + 0.5 * (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]))
    edges = (mass[..., :, 0].mean() + mass[..., :, -1].mean()
             + mass[..., 0, :].mean() + mass[..., -1, :].mean())
    return (lu + lv) / 2.0 + edges


def train(w0: dict, batches, m: dict, lr: float, dtype):
    """Adam steps from the weights ``w0`` over ``batches`` [(x, y)].
    Returns (losses, the first step's gradients, the weights after the
    last step), every tensor in ``dtype``."""
    w = {k: v.detach().to(dtype).clone().requires_grad_(True)
         for k, v in w0.items()}
    m1 = {k: torch.zeros_like(v) for k, v in w.items()}
    m2 = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, g_first = [], None
    for t, (x, y) in enumerate(batches, start=1):
        u, v = fluidnet.forward(x.to(dtype), w, m)
        loss = curl_loss(u, v, y.to(dtype))
        grads = torch.autograd.grad(loss, list(w.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = dict(zip(w, grads))
            if g_first is None:
                g_first = {k: gi.clone() for k, gi in g.items()}
            for k, p in w.items():
                m1[k].mul_(b1).add_(g[k], alpha=1 - b1)
                m2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (m2[k] / (1 - b2 ** t)).sqrt() + eps
                p.sub_(lr / (1 - b1 ** t) * m1[k] / denom)
    return losses, g_first, {k: v.detach() for k, v in w.items()}
