"""Train and eval steps: loss, backward, optimizer update.

Counterpart of the JAX package's ``train/train_step.py`` (reference: the
DDP ``Trainer._run_batch``, multigpu.py:307-338). JAX differentiates a
pure function of the parameters; here the module owns its parameters and
a ``torch.optim`` optimizer updates them in place, so a step is
``step(batch) -> LossBreakdown``. Data parallelism is
``torch.distributed``: each rank computes the loss on its shard, and the
gradients and the loss breakdown are all-reduced to their mean over the
process group (JAX: ``shard_map`` with ``pmean``).

Training runs the modules with autograd, as JAX differentiates the Flax
modules: no CUDA kernel of this package has a backward, and none runs on
this path. The train and eval steps call the model inside
``ops/slice_attention.py::plain_slice_attention``, so a Transolver trains
and evaluates on the einsum formulation, as the JAX model does. The whole
step (forward, backward, update)
runs inside ``models/layers.py::float32_convs``, with cuDNN's TF32 off:
cuDNN reads its flag when the backward's convolutions run, so the
modules' guard around each forward conv alone would leave every
gradient in TF32.

With ``drop_rate`` > 0 the train step runs the model with dropout: it
passes its ``torch.Generator`` (on the model's device) to the model's
forward, which draws every mask from it (JAX: the step's PRNG key). The
masks are the port's own; no JAX PRNG stream is reproduced. The eval step
is deterministic.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..physics.viscosity import fk_viscosity
from ..constants import visc_feature
from ..models.fluidnet import HALF_HEAD
from ..models.layers import float32_convs
from ..ops.curl import curl_head_valid
from ..ops.slice_attention import plain_slice_attention
from ..utils.profiling import span
from .losses import LossBreakdown, fluidnet_loss, unet_loss


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    net: str = "newfluidnet"          # "fluidnet"-family | "unet" | "convae"
    p_pred: bool = False
    loss_scale: bool = True
    loss_derivative: bool = False
    loss_type: str = "curl"
    roll_forward: int = 1
    # recompute the forward in the backward (torch.utils.checkpoint):
    # activation memory for compute, as JAX's remat
    remat: bool = False
    # training-time dropout (reference -d_r; the model's forward takes the
    # step's generator)
    drop_rate: float = 0.0


def _bind_apply(apply_fn, cfg: TrainStepConfig,
                generator: Optional[torch.Generator] = None):
    if cfg.drop_rate > 0.0:
        if generator is None:
            raise ValueError("drop_rate > 0 needs a torch.Generator for "
                             "the dropout masks")
        apply_fn = functools.partial(apply_fn, generator=generator)

    def plain_apply(x):
        # entered inside what checkpoint recomputes: the recompute runs
        # the same einsum path, on whichever thread the backward uses
        with plain_slice_attention():
            return apply_fn(x)

    if not cfg.remat:
        return plain_apply
    if cfg.drop_rate <= 0.0:
        return lambda x: checkpoint(plain_apply, x, use_reentrant=False)

    def remat_apply(x):
        # the recompute draws the forward's masks again: the generator is
        # put back to its state before the forward (checkpoint restores
        # torch's default generators only)
        state = generator.get_state()

        def run(x):
            generator.set_state(state)
            return plain_apply(x)

        return checkpoint(run, x, use_reentrant=False)
    return remat_apply


def _fluidnet_loss_fn(apply_fn, cfg: TrainStepConfig):
    def loss_fn(batch):
        u, v, p = apply_fn(batch["x"])
        return fluidnet_loss(
            u, v, p, batch["y"], p_pred=cfg.p_pred,
            loss_scale=cfg.loss_scale,
            loss_derivative=cfg.loss_derivative, loss_type=cfg.loss_type)
    return loss_fn


def _unet_reassemble(x, T, u, v, paras, yc, roll_forward, p=None):
    """Re-assemble the 10/11-channel U-Net input from predictions, with
    the viscosity recomputed from the (detached) predicted temperature
    (multigpu.py:208-232). x channel order:
    (xc/4, yc/4, dt, raq_nd, fkt_nd, fkp_nd, V, T, u, v[, p...])."""
    T = T.detach()
    V = fk_viscosity(paras[:, 1][:, None, None], paras[:, 2][:, None, None],
                     1.0 - yc, T)
    Vf = visc_feature(V)
    dt = x[..., 2] / roll_forward
    chans = [x[..., 0], x[..., 1], dt, x[..., 3], x[..., 4], x[..., 5],
             Vf, T, u, v]
    if p is not None and x.shape[-1] > 10:
        chans.append(p.detach())
    elif x.shape[-1] > 10:
        chans.append(x[..., 10])
    return torch.stack(chans, dim=-1)


def _unet_loss_fn(apply_fn, cfg: TrainStepConfig):
    def loss_fn(batch):
        x, paras, yc = batch["x"], batch["paras"], batch["yc"]
        # roll_forward autoregressive unroll: (roll_forward - 1) warm
        # steps without gradient, one step with it (multigpu.py:207-251)
        T, u, v, p = x[..., 7], x[..., 8], x[..., 9], None
        for r in range(cfg.roll_forward):
            xi = _unet_reassemble(x, T, u, v, paras, yc, cfg.roll_forward,
                                  p=p)
            if r < cfg.roll_forward - 1:
                with torch.no_grad():
                    u, v, p, T = apply_fn(xi)
            else:
                u, v, p, T = apply_fn(xi)
        return unet_loss(
            u, v, p, T, batch["y"], p_pred=cfg.p_pred,
            loss_scale=cfg.loss_scale,
            loss_derivative=cfg.loss_derivative, loss_type=cfg.loss_type)
    return loss_fn


def _point_head(out, H: int, W: int):
    """The irregular Transolver's (B, H·W, out_dim) point outputs read as
    the structured model's: channel 0 the stream function on the H × W
    grid, through the VALID curl head; p (with p_pred) that stream
    function's interior, as TransolverStructured2D returns it."""
    psi = out[..., 0].reshape(out.shape[0], H, W)
    u, v = curl_head_valid(psi)
    return u, v, psi[:, 1:-1, 1:-1] if out.shape[-1] > 1 else None


def _transolver_loss_fn(apply_fn, cfg: TrainStepConfig):
    """Transolver outputs live on the (H-2, W-2) VALID interior
    (Transolver_Structured_Mesh_2D-checkpoint.py:201-204); the target is
    cropped to it. The irregular Transolver returns point values, which
    :func:`_point_head` turns into (u, v, p) on the target's grid (the
    JAX loss unpacks its (B, N, 1) output along the batch, so JAX has no
    working counterpart to hold this against)."""
    def loss_fn(batch):
        out = apply_fn(batch["x"])
        if isinstance(out, torch.Tensor):
            out = _point_head(out, *batch["y"].shape[-2:])
        u, v, p = out
        return fluidnet_loss(
            u, v, p, batch["y"][..., 1:-1, 1:-1], p_pred=cfg.p_pred,
            loss_scale=cfg.loss_scale,
            loss_derivative=cfg.loss_derivative, loss_type=cfg.loss_type)
    return loss_fn


def _convae_loss_fn(apply_fn, cfg: TrainStepConfig):
    """ConvAE reconstruction loss (the JAX package's reconstruction of
    the reference's lost ``get_loss_convae``, multigpu.py:311-314): L1 on
    the reconstructed (u, v) channels + the mass penalty."""
    def loss_fn(batch):
        out = apply_fn(batch["x"])
        # curl output channel order: (passthrough..., u, v[, p])
        if cfg.p_pred:
            u, v = out[..., -3], out[..., -2]
        else:
            u, v = out[..., -2], out[..., -1]
        y = batch["y"]
        if u.shape[-1] != y.shape[-1]:
            y = y[..., 1:-1, 1:-1]
        return fluidnet_loss(
            u, v, None, y, p_pred=False, loss_scale=cfg.loss_scale,
            loss_derivative=cfg.loss_derivative, loss_type=cfg.loss_type)
    return loss_fn


def make_loss_fn(apply_fn: Callable, cfg: TrainStepConfig,
                 generator: Optional[torch.Generator] = None):
    """``loss_fn(batch) -> LossBreakdown`` of the network family of
    ``cfg.net``; ``apply_fn`` maps ``batch["x"]`` to the model's
    outputs (a module, or any callable), called inside
    ``plain_slice_attention``; with ``cfg.drop_rate`` > 0 it is called
    with ``generator=generator``, which is required."""
    if cfg.net == "halfnewfluidnet":
        raise ValueError(HALF_HEAD)
    apply_fn = _bind_apply(apply_fn, cfg, generator)
    if cfg.net in ("unet", "iunet"):
        return _unet_loss_fn(apply_fn, cfg)
    if "transolver" in cfg.net:
        return _transolver_loss_fn(apply_fn, cfg)
    if cfg.net == "convae":
        return _convae_loss_fn(apply_fn, cfg)
    return _fluidnet_loss_fn(apply_fn, cfg)


def _all_reduce_mean(ts, group):
    """Mean of each tensor of ``ts`` over ``group``, in place, in one
    all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    i = 0
    for t in ts:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def _mean_breakdown(br: LossBreakdown, group) -> LossBreakdown:
    vec = br.stack().detach()
    if group is not None:
        _all_reduce_mean([vec], group)
    return LossBreakdown(*vec.unbind())


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: TrainStepConfig,
                    process_group: Optional[dist.ProcessGroup] = None,
                    generator: Optional[torch.Generator] = None):
    """``step(batch) -> LossBreakdown``: the loss of ``model`` on
    ``batch``, its gradients (left in each parameter's ``.grad``), and one
    ``optimizer`` update in place. Returns the loss breakdown detached, on
    the batch's device: reading it is the caller's one host sync.

    With ``process_group`` each rank passes its shard of the batch; the
    gradients and the breakdown are all-reduced to their mean (equal
    shards: the full-batch update). JAX's ``donate`` has no counterpart:
    the optimizer updates the parameters in place. With ``cfg.drop_rate``
    > 0 the dropout masks come from ``generator`` (required, on the
    model's device), which each step advances."""
    loss_fn = make_loss_fn(model, cfg, generator)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch) -> LossBreakdown:
        with float32_convs(batch["x"]):
            optimizer.zero_grad(set_to_none=False)
            with span("pmc.train.loss"):
                br = loss_fn(batch)
            with span("pmc.train.backward"):
                br.total.backward()
                # a parameter the loss does not reach gets a zero
                # gradient, which optax's Adam updates (its moments, the
                # L2 term) and torch's skips when the gradient is None
                for q in params:
                    if q.grad is None:
                        q.grad = torch.zeros_like(q)
                if process_group is not None:
                    _all_reduce_mean([q.grad for q in params],
                                     process_group)
            with span("pmc.train.optimizer"):
                optimizer.step()
        return _mean_breakdown(br, process_group)

    return step


def make_eval_step(model: torch.nn.Module, cfg: TrainStepConfig,
                   process_group: Optional[dist.ProcessGroup] = None):
    """``step(batch) -> LossBreakdown`` without gradients: the
    reference's no_grad cv loop (multigpu.py:383-410). The modules keep
    their own float32 guard for the forward; a Transolver evaluates on
    the einsum formulation it trains on (no kernel launch), as the JAX
    eval step does."""
    loss_fn = make_loss_fn(model, dataclasses.replace(cfg, drop_rate=0.0))

    def step(batch) -> LossBreakdown:
        with torch.no_grad():
            return _mean_breakdown(loss_fn(batch), process_group)

    return step
