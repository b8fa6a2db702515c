"""Training CLI: the counterpart of the JAX package's ``cli/train.py`` and
of the reference's ``multigpu.py``.

The flags are the JAX CLI's (those of the reference trainer,
multigpu.py:917-972), plus ``--device``. Data comes from the reference's
``.pt`` layout (``--data_dir``, data/torch_io.py) or from the synthetic
generator (``--synthetic``, the JAX CLI's three stores). ``--n_devices
N`` trains data-parallel over a ``torch.distributed`` world of N
processes, one device each, started by a launcher that sets the world in
the environment (``torchrun --nproc_per_node N -m
pbml_mantle_convection_tpu_torch.cli.train ... --n_devices N``): NCCL on
cards, gloo with ``--device cpu``.

It runs on the card; only ``--device cpu`` runs it elsewhere, and with no
card and no such flag it fails. Example (the README's flagship)::

    python -m pbml_mantle_convection_tpu_torch.cli.train -net newfluidnet \\
        -l 5 -f 16 -r 6 -k 5 -p learned -lt curl -b 8 -l_sc 1 -l_de 1 \\
        --synthetic

Every network and option of the JAX registry trains (models/registry.py;
``-d_r`` draws the dropout masks from the Trainer's generator, seeded
from ``seed + 1``); a HalfNewFluidNet, whose raw head is no (u, v, p),
raises as JAX's train step fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from ..constants import SimParams
from ..data.dataset import (ConvAEDataset, SnapshotDataset, TimePairDataset,
                            UnstructuredDataset)
from ..data.synthetic import synthetic_store
from ..data.torch_io import load_store
from ..models.registry import ModelConfig
from ..sim.grid import Grid
from ..train.trainer import TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train convnet")
    p.add_argument("-a", "--act_fn", type=str, default="gelu")
    p.add_argument("-l", "--levels", type=int, default=6)
    p.add_argument("-f", "--c_h", type=int, default=16)
    p.add_argument("-fac", "--factor", type=int, default=2)
    p.add_argument("-p", "--r_p", type=str, default="replicate")
    p.add_argument("-lt", "--loss_type", type=str, default="curl")
    p.add_argument("-d", "--dilation", type=int, default=1)
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-s", "--use_symm", type=int, default=0)
    p.add_argument("-ab", "--a_bound", type=int, default=10)
    p.add_argument("-r", "--repeats", type=int, default=4)
    p.add_argument("-rst", "--restart", type=int, default=0)
    p.add_argument("-k", "--kernel", type=int, default=5)
    p.add_argument("-sc", "--scale", type=int, default=1)
    p.add_argument("-l_sc", "--loss_scale", type=int, default=1)
    p.add_argument("-l_de", "--loss_derivative", type=int, default=0)
    p.add_argument("-blurr", "--blurr", type=int, default=0)
    p.add_argument("-pp", "--p_pred", type=int, default=0)
    p.add_argument("-n", "--noise", type=float, default=0.0)
    p.add_argument("-deb", "--debug", type=int, default=0)
    p.add_argument("-net", "--network", type=str, default="newfluidnet")
    p.add_argument("-spectral", "--spectral_conv", type=int, default=0)
    p.add_argument("-l2", "--l2_reg", type=float, default=0.0)
    p.add_argument("-d_r", "--drop_rate", type=float, default=0.0)
    p.add_argument("-roll", "--roll_forward", type=int, default=1)
    p.add_argument("-scales", "--multi_scales", type=float, nargs="+",
                   default=[])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--nn_dir", type=str, default="./trained_networks")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset")
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def synthetic_stores(grid: Grid | None = None):
    """The JAX CLI's synthetic train, cv and init stores (JAX
    ``cli/train.py:94-101``): two parameter triples, 24 training
    snapshots each; ``grid`` defaults to synthetic_store's 32×68."""
    params = [SimParams(3.0, 1e8, 10.0), SimParams(1.0, 1e7, 3.0)]
    return (synthetic_store(grid, params_list=params, n_snapshots=24,
                            seed=0),
            synthetic_store(grid, params_list=params[:1], n_snapshots=8,
                            seed=1),
            synthetic_store(grid, params_list=params, n_snapshots=4,
                            seed=2))


def datasets(network: str, stores, scale: bool = True, p_pred: bool = False,
             noise: float = 0.0, roll_forward: int = 1, **kw):
    """(train, cv, train_init, cv_init) datasets of ``network`` over the
    (train, cv, init) ``stores`` (init may be None), as the JAX CLI
    builds them; ``kw`` (device, dtype, host_resident, ...) goes to every
    dataset."""
    tr, cv, init = stores
    if network in ("unet", "iunet"):
        return (TimePairDataset(tr, roll_forward=roll_forward, p_pred=p_pred,
                                **kw),
                TimePairDataset(cv, roll_forward=roll_forward, p_pred=p_pred,
                                **kw), None, None)
    if "transolver" in network:
        return (UnstructuredDataset(tr, scale=scale, p_pred=p_pred, **kw),
                UnstructuredDataset(cv, scale=scale, p_pred=p_pred, **kw),
                None, None)
    if network == "convae":
        return (ConvAEDataset(tr, scale=scale, **kw),
                ConvAEDataset(cv, scale=scale, **kw), None, None)
    init_ds = (SnapshotDataset(init, scale=scale, p_pred=p_pred, **kw)
               if init is not None else None)
    return (SnapshotDataset(tr, scale=scale, p_pred=p_pred, noise=noise,
                            **kw),
            SnapshotDataset(cv, scale=scale, p_pred=p_pred, **kw),
            init_ds, init_ds)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    owns_world = (args.n_devices or 1) > 1 and not dist.is_initialized()
    if owns_world:
        # one process per device, the world from the launcher's
        # environment (torchrun: RANK, WORLD_SIZE, MASTER_ADDR/PORT)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
    try:
        return _train(args, device)
    finally:
        if owns_world:
            dist.destroy_process_group()


def _train(args, device):
    mc = ModelConfig(
        network=args.network, levels=args.levels, c_h=args.c_h,
        act_fn=args.act_fn, r_p=args.r_p, loss_type=args.loss_type,
        use_symm=bool(args.use_symm), dilation=args.dilation,
        a_bound=args.a_bound, repeats=args.repeats, kernel=args.kernel,
        p_pred=bool(args.p_pred), spectral_conv=bool(args.spectral_conv),
        blurr=bool(args.blurr), drop_rate=args.drop_rate,
        factor=args.factor, multi_scales=tuple(args.multi_scales))

    epochs, milestones = TrainConfig.schedule_for(args.network,
                                                  bool(args.debug))
    if args.epochs is not None:
        epochs = args.epochs

    if args.synthetic or args.data_dir is None:
        stores = synthetic_stores()
    else:
        p_pred = bool(args.p_pred)
        stores = (load_store(args.data_dir, "train", debug=bool(args.debug),
                             p_pred=p_pred),
                  load_store(args.data_dir, "cv", debug=bool(args.debug),
                             p_pred=p_pred),
                  None if args.debug else load_store(
                      args.data_dir, "train", is_init=True, p_pred=p_pred))
    if "transolver" in args.network or args.network == "vit":
        mc = dataclasses.replace(mc, H=stores[0].T.shape[1],
                                 W=stores[0].T.shape[2])

    cfg = TrainConfig(
        model=mc, epochs=epochs, batch_size=args.batch_size,
        milestones=milestones, l2_reg=args.l2_reg,
        loss_scale=bool(args.loss_scale),
        loss_derivative=bool(args.loss_derivative),
        roll_forward=args.roll_forward, debug=bool(args.debug),
        n_devices=args.n_devices, device=str(device))
    train_ds, cv_ds, init_tr, init_cv = datasets(
        args.network, stores, scale=bool(args.scale),
        p_pred=bool(args.p_pred), noise=args.noise,
        roll_forward=args.roll_forward, device=device)
    trainer = Trainer(cfg, train_ds, cv_ds, train_data_init=init_tr,
                      cv_data_init=init_cv, nn_dir=args.nn_dir,
                      restart=bool(args.restart))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
