"""Model registry and channel-count derivation.

Counterpart of the JAX package's ``models/registry.py``: one typed config
(the same fields and the same ``channels`` rule) and ``build_model``,
which builds every network of the JAX registry: ``newfluidnet``,
``fluidnet`` and ``ifluidnet`` (the same FluidNet with c_i = 9),
``halfnewfluidnet``, ``multiscalenewfluidnet``, ``unet`` and ``iunet``
(the same U-Net), ``convae``, ``transolver_structured``, ``transolver``
and ``vit``, with every option JAX's modules take, and the port's own
``samvit`` (SAM's ViT image encoder, ``models/samvit.py``; JAX has no
counterpart). An unknown network raises ``ValueError``; none silently
turns into another model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from .fluidnet import (FluidNet, HalfNewFluidNet, MultiScaleNewFluidNet,
                       NewFluidNet)
from .samvit import SamViTField
from .transolver import TransolverIrregular, TransolverStructured2D
from .unet import ConvAE, Unet
from .vit import ViTField


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX ``ModelConfig``'s fields (multigpu.py:911-1087); ``dtype``
    is a torch dtype (None: float32). ``mlp_dim`` is the port's own: the
    ViT's MLP width, which JAX's registry fixes at 2 · n_hidden (ViT-Base,
    Dosovitskiy et al. 2021, has 4 · 768). ``window_size``,
    ``global_attn_indexes`` and ``neck_chans`` are the port's own too,
    read by ``samvit`` alone (SAM ViT-B's 14; None: SAM's rule, the last
    block of each quarter of the depth; 256)."""

    network: str = "newfluidnet"
    levels: int = 6
    c_h: int = 16
    act_fn: str = "gelu"
    r_p: str = "learned"
    loss_type: str = "curl"
    use_symm: bool = False
    dilation: int = 1
    a_bound: float = 10.0
    repeats: int = 4
    kernel: int = 5
    p_pred: bool = False
    spectral_conv: bool = False
    blurr: bool = False
    drop_rate: float = 0.0
    factor: int = 2
    multi_scales: Sequence[float] = ()
    # transolver-specific
    n_hidden: int = 128
    n_head: int = 8
    slice_num: int = 32
    mlp_ratio: int = 1
    n_layers: int = 5
    # vit-specific: the MLP width; None keeps JAX's rule, 2 · n_hidden
    mlp_dim: Optional[int] = None
    # samvit-specific: window side, global blocks, neck width
    window_size: int = 14
    global_attn_indexes: Optional[Sequence[int]] = None
    neck_chans: int = 256
    # grid
    H: int = 128
    W: int = 506
    dtype: Any = None

    @property
    def channels(self) -> Tuple[int, int]:
        """(c_i, c_o) derivation (multigpu.py:1072-1087)."""
        net = self.network
        if net == "ifluidnet":
            c_i, c_o = 9, 3
        elif "fluidnet" in net:
            c_i, c_o = 7, 3
        elif net == "convae":
            c_i, c_o = 3, 3
        elif net in ("unet", "iunet"):
            c_i, c_o = 11, 4
            if not self.p_pred:
                c_i -= 1
        elif "transolver" in net or net in ("vit", "samvit"):
            c_i, c_o = 7, 3  # 2 coords + 5 function channels
        else:
            raise ValueError(f"unknown network {net!r}")
        if self.loss_type == "curl":
            c_o -= 1
        if not self.p_pred:
            c_o -= 1
        return c_i, c_o

    @property
    def run_name(self) -> str:
        """Experiment-identity string of the reference's directory
        encoding (multigpu.py:1011-1055), as the JAX package writes it."""
        f_nn = (
            f"{self.network}_levels_{self.levels}_{self.act_fn}_{self.c_h}"
            f"_{self.r_p}_{self.loss_type}_{self.use_symm}"
            f"_ab{int(self.a_bound)}_r{self.repeats}_k{self.kernel}"
            f"_fa{self.factor}_p_pred{self.p_pred}")
        if self.blurr:
            f_nn += "_blurr"
        return f_nn


def build_model(cfg: ModelConfig, seed: int = 0, device=None):
    """The port's module for ``cfg.network``, weights from ``seed``, on
    ``device`` (default: the card)."""
    net = cfg.network
    c_i, c_o = cfg.channels
    dtype = cfg.dtype or torch.float32
    common = dict(seed=seed, device=device, dtype=dtype)
    fluid = dict(levels=cfg.levels, c_i=c_i, c_h=cfg.c_h, c_o=c_o,
                 act_fn=cfg.act_fn, r_p=cfg.r_p, loss_type=cfg.loss_type,
                 use_symm=cfg.use_symm, dilation=cfg.dilation,
                 a_bound=cfg.a_bound, repeats=cfg.repeats, f=cfg.kernel,
                 p_pred=cfg.p_pred, spectral_conv=cfg.spectral_conv,
                 blurr=cfg.blurr, **common)
    if net == "newfluidnet":
        return NewFluidNet(**fluid, drop_rate=cfg.drop_rate,
                           factor=cfg.factor)
    if net in ("fluidnet", "ifluidnet"):
        # ifluidnet is the same FluidNet with c_i = 9; the velocity
        # feedback loop lives in TimeStepper.stokes_iterative
        return FluidNet(**fluid, drop_rate=cfg.drop_rate, factor=cfg.factor)
    if net == "multiscalenewfluidnet":
        scales = tuple(cfg.multi_scales) or (1e-5, 1e-3, 1e-1, 1e1)
        return MultiScaleNewFluidNet(**fluid, drop_rate=cfg.drop_rate,
                                     factor=cfg.factor, scales=scales)
    if net == "halfnewfluidnet":
        return HalfNewFluidNet(**fluid, drop_rate=cfg.drop_rate,
                               factor=cfg.factor)
    if net in ("unet", "iunet"):
        return Unet(**fluid, drop_rate=cfg.drop_rate)
    if net == "convae":
        return ConvAE(**fluid)
    if net == "transolver":
        return TransolverIrregular(
            space_dim=2, fun_dim=5, n_layers=cfg.n_layers,
            n_hidden=cfg.n_hidden, n_head=cfg.n_head,
            mlp_ratio=cfg.mlp_ratio, out_dim=max(1, c_o),
            slice_num=cfg.slice_num, **common)
    if net == "transolver_structured":
        return TransolverStructured2D(
            H=cfg.H, W=cfg.W, space_dim=2, fun_dim=5,
            n_layers=cfg.n_layers, n_hidden=cfg.n_hidden,
            n_head=cfg.n_head, mlp_ratio=cfg.mlp_ratio,
            out_dim=max(1, c_o), slice_num=cfg.slice_num,
            a_bound=cfg.a_bound, p_pred=cfg.p_pred, kernel=3, **common)
    if net == "vit":
        # the patch must divide the grid: 8, else 2 (JAX's rule; 128×506
        # gets 8×2 patches, 4,048 tokens)
        ph = 8 if cfg.H % 8 == 0 else 2
        pw = 8 if cfg.W % 8 == 0 else 2
        return ViTField(image_size=(cfg.H, cfg.W), patch_size=(ph, pw),
                        c_o=3 if cfg.p_pred else 2, dim=cfg.n_hidden,
                        depth=cfg.n_layers, heads=cfg.n_head,
                        mlp_dim=cfg.mlp_dim or cfg.n_hidden * 2,
                        channels=c_i,
                        p_pred=cfg.p_pred, **common)
    if net == "samvit":
        # the ViT's patch rule: 8×2 on 128×506, a 16 × 253 token grid
        ph = 8 if cfg.H % 8 == 0 else 2
        pw = 8 if cfg.W % 8 == 0 else 2
        return SamViTField(
            image_size=(cfg.H, cfg.W), patch_size=(ph, pw),
            c_o=3 if cfg.p_pred else 2, dim=cfg.n_hidden,
            depth=cfg.n_layers, heads=cfg.n_head,
            mlp_dim=cfg.mlp_dim or cfg.n_hidden * 4,
            window_size=cfg.window_size,
            global_attn_indexes=cfg.global_attn_indexes,
            neck_chans=cfg.neck_chans, channels=c_i, p_pred=cfg.p_pred,
            **common)
    raise ValueError(f"unknown network {net!r}")
