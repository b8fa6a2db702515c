"""The reference's PyTorch checkpoints, loaded straight into the port.

Maps the reference's ``state_dict`` checkpoints (``{epoch}_fluidnet_uvp.pt``,
multigpu.py:412-419) onto the port's modules, so trained reference networks
roll out here. It is the name map of the JAX package's
``utils/torch_convert.py`` (reference module tree → Flax tree), aimed at
the port's module names instead; the reference's tensors are already in
PyTorch layouts (OIHW convs, (out, in) Linear weights), so the work is
renaming, and one reshape:

NewFluidNet (pytorch_networks_convae.py:1068-1388):
  conv.0.layers.0.*      → conv_0.conv.*         (FluidLayer conv or BLC)
  conv.0.layers.1.*      → conv_0.gn.*           (GroupNorm)
  convs.{l}.{r}.layers.* → convs_{l}_{r}.{conv,gn}.*
  conv.1|2|3.*           → conv_1|2|3.*;  gn.0.* → gn_0.*
  BLC learnable_bias (1, C, 1, 1) → (C,)

Unet (pytorch_networks_convae.py:1700-2070):
  conv.{r<repeats}       → conv_{r};  convs.{l}.{r} → convs_{l}_{r}
  upconvs.{i}.{r}        → upconvs_{i}_{r}
  conv.{repeats+0,1,2}   → conv_m3, conv_m2, conv_m1;  gn.0 → gn_0

Transolver ``Model`` (Transolver_Structured_Mesh_2D-checkpoint.py:41-77):
  blocks.{i}.*           → blocks_{i}.*
  preprocess.linear_pre.0, Attn.to_out.0, mlp.linear_pre.0 → without the .0

What the port does not build raises ``NotImplementedError`` naming its
ROADMAP item: symmetric convs (a conv whose unique filters are fewer than
its outputs), spectral convs (``weights1``/``weights2``), the ViT and the
other fluidnet variants (queue 1 item 6); so does the ConvAE, whose
reference names no map holds.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.registry import _UNPORTED

_BLC_SUBMODULES = (
    "conv", "conv_top_left", "conv_top_right", "conv_bottom_left",
    "conv_bottom_right", "conv_top", "conv_bottom", "conv_left",
    "conv_right")
_ITEM6 = "ROADMAP queue 1 item 6"


def _tensor(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().clone().contiguous()


def _check_unique_filters(w, n_out: int, key: str) -> None:
    if w.shape[0] != n_out:
        raise NotImplementedError(
            f"{key}: {w.shape[0]} unique filters for {n_out} outputs is a "
            f"symmetric conv, which is not ported yet ({_ITEM6})")


def _convert_conv(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    """One conv-ish reference submodule at ``src`` (a plain conv or a
    boundary-learned one) → the port's names under ``dst``."""
    rels = {k[len(src) + 1:]: k for k in sd if k.startswith(src + ".")}
    if "weights1" in rels or "weights2" in rels:
        raise NotImplementedError(
            f"{src}: a spectral conv (SpectralConv2d) is not ported yet "
            f"({_ITEM6})")
    if "learnable_bias" in rels:  # BoundaryLearnedConvolution2D
        lb = _tensor(sd[rels["learnable_bias"]]).reshape(-1)
        for sub in _BLC_SUBMODULES:
            wk = f"{sub}.weight"
            if wk in rels:
                w = _tensor(sd[rels[wk]])
                _check_unique_filters(w, lb.numel(), rels[wk])
                out[f"{dst}.{sub}.weight"] = w
        out[f"{dst}.learnable_bias"] = lb
        return
    if "weight" not in rels:
        raise KeyError(f"no conv weights under {src!r}")
    w = _tensor(sd[rels["weight"]])
    if "bias" in rels:
        b = _tensor(sd[rels["bias"]])
        _check_unique_filters(w, b.numel(), rels["weight"])
        out[f"{dst}.bias"] = b
    out[f"{dst}.weight"] = w


def _convert_gn(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])


def _convert_fluid_layer(out: Dict, dst: str, sd: Mapping, src: str):
    """FluidLayer: layers.0 = conv, layers.1 = GroupNorm
    (pytorch_networks_convae.py:759-788)."""
    _convert_conv(out, f"{dst}.conv", sd, f"{src}.layers.0")
    _convert_gn(out, f"{dst}.gn", sd, f"{src}.layers.1")


def convert_fluidnet(state_dict: Mapping, levels: int, repeats: int
                     ) -> Dict[str, torch.Tensor]:
    """NewFluidNet state_dict (plain or boundary-learned convs) → the
    port's ``models/fluidnet.py::NewFluidNet`` state_dict."""
    sd = dict(state_dict)
    out: Dict[str, torch.Tensor] = {}
    _convert_fluid_layer(out, "conv_0", sd, "conv.0")
    for l in range(levels):
        for r in range(repeats):
            _convert_fluid_layer(out, f"convs_{l}_{r}", sd,
                                 f"convs.{l}.{r}")
    _convert_conv(out, "conv_1", sd, "conv.1")
    _convert_gn(out, "gn_0", sd, "gn.0")
    _convert_conv(out, "conv_2", sd, "conv.2")
    _convert_conv(out, "conv_3", sd, "conv.3")
    return out


def convert_unet(state_dict: Mapping, levels: int, repeats: int
                 ) -> Dict[str, torch.Tensor]:
    """Unet state_dict → the port's ``models/unet.py::Unet`` state_dict."""
    sd = dict(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for r in range(repeats):
        _convert_fluid_layer(out, f"conv_{r}", sd, f"conv.{r}")
    for l in range(1, levels):
        for r in range(repeats):
            _convert_fluid_layer(out, f"convs_{l - 1}_{r}", sd,
                                 f"convs.{l - 1}.{r}")
    for i in range(max(0, levels - 2)):
        for r in range(repeats):
            _convert_fluid_layer(out, f"upconvs_{i}_{r}", sd,
                                 f"upconvs.{i}.{r}")
    _convert_conv(out, "conv_m3", sd, f"conv.{repeats}")
    _convert_gn(out, "gn_0", sd, "gn.0")
    _convert_conv(out, "conv_m2", sd, f"conv.{repeats + 1}")
    _convert_conv(out, "conv_m1", sd, f"conv.{repeats + 2}")
    return out


_TRANSOLVER_RENAMES = ((".to_out.0.", ".to_out."),
                       (".linear_pre.0.", ".linear_pre."))


def convert_transolver(state_dict: Mapping, n_layers: int
                       ) -> Dict[str, torch.Tensor]:
    """Transolver ``Model`` state_dict → the port's
    ``TransolverStructured2D`` / ``TransolverIrregular`` state_dict (the
    structured model's conv slice projections and the irregular model's
    Linear ones keep their layouts; Physics_Attention-checkpoint.py:18-19,
    75-77)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        name = f".{k}."
        for i in range(n_layers):
            name = name.replace(f".blocks.{i}.", f".blocks_{i}.")
        for a, b in _TRANSOLVER_RENAMES:
            name = name.replace(a, b)
        out[name[1:-1]] = _tensor(v)
    return out


def load_reference_checkpoint(path: str, network: str, levels: int,
                              repeats: int) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pt`` state_dict (``weights_only``) and convert
    it for the port's ``network`` (for a Transolver ``levels`` is its
    number of blocks, as in the JAX package)."""
    if network in _UNPORTED:
        raise NotImplementedError(f"network {network!r} is not ported yet "
                                  f"({_UNPORTED[network]})")
    if network == "convae":
        raise NotImplementedError(
            "the reference's ConvAE is a checkpoint-only model "
            "(pycold-checkpoint.py:989) whose state_dict names the JAX "
            "package's name map does not hold: no conversion (ROADMAP "
            "queue 1 item 8, left out)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if network in ("unet", "iunet"):
        return convert_unet(sd, levels, repeats)
    if "transolver" in network:
        return convert_transolver(sd, levels)
    return convert_fluidnet(sd, levels, repeats)
