"""The reference's PyTorch checkpoints, loaded straight into the port.

Maps the reference's ``state_dict`` checkpoints (``{epoch}_fluidnet_uvp.pt``,
multigpu.py:412-419) onto the port's modules, so trained reference networks
roll out here. It is the name map of the JAX package's
``utils/torch_convert.py`` (reference module tree → Flax tree), aimed at
the port's module names instead; the reference's tensors are already in
PyTorch layouts (OIHW convs, (out, in) Linear weights), so the work is
renaming, and one reshape:

NewFluidNet and FluidNet (pytorch_networks_convae.py:1068-1697):
  conv.0.layers.0.*      → conv_0.conv.*         (FluidLayer conv or BLC)
  conv.0.layers.1.*      → conv_0.gn.*           (GroupNorm)
  convs.{l}.{r}.layers.* → convs_{l}_{r}.{conv,gn}.*
  conv.1|2|3.*           → conv_1|2|3.*;  gn.0.* → gn_0.*
  BLC learnable_bias (1, C, 1, 1) → (C,)
  a symmetric conv's unique filters (n_unique, c_i, k, k) → its weight
  a spectral conv's complex weights1|2 → weights1|2_real, weights1|2_imag

Unet (pytorch_networks_convae.py:1700-2070):
  conv.{r<repeats}       → conv_{r};  convs.{l}.{r} → convs_{l}_{r}
  upconvs.{i}.{r}        → upconvs_{i}_{r}
  conv.{repeats+0,1,2}   → conv_m3, conv_m2, conv_m1;  gn.0 → gn_0

Transolver ``Model`` (Transolver_Structured_Mesh_2D-checkpoint.py:41-77):
  blocks.{i}.*           → blocks_{i}.*
  preprocess.linear_pre.0, Attn.to_out.0, mlp.linear_pre.0 → without the .0

lucidrains ViT (vit_pytorch-checkpoint.py:85-133), under ViTField's
``vit.``: the Flax automatic names of JAX's ``convert_vit`` (:199-235),
``to_patch_embedding.1|2|3`` → ``LayerNorm_0``, ``Dense_0``,
``LayerNorm_1``; ``transformer.layers.{i}.0|1`` →
``Transformer_0.attn_{i}|ff_{i}``; ``mlp_head`` → ``Dense_1``.

The HalfNewFluidNet and the multi-scale ensemble raise: the reference lost
both classes (SURVEY.md §2), so no checkpoint of them exists, and the JAX
converter has no map for them; so does the ConvAE, whose reference names
no map holds.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

_BLC_SUBMODULES = (
    "conv", "conv_top_left", "conv_top_right", "conv_bottom_left",
    "conv_bottom_right", "conv_top", "conv_bottom", "conv_left",
    "conv_right")
# networks whose reference checkpoints have no conversion, and why
NO_CONVERSION = {
    "halfnewfluidnet": "the reference lost the HalfNewFluidNet class "
                       "(SURVEY.md §2): no checkpoint of it exists and the "
                       "JAX package's converter has no map for it",
    "multiscalenewfluidnet": "the reference lost the multi-scale ensemble "
                             "(SURVEY.md §2): no checkpoint of it exists and "
                             "the JAX package's converter has no map for it",
    "convae": "the reference's ConvAE is a checkpoint-only model "
              "(pycold-checkpoint.py:989) whose state_dict names the JAX "
              "package's name map does not hold: no conversion (ROADMAP "
              "queue 1 item 8, left out)",
}


def _tensor(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().clone().contiguous()


def _convert_conv(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    """One conv-ish reference submodule at ``src`` (a plain, symmetric,
    boundary-learned or spectral conv) → the port's names under ``dst``.
    A symmetric conv stores its unique filters, as the port's does: they
    go across as they are."""
    rels = {k[len(src) + 1:]: k for k in sd if k.startswith(src + ".")}
    if "weights1" in rels:  # SpectralConv2d
        for i in (1, 2):
            w = torch.as_tensor(sd[rels[f"weights{i}"]])
            out[f"{dst}.weights{i}_real"] = _tensor(w.real)
            out[f"{dst}.weights{i}_imag"] = _tensor(w.imag)
        return
    if "learnable_bias" in rels:  # BoundaryLearnedConvolution2D
        for sub in _BLC_SUBMODULES:
            wk = f"{sub}.weight"
            if wk in rels:
                out[f"{dst}.{sub}.weight"] = _tensor(sd[rels[wk]])
        out[f"{dst}.learnable_bias"] = _tensor(
            sd[rels["learnable_bias"]]).reshape(-1)
        return
    if "weight" not in rels:
        raise KeyError(f"no conv weights under {src!r}")
    if "bias" in rels:
        out[f"{dst}.bias"] = _tensor(sd[rels["bias"]])
    out[f"{dst}.weight"] = _tensor(sd[rels["weight"]])


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
    """NewFluidNet or FluidNet state_dict (plain, symmetric,
    boundary-learned or spectral convs) → the port's
    ``models/fluidnet.py`` state_dict of the same class."""
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


def convert_vit(state_dict: Mapping, depth: int, prefix: str = ""
                ) -> Dict[str, torch.Tensor]:
    """lucidrains ViT state_dict → the port's ``models/vit.py::ViT``
    state_dict, its keys under ``prefix`` ("vit." for ``ViTField``); the
    names of JAX's ``convert_vit``, the tensors as they are."""
    sd = dict(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src, bias=True):
        out[f"{prefix}{dst}.weight"] = _tensor(sd[f"{src}.weight"])
        if bias:
            out[f"{prefix}{dst}.bias"] = _tensor(sd[f"{src}.bias"])

    put("LayerNorm_0", "to_patch_embedding.1")
    put("Dense_0", "to_patch_embedding.2")
    put("LayerNorm_1", "to_patch_embedding.3")
    for name in ("pos_embedding", "cls_token"):
        out[prefix + name] = _tensor(sd[name])
    for i in range(depth):
        a, f = f"transformer.layers.{i}.0", f"transformer.layers.{i}.1"
        t = f"Transformer_0.attn_{i}"
        put(f"{t}.LayerNorm_0", f"{a}.norm")
        put(f"{t}.Dense_0", f"{a}.to_qkv", bias=False)
        put(f"{t}.Dense_1", f"{a}.to_out.0")
        t = f"Transformer_0.ff_{i}"
        put(f"{t}.LayerNorm_0", f"{f}.net.0")
        put(f"{t}.Dense_0", f"{f}.net.1")
        put(f"{t}.Dense_1", f"{f}.net.4")
    put("Transformer_0.LayerNorm_0", "transformer.norm")
    put("Dense_1", "mlp_head")
    return out


def load_reference_checkpoint(path: str, network: str, levels: int,
                              repeats: int) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pt`` state_dict (``weights_only``) and convert
    it for the port's ``network`` (for a Transolver ``levels`` is its
    number of blocks, for the ViT its depth, as in the JAX package's
    converters). The networks of :data:`NO_CONVERSION` raise."""
    if network in NO_CONVERSION:
        raise NotImplementedError(NO_CONVERSION[network])
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if network in ("unet", "iunet"):
        return convert_unet(sd, levels, repeats)
    if "transolver" in network:
        return convert_transolver(sd, levels)
    if network == "vit":
        return convert_vit(sd, levels, prefix="vit.")
    return convert_fluidnet(sd, levels, repeats)
