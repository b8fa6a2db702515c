"""Experiment registry: the canonical ablation grid.

Counterpart of the JAX package's ``train/experiments.py``, the same
entries: the programmatic equivalent of the reference's
``network_lists.ipynb`` cell 0, the recorded training commands spanning
the architecture / padding / loss ablation grid. Each entry is argv for
this package's train CLI (cli/train.py). Run one with
``run_experiment(name)`` or list them with ``EXPERIMENTS``. Every entry
runs; ``fluidnet_base``'s six learned-padding levels need a grid of at
least 192 cells each way (its deepest branch must keep the 6-cell slab),
and below that it raises a ``ValueError`` (JAX: an ``IndexError``).
"""

from __future__ import annotations

from typing import Dict, List

# Each entry: CLI argv for pbml_mantle_convection_tpu_torch.cli.train
# (flag names match the reference trainer, multigpu.py:917-972).
EXPERIMENTS: Dict[str, List[str]] = {
    # -- production flagship (advect_wi_gaia.py defaults: l=5/6, c_h=16,
    #    r=4-6, k=5, learned padding, curl loss, loss_scale+derivative)
    "newfluidnet_flagship": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "learned", "-lt", "curl", "-b", "16", "-ab", "10",
        "-l_sc", "1", "-l_de", "1"],
    # -- padding ablations (Ablation_padding study)
    "newfluidnet_pad_zeros": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "zeros", "-lt", "curl", "-b", "16", "-ab", "10",
        "-l_sc", "1", "-l_de", "1"],
    "newfluidnet_pad_replicate": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "replicate", "-lt", "curl", "-b", "16", "-ab", "10",
        "-l_sc", "1", "-l_de", "1"],
    # -- mass/loss ablations (Ablation_mass / Ablation_loss_scale)
    "newfluidnet_mass": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "learned", "-lt", "mass", "-b", "16", "-ab", "10",
        "-l_sc", "1", "-l_de", "1"],
    "newfluidnet_mae": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "learned", "-lt", "mae", "-b", "16", "-ab", "10",
        "-l_sc", "1", "-l_de", "0"],
    "newfluidnet_no_loss_scale": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "learned", "-lt", "curl", "-b", "16", "-ab", "10",
        "-l_sc", "0", "-l_de", "1"],
    # -- symmetric convolutions
    "newfluidnet_symm": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "learned", "-lt", "curl", "-b", "16", "-ab", "10",
        "-s", "1", "-l_sc", "1", "-l_de", "1"],
    # -- older FluidNet topology
    "fluidnet_base": [
        "-net", "fluidnet", "-l", "6", "-f", "16", "-r", "4", "-k", "5",
        "-p", "learned", "-lt", "curl", "-b", "16", "-ab", "10",
        "-l_sc", "1", "-l_de", "1"],
    # -- pressure prediction
    "newfluidnet_p_pred": [
        "-net", "newfluidnet", "-l", "5", "-f", "16", "-r", "6", "-k", "5",
        "-p", "learned", "-lt", "curl", "-b", "16", "-ab", "10",
        "-pp", "1", "-l_sc", "1", "-l_de", "1"],
    # -- spectral (FNO) variant
    "newfluidnet_spectral": [
        "-net", "newfluidnet", "-l", "3", "-f", "16", "-r", "2", "-k", "5",
        "-p", "zeros", "-lt", "curl", "-b", "16", "-ab", "10",
        "-spectral", "1"],
    # -- multi-scale viscosity ensemble
    "multiscale": [
        "-net", "multiscalenewfluidnet", "-l", "4", "-f", "16", "-r", "4",
        "-k", "5", "-p", "learned", "-lt", "curl", "-b", "16", "-ab", "10",
        "-scales", "1e-5", "1e-3", "1e-1", "1e1"],
    # -- coupled U-Net with roll-forward unrolling (roll1/roll2/roll4)
    "unet_roll1": [
        "-net", "unet", "-l", "4", "-f", "32", "-r", "2", "-k", "5",
        "-p", "replicate", "-lt", "curl", "-b", "8", "-ab", "10",
        "-roll", "1", "-l_sc", "1"],
    "unet_roll2": [
        "-net", "unet", "-l", "4", "-f", "32", "-r", "2", "-k", "5",
        "-p", "replicate", "-lt", "curl", "-b", "8", "-ab", "10",
        "-roll", "2", "-l_sc", "1"],
    "unet_roll4": [
        "-net", "unet", "-l", "4", "-f", "32", "-r", "2", "-k", "5",
        "-p", "replicate", "-lt", "curl", "-b", "8", "-ab", "10",
        "-roll", "4", "-l_sc", "1"],
    # -- autoencoder
    "convae": [
        "-net", "convae", "-l", "2", "-f", "8", "-r", "2", "-k", "3",
        "-p", "zeros", "-lt", "curl", "-b", "16", "-ab", "4"],
    # -- transformer baselines
    "transolver": [
        "-net", "transolver_structured", "-lt", "curl", "-b", "4",
        "-ab", "10"],
    "vit": ["-net", "vit", "-lt", "mae", "-b", "4"],
}


def run_experiment(name: str, extra_args: List[str] = (),
                   synthetic: bool = True):
    """Launch one registered experiment through the train CLI
    (``extra_args`` such as ``["--device", "cpu", "--epochs", "1"]``)."""
    from ..cli.train import main
    argv = list(EXPERIMENTS[name]) + list(extra_args)
    if synthetic:
        argv.append("--synthetic")
    return main(argv)
