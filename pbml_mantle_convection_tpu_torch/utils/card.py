"""The card a measurement ran on: its name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them (a card set below its maximum runs slower under load, so every
number kept is written beside both)."""

from __future__ import annotations

import subprocess

import torch


def card_info(device) -> dict:
    """{"device": name, "power_limit": e.g. "700.00 W"} of a CUDA
    device; {"device": "cpu", "power_limit": None} of the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    name, limit = (f.strip() for f in out.strip().split(","))
    return {"device": name, "power_limit": limit}
