#!/usr/bin/env python3
"""The drivers on the card alone: ``chip_smoke.py`` phase 10 beside its
phase 3 (``bench_torch.py`` at 128×506 and 256², whose 128×506 figure
phase 10 prints the rollout CLI's steps/s against).

Builds the CUDA kernels, runs ``chip_smoke.run_main_path`` and then
``chip_smoke.run_drivers`` (the flagship through ``cli/rollout.py`` for
2000 steps, ``--engine native``, ``-m GAIA``, ML_PRE and
``cli/analyze.py``, with their launch checks). Run from the repository
root on a machine with a CUDA device (~1 min)::

    python3 tools/torch_port_drivers.py
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    import bench_torch
    import chip_smoke
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    t0 = time.time()
    print(chip_smoke.card_line())
    _cuda.build()
    _cuda.library()
    counters = bench_torch.counters()
    _, sps = chip_smoke.run_main_path(counters)
    chip_smoke.run_drivers(counters, sps[128, 506])
    print(f"total {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
