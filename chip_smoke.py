#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   ``pbml_mantle_convection_tpu_torch/csrc`` (nvcc, sm_90a), prints the
   build time, and checks with ``cuobjdump --dump-sass`` that the layer
   kernels of ``layer_stack`` and ``trunk`` (learned-boundary and
   zero-padded instances, ``layer_stack``'s for each activation) and
   every ``slice_pool_kernel``
   and ``slice_deslice_kernel`` instance, the dense attention kernel and
   the projection conv and Dense GEMM kernels hold TF32 tensor-core MMAs
   (the slice, attention, projection and GEMM kernels' in threes: 3xTF32;
   the projection and GEMM kernels' are wgmma, ``HGMMA``);
   then, under PyTorch's default flags (TF32 convs allowed), holds a small
   NewFluidNet and a small TransolverStructured2D against the same modules
   in float64 and times the float32 guard of the port's convs;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship's 128×506 rollout gives it (TF32 off), and times
   both; ``layer_stack`` and ``trunk`` also in their zero-padded instance
   (the JAX kernels' ``learned=False``) at the shapes of the flagship with
   ``-pad zeros``, timed beside the learned instance; the two energy
   kernels (``curl_advect_epilogue``, ``advect_diffuse_step_fused``)
   also at zero velocity (dt must be dt_diffuse to the bit), for the
   same bits on a second call, for their
   device kernels per call (``torch.profiler``: one each), in a CUDA graph
   replayed on new inputs (the eager bits), device-only beside their byte
   bound and the launch floor (an empty kernel of the same grid), and for
   the host's µs per call;
3. drives the main path — the coupled ML_STOKES rollout of the flagship
   NewFluidNet (levels=5, c_h=16, repeats=6, k=5, learned padding, curl
   head; seeded random weights) through the fused executor at 128×506 and
   256×256 with ``bench_torch.main()`` (20 warm-up steps, best of 3 × 500;
   it echoes its JSON line and checks that T stays finite) — checks the
   kernel launch counts per step (4 + 1 + 1 + 0), and compares 10 steps
   of the kernel path with the plain-PyTorch module path; then the
   flagship with ``-pad zeros`` (the zero instances) through
   ``cli/benchmark.py --what rollout -pad zeros`` at 128×506 and 256²,
   B = 1 and 4 (4 + 1 + 1 + 0 and 4B + B + 0 + 1 launches per step), and
   10 of its steps against its module path;
4. drives the other engine modes at 128×506 in float32 — GAIA (converged
   PT Stokes solve, ``make_stokes_fn`` defaults), GAIA-skip3, ML_PRE with
   the flagship (pre_iter=200) and ML_STOKES with core cooling, Di=0.5 and
   radioactive decay — checks their launch counts per step, T and its
   boundary rows, prints ms/step and PT iterations, and holds each of a
   few steps against a plain reference step composed here from the plain
   functions;
5. serves the Transolver: holds both slice-attention kernels against
   their plain versions at BH=8, N=64,768 with (D, G) = (16, 32) (the
   serving shape), (32, 64), (64, 128) and (128, 128) in float32 and at
   the serving shape in bfloat16, on dense tensors and on the (1, 8, N, D)
   views of (1, N, 8·D) rows that the projections give (the deslice then
   writing such rows), at a ragged N, in float64 and past 128 (the SIMT
   kernels), and times them beside their byte and operation bounds;
   prints the strides of the projections' outputs and counts, by name,
   the device kernels of one Physics-Attention forward (no copy kernel on
   the 2-D structured and irregular paths); drives
   ``cli/benchmark.py --what inference -net transolver_structured`` at
   the serving configuration (``ModelConfig`` defaults: 128×506, 5
   layers, n_hidden=128, 8 heads, 32 slices; seeded random weights) and
   checks 5 + 5 slice-attention launches per forward; splits one forward
   into projections, slice attention and the rest; compares the kernel
   path's u, v with the einsum formulation's; runs TransolverIrregular
   once at the same N; then (5b) holds the ViT's dense attention kernel
   against float64 at ViT-Base's shape over the field (B = 1, 12 heads of
   64, 4,049 tokens; q, k, v strided views of one qkv tensor) and times it
   (ms a block) beside its bound (3xTF32 operations), the plain einsum +
   softmax path and ``F.scaled_dot_product_attention`` in float32
   (``library_ms``, a yardstick the port never calls); then (5c) runs
   ViT-Base of the ``vit-serve-b1`` cell through ``ViTField`` at B = 1
   without grad and checks 12 dense attention launches per forward; then
   (5e) holds the Transolver's projection conv kernel (both 3×3
   projections of a block in one launch) against ``F.conv2d`` in float64
   at the cell's shape (B = 1, 128×506, 128 → 2 × 128; no worse than
   twice plain float32's error, the same bits twice, one launch a call)
   and times it (ms a block) beside its bound (3xTF32 operations, and the
   TF32 rate's), its plain version (the kernel's nine shifted products
   written in plain PyTorch) and cuDNN's ``F.conv2d`` pair in float32
   with its layout copies (``library_ms``, the port's path off the
   kernel's route); then (5f) runs the ``transolver-serve-b1`` cell's
   Transolver (8 blocks, 64 slices) at B = 1 without grad and checks 8
   projection conv launches per forward; then (5g) holds the ViT family's
   Dense GEMM kernel against ``F.linear`` in float64 at each Dense shape
   of the ViT-Base and SAM ViT-B cells (no worse than 1.5× float32
   ``F.linear``'s error, the same bits twice, one launch a call) and times
   it (ms a call) beside its bound (3xTF32 operations), its plain version
   (the kernel's split and per-stage sums in plain PyTorch) and float32
   ``F.linear`` (``library_ms``, cuBLAS, a yardstick the kernel's route
   never calls); then (5h) runs one ViT-Base and one SAM ViT-B forward of
   the cells' configurations at B = 1 without grad and checks 48 Dense
   GEMM launches per forward;
6. runs ``tools/torch_port_accuracy.py`` at 128×506 for 500 steps: the
   flagship ML_STOKES rollout (fused, module float32 and module TF32
   against the float64 module path with the energy step's plain version;
   the fused T-RMSE must stay below ``ACC_T_RMSE`` and the TF32 control
   must not), the core-cooling Di=0.5 mode (``DI_STEPS`` = 100 steps,
   printed, finite) and the ``-pad zeros`` flagship (fused below
   ``ACC_T_RMSE``); each leg's
   launches per step are checked, and kept out of the kernels line;
7. runs ``cli/benchmark.py --what rollout --batch 4`` at 128×506 (4B + B
   + 1 + 0 launches per step) and the same at B = 1;
8. trains, through the module path with autograd as JAX trains (no kernel
   has a backward; the train and eval steps run the Transolver's einsum
   formulation): under PyTorch's default flags one train step's parameter
   gradients of a small NewFluidNet and a small TransolverStructured2D, and
   of the flagship and the serving Transolver at 128×506, B = 2, against
   the same step in float64 (≤ ``TOL_TRAIN_GRAD``; the control with the
   backward outside the step's float32 guard must read above it; the step
   with cuDNN off printed beside it, and for each the parameter where the
   error sits), every Transolver parameter with a gradient; the
   flagship's readings of ROADMAP §3 fault 7 at B = 2 and 8, weight seeds
   0-2, each ≤ ``TOL_FAULT7``; a Transolver
   forward with grad on outside the step goes through the slice kernels
   (one launch each per block) with its gradients, the einsum formulation
   recomputed in the backward, within the same bound; the slice kernels
   refusing an input that requires grad; ``cli/benchmark.py --what train
   --profile`` for the flagship and for ``transolver_structured`` at its
   serving configuration, 128×506, B = 8 (both JSON lines echoed, losses
   finite, peak memory, the step's split and the device's idle share in
   them); the Trainer on the JAX CLI's synthetic stores at 128×506 with the
   README's flagship flags: two epochs, a restart into a third, a fourth
   host-resident (epoch wall times printed); no kernel wrapper launches
   during any of the training runs (those counts stay out of the kernels
   line);
9. runs the U-Net at ``unet_roll1``'s width (levels 4, c_h 32, repeats
   2, k 5, replicate padding) at 128×506: ``cli/benchmark.py --what
   inference``, ``--what rollout`` and ``--what train`` (B = 8) with
   their JSON lines, 20 coupled steps in float32 against float64 (each
   step from the float64 state, the free-running trajectory for its
   first steps, and a float64 trajectory from a start 1e-7 off as the
   witness that the dynamics part them later), train-step gradients
   against float64 at B = 2 with the TF32 control and at B = 8 for
   weight seeds 0-2; no kernel wrapper launches (the U-Net runs no
   kernel, on JAX neither);
10. drives the drivers at 128×506 with the flagship's seed-0 weights,
   written once as a port checkpoint and read through ``--nn_dir``:
   (a) ``cli/rollout.py -m ML_STOKES --max_steps 2000`` (``rollout_torch``,
   chunks of 10 steps): the six files of the run directory, 2000 finite
   T_vec values, 4 + 1 + 1 + 0 launches per step (its warm-up step
   counted), the final T against one ``SimEngine.multi_step(2000)`` from
   the same T0 (≤ ``TOL_DRIVER_T``, bitwise printed), steps/s from
   sum(TS_vec) beside phase 3's ``bench_torch.py`` figure; (b) ``--engine
   native`` for 20 steps (the C++ engine on the host, the surrogate on
   the card: 4 + 1 + 0 + 1 per step, ms/step); (c) ``-m GAIA`` for 3 steps
   (the C++ momentum solve, no launch, ms/step); (d) ``-m ML_PRE`` for 5
   steps (4 + 1 + 0 + 1 per step); (e) ``cli/analyze.py`` over (c) and
   (b), (c) the baseline (finite Pearson values); the counts stay out of
   the kernels line;
11. runs the other models at 128×506 under PyTorch's default flags:
   (a) ``cli/rollout.py`` at its default ``-s 1`` (the symmetric
   flagship on the module path) for 100 steps, 0 + 0 + 0 + 1 launches per
   step, steps/s from sum(TS_vec), its forward against float64; (b) the
   ``blurr`` flagship through the fused executor, 4 + 1 + 0 + 1 per step
   (no fused epilogue: it would skip the blur), steps/s beside phase 3's,
   10 steps against its module path; (c) ``cli/benchmark.py --what
   inference|rollout|train`` for FluidNet (-l 5 -r 4), the multi-scale
   ensemble (-l 4 -r 4) and the ViT (defaults; train B = 4, the others
   B = 8), 0 + 0 + 0 + 1 per rollout step; (d) the spectral network
   against float64 on cuFFT; (e) train-step gradients of the symmetric
   flagship, FluidNet, the ensemble, the spectral network and the ViT at
   B = 2 and weight seeds 0-2 against float64 (``TOL_TRAIN_GRAD``; above
   it, only a loss kink crossed by rounding, as ``locate_kink`` proves
   it); (f) a
   dropout train step repeated from its generator's seed; the counts stay
   out of the kernels line;
12. runs the parallel paths and bfloat16 at 128×506 on a process group
   of one NCCL rank: (a) ``cli/benchmark.py --what rollout --sharded`` at
   B = 1 and 4 (4 + 1 + 1 + 0 launches per simulation-step; sim-steps/s
   beside phase 3's steps/s), and 4 simulations of ``make_batch_sharded``
   bitwise equal to standalone B = 1 runs; (b) the coupled rollout with
   the process group (dt all-reduced, the energy kernel with that dt:
   4B + B + 0 + 1 per step) bitwise equal to the batched rollout; (c)
   ``physics_attention_sharded`` at the serving shape (8 heads, D = 16,
   G = 32, N = 64,768) against the unsharded kernel path
   (``TOL_SHARDED_ATTN``, one ``slice_pool`` and one ``slice_deslice``
   launch per call), timed with and without its two all-reduces, and the
   same over two gloo ranks sharing the card (processes of this script,
   ``--attention-rank``), N split in halves; (d) a
   ``torch.distributed.checkpoint`` round trip of the flagship's train
   state; (e) ``--what inference -net transolver_structured --dtype
   bfloat16`` at the serving configuration (5 + 5 launches per forward;
   its stream function against float32 within ``TOL_BF16_PSI``), the
   zero-padded flagship's bfloat16 inference on the fused executor (4 + 1
   launches per forward, float32 kernels on the bfloat16 weights; its
   stream function against the float32 module within
   ``TOL_BF16_EXECUTOR``), the
   flagship's bfloat16 ``--raw-module`` inference and ``--what train``
   (B = 8), and the bfloat16 flagship rollout refused with JAX's reason;
13. runs the layer kernels' instances of each of the seven activations
   (``act_fn`` of ``models/layers.py``: gelu, selu, elu, silu, relu,
   tanh, sine), each with learned and zero padding, on the flagship at
   128×506: (a) each instance's four ``layer_stack`` calls and its
   ``trunk`` against their plain versions and timed as in phase 2; the
   ``sine`` instances, whose six-layer stacks can be chaotic in float32,
   held per layer (and one R = 2 call) against float64, the kernel's
   error within ``SINE_DECADE`` of the plain float32 path's; (b) a fused
   ML_STOKES rollout of each (20 + 200 steps through ``SimEngine.
   multi_step`` with learned padding, 1 + 200 through ``rollout_torch``
   with zero padding; 4 + 1 + 1 + 0 launches per step, T finite; steps/s
   beside phase 3's); (c) the 200-step fused T_rmse of the ``selu`` and
   ``relu`` flagships against the float64 module path, below
   ``ACC_T_RMSE``;
14. runs the rollout CLI's other heads at the flagship's width
   (``run_heads``): (a) the ``mae`` + ``p_pred`` and curl + ``p_pred``
   executors (merge 3 at c_o 3 and 2), learned and zero padding, each
   ``layer_stack`` call and ``trunk`` against their plain versions,
   timed, merge 3 beside its bound; (b) ``cli/rollout.py --fast 1`` with
   ``-lt mae -pp 1``, ``-pp 1`` and ``-lt mass`` for 200 steps each: the
   fused executor's route line, 4 + 1 + 0 + 1 launches per step (these
   heads take no fused epilogue), the pressure in the snapshots with
   ``-pp 1``, steps/s beside phase 3's and the curl head's through the
   same CLI; (c) ``--fast 1 -f 32`` and ``-k 3``: the module route, 0 +
   0 + 0 + 1 per step, steps/s; (d) the ``mae`` + ``p_pred`` flagship's
   200-step fused T_rmse below ``ACC_T_RMSE``;
15. runs the port's four study tools through their ``main`` at cut
   sizes (``run_studies``, ``STUDY_ARGV``): (a) the speedup study (GAIA,
   GAIA-skip10, ML_STOKES, ML_PRE at 50×74, float64, 40 steps, 1000 PT
   iterations): every row finite, 0 + 0 + 0 + 1 launches per step in each
   mode, GAIA-skip10's final T-RMSE below ML_STOKES's (ML_PRE's
   printed); (b) the reference-scale study at 128×506 (9 GAIA steps per
   simulation, the flagship trained 2 epochs through the Trainer with a
   restart at epoch 1): the restart epoch, 4 + 1 + 1 + 0 launches per
   ML_STOKES step and 4 + 1 + 0 + 1 per ML_PRE step of the held-out
   rollouts, the trained-vs-untrained margin; (c) the interleave
   fidelity tool at 128×506 (40 steps, the native step every 10th): 4 +
   1 + 1 + 0 in leg A, 4 + 1 + 0 + 1 in the native legs; (d) the
   HBM-scale study ``--phase inline`` on a 311 MB host-resident store:
   finite losses, the restart into epoch 1, no launch;
16. prints one JSON line of per-kernel numbers (launches summed over
   phases 3, 4, 5, 7, 12 (a)-(b), 14 (b)-(c) and 15; the layer kernels' zero
   instance, its launches from phase 3c alone, under ``zero_instance``,
   each (activation, padding) instance of phase 13, its launches from 13
   (b), under ``activation_instances``, and each (head, padding)
   instance of phase 14, with merge 3's own numbers and the launches of
   14 (b), under ``head_instances``, the top-level counts being the
   learned GELU curl instance's; the dense attention kernel's are phase
   5c's, the projection conv kernel's phase 5f's, the Dense GEMM kernel's
   phase 5h's), the card line again,
   and last
   ``{"ok": true, "device": {...}}``.

``--phase 10``, ``--phase 11``, ``--phase 12``, ``--phase 13``,
``--phase 14`` or ``--phase 15`` builds the kernels and runs phase 3 and
then that phase alone (the drivers, the other models, the parallel
paths, the activations, the heads or the study tools, whose steps/s it
prints beside phase 3's),
with their launch checks; it prints no result line::

    python3 chip_smoke.py --phase 12

Any failed phase raises, so the script exits non-zero and prints no result
line; so does a machine without a CUDA device or a directory without the
package. The script imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, dense TF32 FLOP/s of the tensor cores (3xTF32
# spends three TF32 products on each float32-accurate one: 495/3)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_3XTF32 = 495e12 / 3
REPLACES = {
    "layer_stack": "pbml_mantle_convection_tpu/ops/branch_kernel.py:609",
    "trunk": "pbml_mantle_convection_tpu/ops/merge_kernel.py:76",
    "curl_advect_epilogue":
        "pbml_mantle_convection_tpu/ops/epilogue_kernel.py:60",
    "advect_diffuse_step_fused":
        "pbml_mantle_convection_tpu/ops/pallas_kernels.py:46",
    "slice_pool": "pbml_mantle_convection_tpu/ops/slice_attention.py:44",
    "slice_deslice": "pbml_mantle_convection_tpu/ops/slice_attention.py:60",
    "dense_attention": "none (pbml_mantle_convection_tpu/models/vit.py:60 "
                       "computes the ViT's attention as einsum + softmax)",
    "projection_conv": "none (pbml_mantle_convection_tpu/models/"
                       "transolver.py:165-168 leaves the convs to XLA)",
    "dense_gemm": "none (pbml_mantle_convection_tpu/models/vit.py leaves "
                  "the ViT's Dense layers to XLA)",
}
SOURCES = {
    "layer_stack": "pbml_mantle_convection_tpu_torch/csrc/layer_stack.cu",
    "trunk": "pbml_mantle_convection_tpu_torch/csrc/trunk.cu",
    "curl_advect_epilogue":
        "pbml_mantle_convection_tpu_torch/csrc/epilogue.cu",
    "advect_diffuse_step_fused":
        "pbml_mantle_convection_tpu_torch/csrc/advect.cu",
    "slice_pool": "pbml_mantle_convection_tpu_torch/csrc/slice_attention.cu",
    "slice_deslice":
        "pbml_mantle_convection_tpu_torch/csrc/slice_attention.cu",
    "dense_attention":
        "pbml_mantle_convection_tpu_torch/csrc/dense_attention.cu",
    "projection_conv":
        "pbml_mantle_convection_tpu_torch/csrc/projection_conv.cu",
    "dense_gemm": "pbml_mantle_convection_tpu_torch/csrc/dense_gemm.cu",
}
# kernel vs plain version, max |diff| / max |plain|: both are float32 with
# sums in another order (25·c_in-term conv dots, double vs float GroupNorm
# statistics, the epilogue's analytic mean cancellation); the energy step
# differs only by FMA contraction (1e-12 in float64)
# the slice kernels in float32 against their plain versions in float64:
# float32 sums over N (pool) or G (deslice); 1e-12 when both are float64
# the dense attention kernel in float32 against float64: 3xTF32 products
# and exp2 over 4,049 keys (the plain float32 path reads ~1e-6)
TOL = {"layer_stack": 1e-4, "trunk": 1e-4, "curl_advect_epilogue": 1e-5,
       "advect_diffuse_step_fused": 1e-5, "slice_pool": 1e-5,
       "slice_deslice": 1e-5, "dense_attention": 5e-6}
TOL_ADVECT_F64 = 1e-12
TOL_SLICE_F64 = 1e-12
# bfloat16 slice kernels against the float32 plain version of the same
# bfloat16 values: the rounding of a bfloat16 output (2^-8 relative), twice
TOL_SLICE_16 = 8e-3
# float32 modules against float64 at PyTorch's default flags: the conv
# kernels' bound (TF32 convs land near 1e-3)
TOL_MODULE_F64 = 1e-4
# one Transolver forward, kernel path vs the einsum formulation, relative
# to max |plain|: the stream function (the last block's output) after 5
# blocks of float32 attention; u and v are its central differences, ~10x
# smaller than it (printed), so the same absolute error weighs ~10x more
TOL_TRANSOLVER = {"psi": 1e-4, "u": 1e-3, "v": 1e-3}
# 10 coupled steps, kernel path vs module path: the random-weight network
# (34 GroupNorm layers) feeds its float32 reassociation noise back through
# T → viscosity → velocities every step
TOL_ROLLOUT = {"T": 1e-3, "u": 2e-2, "v": 2e-2}
# 500-step T-RMSE of the fused flagship rollout against the float64 module
# path at 128×506, between the float32-accurate readings (fused 7.8e-7,
# module float32 7.4e-7 on the H100) and the module path's at cuDNN TF32
# (2.8e-5), which must fail it: the bound tells float32 from TF32
ACC_T_RMSE = 5e-6
# device kernels of one call with the adaptive dt (torch.profiler): the
# grid-wide dt is formed inside one cooperative launch
DEVICE_KERNELS = {"curl_advect_epilogue": 1, "advect_diffuse_step_fused": 1}
# threads per block of both energy kernels (csrc/epilogue.cu and
# csrc/advect.cu kBlock): their launch floor is an empty kernel of as many
# blocks of as many threads as the 128×506 call
ENERGY_BLOCK = 512


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    from pbml_mantle_convection_tpu_torch.utils.card import card_info
    card = card_info("cuda")
    return f"{card['device']}, {card['power_limit']}"


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def queued_ms(fn, n: int = 200) -> float:
    """Device time per call: the host queues the n calls while the card
    spins (~50 ms), so the events time the kernels back to back and not
    the host's enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_us(fn, n: int = 300) -> float:
    """The host's µs per call of ``fn`` (its wrapper's enqueue): n calls
    timed on the host clock, the device kept ahead of them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def launch_floor(blocks: int, threads: int) -> dict:
    """The device-only ms of an empty kernel of ``blocks`` × ``threads``,
    200 queued back to back (``queued_ms``): an ordinary launch
    ("plain"), a cooperative one, and a cooperative one whose blocks meet
    once at ``this_grid().sync()`` (csrc/epilogue.cu::pmc_empty)."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    lib, st = _cuda.library(), torch.cuda.current_stream().cuda_stream
    out = {}
    for mode, name in ((0, "plain"), (1, "cooperative"),
                       (2, "cooperative_sync")):
        def empty(mode=mode):
            _cuda.raise_on_error(lib.pmc_empty(blocks, threads, mode, st),
                                 "pmc_empty")
        out[name] = queued_ms(empty)
    return out


def graph_replay(name, fn, static, fresh, reps: int = 3) -> None:
    """Captures ``fn(*static)`` in a ``torch.cuda.CUDAGraph``, then ``reps``
    times copies new inputs (``fresh(k)``) into the static buffers,
    replays, and holds the graph's outputs to the bits of an eager call on
    the same inputs."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(*static)
    for k in range(reps):
        new = fresh(k)
        for a, b in zip(static, new):
            a.copy_(b)
        graph.replay()
        eager = fn(*new)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, eager)):
            raise AssertionError(f"{name}: CUDA-graph replay {k} differs "
                                 f"from the eager call")
    print(f"{name}: captured in a CUDA graph; {reps} replays on new inputs "
          f"give the eager bits")


def bound_ms(n_bytes: float, flops: float, tensor_cores: bool = False
             ) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate, or the flops
    at the float32 SIMT peak (or, ``tensor_cores``, at the 3xTF32 rate of
    the tensor cores), whichever is longer."""
    peak = PEAK_3XTF32 if tensor_cores else PEAK_F32
    tb, to = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def conv_taps(conv) -> int:
    """Taps per output pixel of a layer's own conv (k × k), whatever the
    kernel packs it as: the zero-padded flagship's 3×3 merge convs run
    as 5×5 kernels with a zero ring, 25/9 of the MACs the function
    needs."""
    w = conv.kernels()[0] if hasattr(conv, "kernels") else conv.weight
    return w.shape[-2] * w.shape[-1]


def stack_work(sw, H, W, n_pyr=0, taps=25):
    """(bytes, flops) of one layer_stack over an H × W field whose convs
    have ``taps`` taps (:func:`conv_taps`): inputs read once, outputs
    written once; conv FMAs as 2 flops, + bias, GroupNorm (~4/elem) and
    GELU (~6/elem), 4 flops per pooled output (the n_pyr successive
    pools of the output)."""
    hw = H * W
    flops = 0.0
    c_in = sw.c_in
    n_w = 0
    for ws in sw.kernels:     # 9 weight classes (learned) or 1 (zeros)
        flops += (2 * c_in * taps + 1 + 4 * sw.use_gn + 6 * sw.use_act) \
            * sw.c_o * hw
        n_w += len(ws) * c_in * taps * sw.c_o
        c_in = sw.c_o
    n_pool = sum(sw.c_o * (H >> l) * (W >> l) for l in range(1, n_pyr + 1))
    flops += 4 * n_pool
    n_bytes = 4 * (sw.c_in * hw + n_w + 3 * sw.bias.numel()
                   + sw.c_o * hw + n_pool)
    return n_bytes, flops


def check_sass(so) -> None:
    """The layer kernels (``blc_fused_kernel``, in layer_stack.cu's and in
    trunk.cu's objects, each in its learned-boundary and its zero-padded
    instance, layer_stack.cu's for each of the seven activations) and the slice kernels' tensor-core instances
    (``slice_pool_kernel`` and ``slice_deslice_kernel``, one per storage
    type and G bucket) run their products on the tensor cores: their SASS
    in the built library holds TF32 ``HMMA`` (or ``HGMMA``) instructions,
    the slice kernels' a multiple of three (3xTF32: three products for
    each float32-accurate one); the dense attention kernel a multiple of
    384, a tile's 2 × 64 m16n8k8 products three times each; the
    projection conv kernel's ``HGMMA`` (wgmma) a multiple of 18, a stage's
    6 k-steps three times each; the dense GEMM kernel's (one instance,
    three warpgroups) a multiple of 12, a stage's 4 k-steps three times
    each. Prints the count per kernel instance (``cuobjdump
    --dump-sass``)."""
    import shutil
    from pathlib import Path
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import ACT_CODES
    act_names = {c: a for a, c in ACT_CODES.items()}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise AssertionError("cuobjdump not found: cannot check the SASS")
    sass = subprocess.run([tool, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if re.search(
                r"blc_fused_kernel|slice_(pool|deslice)_kernel|"
                r"dense_attention_kernel|projection_conv_kernel|"
                r"dense_gemm_kernel",
                m.group(1)) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\.\S*TF32", line):
            counts[fn] += 1
    slices = {}
    dense = {k: counts.pop(k) for k in list(counts)
             if "dense_attention_kernel" in k}
    print(f"sass: dense_attention.cu dense_attention_kernel: "
          f"{list(dense.values())} TF32 tensor-core MMA instructions")
    if len(dense) != 1 or not all(n and n % 384 == 0
                                  for n in dense.values()):
        raise AssertionError(f"dense_attention_kernel without its 3xTF32 "
                             f"MMAs: {dense}")
    proj = {k: counts.pop(k) for k in list(counts)
            if "projection_conv_kernel" in k}
    print(f"sass: projection_conv.cu projection_conv_kernel: "
          f"{list(proj.values())} TF32 tensor-core MMA instructions")
    if len(proj) != 1 or not all(n and n % 18 == 0 for n in proj.values()):
        raise AssertionError(f"projection_conv_kernel without its 3xTF32 "
                             f"wgmma products: {proj}")
    gemm = {k: counts.pop(k) for k in list(counts)
            if "dense_gemm_kernel" in k}
    print(f"sass: dense_gemm.cu dense_gemm_kernel: {list(gemm.values())} "
          f"TF32 tensor-core MMA instructions")
    if len(gemm) != 1 or not all(n and n % 12 == 0 for n in gemm.values()):
        raise AssertionError(f"dense_gemm_kernel without its 3xTF32 wgmma "
                             f"products: {gemm}")
    for name, n in sorted(counts.items()):
        t = re.search(r"(slice_(?:pool|deslice)_kernel)I(\w+?)Li(\d+)E",
                      name)
        if t:
            inst = (f"{t.group(1)}<{t.group(2).lstrip('0123456789_')}, "
                    f"{t.group(3)}>")
            slices[inst] = n
            print(f"sass: slice_attention.cu {inst}: {n} TF32 tensor-core "
                  f"MMA instructions")
            continue
        src = "trunk.cu" if "trunk_cu" in name else "layer_stack.cu"
        t = re.search(r"blc_fused_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d)E",
                      name)
        inst = (f"<{t.group(1)}, {t.group(2)}, {t.group(3)}, {t.group(4)}> "
                f"({'zero-padded' if t.group(3) == '1' else 'learned'}, "
                f"{act_names[int(t.group(4))]})" if t else name)
        print(f"sass: {src} blc_fused_kernel{inst}: {n} TF32 tensor-core "
              f"MMA instructions")
    layer = {k: n for k, n in counts.items() if "blc_fused_kernel" in k}
    for zero in ("0", "1"):
        for act in act_names:
            got = [n for k, n in layer.items()
                   if re.search(rf"ELb\dELb{zero}ELi{act}E", k)]
            if len(got) < 2 or not all(got):      # both widths
                which = "zero-padded" if zero == "1" else "learned"
                raise AssertionError(f"layer kernels ({which}, "
                                     f"{act_names[act]} instance) without "
                                     f"TF32 MMA: {layer}")
    for kernel in ("slice_pool_kernel", "slice_deslice_kernel"):
        got = {k: n for k, n in slices.items() if k.startswith(kernel)}
        if len(got) < 9 or not all(n and n % 3 == 0 for n in got.values()):
            raise AssertionError(f"{kernel} instances without 3xTF32 MMA: "
                                 f"{got}")


def rel_err(a, b) -> tuple[float, float]:
    d = float((a - b).abs().max())
    return d, d / max(float(b.abs().max()), 1e-30)


def flagship(H, W, device, r_p="learned", act="gelu", loss_type="curl",
             p_pred=False):
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2) if H != W else 1.0)
    params = SimParams(raq=3.0, fkt=1e8, fkp=10.0)
    c_o = (1 if loss_type == "curl" else 2) + p_pred
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=c_o, act_fn=act,
                        r_p=r_p, loss_type=loss_type, repeats=6, f=5,
                        p_pred=p_pred, seed=0, device=device)
    fast = FastNewFluidNet(model, H, W)

    def engine(apply_fn):
        return SimEngine(TimeStepper(grid, params, apply_fn, cn_max=0.99,
                                     device=device))

    T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(6.28 * grid.xc), 0.0, 1.0)
    return model, fast, engine, T0[None]


def check_kernels(H, W):
    """Phase 2: every kernel against its plain version at main-path
    shapes, the layer kernels in both instances (the zero-padded one at
    the shapes of the ``-pad zeros`` flagship), timed side by side.
    Returns the per-kernel records (launches filled later); the zero
    instance's numbers go under ``zero_instance`` in the layer kernels'
    records."""
    rec, eng, psi, T = check_layer_kernels(H, W)
    zero = check_layer_kernels(H, W, "zeros")[0]
    for k in ("layer_stack", "trunk"):
        rec[k]["zero_instance"] = zero[k]
        print(f"{k}: zero-padded instance {zero[k]['queued_ms']:.4f} ms "
              f"device only against the learned instance's "
              f"{rec[k]['queued_ms']:.4f} ms "
              f"({zero[k]['queued_ms'] / rec[k]['queued_ms']:.3f}x), bound "
              f"{zero[k]['bound_ms']:.4f} ms (the model's 3×3 merges at 9 "
              f"taps; the kernel runs them as 5×5, 25/9 of their MACs)")
    # the energy kernels
    rec["curl_advect_epilogue"] = check_epilogue(eng, psi[0], T[0])
    rec["advect_diffuse_step_fused"] = check_advect(eng, T)
    return rec


def check_layer_kernels(H, W, r_p="learned", act="gelu", check=True,
                        built=None):
    """``layer_stack`` and ``trunk`` of the flagship with padding ``r_p``
    and activation ``act`` (the layer kernels' learned-boundary or
    zero-padded instance of it) against their plain versions at the main
    path's shapes, timed. ``check=False`` records the disagreement
    without holding it to the bound (the six-layer ``sine`` stacks, whose
    float32 rounding grows through each ``sin(30·)``: phase 13 holds
    those per layer); every call must still repeat its bits. ``built``:
    the ``flagship`` tuple, when the caller has it. Returns (their
    records, the engine, the plain ψ, T)."""
    import torch
    import torch.nn.functional as F
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (
        layer_stack, layer_stack_plain, layer_stacks, layer_stacks_plain)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (
        trunk, trunk_plain)
    from pbml_mantle_convection_tpu_torch.sim.stepper import viscosity

    _, fast, engine, T0 = built or flagship(H, W, "cuda", r_p, act)
    tag = f"[{r_p}]" if act == "gelu" else f"[{r_p}, {act}]"
    eng = engine(fast)
    T = eng.init_state(T0).T
    st = eng.stepper
    x = st.executor_input(T, viscosity(T, st.static, st.params))

    # the main path's stage inputs, from the plain chain
    n_pyr = len(fast.branches) - 1
    b, pyr = layer_stack_plain(x, fast.stem, pyramid=n_pyr)
    xs = [b, *pyr]
    outs = layer_stacks_plain(xs, fast.branches)
    y1 = trunk_plain(outs[0], outs[1:], x, fast.trunk)
    y2, _ = layer_stack_plain(y1, fast.merge2)
    psi, _ = layer_stack_plain(y2, fast.merge3)

    # the model's own kernel sizes, not the 5×5 the kernel packs
    m = fast.m
    taps = {n: conv_taps(getattr(m, n)) for n in ("conv_1", "conv_2",
                                                  "conv_3")}
    taps["fluid"] = conv_taps(m.conv_0.conv)

    def work(sws, inputs, n_pyr=0, k="fluid"):
        w = [stack_work(sw, i.shape[1], i.shape[2], n_pyr=n_pyr,
                        taps=taps[k])
             for sw, i in zip(sws, inputs)]
        return sum(a for a, _ in w), sum(f for _, f in w)

    def stem(fn):
        y, pools = fn(x, fast.stem, pyramid=n_pyr)
        return [y, *pools]

    # the main path's four layer_stack calls: (name, kernel call, plain
    # call, each returning a list of fields, (bytes, flops))
    calls = [
        ("stem", lambda: stem(layer_stack), lambda: stem(layer_stack_plain),
         work([fast.stem], [x], n_pyr)),
        ("branches", lambda: layer_stacks(xs, fast.branches),
         lambda: layer_stacks_plain(xs, fast.branches),
         work(fast.branches, xs)),
        ("merge2", lambda: [layer_stack(y1, fast.merge2)[0]],
         lambda: [layer_stack_plain(y1, fast.merge2)[0]],
         work([fast.merge2], [y1], k="conv_2")),
        ("merge3", lambda: [layer_stack(y2, fast.merge3)[0]],
         lambda: [layer_stack_plain(y2, fast.merge3)[0]],
         work([fast.merge3], [y2], k="conv_3")),
    ]
    rec = {}
    tot = dict(ms=0.0, queued_ms=0.0, plain_ms=0.0, err=0.0, bytes=0.0,
               flops=0.0)
    for name, kern, plain, (nb, fl) in calls:
        got, ref = kern(), plain()
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, kern()))
        ms = cuda_ms(kern)
        qms = queued_ms(kern)
        pms = cuda_ms(plain, n=5)
        bms, by = bound_ms(nb, fl, tensor_cores=True)
        sms, sby = bound_ms(nb, fl)
        print(f"layer_stack{tag} {name:8s} fields "
              f"{[tuple(t.shape) for t in ref]}"
              f": max_abs_err={err:.3e} rel={rel:.3e} (tol "
              f"{TOL['layer_stack']}) repeatable={same} ms={ms:.4f} "
              f"(device only, launches queued: {qms:.4f}) plain_ms="
              f"{pms:.4f} bound_ms={bms:.4f} ({by}, 3xTF32 tensor cores) "
              f"simt_bound_ms={sms:.4f} ({sby}, float32 SIMT)")
        if not ((rel <= TOL["layer_stack"] or not check) and same):
            raise AssertionError(f"layer_stack{tag} {name} disagrees: "
                                 f"{rel}, repeatable {same}")
        if name == "merge3":
            # c_o columns of the 8 the tensor cores fill (c_o = 1 on the
            # curl head, 2 or 3 on the others): their bound beside it
            c_o = fast.merge3.c_o
            merge3 = dict(c_o=c_o, max_abs_err=err, rel=rel, ms=ms,
                          queued_ms=qms, plain_ms=pms, bound_ms=bms,
                          bound_by=by, padded_bound_ms=bound_ms(
                              nb, fl * 8 / c_o, tensor_cores=True)[0])
        tot["ms"] += ms
        tot["queued_ms"] += qms
        tot["plain_ms"] += pms
        tot["bytes"] += nb
        tot["flops"] += fl
        tot["err"] = max(tot["err"], err)
    bms, by = bound_ms(tot["bytes"], tot["flops"], tensor_cores=True)
    sms, _ = bound_ms(tot["bytes"], tot["flops"])
    print(f"layer_stack{tag} summed over the {len(calls)} calls of a step: "
          f"ms="
          f"{tot['ms']:.4f} (device only {tot['queued_ms']:.4f}) bound_ms="
          f"{bms:.4f} ({by}, 3xTF32) simt_bound_ms={sms:.4f}")
    rec["layer_stack"] = dict(max_abs_err=tot["err"], ms=tot["ms"],
                              plain_ms=tot["plain_ms"], bound_ms=bms,
                              bound_by=by, library_ms=None,
                              queued_ms=tot["queued_ms"],
                              simt_bound_ms=sms, merge3=merge3)

    # trunk
    def trunk_k():
        return trunk(outs[0], outs[1:], x, fast.trunk)
    yk = trunk_k()
    err, rel = rel_err(yk, y1)
    same = bool(torch.equal(yk, trunk_k()))
    ms = cuda_ms(trunk_k)
    qms = queued_ms(trunk_k)
    pms = cuda_ms(lambda: trunk_plain(outs[0], outs[1:], x, fast.trunk), n=5)

    def interp():
        return [F.interpolate(c[None], size=(H, W), mode="bicubic",
                              align_corners=False) for c in outs[1:]]
    lib_ms = cuda_ms(interp)
    from pbml_mantle_convection_tpu_torch.ops.resize import (
        resize_bicubic_nchw)
    e_int = max(rel_err(a[0], resize_bicubic_nchw(c, (H, W)))[1]
                for a, c in zip(interp(), outs[1:]))
    c_h = fast.trunk.merge.c_o
    n_coarse = sum(c.numel() for c in outs[1:])
    nb, fl = stack_work(fast.trunk.merge, H, W, taps=taps["conv_1"])
    nb += 4 * n_coarse - 4 * c_h * len(outs[1:]) * H * W
    fl += 40 * c_h * len(outs[1:]) * H * W
    bms, by = bound_ms(nb, fl, tensor_cores=True)
    sms, sby = bound_ms(nb, fl)
    print(f"trunk{tag} c_in={fast.trunk.merge.c_in} {H}x{W}: max_abs_err="
          f"{err:.3e} rel={rel:.3e} (tol {TOL['trunk']}) repeatable={same} "
          f"ms={ms:.4f} (device only, launches queued: {qms:.4f}) "
          f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}, 3xTF32 tensor "
          f"cores) simt_bound_ms={sms:.4f} ({sby}, float32 SIMT) "
          f"library_ms={lib_ms:.4f} (4x F.interpolate bicubic, the "
          f"upsampling only: not the same function; F.interpolate vs "
          f"resize matrices rel {e_int:.2e})")
    if not ((rel <= TOL["trunk"] or not check) and same):
        raise AssertionError(f"trunk{tag} disagrees: {rel}, repeatable "
                             f"{same}")
    rec["trunk"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms, queued_ms=qms,
                        simt_bound_ms=sms)
    return rec, eng, psi, T


def check_epilogue(eng, psi, T):
    """The epilogue kernel against its plain version at the main path's
    psi and T (``check_kernels``): u, v, T_new and dt, the same bits on a
    second call, constant psi (zero velocity: dt must be dt_diffuse
    exactly), its device kernels per call (``torch.profiler``), a CUDA
    graph replayed on new inputs; times it device-only and back to back,
    beside its byte bound and the launch floor, and the host's µs per
    call."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
        curl_advect_epilogue, curl_advect_epilogue_plain)
    H, W = T.shape
    consts, s, src = eng._epi, eng.stepper.scaler, eng.stepper.heating

    def epi(psi=psi, T=T):
        return curl_advect_epilogue(psi, T, consts, s, src)
    outk = epi()
    outp = curl_advect_epilogue_plain(psi, T, consts, s, src)
    errs = [rel_err(a, b) for a, b in zip(outk, outp)]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    dt_rel = errs[3][1]
    same = all(bool(torch.equal(a, b)) for a, b in zip(outk, epi()))
    flat = epi(torch.full_like(psi, 0.7))
    zero_ok = (float(flat[3]) == consts.dt_diffuse
               and not bool(flat[0].any()) and not bool(flat[1].any()))
    kernels = device_kernels(epi)
    per_call = device_kernel_count(epi)
    g = torch.Generator(device=psi.device).manual_seed(7)
    graph_replay("curl_advect_epilogue", epi, [psi.clone(), T.clone()],
                 lambda k: [psi * (1 + 0.1 * k) + 1e-3 * torch.randn(
                     H, W, generator=g, device=psi.device),
                     torch.clamp(T + 0.01 * torch.randn(
                         H, W, generator=g, device=psi.device), 0, 1)])
    ms = cuda_ms(epi)
    qms = queued_ms(epi)
    hus = host_us(epi)
    pms = cuda_ms(lambda: curl_advect_epilogue_plain(psi, T, consts, s, src),
                  n=5)
    nb = 4 * (2 * H * W + 4 * (H - 2) * (W - 2) + 3 * H * W + 1)
    bms, by = bound_ms(nb, 45 * H * W)
    floor = launch_floor((H * W + ENERGY_BLOCK - 1) // ENERGY_BLOCK,
                         ENERGY_BLOCK)
    print(f"curl_advect_epilogue {H}x{W}: max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {TOL['curl_advect_epilogue']}) dt rel "
          f"{dt_rel:.1e} repeatable={same} zero velocity dt == dt_diffuse: "
          f"{zero_ok}; ms={ms:.4f} (device only, launches queued: "
          f"{qms:.5f}) host_us={hus:.1f} plain_ms={pms:.4f} bound_ms="
          f"{bms:.5f} ({by}) launch floor {floor['plain']:.5f} ms "
          f"(cooperative {floor['cooperative']:.5f}, with one grid sync "
          f"{floor['cooperative_sync']:.5f}); device kernels per call "
          f"{per_call:g}: {dict(kernels)}")
    if not (rel <= TOL["curl_advect_epilogue"] and dt_rel <= 1e-6 and same
            and zero_ok):
        raise AssertionError(f"curl_advect_epilogue disagrees: {rel}, dt "
                             f"{dt_rel}, repeatable {same}, zero velocity "
                             f"{zero_ok}")
    if per_call != DEVICE_KERNELS["curl_advect_epilogue"]:
        raise AssertionError(f"curl_advect_epilogue: {per_call} device "
                             f"kernels per call ({dict(kernels)})")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, queued_ms=qms,
                launch_floor_ms=floor["plain"], host_us=hus,
                device_kernels_per_call=per_call)


def check_advect(eng, T):
    """The energy-step kernel against its plain version at 128×506, B=1:
    float32 with the scalar source (GAIA, ML_PRE) and with the field
    source (Di > 0) under core cooling, and float64. The float32
    scalar-source call also twice for the same bits, at zero velocity (dt
    must be dt_diffuse to the bit), for its device kernels per call and in
    a CUDA graph replayed on new inputs; times it as ``check_epilogue``."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_fused, advect_diffuse_step_plain)
    from pbml_mantle_convection_tpu_torch.physics.advection import (
        grid_metrics)
    dev = T.device
    g = torch.Generator(device=dev).manual_seed(5)
    _, H, W = T.shape
    u, v = (float(eng.stepper.scaler) * torch.randn(
        1, H, W, generator=g, device=dev) for _ in range(2))
    met, src = eng.stepper.metrics, eng.stepper.heating
    field = src + 0.1 * torch.randn(1, H - 2, W - 2, generator=g,
                                    device=dev)
    met64 = grid_metrics(*eng.grid.coords(dev, torch.float64),
                         aspect=eng.grid.aspect)
    tol = TOL["advect_diffuse_step_fused"]
    cases = [("f32 scalar src", (u, v, T, src, met), {}, tol),
             ("f32 field src, core_cool", (u, v, T, field, met),
              dict(core_cool=True), tol),
             ("f64 scalar src", (u.double(), v.double(), T.double(),
                                 src.double(), met64), {}, TOL_ADVECT_F64)]
    err0 = None
    for name, args, kw, tol in cases:
        out, dt = advect_diffuse_step_fused(*args, cn_max=0.99, **kw)
        ref, dt_ref = advect_diffuse_step_plain(*args, cn_max=0.99, **kw)
        err, rel = rel_err(out, ref)
        dt_rel = abs(float(dt) - float(dt_ref)) / float(dt_ref)
        print(f"advect {name} {H}x{W}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {tol}) dt rel {dt_rel:.1e}")
        if not (rel <= tol and dt_rel <= 1e-6):
            raise AssertionError(f"advect {name} disagrees: {rel}, {dt_rel}")
        if err0 is None:
            err0 = err

    def step(u=u, v=v, T=T):
        return advect_diffuse_step_fused(u, v, T, src, met, cn_max=0.99)
    out = step()
    same = all(bool(torch.equal(a, b)) for a, b in zip(out, step()))
    still = step(torch.zeros_like(u), torch.zeros_like(v))
    d2 = met.dx_min * met.dx_min
    zero_ok = bool(still[1] == 0.5 * (d2 * d2) / (d2 + d2))
    kernels = device_kernels(step)
    per_call = device_kernel_count(step)
    graph_replay("advect_diffuse_step_fused f32", step,
                 [u.clone(), v.clone(), T.clone()],
                 lambda k: [u * (1 + 0.1 * k), v.flip(-1),
                            torch.clamp(T + 0.01 * k, 0, 1)])
    ms = cuda_ms(step, n=200)
    pms = cuda_ms(lambda: advect_diffuse_step_plain(u, v, T, src, met,
                                                    cn_max=0.99), n=50)
    dms = queued_ms(step)
    hus = host_us(step)
    # u, v, T and 4 interior metric arrays read, T written, 2 scalars
    nb = 4 * (4 * H * W + 4 * (H - 2) * (W - 2) + 2)
    bms, by = bound_ms(nb, 35 * H * W)
    floor = launch_floor((H * W + ENERGY_BLOCK - 1) // ENERGY_BLOCK,
                         ENERGY_BLOCK)
    print(f"advect_diffuse_step_fused {H}x{W} f32: ms={ms:.4f} "
          f"(device only, launches queued: {dms:.5f}) host_us={hus:.1f} "
          f"plain_ms={pms:.4f} bound_ms={bms:.5f} ({by}) launch floor "
          f"{floor['plain']:.5f} ms; repeatable={same}, zero velocity dt "
          f"== dt_diffuse: {zero_ok}; device kernels per call "
          f"{per_call:g}: {dict(kernels)}; library_ms: none (no "
          f"one PyTorch call computes an upwind step)")
    if not (same and zero_ok):
        raise AssertionError(f"advect: repeatable {same}, zero velocity "
                             f"{zero_ok}")
    if per_call != DEVICE_KERNELS["advect_diffuse_step_fused"]:
        raise AssertionError(f"advect_diffuse_step_fused: {per_call} device "
                             f"kernels per call ({dict(kernels)})")
    return dict(max_abs_err=err0, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, queued_ms=dms,
                launch_floor_ms=floor["plain"], host_us=hus,
                device_kernels_per_call=per_call)


def run_main_path(counters):
    """Phase 3: the flagship rollout through the kernels at both grids,
    timed by ``bench_torch.main()`` (its JSON line; it fails on a
    non-finite T). Every count is set to 0 just before each run and read
    just after it. Returns the launch counts of both runs and the steps/s
    of each grid."""
    import os
    import bench_torch
    launch = {n: 0 for n in counters}
    sps = {}
    saved = {k: os.environ.get(k) for k in ("PMC_BENCH_H", "PMC_BENCH_W")}
    try:
        for H, W in ((128, 506), (256, 256)):
            os.environ["PMC_BENCH_H"], os.environ["PMC_BENCH_W"] = \
                str(H), str(W)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            rec = bench_torch.main([])
            got = {k: fn.launches for k, fn in counters.items()}
            steps = rec["warmup_steps"] + rec["reps"] * rec["steps"]
            want = {k: n * steps
                    for k, n in bench_torch.LAUNCHES_PER_STEP.items()}
            if got != want:
                raise AssertionError(f"{H}x{W}: launches {got}, want {want}")
            print(f"main path {H}x{W}: {rec['value']} steps/s (best of "
                  f"{rec['reps']} x {rec['steps']} steps), launches {got} = "
                  f"4+1+1+0 per step, {time.perf_counter() - t0:.1f} s")
            for k in launch:
                launch[k] += got[k]
            sps[H, W] = rec["value"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launch, sps


def compare_paths(H, W, K=10, r_p="learned"):
    """Phase 3b: K steps of the kernel path vs the plain module path of
    the flagship with padding ``r_p``."""
    model, fast, engine, T0 = flagship(H, W, "cuda", r_p)
    finals = []
    for apply_fn in (fast, model):
        eng = engine(apply_fn)
        finals.append(eng.multi_step(eng.init_state(T0), K)[0])
    sk, sp = finals
    for name in ("T", "u", "v"):
        err, rel = rel_err(getattr(sk, name), getattr(sp, name))
        print(f"{K} steps {H}x{W} [{r_p}] kernel vs plain path: {name} "
              f"max_abs_err={err:.3e} rel={rel:.3e} (tol {TOL_ROLLOUT[name]})")
        if not rel <= TOL_ROLLOUT[name]:
            raise AssertionError(f"kernel path diverges from plain: {name}")


def rollout_launches(B, n):
    """Kernel wrapper launches of ``n`` fused flagship steps of B
    simulations: 4 + 1 + 1 + 0 per step at B = 1 (the epilogue), 4B + B +
    0 + 1 at B > 1 (one batched energy step)."""
    if B > 1:
        return {"layer_stack": 4 * B * n, "trunk": B * n,
                "advect_diffuse_step_fused": n, "curl_advect_epilogue": 0}
    return {"layer_stack": 4 * n, "trunk": n,
            "advect_diffuse_step_fused": 0, "curl_advect_epilogue": n}


def run_zero_path(counters, steps=500, device="cuda"):
    """Phase 3c: the ``-pad zeros`` flagship (the layer kernels' zero
    instance) through ``cli/benchmark.py --what rollout -pad zeros`` at
    128×506 and 256², B = 1 and B = 4 (launches per step asserted; every
    count set to 0 just before each run and read just after), then 10
    steps of its kernel path vs its module path. Returns the launch
    counts of the runs."""
    from pbml_mantle_convection_tpu_torch.cli import benchmark
    launch = {k: 0 for k in counters}
    for H, W in ((128, 506), (256, 256)):
        for b in (1, 4):
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            sps = benchmark.main(["--what", "rollout", "-pad", "zeros",
                                  "--batch", str(b), "--H", str(H),
                                  "--W", str(W), "--steps", str(steps),
                                  "--device", device])
            got = {k: fn.launches for k, fn in counters.items()}
            n = steps + min(steps, 20)                 # timed + warm-up
            want = rollout_launches(b, n)
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"-pad zeros {H}x{W} B={b}: launches "
                                     f"{got}, want {want}")
            print(f"-pad zeros rollout {H}x{W} B={b}: {sps:.2f} steps/s, "
                  f"{b * sps:.2f} sim-steps/s, launches "
                  f"{ {k: got[k] / n for k in want} } per step, "
                  f"{time.perf_counter() - t0:.1f} s")
            for k in launch:
                launch[k] += got[k]
    compare_paths(128, 506, r_p="zeros")
    return launch


def mode_engines(H, W, device="cuda"):
    """The engine modes of phase 4 on the flagship's grid, float32:
    name → (engine, plain module or None, steps timed, steps compared)."""
    from pbml_mantle_convection_tpu_torch.physics.stokes import (
        make_stokes_fn)
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    model, fast, engine, T0 = flagship(H, W, device)
    base = engine(fast)
    grid, params = base.grid, base.params

    def stepper(apply_fn, **kw):
        return TimeStepper(grid, params, apply_fn, cn_max=0.99,
                           device=device, **kw)

    def gaia():
        return make_stokes_fn(grid, params.raq)     # n_iter 2000, ptol 1e-5

    return T0, {
        "GAIA": (SimEngine(stepper(None), mode="GAIA", stokes_fn=gaia()),
                 None, 3, 2),
        "GAIA-skip3": (SimEngine(stepper(None), mode="GAIA", intervene_ts=3,
                                 stokes_fn=gaia()), None, 6, 4),
        "ML_PRE": (SimEngine(stepper(fast), mode="ML_PRE",
                             stokes_fn=make_stokes_fn(grid, params.raq,
                                                      pre_iter=200)),
                   model, 10, 3),
        "ML_STOKES-core_cool-Di0.5-decay": (
            SimEngine(stepper(fast), core_cool=True, Di=0.5,
                      radioactive_decay=True), model, 50, 10),
    }


def plain_step(eng, state, n_step, model):
    """One step of ``eng``'s mode composed from the plain functions: the
    NewFluidNet module for the surrogate, the plain energy step; the PT
    solve and the sources are torch ops in both."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_plain)
    from pbml_mantle_convection_tpu_torch.ops.stencils import (
        stamp_temperature_bc)
    from pbml_mantle_convection_tpu_torch.physics.advection import (
        viscous_dissipation)
    from pbml_mantle_convection_tpu_torch.physics.viscosity import (
        fk_viscosity)
    from pbml_mantle_convection_tpu_torch.sim.engine import (
        CORE_RHOCP_VAR, decay_heating)
    from pbml_mantle_convection_tpu_torch.sim.stepper import (
        assemble_fluidnet_input)
    st, prm, T = eng.stepper, eng.params, state.T
    if eng.mode == "GAIA":
        V = fk_viscosity(prm.fkt, prm.fkp, st.static.depth, T)
        if n_step % eng.intervene_ts == 0:
            u, v, p = eng.stokes_fn(T, V)
        else:
            u, v, p = state.u, state.v, state.p
    else:
        x, V = assemble_fluidnet_input(T, st.static, prm)
        u, v, p = model(x)
        u, v = u * st.scaler, v * st.scaler
        if p is None:
            p = state.p
        if eng.mode == "ML_PRE":
            u, v, p = eng.stokes_fn(T, V, (u, v, p))
    src = decay_heating(prm.raq, state.t, eng.radioactive_decay)
    if eng.Di > 0:
        src = (src - eng.Di * v[..., 1:-1, 1:-1] * T[..., 1:-1, 1:-1]
               + eng.Di * viscous_dissipation(u, v, V, st.metrics))
    T_new, dt = advect_diffuse_step_plain(u, v, T, src, st.metrics,
                                          cn_max=st.cn_max,
                                          core_cool=eng.core_cool)
    T_core = state.T_core
    if eng.core_cool:
        q_cmb = torch.mean((state.T_core - T_new[..., 1, :])
                           / (0.5 * eng.grid.dy))
        T_core = T_core - dt * CORE_RHOCP_VAR * q_cmb
        T_new[..., 0, :] = T_core
    T_new = torch.clamp(stamp_temperature_bc(T_new, core_cool=eng.core_cool),
                        0.0, 2.0)
    return state._replace(T=T_new, u=u, v=v, p=p, V=V, t=state.t + dt,
                          dt=dt, n_step=state.n_step + 1, T_core=T_core)


def check_bc_rows(name, state, core_cool):
    import torch
    T = state.T
    if not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{name}: T is not finite")
    bottom = state.T_core if core_cool else torch.ones((), device=T.device)
    ok = (bool((T[:, -1] == 0).all())
          and bool((T[:, 0] == torch.clamp(bottom, 0, 2)).all())
          and bool((T[..., 0] == T[..., 1]).all())
          and bool((T[..., -1] == T[..., -2]).all()))
    if not ok:
        raise AssertionError(f"{name}: boundary rows are wrong")


def run_modes(counters, H=128, W=506):
    """Phase 4: each engine mode through its kernels, launch counts per
    step asserted, then a few steps against the plain reference. Returns
    the launch counts of the timed runs."""
    import torch
    launch = {n: 0 for n in counters}
    T0, modes = mode_engines(H, W)
    for name, (eng, model, n, K) in modes.items():
        state = eng.multi_step(eng.init_state(T0), 1)[0]      # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, trace = eng.multi_step(state, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        got = {k: fn.launches for k, fn in counters.items()}
        net = eng.mode != "GAIA"
        want = {"layer_stack": 4 * n * net, "trunk": n * net,
                "curl_advect_epilogue": 0, "advect_diffuse_step_fused": n}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, want {want}")
        check_bc_rows(name, state, eng.core_cool)
        pt = ("" if eng.stokes_fn is None else
              f", PT iterations of the last solve "
              f"{eng.stokes_fn.n_done.tolist()}")
        print(f"mode {name} {H}x{W} f32: {ms:.3f} ms/step ({n} steps), "
              f"launches {got} per run{pt}, mean T "
              f"{float(trace.mean_T[-1]):.6f}, T_core "
              f"{float(state.T_core):.6f}")
        for k in launch:
            launch[k] += got[k]

        # each of K steps from the same state, the kernel path's: the EBA
        # dissipation source (Di·Φ·dt ~ 1e5 with these velocities) turns
        # the surrogates' 1e-6 velocity differences into 1e-4 in T per
        # step, which a free-running comparison would compound
        sk = eng.init_state(T0)
        worst = {f: (0.0, 0.0) for f in ("T", "u", "v")}
        with torch.no_grad():
            for i in range(K):
                sp = plain_step(eng, sk, i, model)
                sk = eng.step(sk)
                check_bc_rows(name + " plain", sp, eng.core_cool)
                for f in worst:
                    worst[f] = max(worst[f],
                                   rel_err(getattr(sk, f), getattr(sp, f)),
                                   key=lambda e: e[1])
        for f, (err, rel) in worst.items():
            print(f"  {K} steps, each kernel vs plain: {f} max_abs_err="
                  f"{err:.3e} rel={rel:.3e} (tol {TOL_ROLLOUT[f]})")
            if not rel <= TOL_ROLLOUT[f]:
                raise AssertionError(f"{name}: kernel step disagrees with "
                                     f"plain: {f}")
    return launch


def slice_inputs(BH, N, D, G, dtype, seed, device="cuda"):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device,
                                   dtype=dtype)

    temp = 0.3 + 0.4 * torch.rand(BH, generator=g, device=device,
                                  dtype=dtype)
    return (rand(BH, N, D), rand(BH, N, D), rand(D, G, scale=0.3),
            rand(G, scale=0.1), temp, rand(BH, G, D))


def heads_view(x):
    """(BH, N, D) values as the (1, BH, N, D) view of (1, N, BH·D) rows:
    the layout in which the Transolver's projections hand x_mid and fx to
    the slice kernels (heads of D adjacent values, BH·D apart)."""
    BH, N, D = x.shape
    rows = x.new_empty(1, N, BH * D)
    view = rows.view(1, N, BH, D).permute(0, 2, 1, 3)
    view.copy_(x.reshape(1, BH, N, D))
    return view


def slice_calls(args, layout):
    """The two kernels' calls on ``args`` (dense, from ``slice_inputs``)
    in ``layout``: "dense", or "heads" (x_mid and fx as ``heads_view``s,
    temp per head of B = 1, the deslice writing (1, N, BH·D) rows)."""
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice, slice_pool)
    fx, xm, ws, bs, temp, tok = args
    if layout == "heads":
        fx, xm, tok = heads_view(fx), heads_view(xm), tok[None]
    return (lambda: slice_pool(fx, xm, ws, bs, temp),
            lambda: slice_deslice(xm, tok, ws, bs, temp))


def slice_errors(args, layout="dense"):
    """(max_abs_err, rel) of both kernels against their plain versions on
    the same inputs, the plain versions run in float64 (a float32 plain
    product sums 64,768 terms in its own order and is no closer to the
    exact sums than the kernel: both errors are printed), and whether a
    second call of each gives the same bits. 16-bit inputs: the plain
    versions in float32 of the same values."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice_plain, slice_pool_plain)
    fx, xm, ws, bs, temp, tok = args
    ref_type = (torch.float32 if fx.dtype in (torch.bfloat16, torch.float16)
                else torch.float64)
    wide = [a.to(ref_type) for a in args]
    pool, deslice = slice_calls(args, layout)
    num, den = pool()
    ref = slice_pool_plain(*wide[:5])
    perr = max(rel_err(num.reshape(ref[0].shape).to(ref_type), ref[0]),
               rel_err(den.reshape(ref[1].shape).to(ref_type), ref[1]),
               key=lambda e: e[1])
    pool_plain = max((rel_err(a.to(ref_type), b)[1] for a, b in
                      zip(slice_pool_plain(fx, xm, ws, bs, temp), ref)))
    out = deslice()
    ref = slice_deslice_plain(wide[1], wide[5], *wide[2:5])
    derr = rel_err(out.reshape(ref.shape).to(ref_type), ref)
    num2, den2 = pool()
    same = (torch.equal(num, num2) and torch.equal(den, den2)
            and torch.equal(out, deslice()))
    if layout == "heads" and out.transpose(1, 2).reshape(
            1, out.shape[2], -1).data_ptr() != out.data_ptr():
        raise AssertionError("slice_deslice: the heads result is not a "
                             "view of (1, N, BH·D) rows")
    return perr, derr, same, pool_plain


def deslice_library(args, layout):
    """The deslice as one PyTorch call: N queries x_mid over G keys
    k = wsᵀ / temp, an additive mask bs / temp and values tok, at scale 1,
    is ``scaled_dot_product_attention``: softmax_g((x·ws + bs) / temp)·tok
    per head. k and the mask are made here, outside the timed call;
    returns the call (the library's time of the same function, used
    nowhere in the port)."""
    import torch.nn.functional as F
    fx, xm, ws, bs, temp, tok = args
    if layout == "heads":
        xm, tok = heads_view(xm), tok[None]
    else:
        xm, tok = xm[None], tok[None]
    BH, N = xm.shape[1:3]
    k = (ws.t()[None] / temp[:, None, None])[None]
    mask = (bs[None] / temp[:, None])[None, :, None].expand(1, BH, N, -1)
    return lambda: F.scaled_dot_product_attention(xm, k, tok,
                                                  attn_mask=mask, scale=1.0)


def slice_work(BH, N, D, G, itemsize=4):
    """(bytes, flops) of one slice_pool or slice_deslice call: two
    (BH, N, D) arrays read or written once (weights and the small outputs
    aside); the logits' and the sums' multiply-adds, 2 flops each (the
    softmax's exps not counted)."""
    return 2 * BH * N * D * itemsize, 4 * BH * N * G * D


# check_slice: (D, G, dtype, layout). float32 at the serving shape in the
# main path's layout (its numbers go into the kernels line) and dense (as
# the records before the layout change), the JAX docstring's (32, 64) both
# ways, the widest the tensor-core kernels take; bfloat16 at the serving
# shape, held against the float32 plain version of its values
SLICE_CASES = ((16, 32, "float32", "heads"), (16, 32, "float32", "dense"),
               (32, 64, "float32", "heads"), (32, 64, "float32", "dense"),
               (64, 128, "float32", "dense"), (128, 128, "float32", "dense"),
               (16, 32, "bfloat16", "heads"))
# ragged N, float64 (SIMT), and D or G past 128 (SIMT) in the heads layout
SLICE_EDGE_CASES = ((8, 128 * 506 - 77, 16, 32, "float32", "dense"),
                    (8, 4133, 32, 64, "float64", "heads"),
                    (3, 1001, 64, 64, "float64", "dense"),
                    (2, 700, 128, 128, "float64", "dense"),
                    (2, 1999, 256, 160, "float32", "heads"),
                    (2, 1999, 160, 256, "bfloat16", "heads"))


def check_slice(heads=8, N=128 * 506, device="cuda", cases=SLICE_CASES,
                edge_cases=SLICE_EDGE_CASES, seeds=(1, 2, 3, 4, 5)):
    """Phase 5a: both slice kernels against their plain versions at
    ``cases``, at D = G = 128 on ``seeds``, then at ``edge_cases``; times
    each case of ``cases`` beside its bounds (bytes and 3xTF32 operations:
    both kernels run on the tensor cores there) and, for the deslice, the
    library call of the same function (``deslice_library``). Returns the
    serving shape's float32 records in the main path's layout."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice_plain, slice_pool_plain)
    rec = {}
    for D, G, name_t, layout in cases:
        dtype = getattr(torch, name_t)
        args = slice_inputs(heads, N, D, G, dtype, D, device)
        fx, xm, ws, bs, temp, tok = args
        (pe, pr), (de, dr), same, ppr = slice_errors(args, layout)
        pool, deslice = slice_calls(args, layout)
        calls = {
            "slice_pool": (pool,
                           lambda: slice_pool_plain(fx, xm, ws, bs, temp),
                           pe, pr),
            "slice_deslice": (
                deslice,
                lambda: slice_deslice_plain(xm, tok, ws, bs, temp), de, dr)}
        nb, fl = slice_work(heads, N, D, G, fx.element_size())
        tol = TOL_SLICE_16 if fx.element_size() == 2 else TOL["slice_pool"]
        wide = D * G > 2048
        library = deslice_library(args, layout)
        lib = {"slice_pool": None,
               "slice_deslice": cuda_ms(library, n=10 if wide else 50)}
        lib_rel = rel_err(library().reshape(xm.shape).double(),
                          slice_deslice_plain(
                              *[a.double() for a in (xm, tok, ws, bs,
                                                     temp)]))[1]
        print(f"library for slice_deslice D={D} G={G} {name_t} {layout}: "
              f"F.scaled_dot_product_attention {lib['slice_deslice']:.4f} "
              f"ms ({queued_ms(library, n=20 if wide else 200):.4f} device "
              f"only), rel {lib_rel:.3e} vs the float64 plain version")
        for name, (fn, plain, err, rel) in calls.items():
            ms = cuda_ms(fn, n=10 if wide else 50)
            qms = queued_ms(fn, n=20 if wide else 200)
            pms = cuda_ms(plain, n=3 if wide else 10)
            tb, _ = bound_ms(nb, 0.0)
            to = bound_ms(0.0, fl, tensor_cores=True)[0]
            bms, by = bound_ms(nb, fl, tensor_cores=True)
            note = (f"; plain in {name_t} vs float64 rel {ppr:.3e}"
                    if name == "slice_pool" else "")
            lms = (f"library_ms={lib[name]:.4f} (scaled_dot_product_"
                   f"attention)" if lib[name] is not None else
                   "library_ms: none (no one PyTorch call computes it)")
            print(f"{name} BH={heads} N={N} D={D} G={G} {name_t} {layout}: "
                  f"max_abs_err={err:.3e} rel={rel:.3e} (tol {tol}{note}) "
                  f"ms={ms:.4f} (device only, launches queued: {qms:.4f}) "
                  f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}; bytes "
                  f"{tb:.4f}, operations {to:.4f} at the 3xTF32 tensor-core "
                  f"rate); {lms}")
            if not rel <= tol:
                raise AssertionError(f"{name} D={D} G={G} {name_t} {layout} "
                                     f"disagrees: {rel}")
            if (D, G, name_t, layout) == (16, 32, "float32", "heads"):
                rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound_ms=bms, bound_by=by,
                                 library_ms=lib[name],
                                 queued_ms=qms, bytes_bound_ms=tb,
                                 ops_bound_ms=to)
        if (D, G, name_t, layout) == (16, 32, "float32", "dense"):
            y = torch.empty_like(xm)
            print(f"yardstick: a torch copy of one (BH, N, D) {name_t} array "
                  f"(the deslice's bytes, read and written): "
                  f"{queued_ms(lambda: y.copy_(xm)):.4f} ms device only")
        if not same:
            raise AssertionError(f"slice kernels {name_t} {layout}: two calls "
                                 f"differ")
    # the widest tensor-core shape, where the float32 error is largest, on
    # more seeds than the one above
    for seed in seeds:
        (pe, pr), (de, dr), same, _ = slice_errors(
            slice_inputs(heads, N, 128, 128, torch.float32, seed, device))
        print(f"slice kernels D=G=128 float32 seed {seed}: pool rel="
              f"{pr:.3e}, deslice rel={dr:.3e} (tol {TOL['slice_pool']})")
        if not (pr <= TOL["slice_pool"] and dr <= TOL["slice_pool"]
                and same):
            raise AssertionError(f"slice kernels disagree at D=G=128, "
                                 f"seed {seed}")
    for BH, n, D, G, name_t, layout in edge_cases:
        dtype = getattr(torch, name_t)
        tol = {torch.float64: TOL_SLICE_F64,
               torch.bfloat16: TOL_SLICE_16}.get(dtype, TOL["slice_pool"])
        (pe, pr), (de, dr), same, _ = slice_errors(
            slice_inputs(BH, n, D, G, dtype, n, device), layout)
        route = ("tensor cores" if dtype != torch.float64
                 and max(D, G) <= 128 else "SIMT")
        print(f"slice kernels BH={BH} N={n} D={D} G={G} {name_t} {layout} "
              f"({route}): pool rel={pr:.3e}, deslice rel={dr:.3e} (tol "
              f"{tol}), repeatable={same}")
        if not (pr <= tol and dr <= tol and same):
            raise AssertionError(f"slice kernels disagree at N={n}, D={D}, "
                                 f"G={G}, {name_t}")
    return rec


def check_dense_attention(B=1, heads=12, N=4049, device="cuda", seed=0):
    """Phase 5b: the ViT's dense attention kernel at ViT-Base's shape over
    the 128×506 field (12 heads of 64, 4,049 tokens), reading q, k and v
    as the strided views of one qkv tensor, against float64 (≤
    ``TOL["dense_attention"]``, the same bits twice, one launch a call);
    timed (ms a block) beside its bound (3xTF32 operations), the plain
    einsum + softmax path, and ``F.scaled_dot_product_attention`` in
    float32, a yardstick the port never calls. Returns the record."""
    import torch
    import torch.nn.functional as F
    from pbml_mantle_convection_tpu_torch.ops.dense_attention import (
        dense_attention)

    def plain(q, k, v, scale):
        """``models/vit.py::Attention.forward`` off the kernel's route."""
        attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale,
                             dim=-1)
        return torch.einsum("bhnm,bhmd->bhnd", attn, v)

    D, scale = 64, 0.125
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(B, N, 3 * heads * D, generator=g, device=device)
    q, k, v = (t.reshape(B, N, heads, D).transpose(1, 2)
               for t in x.chunk(3, dim=-1))
    n0 = dense_attention.launches
    out = dense_attention(q, k, v, scale)
    again = dense_attention(q, k, v, scale)
    torch.cuda.synchronize()
    if dense_attention.launches != n0 + 2:
        raise AssertionError("dense_attention: not one launch a call")
    want = plain(q.double(), k.double(), v.double(), scale)
    err, rel = rel_err(out.double(), want)
    plain_rel = rel_err(plain(q, k, v, scale).double(), want)[1]

    def library():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    lib_rel = rel_err(library().double(), want)[1]
    ms = cuda_ms(lambda: dense_attention(q, k, v, scale), n=20)
    qms = queued_ms(lambda: dense_attention(q, k, v, scale), n=50)
    pms = cuda_ms(lambda: plain(q, k, v, scale), n=5)
    lms = cuda_ms(library, n=20)
    flops = 2 * 2 * B * heads * N * N * D
    nbytes = 4 * B * N * heads * D * 4
    bms, by = bound_ms(nbytes, flops, tensor_cores=True)
    print(f"dense_attention B={B} H={heads} N={N} D={D} float32 qkv views: "
          f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{TOL['dense_attention']}; plain float32 rel {plain_rel:.3e}, "
          f"library rel {lib_rel:.3e}) ms={ms:.4f} (device only, launches "
          f"queued: {qms:.4f}) plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}: "
          f"{flops / 1e9:.2f} GFLOP at the 3xTF32 rate; bytes "
          f"{bound_ms(nbytes, 0.0)[0]:.4f}) library_ms={lms:.4f} "
          f"(scaled_dot_product_attention, float32; never called by the "
          f"port); {flops / qms / 1e9:.1f} TFLOP/s")
    if not (rel <= TOL["dense_attention"] and torch.equal(out, again)):
        raise AssertionError(f"dense_attention disagrees: rel {rel}, "
                             f"repeatable {torch.equal(out, again)}")
    return dict(max_abs_err=err, rel=rel, ms=ms, queued_ms=qms, plain_ms=pms,
                bound_ms=bms, bound_by=by, library_ms=lms)


def run_vit(iters=5, H=128, W=506, device="cuda"):
    """Phase 5c: ViT-Base of the ``vit-serve-b1`` cell (12 blocks of 768,
    12 heads of 64, MLP 3,072, 8×2 patches: 4,049 tokens) through
    ``ViTField`` at B = 1 without grad, the main path of the ViT's
    serving: ``dense_attention.launches`` counted from zero over ``iters``
    forwards after a warm-up, 12 a forward. Returns the launches."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.vit import ViTField
    from pbml_mantle_convection_tpu_torch.ops.dense_attention import (
        dense_attention)
    field = ViTField((H, W), (8, 2), dim=768, depth=12, heads=12,
                     mlp_dim=3072, device=device)
    x = torch.rand(1, H, W, 7, device=device,
                   generator=torch.Generator(device).manual_seed(0))
    with torch.no_grad():
        field(x)
        torch.cuda.synchronize()
        dense_attention.launches = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            u, v, _ = field(x)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    got = dense_attention.launches
    if got != 12 * iters or not (torch.isfinite(u).all()
                                 and torch.isfinite(v).all()):
        raise AssertionError(f"vit: {got} dense_attention launches over "
                             f"{iters} forwards, want {12 * iters}; finite "
                             f"u, v: {bool(torch.isfinite(u).all())}, "
                             f"{bool(torch.isfinite(v).all())}")
    print(f"vit-base {H}x{W} B=1 serving forward (ViTField, no grad): "
          f"{ms:.3f} ms per forward, dense_attention launches {got} = 12 "
          f"per forward ({iters} forwards)")
    return got


def check_projection_conv(B=1, H=128, W=506, C=128, device="cuda", seed=0):
    """Phase 5e: the Transolver's projection conv kernel at the
    ``transolver-serve-b1`` cell's shape (both 3×3 projections of a block,
    128 → 2 × 128 over 128×506), reading the (B, C, H, W) channels-last
    view of (B, H·W, C) rows, against ``F.conv2d`` in float64 (no worse
    than twice plain float32's error, the same bits twice, one launch a
    call); timed (ms a block) beside its bound (3xTF32 operations; the
    TF32 rate's beside it), its plain version (the kernel's nine shifted
    (pixels × C) · (C × 2 C_out) products in plain PyTorch) and cuDNN's
    ``F.conv2d`` pair in float32 with its layout copies (``library_ms``:
    the port's path off the kernel's route, never taken on it). Returns
    the record."""
    import torch
    import torch.nn.functional as F
    from pbml_mantle_convection_tpu_torch.ops.projection_conv import (
        pack_weights, projection_conv)

    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(B, H * W, C, generator=g, device=device)
    img = x.reshape(B, H, W, C).permute(0, 3, 1, 2)
    bound = (9 * C) ** -0.5
    ws = [((torch.rand(C, C, 3, 3, generator=g, device=device) * 2 - 1)
           * bound).contiguous(memory_format=torch.channels_last)
          for _ in range(2)]
    bs = [(torch.rand(C, generator=g, device=device) * 2 - 1) * bound
          for _ in range(2)]
    packed = pack_weights(*ws)
    wcat = torch.cat(ws).permute(2, 3, 1, 0).reshape(9, C, 2 * C)
    bcat = torch.cat(bs)

    def plain():
        """The kernel's implicit GEMM in plain PyTorch: the padded image's
        nine shifted views times each tap's (C × 2 C_out) weights."""
        pad = F.pad(x.reshape(B, H, W, C), (0, 0, 1, 1, 1, 1))
        out = bcat.expand(B, H, W, 2 * C).clone()
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            out += pad[:, ky:ky + H, kx:kx + W] @ wcat[tap]
        return out

    def library():
        return [F.conv2d(img, w, b, padding="same") for w, b in zip(ws, bs)]

    def kernel():
        return projection_conv(img, packed, C, *bs)

    with torch.no_grad():
        n0 = projection_conv.launches
        out, again = kernel(), kernel()
        torch.cuda.synchronize()
        if projection_conv.launches != n0 + 2:
            raise AssertionError("projection_conv: not one launch a call")
        want = [F.conv2d(img.double(), w.double(), b.double(),
                         padding="same") for w, b in zip(ws, bs)]
        err = max(rel_err(a.double(), b)[1] for a, b in zip(out, want))
        lib_rel = max(rel_err(a.double(), b)[1]
                      for a, b in zip(library(), want))
        p = plain()
        plain_rel = max(rel_err(p[..., i * C:(i + 1) * C].permute(
            0, 3, 1, 2).double(), b)[1] for i, b in enumerate(want))
        ms = cuda_ms(kernel, n=50)
        qms = queued_ms(kernel, n=200)
        pms = cuda_ms(plain, n=10)
        lms = cuda_ms(library, n=20)
    flops = 2 * 2 * B * H * W * C * C * 9
    nbytes = 4 * (B * H * W * C * 3 + 2 * 9 * C * C + 2 * C)
    bms, by = bound_ms(nbytes, flops, tensor_cores=True)
    tf32_ms = flops / 495e12 * 1e3
    print(f"projection_conv B={B} {H}x{W} {C}->2x{C} 3x3 float32 "
          f"channels-last: rel={err:.3e} (tol twice plain float32's: "
          f"library rel {lib_rel:.3e}, plain rel {plain_rel:.3e}) "
          f"ms={ms:.4f} (device only, launches queued: {qms:.4f}) "
          f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}: "
          f"{flops / 1e9:.2f} GFLOP at the 3xTF32 rate; {tf32_ms:.4f} at "
          f"the TF32 rate; bytes {bound_ms(nbytes, 0.0)[0]:.4f}) "
          f"library_ms={lms:.4f} (two F.conv2d with cuDNN's layout "
          f"copies, float32; the port's path off the kernel's route); "
          f"{flops / qms / 1e9:.1f} TFLOP/s")
    if not (err <= 2 * lib_rel and all(torch.equal(a, b)
                                       for a, b in zip(out, again))):
        raise AssertionError(f"projection_conv disagrees: rel {err} "
                             f"(plain float32 {lib_rel})")
    return dict(rel=err, library_rel=lib_rel, ms=ms, queued_ms=qms,
                plain_ms=pms, bound_ms=bms, bound_by=by, tf32_bound_ms=tf32_ms,
                library_ms=lms)


def run_projection_cell(iters=10, device="cuda"):
    """Phase 5f: the ``transolver-serve-b1`` cell's Transolver (8 blocks,
    n_hidden 128, 64 slices, 128×506) at B = 1 without grad, the main path
    of the Transolver's serving: ``projection_conv.launches`` counted from
    zero over ``iters`` forwards after a warm-up, 8 a forward. Returns the
    launches."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    from pbml_mantle_convection_tpu_torch.ops.projection_conv import (
        projection_conv)
    from pathlib import Path
    cfg = json.loads((Path(__file__).resolve().parent / "benchmarks"
                      / "configs" / "transolver-structured.json").read_text())
    model = build_model(ModelConfig(**cfg["model"], **cfg["grid"]),
                        device=device)
    H, W = cfg["grid"]["H"], cfg["grid"]["W"]
    x = transolver_input(H, W, device)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        projection_conv.launches = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            u, v, _ = model(x)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    got = projection_conv.launches
    want = model.n_layers * iters
    if got != want or not (torch.isfinite(u).all()
                           and torch.isfinite(v).all()):
        raise AssertionError(f"transolver cell: {got} projection_conv "
                             f"launches over {iters} forwards, want {want}")
    print(f"transolver-structured {H}x{W} B=1 serving forward (8 blocks, "
          f"no grad): {ms:.3f} ms per forward, projection_conv launches "
          f"{got} = {model.n_layers} per forward ({iters} forwards)")
    return got


# the Dense layers of the two ViT cells (B = 1): (what, rows, d_in, d_out,
# bias, GELU, launches per forward); SAM's window blocks run qkv and the
# output projection on 7,448 padded slots
DENSE_SHAPES = [("ViT qkv", 4049, 768, 2304, False, False, 12),
                ("ViT output", 4049, 768, 768, True, False, 12),
                ("ViT / SAM MLP1", 4049, 768, 3072, True, True, 24),
                ("ViT / SAM MLP2", 4049, 3072, 768, True, False, 24),
                ("SAM window qkv", 7448, 768, 2304, True, False, 8),
                ("SAM window output", 7448, 768, 768, True, False, 8),
                ("SAM global qkv", 4048, 768, 2304, True, False, 4),
                ("SAM global output", 4048, 768, 768, True, False, 4)]


def check_dense_gemm(device="cuda", seed=0):
    """Phase 5g: the ViT family's Dense GEMM kernel at each Dense shape of
    the ``vit-serve-b1`` and ``samvit-serve-b1`` cells, against
    ``F.linear`` (and GELU) in float64 (no worse than 1.5× float32
    ``F.linear``'s error, the same bits twice, one launch a call); timed
    (ms a call, device only) beside its bound (3xTF32 operations; the
    TF32 rate's beside it), its plain version (``dense_gemm_plain``: the
    kernel's split and per-stage sums in plain PyTorch) and float32
    ``F.linear`` with ``F.gelu`` after it where asked (cuBLAS, the
    ``library_ms``, a yardstick the kernel's route never calls). Returns
    the record of the largest shape (SAM's window qkv, 26.4 GFLOP) with
    every shape's beside it under ``shapes``."""
    import torch
    import torch.nn.functional as F
    from pbml_mantle_convection_tpu_torch.ops.dense_gemm import (
        dense_gemm, dense_gemm_plain, pack_weight)

    rows_out, vit = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                             bound_ms=0.0)
    largest, flops_max = None, 0.0
    for what, M, K, N, has_b, gelu, per_fwd in DENSE_SHAPES:
        g = torch.Generator(device).manual_seed(seed + M + N)
        x = torch.randn(M, K, generator=g, device=device)
        w = (torch.rand(N, K, generator=g, device=device) * 2 - 1) * K ** -0.5
        b = ((torch.rand(N, generator=g, device=device) * 2 - 1) * K ** -0.5
             if has_b else None)
        packed = pack_weight(w)

        def kernel():
            return dense_gemm(x, packed, b, gelu)

        def library():
            y = F.linear(x, w, b)
            return F.gelu(y) if gelu else y

        with torch.no_grad():
            n0 = dense_gemm.launches
            out, again = kernel(), kernel()
            torch.cuda.synchronize()
            if dense_gemm.launches != n0 + 2:
                raise AssertionError("dense_gemm: not one launch a call")
            want = F.linear(x.double(), w.double(),
                            None if b is None else b.double())
            if gelu:
                want = F.gelu(want)
            err = rel_err(out.double(), want)[1]
            lib_rel = rel_err(library().double(), want)[1]
            plain_rel = rel_err(dense_gemm_plain(x, w, b, gelu).double(),
                                want)[1]
            ms = queued_ms(kernel, n=100)
            pms = cuda_ms(lambda: dense_gemm_plain(x, w, b, gelu), n=3)
            lms = queued_ms(library, n=50)
        flops = 2.0 * M * K * N
        nbytes = 4.0 * (M * K + N * K + M * N + (N if has_b else 0))
        bms, by = bound_ms(nbytes, flops, tensor_cores=True)
        print(f"dense_gemm {what} {M}x{K}->{N} bias {has_b} gelu {gelu}: "
              f"rel={err:.3e} (tol 1.5x "
              f"library rel {lib_rel:.3e}; plain rel {plain_rel:.3e}) "
              f"ms={ms:.4f} (device only) plain_ms={pms:.4f} "
              f"bound_ms={bms:.4f} ({by}: {flops / 1e9:.2f} GFLOP at the "
              f"3xTF32 rate; {flops / 495e12 * 1e3:.4f} at the TF32 rate; "
              f"bytes {bound_ms(nbytes, 0.0)[0]:.4f}) library_ms={lms:.4f} "
              f"(F.linear{' + F.gelu' if gelu else ''}, cuBLAS float32; "
              f"never called on the kernel's route); "
              f"{flops / ms / 1e9:.1f} TFLOP/s; {per_fwd} per forward")
        if not (err <= 1.5 * lib_rel and torch.equal(out, again)):
            raise AssertionError(f"dense_gemm {what} disagrees: rel {err} "
                                 f"(float32 F.linear {lib_rel})")
        rows_out.append(dict(what=what, shape=[M, K, N], bias=has_b,
                             gelu=gelu, rel=err, library_rel=lib_rel,
                             ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                             library_ms=lms))
        if flops > flops_max:
            largest, flops_max = rows_out[-1], flops
        if M == 4049:
            blocks = 12
            vit["ms"] += blocks * ms
            vit["plain_ms"] += blocks * pms
            vit["library_ms"] += blocks * lms
            vit["bound_ms"] += blocks * bms
    print(f"dense_gemm at a ViT-Base forward's 48 shapes, each timed "
          f"alone, summed: {vit['ms']:.3f} ms device only, bound "
          f"{vit['bound_ms']:.3f}, plain {vit['plain_ms']:.3f}, library "
          f"{vit['library_ms']:.3f}")
    return dict(largest, shapes=rows_out)


def run_dense_gemm_models(iters=5, device="cuda"):
    """Phase 5h: one ViT-Base (``vit-serve-b1``) and one SAM ViT-B
    (``samvit-serve-b1``) forward at B = 1 without grad, the main path of
    both cells: ``dense_gemm.launches`` counted from zero over ``iters``
    forwards of each after a warm-up, 48 a forward (qkv, output and the
    two MLP layers of 12 blocks; the ViT's embedding and 1-row head and
    SAM's 32-wide head stay on ``F.linear``). Returns the launches."""
    import torch
    from pathlib import Path
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    from pbml_mantle_convection_tpu_torch.ops.dense_gemm import dense_gemm
    total = 0
    for config in ("vit-base.json", "sam-vit-b.json"):
        cfg = json.loads((Path(__file__).resolve().parent / "benchmarks"
                          / "configs" / config).read_text())
        model = build_model(ModelConfig(**cfg["model"], **cfg["grid"]),
                            device=device)
        H, W = cfg["grid"]["H"], cfg["grid"]["W"]
        x = torch.rand(1, H, W, 7, device=device,
                       generator=torch.Generator(device).manual_seed(0))
        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            dense_gemm.launches = 0
            t0 = time.perf_counter()
            for _ in range(iters):
                u, v, _ = model(x)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        got = dense_gemm.launches
        if got != 48 * iters or not (torch.isfinite(u).all()
                                     and torch.isfinite(v).all()):
            raise AssertionError(f"{config}: {got} dense_gemm launches over "
                                 f"{iters} forwards, want {48 * iters}")
        print(f"{config} {H}x{W} B=1 serving forward (no grad): {ms:.3f} "
              f"ms per forward, dense_gemm launches {got} = 48 per forward "
              f"({iters} forwards)")
        total += got
        del model
    return total


def check_default_flags(device="cuda"):
    """Phase 1b: under PyTorch's default flags (cuDNN may run float32 convs
    in TF32) the port's module paths convolve in float32: a small
    NewFluidNet and a small TransolverStructured2D against the same
    modules in float64 (≤ TOL_MODULE_F64 of max |f64|); then the host
    cost of the float32 guard (``models/layers.py::float32_convs``) per
    call. Leaves the flags as it found them."""
    import copy

    import torch
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.models.layers import float32_convs
    from pbml_mantle_convection_tpu_torch.models.transolver import (
        TransolverStructured2D)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False    # PyTorch's
    try:
        # widths at which cuDNN takes its TF32 kernels (narrower convs
        # stay float32 under either flag)
        g = torch.Generator().manual_seed(12)
        nets = [
            ("NewFluidNet levels=3 c_h=16 repeats=2 64x96",
             NewFluidNet(levels=3, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                         r_p="learned", loss_type="curl", repeats=2, f=5,
                         p_pred=False, seed=0, device=device),
             torch.rand(1, 64, 96, 7, generator=g)),
            ("TransolverStructured2D n_layers=2 n_hidden=256 32x48",
             TransolverStructured2D(H=32, W=48, n_layers=2, n_hidden=256,
                                    n_head=8, slice_num=32, seed=0,
                                    device=device),
             torch.rand(1, 32 * 48, 7, generator=g))]
        with torch.no_grad():
            for name, net, x in nets:
                x = x.to(device)
                got = net(x)
                ref = copy.deepcopy(net).double()(x.double())
                rel = max(rel_err(a.double(), b)[1]
                          for a, b in zip(got[:2], ref[:2]))
                print(f"default flags (cudnn.allow_tf32=True) {name}: "
                      f"u, v vs float64 rel={rel:.3e} (tol "
                      f"{TOL_MODULE_F64})")
                if not (rel <= TOL_MODULE_F64 and cudnn.allow_tf32):
                    raise AssertionError(f"{name} at default flags: {rel}")
        x = torch.zeros(1, device=device)
        cost = {}
        for flag in (True, False):
            cudnn.allow_tf32 = flag
            n = 20000
            t0 = time.perf_counter()
            for _ in range(n):
                with float32_convs(x):
                    pass
            cost[flag] = (time.perf_counter() - t0) / n * 1e6
        print(f"float32_convs host cost: {cost[True]:.2f} us per call with "
              f"TF32 allowed, {cost[False]:.2f} us with it off")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def transolver_input(H, W, device="cuda"):
    """A seeded, non-zero Transolver input (1, H·W, 7): the surrogate's
    channels of the ``bench.py`` field plus 1% noise, so that the kernel
    path and the einsum path are compared on varied slice weights (the
    CLI feeds zeros, as the JAX CLI does)."""
    import torch
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.stepper import (
        assemble_fluidnet_input, make_static_fields)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    params = SimParams(3.0, 1e8, 10.0)
    rng = np.random.default_rng(0)
    T = np.clip(1.0 - grid.yc + 0.05 * np.sin(6.28 * grid.xc)
                + 0.01 * rng.standard_normal(grid.yc.shape), 0.0, 1.0)
    x, _ = assemble_fluidnet_input(
        torch.as_tensor(T[None], dtype=torch.float32, device=device),
        make_static_fields(grid, params, torch.float32, device), params)
    return x.reshape(1, H * W, x.shape[-1])


def run_transolver(counters, iters=50, H=128, W=506, device="cuda"):
    """Phase 5b: the Transolver serving path through the port's CLI, with
    its launch counts. Returns them."""
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        main as benchmark)
    for fn in counters.values():
        fn.launches = 0
    ms = benchmark(["--what", "inference", "-net", "transolver_structured",
                    "--iters", str(iters), "--H", str(H), "--W", str(W),
                    "--device", device])
    got = {k: fn.launches for k, fn in counters.items()}
    fwd = iters + 1                         # the CLI's warm-up pass
    want = {k: 5 * fwd if k.startswith("slice") else 0 for k in counters}
    if got != want:
        raise AssertionError(f"transolver: launches {got}, want {want}")
    print(f"transolver_structured {H}x{W} serving: {ms:.4f} ms per forward, "
          f"launches {got} = 5 slice_pool + 5 slice_deslice per forward "
          f"({fwd} forwards)")
    return got


def device_kernels(fn, calls: int = 1):
    """The device kernels of ``calls`` calls of ``fn`` (after a warm-up
    call), by name: ``torch.profiler``'s CUDA events, less the program's
    ``pmc.*`` spans (``utils/profiling.py::span``), which the profiler
    also puts on the device's timeline, as ranges that launch nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith("pmc."))


def device_kernel_count(fn, calls: int = 5, sessions: int = 3) -> float:
    """Device kernels per call of ``fn``: ``calls`` calls in one profiler
    session, the largest count of ``sessions`` sessions, over ``calls``.
    On the H100 a short session now and then comes back with a kernel's
    records missing (0 where the same call counts 1 in the next session);
    none has come back with more."""
    return max(sum(device_kernels(fn, calls).values())
               for _ in range(sessions)) / calls


def attention_layouts(structured, irregular, H, W, device="cuda"):
    """Phase 5d: the strides of the Physics-Attention projections' outputs
    (2-D structured: the conv's; irregular: the Dense heads'; 3-D: the
    conv3d's) and the device kernels of one forward of each, by name. The
    2-D structured and irregular forwards must launch no copy kernel: the
    slice kernels read the projections' views and write the rows that
    ``to_out`` reads."""
    import numpy as np
    import torch
    from pbml_mantle_convection_tpu_torch.models.transolver import (
        PhysicsAttentionStructuredMesh3D)
    attn2 = structured.blocks_0.Attn
    C = attn2.heads * attn2.dim_head
    h = torch.randn(1, H * W, C, device=device)
    vol = (16, 32, 32)
    attn3 = PhysicsAttentionStructuredMesh3D(
        C, *vol, np.random.default_rng(3), heads=attn2.heads,
        dim_head=attn2.dim_head, slice_num=32).to(device)
    h3 = torch.randn(1, int(np.prod(vol)), C, device=device)
    img = h.reshape(1, H, W, C).permute(0, 3, 1, 2)
    with torch.no_grad():
        conv = attn2._conv(img, attn2.in_project_x)
        print(f"layouts: 2-D structured conv output {tuple(conv.shape)} "
              f"strides {conv.stride()} (channels_last: "
              f"{conv.is_contiguous(memory_format=torch.channels_last)})")
        for name, attn, x, check in (
                ("2-D structured", attn2, h, True),
                ("irregular", irregular.blocks_0.Attn, h, True),
                ("3-D structured", attn3, h3, False)):
            fx_mid, x_mid = attn.project(x)
            kernels = device_kernels(lambda: attn(x))
            copies = {k: n for k, n in kernels.items()
                      if re.search(r"copy", k, re.I)}
            print(f"layouts: {name} x_mid {tuple(x_mid.shape)} strides "
                  f"{x_mid.stride()}, fx_mid strides {fx_mid.stride()}; one "
                  f"forward: {sum(kernels.values())} device kernels, "
                  f"copies {sum(copies.values())}: " + "; ".join(
                      f"{n} x {k[:90]}" for k, n in sorted(kernels.items())))
            if not kernels:
                raise AssertionError("the profiler saw no device kernels")
            if check and copies:
                raise AssertionError(f"{name} Physics-Attention forward "
                                     f"copies: {copies}")


def transolver_checks(counters, H=128, W=506, device="cuda"):
    """Phase 5c: one forward split by layer, the kernel path against the
    einsum formulation, and TransolverIrregular at the same N; then the
    projections' layouts (``attention_layouts``)."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        plain_slice_attention, slice_attention_fused, slice_attention_plain)
    model = build_model(ModelConfig(network="transolver_structured", H=H,
                                    W=W), device=device)
    x = transolver_input(H, W, device)
    N = H * W
    with torch.no_grad():
        total = cuda_ms(lambda: model(x), n=20)
        attn = model.blocks_0.Attn
        h = torch.randn(1, N, attn.heads * attn.dim_head, device=device)
        proj = cuda_ms(lambda: attn.project(h), n=20)
        fx_mid, x_mid = attn.project(h)
        args = (fx_mid, x_mid, attn.in_project_slice.weight.t(),
                attn.in_project_slice.bias,
                torch.clamp(attn.temperature, 0.1, 5.0),
                attn.to_q.weight.t(), attn.to_k.weight.t(),
                attn.to_v.weight.t())
        core = cuda_ms(lambda: slice_attention_fused(*args), n=20)
        core_plain = cuda_ms(lambda: slice_attention_plain(*args), n=10)
        L = model.n_layers
        print(f"transolver forward {H}x{W} f32: {total:.4f} ms; per block "
              f"x {L}: projection convs {proj:.4f} ms (2 x 3x3 128->128 "
              f"in one projection_conv launch, "
              f"{2 * 2 * 9 * 128 * 128 * N / 1e9:.1f} GFLOP), "
              f"slice_attention_fused {core:.4f} ms (einsum formulation "
              f"{core_plain:.4f}); the rest {total - L * (proj + core):.4f} "
              f"ms per forward")

        psi = []
        hook = getattr(model, f"blocks_{L - 1}").register_forward_hook(
            lambda mod, inp, out: psi.append(out))
        u, v, p = model(x)
        try:
            with plain_slice_attention():
                up, vp, _ = model(x)
        finally:
            hook.remove()
    if p is not None or u.shape != (1, H - 2, W - 2):
        raise AssertionError(f"transolver: output shape {tuple(u.shape)}")
    print(f"transolver: max |psi| / max |u| = "
          f"{float(psi[1].abs().max() / up.abs().max()):.1f}")
    for name, a, b in (("psi", *psi), ("u", u, up), ("v", v, vp)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"transolver: {name} is not finite")
        err, rel = rel_err(a, b)
        print(f"transolver forward kernel vs einsum path: {name} "
              f"max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {TOL_TRANSOLVER[name]})")
        if not rel <= TOL_TRANSOLVER[name]:
            raise AssertionError(f"transolver: kernel path diverges: {name}")

    irregular = build_model(ModelConfig(network="transolver"), device=device)
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        out = irregular(x)
        got = {k: fn.launches for k, fn in counters.items()}
        ms = cuda_ms(lambda: irregular(x), n=5)
    want = {k: 5 if k.startswith("slice") else 0 for k in counters}
    if got != want or out.shape != (1, N, 1) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"transolver (irregular): launches {got}, "
                             f"shape {tuple(out.shape)}")
    print(f"transolver (irregular) N={N}: {ms:.4f} ms per forward, "
          f"launches {got} per forward, output finite")
    attention_layouts(model, irregular, H, W, device)


def load_tool(stem):
    """The module ``tools/<stem>.py``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "tools" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# steps of phase 6's core-cooling Di=0.5 leg (a drift figure, no bound)
DI_STEPS = 100


def accuracy_tool():
    return load_tool("torch_port_accuracy")


def leg_launches(mode, path):
    """Kernel wrapper launches per step of one accuracy leg (``path``
    "f64", "module" or "fused"): none for the
    float64 reference (the module and the energy step's plain version),
    the energy kernel alone for the module legs, and for the fused leg the
    4 + 1 stages with the epilogue (ML_STOKES) or the energy kernel (the
    Di mode, whose source term the epilogue does not take)."""
    want = dict.fromkeys(("layer_stack", "trunk", "curl_advect_epilogue",
                          "advect_diffuse_step_fused"), 0)
    if path == "fused":
        want.update(layer_stack=4, trunk=1)
    if path != "f64":
        want["curl_advect_epilogue" if (path, mode) == ("fused", "ML_STOKES")
             else "advect_diffuse_step_fused"] = 1
    return want


def run_accuracy(H=128, W=506, steps=500, device="cuda", di_steps=DI_STEPS):
    """Phase 6: the 500-step T-RMSE against the float64 module path
    (``tools/torch_port_accuracy.py``): the flagship ML_STOKES rollout,
    whose fused path must read T_rmse < ACC_T_RMSE and whose TF32 control
    must not, the core-cooling Di=0.5 mode (``di_steps``: its figure
    measures drift and has no bound), printed and checked finite,
    and the ``-pad zeros`` flagship, whose fused path must read below
    ACC_T_RMSE too. Each leg's launches per step are checked
    (``leg_launches``); none of them goes into the kernels line."""
    acc = accuracy_tool()
    weights = acc.flagship_weights(0)
    recs = {}
    for mode, n in (("ML_STOKES", steps), (acc.DI_MODE, di_steps)):
        t0 = time.perf_counter()
        rec = acc.measure(weights, H, W, n, mode, device=device)
        print(json.dumps(rec))
        legs = {"f64": ("f64", rec["f64_launches_per_step"]),
                **{name: (acc.VARIANTS[name][0],
                          rec[name]["launches_per_step"])
                   for name in acc.MODE_VARIANTS[mode]}}
        for name, (path, got) in legs.items():
            want = leg_launches(mode, path)
            if got != want:
                raise AssertionError(f"accuracy {mode} {name}: launches "
                                     f"per step {got}, want {want}")
        for name in acc.MODE_VARIANTS[mode]:
            nums = [rec[name][k] for k in ("T_rmse", "trace_mae",
                                           "steps_per_s")]
            if not all(np.isfinite(nums)):
                raise AssertionError(f"accuracy {mode}: {name} {rec[name]}")
        print(f"accuracy {H}x{W} {mode}: {n} steps, fused T_rmse "
              f"{rec['fused']['T_rmse']:.3e}, float64 leg "
              f"{rec['f64_seconds']:.2f} s, launches per step checked, "
              f"{time.perf_counter() - t0:.1f} s")
        recs[mode] = rec
    # the -pad zeros flagship (the layer kernels' zero instance)
    t0 = time.perf_counter()
    arch = {**acc.ARCH, "r_p": "zeros"}
    zrec = acc.measure(acc.flagship_weights(0, arch), H, W, steps,
                       "ML_STOKES", device=device, arch=arch)
    print(json.dumps(zrec))
    for name in acc.MODE_VARIANTS["ML_STOKES"]:
        path = acc.VARIANTS[name][0]
        if zrec[name]["launches_per_step"] != leg_launches("ML_STOKES",
                                                           path):
            raise AssertionError(f"accuracy -pad zeros {name}: launches "
                                 f"{zrec[name]['launches_per_step']}")
    zfused = zrec["fused"]["T_rmse"]
    print(f"accuracy {H}x{W} -pad zeros ML_STOKES: {steps} steps, fused "
          f"T_rmse {zfused:.3e} (bound {ACC_T_RMSE}), module_f32 "
          f"{zrec['module_f32']['T_rmse']:.3e}, TF32 control "
          f"{zrec['module_tf32']['T_rmse']:.3e}, fused "
          f"{zrec['fused']['steps_per_s']:.1f} steps/s, "
          f"{time.perf_counter() - t0:.1f} s")
    if not zfused < ACC_T_RMSE:
        raise AssertionError(f"accuracy -pad zeros: fused T_rmse "
                             f"{zfused:.3e} >= {ACC_T_RMSE}")
    flag, di = recs["ML_STOKES"], recs[acc.DI_MODE]
    fused, tf32 = flag["fused"]["T_rmse"], flag["module_tf32"]["T_rmse"]
    if not fused < ACC_T_RMSE:
        raise AssertionError(f"accuracy: fused T_rmse {fused:.3e} >= "
                             f"{ACC_T_RMSE}")
    if not tf32 >= ACC_T_RMSE:
        raise AssertionError(f"accuracy: the TF32 control reads T_rmse "
                             f"{tf32:.3e} < {ACC_T_RMSE}: the bound no "
                             f"longer tells float32 from TF32")
    print(f"accuracy: fused T_rmse {fused:.3e} < {ACC_T_RMSE} <= TF32 "
          f"control {tf32:.3e}; the Di=0.5 mode's fused T_rmse "
          f"{di['fused']['T_rmse']:.3e} after {di_steps} steps (drift, no "
          f"bound)")


def run_batched(counters, B=4, H=128, W=506, steps=500, device="cuda"):
    """Phase 7: ``cli/benchmark.py --what rollout --batch B`` at 128×506
    (4B ``layer_stack`` + B ``trunk`` + 1 ``advect_diffuse_step_fused`` +
    0 ``curl_advect_epilogue`` launches per step), then the same at B = 1
    for its sim-steps/s. Returns the launch counts of both."""
    from pbml_mantle_convection_tpu_torch.cli import benchmark
    launch = {k: 0 for k in counters}
    sps = {}
    for b in (B, 1):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        sps[b] = benchmark.main(["--what", "rollout", "--batch", str(b),
                                 "--H", str(H), "--W", str(W),
                                 "--steps", str(steps),
                                 "--device", device])
        got = {k: fn.launches for k, fn in counters.items()}
        n = steps + min(steps, 20)                   # timed + warm-up
        want = rollout_launches(b, n)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"rollout B={b}: launches {got}, "
                                 f"want {want}")
        print(f"rollout B={b} {H}x{W}: {sps[b]:.1f} steps/s, "
              f"{b * sps[b]:.1f} sim-steps/s, launches "
              f"{ {k: got[k] / n for k in want} } per step, "
              f"{time.perf_counter() - t0:.1f} s")
        for k in launch:
            launch[k] += got[k]
    print(f"rollout B={B}: {B * sps[B]:.1f} sim-steps/s against "
          f"{B} x {sps[1]:.1f} = {B * sps[1]:.1f} at B=1 "
          f"({sps[B] / sps[1]:.3f} of it; {B * sps[B] / sps[1]:.3f} of the "
          f"B=1 sim-steps/s)")
    return launch


# train-step parameter gradients in float32 against float64, max |diff|
# over max |f64| across all parameters: the conv kernels' bound; the
# backward's convolutions in cuDNN's TF32 must land above it
TOL_TRAIN_GRAD = 1e-4


def train_gradients(net, x, y, net_name, leg="step", extra=None):
    """The parameter gradients of one train step of ``net`` on (x, y),
    and of the same step on a float64 copy; returns (max |diff| / max
    |f64| over all parameters, the f64 copy's gradients by name, the
    float32 net's). ``leg`` of the float32 net: "step", the train step;
    "tf32", the control: the loss and backward outside the step's float32
    guard, as the parent ran them (the modules' forward guard alone), so
    the backward's convolutions follow the TF32 flag; "no_cudnn", the
    train step with cuDNN off (PyTorch's own CUDA convolutions, float32
    GEMMs), which tells cuDNN's share of the float32 error. ``extra``:
    more batch entries (the U-Net's ``paras`` and ``yc``)."""
    import copy

    import torch
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_loss_fn, make_train_step)
    from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
    cfg = TrainStepConfig(net=net_name, loss_scale=True,
                          loss_derivative=True, loss_type="curl")
    ref = copy.deepcopy(net).double()
    cudnn = torch.backends.cudnn
    grads = []
    for m, dt, lg in ((net, torch.float32, leg),
                      (ref, torch.float64, "step")):
        batch = {k: t.to(dt) for k, t in
                 {"x": x, "y": y, **(extra or {})}.items()}
        enabled, cudnn.enabled = cudnn.enabled, lg != "no_cudnn"
        try:
            if lg == "tf32":
                m.zero_grad(set_to_none=True)
                make_loss_fn(m, cfg)(batch).total.backward()
            else:
                make_train_step(m, adam_l2(m.parameters(), 0.0), cfg)(batch)
        finally:
            cudnn.enabled = enabled
        grads.append({n: q.grad for n, q in m.named_parameters()})
    got, want = grads
    top = max(float(g.abs().max()) for g in want.values())
    err = max(float((got[n].double() - want[n]).abs().max()) for n in want)
    return err / top, want, got


# a loss kink crossed by rounding (ROADMAP §3 faults 8 and 10): float32's
# gradient at the last conv's output may leave float64's where an L1 term
# of the loss sits within rounding of 0 and the two precisions take
# opposite sides of its abs(). locate_kink accepts that reading only if
# at each such flip both arguments lie within KINK_ARG of the term's max
# |argument| from 0, the flips' own contribution (the sign change times
# the term's weight, carried to the output in float64) accounts for the
# whole output-gradient difference but KINK_ELSEWHERE of its max, at most
# KINK_PIXELS elements flip, and float64's backward fed float32's output
# gradient reproduces the float32 step within TOL_TRAIN_GRAD (a term
# whose flips move the output gradient by less than KINK_ELSEWHERE, as
# the mass residual of a curl head, which is 0 in exact arithmetic, is
# left out)
KINK_ELSEWHERE = 1e-5
KINK_ARG = 1e-5
KINK_PIXELS = 64


def locate_kink(net, x, y, net_name, last, extra=None):
    """Where a float32 train step's gradient error enters, and whether a
    loss kink crossed by rounding explains it. The loss gradient at the
    output of the module ``last`` (the last conv, before the mean
    subtraction and the head) is taken in float32 and in float64, with
    the argument of every ``abs`` the loss takes after it; a flip is an
    element whose argument has another sign in float32 than in float64
    and whose weight in the loss is not 0, of a term whose flips change
    the output gradient by more than KINK_ELSEWHERE of its max (the
    others are counted in ``n_flips_unreached``). Returns a dict:
    ``step_rel``
    (the reading of :func:`train_gradients`), ``fed_vs_f32_rel`` (the
    float64 backward given float32's output gradient against the float32
    step; max |diff| / max |f64| over all parameters), ``fed_vs_f64_rel``,
    ``out_grad_rel`` and ``n_jumps`` (output-gradient elements more than
    1e-3 of its max apart), ``n_flips``, ``flip_arg_rel`` (the largest
    |argument| at a flip in either precision over its term's max
    |argument| in float64), ``unexplained_rel`` (max |g32 - g64 - the
    flips' contribution| over max |g64|), the first 8 ``flips`` (term,
    index, both arguments in float32 ulps of the term's max) and the
    ``verdict`` of :func:`kink_verdict`."""
    import copy

    import torch
    from torch.overrides import TorchFunctionMode
    from pbml_mantle_convection_tpu_torch.models.layers import (
        float32_convs)
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_loss_fn)

    class AbsArgs(TorchFunctionMode):
        """Each abs() taken once ``armed``: its argument and result."""

        def __init__(self):
            super().__init__()
            self.armed, self.seen = False, []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            r = func(*args, **(kwargs or {}))
            if (self.armed and func in (torch.abs, torch.Tensor.abs)
                    and args[0].requires_grad):
                self.seen.append((args[0], r))
            return r

    cfg = TrainStepConfig(net=net_name, loss_scale=True,
                          loss_derivative=True, loss_type="curl")
    nets = {"f32": net, "f64": copy.deepcopy(net).double()}
    run = {}
    for key, m in nets.items():
        dt = torch.float32 if key == "f32" else torch.float64
        batch = {k: t.to(dt) for k, t in
                 {"x": x, "y": y, **(extra or {})}.items()}
        mode, seen = AbsArgs(), []

        def keep(mod, i, o, seen=seen, mode=mode):
            if not seen:
                o.retain_grad()
                seen.append(o)
                mode.armed = True
        h = m.get_submodule(last).register_forward_hook(keep)
        m.zero_grad(set_to_none=True)
        with float32_convs(batch["x"]):     # the backward's convs too
            with mode:
                total = make_loss_fn(m, cfg)(batch).total
            h.remove()
            total.backward(retain_graph=key == "f64")
        run[key] = dict(out=seen[0], total=total, abs=mode.seen, grads={
            n: q.grad.double() for n, q in m.named_parameters()
            if q.grad is not None})
    r32, r64 = run["f32"], run["f64"]
    if [a.shape for a, _ in r32["abs"]] != [a.shape for a, _ in r64["abs"]]:
        raise AssertionError("locate_kink: the two precisions took "
                             "different abs() terms")
    out64 = r64["out"]
    g32, g64 = r32["out"].grad.double(), out64.grad
    d = (g32 - g64).abs()
    params = {n: q for n, q in nets["f64"].named_parameters()
              if n in r64["grads"]}
    fed = torch.autograd.grad(out64, list(params.values()), grad_outputs=g32,
                              retain_graph=True, allow_unused=True)
    fed = {n: torch.zeros_like(q) if f is None else f
           for (n, q), f in zip(params.items(), fed)}
    # each term's weight in the loss, d total / d |argument|
    weights = torch.autograd.grad(r64["total"], [r for _, r in r64["abs"]],
                                  retain_graph=True, allow_unused=True)
    top = float(g64.abs().max())
    # each flipped term's sign change carried to the output in float64; a
    # term that does not reach it (the curl head's mass residual is 0 for
    # any output: rounding alone signs it) has no kink to explain
    delta = torch.zeros_like(g64)
    flips, unreached, arg_rel = [], 0, 0.0
    for t, ((a32, _), (a64, _), c) in enumerate(
            zip(r32["abs"], r64["abs"], weights)):
        if c is None:
            continue
        a32, b64 = a32.detach().double(), a64.detach()
        flip = (torch.sign(a32) != torch.sign(b64)) & (c != 0)
        if not bool(flip.any()):
            continue
        got = torch.autograd.grad(
            a64, out64, grad_outputs=torch.where(
                flip, c * (torch.sign(a32) - torch.sign(b64)), 0.0),
            retain_graph=True, allow_unused=True)[0]
        if got is None or float(got.abs().max()) <= KINK_ELSEWHERE * top:
            unreached += int(flip.sum())
            if got is not None:
                delta += got
            continue
        delta += got
        scale = float(b64.abs().max())
        for idx in flip.nonzero().tolist():
            i = tuple(idx)
            both = max(abs(float(a32[i])), abs(float(b64[i])))
            arg_rel = max(arg_rel, both / scale)
            flips.append({"term": t, "at": idx, "ulps_f32": float(a32[i])
                          / (scale * 2.0 ** -23), "ulps_f64": float(b64[i])
                          / (scale * 2.0 ** -23)})
    gtop = max(float(w.abs().max()) for w in r64["grads"].values())

    def rel(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in b) / gtop
    k = {"step_rel": rel(r32["grads"], r64["grads"]),
         "fed_vs_f32_rel": rel(fed, r32["grads"]),
         "fed_vs_f64_rel": rel(fed, r64["grads"]),
         "out_grad_rel": float(d.max()) / top,
         "n_jumps": int((d > 1e-3 * top).sum()),
         "n_flips": len(flips),
         "n_flips_unreached": unreached,
         "flip_arg_rel": arg_rel,
         "unexplained_rel": float((g32 - g64 - delta).abs().max()) / top,
         "flips": flips[:8]}
    k["verdict"] = kink_verdict(k)
    return k


def kink_verdict(k) -> str:
    """"kink" if the reading ``k`` of :func:`locate_kink` is a loss kink
    crossed by rounding (the conditions above KINK_ELSEWHERE), else what
    fails."""
    if not k["fed_vs_f32_rel"] <= TOL_TRAIN_GRAD:
        return (f"the backward given float32's output gradient reads "
                f"{k['fed_vs_f32_rel']:.3e} of the float32 step")
    if not 0 < k["n_flips"] <= KINK_PIXELS:
        return f"{k['n_flips']} abs() arguments change sign"
    if not k["flip_arg_rel"] <= KINK_ARG:
        return (f"an abs() argument {k['flip_arg_rel']:.3e} of its term's "
                f"max from 0 changes sign")
    if not k["unexplained_rel"] <= KINK_ELSEWHERE:
        return (f"the flips leave {k['unexplained_rel']:.3e} of the output "
                f"gradient unexplained")
    return "kink"


def worst_parameter(got, want) -> str:
    """The parameter with the largest max |diff| of ``got`` against
    ``want``, that diff over its own max |want| and that max over the
    largest of all, and the median over parameters of each one's own
    relative error: where the error of ``train_gradients`` sits."""
    errs = {n: float((got[n].double() - w).abs().max()) for n, w in
            want.items()}
    tops = {n: float(w.abs().max()) for n, w in want.items()}
    name = max(errs, key=errs.get)
    own = sorted(errs[n] / tops[n] for n in want if tops[n] > 0)
    return (f"worst {name}: {errs[name] / tops[name]:.3e} of its own max "
            f"|grad|, which is {tops[name] / max(tops.values()):.3e} of "
            f"the largest; median over {len(own)} parameters "
            f"{own[len(own) // 2]:.3e}")


def kernel_route_gradients(net, x, y, counters):
    """A Transolver's parameter gradients from a forward with grad on
    outside the train step (as ``model(x)`` in a script runs it: the slice
    kernels forward, the einsum formulation recomputed in the backward),
    TF32 off for the whole of it; returns them and the slice kernels'
    launches."""
    from pbml_mantle_convection_tpu_torch.models.layers import float32_convs
    from pbml_mantle_convection_tpu_torch.train.losses import fluidnet_loss
    for fn in counters.values():
        fn.launches = 0
    with float32_convs(x):
        u, v, p = net(x)
        fluidnet_loss(u, v, p, y[..., 1:-1, 1:-1], p_pred=False,
                      loss_scale=True, loss_derivative=True,
                      loss_type="curl").total.backward()
    return ({n: q.grad for n, q in net.named_parameters()},
            {k: fn.launches for k, fn in counters.items()})


def train_nets(device, full):
    """Phase 8a's networks: (name, registry name, builder, x, y, H, W),
    B = 2, seeded. Small: NewFluidNet levels 3, repeats 2 at 64×96 and a
    2-block TransolverStructured2D (n_hidden 256) at 32×48. Full: the
    flagship (levels 5, c_h 16, repeats 6) and the serving Transolver
    (``ModelConfig`` defaults), both at 128×506, where cuDNN picks other
    backward algorithms (FFT convs among them) than at the small sizes."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    from pbml_mantle_convection_tpu_torch.models.transolver import (
        TransolverStructured2D)
    g = torch.Generator().manual_seed(13)
    (H, W), (h, w) = ((128, 506), (128, 506)) if full else ((64, 96),
                                                            (32, 48))
    levels, repeats = (5, 6) if full else (3, 2)
    nfn = (f"NewFluidNet{' flagship' if full else ''} levels={levels} "
           f"c_h=16 repeats={repeats}",
           lambda: NewFluidNet(levels=levels, c_i=7, c_h=16, c_o=1,
                               act_fn="gelu", r_p="learned",
                               loss_type="curl", repeats=repeats, f=5,
                               p_pred=False, seed=0, device=device))
    if full:
        tsv = ("TransolverStructured2D serving n_layers=5 n_hidden=128",
               lambda: build_model(ModelConfig(
                   network="transolver_structured", H=h, W=w),
                   device=device))
    else:
        tsv = ("TransolverStructured2D n_layers=2 n_hidden=256",
               lambda: TransolverStructured2D(H=h, W=w, n_layers=2,
                                              n_hidden=256, n_head=8,
                                              slice_num=32, seed=0,
                                              device=device))
    return [
        (*nfn, "newfluidnet", torch.rand(2, H, W, 7, generator=g),
         torch.randn(2, 2, H, W, generator=g), H, W),
        (*tsv, "transolver_structured", torch.rand(2, h * w, 7, generator=g),
         torch.randn(2, 2, h, w, generator=g), h, w)]


def check_train_gradients(counters, device="cuda"):
    """Phase 8a: under PyTorch's default flags (cuDNN may run float32
    convs in TF32), one train step's parameter gradients of a small
    NewFluidNet and TransolverStructured2D and of the flagship and the
    serving Transolver at 128×506 against the same step in float64 (≤
    TOL_TRAIN_GRAD), with the TF32-backward control above the bound and
    the step with cuDNN off printed beside them; every parameter of each
    Transolver gets a gradient (the two biases that the curl head
    differentiates away get rounding noise), and no kernel wrapper
    launches. A Transolver forward with grad on outside the step launches
    the slice kernels (one each per block) and its gradients, through the
    einsum formulation recomputed, are held to the same bound. The slice
    kernels refuse an input that requires grad. Leaves the flags as it
    found them."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice, slice_pool)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        for name, build, net_name, x, y, hh, ww in (
                train_nets(device, False) + train_nets(device, True)):
            t0 = time.perf_counter()
            x, y = x.to(device), y.to(device)
            out = {}
            for leg in ("step", "tf32", "no_cudnn"):
                cudnn.allow_tf32, matmul.allow_tf32 = True, False  # PyTorch's
                for fn in counters.values():
                    fn.launches = 0
                out[leg] = train_gradients(build(), x, y, net_name, leg)
                launched = {k: fn.launches for k, fn in counters.items()}
                if any(launched.values()):
                    raise AssertionError(f"{name}: a train step launched "
                                         f"kernels {launched}")
                if not cudnn.allow_tf32:
                    raise AssertionError("the step left cuDNN's TF32 off")
            rel, rel_ctl = out["step"][0], out["tf32"][0]
            print(f"train step {name} {hh}x{ww} B=2 at default flags "
                  f"(cudnn.allow_tf32=True): parameter gradients vs float64 "
                  f"rel={rel:.3e} (tol {TOL_TRAIN_GRAD}); TF32-backward "
                  f"control rel={rel_ctl:.3e}; the step with cuDNN off "
                  f"rel={out['no_cudnn'][0]:.3e}")
            for leg in ("step", "no_cudnn"):
                print(f"  {leg}: {worst_parameter(out[leg][2], out[leg][1])}")
            if not rel <= TOL_TRAIN_GRAD < rel_ctl:
                raise AssertionError(f"{name}: train gradients {rel:.3e}, "
                                     f"control {rel_ctl:.3e}")
            if net_name.startswith("transolver"):
                want, got = out["step"][1], out["step"][2]
                last = max(int(n.split(".")[0][7:]) for n in got
                           if n.startswith("blocks_"))
                noise = {f"blocks_{last}.ln_3.bias",
                         f"blocks_{last}.mlp2.bias"}
                missing = [n for n, q in got.items() if q is None or (
                    n not in noise and not float(q.abs().max()) > 0)]
                if missing or len(got) != len(want):
                    raise AssertionError(f"transolver parameters without a "
                                         f"gradient on the card: {missing}")
                print(f"train step {name}: all {len(got)} parameters have "
                      f"a gradient, {sum(n.count('.Attn.') for n in got)} "
                      f"of them the attention's")
                cudnn.allow_tf32 = True
                kgot, launched = kernel_route_gradients(build(), x, y,
                                                        counters)
                top = max(float(g.abs().max()) for g in want.values())
                krel = max(float((kgot[n].double() - want[n]).abs().max())
                           for n in want) / top
                n_blocks = last + 1
                print(f"{name}: a forward with grad on outside the train "
                      f"step: slice kernel launches {launched}, parameter "
                      f"gradients vs float64 rel={krel:.3e} (tol "
                      f"{TOL_TRAIN_GRAD})")
                if launched["slice_pool"] != n_blocks or \
                        launched["slice_deslice"] != n_blocks or \
                        not krel <= TOL_TRAIN_GRAD:
                    raise AssertionError(f"{name}: kernels under autograd: "
                                         f"{launched}, rel {krel:.3e}")
            print(f"  {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
        x = torch.randn(2, 64, 16, device=device)
        ws = torch.randn(16, 8, device=device, requires_grad=True)
        bs, temp = torch.zeros(8, device=device), torch.ones(2, device=device)
        tok = torch.randn(2, 8, 16, device=device)
        for fn, args in ((slice_pool, (x, x, ws, bs, temp)),
                         (slice_deslice, (x, tok, ws, bs, temp))):
            n0 = fn.launches
            try:
                fn(*args)
            except RuntimeError as e:
                if "no backward" not in str(e) or fn.launches != n0:
                    raise
            else:
                raise AssertionError(f"{fn.__name__} ran under autograd")
        print("slice_pool, slice_deslice: refuse an input that requires "
              "grad (no launch)")
        cudnn.allow_tf32, matmul.allow_tf32 = True, False        # PyTorch's
        fault7_readings(device)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def echo_benchmark(argv, device="cuda"):
    """``cli/benchmark.py`` with ``argv``; echoes its JSON line (printed
    by the CLI) and returns it."""
    import contextlib
    import io

    from pbml_mantle_convection_tpu_torch.cli import benchmark
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        benchmark.main([*argv, "--device", device])
    line = buf.getvalue().strip().splitlines()[-1]
    print(line)
    return json.loads(line)


def echo_train_benchmark(argv, device="cuda"):
    """``cli/benchmark.py --what train`` with ``argv``; echoes its JSON
    line and checks the loss is finite."""
    rec = echo_benchmark(["--what", "train", *argv], device)
    if not np.isfinite(rec["loss"]):
        raise AssertionError(f"{rec['metric']}: loss {rec['loss']}")
    return rec


def run_trainer(nn_dir, H=128, W=506, device="cuda", model=None):
    """Phase 8c: the port's Trainer on the JAX CLI's synthetic stores at
    H × W with the README's flagship training flags (``-l 5 -f 16 -r 6
    -k 5 -p learned -lt curl -b 8 -l_sc 1 -l_de 1``): two epochs
    device-resident, a restart into a third, then a fourth with the
    stores host-resident (the prefetch thread and its copies to the
    card). Checks finite losses, the log, the resumed epoch and the
    restored Adam state; prints the epoch wall times."""
    import torch
    from pbml_mantle_convection_tpu_torch.cli.train import (
        datasets, synthetic_stores)
    from pbml_mantle_convection_tpu_torch.models.registry import ModelConfig
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.train.trainer import (
        TrainConfig, Trainer, parse_loss_log)
    mc = ModelConfig(**{**dict(network="newfluidnet", levels=5, c_h=16,
                               repeats=6, kernel=5, r_p="learned",
                               loss_type="curl"), **(model or {})})
    epochs, milestones = TrainConfig.schedule_for("newfluidnet", False)
    cfg = TrainConfig(model=mc, epochs=epochs, batch_size=8,
                      milestones=milestones, loss_scale=True,
                      loss_derivative=True, device=device)
    stores = synthetic_stores(Grid(H=H, W=W, aspect=(W - 2) / (H - 2)))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for host, restart, upto in ((False, False, 2), (False, True, 3),
                                (True, True, 4)):
        tr = Trainer(cfg, *datasets("newfluidnet", stores, device=device,
                                    host_resident=host),
                     nn_dir=nn_dir, restart=restart)
        if tr.train_data.host_resident != host:
            raise AssertionError("residency mode")
        if restart and not (tr.start_epoch == upto - 1
                            and tr.optimizer.state_dict()["state"]):
            raise AssertionError(f"restart: epoch {tr.start_epoch}, "
                                 f"{len(tr.optimizer.state)} Adam states")
        tr.train(upto)
    log = parse_loss_log(tr.log_path)
    if [e["epoch"] for e in log] != [0, 1, 2, 3] or not all(
            np.isfinite(e["train"] + e["cv"]).all() for e in log):
        raise AssertionError(f"trainer log: {log}")
    with open(os.path.join(tr.nn_dir, "epoch_metrics.txt")) as f:
        walls = [float(line.split(",")[1]) for line in f]
    n_train = len(tr.train_data)
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if device == "cuda" else "not measured")
    print(f"trainer {H}x{W} flagship B=8 (6 + 2 init), {n_train} training "
          f"snapshots: epoch wall s {walls} (epochs 0-1 device-resident, "
          f"2 after a restart, 3 host-resident); peak device memory "
          f"{peak}; {time.perf_counter() - t0:.1f} s; log {log[-1]}")
    return walls


# train/experiments.py::unet_roll1's network: levels 4, c_h 32, repeats 2,
# k 5, replicate padding (curl, a_bound 10: ModelConfig's defaults)
UNET_ROLL1 = dict(levels=4, c_h=32, repeats=2, kernel=5, r_p="replicate")


def unet_argv(H, W):
    c = UNET_ROLL1
    return ["-net", "unet", "-l", str(c["levels"]), "-f", str(c["c_h"]),
            "-r", str(c["repeats"]), "-k", str(c["kernel"]), "-pad",
            c["r_p"], "--H", str(H), "--W", str(W)]


def unet_model(H, W, device, seed=0):
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    return build_model(ModelConfig(network="unet", loss_type="curl",
                                   p_pred=False, H=H, W=W, **UNET_ROLL1),
                       seed=seed, device=device)


# the U-Net's rollout against float64: the steps over which the free-running
# float32 trajectory stays within TOL_ROLLOUT of the float64 one, and the
# start of a second float64 trajectory UNET_NUDGE off the first (seeded):
# the witness that the dynamics alone widen a gap over the run by as much
# as the float32 trajectory's grows (within UNET_WITNESS_FACTOR)
UNET_TOGETHER = 5
UNET_NUDGE = 1e-7
UNET_WITNESS_FACTOR = 10.0


def unet_rollouts(net, grid, steps, device="cuda"):
    """``steps`` coupled U-Net steps from the CLI's initial field: float64,
    float32 free-running, float64 from a start UNET_NUDGE off, and each
    float32 step taken from the float64 state. Returns the per-step rel
    gaps {"free": T, u, v of float32 vs float64; "nudged": T of the
    nudged float64 vs float64} and the forced steps' worst rel per
    field."""
    import copy

    import numpy as np
    import torch
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        initial_temperature)
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    e32, e64 = (SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0), m,
                                      cn_max=0.99, dtype=dt, device=device,
                                      net="unet"))
                for m, dt in ((net, torch.float32),
                              (copy.deepcopy(net).double(), torch.float64)))
    T0 = initial_temperature(grid)
    nudge = UNET_NUDGE * np.random.default_rng(7).uniform(-1, 1, T0.shape)
    s64, s32 = e64.init_state(T0), e32.init_state(T0)
    sn = e64.init_state(T0 + nudge)
    gaps = {"free": [], "nudged": []}
    forced = dict.fromkeys(("T", "u", "v"), 0.0)
    for _ in range(steps):
        f32 = e32.step(type(s64)(*[
            t.float() if t.is_floating_point() else t for t in s64]))
        s64, s32, sn = e64.step(s64), e32.step(s32), e64.step(sn)
        for name in forced:
            forced[name] = max(forced[name], rel_err(
                getattr(f32, name).double(), getattr(s64, name))[1])
        gaps["free"].append({name: rel_err(getattr(s32, name).double(),
                                           getattr(s64, name))[1]
                             for name in forced})
        gaps["nudged"].append(rel_err(sn.T, s64.T)[1])
    return gaps, forced


def check_unet_rollout(net, grid, steps, device="cuda"):
    """``steps`` coupled U-Net steps in float32 against float64
    (:func:`unet_rollouts`): each float32 step from the float64 state
    within TOL_ROLLOUT, the free-running float32 trajectory within it for
    UNET_TOGETHER steps, and past them the witness that the gap is the
    dynamics': the gap of a float64 trajectory UNET_NUDGE off at the
    start grows from its first step to its last by at least
    1/UNET_WITNESS_FACTOR of the float32 gap's growth."""
    gaps, forced = unet_rollouts(net, grid, steps, device)
    free, nudged = gaps["free"], gaps["nudged"]
    H, W = grid.H, grid.W
    print(f"unet {steps} steps {H}x{W}, each float32 step from the float64 "
          f"state vs the float64 step, worst rel: "
          f"{ {k: f'{v:.3e}' for k, v in forced.items()} } (tol "
          f"{TOL_ROLLOUT})")
    for k in range(steps):
        print(f"unet step {k + 1:2d}: free-running float32 vs float64 rel "
              f"T {free[k]['T']:.3e} u {free[k]['u']:.3e} v "
              f"{free[k]['v']:.3e}; float64 from a start {UNET_NUDGE:g} off "
              f"vs float64 rel T {nudged[k]:.3e}")
    for name, rel in forced.items():
        if not rel <= TOL_ROLLOUT[name]:
            raise AssertionError(f"unet step float32 vs float64: {name} "
                                 f"{rel:.3e}")
    for k in range(UNET_TOGETHER):
        for name, rel in free[k].items():
            if not rel <= TOL_ROLLOUT[name]:
                raise AssertionError(f"unet free-running float32 vs "
                                     f"float64, step {k + 1}: {name} "
                                     f"{rel:.3e}")
    g_free = free[-1]["T"] / free[0]["T"]
    g_nudged = nudged[-1] / nudged[0]
    print(f"unet: float32 stays within {TOL_ROLLOUT} of float64 for "
          f"{UNET_TOGETHER} steps; from step 1 to {steps} its T gap grows "
          f"{g_free:.3e}x to {free[-1]['T']:.3e}, the gap of a float64 start "
          f"{UNET_NUDGE:g} off {g_nudged:.3e}x to {nudged[-1]:.3e}")
    if not g_nudged * UNET_WITNESS_FACTOR >= g_free:
        raise AssertionError(f"unet: float32's gap grows {g_free:.3e}x over "
                             f"{steps} steps, a float64 start "
                             f"{UNET_NUDGE:g} off only {g_nudged:.3e}x")


def check_unet_gradients(H, W, device="cuda"):
    """One U-Net train step's parameter gradients against float64 under
    PyTorch's default flags, each ≤ TOL_TRAIN_GRAD: at B = 2 with the
    TF32-backward control above the bound, and at the production batch
    B = 8 for weight seeds 0, 1, 2 (ROADMAP §3 fault 8)."""
    import torch
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    for B, legs in ((2, ((0, "step"), (0, "tf32"))),
                    (8, ((0, "step"), (1, "step"), (2, "step")))):
        g = torch.Generator().manual_seed(13)
        x = torch.rand(B, H, W, 10, generator=g).to(device)
        y = torch.randn(B, 3, H, W, generator=g).to(device)
        extra = {"paras": torch.tensor([[3.0, 1e8, 10.0]] * B,
                                       device=device),
                 "yc": torch.as_tensor(grid.yc, dtype=torch.float32,
                                       device=device).expand(B, H, W)}
        out = {}
        try:
            for seed, leg in legs:
                cudnn.allow_tf32, matmul.allow_tf32 = True, False  # PyTorch's
                out[seed, leg] = rel, want, got = train_gradients(
                    unet_model(H, W, device, seed), x, y, "unet", leg, extra)
                print(f"unet train step {H}x{W} B={B} seed {seed}"
                      + (" TF32-backward control" if leg == "tf32" else "")
                      + f": parameter gradients vs float64 rel={rel:.3e} "
                      f"(tol {TOL_TRAIN_GRAD}); {worst_parameter(got, want)}")
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = saved
        for (seed, leg), (rel, _, _) in out.items():
            if not (TOL_TRAIN_GRAD < rel if leg == "tf32"
                    else rel <= TOL_TRAIN_GRAD):
                raise AssertionError(f"unet train gradients B={B} seed "
                                     f"{seed} {leg}: {rel:.3e}")
        del out
        torch.cuda.empty_cache()


def run_unet(counters, H=128, W=506, steps=20, device="cuda"):
    """Phase 9: the U-Net at ``unet_roll1``'s width, H × W, seeded
    weights: ``cli/benchmark.py --what inference`` (ms per forward),
    ``--what rollout`` (steps/s), ``--what train`` at B = 8 (ms,
    samples/s, peak memory), ``steps`` coupled steps in float32 against
    float64 (:func:`check_unet_rollout`), and train-step gradients
    against float64 at B = 2 and 8 (:func:`check_unet_gradients`). The
    U-Net runs cuDNN's float32 convs and no kernel of this package, on
    JAX too: every wrapper's count stays 0."""
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    argv = unet_argv(H, W)
    echo_benchmark(["--what", "inference", *argv, "--iters", "50"], device)
    echo_benchmark(["--what", "rollout", *argv, "--steps", "200"], device)
    rec = echo_train_benchmark([*argv, "--iters", "10"], device)
    peak = rec["peak_memory_bytes"]
    print(f"unet train step {H}x{W} B=8: {rec['value']} ms, "
          f"{rec['samples_per_s']} samples/s, peak "
          + (f"{peak / 2**30:.2f} GiB" if peak else "not measured"))
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    check_unet_rollout(unet_model(H, W, device), grid, steps, device)
    check_unet_gradients(H, W, device)
    got = {k: fn.launches for k, fn in counters.items()}
    if any(got.values()):
        raise AssertionError(f"the U-Net launched kernels: {got}")
    print(f"unet: kernel launches {got} (cuDNN's convs, as JAX runs XLA's), "
          f"{time.perf_counter() - t0:.1f} s")


# phase 10: the flagship through the port's rollout CLI at 128×506, its
# seeded weights written once as a port Trainer checkpoint (epoch 0 of a
# two-line loss log) so that every leg reads the same weights
DRIVER_ARGV = ["-raq", "3.0", "-fkt", "1e8", "-fkp", "10", "-l", "5", "-f",
               "16", "-r", "6", "-k", "5", "-s", "0", "-pad", "learned",
               "-init", "perfect"]
DRIVER_STEPS = {"torch": 2000, "native": 20, "gaia": 3, "ml_pre": 5}
# the CLI's chunked rollout against one multi_step of the same length from
# the same T0 and weights (the same kernels in the same order: bitwise
# unless a kernel's sums are not repeatable)
TOL_DRIVER_T = 1e-6
RUN_FILES = ("Gaia.ini", "ml_prof.txt", "snapshots_{m}.pkl", "T_vec_{m}.pkl",
             "t_vec_{m}.pkl", "TS_vec_{m}.pkl")


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _launched(counters, want, name):
    """The counts since :func:`_zero` must be ``want`` (the others 0)."""
    got = {k: fn.launches for k, fn in counters.items()}
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{name}: launches {got}, want {full}")
    return got


def driver_checkpoint(nn_dir, device="cuda"):
    """The flagship's seed-0 weights as the port Trainer writes them:
    ``0_fluidnet_uvp.ckpt`` beside a two-epoch ``fluidnet_uvpT.txt`` (the
    CLI then loads epoch 0, the second-to-last)."""
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.train.trainer import LOG_HEADER
    from pbml_mantle_convection_tpu_torch.utils.checkpoint import (
        save_checkpoint)
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                        r_p="learned", loss_type="curl", repeats=6, f=5,
                        p_pred=False, seed=0, device=device)
    save_checkpoint(os.path.join(nn_dir, "0_fluidnet_uvp.ckpt"),
                    {"model": model.state_dict(), "epoch": 0})
    with open(os.path.join(nn_dir, "fluidnet_uvpT.txt"), "w") as f:
        f.write(LOG_HEADER + "".join(f"{e},[1.0, 1.0],[1.0, 1.0],0.001\n"
                                     for e in range(2)))


def driver_leg(counters, name, argv, out_dir, want):
    """One run of ``cli/rollout.py::main(argv)`` into ``out_dir``: every
    count set to 0 just before it and read just after; the counts must be
    ``want`` (the others 0) and the run directory must hold the six
    files. Returns (main's result, the run directory, its pickles)."""
    from pbml_mantle_convection_tpu_torch.cli import rollout
    from pbml_mantle_convection_tpu_torch.utils.checkpoint import load_pickle
    _zero(counters)
    t0 = time.perf_counter()
    out = rollout.main(argv + ["--out_dir", out_dir])
    wall = time.perf_counter() - t0
    got = _launched(counters, want, f"drivers ({name})")
    runs = os.listdir(out_dir)
    if len(runs) != 1:
        raise AssertionError(f"drivers ({name}): run directories {runs}")
    run = os.path.join(out_dir, runs[0])
    mode = argv[argv.index("-m") + 1]
    missing = [f.format(m=mode) for f in RUN_FILES
               if not os.path.isfile(os.path.join(run, f.format(m=mode)))]
    if missing:
        raise AssertionError(f"drivers ({name}): {run} lacks {missing}")
    pk = {k: load_pickle(os.path.join(run, f"{k}_{mode}.pkl"))
          for k in ("T_vec", "t_vec", "TS_vec", "snapshots")}
    print(f"drivers ({name}): {runs[0]}, launches {got}, {wall:.1f} s")
    return out, run, pk


def run_drivers(counters, bench_sps, device="cuda", steps=DRIVER_STEPS):
    """Phase 10: the drivers on the card (``cli/rollout.py``,
    ``sim/rollout.py``, ``cli/analyze.py``), the flagship at 128×506,
    float32, seeded weights through ``--nn_dir``:
    (a) ML_STOKES through ``rollout_torch``, 2000 steps in chunks of 10:
    4 + 1 + 1 + 0 launches per step (the warm-up step included in the
    count), 2000 finite T_vec values, the final T against one
    ``SimEngine.multi_step`` of 2000 steps (≤ TOL_DRIVER_T; bitwise
    printed), steps/s from sum(TS_vec) beside ``bench_sps`` (phase 3's
    ``bench_torch.py`` figure of the same run);
    (b) ``--engine native`` (the C++ engine on the host, the surrogate on
    the card), 20 steps: 4 + 1 + 0 + 1 per step, the mean T of every step
    and the kept fields finite and in [0, 2];
    (c) ``-m GAIA`` (the C++ urf_mm momentum solve), 3 steps, no launch;
    (d) ML_PRE through ``rollout_torch``, 5 steps: 4 + 1 + 0 + 1 per step;
    (e) ``cli/analyze.py`` over (c) and (b), (c) the baseline: a row each,
    finite Pearson values. The counts stay out of the kernels line."""
    import tempfile
    import torch
    from pbml_mantle_convection_tpu_torch.cli import analyze, rollout
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.rollout import WARMUP_STEPS
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        nn_dir = os.path.join(root, "nn")
        driver_checkpoint(nn_dir, device)
        argv = DRIVER_ARGV + ["--nn_dir", nn_dir, "--device", device]

        # (a) ML_STOKES on the card
        n = steps["torch"]
        argv_a = ["-m", "ML_STOKES", *argv, "--max_steps", str(n)]
        state, run_a, pk = driver_leg(
            counters, "a: ML_STOKES", argv_a, os.path.join(root, "a"),
            rollout_launches(1, n + WARMUP_STEPS))
        T_vec = np.asarray(pk["T_vec"])
        if T_vec.shape != (n,) or not np.isfinite(T_vec).all():
            raise AssertionError(f"drivers (a): T_vec {T_vec.shape}, "
                                 f"finite {np.isfinite(T_vec).all()}")
        if len(pk["snapshots"]["T"]) != n // max(1, n // 200):
            raise AssertionError("drivers (a): snapshots "
                                 f"{len(pk['snapshots']['T'])}")
        grid = Grid()
        args = rollout.build_parser().parse_args(argv_a)
        apply_fn = rollout.build_surrogate(args, grid, torch.device(device))
        eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                    apply_fn, cn_max=0.99, device=device))
        T0 = rollout.initial_temperature(grid, 3.0, 1e8, 10.0, "perfect")
        ref, _ = eng.multi_step(
            eng.init_state(torch.as_tensor(T0, dtype=torch.float32)[None]),
            n)
        err = float((state.T - ref.T).abs().max())
        print(f"drivers (a): final T vs one multi_step({n}) max_abs_err="
              f"{err:.3e} (tol {TOL_DRIVER_T}), bitwise "
              f"{bool(torch.equal(state.T, ref.T))}")
        if not err <= TOL_DRIVER_T:
            raise AssertionError(f"drivers (a): final T off by {err:.3e}")
        sps = n / float(np.sum(pk["TS_vec"]))
        print(f"drivers (a): {sps:.2f} steps/s from sum(TS_vec) ({n} steps "
              f"in chunks of {max(1, n // 200)}), bench_torch.py 128x506 "
              f"{bench_sps} steps/s in this run ({sps / bench_sps:.3f} of "
              f"it)")

        # (b) the native engine, the surrogate on the card
        n = steps["native"]
        out_b, run_b, pk = driver_leg(
            counters, "b: --engine native",
            ["-m", "ML_STOKES", *argv, "--engine", "native",
             "--max_steps", str(n)], os.path.join(root, "b"),
            {"layer_stack": 4 * n, "trunk": n,
             "advect_diffuse_step_fused": n})
        # the mean T of every step (a NaN or inf anywhere shows in it) and
        # every field the run kept
        T_vec = np.asarray(out_b[3])
        kept = np.stack(out_b[2]["T"])
        if (out_b[1] != n or not np.isfinite(T_vec).all()
                or not np.isfinite(kept).all() or T_vec.min() < 0.0
                or T_vec.max() > 2.0 or kept.min() < 0.0 or kept.max() > 2.0):
            raise AssertionError(f"drivers (b): {out_b[1]} steps, mean T "
                                 f"{T_vec.min()}..{T_vec.max()}, kept T "
                                 f"{kept.min()}..{kept.max()}")
        print(f"drivers (b): {1e3 * np.mean(out_b[5]):.2f} ms/step, median "
              f"{1e3 * np.median(out_b[5]):.2f} (the native engine on the "
              f"host, the surrogate on the card), mean T {T_vec[-1]:.6f}")

        # (c) GAIA: the native engine alone
        n = steps["gaia"]
        out_c, run_c, _ = driver_leg(
            counters, "c: GAIA",
            ["-m", "GAIA", *argv, "--max_steps", str(n)],
            os.path.join(root, "c"), {})
        if out_c[1] != n or not np.isfinite(out_c[3]).all():
            raise AssertionError(f"drivers (c): {out_c[1]} steps")
        print(f"drivers (c): {1e3 * np.mean(out_c[5]):.1f} ms/step, median "
              f"{1e3 * np.median(out_c[5]):.1f} (the C++ urf_mm momentum "
              f"solve, {n} steps)")

        # (d) ML_PRE on the card
        n = steps["ml_pre"]
        w = n + WARMUP_STEPS
        _, _, pk = driver_leg(
            counters, "d: ML_PRE",
            ["-m", "ML_PRE", *argv, "--max_steps", str(n)],
            os.path.join(root, "d"),
            {"layer_stack": 4 * w, "trunk": w,
             "advect_diffuse_step_fused": w})
        if not np.isfinite(pk["T_vec"]).all():
            raise AssertionError("drivers (d): T_vec not finite")
        print(f"drivers (d): {1e3 * np.mean(pk['TS_vec']):.2f} ms/step, "
              f"median {1e3 * np.median(pk['TS_vec']):.2f}")

        # (e) the analysis CLI, (c) as the baseline
        rows = analyze.main([run_c, run_b, "--truth", run_c])
        if len(rows) != 2 or not all(np.isfinite(r["pearson_T"])
                                     for r in rows):
            raise AssertionError(f"drivers (e): rows {rows}")
    print(f"drivers: {time.perf_counter() - t_phase:.1f} s (launch counts "
          f"kept out of the kernels line)")


# ROADMAP §3 fault 7, repaired: the flagship's train-step gradients against
# float64, at B = 2 and at the production batch B = 8, weight seeds 0-2
TOL_FAULT7 = 1e-5


def fault7_readings(device="cuda", H=128, W=506):
    """Phase 8a (fault 7): one train step of the flagship (levels 5, c_h
    16, repeats 6) at H × W for B = 2 and 8 and weight seeds 0, 1, 2, its
    parameter gradients against the same step in float64: each reading
    ≤ TOL_FAULT7 (merge-1's band convs take their weight gradients off
    cuDNN, ``models/layers.py::conv2d_routed``), with the parameter where the
    error sits."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    for B in (2, 8):
        g = torch.Generator().manual_seed(13)
        x = torch.rand(B, H, W, 7, generator=g).to(device)
        y = torch.randn(B, 2, H, W, generator=g).to(device)
        for seed in (0, 1, 2):
            net = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                              r_p="learned", loss_type="curl", repeats=6,
                              f=5, p_pred=False, seed=seed, device=device)
            rel, want, got = train_gradients(net, x, y, "newfluidnet")
            print(f"fault 7: flagship {H}x{W} B={B} seed {seed}: gradients "
                  f"vs float64 rel={rel:.3e} (tol {TOL_FAULT7}); "
                  f"{worst_parameter(got, want)}")
            if not rel <= TOL_FAULT7:
                raise AssertionError(f"fault 7: B={B} seed {seed}: "
                                     f"{rel:.3e}")
        torch.cuda.empty_cache()


def run_train(counters, device="cuda"):
    """Phase 8: training, through the module path with autograd as JAX
    trains (no kernel of this package has a backward): the gradient
    checks (8a), ``--what train --profile`` for the flagship and the
    Transolver at 128×506, B = 8 (8b), the Trainer, its cv passes
    included (8c); every kernel wrapper's count is 0 over 8b and 8c (8d;
    kept out of the kernels line)."""
    import tempfile
    check_train_gradients(counters, device)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    echo_train_benchmark(["--iters", "20", "--profile"], device)
    echo_train_benchmark(["-net", "transolver_structured", "--iters", "10",
                          "--profile"], device)
    print(f"--what train: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as d:
        run_trainer(d, device=device)
    got = {k: fn.launches for k, fn in counters.items()}
    if any(got.values()):
        raise AssertionError(f"training launched kernels: {got}")
    print(f"training: kernel launches {got} (the module path, as JAX "
          f"trains)")


# phase 11: the other models (ROADMAP queue 1 item 6) at 128×506, float32,
# PyTorch's default flags (cuDNN's TF32 allowed; the port's convs keep
# their float32 guard)
OTHER_ARGV = ["-m", "ML_STOKES", "-raq", "3.0", "-fkt", "1e8", "-fkp", "10",
              "-l", "5", "-f", "16", "-r", "6", "-k", "5", "-pad", "learned"]
OTHER_STEPS = 100
# cli/benchmark.py's other networks: their experiments' widths, train batch
OTHER_BENCH = {"fluidnet": (["-l", "5", "-r", "4"], 8),
               "multiscalenewfluidnet": (["-l", "4", "-r", "4"], 8),
               "vit": ([], 4)}
# the networks of the gradient leg (B = 2): (name, ModelConfig fields)
OTHER_GRAD_NETS = (
    ("symmetric flagship", dict(network="newfluidnet", levels=5, repeats=6,
                                use_symm=True)),
    ("fluidnet -l 5 -r 4", dict(network="fluidnet", levels=5, repeats=4)),
    ("multiscale -l 4 -r 4", dict(network="multiscalenewfluidnet", levels=4,
                                  repeats=4)),
    ("spectral -l 3 -r 2", dict(network="newfluidnet", levels=3, repeats=2,
                                r_p="zeros", spectral_conv=True)),
    ("vit (ModelConfig defaults)", dict(network="vit")))
# the weight seeds each network of the gradient leg is read at
OTHER_GRAD_SEEDS = (0, 1, 2)


def other_gradients(name, fields, seed, x, y, device, H, W):
    """Phase 11 (e) for one network and weight seed: the train step's
    parameter gradients against float64 (the step with cuDNN off beside
    them at seed 0), held to TOL_TRAIN_GRAD; a reading above it passes
    only where :func:`locate_kink` finds a loss kink crossed by rounding
    (ROADMAP §3 fault 10)."""
    t0 = time.perf_counter()
    legs = ("step", "no_cudnn") if seed == 0 else ("step",)
    out = {leg: train_gradients(other_model(fields, device, seed, H, W), x,
                                y, fields["network"], leg) for leg in legs}
    rel = out["step"][0]
    beside = (f"; cuDNN off rel={out['no_cudnn'][0]:.3e}" if seed == 0
              else "")
    print(f"other models (e): train step {name} seed {seed} {H}x{W} B=2 at "
          f"default flags: parameter gradients vs float64 rel={rel:.3e} "
          f"(tol {TOL_TRAIN_GRAD}){beside}, "
          f"{time.perf_counter() - t0:.1f} s")
    for leg in legs:
        print(f"  {leg}: {worst_parameter(out[leg][2], out[leg][1])}")
    if rel <= TOL_TRAIN_GRAD:
        return
    last = {"multiscalenewfluidnet": "nets_0.conv_3",
            "vit": "vit.Dense_1"}.get(fields["network"], "conv_3")
    k = locate_kink(other_model(fields, device, seed, H, W), x, y,
                    fields["network"], last)
    print(f"  above the bound: {json.dumps(k)}")
    if k["verdict"] != "kink":
        raise AssertionError(f"(e) {name} seed {seed}: gradients {rel:.3e}, "
                             f"not a loss kink: {k['verdict']}")
    print(f"  {name} seed {seed}: a loss kink crossed by rounding: "
          f"{k['n_flips']} abs() argument(s) within {k['flip_arg_rel']:.3e} "
          f"of their term's max from 0 change sign and account for the "
          f"output gradient's difference but {k['unexplained_rel']:.3e}; "
          f"the backward given float32's output gradient reads "
          f"{k['fed_vs_f32_rel']:.3e} (tol {TOL_TRAIN_GRAD})")


def other_model(fields, device="cuda", seed=0, H=128, W=506):
    """The registry's model of ``fields`` (c_h 16, k 5, learned padding,
    curl, a_bound 10: ModelConfig's defaults otherwise) at H × W."""
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    return build_model(ModelConfig(**{"H": H, "W": W, **fields}), seed=seed,
                       device=device)


def module_vs_f64(name, net, x):
    """u, v of ``net`` on ``x`` against a float64 copy, rel to max |f64|;
    raises above TOL_MODULE_F64."""
    import copy
    import torch
    with torch.no_grad():
        got = net(x)
        ref = copy.deepcopy(net).double()(x.double())
    rel = max(rel_err(a.double(), b)[1] for a, b in zip(got[:2], ref[:2]))
    print(f"other models: {name} forward u, v vs float64 rel={rel:.3e} "
          f"(tol {TOL_MODULE_F64})")
    if not rel <= TOL_MODULE_F64:
        raise AssertionError(f"{name}: forward vs float64 {rel:.3e}")
    return rel


def run_other_models(counters, bench_sps, device="cuda", steps=OTHER_STEPS,
                     blurr_steps=500, bench_steps=100, H=128, W=506):
    """Phase 11: the other models on the card at 128×506, float32, under
    PyTorch's default flags:
    (a) ``cli/rollout.py`` with the parser's default ``-s 1`` (the
    symmetric flagship, ``-l 5 -f 16 -r 6 -k 5 -pad learned``, seed-0
    weights) for ``steps`` steps: 0 + 0 + 0 + 1 launches per step (the
    module path and the energy kernel; the warm-up step counted), T_vec
    finite, steps/s from sum(TS_vec), the network's forward against
    float64 (≤ TOL_MODULE_F64);
    (b) the ``blurr`` flagship through the fused executor: 4 + 1 + 0 + 1
    per step (the engine takes no fused epilogue: it would skip the
    blur), steps/s over 500 steps beside ``bench_sps`` (phase 3's
    flagship), 10 steps against its module path (TOL_ROLLOUT);
    (c) ``cli/benchmark.py --what inference|rollout|train`` for FluidNet
    (-l 5 -r 4), the multi-scale ensemble (-l 4 -r 4) and the ViT
    (ModelConfig defaults), train at B = 8 (the ViT at B = 4, its
    experiment's batch), their JSON lines echoed; each rollout 0 + 0 + 0
    + 1 per step, inference and training no launch;
    (d) the spectral NewFluidNet at ``newfluidnet_spectral``'s widths
    (-l 3 -f 16 -r 2 -pad zeros): a forward against float64 (cuFFT);
    (e) train-step parameter gradients against float64 at B = 2 and
    weight seeds 0-2 (≤ TOL_TRAIN_GRAD; :func:`other_gradients`), with
    the step with cuDNN off beside them at seed 0, and the parameter
    where each error sits: the symmetric flagship, FluidNet, the
    ensemble, the spectral network and the ViT; no launch;
    (f) one train step with dropout 0.1 (the flagship) from a generator:
    the same seed gives the same loss and masks, another seed another.
    The counts stay out of the kernels line. Leaves the flags as it found
    them. (a) and (b) run on the CLI's grid, 128×506; ``H``, ``W`` size
    (c)-(f), and with the step counts make a CPU rehearsal small (pass an
    empty ``counters``: the CPU wrappers count nothing)."""
    import copy
    import tempfile

    import torch
    from pbml_mantle_convection_tpu_torch.cli import rollout
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.rollout import WARMUP_STEPS
    from pbml_mantle_convection_tpu_torch.sim.stepper import (
        TimeStepper, assemble_fluidnet_input)
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_train_step)
    from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
    from pbml_mantle_convection_tpu_torch.utils.checkpoint import load_pickle

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32

    def pytorch_flags():
        # cli/benchmark.py turns TF32 off for its runs
        cudnn.allow_tf32, matmul.allow_tf32 = True, False

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    pytorch_flags()
    t_phase = time.perf_counter()
    grid = Grid()
    params = SimParams(3.0, 1e8, 10.0)
    try:
        # (a) the rollout CLI at its default -s 1
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            argv = OTHER_ARGV + ["--max_steps", str(steps), "--device",
                                 device, "--out_dir", d]
            _zero(counters)
            rollout.main(argv)
            got = _launched(counters, {"advect_diffuse_step_fused":
                                       steps + WARMUP_STEPS}, "(a) -s 1")
            run = os.path.join(d, os.listdir(d)[0])
            T_vec = np.asarray(load_pickle(os.path.join(
                run, "T_vec_ML_STOKES.pkl")))
            TS = np.asarray(load_pickle(os.path.join(
                run, "TS_vec_ML_STOKES.pkl")))
        if T_vec.shape != (steps,) or not np.isfinite(T_vec).all():
            raise AssertionError(f"(a) T_vec {T_vec.shape}")
        print(f"other models (a): cli/rollout.py -s 1 (default) -l 5 -f 16 "
              f"-r 6, {steps} steps: {steps / TS.sum():.2f} steps/s from "
              f"sum(TS_vec), launches {got} = 0+0+0+1 per step, mean T "
              f"{T_vec[-1]:.6f}, {time.perf_counter() - t0:.1f} s")
        args = rollout.build_parser().parse_args(argv)
        net = rollout.build_surrogate(args, grid, torch.device(device))
        if not (isinstance(net, NewFluidNet) and net.use_symm):
            raise AssertionError(f"(a) the CLI built {type(net).__name__}")
        st = TimeStepper(grid, params, net, device=device)
        T0 = rollout.initial_temperature(grid, 3.0, 1e8, 10.0, "hot")
        x, _ = assemble_fluidnet_input(
            torch.as_tensor(T0, dtype=torch.float32, device=device)[None],
            st.static, params)
        module_vs_f64("(a) symmetric flagship", net, x)

        # (b) the blurr flagship through the fused executor
        t0 = time.perf_counter()
        blurr = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                            r_p="learned", loss_type="curl", repeats=6, f=5,
                            p_pred=False, blurr=True, seed=0, device=device)
        T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(6.28 * grid.xc),
                     0.0, 1.0)[None]
        engines = [SimEngine(TimeStepper(grid, params, fn, cn_max=0.99,
                                         device=device))
                   for fn in (FastNewFluidNet(blurr, 128, 506), blurr)]
        if engines[0]._epi is not None:
            raise AssertionError("(b) the fused epilogue would skip blurr")
        eng = engines[0]
        n = blurr_steps
        state, _ = eng.multi_step(eng.init_state(T0), min(n, 20))  # warm-up
        sync()
        _zero(counters)
        t1 = time.perf_counter()
        state, _ = eng.multi_step(state, n)
        sync()
        sps = n / (time.perf_counter() - t1)
        got = _launched(counters, {"layer_stack": 4 * n, "trunk": n,
                                   "advect_diffuse_step_fused": n},
                        "(b) blurr")
        if not bool(torch.isfinite(state.T).all()):
            raise AssertionError("(b) T not finite")
        print(f"other models (b): blurr flagship through the fused "
              f"executor: {sps:.2f} steps/s over {n} steps (phase 3's "
              f"flagship {bench_sps} in this run, {sps / bench_sps:.3f} of "
              f"it), launches {got} = 4+1+0+1 per step")
        k = min(n, 10)
        finals = [e.multi_step(e.init_state(T0), k)[0] for e in engines]
        for f in ("T", "u", "v"):
            err, rel = rel_err(getattr(finals[0], f), getattr(finals[1], f))
            print(f"other models (b): {k} steps kernel vs module path: {f} "
                  f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
                  f"{TOL_ROLLOUT[f]})")
            if not rel <= TOL_ROLLOUT[f]:
                raise AssertionError(f"(b) blurr kernel path: {f} {rel}")
        print(f"  {time.perf_counter() - t0:.1f} s")
        del engines, eng, blurr

        # (c) the benchmark CLI
        for net_name, (widths, batch) in OTHER_BENCH.items():
            t0 = time.perf_counter()
            argv = ["-net", net_name, *widths, "--H", str(H), "--W", str(W)]
            _zero(counters)
            echo_benchmark(["--what", "inference", "--iters", "50", *argv],
                           device)
            _launched(counters, {}, f"(c) {net_name} inference")
            n = bench_steps
            _zero(counters)
            echo_benchmark(["--what", "rollout", "--steps", str(n), *argv],
                           device)
            _launched(counters, {"advect_diffuse_step_fused": n + min(n, 20)},
                      f"(c) {net_name} rollout")
            _zero(counters)
            echo_train_benchmark(["--batch", str(batch), "--iters", "5",
                                  *argv], device)
            _launched(counters, {}, f"(c) {net_name} train")
            pytorch_flags()
            print(f"other models (c): {net_name}: launches per rollout step "
                  f"0+0+0+1, none in inference or training, "
                  f"{time.perf_counter() - t0:.1f} s")

        # (d) the spectral network on cuFFT
        g = torch.Generator().manual_seed(21)
        x = torch.rand(1, H, W, 7, generator=g).to(device)
        module_vs_f64("(d) spectral -l 3 -f 16 -r 2 -pad zeros",
                      other_model(OTHER_GRAD_NETS[3][1], device, H=H, W=W),
                      x)

        # (e) train-step gradients against float64, B = 2
        x = torch.rand(2, H, W, 7, generator=g).to(device)
        y = torch.randn(2, 2, H, W, generator=g).to(device)
        _zero(counters)
        for name, fields in OTHER_GRAD_NETS:
            for seed in OTHER_GRAD_SEEDS:
                other_gradients(name, fields, seed, x, y, device, H, W)
            if device == "cuda":
                torch.cuda.empty_cache()
        _launched(counters, {}, "(e) train steps")

        # (f) dropout from the step's generator
        net = other_model(dict(network="newfluidnet", levels=5, repeats=6,
                               drop_rate=0.1), device, H=H, W=W)
        cfg = TrainStepConfig(net="newfluidnet", loss_scale=True,
                              loss_derivative=True, loss_type="curl",
                              drop_rate=0.1)
        losses = []
        for seed in (5, 5, 6):
            m = copy.deepcopy(net)
            gen = torch.Generator(device=device).manual_seed(seed)
            br = make_train_step(m, adam_l2(m.parameters(), 1e-3), cfg,
                                 generator=gen)({"x": x, "y": y})
            losses.append(br.stack().cpu())
        same = bool(torch.equal(losses[0], losses[1]))
        print(f"other models (f): a dropout 0.1 train step of the flagship "
              f"from a generator on the device: losses {losses[0][0]:.6e} (seed 5), "
              f"{losses[1][0]:.6e} (seed 5 again, equal: {same}), "
              f"{losses[2][0]:.6e} (seed 6)")
        if not same or torch.equal(losses[0], losses[2]):
            raise AssertionError(f"(f) dropout losses {losses}")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    print(f"other models: {time.perf_counter() - t_phase:.1f} s (launch "
          f"counts kept out of the kernels line)")


# phase 12: sharded rollouts, sequence-parallel attention, distributed
# checkpoints, bfloat16
PAR_STEPS = 500          # the --sharded CLI's steps per call
PAR_CHECK_STEPS = 20     # steps of the bitwise checks
PAR_B = 4
# sharded Physics-Attention against the unsharded kernel path at the
# serving shape, max |diff| / max |unsharded|: the same float32 sums, the
# pooled ones added across ranks in another order
TOL_SHARDED_ATTN = 1e-5
# the bfloat16 serving Transolver's stream function (the last block's
# output) against the float32 kernel path, relative to max |psi|: bfloat16
# keeps 8 bits (2^-8 = 3.9e-3 per rounding) through 5 blocks (2.3e-2 and
# 2.4e-2 on the CPU at 32x48 and 64x128); u and v, central differences of
# psi much smaller than psi's bfloat16 ulp, are printed, not bounded
TOL_BF16_PSI = 5e-2
# the zero-padded flagship's bfloat16 inference on the executor (float32
# kernels on the bfloat16 weights) against the float32 module on the same
# weights, relative to max |psi|: the layer kernels' bound (TOL); the
# bfloat16 module's psi is printed beside it (6.8e-2 off the executor's
# on the CPU at 128x506; the executor 1.0e-5 off the float32 module)
TOL_BF16_EXECUTOR = 1e-4
SERVING_ATTN = dict(heads=8, dim_head=16, slice_num=32)


def serving_attention(device, seed=0, N=128 * 506):
    """The serving Transolver's Physics-Attention at its width (8 heads,
    D = 16, G = 32; irregular-mesh projections) and a seeded (1, N, 128)
    input."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.transolver import (
        PhysicsAttentionIrregularMesh)
    a = SERVING_ATTN
    m = PhysicsAttentionIrregularMesh(
        a["heads"] * a["dim_head"], np.random.default_rng(seed),
        **a).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(1, N, a["heads"] * a["dim_head"], generator=g,
                    device=device)
    return m, x


def attention_rank(rank, world, port, out, device="cuda", N=128 * 506):
    """One rank of phase 12 (c)'s two gloo ranks sharing the card: its
    half of the points through ``physics_attention_sharded`` (one
    ``slice_pool`` and one ``slice_deslice`` launch), the halves gathered;
    rank 0 writes the error against the unsharded kernel path and the
    launch counts to ``out``."""
    import torch
    import torch.distributed as dist
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice, slice_pool)
    from pbml_mantle_convection_tpu_torch.parallel.mesh import (
        gather_rows, shard_batch)
    from pbml_mantle_convection_tpu_torch.parallel.sequence import (
        physics_attention_sharded)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        m, x = serving_attention(device, N=N)
        a = SERVING_ATTN
        local = shard_batch(dist.group.WORLD, x.transpose(0, 1)
                            ).transpose(0, 1)
        with torch.no_grad():
            physics_attention_sharded(m, local, dist.group.WORLD,
                                      a["heads"], a["dim_head"])
            slice_pool.launches = slice_deslice.launches = 0
            y = physics_attention_sharded(m, local, dist.group.WORLD,
                                          a["heads"], a["dim_head"])
            launches = [slice_pool.launches, slice_deslice.launches]
            y = gather_rows(dist.group.WORLD, y, dim=1)
            ref = m(x)
        err, rel = rel_err(y, ref)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"max_abs_err": err, "rel": rel,
                           "launches": launches,
                           "n_local": int(local.shape[1])}, f)
    finally:
        dist.destroy_process_group()


def run_attention_ranks(world=2, device="cuda", N=128 * 506):
    """Phase 12 (c)'s gloo ranks as processes of this script; returns
    rank 0's record."""
    import socket
    import tempfile
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--attention-rank",
             str(r), str(world), str(port), out, device, str(N)])
            for r in range(world)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if codes != [0] * world:
            raise AssertionError(f"attention ranks exited {codes}")
        with open(out) as f:
            return json.load(f)


def check_bf16_zero_executor(counters, device, H, W, iters, grid_argv):
    """Phase 12 (e): ``--what inference -pad zeros --dtype bfloat16``
    runs the fused executor as JAX's CLI does, in float32 on the bfloat16
    weights (``FastNewFluidNet.float32_of``): 4 ``layer_stack`` + 1
    ``trunk`` launches per forward, timed beside the float32 CLI run;
    then its stream function against the float32 module on the same
    weights (``TOL_BF16_EXECUTOR``), and the bfloat16 module's printed
    beside it."""
    import torch
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    fwd = iters + 1                          # the CLI's warm-up pass
    ms = {}
    for dt in ("float32", "bfloat16"):
        _zero(counters)
        ms[dt] = echo_benchmark(["--what", "inference", "-pad", "zeros",
                                 "--dtype", dt, "--iters", str(iters)]
                                + grid_argv, device)["value"]
        _launched(counters, {"layer_stack": 4 * fwd, "trunk": fwd},
                  f"(e) -pad zeros inference in {dt}")
    # the CLI's model (its defaults: -l 5 -f 16 -r 6 -k 5)
    zm = build_model(ModelConfig(network="newfluidnet", levels=5, c_h=16,
                                 repeats=6, kernel=5, r_p="zeros",
                                 loss_type="curl", p_pred=False, H=H, W=W,
                                 dtype=torch.bfloat16), device=device)
    x = transolver_input(H, W, device).reshape(1, H, W, -1).to(
        torch.bfloat16)
    psi = {}
    with torch.no_grad():
        ex = FastNewFluidNet.float32_of(zm, H, W)
        psi["executor"] = ex.psi(x[0].float().permute(2, 0, 1)
                                 .contiguous())[0]
        for name, m, xm in (("float32", ex.m, x.float()),
                            ("bfloat16", zm, x)):
            hook = m.conv_3.register_forward_hook(
                lambda mod, inp, o, name=name: psi.__setitem__(
                    name, o[0, 0].float()))
            m(xm)
            hook.remove()
    err, rel = rel_err(psi["executor"], psi["float32"])
    rel16 = rel_err(psi["bfloat16"], psi["executor"])[1]
    print(f"parallel (e) bf16 -pad zeros inference through the executor: "
          f"{ms['bfloat16']} ms per forward (float32 {ms['float32']} ms, "
          f"same call), 4 + 1 launches per forward; psi rel {rel:.3e} (max "
          f"abs {err:.3e}, tol {TOL_BF16_EXECUTOR}) against the float32 "
          f"module on the same weights, the bfloat16 module's rel "
          f"{rel16:.3e}")
    if not rel <= TOL_BF16_EXECUTOR:
        raise AssertionError(f"(e) bf16 zero executor psi rel {rel}")


def run_parallel(counters, bench_sps, device="cuda", steps=PAR_STEPS,
                 H=128, W=506, iters=20):
    """Phase 12, at 128×506 (module doc). Returns the kernel launches of
    its main-path runs, (a) and (b), by kernel."""
    import socket
    import tempfile

    import torch
    import torch.distributed as dist
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice, slice_pool)
    from pbml_mantle_convection_tpu_torch.parallel.rollout import (
        make_batch_sharded)
    from pbml_mantle_convection_tpu_torch.parallel.sequence import (
        physics_attention_sharded)
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_train_step)
    from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
    from pbml_mantle_convection_tpu_torch.utils.checkpoint import (
        restore_checkpoint_distributed, save_checkpoint_distributed)
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {**counters, "slice_pool": slice_pool,
                "slice_deslice": slice_deslice}
    launch = {k: 0 for k in counters}
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    # the NCCL world of one: the CLI's mesh is this group
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
        rank=0, world_size=1,
        **({"device_id": torch.device(device, 0)} if cuda else {}))
    group = dist.group.WORLD
    try:
        # (a) --sharded at B = 1 and 4, each simulation 4 + 1 + 1 + 0
        for B in (1, PAR_B):
            _zero(counters)
            rec = echo_benchmark(["--what", "rollout", "--sharded", "--batch",
                                  str(B), "--steps", str(steps), "--H",
                                  str(H), "--W", str(W)], device)
            sim_steps = 2 * B * steps                # warm-up + timed
            want = rollout_launches(1, sim_steps)
            got = _launched(counters, want, f"(a) --sharded B={B}")
            for k in launch:
                launch[k] += got[k]
            print(f"parallel (a) --sharded B={B}: {rec['value']} "
                  f"sim-steps/s over {rec['n_devices']} "
                  f"{dist.get_backend()} rank "
                  f"({rec['rollout_steps_per_s']} rollout steps/s), phase "
                  f"3's main path {bench_sps:.1f} steps/s "
                  f"({rec['value'] / bench_sps:.3f} of it); launches "
                  f"{ {k: got[k] / sim_steps for k in want} } per "
                  f"simulation-step")
        model, fast, _, _ = flagship(H, W, device)
        from pbml_mantle_convection_tpu_torch.cli.benchmark import (
            initial_temperature)
        from pbml_mantle_convection_tpu_torch.constants import SimParams
        from pbml_mantle_convection_tpu_torch.sim.grid import Grid
        grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))

        def engine(g=None):
            return SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                         fast, cn_max=0.99, device=device),
                             process_group=g)

        T0 = initial_temperature(grid, PAR_B)
        K = PAR_CHECK_STEPS
        out = make_batch_sharded(engine(), K, group)(T0)
        eng = engine()
        same = []
        for b in range(PAR_B):
            st, tr = eng.multi_step(eng.init_state(T0[b:b + 1]), K)
            same.append(bool(torch.equal(out[0][b], st.T[0]))
                        and bool(torch.equal(out[5][b], st.t)))
        print(f"parallel (a) per-simulation rollout, {PAR_B} simulations x "
              f"{K} steps: final T and t bitwise equal to standalone B = 1 "
              f"multi_step runs: {same}")
        if not all(same):
            raise AssertionError("(a) sharded rollout differs from B = 1")

        # (b) the coupled rollout over the group (one dt all-reduced per
        # step; the energy kernel with the given dt) vs the batched one
        _zero(counters)
        ec = engine(group)
        sc, tc = ec.multi_step(ec.init_state(T0), K)
        got = _launched(counters, rollout_launches(PAR_B, K),
                        "(b) coupled rollout")
        for k in launch:
            launch[k] += got[k]
        eb = engine()
        sb, tb = eb.multi_step(eb.init_state(T0), K)
        same_T = bool(torch.equal(sc.T, sb.T))
        same_dt = bool(torch.equal(tc.dt, tb.dt))
        print(f"parallel (b) coupled B={PAR_B} over the "
              f"{dist.get_backend()} group, {K} steps ({4 * PAR_B} + "
              f"{PAR_B} + 0 + 1 launches per step): final T bitwise equal to the batched rollout: {same_T}, "
              f"dt trace: {same_dt}, mean-T trace rel "
              f"{rel_err(tc.mean_T, tb.mean_T)[1]:.3e}")
        if not (same_T and same_dt):
            raise AssertionError("(b) coupled rollout differs from batched")

        # (c) sequence-parallel attention at the serving shape
        m, x = serving_attention(device, N=H * W)
        a = SERVING_ATTN
        with torch.no_grad():
            ref = m(x)
            _zero(counters)
            y = physics_attention_sharded(m, x, group, a["heads"],
                                          a["dim_head"])
            got = _launched(counters, {"slice_pool": 1, "slice_deslice": 1},
                            "(c) sharded attention")
            sharded_ms = cuda_ms(lambda: physics_attention_sharded(
                m, x, group, a["heads"], a["dim_head"]))
            alone_ms = cuda_ms(lambda: physics_attention_sharded(
                m, x, None, a["heads"], a["dim_head"]))
            num = torch.zeros(1, a["heads"], a["slice_num"], a["dim_head"],
                              device=device)
            den = torch.zeros(1, a["heads"], a["slice_num"], device=device)
            ar_ms = cuda_ms(lambda: (dist.all_reduce(num, group=group),
                                     dist.all_reduce(den, group=group)))
            module_ms = cuda_ms(lambda: m(x))
        err, rel = rel_err(y, ref)
        print(f"parallel (c) physics_attention_sharded at N={x.shape[1]}, "
              f"8 heads, D=16, G=32, 1 {dist.get_backend()} rank: rel "
              f"{rel:.3e} (max abs {err:.3e}, tol {TOL_SHARDED_ATTN}) "
              f"against the unsharded "
              f"kernel path, launches {got}; {sharded_ms:.4f} ms with the "
              f"two all-reduces, {alone_ms:.4f} ms without, the module "
              f"{module_ms:.4f} ms; the two all-reduces alone "
              f"{ar_ms:.4f} ms")
        if not rel <= TOL_SHARDED_ATTN:
            raise AssertionError(f"(c) sharded attention rel {rel}")
        r2 = run_attention_ranks(2, device, H * W)
        print(f"parallel (c) two gloo ranks sharing the card, "
              f"{r2['n_local']} points each: rel {r2['rel']:.3e} (max abs "
              f"{r2['max_abs_err']:.3e}), launches per rank per call "
              f"(slice_pool, slice_deslice) {r2['launches']}")
        if not (r2["rel"] <= TOL_SHARDED_ATTN and r2["launches"] == [1, 1]):
            raise AssertionError(f"(c) two ranks: {r2}")

        # (d) distributed checkpoint of the flagship's train state
        opt = adam_l2(model.parameters(), 1e-3)
        cfg = TrainStepConfig(loss_scale=True, loss_derivative=True,
                              loss_type="curl")
        gen = torch.Generator(device=device).manual_seed(4)
        make_train_step(model, opt, cfg)(
            {"x": torch.rand(1, H, W, 7, generator=gen, device=device),
             "y": torch.randn(1, 2, H, W, generator=gen, device=device)})
        state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
                 "epoch": 1}
        fresh = flagship(H, W, device)[0]
        opt2 = adam_l2(fresh.parameters(), 1e-3)
        make_train_step(fresh, opt2, cfg)(
            {"x": torch.zeros(1, H, W, 7, device=device),
             "y": torch.zeros(1, 2, H, W, device=device)})
        target = {"model": fresh.state_dict(),
                  "optimizer": opt2.state_dict(), "epoch": 0}
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_checkpoint_distributed(os.path.join(tmp, "ck"), state,
                                        group)
            t1 = time.perf_counter()
            got = restore_checkpoint_distributed(os.path.join(tmp, "ck"),
                                                 target, group)
            t2 = time.perf_counter()
        pairs = list(zip(model.state_dict().values(),
                         got["model"].values()))
        for k, s in opt.state_dict()["state"].items():
            for n, v in s.items():
                pairs.append((v, got["optimizer"]["state"][k][n]))
        same = all(torch.equal(u, v) for u, v in pairs)
        print(f"parallel (d) distributed checkpoint of the flagship's train "
              f"state ({len(pairs)} tensors): save {t1 - t0:.2f} s, restore "
              f"{t2 - t1:.2f} s into a fresh state, equal: {same}, epoch "
              f"{got['epoch']}")
        if not (same and got["epoch"] == 1):
            raise AssertionError("(d) checkpoint round trip")
    finally:
        dist.destroy_process_group()

    # (e) bfloat16
    _zero(counters)
    rec = echo_benchmark(["--what", "inference", "-net",
                          "transolver_structured", "--dtype", "bfloat16",
                          "--iters", str(iters), "--H", str(H), "--W",
                          str(W)], device)
    fwd = iters + 1                          # the CLI's warm-up pass
    _launched(counters, {"slice_pool": 5 * fwd, "slice_deslice": 5 * fwd},
              "(e) bf16 transolver")
    psi = {}
    for dt in (torch.float32, torch.bfloat16):
        net = build_model(ModelConfig(network="transolver_structured", H=H,
                                      W=W, dtype=dt), device=device)
        hook = net.blocks_4.register_forward_hook(
            lambda mod, inp, o, dt=dt: psi.__setitem__(dt, o.float()))
        with torch.no_grad():
            psi[dt, "uv"] = net(transolver_input(H, W, device).to(dt))
        hook.remove()
    err, rel = rel_err(psi[torch.bfloat16], psi[torch.float32])
    uv = [rel_err(b.float(), a)[1] for a, b in
          zip(psi[torch.float32, "uv"][:2], psi[torch.bfloat16, "uv"][:2])]
    print(f"parallel (e) bf16 transolver_structured serving: {rec['value']} "
          f"ms per forward (float32: 9.16-9.20 ms, PERF.md), 5 + 5 slice "
          f"launches per forward; psi rel {rel:.3e} (tol {TOL_BF16_PSI}) "
          f"against float32, u {uv[0]:.3e}, v {uv[1]:.3e}")
    if not rel <= TOL_BF16_PSI:
        raise AssertionError(f"(e) bf16 transolver psi rel {rel}")
    grid_argv = ["--H", str(H), "--W", str(W)]
    check_bf16_zero_executor(counters, device, H, W, iters, grid_argv)
    _zero(counters)
    echo_benchmark(["--what", "inference", "--raw-module", "--dtype",
                    "bfloat16", "--iters", str(iters)] + grid_argv, device)
    echo_train_benchmark(["--dtype", "bfloat16", "--batch", "8", "--iters",
                          str(max(1, iters // 2))] + grid_argv, device)
    _launched(counters, {}, "(e) bf16 module and train")
    try:
        echo_benchmark(["--what", "rollout", "--dtype", "bfloat16"]
                       + grid_argv, device)
    except TypeError as e:
        print(f"parallel (e) bf16 rollout refused: {e}")
    else:
        raise AssertionError("(e) the bf16 flagship rollout ran")
    print(f"parallel: {time.perf_counter() - t_phase:.1f} s")
    return launch


# phase 13: the layer kernels' instances of each activation
ACT_PADS = ("learned", "zeros")
ACT_WARMUP = 20          # fused steps before the timed ones
ACT_STEPS = 200          # timed fused steps per (activation, padding)
# (c): selu, NewFluidNet's default activation, and relu, which has a kink;
# their T_rmse after this many steps (phase 6 holds the flagship's at 500)
ACT_ACCURACY = ("selu", "relu")
ACT_ACC_STEPS = 200
# sine per layer: a kernel's error against float64 at most this many times
# the plain float32 path's own error (the same decade)
SINE_DECADE = 10.0


def sine_layer_checks(built, H, W, r_p):
    """Phase 13 (a) for ``sine``: each layer of the flagship as its own
    kernel call (R = 1; the branch layers of the five levels grouped as
    on the main path), the stem with its pyramid, the trunk and merges 2
    and 3, each on the float64 chain's input to that layer rounded to
    float32; then the first two layers of each branch as one R = 2 call
    (the activation applied while staging). Each call against its plain
    version in float64: the kernel's error must stay within
    ``SINE_DECADE`` of the plain float32 path's own (one ``sin(30·)``
    turns float32 rounding into ~1e-4 of the output, so float32 against
    float32 says little: recorded beside it). A six-layer ``sine`` stack
    can be chaotic in float32 (module doc of
    tests/test_torch_port_activations.py), so no whole-stack bound.
    Returns {"layer_stack": worst, "trunk": worst}, each {"max_abs_err",
    "rel" (kernel against plain float32), "vs_f64", "plain_vs_f64"}."""
    import copy
    import torch
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        conv_weights)
    from pbml_mantle_convection_tpu_torch.models.layers import (
        fluid_layer_groups)
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (
        layer_stack, layer_stack_plain, layer_stacks, layer_stacks_plain,
        pack_stack)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (
        trunk, trunk_plain, trunk_weights)
    from pbml_mantle_convection_tpu_torch.sim.stepper import viscosity

    model, fast, engine, T0 = built
    eng = engine(fast)
    st, T = eng.stepper, eng.init_state(T0).T
    x = st.executor_input(T, viscosity(T, st.static, st.params))
    m64 = copy.deepcopy(model).double()
    g = fluid_layer_groups(model.c_h)

    def stack(lays, **kw):
        return pack_stack([(*conv_weights(lay.conv), lay.gn.weight,
                            lay.gn.bias) for lay in lays], groups=g,
                          act="sine", **kw)

    def merge(m, conv, gn=None, use_act=True):
        return pack_stack([(*conv_weights(conv),
                            gn.weight if gn is not None else None,
                            gn.bias if gn is not None else None)],
                          groups=max(1, m.c_h // 4) if gn is not None else 1,
                          use_gn=gn is not None, use_act=use_act, act="sine")

    worst = {k: dict(max_abs_err=0.0, rel=0.0, vs_f64=0.0, plain_vs_f64=0.0)
             for k in ("layer_stack", "trunk")}

    def hold(kind, name, kern, plain32, plain64):
        """Holds one call; returns the float64 outputs (the next inputs)."""
        got, p32, p64 = kern(), plain32(), plain64()
        kp = [rel_err(a, b) for a, b in zip(got, p32)]
        err, rel = max(e for e, _ in kp), max(r for _, r in kp)
        ek = max(rel_err(a.double(), b)[1] for a, b in zip(got, p64))
        ep = max(rel_err(a.double(), b)[1] for a, b in zip(p32, p64))
        print(f"sine [{r_p}] {kind} {name}: vs float64: kernel {ek:.3e}, "
              f"plain float32 {ep:.3e} ({ek / ep:.2f}x, bound "
              f"{SINE_DECADE}x); kernel vs plain float32 rel {rel:.3e}")
        if not ek <= SINE_DECADE * ep:
            raise AssertionError(f"sine [{r_p}] {kind} {name} disagrees")
        w = worst[kind]
        w["max_abs_err"] = max(w["max_abs_err"], err)
        w["rel"] = max(w["rel"], rel)
        w["vs_f64"] = max(w["vs_f64"], ek)
        w["plain_vs_f64"] = max(w["plain_vs_f64"], ep)
        return p64

    n_pyr = model.levels - 1
    x64 = x.double()
    s32, s64 = stack([model.conv_0]), stack([m64.conv_0])

    def with_pyr(fn, xin, sw):
        y, pools = fn(xin, sw, pyramid=n_pyr)
        return [y, *pools]

    ins64 = hold("layer_stack", "stem",
                 lambda: with_pyr(layer_stack, x, s32),
                 lambda: with_pyr(layer_stack_plain, x, s32),
                 lambda: with_pyr(layer_stack_plain, x64, s64))
    level64 = list(ins64)
    for r in range(model.repeats):
        b32 = [stack([getattr(model, f"convs_{l}_{r}")])
               for l in range(model.levels)]
        b64 = [stack([getattr(m64, f"convs_{l}_{r}")])
               for l in range(model.levels)]
        xin = [t.float() for t in ins64]
        ins64 = hold("layer_stack", f"branch layer {r}",
                     lambda: layer_stacks(xin, b32),
                     lambda: layer_stacks_plain(xin, b32),
                     lambda: layer_stacks_plain(ins64, b64))
    two32 = [stack([getattr(model, f"convs_{l}_{r}") for r in range(2)])
             for l in range(model.levels)]
    two64 = [stack([getattr(m64, f"convs_{l}_{r}") for r in range(2)])
             for l in range(model.levels)]
    lv32 = [t.float() for t in level64]
    hold("layer_stack", "branch layers 0-1 (R=2)",
         lambda: layer_stacks(lv32, two32),
         lambda: layer_stacks_plain(lv32, two32),
         lambda: layer_stacks_plain(level64, two64))
    o32 = [t.float() for t in ins64]
    tw64 = trunk_weights(merge(m64, m64.conv_1, m64.gn_0),
                         fast.trunk.coarse_hw, H, W)
    y1 = hold("trunk", "merge-1",
              lambda: [trunk(o32[0], o32[1:], x, fast.trunk)],
              lambda: [trunk_plain(o32[0], o32[1:], x, fast.trunk)],
              lambda: [trunk_plain(ins64[0], ins64[1:], x64, tw64)])[0]
    for name, sw32, sw64 in (
            ("merge2", fast.merge2, merge(m64, m64.conv_2)),
            ("merge3", fast.merge3, merge(m64, m64.conv_3, use_act=False))):
        y32 = y1.float()
        y1 = hold("layer_stack", name,
                  lambda: [layer_stack(y32, sw32)[0]],
                  lambda: [layer_stack_plain(y32, sw32)[0]],
                  lambda: [layer_stack_plain(y1, sw64)[0]])[0]
    return worst


def act_rollout(counters, built, r_p, act, device="cuda"):
    """Phase 13 (b): the fused ML_STOKES rollout of ``built`` at B = 1,
    ``ACT_WARMUP`` + ``ACT_STEPS`` steps: with learned padding through
    ``SimEngine.multi_step`` (the warm-up, then the timed steps), with
    zero padding through ``sim/rollout.py::rollout_torch`` (its own
    warm-up step, then chunks of ``multi_step``). Every count is set to 0
    just before and read just after; 4 + 1 + 1 + 0 launches per step and
    a finite T are asserted. Returns (launches, steps/s)."""
    import torch
    from pbml_mantle_convection_tpu_torch.sim.rollout import (
        WARMUP_STEPS, rollout_torch)
    _, fast, engine, T0 = built
    eng = engine(fast)
    for fn in counters.values():
        fn.launches = 0
    if r_p == "learned":
        state = eng.multi_step(eng.init_state(T0), ACT_WARMUP)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = eng.multi_step(state, ACT_STEPS)[0]
        torch.cuda.synchronize()
        n = ACT_WARMUP + ACT_STEPS
    else:
        t0 = time.perf_counter()
        state = rollout_torch(eng, T0, ACT_STEPS, snapshot_every=0)[0]
        torch.cuda.synchronize()
        n = WARMUP_STEPS + ACT_STEPS
    sps = ACT_STEPS / (time.perf_counter() - t0)
    got = {k: fn.launches for k, fn in counters.items()}
    want = rollout_launches(1, n)
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"[{r_p}, {act}] rollout: launches {got}, "
                             f"want {want}")
    if not bool(torch.isfinite(state.T).all()):
        raise AssertionError(f"[{r_p}, {act}] rollout: T not finite")
    return got, sps


def run_activations(counters, bench_sps, device="cuda", H=128, W=506,
                    acc_steps=ACT_ACC_STEPS):
    """Phase 13: the layer kernels' instances of the seven activations
    (``act_fn`` of ``models/layers.py``), each with learned and zero
    padding, on the flagship at 128×506: (a) each instance's
    ``layer_stack`` calls (stem with its pyramid, the grouped branches,
    merges 2 and 3) and ``trunk`` against their plain versions, timed
    (``check_layer_kernels``; ``sine`` held per layer by
    ``sine_layer_checks``); (b) a fused ML_STOKES rollout of each
    (``act_rollout``), steps/s beside phase 3's; (c) the 200-step T_rmse
    of the fused ``selu`` and ``relu`` flagships against the float64
    module path (``tools/torch_port_accuracy.py``), below ``ACC_T_RMSE``.
    Returns the per-instance records for the kernels line:
    {"layer_stack": {"act/padding": {...}}, "trunk": {...}}, with the
    launches of (b)."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import ACT_CODES
    t_phase = time.perf_counter()
    out = {"layer_stack": {}, "trunk": {}}
    for act in ACT_CODES:
        for r_p in ACT_PADS:
            t0 = time.perf_counter()
            built = flagship(H, W, device, r_p, act)
            sine = act == "sine"
            rec = check_layer_kernels(H, W, r_p, act, check=not sine,
                                      built=built)[0]
            if sine:
                worst = sine_layer_checks(built, H, W, r_p)
                for k in ("layer_stack", "trunk"):
                    rec[k]["whole_stack_max_abs_err"] = rec[k]["max_abs_err"]
                    rec[k]["max_abs_err"] = worst[k]["max_abs_err"]
                    rec[k]["per_layer_vs_f64"] = worst[k]["vs_f64"]
                    rec[k]["per_layer_plain_vs_f64"] = \
                        worst[k]["plain_vs_f64"]
            got, sps = act_rollout(counters, built, r_p, act, device)
            for k in ("layer_stack", "trunk"):
                out[k][f"{act}/{r_p}"] = dict(launches=got[k], **rec[k],
                                              steps_per_s=sps)
            print(f"activation [{r_p}, {act}]: layer_stack "
                  f"{rec['layer_stack']['queued_ms']:.4f} ms, trunk "
                  f"{rec['trunk']['queued_ms']:.4f} ms device only; "
                  f"rollout {sps:.2f} steps/s ({sps / bench_sps:.3f} of "
                  f"phase 3's {bench_sps:.2f}), launches {got}; "
                  f"{time.perf_counter() - t0:.1f} s")
            del built
            torch.cuda.empty_cache()
    acc = accuracy_tool()
    for act in ACT_ACCURACY:
        t0 = time.perf_counter()
        arch = {**acc.ARCH, "act_fn": act}
        r = acc.measure(acc.flagship_weights(0, arch), H, W, acc_steps,
                        "ML_STOKES", device=device, arch=arch,
                        variants=("fused",))
        print(json.dumps({"act_fn": act, **r}))
        if r["fused"]["launches_per_step"] != leg_launches("ML_STOKES",
                                                           "fused"):
            raise AssertionError(f"accuracy {act}: launches "
                                 f"{r['fused']['launches_per_step']}")
        t_rmse = r["fused"]["T_rmse"]
        print(f"accuracy {H}x{W} [{act}] ML_STOKES: {acc_steps} steps, "
              f"fused T_rmse {t_rmse:.3e} (bound {ACC_T_RMSE}), trace_mae "
              f"{r['fused']['trace_mae']:.3e}, "
          f"{time.perf_counter() - t0:.1f} s")
        if not t_rmse < ACC_T_RMSE:
            raise AssertionError(f"accuracy [{act}]: fused T_rmse "
                                 f"{t_rmse:.3e} >= {ACC_T_RMSE}")
    print(f"activations: {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 14: the rollout CLI's other heads at the flagship's width (-lt
# mae|mass, -pp 1), seeded weights, and the curl head through the same
# CLI as their baseline; (loss_type, p_pred) of each
HEADS = {"curl": ("curl", False), "mae+p": ("mae", True),
         "curl+p": ("curl", True), "mass": ("mass", False)}
# the executors held kernel against plain: (head, paddings); the curl
# head (merge 3 at c_o 1) is the same call's baseline
HEAD_CHECKS = {"curl": ("learned",), "mae+p": ("learned", "zeros"),
               "curl+p": ("learned", "zeros")}
HEAD_STEPS = 200           # timed CLI steps per head
# the widths and kernel sizes the executor lacks: the CLI's module route
ROUTE_FLAGS = {"-f 32": ["-f", "32"], "-k 3": ["-k", "3"]}
ROUTE_STEPS = 50


def head_argv(flags, device="cuda"):
    """The phase 10 flagship's CLI flags (ML_STOKES) with ``flags`` in
    place of or beside them."""
    d = dict(zip(DRIVER_ARGV[::2], DRIVER_ARGV[1::2]))
    d.update(zip(flags[::2], flags[1::2]))
    return ["-m", "ML_STOKES", *(a for kv in d.items() for a in kv),
            "--device", device]


def head_cli_leg(counters, name, argv, out_dir, want, route):
    """:func:`driver_leg` with the CLI's route line read from its output:
    it must start with ``route``. Returns (the route line, the pickles)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, _, pk = driver_leg(counters, name, argv, out_dir, want)
    print(buf.getvalue(), end="")
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("route: ")]
    if len(lines) != 1 or not lines[0].startswith(route):
        raise AssertionError(f"{name}: route lines {lines}, want {route!r}")
    T_vec = np.asarray(pk["T_vec"])
    if not np.isfinite(T_vec).all():
        raise AssertionError(f"{name}: T_vec not finite")
    return lines[0], pk


def run_heads(counters, bench_sps, device="cuda", H=128, W=506,
              steps=HEAD_STEPS, route_steps=ROUTE_STEPS,
              acc_steps=ACT_ACC_STEPS):
    """Phase 14: the rollout CLI's other heads at the flagship's width
    (``-l 5 -r 6 -f 16 -k 5 -s 0``), 128×506, seeded weights:
    (a) the ``mae`` + ``p_pred`` (c_o 3) and curl + ``p_pred`` (c_o 2)
    executors, learned and zero padding: each ``layer_stack`` call (merge
    3 at its c_o among them) and ``trunk`` against their plain versions,
    timed (``check_layer_kernels``), merge 3 with its bound at its c_o
    and with c_o padded to the 8 columns the tensor cores fill, beside
    the curl head's (c_o 1, learned) in the same call;
    (b) ``cli/rollout.py --fast 1`` with ``-lt mae -pp 1``, ``-pp 1`` and
    ``-lt mass``: the fused executor (its route line), 4 + 1 + 0 + 1
    launches per step (no fused epilogue), T_vec finite, the snapshots'
    pressure nonzero with ``-pp 1``, steps/s from sum(TS_vec) beside
    phase 3's and beside the curl head's through the same CLI (4 + 1 +
    1 + 0: its chunks and host copies are theirs);
    (c) ``--fast 1 -f 32`` and ``-k 3``: the module route (its line), 0 +
    0 + 0 + 1 per step, steps/s;
    (d) the 200-step T_rmse of the ``mae`` + ``p_pred`` flagship, fused
    and module float32 against the float64 module path
    (``tools/torch_port_accuracy.py``), the fused leg below
    ``ACC_T_RMSE``, 4 + 1 + 0 + 1 launches per step.
    Returns ({"layer_stack": {"head/padding": record}, "trunk": ...} for
    the kernels line, with the layer_stack launches of (b), and the
    launches of (b) and (c) summed)."""
    import tempfile
    import torch
    from pbml_mantle_convection_tpu_torch.sim.rollout import WARMUP_STEPS
    t_phase = time.perf_counter()
    out = {"layer_stack": {}, "trunk": {}}
    for name, pads in HEAD_CHECKS.items():
        lt, pp = HEADS[name]
        for r_p in pads:
            built = flagship(H, W, device, r_p, "gelu", lt, pp)
            rec = check_layer_kernels(H, W, r_p, built=built)[0]
            m3 = rec["layer_stack"]["merge3"]
            if m3["c_o"] != built[0].c_o:
                raise AssertionError(f"heads [{name}, {r_p}]: merge 3 at "
                                     f"c_o {m3['c_o']}")
            for k in ("layer_stack", "trunk"):
                out[k][f"{name}/{r_p}"] = rec[k]
            print(f"heads [{name}, {r_p}]: merge 3 c_o={m3['c_o']} rel "
                  f"{m3['rel']:.3e} (tol {TOL['layer_stack']}), "
                  f"{m3['queued_ms']:.5f} ms device only, plain "
                  f"{m3['plain_ms']:.4f}, bound {m3['bound_ms']:.5f} "
                  f"({m3['bound_by']}, 3xTF32), c_o padded to 8 "
                  f"{m3['padded_bound_ms']:.5f}")
            del built
            torch.cuda.empty_cache()

    launch = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory() as root:
        for name, (lt, pp) in HEADS.items():
            flags = (["-lt", lt] if lt != "curl" else []) + (
                ["-pp", "1"] if pp else [])
            n = steps + WARMUP_STEPS
            want = {"layer_stack": 4 * n, "trunk": n,
                    "advect_diffuse_step_fused": n}
            if name == "curl":       # the fused epilogue's step
                want = rollout_launches(1, n)
            route, pk = head_cli_leg(
                counters, f"heads (b): {' '.join(flags) or 'curl'}",
                head_argv(flags + ["--max_steps", str(steps)], device),
                os.path.join(root, name), want, "route: fused executor")
            P = np.stack(pk["snapshots"]["P"])
            if bool(np.abs(P).max() > 0) != pp or not np.isfinite(P).all():
                raise AssertionError(f"heads (b) {name}: snapshot P max "
                                     f"{np.abs(P).max()}, p_pred {pp}")
            for k in launch:
                launch[k] += counters[k].launches
            sps = steps / float(np.sum(pk["TS_vec"]))
            if f"{name}/learned" in out["layer_stack"]:
                out["layer_stack"][f"{name}/learned"].update(
                    launches=counters["layer_stack"].launches,
                    steps_per_s=sps)
                out["trunk"][f"{name}/learned"].update(
                    launches=counters["trunk"].launches, steps_per_s=sps)
            print(f"heads (b) {name}: {sps:.2f} steps/s from sum(TS_vec) "
                  f"({steps} steps; {sps / bench_sps:.3f} of phase 3's "
                  f"{bench_sps:.2f}), snapshot |P| max {np.abs(P).max():.3e}")
        for name, flags in ROUTE_FLAGS.items():
            n = route_steps + WARMUP_STEPS
            route, pk = head_cli_leg(
                counters, f"heads (c): {name}",
                head_argv(flags + ["--max_steps", str(route_steps)], device),
                os.path.join(root, name.replace(" ", "")),
                {"advect_diffuse_step_fused": n}, "route: module")
            for k in launch:
                launch[k] += counters[k].launches
            sps = route_steps / float(np.sum(pk["TS_vec"]))
            print(f"heads (c) {name}: {sps:.2f} steps/s from sum(TS_vec) "
                  f"({route_steps} steps, the module path), {route}")

    acc = accuracy_tool()
    arch = acc.head_arch(acc.ARCH, "mae", True)
    t0 = time.perf_counter()
    r = acc.measure(acc.flagship_weights(0, arch), H, W, acc_steps,
                    "ML_STOKES", device=device, arch=arch,
                    variants=("fused", "module_f32"))
    print(json.dumps({"loss_type": "mae", "p_pred": True, **r}))
    want = {"layer_stack": 4, "trunk": 1, "curl_advect_epilogue": 0,
            "advect_diffuse_step_fused": 1}
    if r["fused"]["launches_per_step"] != want:
        raise AssertionError(f"accuracy mae+p: fused launches "
                             f"{r['fused']['launches_per_step']}")
    t_rmse = r["fused"]["T_rmse"]
    print(f"accuracy {H}x{W} [mae+p] ML_STOKES: {acc_steps} steps, fused "
          f"T_rmse {t_rmse:.3e} (bound {ACC_T_RMSE}), module_f32 "
          f"{r['module_f32']['T_rmse']:.3e}, trace_mae "
          f"{r['fused']['trace_mae']:.3e}, "
          f"{time.perf_counter() - t0:.1f} s")
    if not t_rmse < ACC_T_RMSE:
        raise AssertionError(f"accuracy [mae+p]: fused T_rmse {t_rmse:.3e} "
                             f">= {ACC_T_RMSE}")
    print(f"heads: {time.perf_counter() - t_phase:.1f} s")
    return out, launch


# phase 15: the four study tools at cut sizes (their flags; the grids
# of (b)-(d) are the production 128×506, (a)'s JAX's coarse default)
STUDY_ARGV = {
    "speedup": ["--steps", "40", "--n-iter", "1000"],
    # 9 steps: the least that leaves the cv store a snapshot (every 8th
    # index past each simulation's 5 init snapshots); the fallback
    # triples are three simulations whatever --n-train-sims
    "refscale": ["--steps", "9", "--epochs", "2", "--n-train-sims", "2",
                 "--n-iter", "1000"],
    "interleave": ["--steps", "40", "--intervene", "10"],
    # 4 × 100 snapshots of 128×506: 311 MB of float32 fields
    "hbm": ["--phase", "inline", "--sims", "4", "--snaps", "100",
            "--batch", "16", "--steps_cap", "4", "--pipeline_steps", "10"],
}
# launches per step of each leg (layer_stack, trunk, curl_advect_epilogue,
# advect_diffuse_step_fused): the speedup study's surrogate is the module
# (JAX's study runs model.apply), so the energy kernel alone; the
# reference-scale and interleave rollouts run the fused executor, with
# the epilogue in ML_STOKES and the energy kernel where the engine or the
# native loop takes the surrogate's velocities
MODULE_STEP = (0, 0, 0, 1)
FUSED_STEP = (4, 1, 1, 0)
EXECUTOR_STEP = (4, 1, 0, 1)


def _per_step(t):
    return dict(zip(("layer_stack", "trunk", "curl_advect_epilogue",
                     "advect_diffuse_step_fused"), map(float, t)))


def _finite_row(name, row):
    bad = [k for k, v in row.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{name}: not finite: {bad}")


def _study_launches(counters, name, rows, extra):
    """The counts since :func:`_zero` must be the rows' launches per step
    times their steps, plus ``extra`` (warm-up steps, GAIA data); each
    row's launches per step as the tool read them must be its ``want``.
    ``rows``: [(row name, launches per step, steps, want per step)]."""
    want = dict(extra)
    for row, got, n, per in rows:
        if got != _per_step(per):
            raise AssertionError(f"{name} {row}: launches per step {got}, "
                                 f"want {_per_step(per)}")
        for k, v in _per_step(per).items():
            want[k] = want.get(k, 0) + int(v) * n
    return _launched(counters, want, name)


def run_studies(counters, bench_sps, device="cuda", argv=None):
    """Phase 15: the port's four study tools, each through its ``main``,
    at cut sizes (``STUDY_ARGV``): (a) the speedup study (GAIA, GAIA-skip10,
    ML_STOKES, ML_PRE at 50×74, float64): every row finite, the launches
    per step 0 + 0 + 0 + 1 in each mode (GAIA, the skip and the module
    surrogate), GAIA-skip10's final T-RMSE below ML_STOKES's (ML_PRE's
    printed beside it); (b) the reference-scale study at 128×506 (the flagship
    trained 2 epochs through the Trainer with a restart at epoch 1, then
    held-out rollouts through the fused executor): the restart epoch,
    4 + 1 + 1 + 0 launches per ML_STOKES step, 4 + 1 + 0 + 1 per ML_PRE
    step, the trained-vs-untrained margin; (c) the interleave fidelity
    tool at 128×506 (40 steps, the native step every 10th): 4 + 1 + 1 + 0
    in leg A, 4 + 1 + 0 + 1 in the native legs; (d) the HBM-scale study
    ``--phase inline`` on a 311 MB host-resident store (4 capped train
    steps of the flagship at B = 16 per epoch): losses finite, the restart
    into epoch 1, no kernel launch. Each tool's launches are read from
    zero just after it. Returns the launches of (a)-(d) summed."""
    import tempfile
    argv = argv or STUDY_ARGV
    t_phase = time.perf_counter()
    launch = dict.fromkeys(counters, 0)

    def add():
        for k in launch:
            launch[k] += counters[k].launches

    dev = ["--device", device]
    with tempfile.TemporaryDirectory() as root:
        out = ["--out-dir", root]
        # (a)
        t0 = time.perf_counter()
        _zero(counters)
        rec = load_tool("torch_port_speedup_study").main(
            argv["speedup"] + dev + out)
        rows = rec["rows"]
        for name, row in rows.items():
            _finite_row(f"studies (a) {name}", row)
        n = rec["steps"]
        _study_launches(counters, "studies (a) speedup", [
            (name, row["launches_per_step"], n, MODULE_STEP)
            for name, row in rows.items()],
            # each mode's warm-up step
            {"advect_diffuse_step_fused": len(rows)})
        add()
        skip = next(k for k in rows if k.startswith("GAIA-skip"))
        ml = rows["ML_STOKES"]["t_rmse"]
        print(f"studies (a) speedup {rec['grid'][0]}x{rec['grid'][1]}, "
              f"{n} steps: "
              + ", ".join(f"{k} {r['wall_per_step'] * 1e3:.2f} ms/step "
                          f"({r['speedup']:.2f}x) T-RMSE {r['t_rmse']:.3e}"
                          for k, r in rows.items())
              + f"; train loss {rec['train_loss']:.5f}; "
              f"{time.perf_counter() - t0:.1f} s")
        # the solver-grade skip must beat the surrogate alone; ML_PRE's
        # 100-iteration refinement from a surrogate trained for 160
        # batches need not (a 18×26 CPU run ends 2× above ML_STOKES), so
        # its standing is printed, not checked
        if not rows[skip]["t_rmse"] < ml:
            raise AssertionError(f"studies (a): {skip} T-RMSE "
                                 f"{rows[skip]['t_rmse']:.3e} not below "
                                 f"ML_STOKES's {ml:.3e}")
        print(f"studies (a): ML_PRE T-RMSE {rows['ML_PRE']['t_rmse']:.3e} "
              f"{'below' if rows['ML_PRE']['t_rmse'] < ml else 'not below'}"
              f" ML_STOKES's {ml:.3e} (printed, not checked)")

        # (b)
        t0 = time.perf_counter()
        _zero(counters)
        rec = load_tool("torch_port_reference_scale_study").main(
            argv["refscale"] + dev + out
            + ["--run-dir", os.path.join(root, "refscale_run")])
        half = max(1, rec["epochs"] // 2)
        if rec["start_epoch_after_restart"] != half:
            raise AssertionError(f"studies (b): restart at epoch "
                                 f"{rec['start_epoch_after_restart']}")
        rows = rec["rows"]
        for name, row in rows.items():
            _finite_row(f"studies (b) {name}", row)
        n = rec["eval_steps"]
        _study_launches(counters, "studies (b) reference scale", [
            (name, row["launches_per_step"], n,
             EXECUTOR_STEP if "ML_PRE" in name else FUSED_STEP)
            for name, row in rows.items()],
            # the GAIA ground truth: the training simulations and the
            # held-out one, one energy step each per step
            {"advect_diffuse_step_fused":
                (len(rec["train_paras"]) * rec["steps"] + n)})
        add()
        print(f"studies (b) reference scale {rec['grid'][0]}x"
              f"{rec['grid'][1]}: restart at epoch "
              f"{rec['start_epoch_after_restart']}, "
              + ", ".join(f"{k} T-RMSE {r['t_rmse']:.3e} ({r['wall_s']:.2f}"
                          f" s)" for k, r in rows.items())
              + f"; trained-vs-untrained margin {rec['margin']:.2f}x; "
              f"data {rec['data_s']:.1f} s, training "
              f"{rec['train_wall_s']:.1f} s; "
              f"{time.perf_counter() - t0:.1f} s")

        # (c)
        t0 = time.perf_counter()
        _zero(counters)
        rec = load_tool("torch_port_interleave_fidelity").main(
            argv["interleave"] + dev + out + ["--json"])
        legs = [("A", rec["A_launches_per_step"], rec["steps"],
                 FUSED_STEP)]
        for leg in ("B_native_interleave", "C_native_everystep"):
            _finite_row(f"studies (c) {leg}", rec[leg])
            legs.append((leg, rec[leg]["launches_per_step"],
                         rec[leg]["steps"], EXECUTOR_STEP))
        _study_launches(counters, "studies (c) interleave", legs, {})
        add()
        B, C = rec["B_native_interleave"], rec["C_native_everystep"]
        print(f"studies (c) interleave {rec['grid'][0]}x{rec['grid'][1]}: "
              f"B (native every {rec['intervene_ts']}) trace RMSE "
              f"{B['trace_rmse']:.3e} over {B['steps']} steps, C (native "
              f"every step) {C['trace_rmse']:.3e} over {C['steps']}; "
              f"{B['s_per_step'] * 1e3:.2f} and "
              f"{C['s_per_step'] * 1e3:.2f} ms/step; "
              f"{time.perf_counter() - t0:.1f} s")

        # (d)
        t0 = time.perf_counter()
        _zero(counters)
        rec = load_tool("torch_port_hbm_scale_study").main(
            argv["hbm"] + dev + out
            + ["--path", os.path.join(root, "hbm_store"),
               "--run-dir", os.path.join(root, "hbm_run")])
        _launched(counters, {}, "studies (d) hbm")
        for k in ("losses_epoch0", "losses_epoch1"):
            if not np.isfinite(rec[k]).all():
                raise AssertionError(f"studies (d): {k} {rec[k]}")
        if (rec["start_epoch0"], rec["start_epoch1"]) != (0, 1):
            raise AssertionError(f"studies (d): epochs start at "
                                 f"{rec['start_epoch0']}, "
                                 f"{rec['start_epoch1']}")
        print(f"studies (d) hbm: {rec['store_gb']} GB store, generated in "
              f"{rec['store_open_s']} s; pipeline "
              f"{rec['pipeline_ms_per_batch']} ms/batch "
              f"({rec['pipeline_gbps']} GB/s); epoch 1 "
              f"{rec['e2e_ms_per_step']} ms/step end to end over "
              f"{rec['steps_measured']} of {rec['steps_per_epoch_full']} "
              f"steps, peak {rec.get('peak_device_gb_epoch1')} GB on the "
              f"card; {time.perf_counter() - t0:.1f} s")
    print(f"studies: {time.perf_counter() - t_phase:.1f} s (bench_torch.py "
          f"128x506 {bench_sps:.2f} steps/s in this run)")
    return launch


def run_phase(n: int) -> int:
    """``--phase n``: builds the kernels, runs phase 3
    (:func:`run_main_path`) and then phase ``n``."""
    import bench_torch
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    print(f"card: {card_line()}")
    _cuda.build()
    _cuda.library()
    counters = bench_torch.counters()
    _, sps = run_main_path(counters)
    globals()[PHASES[n]](counters, sps[128, 506])
    print(f"phase 3 and phase {n}: {time.perf_counter() - t0:.1f} s")
    return 0


# the phases ``--phase`` runs after phase 3, by number
PHASES = {10: "run_drivers", 11: "run_other_models", 12: "run_parallel",
          13: "run_activations", 14: "run_heads", 15: "run_studies"}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "H100 (module doc)")
    ap.add_argument("--phase", type=int, choices=sorted(PHASES),
                    help="run phase 3 and then this phase alone")
    ap.add_argument("--attention-rank", nargs=6, metavar=(
        "RANK", "WORLD", "PORT", "OUT", "DEVICE", "N"),
        help="one of phase 12's gloo ranks (started by the phase itself)")
    args = ap.parse_args(argv)
    if args.attention_rank:
        r, w, port, out, device, n = args.attention_rank
        attention_rank(int(r), int(w), int(port), out, device, int(n))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.phase is not None:
        return run_phase(args.phase)
    import bench_torch
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    from pbml_mantle_convection_tpu_torch.ops.dense_attention import (
        dense_attention)
    from pbml_mantle_convection_tpu_torch.ops.dense_gemm import dense_gemm
    from pbml_mantle_convection_tpu_torch.ops.projection_conv import (
        projection_conv)
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice, slice_pool)

    card = card_line()
    print(f"card: {card}")
    so, secs, report = _cuda.build()
    _cuda.library()
    print(f"kernels built in {secs:.1f} s")
    for line in report.splitlines():
        if re.search(r"Function properties|registers|spill", line):
            print("  ptxas:", line.strip())
    check_sass(so)
    check_default_flags()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)

    t0 = time.perf_counter()
    rec = check_kernels(128, 506)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    counters = bench_torch.counters()
    launch, bench_sps = run_main_path(counters)
    compare_paths(128, 506)
    t0 = time.perf_counter()
    for k, n in run_modes(counters).items():
        launch[k] += n
    print(f"engine modes: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rec.update(check_slice())
    counters.update(slice_pool=slice_pool, slice_deslice=slice_deslice)
    for k in ("slice_pool", "slice_deslice"):
        launch[k] = 0
    for k, n in run_transolver(counters).items():
        launch[k] += n
    transolver_checks(counters)
    print(f"transolver: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["dense_attention"] = check_dense_attention()
    vit_launches = run_vit()
    print(f"dense attention: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["projection_conv"] = check_projection_conv()
    projection_launches = run_projection_cell()
    print(f"projection conv: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["dense_gemm"] = check_dense_gemm()
    dense_gemm_launches = run_dense_gemm_models()
    print(f"dense gemm: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_accuracy()
    print(f"accuracy: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, n in run_batched(counters).items():
        launch[k] += n
    print(f"batched rollout: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero = run_zero_path(counters)
    for k, n in zero.items():       # the layer kernels' by instance
        if k in ("layer_stack", "trunk"):
            rec[k]["zero_instance"]["launches"] = n
        else:
            launch[k] += n
    print(f"-pad zeros path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_train(counters)
    print(f"train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_unet(counters)
    print(f"unet: {time.perf_counter() - t0:.1f} s")
    run_drivers(counters, bench_sps[128, 506])
    run_other_models(counters, bench_sps[128, 506])
    for k, n in run_parallel(counters, bench_sps[128, 506]).items():
        launch[k] += n
    for k, inst in run_activations(counters, bench_sps[128, 506]).items():
        rec[k]["activation_instances"] = inst
    heads, n_heads = run_heads(counters, bench_sps[128, 506])
    for k, inst in heads.items():
        rec[k]["head_instances"] = inst
    for k, n in n_heads.items():
        launch[k] += n
    for k, n in run_studies(counters, bench_sps[128, 506]).items():
        launch[k] += n

    floor = launch_floor(1, ENERGY_BLOCK)
    print(f"launch floor: an empty kernel of one block of {ENERGY_BLOCK} "
          f"threads, 200 "
          f"queued: {floor['plain']:.5f} ms device only per launch "
          f"(cooperative {floor['cooperative']:.5f}, with one grid sync "
          f"{floor['cooperative_sync']:.5f})")
    # the ViT's, the Transolver projections' and the Dense layers' kernels,
    # added last (the phases above check that every counter they hold reads
    # their own launches): phase 5c's, 5f's and 5h's
    counters["dense_attention"] = dense_attention
    launch["dense_attention"] = vit_launches
    counters["projection_conv"] = projection_conv
    launch["projection_conv"] = projection_launches
    counters["dense_gemm"] = dense_gemm
    launch["dense_gemm"] = dense_gemm_launches
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launch[k], **rec[k])
               for k in counters]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
