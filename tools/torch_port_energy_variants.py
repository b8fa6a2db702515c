#!/usr/bin/env python3
"""Times variants of the two energy-step kernels on the card.

A variant is the checked-in ``csrc/epilogue.cu`` and ``csrc/advect.cu``
with textual edits (``VARIANTS`` below; a ``[tag]`` edit replaces the
region between the source's ``// [tag]`` and ``// [/tag]`` lines), or
``parent``: the package of another tree (``--parent``, e.g. a parent
commit unpacked by ``git archive`` into the git-ignored ``build/``), as
it is. Each name on the command line runs in its own process, in that
order (name one twice to see the spread between two runs of the same
code), builds only the kernels it times (``layer_stack.cu`` for the
library's helpers, ``epilogue.cu``, ``advect.cu``) and prints, at each
grid of ``--grids``:

* ``curl_advect_epilogue`` (the flagship's constants: a_bound 4, cn_max
  0.99, the velocity scaler and source of ``chip_smoke.py::flagship``);
* ``advect_diffuse_step_fused`` with the adaptive dt in float32 and
  float64 at B = 1, float32 at B = 16 (more points than one co-resident
  wave: the looping path), and float32 with a given dt;

for each: max |kernel − plain| / max |plain| and dt's relative
difference, the device-only ms per call (200 calls queued behind a spin,
``chip_smoke.py::queued_ms``), the ms per call back to back, the host's
µs per call (the wrapper's enqueue, the device kept ahead of it) and the
device kernels of one call (``torch.profiler``); and the launch floor
(an empty kernel of the same grid queued 200 times: plain, cooperative,
and cooperative with one grid sync), where the tree's library has it. One
JSON line per variant. Needs the card and nvcc.

Usage (from the repository root, on the machine with the card)::

    python3 tools/torch_port_energy_variants.py current two_pass_pdl current
    python3 tools/torch_port_energy_variants.py --parent build/parent \\
        parent current current parent
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the host launch of the second design: two ordinary launches of the same
# kernel, the second a programmatic dependent launch
_PDL_LAUNCH = """  // [launch]
  const int blocks = min(max_blocks, {need});
  {args} a1 = a, a2 = a;
  a1.role = 1;
  a2.role = 2;
  {kernel}<<<blocks, kBlock, 0, stream>>>(a1);
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBlock);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, {kernel}, a2);
  return err != cudaSuccess ? err : cudaGetLastError();
  // [/launch]
"""
_TRIGGER = ('  if (a.role == 1) '
            'asm volatile("griddepcontrol.launch_dependents;");\n')
_WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'

# name → {file: [(text or "[tag]", replacement), ...]}
VARIANTS = {
    "current": {},
    # design (B): pass 1 (role 1) computes the velocities and the block
    # maxima, and the last block to take the self-resetting ticket writes
    # dt; pass 2 (role 2), launched programmatically dependent on it,
    # recomputes its inputs before griddepcontrol.wait and then reads dt
    "two_pass_pdl": {
        "epilogue.cu": [
            ("  float a_bound, scaler, adv_num, dt_diffuse;\n};",
             "  float a_bound, scaler, adv_num, dt_diffuse;\n"
             "  int role;   // 1: velocities and dt; 2: the update\n};"),
            ("  a.u[R * W + C] = uo;\n  a.v[R * W + C] = vo;\n",
             "  if (a.role != 2) {\n    a.u[R * W + C] = uo;\n"
             "    a.v[R * W + C] = vo;\n  }\n"),
            ("[join]", """__device__ unsigned int epi_ticket = 0;

__device__ __forceinline__ float grid_dt(const EpiArgs& a, float bmax) {
  if (a.role == 1) {
    __shared__ bool last;
    if (threadIdx.x == 0) {
      a.block_max[blockIdx.x] = bmax;
      __threadfence();
      last = atomicAdd(&epi_ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      float m = 0.f;
      for (int k = threadIdx.x; k < (int)gridDim.x; k += kBlock)
        m = fmaxf(m, __ldcg(&a.block_max[k]));
      m = block_max(m);
      if (threadIdx.x == 0) {
        *a.dt = fminf(a.adv_num / m, a.dt_diffuse);
        epi_ticket = 0;
      }
    }
    return 0.f;
  }
""" + _WAIT + """  return __ldcg(a.dt);
}
"""),
            ("  float m = 0.f, tc0 = 0.f, rhs0 = 0.f;\n",
             "  float m = 0.f, tc0 = 0.f, rhs0 = 0.f;\n" + _TRIGGER),
            ("    if (R0 > 0 && R0 < H - 1)\n      rhs0 =",
             "    if (a.role == 2 && R0 > 0 && R0 < H - 1)\n      rhs0 ="),
            ("  const float dt = grid_dt(a, block_max(m));\n",
             "  const float dt = grid_dt(a, block_max(m));\n"
             "  if (a.role == 1) return;\n"),
            ("[launch]", _PDL_LAUNCH.format(
                need="(H * W + kBlock - 1) / kBlock", args="EpiArgs",
                kernel="epilogue_kernel")),
        ],
        "advect.cu": [
            ("  int core_cool, clip_T;\n};",
             "  int core_cool, clip_T;\n"
             "  int role;   // 1: dt; 2: the update; 0: the update, dt given\n"
             "};"),
            ("[join]", """__device__ unsigned int adv_ticket = 0;

template <typename T>
__device__ __forceinline__ T grid_dt(const AdvArgs<T>& a, T mx, T mn) {
  if (a.role == 1) {
    block_max_min(mx, mn);
    __shared__ bool last;
    if (threadIdx.x == 0) {
      a.part[2 * blockIdx.x] = mx;
      a.part[2 * blockIdx.x + 1] = mn;
      __threadfence();
      last = atomicAdd(&adv_ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      mx = T(0);
      mn = T(INFINITY);
      for (int k = threadIdx.x; k < (int)gridDim.x; k += kBlock) {
        mx = tmax(mx, __ldcg(&a.part[2 * k]));
        mn = tmin(mn, __ldcg(&a.part[2 * k + 1]));
      }
      block_max_min(mx, mn);
      if (threadIdx.x == 0) {
        const T d2 = mn * mn;
        const T dt_advect = a.adv_coef * mn / mx;
        const T dt_diffuse = T(0.5) * (d2 * d2) / (d2 + d2);
        *a.dt_out = tmin(dt_advect, dt_diffuse);
        adv_ticket = 0;
      }
    }
    return T(0);
  }
""" + _WAIT + """  return __ldcg(a.dt_out);
}
"""),
            ("  T tc0 = T(0), rhs0 = T(0), mx = T(0), mn = T(INFINITY);\n",
             "  T tc0 = T(0), rhs0 = T(0), mx = T(0), mn = T(INFINITY);\n"
             + _TRIGGER),
            ("      rhs0 = update_rhs(a, q0, ui, vi, tc0, mn);",
             "      if (a.role == 1) mn = __ldg(&a.dxl[q0.m]);\n"
             "      else rhs0 = update_rhs(a, q0, ui, vi, tc0, mn);"),
            ("    dt = grid_dt(a, mx, mn);\n",
             "    dt = grid_dt(a, mx, mn);\n    if (a.role == 1) return;\n"),
            ("[launch]", _PDL_LAUNCH.format(need="need", args="AdvArgs<T>",
                                            kernel="advect_kernel<T>")),
        ],
    },
}
for _t in (128, 256, 1024):
    # blocks of _t threads (the co-resident cap follows)
    VARIANTS[f"block{_t}"] = {
        f: [("constexpr int kBlock = 512;", f"constexpr int kBlock = {_t};")]
        for f in ("epilogue.cu", "advect.cu")}
KEEP_SOURCES = ("layer_stack.cu", "epilogue.cu", "advect.cu")
KEEP_ENTRIES = ("pmc_curl_advect_epilogue", "pmc_advect_", "pmc_empty")


def edit(text: str, old: str, new: str, where: str) -> str:
    if old.startswith("[") and old.endswith("]"):
        tag = old[1:-1]
        a, b = f"// [{tag}]", f"// [/{tag}]"
        if a not in text or b not in text:
            raise ValueError(f"{where}: no region {old}")
        i = text.index(a)
        i = text.rindex("\n", 0, i) + 1          # the start of its line
        j = text.index("\n", text.index(b)) + 1
        return text[:i] + new + text[j:]
    if old not in text:
        raise ValueError(f"{where}: {old!r} not in the source")
    return text.replace(old, new)


def use_tree(name: str, root: Path):
    """Import the package of ``root``, point its kernel build at a copy of
    csrc with the variant's edits (none for ``parent``) and build only
    KEEP_SOURCES; returns the loaded library."""
    sys.path.insert(0, str(root))
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    if not Path(_cuda.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {_cuda.__file__}, not {root}'s")
    if name != "parent":
        d = _cuda.BUILD_DIR.parent / "variants" / f"energy_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, d)
        for fname, edits in VARIANTS[name].items():
            f = d / fname
            text = f.read_text()
            for old, new in edits:
                text = edit(text, old, new, f"variant {name}, {fname}")
            f.write_text(text)
        _cuda.CSRC = d
    _cuda.SOURCES = tuple(s for s in _cuda.SOURCES if s in KEEP_SOURCES)
    _cuda._SIGNATURES = {k: v for k, v in _cuda._SIGNATURES.items()
                         if k.startswith(KEEP_ENTRIES)}
    _cuda.library.cache_clear()
    t0 = time.perf_counter()
    _, _, report = _cuda.build()
    lib = _cuda.library()
    regs = [line.split(":", 1)[-1].strip() for line in report.splitlines()
            if "registers" in line and "Used" in line]
    print(f"{name}: built in {time.perf_counter() - t0:.1f} s; ptxas "
          f"{' | '.join(regs)}", flush=True)
    return lib


def measure(name: str, root: Path, grids) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (ENERGY_BLOCK, card_line, cuda_ms,
                            device_kernel_count, host_us, queued_ms)
    lib = use_tree(name, root)
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_fused, advect_diffuse_step_plain)
    from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
        curl_advect_epilogue, curl_advect_epilogue_plain, epilogue_consts)
    from pbml_mantle_convection_tpu_torch.physics.advection import (
        grid_metrics)
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"variant": name, "card": card_line()}

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def record(key, fn, plain_out, got, dt_pair):
        errs = max(rel(a, b) for a, b in zip(got, plain_out))
        dt_rel = abs(float(dt_pair[0]) - float(dt_pair[1])) / float(
            dt_pair[1])
        r = {"rel_err": errs, "dt_rel": dt_rel,
             "device_ms": queued_ms(fn), "ms": cuda_ms(fn, n=200),
             "host_us": host_us(fn),
             "device_kernels": device_kernel_count(fn)}
        out[key] = r
        print(f"{name} {key}: rel err {errs:.2e}, dt rel {dt_rel:.1e}, "
              f"device ms {r['device_ms']:.5f}, back to back "
              f"{r['ms']:.5f}, host us {r['host_us']:.1f}, device kernels "
              f"per call {r['device_kernels']}", flush=True)

    for H, W in grids:
        grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2) if H != W else 1.0)
        g = torch.Generator(device=dev).manual_seed(H + W)
        met = grid_metrics(*grid.coords(dev, torch.float32),
                           aspect=grid.aspect)
        met64 = grid_metrics(*grid.coords(dev, torch.float64),
                             aspect=grid.aspect)
        consts = epilogue_consts(met, 4.0, 0.99)
        scaler, src = 1.0e4, torch.tensor(3.0, device=dev)
        psi = 0.05 * torch.randn(H, W, generator=g, device=dev)
        T = torch.rand(H, W, generator=g, device=dev)

        def epi():
            return curl_advect_epilogue(psi, T, consts, scaler, src)
        got = epi()
        ref = curl_advect_epilogue_plain(psi, T, consts, scaler, src)
        record(f"epilogue {H}x{W}", epi, ref[:3], got[:3], (got[3], ref[3]))

        for label, B, dtype, given in (("f32", 1, torch.float32, False),
                                       ("f64", 1, torch.float64, False),
                                       ("f32 B=16", 16, torch.float32, False),
                                       ("f32 dt given", 1, torch.float32,
                                        True)):
            m = met64 if dtype == torch.float64 else met
            u, v = (40 * torch.randn(B, H, W, generator=g, device=dev,
                                     dtype=dtype) for _ in range(2))
            Tb = torch.rand(B, H, W, generator=g, device=dev, dtype=dtype)
            s = torch.tensor(2.5, device=dev, dtype=dtype)
            dt = (torch.tensor(1e-6, device=dev, dtype=dtype) if given
                  else None)

            def adv(u=u, v=v, Tb=Tb, s=s, m=m, dt=dt):
                return advect_diffuse_step_fused(u, v, Tb, s, m, dt=dt,
                                                 cn_max=0.99)
            got = adv()
            ref = advect_diffuse_step_plain(u, v, Tb, s, m, dt=dt,
                                            cn_max=0.99)
            record(f"advect {label} {H}x{W}", adv, ref[:1], got[:1],
                   (got[1], ref[1]))

        if hasattr(lib, "pmc_empty"):
            blocks = (H * W + ENERGY_BLOCK - 1) // ENERGY_BLOCK
            for mode, what in ((0, "plain"), (1, "cooperative"),
                               (2, "cooperative + grid sync")):
                def empty(mode=mode):
                    err = lib.pmc_empty(blocks, ENERGY_BLOCK, mode,
                                        _cuda.stream(psi))
                    _cuda.raise_on_error(err, "pmc_empty")
                ms = queued_ms(empty)
                out[f"launch floor {what} {H}x{W}"] = ms
                print(f"{name} launch floor ({what}, {blocks} x "
                      f"{ENERGY_BLOCK}) "
                      f"{H}x{W}: {ms:.5f} ms", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="128x506,256x256")
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"),
                    help="the tree whose package the name 'parent' times")
    ap.add_argument("--measure", metavar="NAME", help=argparse.SUPPRESS)
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"'parent' or one of {', '.join(VARIANTS)} "
                         f"(default: current)")
    args = ap.parse_args()
    grids = [tuple(map(int, s.split("x"))) for s in args.grids.split(",")]
    for name in args.variants:
        if name != "parent" and name not in VARIANTS:
            ap.error(f"unknown variant {name!r}")
    if args.measure:
        import torch
        if not torch.cuda.is_available():
            print("torch_port_energy_variants: no CUDA device",
                  file=sys.stderr)
            return 1
        root = Path(args.parent) if args.measure == "parent" else ROOT
        print(json.dumps(measure(args.measure, root, grids)))
        return 0
    for name in args.variants or ["current"]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", name,
             "--grids", args.grids, "--parent", args.parent],
            cwd=ROOT, capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr, file=sys.stderr)
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
