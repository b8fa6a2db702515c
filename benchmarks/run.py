#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python benchmarks/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root
of the checkout: a configuration (``benchmarks/configs/<name>.json``) under
a traffic mix (``benchmarks/traffic/<name>.json``, whose ``driver`` names
the general generator in ``benchmarks/drivers/``), with the limits of its
check in ``benchmarks/limits/<cell>.json``. With ``--trace 0`` the run
measures the cell's end-to-end metrics over ``--seconds`` of its traffic;
with ``--trace 1`` it profiles a bounded stretch of the same traffic and
reads each per-layer metric that the cell reports with that metric's own
reader, ``benchmarks/metrics/<metric>.py``. Either way it then checks what
the timed path produced against the plain reference
(``benchmarks/reference/``), prints each number compared beside its limit
as the last lines of standard error, and prints one JSON line as the last
line of standard output.

It needs an NVIDIA GPU: without one, or with fewer than the cell asks for,
it exits with code 2 and prints no result. It measures the PyTorch and
CUDA package ``pbml_mantle_convection_tpu_torch`` and loads nothing of
JAX: if ``jax``, ``jaxlib``, ``flax`` or ``pbml_mantle_convection_tpu``
is loaded when the window has closed, it exits with code 3 and prints no
result. Kernel builds and traces stay inside the checkout (``build/``).

Against a host whose speed drifts, the process keeps to a fixed pair of
cores and one math thread, and moves what set-up allocated out of the
garbage collector's reach before the window; the host's state beside
each run (the load average, and the host's time to launch a small
operation before and after the window) goes into the result line under
``host`` and onto standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmarks"
FORBIDDEN = ("jax", "jaxlib", "flax", "pbml_mantle_convection_tpu")
CORES = 2          # the host cores the run keeps to
PROBE_LAUNCHES = 2000


def fail(msg: str, code: int) -> int:
    print(f"run.py: {msg}", file=sys.stderr)
    return code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(staged: bool = False) -> dict:
    """``BENCHMARK.json``; with ``staged`` also the cells of
    ``benchmarks/staged/<cell>.json`` merged in, for the tests and
    ``calibrate.py``. A staged cell has every file of a cell and a check
    that holds, and is left out of the manifest until a bound can hold
    its rate. A staged metric that gives only ``name`` and ``workloads``
    adds the cell to that metric of the manifest."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    if not staged:
        return manifest
    for path in sorted((HERE / "staged").glob("*.json")):
        part = load_json(path)
        manifest["workloads"].append(part["workload"])
        for group in ("end_to_end", "per_layer"):
            have = {m["name"]: m for m in manifest[group]}
            for m in part[group]:
                if m["name"] in have:
                    have[m["name"]]["workloads"] += m["workloads"]
                else:
                    manifest[group].append(m)
    return manifest


def cell_of(manifest: dict, name: str):
    """(workload entry, configuration, traffic, limits) of cell ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(ROOT / cfgs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return w, cfg, traffic, limits


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether a metric belongs in cell ``cell``'s line: the cells its
    ``workloads`` key lists, or without the key every cell that reports
    the end-to-end metric it ``moves`` (an end-to-end metric without the
    key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmarks.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pin_cores() -> list:
    """Keep this process and the threads it starts to the last ``CORES``
    of the cores it may use, the same ones in every run."""
    allowed = sorted(os.sched_getaffinity(0))
    cores = allowed[-CORES:]
    os.sched_setaffinity(0, cores)
    return cores


def host_state(device) -> dict:
    """The 1-minute load average, and the host's microseconds to launch
    one small operation (``PROBE_LAUNCHES`` in a row on an idle device,
    which keeps up, so the host's time is read)."""
    import torch

    from benchmarks.harness.common import now, sync
    a = torch.zeros(64, device=device)
    sync(device)
    t0 = now()
    for _ in range(PROBE_LAUNCHES):
        a.add_(1.0)
    launch = now() - t0
    sync(device)
    return {"loadavg_1m": os.getloadavg()[0],
            "launch_us": 1e6 * launch / PROBE_LAUNCHES}


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        overrides=None, staged: bool = False) -> dict:
    """One run of cell ``workload`` on ``device``: set-up, the window (or
    the traced stretch), the check; the result line as a dict.
    ``overrides`` ({"config": {...}, "traffic": {...}}) updates the files'
    values, for the tests' small sizes; ``staged`` lets the tests run the
    staged cells."""
    import torch

    manifest = load_manifest(staged)
    w, cfg, traffic, limits = cell_of(manifest, workload)
    for key, d in (("config", cfg), ("traffic", traffic)):
        d.update((overrides or {}).get(key, {}))
    cuda = device.type == "cuda"
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32

    mod = importlib.import_module(f"benchmarks.drivers.{traffic['driver']}")
    unknown = set(traffic) - {"driver"} - set(mod.KEYS)
    if unknown:
        raise ValueError(f"traffic {w['traffic']!r}: the {traffic['driver']}"
                         f" driver reads no {sorted(unknown)}")
    drv = mod.Driver(cfg, traffic, seed, device)
    drv.setup()
    gc.collect()
    gc.freeze()
    host = {"before": host_state(device)}
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    ends = [m for m in manifest["end_to_end"] if applies(m, workload, set())]
    reported = {m["name"] for m in ends}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": w["chips"]}
    metrics = {}
    breakdown = None
    if trace:
        path = ROOT / "build" / "bench_traces" / f"{workload}.json"
        view = drv.traced(seconds, path)
        attempted, failed = view.units, 0
        for m in manifest["per_layer"]:
            if applies(m, workload, reported):
                value = reader(m["name"])(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=view.trace.busy_s(), window_s=view.wall_s)
        breakdown = {"device_ops": view.trace.top_ops(),
                     "idle_gaps": view.trace.idle_gaps()}
    else:
        win = drv.window(seconds)
        attempted, failed = win.units, win.failed
        values = drv.end_to_end(win)
        values["setup_s"] = setup_s
        for m in ends:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if cuda else 0)
    host["after"] = host_state(device)

    drv.release()
    readings = drv.check()
    checks, correct = {}, failed == 0
    for name, value in readings.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and limit is not None and value <= limit
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["host"] = host
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: the host drives the card, and idle
    # worker threads of the math libraries only take its cores
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    # every cache of this run inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    w = cell_of(load_manifest(), args.workload)[0]
    cores = pin_cores()
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark runs on the card only",
                    2)
    if torch.cuda.device_count() < w["chips"]:
        return fail(f"the cell needs {w['chips']} cards, "
                    f"{torch.cuda.device_count()} present", 2)
    sys.path.insert(0, str(ROOT))
    try:
        import pbml_mantle_convection_tpu_torch as program
    except ImportError as e:
        return fail(f"the program is not in this checkout ({e})", 2)
    if not Path(program.__file__).resolve().is_relative_to(ROOT):
        return fail(f"the program is not in this checkout (found "
                    f"{program.__file__})", 2)
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 device)
    loaded = forbidden_modules()
    if loaded:
        return fail(f"loaded after the window: {', '.join(loaded)}", 3)
    result["host"]["cores"] = cores
    for when in ("before", "after"):
        h = result["host"][when]
        print(f"host {when} the window: load {h['loadavg_1m']!r}, "
              f"launch_us {h['launch_us']!r}, cores {cores}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check failed_units {result['failed']} limit 0", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
