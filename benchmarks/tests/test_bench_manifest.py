"""The manifest (``BENCHMARK.json``) and the files it names: names and
units in the allowed characters, every workload's configuration, traffic
and limits on disk, every per-layer metric with a reader and an
end-to-end metric that each of its cells reports, the bounds and the run
length inside the contract, and ``run.py``'s refusal without a card."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
# the manifest with the staged cells merged in, as a later PR that lists
# them would have it
sys.path.insert(0, str(ROOT))
from benchmarks.run import load_manifest  # noqa: E402

WITH_STAGED = load_manifest(staged=True)
BOTH = pytest.mark.parametrize("manifest", [MANIFEST, WITH_STAGED],
                               ids=["committed", "with_staged"])
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"_dim$|_rank$|c_h|n_hidden|mlp_ratio|expansion)")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@BOTH
def test_keys_and_limits(manifest):
    assert set(manifest) == KEYS["top"]
    assert manifest["command"] == ["python3", "benchmarks/run.py"]
    assert manifest["paths"] == ["benchmarks"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    for c in manifest["configs"]:
        assert set(c) == KEYS["config"]
    for w in manifest["workloads"]:
        assert set(w) == KEYS["workload"]
        assert w["chips"] in (1, 4)
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@BOTH
def test_names_units_and_lines(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if group
                                            == "configs" else ()):
                if key in e:
                    assert one_line(e[key]), (e["name"], key)
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in manifest[group]]
        assert len(ns) == len(set(ns))
    for word in manifest["command"]:
        assert one_line(word)


@BOTH
def test_workload_files_exist_and_pairs_unique(manifest):
    cfgs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in cfgs
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads(
            (BENCH / "limits" / f"{w['name']}.json").read_text())
        assert all(isinstance(v, float) and v > 0 for v in limits.values())
    assert used == set(cfgs)
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmarks/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
        assert (BENCH / "models" / f"{cfg['family']}.py").exists()


def test_at_most_a_quarter_on_four_chips():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


@BOTH
def test_every_metric_reported_where_it_moves(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    ends = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in ends and "workloads" not in ends["setup_s"]

    def reports(cell, name):
        m = ends[name]
        return "workloads" not in m or cell in m["workloads"]

    for cell in cells:
        assert sum(reports(cell, n) for n in ends if n != "setup_s") >= 1
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in ends and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(cell, m["moves"]), (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_full_check_fits_the_day():
    n = 24
    total = ((2 + 14 * n) * (MANIFEST["run_seconds"] + 60)
             + n * 2 * 90 + 1200)
    assert total <= 43200


@BOTH
def test_metric_readers_have_read(manifest):
    for m in manifest["per_layer"]:
        tree = ast.parse((BENCH / "metrics" / f"{m['name']}.py")
                         .read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body), m["name"]


def test_run_fails_without_a_card():
    cmd = [sys.executable, str(BENCH / "run.py"), "--workload",
           MANIFEST["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
           "--seconds", "1", "--trace", "0"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=120)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would measure")
    assert r.returncode != 0
    assert r.stdout.strip() == ""

