"""Nothing under ``benchmarks/`` imports JAX, Flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the port."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pbml_mantle_convection_tpu"}
PORT = "pbml_mantle_convection_tpu_torch"


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports
    inside ``benchmarks`` as ``benchmarks``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("benchmarks" if node.level else
                      node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_no_jax_anywhere():
    assert len(sources()) > 20
    for path in sources():
        bad = imported(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


def test_reference_takes_nothing_of_the_port():
    """The reference imports numpy, torch, the standard library and its
    own modules, nothing else."""
    allowed = {"numpy", "torch", "math", "functools", "__future__",
               "benchmarks"}
    for path in (BENCH / "reference").glob("*.py"):
        assert imported(path) <= allowed, path.name
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, path.name
