"""The PyTorch port, chip_smoke.py, bench_torch.py and the port's tools
import nothing of JAX, Flax or the JAX package (the machine with the card
has none of them), importing the port builds no kernel, and the port's
lower layers (models, ops, physics) import nothing of the layers that
drive them (sim, cli, train, data, parallel)."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pbml_mantle_convection_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pbml_mantle_convection_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = (sorted(PORT.rglob("*.py"))
           + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
           + sorted((ROOT / "tools").glob("torch_port_*.py")))


LOWER = sorted(p for d in ("models", "ops", "physics")
               for p in (PORT / d).rglob("*.py"))
UPPER = ("sim", "cli", "train", "data", "parallel")


def _port_imports(path: Path):
    """The port's subpackages that ``path`` imports from, relative
    imports resolved."""
    package = path.relative_to(ROOT).parent.parts
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name.split(".") for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = (list(package[:len(package) - node.level + 1])
                    if node.level else [])
            mod = base + (node.module.split(".") if node.module else [])
            names = ([mod] if node.module
                     else [mod + [a.name] for a in node.names])
        else:
            continue
        for parts in names:
            if len(parts) > 1 and parts[0] == PORT.name:
                yield parts[1]


@pytest.mark.parametrize("path", LOWER,
                         ids=[str(p.relative_to(ROOT)) for p in LOWER])
def test_lower_layers_import_no_upper_layer(path):
    bad = sorted(set(_port_imports(path)) & set(UPPER))
    assert not bad, f"{path.relative_to(ROOT)} imports from {bad}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_a_card():
    """Importing builds nothing and touches no device (kernels are built
    at their first CUDA call)."""
    import pbml_mantle_convection_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    assert len(names) >= 20
    for name in names:
        importlib.import_module(name)
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    assert _cuda.library.cache_info().currsize == 0
    for src in _cuda.SOURCES + _cuda.HEADERS:
        assert (_cuda.CSRC / src).is_file()
