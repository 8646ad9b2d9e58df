"""Nothing under portbench imports JAX, the JAX package, ``bench.py`` or
``tools/``, and the reference imports nothing of the port either. Module
names are compared by their top-level name, whole: the port's name,
``pislam_tpu_torch``, begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pislam_tpu", "bench", "tools", "__graft_entry__"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_package_or_tools(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_top_level_imports(path)) & (FORBIDDEN | {"pislam_tpu_torch"})


def test_forbidden_modules_compares_whole_names():
    assert run.forbidden_modules(["pislam_tpu_torch", "pislam_tpu_torch.ops.kernels",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["pislam_tpu.config", "jax.numpy", "jaxlib",
                                  "flax"]) == ["flax", "jax", "jaxlib", "pislam_tpu"]


def test_no_file_read_from_the_jax_side():
    """No path string names bench.py, tools/ or the BENCH_* records."""
    for path in FILES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("bench.py", "tools/", "BENCH_", "__graft_entry__"):
            assert name not in text, (path, name)
