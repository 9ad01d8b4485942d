"""Static check that the PyTorch port stands alone: no module of
`normal_clustering_nerf_torch/`, not `chip_smoke.py`, not
`time_encodes.py` and not `time_calls.py` imports JAX, jaxlib or the JAX
package `normal_clustering_nerf_tpu`.

The check reads the sources (an AST scan) instead of importing them,
because a process may have JAX imported before any test runs.
"""
import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "normal_clustering_nerf_tpu")
SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "normal_clustering_nerf_torch").rglob("*.py")
) + ["chip_smoke.py", "time_encodes.py", "time_calls.py"]


def imported_modules(tree: ast.AST):
    """Every module an import statement, `importlib.import_module(...)` or
    `__import__(...)` with a literal name brings in."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            arg = node.args[0]
            if (name in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                yield arg.value


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_scan_sees_every_form_of_import():
    src = ("import jax.numpy as jnp\nfrom jaxlib import xla_client\n"
           "from normal_clustering_nerf_tpu.ops import composite\n"
           "import importlib\nimportlib.import_module('jax')\n"
           "__import__('normal_clustering_nerf_tpu')\n"
           "from . import kernels\nimport torch\n")
    found = [m for m in imported_modules(ast.parse(src)) if forbidden(m)]
    assert found == ["jax.numpy", "jaxlib", "normal_clustering_nerf_tpu.ops",
                     "jax", "normal_clustering_nerf_tpu"]


def test_the_port_has_files_to_scan():
    assert "normal_clustering_nerf_torch/kernels.py" in SOURCES
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted(m for m in imported_modules(tree) if forbidden(m))
    assert not bad, f"{path} imports {bad}"
