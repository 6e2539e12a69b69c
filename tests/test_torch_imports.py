"""The port stands alone: no module of fedml_tpu_torch, and neither
chip_smoke.py nor the tools/torch_*.py scripts, imports JAX or anything of
the JAX package."""

import ast
import pathlib

import jax  # noqa: F401
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "fedml_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob(
        "torch_*.py"))
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad
