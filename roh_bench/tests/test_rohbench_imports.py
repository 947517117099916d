"""Nothing the harness runs imports JAX, the JAX package or the repo's
other scripts, and the reference imports nothing of the program: an
AST check of every import, top-level module names compared whole (the
port's name begins with the JAX package's)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "garlic_tpu", "bench", "bench_scaling",
             "tests", "chip_smoke"}
# the reference, what it imports and the side inputs' writers, which
# write what the program and the reference both read: no part of the
# program either
REFERENCE = ("reference.py", "centromeres.py", "panel.py", "compare.py",
             "control.py", "inputs/genetic_map.py")


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    out = []
    for d, dirs, files in os.walk(ROOT):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_the_harness_has_files():
    names = {os.path.relpath(p, ROOT) for p in harness_files()}
    assert {"run.py", "harness.py", "reference.py",
            "metrics/k2_roofline_pct.py"} <= names


@pytest.mark.parametrize("path", harness_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    with open(path) as f:
        names = top_level_imports(f.read())
    assert not names & FORBIDDEN
    if os.path.relpath(path, ROOT) in REFERENCE:
        assert "garlic_tpu_torch" not in names


@pytest.mark.parametrize("src,bad", [
    ("import jax.numpy as jnp", {"jax"}),
    ("from garlic_tpu.ops import lod", {"garlic_tpu"}),
    ("import garlic_tpu_torch, chip_smoke", {"chip_smoke"}),
    ("from garlic_tpu_torch.pipeline import run_main", set()),
    ("from . import bench", set())])
def test_names_are_compared_whole(src, bad):
    assert top_level_imports(src) & FORBIDDEN == bad
