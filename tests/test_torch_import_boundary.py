"""The port stands alone: no source file of ``cl_multiview_stereo_tpu_torch``
and not ``chip_smoke.py`` imports JAX, jaxlib or the JAX package, at module
level or inside a function, and the port, every submodule and the smoke
script import in a process where those names are blocked."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "cl_multiview_stereo_tpu_torch"
BLOCKED = ("jax", "jaxlib", "cl_multiview_stereo_tpu")
# build outputs under _build/ are not sources
SOURCES = sorted(
    str(p.relative_to(REPO)) for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts
) + ["chip_smoke.py"]


def _imported(tree: ast.AST):
    """(line, top-level module name) of every import statement, and of every
    ``importlib.import_module``/``__import__`` call with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text(), path)
    bad = [f"{path}:{line} imports {name}" for line, name in _imported(tree) if name in BLOCKED]
    assert not bad, bad


def test_imported_finds_nested_and_dynamic_imports():
    """The scan itself: imports inside functions and literal dynamic ones."""
    src = textwrap.dedent("""
        import os
        def f():
            from cl_multiview_stereo_tpu.config import SystemSettings
            import jax.numpy as jnp
        importlib.import_module("jaxlib.xla_client")
        from . import sibling
        from cl_multiview_stereo_tpu_torch import config
    """)
    names = sorted(name for _, name in _imported(ast.parse(src)))
    assert names == sorted(["os", "cl_multiview_stereo_tpu", "jax", "jaxlib",
                            "cl_multiview_stereo_tpu_torch"])


def test_port_imports_with_jax_blocked():
    """``sys.modules[name] = None`` makes any import of ``name`` raise, so
    the process imports the port only if nothing on its import paths, and
    nothing a submodule imports at top level, reaches JAX or its package."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None

        def fail(name):
            raise ImportError(f"cannot import {{name}}")

        import cl_multiview_stereo_tpu_torch as port
        names = [port.__name__]
        for info in pkgutil.walk_packages(port.__path__, port.__name__ + ".", onerror=fail):
            importlib.import_module(info.name)
            names.append(info.name)
        import chip_smoke
        print("\\n".join(names))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    port = "cl_multiview_stereo_tpu_torch"
    want = {f"{port}.{m}" for m in (
        "config", "io.images", "io.pointcloud", "testing.synthetic", "cli",
        "models.mvs_pipeline", "models.plane_sweep", "ops.cost_volume", "ops.consistency",
        "ops.sweep", "kernels.build", "utils.artifacts",
    )}
    assert want <= names, sorted(want - names)
