"""The port's MVSPipeline end to end against the JAX pipeline, plus the
port's import boundary."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from torch_parity import CPU, n, small_settings

PORT = Path(__file__).resolve().parent.parent / "cl_multiview_stereo_tpu_torch"
# modules of the JAX package that import jax; the numpy-only ones
# (config, testing.synthetic, io.images) may be imported
FORBIDDEN = ("jax", "cl_multiview_stereo_tpu.ops", "cl_multiview_stereo_tpu.models",
             "cl_multiview_stereo_tpu.parallel", "cl_multiview_stereo_tpu.utils")


@pytest.fixture(scope="module")
def runs():
    """tests/test_pipeline.py's scene through both pipelines, strips method."""
    s = small_settings()
    views, gt = synthetic.two_plane_scene(
        48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=11
    )
    port = MVSPipeline.create(64, 48, s, device=CPU, depth_method="strips").run(views)
    ref = JaxPipeline.create(64, 48, s, depth_method="strips").run(views)
    return s, views, port, ref


def test_pipeline_matches_jax(runs):
    _, _, port, ref = runs
    assert (n(port.labels) == np.asarray(ref.labels)).mean() > 0.995
    agree = (n(port.disp_init) == np.asarray(ref.disp_init)).mean()
    assert agree >= 0.99, f"disp_init agreement {agree}"
    d, dj = n(port.disp_full), np.asarray(ref.disp_full)
    assert d.shape == (4, 48, 64) and d.dtype == np.float32
    close = (np.abs(d - dj) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"


def test_pipeline_recovers_ground_truth(runs):
    d = n(runs[2].disp_full)
    assert np.isfinite(d).all()
    near = (np.abs(d - 5.0) <= 1.5) | (np.abs(d - 9.0) <= 1.5)
    # tests/test_pipeline.py's bound for the JAX pipeline
    assert near.mean() > 0.55, f"near-GT fraction {near.mean()}"


def test_dense_method_is_the_same_function(runs):
    s, views, port, _ = runs
    dense = MVSPipeline.create(64, 48, s, device=CPU, depth_method="dense").run(views)
    np.testing.assert_array_equal(n(dense.disp_full), n(port.disp_full))


@pytest.mark.parametrize(
    "kw", [{"depth_method": "gather"}, {"cross_check": True}, {"pair_layout": "view"}],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        MVSPipeline.create(64, 48, small_settings(), device=CPU, **kw)


def test_convert_gives_explicit_dtypes():
    ck = {"state_d": np.zeros((1, 2, 3)), "state_sm": np.zeros((1, 2, 3)),
          "state_cs": np.zeros((1, 2, 3)), "state_n": np.zeros((1, 2, 3, 3)),
          "labels": np.zeros((1, 4, 4), np.int64)}
    state = convert.refine_state(ck, CPU)
    assert all(x.dtype == torch.float32 for x in state)
    assert convert.labels(ck, CPU).dtype == torch.int32


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_port_imports_no_jax(target):
    if target == "package":
        # build outputs under _build/ are not sources
        paths = [p for p in sorted(PORT.rglob("*.py")) if "_build" not in p.relative_to(PORT).parts]
        forbidden = FORBIDDEN
    else:
        # the smoke script reaches even the numpy-only reference modules
        # through the port's re-exports
        paths = [PORT.parent / "chip_smoke.py"]
        forbidden = ("jax", "cl_multiview_stereo_tpu")
    bad = [
        f"{path.name}:{line} imports {name}"
        for path in paths
        for line, name in _imports(path)
        if any(name == f or name.startswith(f + ".") for f in forbidden)
    ]
    assert paths and not bad, bad
