"""The port's MVSPipeline end to end against the JAX pipeline, plus the
port's import boundary."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from torch_parity import CPU, jax_settings, n, scenes, small_settings

PORT = Path(__file__).resolve().parent.parent / "cl_multiview_stereo_tpu_torch"
# the port imports neither JAX nor any module of the JAX package
FORBIDDEN = ("jax", "jaxlib", "cl_multiview_stereo_tpu")


@pytest.fixture(scope="module")
def runs():
    """tests/test_pipeline.py's scene through both pipelines, strips method."""
    s = small_settings()
    views, jviews = scenes(
        "two_plane_scene", 48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0,
        bl_ratio=1.0, seed=11,
    )
    port = MVSPipeline.create(64, 48, s, device=CPU, depth_method="strips").run(views)
    ref = JaxPipeline.create(64, 48, jax_settings(s), depth_method="strips").run(jviews)
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


# one case per knob of the JAX MVSPipeline beyond the defaults:
# (SystemSettings overrides, MVSPipeline.create keywords)
KNOBS = {
    "cross_check": ({}, {"cross_check": True}),
    "edge_enable": ({"edge_enable": True}, {}),
    "enforce_connectivity": ({"enforce_connectivity": True}, {}),
    "gather": ({}, {"depth_method": "gather"}),
    "view": ({}, {"pair_layout": "view"}),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_pipeline_knob_matches_jax(knob):
    """Each knob against the JAX pipeline at test_pipeline_matches_jax's
    bounds."""
    overrides, kw = KNOBS[knob]
    s = small_settings(**overrides)
    views, jviews = scenes(
        "two_plane_scene", 48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0,
        bl_ratio=1.0, seed=11,
    )
    port = MVSPipeline.create(64, 48, s, device=CPU, **kw).run(views)
    ref = JaxPipeline.create(64, 48, jax_settings(s), **kw).run(jviews)
    assert (n(port.labels) == np.asarray(ref.labels)).mean() > 0.995
    agree = (n(port.disp_init) == np.asarray(ref.disp_init)).mean()
    assert agree >= 0.99, f"disp_init agreement {agree}"
    d, dj = n(port.disp_full), np.asarray(ref.disp_full)
    close = (np.abs(d - dj) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"
    if knob == "cross_check":
        assert (d == 0).any(), "the vote rejected nothing"
    if knob == "enforce_connectivity":
        # the vote moves labels two cells from their home cell, past the
        # one-cell reach of plain SLIC; the port's direct label gathers
        # (fusion.gather_cells, refine.rasterize_table, the extent walk)
        # take any label, where the JAX lookups need label_radius=3
        labels = n(port.labels)
        home_x = np.arange(64)[None, None, :] // s.spixl_size
        home_y = np.arange(48)[None, :, None] // s.spixl_size
        reach = max(np.abs(labels % 8 - home_x).max(), np.abs(labels // 8 - home_y).max())
        assert reach > 1, reach


def test_create_rejects_unknown_knobs():
    for kw in ({"depth_method": "sparse"}, {"pair_layout": "diagonal"}):
        with pytest.raises(ValueError):
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
    else:
        paths = [PORT.parent / "chip_smoke.py"]
    bad = [
        f"{path.name}:{line} imports {name}"
        for path in paths
        for line, name in _imports(path)
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN)
    ]
    assert paths and not bad, bad
