"""What the benchmark imports, and its operation counts against hand counts
on small shapes."""

from __future__ import annotations

import ast

import pytest
import torch

from mvs_bench import counts, reference, trace
from mvs_bench.tests.conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "cl_multiview_stereo_tpu"}
PORT = "cl_multiview_stereo_tpu_torch"
# the modules of the yardstick that may not lean on the program
PLAIN = ("reference.py", "judge.py", "scenes.py", "counts.py", "trace.py")


def _imports(path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for p in files:
        assert not (_imports(p) & FORBIDDEN), p


def test_the_reference_and_the_yardstick_import_nothing_of_the_port():
    for name in PLAIN:
        assert PORT not in _imports(BENCH / name), name
    for p in (BENCH / "metrics").glob("*.py"):
        assert PORT not in _imports(p), p


def _shapes(**kw) -> counts.Shapes:
    base = dict(v=1, h=4, w=6, mh=2, mw=3, levels=2, pairs=0, moves=(2,), taps=(8, 12), valid_moves=(5,),
                valid_refits=1, spixl=2, no_iter=1)
    return counts.Shapes(**{**base, **kw})


def test_lab_counts_a_pixel_by_hand():
    assert counts.lab(_shapes(v=2, h=3, w=5)) == (2 * 15 * 15, 33 * 30)


def test_slic_candidates_by_hand():
    # W = 2, H = 1, S = 2, a 1 x 1 map: pixel 0 (parity 0) sees cell rows
    # -1, 0 and columns -1, 0: one candidate on the map; pixel 1 (column
    # parity 1) sees rows 0, 1: one again
    s = _shapes(h=1, w=2, mh=1, mw=1, spixl=2)
    assert counts.slic_candidates(s) == 2
    n_bytes, n_ops = counts.slic(s, members=2)
    assert n_bytes == 2 * (16 * 2 + 20) + (16 * 2 + 24) and n_ops == 2 * 18 * 2 + 5 * 2 + 59


def test_slic_members_by_hand():
    labels = torch.tensor([[[0, 1, 5, -1]]], dtype=torch.int32)  # 1 x 4 pixels, S = 2, a 1 x 2 map
    assert counts.slic_members(labels, _shapes(h=1, w=4, mh=1, mw=2, spixl=2)) == 2


def test_extent_sectors_by_hand():
    # one view of 1 x 16 pixels, S = 2: a centre at x = 2 reaches x = 1 and 3
    centers = torch.tensor([[[[2.0, 0.0]]]])
    assert counts.extent_sectors((1, 1, 16), centers, 2) == 1
    assert counts.extent(_shapes(mh=1, mw=1), 1) == (32 + 40, 0)


def test_cost_volume_terms_by_hand():
    st = reference.Settings(array_width=2, array_height=1, neib_hor=1, neib_ver=0, bl_ratio=1.0)
    s = _shapes(v=2, h=1, w=8, mh=1, mw=1, levels=1)
    centers = torch.tensor([[[[4.0, 0.0]]], [[[4.0, 0.0]]]])
    step = torch.ones((2, 1, 1, 2))
    levels = torch.tensor([2.0])
    # x samples 2..6, y samples -2..2 of which only 0 is in the image; view
    # 0 against +1 (x - 2 in -1..8: all 5), view 1 against -1 (x + 2 < 8: 4)
    valid, pairs = counts.cost_volume_terms(centers, step, levels, s, st)
    assert (valid, pairs) == (5 + 4, 2)
    n_bytes, n_ops = counts.cost_volume(s, valid, pairs)
    assert n_bytes == 12 * 16 + 32 + 4 + 8 and n_ops == 9 * 9 + (50 - 9) + 2


def test_refinement_counts_by_hand():
    s = _shapes(v=1, h=2, w=2, mh=1, mw=2, pairs=3, moves=(2,), taps=(8, 12), valid_moves=(3,), valid_refits=1)
    cells, px = 2, 4
    # launches: the init (1 move), the sweep's update (2) and refit (8, one d row)
    assert counts.consistency(s) == (
        3 * (116 * cells + 4 * px) + 4 * cells * (1 + 2 + 1) + 16 * cells * (1 + 2 + 8),
        (1 + 2 + 8) * 2 * 9 * (3 * 36 + 1 * 8))
    assert counts.smoothness(s) == (
        28 * cells * 2 + 4 * cells * (1 + 2 + 1) + 16 * cells * (1 + 2 + 8),
        14 * cells * (8 + 12) + 12 * cells * (1 * 8 + 2 * 12 + 8 * 12))
    assert counts.chain(s) == (44 * cells + 8 * (3 + 1) + 16 * 2 * cells + 96 * cells + 32 * cells,
                               19 * 2 * cells + 5 * (3 + 1) + 20 * 8 * cells + 2 * 8 * cells)
    assert counts.raster(s) == (2 * (4 * px + 24 * cells + 12 * px + 16 * px) + 4 * px + 24 * cells + 4 * px,
                                3 * 8 * px)


def test_shapes_of_the_reference_settings():
    s = counts.shapes(reference.Settings(), 9, 1080, 1920)
    assert (s.mh, s.mw, s.levels, s.pairs) == (135, 240, 31, 40)
    assert s.taps == (60, 60, 32, 24, 20, 16) and len(s.moves) == 5
    assert counts.least_ms(3.35e9, 0) == pytest.approx(1.0)


def test_the_trace_arithmetic():
    ops = [trace.Op("a", 0.0, 10.0, 0.0), trace.Op("b", 5.0, 20.0, 1.0), trace.Op("c", 30.0, 40.0, None)]
    assert trace.busy_us(ops, (0.0, 50.0)) == 30.0
    assert trace.idle_gaps(ops, (0.0, 50.0)) == [(20.0, 30.0), (40.0, 50.0)]
    t = trace.Trace(ops, [("lab", 0.0, 0.5), ("slic", 0.5, 2.0)], [], (0.0, 50.0))
    assert trace.by_launch_range(t) == {"lab": 0.01, "slic": 0.015, "unlinked": 0.01}
    named = [trace.Op("void (anonymous namespace)::raster_kernel<4, 1, true>(int const*)", 0.0, 2000.0, 0.0)]
    assert trace.kernel_ms(named, ("raster_kernel",)) == 2.0 and trace.kernel_ms(named, ("lab_kernel",)) is None
