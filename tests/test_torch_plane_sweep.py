"""Dense plane sweep: the port's ``plane_sweep_depth`` on CPU tensors (its
plain twin) against JAX's XLA form and the Pallas ``_sweep_kernel`` in
interpret mode, bitwise, on tests/test_pallas_sweep.py's cases and on a
ladder that pins the double-precision shift tables.  The CUDA kernel
against the twin is in test_torch_kernels_cuda.py."""

import math

import numpy as np
import pytest

from cl_multiview_stereo_tpu.models import plane_sweep as jps
from cl_multiview_stereo_tpu.ops.pallas.sweep import plane_sweep_pallas
from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_view_subsets
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.models import plane_sweep
from cl_multiview_stereo_tpu_torch.ops import sweep
from torch_parity import n, t

BL = 1.0359
# f32(11 / 1.0359): the double product BL*d is 11.0000003 (ceil 12), the
# f32 product rounds to 11.0 (ceil 11), so an f32 shift table reads
# another row than the JAX forms
SPLIT_D = float(np.float32(11 / BL))


def _check(lab, ladder, pairs, bl_ratio):
    """Port (CPU) == JAX XLA == JAX Pallas (interpret), disp and cost."""
    import jax.numpy as jnp

    ladder = tuple(float(d) for d in ladder)
    got = plane_sweep.plane_sweep_depth(t(lab), ladder, pairs, bl_ratio, 2)
    xla = jps.plane_sweep_depth(jnp.asarray(lab), ladder, pairs, bl_ratio, 2)
    pallas = plane_sweep_pallas(jnp.asarray(lab), ladder, pairs, bl_ratio, tile_h=16, interpret=True)
    for name, want in (("xla", xla), ("pallas", pallas)):
        for k, field in enumerate(("disp", "cost")):
            np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), err_msg=f"{name} {field}")


@pytest.mark.parametrize("dv", [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, 1)])
def test_single_pair_matches_jax(dv):
    rng = np.random.default_rng(0)
    lab = rng.uniform(0, 100, (2, 48, 160, 3)).astype(np.float32)
    _check(lab, range(5, 13), ((0, 1, dv[0], dv[1]),), 1.03590)


def test_multiview_odd_shape_matches_jax():
    rng = np.random.default_rng(1)
    s = SystemSettings(array_width=3, array_height=3, min_disp=10, max_disp=20, inc=1)
    pairs = plane_sweep.build_pairs(*build_view_subsets(s), s.array_width)
    lab = rng.uniform(0, 100, (9, 53, 131, 3)).astype(np.float32)
    _check(lab, range(10, 21), pairs, s.bl_ratio)


def test_double_precision_shift_table_matches_jax():
    """A ladder value whose vertical shift differs between the double and
    the f32 product: the port must take the double one, as JAX does."""
    assert math.ceil(BL * SPLIT_D) != math.ceil(float(np.float32(BL) * np.float32(SPLIT_D)))
    sy, _, loy, _ = sweep.shift_table([SPLIT_D], 0, 1, BL)[0]
    assert (sy, loy) == (12, 11)
    rng = np.random.default_rng(2)
    lab = rng.uniform(0, 100, (2, 48, 160, 3)).astype(np.float32)
    _check(lab, (9.0, 10.0, SPLIT_D, 11.0, 12.0), ((0, 1, 0, 1), (1, 0, 0, -1)), BL)


@pytest.mark.parametrize("grid", [(2, 2), (3, 3), (4, 1)], ids=str)
def test_build_pairs_matches_jax(grid):
    s = SystemSettings(array_width=grid[0], array_height=grid[1])
    subset, counts = build_view_subsets(s)
    assert plane_sweep.build_pairs(subset, counts, s.array_width) == jps.build_pairs(
        subset, counts, s.array_width
    )


def test_kernel_pair_tables():
    """The kernel's CSR tables: pairs grouped by reference view in subset
    order, each with the twin's shift table."""
    s = SystemSettings()
    pairs = plane_sweep.build_pairs(*build_view_subsets(s), s.array_width)
    ladder = [30.0, 40.5, 60.0]
    start, view, shifts = sweep.pair_tables(ladder, pairs, s.bl_ratio, 9)
    assert start.tolist() == [0, 3, 8, 11, 16, 24, 29, 32, 37, 40]
    assert view.tolist() == [p[1] for p in pairs]
    for i, (_, _, dvx, dvy) in enumerate(pairs):
        assert shifts[i].tolist() == [list(r) for r in sweep.shift_table(ladder, dvx, dvy, s.bl_ratio)]
    with pytest.raises(ValueError):
        sweep.pair_tables(ladder, ((0, 9, 1, 0),), s.bl_ratio, 9)


def test_cpu_tensor_runs_the_twin_without_the_build(monkeypatch):
    """A CPU tensor takes the plain twin: no build, no launch counted; a
    view with no pairs keeps (0, 1e6)."""
    def no_build(name):
        raise AssertionError(f"the CPU path tried to build {name}")

    monkeypatch.setattr(build, "load", no_build)
    rng = np.random.default_rng(3)
    lab = t(rng.uniform(0, 100, (3, 20, 24, 3)).astype(np.float32))
    pairs = ((0, 1, 1, 0), (1, 0, -1, 0))
    before = sweep.LAUNCHES
    disp, cost = plane_sweep.plane_sweep_depth(lab, [4.0, 5.0], pairs, 1.0)
    assert sweep.LAUNCHES == before
    want = plane_sweep.plane_sweep_reference(lab, [4.0, 5.0], pairs, 1.0)
    np.testing.assert_array_equal(n(disp), n(want[0]))
    np.testing.assert_array_equal(n(cost), n(want[1]))
    assert (n(disp[2]) == 0.0).all() and (n(cost[2]) == 1.0e6).all()
