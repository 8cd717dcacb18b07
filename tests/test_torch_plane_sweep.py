"""Dense plane sweep: the port's ``plane_sweep_depth`` on CPU tensors (its
plain twin) against JAX's XLA form and the Pallas ``_sweep_kernel`` in
interpret mode, bitwise, on tests/test_pallas_sweep.py's cases and on a
ladder that pins the double-precision shift tables; the kernel's chunk
tables and, in torch, its slab indexing.  The CUDA kernel against the twin
is in test_torch_kernels_cuda.py."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models import plane_sweep as jps
from cl_multiview_stereo_tpu.ops.pallas.sweep import plane_sweep_pallas
from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_disp_levels, build_view_subsets
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


# csrc/sweep.cu's tile, KWARPS_Y * KROWS rows by KWARPS_X * (32 - 2r)
# columns; its kChunk and kSpare are ops/sweep.py's CHUNK and SPARE
# (test_kernel_constants_match_the_host)
KWARPS_X, KWARPS_Y, KROWS = 2, 4, 4
TILE_H = KWARPS_Y * KROWS


def _tile_w(radius):
    return KWARPS_X * (32 - 2 * radius)


REF = SystemSettings()
REF_PAIRS = plane_sweep.build_pairs(*build_view_subsets(REF), REF.array_width)
HORIZONTAL = ((0, 1, 1, 0), (1, 0, -1, 0))

# (ladder, pairs, bl_ratio, expected chunk bounds)
CHUNK_CASES = {
    # the reference ladder 30..60: ceil(31 / 8) chunks
    "reference": (build_disp_levels(REF), REF_PAIRS, REF.bl_ratio, [0, 8, 16, 24, 31]),
    # an unsorted ladder whose jumps (30 px) exceed the spare: each closes a chunk
    "unsorted": ([30.0, 60.0, 31.0, 45.5], REF_PAIRS, REF.bl_ratio, [0, 1, 2, 4]),
    "nonuniform": ([30.0, 40.5, 60.0], REF_PAIRS, REF.bl_ratio, [0, 2, 3]),
    "D=1": ([40.0], REF_PAIRS, REF.bl_ratio, [0, 1]),
    # a spread of exactly SPARE fits, one more closes the chunk
    "spread-at-spare": ([0.0, 16.0, 17.0], HORIZONTAL, 1.0, [0, 2, 3]),
    "roofline-D64": ([float(d) for d in range(4, 68)], HORIZONTAL, 1.0, list(range(0, 65, 8))),
    "no-pairs": ([4.0, 5.0, 6.0], (), 1.0, [0, 3]),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_tables(case):
    """The chunks cover the ladder in order, each at most CHUNK long; each
    closes early only where the next hypothesis would spread some pair's
    shifts past SPARE; every (pair, hypothesis) read of a tile falls inside
    its chunk's slab; the box is the chunk's max and min shifts."""
    ladder, pairs, bl, want = CHUNK_CASES[case]
    _, _, shifts = sweep.pair_tables(ladder, pairs, bl, 9)
    bounds, box = sweep.chunk_tables(shifts)
    assert bounds.tolist() == want
    assert box.shape == (len(pairs), len(bounds) - 1, 4) and box.dtype == np.int32
    s = shifts[..., :2].astype(np.int64)
    for c, (a, b) in enumerate(zip(bounds, bounds[1:])):
        assert 0 < b - a <= sweep.CHUNK
        if b - a < sweep.CHUNK and b < len(ladder):
            grown = s[:, a:b + 1]
            assert (grown.max(1) - grown.min(1) > sweep.SPARE).any()
        np.testing.assert_array_equal(box[:, c, :2], s[:, a:b].max(1))
        np.testing.assert_array_equal(box[:, c, 2:], s[:, a:b].min(1))
        for r in range(sweep.MAX_RADIUS + 1):
            halo = np.array([TILE_H + 2 * r, _tile_w(r) + 2 * r])
            extent = halo + box[:, c, :2] - box[:, c, 2:]  # the slab's rows, columns
            assert (extent <= halo + sweep.SPARE).all()
            for d in range(a, b):
                # slab row of halo row i: i + max sy - sy, in [0, extent)
                first = box[:, c, :2] - s[:, d]
                assert (first >= 0).all() and (first + halo <= extent).all()


def test_kernel_constants_match_the_host():
    src = (Path(sweep.__file__).parent.parent / "csrc" / "sweep.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kChunk"), const("kSpare"), const("kMaxR")) == (sweep.CHUNK, sweep.SPARE, sweep.MAX_RADIUS)
    assert (const("kWarpsX"), const("kWarpsY"), const("kRows")) == (KWARPS_X, KWARPS_Y, KROWS)
    assert KWARPS_Y * KROWS == sweep.TILE_ROWS  # kTileH, the rows a band is padded to


def _emulate_kernel(lab, ladder, pairs, bl_ratio, radius):
    """csrc/sweep.cu's indexing in torch: for each (view, chunk, pair) every
    tile's slab staged from the chunk tables at clamped coordinates, and
    each hypothesis read at slab row (y - sy) - row0, column (x - sx) -
    col0, with no clamp; box sums, min over pairs and WTA as the kernel
    takes them."""
    v, h, w = lab.shape[:3]
    start, view, shifts = sweep.pair_tables(ladder, pairs, bl_ratio, v)
    bounds, box = sweep.chunk_tables(shifts)
    tile_w = _tile_w(radius)
    n_ty, n_tx = -(-h // TILE_H), -(-w // tile_w)
    hh, hw = TILE_H + 2 * radius, tile_w + 2 * radius
    planar = lab.permute(0, 3, 1, 2)  # (V, 3, H, W)
    ty0, tx0 = torch.arange(n_ty) * TILE_H, torch.arange(n_tx) * tile_w
    ys = (ty0 - radius)[:, None] + torch.arange(hh)  # (tiles, halo) image rows
    xs = (tx0 - radius)[:, None] + torch.arange(hw)
    in_img = ((ys >= 0) & (ys < h))[:, :, None, None] & ((xs >= 0) & (xs < w))[None, None]
    disp = torch.zeros((v, n_ty, TILE_H, n_tx, tile_w))
    cost = torch.full((v, n_ty, TILE_H, n_tx, tile_w), 1.0e6)
    for ref in range(v):
        ref_halo = planar[ref][:, ys.clamp(0, h - 1)][..., xs.clamp(0, w - 1)]  # (3, ty, hh, tx, hw)
        for c, (a, b) in enumerate(zip(bounds, bounds[1:])):
            m = torch.full((b - a, n_ty, TILE_H, n_tx, tile_w), 1.0e6)
            for p in range(start[ref], start[ref + 1]):
                my, mx, ny, nx = (int(k) for k in box[p, c])
                rows, cols = hh + my - ny, hw + mx - nx
                assert rows <= hh + sweep.SPARE and cols <= hw + sweep.SPARE
                slab_r = ((ty0 - radius - my)[:, None] + torch.arange(rows)).clamp(0, h - 1)
                slab_c = ((tx0 - radius - mx)[:, None] + torch.arange(cols)).clamp(0, w - 1)
                slab = planar[int(view[p])][:, slab_r][..., slab_c]  # (3, ty, rows, tx, cols)
                for d in range(a, b):
                    sy, sx, loy, lox = (int(k) for k in shifts[p, d])
                    i = torch.arange(hh) + my - sy  # (y - sy) - row0 for halo row y
                    j = torch.arange(hw) + mx - sx
                    assert int(i.min()) >= 0 and int(i.max()) < rows
                    assert int(j.min()) >= 0 and int(j.max()) < cols
                    diff = (ref_halo - slab[:, :, i][..., j]).abs()
                    sad = (diff[0] + diff[1]) + diff[2]
                    valid = (((ys >= loy) & (ys <= h - 1 + sy))[:, :, None, None]
                             & ((xs >= lox) & (xs <= w - 1 + sx))[None, None])
                    sad = torch.where(in_img, torch.where(valid, sad, 30.0), 0.0)
                    acc = sad[:, 0:TILE_H]
                    for k in range(1, 2 * radius + 1):
                        acc = acc + sad[:, k:k + TILE_H]
                    out = acc[..., 0:tile_w]
                    for k in range(1, 2 * radius + 1):
                        out = out + acc[..., k:k + tile_w]
                    m[d - a] = torch.minimum(m[d - a], out)
            for d in range(a, b):
                take = m[d - a] < cost[ref]
                cost[ref] = torch.where(take, m[d - a], cost[ref])
                disp[ref] = torch.where(take, float(np.float32(ladder[d])), disp[ref])
    crop = (v, n_ty * TILE_H, n_tx * tile_w)
    return disp.reshape(crop)[:, :h, :w], cost.reshape(crop)[:, :h, :w]


ODD = SystemSettings(array_width=3, array_height=3, min_disp=10, max_disp=20, inc=1)
ODD_PAIRS = plane_sweep.build_pairs(*build_view_subsets(ODD), ODD.array_width)

# (ladder, radius) on the 9x53x131 scene with its 40 pairs
EMULATION_CASES = {
    "D11-r2": (range(10, 21), 2),
    "D11-r0": (range(10, 21), 0),
    "D11-r4": (range(10, 21), 4),
    "D9-r2": (range(10, 19), 2),
    "D1-r2": ([12.0], 2),
    "unsorted-r2": ([30.0, 60.0, 31.0, 45.5], 2),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_slab_indexing_emulation_matches_reference(case):
    ladder, radius = EMULATION_CASES[case]
    ladder = [float(d) for d in ladder]
    rng = np.random.default_rng(4)
    lab = t(rng.uniform(0, 100, (9, 53, 131, 3)).astype(np.float32))
    got = _emulate_kernel(lab, ladder, ODD_PAIRS, ODD.bl_ratio, radius)
    want = plane_sweep.plane_sweep_reference(lab, ladder, ODD_PAIRS, ODD.bl_ratio, radius)
    for k, field in enumerate(("disp", "cost")):
        np.testing.assert_array_equal(n(got[k]), n(want[k]), err_msg=field)


def test_kernel_tables_pack_every_table_once():
    """One int32 array holds the CSR, the shifts, the ladder's float32 bits
    and the chunk tables, each at its offset."""
    ladder = [30.0, 40.5, 60.0]
    packed, at = sweep.kernel_tables(ladder, REF_PAIRS, REF.bl_ratio, 9)
    start, view, shifts = sweep.pair_tables(ladder, REF_PAIRS, REF.bl_ratio, 9)
    bounds, box = sweep.chunk_tables(shifts)
    assert packed.dtype == np.int32
    parts = dict(start=start, view=view, shifts=shifts, ladder=np.asarray(ladder, np.float32).view(np.int32),
                 bounds=bounds, box=box)
    assert list(at) == list(parts) and at["start"] == 0
    ends = list(at.values())[1:] + [packed.size]
    for (k, want), end in zip(parts.items(), ends):
        np.testing.assert_array_equal(packed[at[k]:end], want.reshape(-1), err_msg=k)
    assert packed[at["ladder"]:at["bounds"]].view(np.float32).tolist() == ladder
