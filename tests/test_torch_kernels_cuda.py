"""The port's CUDA kernels against their plain twins, and the cross-check
fusion against its CPU run, on a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
CUDA device every test here skips.
"""

from functools import partial

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu_torch.config import (
    DerivedGeometry,
    RefinementSchedule,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu_torch.models import plane_sweep
from cl_multiview_stereo_tpu_torch.ops import (
    chain,
    color,
    consistency,
    cost_volume,
    crosscheck,
    fusion,
    raster,
    refine,
    slic,
    smoothness,
    superpixel,
    sweep,
)
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab, rgb_to_lab_reference
from cl_multiview_stereo_tpu_torch.testing import synthetic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(h, w, s, device, disp=7.0, seed=5):
    rgb, _ = synthetic.fronto_parallel_scene(
        h, w, s.array_width, s.array_height, disp=disp, bl_ratio=s.bl_ratio, seed=seed
    )
    geom = DerivedGeometry.create(w, h, s)
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    return lab.contiguous(), spmap.center.contiguous(), superpixel.extent_step(ext).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(48, 64), (61, 45)], ids=str)
@pytest.mark.parametrize("bl_ratio", [1.0, 1.0359, 0.97])
def test_cost_volume_kernel_matches_reference(cuda, hw, bl_ratio):
    s = SystemSettings(array_width=3, array_height=3, min_disp=4, max_disp=11, bl_ratio=bl_ratio)
    lab, centers, step = _inputs(*hw, s, cuda)
    levels = build_disp_levels(s)
    args = (lab, centers, step, levels, s.array_width, bl_ratio)
    before = cost_volume.LAUNCHES
    got = cost_volume.superpixel_cost_volume(*args)
    torch.cuda.synchronize()
    assert cost_volume.LAUNCHES == before + 1
    want = cost_volume.cost_volume_reference(*args)
    assert torch.equal(got, want), f"{int((got != want).sum())} outputs differ"


# chip_smoke.py's phase-2 shapes: the slice's 9-view 1080p scene, an odd
# small one, and 16-pixel superpixels on ragged 8x8-cell tiles with sample
# steps up to 7, whose boxes outgrow the shared-memory band
SMOKE_SHAPES = {
    "full-9x1080x1920": (dict(), (1080, 1920), 40.0),
    "odd-4x61x45": (dict(array_width=2, array_height=2, min_disp=4, max_disp=11), (61, 45), 7.0),
    "ragged-9x543x967-S16": (dict(spixl_size=16), (543, 967), 40.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
def test_cost_volume_kernel_bitwise_at_smoke_shapes(cuda, shape):
    overrides, (h, w), disp = SMOKE_SHAPES[shape]
    s = SystemSettings(**overrides)
    lab, centers, step = _inputs(h, w, s, cuda, disp=disp, seed=0)
    args = (lab, centers, step, build_disp_levels(s), s.array_width, s.bl_ratio)
    got = cost_volume.superpixel_cost_volume(*args)
    want = cost_volume.cost_volume_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} outputs differ"
    if shape.endswith("S16"):
        assert step.max().item() == 7.0


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["x", "y"])
def test_cost_volume_kernel_bitwise_at_the_rounding_edge(cuda, axis):
    """A read one pixel inside the image's far edge whose exact validity
    test passes but whose f32 difference rounds up to the edge: x - d*gx =
    W - 2**-20 rounds to W, so the sample costs 30.  Two views side by side
    (or stacked), one 8x8-cell tile of regular centres with step 1, so the
    tile's samples reach exactly to 62, and view 1 reads view 0 at
    62 - ceil(-d) = 63 = size - 1 for both d = 1 and d = 2 - 2**-20."""
    size = 64
    aw = 2 if axis == "x" else 1
    v = 2
    rng = np.random.default_rng(9)
    lab = torch.as_tensor(rng.uniform(0, 100, (v, size, size, 3)).astype(np.float32), device=cuda)
    grid = 8 * torch.arange(8, dtype=torch.float32) + 4.0
    cy, cx = torch.meshgrid(grid, grid, indexing="ij")
    centers = torch.stack([cx, cy], -1).expand(v, 8, 8, 2).contiguous().to(cuda)
    step = torch.ones((v, 8, 8, 2), dtype=torch.float32, device=cuda)
    levels = np.asarray([1.0, 2.0 - 2.0**-20], np.float32)
    # the reference's own test on the far sample of view 1 against view 0
    far = np.float32(62) + levels[1]
    assert far == np.float32(size)
    args = (lab, centers, step, levels, aw, 1.0)
    got = cost_volume.superpixel_cost_volume(*args)
    want = cost_volume.cost_volume_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} outputs differ"


@pytest.mark.cuda
def test_cost_volume_wrapper_rejects_bad_input(cuda):
    s = SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11)
    lab, centers, step = _inputs(48, 64, s, cuda)
    levels = build_disp_levels(s)
    with pytest.raises(TypeError):
        cost_volume.superpixel_cost_volume(lab.double(), centers, step, levels, 2, 1.0)
    with pytest.raises(ValueError):
        cost_volume.superpixel_cost_volume(lab, centers.cpu(), step, levels, 2, 1.0)
    with pytest.raises(ValueError):
        cost_volume.superpixel_cost_volume(
            lab.transpose(1, 2), centers, step, levels, 2, 1.0
        )


def _lab(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0, 100, shape).astype(np.float32), device=device)


def _sweep_matches(lab, ladder, pairs, bl_ratio, radius=2):
    before = sweep.LAUNCHES
    got = plane_sweep.plane_sweep_depth(lab, ladder, pairs, bl_ratio, radius)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    want = plane_sweep.plane_sweep_reference(lab, ladder, pairs, bl_ratio, radius)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dv", [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, 1)])
def test_sweep_kernel_single_pair_bitwise(cuda, dv):
    _sweep_matches(_lab((2, 48, 160, 3), 0, cuda), range(5, 13), ((0, 1, dv[0], dv[1]),), 1.0359)


ODD = SystemSettings(array_width=3, array_height=3, min_disp=10, max_disp=20, inc=1)
ODD_PAIRS = plane_sweep.build_pairs(*build_view_subsets(ODD), ODD.array_width)


@pytest.mark.cuda
def test_sweep_kernel_odd_multiview_bitwise(cuda):
    _sweep_matches(_lab((9, 53, 131, 3), 1, cuda), range(10, 21), ODD_PAIRS, ODD.bl_ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0, 4])
def test_sweep_kernel_window_radius_bitwise(cuda, radius):
    _sweep_matches(_lab((9, 53, 131, 3), 1, cuda), range(10, 21), ODD_PAIRS, ODD.bl_ratio, radius)


# one hypothesis; one more than a chunk holds; an unsorted ladder whose
# jumps close chunks early (ops/sweep.chunk_tables)
SWEEP_LADDERS = {
    "D1": [12.0],
    "D-chunk+1": [float(d) for d in range(10, 11 + sweep.CHUNK)],
    "unsorted": [30.0, 60.0, 31.0, 45.5],
}


@pytest.mark.cuda
@pytest.mark.parametrize("ladder", list(SWEEP_LADDERS))
def test_sweep_kernel_ladders_bitwise(cuda, ladder):
    _sweep_matches(_lab((9, 70, 150, 3), 3, cuda), SWEEP_LADDERS[ladder], ODD_PAIRS, ODD.bl_ratio)


@pytest.mark.cuda
def test_sweep_kernel_view_without_pairs(cuda):
    disp, cost = _sweep_matches(_lab((3, 40, 70, 3), 4, cuda), [4.0, 5.0, 6.0],
                                ((0, 1, 1, 0), (1, 0, -1, 0)), 1.0)
    assert bool((disp[2] == 0.0).all()) and bool((cost[2] == 1.0e6).all())


@pytest.mark.cuda
def test_sweep_kernel_diagonal_ragged_tiles_bitwise(cuda):
    """dv = (-1, -1) at a height and width that leave ragged tiles (at
    radius 2, 37 = 2 x 16 + 5 rows, 101 = 56 + 45 columns)."""
    _sweep_matches(_lab((2, 37, 101, 3), 5, cuda), range(3, 14), ((0, 1, -1, -1), (1, 0, 1, 1)), 1.0359)


@pytest.mark.cuda
def test_sweep_tables_one_host_to_device_copy(cuda):
    """Every table of a call reaches the card in one copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lab = _lab((9, 53, 131, 3), 1, cuda)
    args = (lab, [float(d) for d in range(10, 21)], ODD_PAIRS, ODD.bl_ratio)
    sweep.plane_sweep(*args)  # build and load outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep.plane_sweep(*args)
        torch.cuda.synchronize()
    copies = sum(e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.key.startswith("Memcpy HtoD"))
    assert copies == 1


@pytest.fixture
def strips_scene(cuda):
    """tests/test_consistency_strips.py's scene (3x2 views, 48x64,
    bl_ratio 1.0359), built by the port on the card."""
    s = SystemSettings(array_width=3, array_height=2, spixl_size=8, min_disp=4, max_disp=11,
                       inc=1, bl_ratio=1.0359, kernel_size=8, kernel_step=2, no_prop=2)
    views, _ = synthetic.two_plane_scene(48, 64, array_width=3, array_height=2, disp_bg=5.0,
                                         disp_fg=9.0, bl_ratio=1.0359, seed=3)
    geom = DerivedGeometry.create(64, 48, s)
    lab = rgb_to_lab(torch.as_tensor(views, device=cuda))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    subset, counts = build_view_subsets(s)
    disp0 = cost_volume.initial_depth_estimation(
        lab, spmap.center, ext, build_disp_levels(s), subset, torch.as_tensor(counts, device=cuda),
        s.array_width, s.bl_ratio,
    )
    sched = RefinementSchedule.create(s)
    fl = refine.compute_flatness(spmap.color, sched.gamma_eff)
    ctx = refine.make_context(spmap.center, spmap.color, disp0, labels, ext, fl)
    kw = dict(gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff,
              bl_ratio=sched.bl_ratio, pairs=refine.pairs_from_subsets(subset, s.array_width))
    reach = dict(steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    state = refine.init_state(ctx, **kw, **reach)
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **reach)
    rng = np.random.default_rng(0)
    m = 13
    d_c = state.d[None] + torch.as_tensor(rng.normal(0, 1.5, (m,) + tuple(state.d.shape)),
                                          dtype=torch.float32, device=cuda)
    n_c = torch.as_tensor(rng.normal(0, 0.2, (m,) + tuple(state.n.shape)), dtype=torch.float32,
                          device=cuda)
    n_c[..., 2] += 1.0
    n_c = n_c / torch.linalg.norm(n_c, dim=-1, keepdim=True)
    n_c[4] = torch.tensor([1.0, 0.0, 0.0], device=cuda)  # nz = 0: every sample blows up
    n_c[5, :, ::2] = torch.tensor([0.6, 0.8, 0.0], device=cuda)
    return dict(ctx=ctx, cache=cache, kw=kw, d_c=d_c.contiguous(), n_c=n_c.contiguous(), sched=sched)


def _moves(sc, m):
    """The first m of the scene's 13 candidate moves; with fewer than 5,
    the nz = 0 move (row 4) comes first."""
    rows = list(range(m)) if m > 4 else [4] + list(range(m - 1))
    return rows, sc["d_c"][rows].contiguous(), sc["n_c"][rows].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 6, 8, 13])
def test_consistency_kernel_matches_reference(strips_scene, m):
    """M = 1 gives a cell one lane; M = 13 gives its 8 lanes a second,
    ragged round of moves."""
    sc = strips_scene
    rows, d_c, n_c = _moves(sc, m)
    args = (sc["ctx"], sc["cache"], d_c, n_c)
    before = consistency.LAUNCHES
    got = consistency.consistency_moves(*args, **sc["kw"])
    torch.cuda.synchronize()
    assert consistency.LAUNCHES == before + 1
    want = consistency.consistency_moves_reference(*args, **sc["kw"])
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert bool((got[rows.index(4)] == np.float32(0.01)).all())


@pytest.mark.cuda
def test_consistency_kernel_fractional_deltas(strips_scene):
    """Pairs with non-integer deltas, as SfM's pair_deltas gives them."""
    sc = strips_scene
    kw = dict(sc["kw"], pairs=tuple((r, n, 0.5 * dx, 1.25 * dy) for r, n, dx, dy in sc["kw"]["pairs"]))
    assert any(dx % 1 for _, _, dx, _ in kw["pairs"])
    _, d_c, n_c = _moves(sc, 8)
    args = (sc["ctx"], sc["cache"], d_c, n_c)
    got = consistency.consistency_moves(*args, **kw)
    want = consistency.consistency_moves_reference(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not torch.equal(got, consistency.consistency_moves(*args, **sc["kw"]))


@pytest.mark.cuda
def test_consistency_kernel_moves_independent(strips_scene):
    """Each move scored alone gives the bits of its row of the batched
    call."""
    sc = strips_scene
    ctx, cache, d_c, n_c = sc["ctx"], sc["cache"], sc["d_c"], sc["n_c"]
    batched = consistency.consistency_moves(ctx, cache, d_c, n_c, **sc["kw"])
    for k in range(d_c.shape[0]):
        alone = consistency.consistency_moves(ctx, cache, d_c[k:k + 1].contiguous(),
                                              n_c[k:k + 1].contiguous(), **sc["kw"])
        assert torch.equal(alone[0], batched[k]), k


def _gather_close(got, want):
    """The kernel against its plain twin: NaN at the same places, the rest
    within the twin's bound (the same formula, the samples' sums in
    another order)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


def _nan_table(ras, h, w):
    """``ras`` with NaN disparity on the image's edge rows and columns,
    where samples outside the image clamp, and on scattered pixels."""
    t = ras.clone().view(-1, h, w, 4)
    t[:, (0, h - 1), :, 0] = float("nan")
    t[:, :, (0, w - 1), 0] = float("nan")
    t.view(-1, 4)[::53, 0] = float("nan")
    return t.view(-1, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["clean", "nan"])
@pytest.mark.parametrize("m", [1, 8, 13])
def test_consistency_gather_rule_matches_reference(strips_scene, m, table):
    """The gather engine's rule (the main path's launches: M = 1 at the
    init, 8 a phase) against the plain gather form on the card, nz = 0
    moves included; with a table that is NaN where samples outside the
    image clamp, the kernel adds the form's 0 * NaN terms."""
    sc = strips_scene
    rows, d_c, n_c = _moves(sc, m)
    cache = sc["cache"]
    if table == "nan":
        cache = cache._replace(ras=_nan_table(cache.ras, *sc["ctx"].labels.shape[1:]))
    args = (sc["ctx"], cache, d_c, n_c)
    before = consistency.LAUNCHES
    got = consistency.consistency_moves(*args, **sc["kw"], rule="gather")
    torch.cuda.synchronize()
    assert consistency.LAUNCHES == before + 1
    want = consistency.consistency_moves_reference(*args, **sc["kw"], rule="gather")
    _gather_close(got, want)
    if table == "nan":
        # M = 1 is the nz = 0 move alone: no sample of it is visible, so no
        # pair takes its NaN terms into a contribution
        assert bool(torch.isnan(got).any()) == (m > 1)
    else:
        assert bool(torch.isfinite(got).all())
        # the strips rule differs only where a sample's disparity is not finite
        strips = consistency.consistency_moves(*args, **sc["kw"])
        finite = n_c[..., 2] != 0
        assert torch.equal(strips[finite], got[finite])


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [0, 1])
def test_consistency_row_window_matches_reference(strips_scene, tile):
    """The row-sharded refinement's launch: a tile's cells against its
    rows of the table and 8 halo rows each side (zero rows past the
    image), ``img_hw``/``ras_rows`` as ``spatial.block_sweep`` passes them."""
    from cl_multiview_stereo_tpu_torch.parallel import spatial

    sc = strips_scene
    ctx, cache = sc["ctx"], sc["cache"]
    v, h, w = ctx.labels.shape
    bh, bhp, halo = ctx.center.shape[1] // 2, h // 2, 8
    row_lo, rows = tile * bhp - halo, bhp + 2 * halo
    pad = torch.zeros((v, halo, w, 4), device=cache.ras.device)
    table = torch.cat([pad, cache.ras.view(v, h, w, 4), pad], 1)
    win = table[:, row_lo + halo:row_lo + halo + rows].contiguous().view(-1, 4)
    blk = spatial.block_context(ctx, tile, 2)
    _, d_c, n_c = _moves(sc, 8)
    d_c, n_c = (a[:, :, tile * bh:(tile + 1) * bh].contiguous() for a in (d_c, n_c))
    geom = dict(img_hw=(h, w), ras_rows=(row_lo, rows))
    args = (blk, cache._replace(ras=win), d_c, n_c)
    got = consistency.consistency_moves(*args, **sc["kw"], rule="gather", **geom)
    want = consistency.consistency_moves_reference(*args, **sc["kw"], rule="gather", **geom)
    torch.cuda.synchronize()
    _gather_close(got, want)


@pytest.mark.cuda
def test_consistency_view_block_matches_whole_launch(strips_scene):
    """The view-sharded pipeline's launch: views 3..5 with their own
    pairs (neighbours global) against the whole table: the plain twin's
    scores, and the whole launch's rows bitwise."""
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import own_pairs

    sc = strips_scene
    v0, nv = 3, 3
    kw = dict(sc["kw"], pairs=own_pairs(sc["kw"]["pairs"], v0, nv))
    assert max(p[1] for p in kw["pairs"]) >= nv
    ctx = refine.RefineContext(*(x[v0:v0 + nv].contiguous() if x.ndim > 2 else x for x in sc["ctx"]))
    _, d_c, n_c = _moves(sc, 8)
    args = (ctx, sc["cache"], d_c[:, v0:v0 + nv].contiguous(), n_c[:, v0:v0 + nv].contiguous())
    got = consistency.consistency_moves(*args, **kw, rule="gather")
    want = consistency.consistency_moves_reference(*args, **kw, rule="gather")
    whole = consistency.consistency_moves(sc["ctx"], sc["cache"], d_c, n_c, **sc["kw"], rule="gather")
    torch.cuda.synchronize()
    _gather_close(got, want)
    assert torch.equal(got, whole[:, v0:v0 + nv])


@pytest.mark.cuda
def test_gather_engine_on_the_card_launches_the_kernel(strips_scene, monkeypatch):
    """``score_moves`` (one launch for all moves), ``init_scores`` (one)
    and ``refine`` (1 + 2 a sweep) under the gather engine never call the
    plain form on CUDA tensors, and a wrong input raises instead of falling
    back to it."""
    def plain(*a, **k):
        raise AssertionError("the card called the plain gather form")

    sc = strips_scene
    want_sm, want_cs = refine.score_moves(sc["ctx"], sc["cache"], sc["d_c"], sc["n_c"], **sc["kw"])
    monkeypatch.setattr(refine, "consistency_from_cache", plain)
    monkeypatch.setattr(consistency, "consistency_from_cache", plain)
    before = consistency.LAUNCHES
    sm, cs = refine.score_moves(sc["ctx"], sc["cache"], sc["d_c"], sc["n_c"], **sc["kw"])
    assert consistency.LAUNCHES == before + 1
    # the nz = 0 moves' smoothness is NaN
    torch.testing.assert_close((sm, cs), (want_sm, want_cs), rtol=0, atol=0, equal_nan=True)
    d0 = sc["ctx"].disp0
    refine.init_scores(sc["ctx"], sc["cache"], d0, refine._fronto_normals(d0), **sc["kw"])
    assert consistency.LAUNCHES == before + 2
    refine.refine(sc["ctx"], sc["sched"], pairs=sc["kw"]["pairs"])
    torch.cuda.synchronize()
    assert consistency.LAUNCHES == before + 2 + 1 + 2 * sc["sched"].no_prop
    with pytest.raises(ValueError):
        refine.score_moves(sc["ctx"], sc["cache"]._replace(ras=sc["cache"].ras[1:]), sc["d_c"], sc["n_c"],
                           **sc["kw"])


@pytest.mark.cuda
def test_sweep_wrapper_rejects_bad_input(cuda):
    lab = _lab((2, 24, 40, 3), 2, cuda)
    args = ([4.0, 5.0], ((0, 1, 1, 0),), 1.0)
    with pytest.raises(TypeError):
        sweep.plane_sweep(lab.double(), *args)
    with pytest.raises(ValueError):
        sweep.plane_sweep(lab.cpu(), *args)
    with pytest.raises(ValueError):
        sweep.plane_sweep(lab.transpose(1, 2), *args)
    with pytest.raises(ValueError):
        sweep.plane_sweep(lab, *args, window_radius=5)


@pytest.mark.cuda
def test_consistency_wrapper_rejects_bad_input(strips_scene):
    sc = strips_scene
    ctx, cache, d_c, n_c = sc["ctx"], sc["cache"], sc["d_c"], sc["n_c"]
    with pytest.raises(TypeError):
        consistency.consistency_moves(ctx, cache, d_c.double(), n_c, **sc["kw"])
    with pytest.raises(ValueError):
        consistency.consistency_moves(ctx, cache._replace(ras=cache.ras.cpu()), d_c, n_c, **sc["kw"])
    with pytest.raises(ValueError):
        consistency.consistency_moves(ctx, cache, d_c, n_c.transpose(0, 1), **sc["kw"])
    with pytest.raises(ValueError):
        consistency.consistency_moves(ctx, cache, d_c.transpose(2, 3).contiguous().transpose(2, 3),
                                      n_c, **sc["kw"])


@pytest.mark.cuda
def test_cross_check_fusion_card_equals_cpu(cuda):
    """Fusion with the cross-check vote at 4x48x64: the card's eager ops
    give the CPU run's bits, non-finite pixels (nz = 0 planes) included."""
    s = SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11, bl_ratio=1.0359)
    views, _ = synthetic.two_plane_scene(48, 64, array_width=2, array_height=2, disp_bg=5.0,
                                         disp_fg=9.0, bl_ratio=s.bl_ratio, seed=7)
    geom = DerivedGeometry.create(64, 48, s)
    labels, spmap = slic.segment(rgb_to_lab(torch.as_tensor(views)), geom, SlicParams.create(s))
    rng = np.random.default_rng(3)
    d = torch.as_tensor(rng.uniform(4, 11, (4, geom.map_h, geom.map_w)).astype(np.float32))
    nrm = torch.as_tensor(rng.normal(0, 0.05, (4, geom.map_h, geom.map_w, 3)).astype(np.float32))
    nrm[..., 2] = 1.0
    nrm[:, 1, 2:5] = torch.tensor([1.0, 0.0, 0.0])
    kw = dict(array_width=2, bl_ratio=s.bl_ratio, fuse=0.5 * s.fuse, cross_check=True)
    want = fusion.fuse_views(labels, spmap.center, d, nrm, **kw)
    got = fusion.fuse_views(labels.to(cuda), spmap.center.to(cuda), d.to(cuda), nrm.to(cuda), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, equal_nan=True)
    assert (want == 0).any() and not bool(torch.isfinite(want).all())


@pytest.mark.cuda
def test_gather_consistency_card_equals_cpu(strips_scene):
    """The gather engine (plain PyTorch) on the strips scene's candidates,
    nz = 0 ones included: an NaN shift reads the sample's own pixel and
    +-inf leaves the image on both devices, so the card gives the CPU's
    scores."""
    sc = strips_scene
    ctx, cache = sc["ctx"], sc["cache"]
    got = refine.consistency_from_cache(ctx, cache, sc["d_c"], sc["n_c"], **sc["kw"])
    to_cpu = lambda tup: type(tup)(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in tup))  # noqa: E731
    want = refine.consistency_from_cache(to_cpu(ctx), to_cpu(cache), sc["d_c"].cpu(),
                                         sc["n_c"].cpu(), **sc["kw"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# SfM on the card: plain PyTorch (no kernel of its own), held against the
# port's CPU path
# ---------------------------------------------------------------------------

SFM_SETTINGS = SystemSettings(array_width=2, array_height=2, spixl_size=8, min_disp=4, max_disp=11,
                              bl_ratio=1.0, kernel_size=8, kernel_step=2, no_prop=1)


def _sfm_scene():
    rgb, _ = synthetic.fronto_parallel_scene(120, 160, array_width=2, array_height=2, disp=8.0,
                                             bl_ratio=1.0)
    return rgb


@pytest.mark.cuda
def test_harris_keypoints_card_agrees_with_cpu(cuda):
    """Share of the card's keypoints (with a finite score) that the CPU also
    found, and their order: the card's parallel cumulative sums reorder the
    box sums, so agreement is stated (>= 0.99), not bitwise."""
    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import gray_image
    from cl_multiview_stereo_tpu_torch.ops.features import harris_keypoints

    gray = gray_image(torch.as_tensor(_sfm_scene()))
    got = harris_keypoints(gray.to(cuda), k=192)
    want = harris_keypoints(gray, k=192)
    assert torch.equal(gray_image(torch.as_tensor(_sfm_scene(), device=cuda)).cpu(), gray)
    fin = torch.isfinite(got.score.cpu())
    shared = 0
    for v in range(gray.shape[0]):
        mine = {tuple(p) for p in got.xy[v].cpu()[fin[v]].tolist()}
        ref = {tuple(p) for p in want.xy[v][torch.isfinite(want.score[v])].tolist()}
        shared += len(mine & ref)
    assert shared >= 0.99 * int(fin.sum()), (shared, int(fin.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("pose_graph", [False, True], ids=["ba", "pose_graph"])
def test_run_sfm_card_agrees_with_cpu(cuda, pose_graph):
    """run_sfm at 2x2 views of 120x160 on the card and on the CPU: the same
    number of matches, poses within 1e-3 (ATE between the two runs) and the
    RMS within 1e-3 px."""
    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import run_sfm

    kw = dict(k=192, max_matches=96, ba_iters=8, use_pose_graph=pose_graph)
    got = run_sfm(_sfm_scene(), SFM_SETTINGS, device=cuda, **kw)
    want = run_sfm(_sfm_scene(), SFM_SETTINGS, device="cpu", **kw)
    assert got.n_matches == want.n_matches
    assert float(np.sqrt(np.mean(np.sum((got.t - want.t) ** 2, -1)))) < 1e-3
    assert abs(got.rms_after - want.rms_after) < 1e-3
    assert got.rms_after <= got.rms_before + 1e-3


@pytest.mark.cuda
def test_bundle_adjust_loop_never_waits_for_the_host(cuda):
    """No synchronisation and no device-to-host copy per iteration: the
    counts under torch.profiler are the same for 2 and for 6 iterations
    (the degree check before the loop reads the device once)."""
    from torch.profiler import ProfilerActivity, profile

    from cl_multiview_stereo_tpu_torch.models import sfm

    rng = np.random.default_rng(0)
    n_cam, n_pt = 4, 40
    aa = torch.zeros(n_cam, 3)
    t = torch.as_tensor(np.stack([-np.arange(n_cam), np.zeros(n_cam), np.zeros(n_cam)], -1), dtype=torch.float32)
    X = torch.as_tensor(rng.uniform([-2, -2, 4], [2, 2, 8], (n_pt, 3)), dtype=torch.float32)
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0])
    cams = torch.arange(n_cam).repeat_interleave(n_pt).to(torch.int32)
    pts = torch.arange(n_pt).repeat(n_cam).to(torch.int32)
    uv = sfm.project(aa[cams.long()], t[cams.long()], X[pts.long()], intr)
    prob = sfm.BAProblem(aa=aa, t=t + 0.05, X=X + 0.1, intr=intr, obs_cam=cams, obs_pt=pts,
                         obs_uv=uv + torch.randn(uv.shape) * 0.3, obs_w=torch.ones(len(cams)))
    prob = sfm.BAProblem(*(x.to(cuda) for x in prob))
    sfm.bundle_adjust(prob, iters=1, max_deg=n_cam)  # warm-up outside the trace
    torch.cuda.synchronize()

    def waits(iters: int) -> int:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = sfm.bundle_adjust(prob, iters=iters, max_deg=n_cam)
            torch.cuda.synchronize()
        assert torch.isfinite(out.t).all()
        return sum(e.count for e in prof.key_averages()
                   if "Synchronize" in e.key or e.key.startswith("Memcpy DtoH"))

    assert waits(2) == waits(6)


# the row-window mode of the sweep kernel (parallel/spatial.spatial_plane_sweep)
ROW_TILES = {"top": (0, 16), "middle": (27, 21), "bottom": (53, 17)}


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0, 2])
@pytest.mark.parametrize("tile", list(ROW_TILES))
def test_sweep_row_window_matches_full_launch(cuda, tile, radius):
    """A tile's rows from a band cut to what they read equal the whole
    image's launch bitwise, and the plain twin's window."""
    out0, rows = ROW_TILES[tile]
    lab = _lab((9, 70, 150, 3), 6, cuda)
    ladder = [float(d) for d in range(10, 21)]
    full = plane_sweep.plane_sweep_depth(lab, ladder, ODD_PAIRS, 1.0359, radius)
    up, down = sweep.row_reach(ladder, ODD_PAIRS, 1.0359, radius)
    b0, b1 = max(0, out0 - up), min(70, out0 + rows + down)
    win = sweep.RowWindow(70, b0, out0, rows)
    band = lab[:, b0:b1].contiguous()
    before = sweep.LAUNCHES
    got = plane_sweep.plane_sweep_depth(band, ladder, ODD_PAIRS, 1.0359, radius, rows=win)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    plain = plane_sweep.plane_sweep_reference(band, ladder, ODD_PAIRS, 1.0359, radius, rows=win)
    for g, f, p in zip(got, full, plain):
        assert torch.equal(g, f[:, out0:out0 + rows]) and torch.equal(g, p)


@pytest.mark.cuda
def test_cost_volume_view_range_matches_full_volume(cuda):
    s = SystemSettings(array_width=3, array_height=3, min_disp=4, max_disp=11, bl_ratio=1.0359)
    lab, centers, step = _inputs(61, 45, s, cuda)
    args = (lab, centers, step, build_disp_levels(s), s.array_width, s.bl_ratio)
    full = cost_volume.superpixel_cost_volume(*args)
    for v0, nv in ((0, 3), (3, 3), (6, 3), (4, 1), (0, 9)):
        got = cost_volume.superpixel_cost_volume(*args, view_range=(v0, nv))
        plain = cost_volume.cost_volume_reference(*args, view_range=(v0, nv))
        torch.cuda.synchronize()
        assert torch.equal(got, full[v0:v0 + nv]) and torch.equal(got, plain), (v0, nv)


@pytest.fixture
def nccl_world1(cuda):
    """A world-size-1 NCCL group, destroyed after the test."""
    import torch.distributed as dist

    from cl_multiview_stereo_tpu_torch.parallel import initialize_distributed

    initialize_distributed(device="cuda")
    yield cuda
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world1_halo_and_depth_slabs(nccl_world1):
    from torch.distributed.device_mesh import init_device_mesh

    from cl_multiview_stereo_tpu_torch.parallel import spatial

    dev = nccl_world1
    tile = init_device_mesh("cuda", (1,), mesh_dim_names=("tile",))
    disp = init_device_mesh("cuda", (1,), mesh_dim_names=("disp",))
    x = torch.arange(32 * 3, dtype=torch.float32, device=dev).reshape(32, 3)
    for halo in (3, 40):
        got = spatial.halo_exchange_rows(x, halo, tile, "tile")
        zeros = torch.zeros((halo, 3), device=dev)
        assert torch.equal(got, torch.cat([zeros, x, zeros]))
    s = SystemSettings(array_width=3, array_height=3, min_disp=4, max_disp=11)
    lab, centers, step = _inputs(61, 45, s, dev)
    subset, counts = build_view_subsets(s)
    levels = build_disp_levels(s)
    want = cost_volume.wta_disparity(
        cost_volume.superpixel_cost_volume(lab, centers, step, levels, s.array_width, s.bl_ratio),
        levels, torch.as_tensor(counts, device=dev))
    got = spatial.disp_sharded_depth_init(lab, centers, step, levels, counts, disp, s.array_width, s.bl_ratio)
    assert torch.equal(got, want)


# MVSPipeline.jitted(): the CUDA graph of run() and the streaming path

JIT_SETTINGS = dict(array_width=3, array_height=3, min_disp=4, max_disp=11)


def _leaf_pairs(a, b, prefix=""):
    """(name, a's tensor, b's tensor) over two nested NamedTuples."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            yield prefix + f, x, y
        else:
            yield from _leaf_pairs(x, y, f"{prefix}{f}.")


def _jit_scene(disp, seed, h=72, w=96):
    rgb, _ = synthetic.fronto_parallel_scene(h, w, 3, 3, disp=disp, bl_ratio=1.0, seed=seed)
    return rgb


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", ["default", "cross_check", "gather"])
def test_jitted_two_scenes_bitwise_run(cuda, knobs):
    """Scene A then scene B through the graph: each bitwise run(), so the
    replay reads the refreshed static input and returns fresh tensors."""
    from cl_multiview_stereo_tpu_torch.models import mvs_pipeline

    kw = {"default": {}, "cross_check": dict(cross_check=True), "gather": dict(depth_method="gather")}[knobs]
    pipe = mvs_pipeline.MVSPipeline.create(96, 72, SystemSettings(**JIT_SETTINGS), device=cuda, **kw)
    fwd = pipe.jitted()
    a, b = _jit_scene(7.0, 1), _jit_scene(5.0, 2)
    before = dict(mvs_pipeline.REPLAYED_LAUNCHES)
    got_a = fwd(a)
    got_b = fwd(torch.as_tensor(b, device=cuda))
    want_a, want_b = pipe.run(a), pipe.run(b)
    torch.cuda.synchronize()
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for name, x, y in _leaf_pairs(got, want):
            assert torch.equal(x, y), name
    assert not torch.equal(got_a.disp_full, got_b.disp_full)
    cv = 0 if knobs == "gather" else 2
    assert mvs_pipeline.REPLAYED_LAUNCHES.get("cost_volume", 0) - before.get("cost_volume", 0) == cv
    # the consistency kernel inside the graph: 1 + 2 a sweep per replay
    per_run = 1 + 2 * pipe.settings.no_prop
    assert mvs_pipeline.REPLAYED_LAUNCHES.get("consistency", 0) - before.get("consistency", 0) == 2 * per_run
    with pytest.raises(ValueError, match="the pipeline takes"):
        fwd(a[:, :-1])


@pytest.mark.cuda
def test_jitted_replay_makes_no_pageable_copy(cuda):
    """After the warm-up neither the replay nor the eager run copies a
    pageable host buffer to the card: every table is on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    pipe = MVSPipeline.create(96, 72, SystemSettings(**JIT_SETTINGS), device=cuda)
    rgb = torch.as_tensor(_jit_scene(7.0, 1), device=cuda)
    fwd = pipe.jitted()
    fwd(rgb)
    torch.cuda.synchronize()
    for fn in (lambda: fwd(rgb), lambda: pipe.run(rgb)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        pageable = [e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "HtoD" in e.key and "Pageable" in e.key]
        assert not pageable, pageable


def _write_scenes(root, arrays):
    from PIL import Image

    lists = []
    for k, rgb in enumerate(arrays):
        for v, im in enumerate(rgb):
            Image.fromarray(im).save(root / f"s{k}_v{v}.png")
        (root / f"s{k}.txt").write_text("".join(f"s{k}_v{v}.png\n" for v in range(len(rgb))))
        lists.append(str(root / f"s{k}.txt"))
    return lists


@pytest.mark.cuda
def test_pinned_staging_survives_a_slow_consumer(cuda, tmp_path):
    """Depth 2 over 4 scenes, and the card kept busy after each scene, so
    that each copy from a pinned buffer queues behind that work while the
    host decodes the next scenes: every scene arrives intact."""
    from cl_multiview_stereo_tpu_torch.io.prefetcher import ScenePrefetcher
    from cl_multiview_stereo_tpu_torch.io.images import read_image_list

    arrays = [_jit_scene(4.0 + k, k) for k in range(4)]
    lists = _write_scenes(tmp_path, arrays)
    got = []
    with ScenePrefetcher([read_image_list(p) for p in lists], 72, 96, depth=2, device=cuda) as pf:
        for idx, rgb in pf:
            assert rgb.device.type == "cuda"
            got.append((idx, rgb))
            torch.cuda._sleep(50_000_000)
    torch.cuda.synchronize()
    assert [i for i, _ in got] == [0, 1, 2, 3]
    for (_, rgb), want in zip(got, arrays):
        assert torch.equal(rgb.cpu(), torch.as_tensor(want))


@pytest.mark.cuda
def test_run_scenes_bitwise_run_on_the_card(cuda, tmp_path):
    from cl_multiview_stereo_tpu_torch.io.prefetcher import run_scenes
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    arrays = [_jit_scene(7.0, 1), _jit_scene(5.0, 2)]
    lists = _write_scenes(tmp_path, arrays)
    pipe = MVSPipeline.create(96, 72, SystemSettings(**JIT_SETTINGS), device=cuda)
    got = [(i, art.disp_full) for i, art in run_scenes(pipe, lists * 2, depth=2)]
    assert [i for i, _ in got] == [0, 1, 2, 3]
    for k, (_, disp) in enumerate(got):
        assert torch.equal(disp, pipe.run(arrays[k % 2]).disp_full), k


# SLIC on csrc/slic.cu: chip_smoke.py's phase-2 shape (the slice's 9-view
# 1080p scene), ragged cells at the map's edge, 5-pixel cells, and 12-pixel
# cells on an image whose height and width are multiples of neither the cell
# nor a block's run of cells (10 cells, 120 columns)
SLIC_SHAPES = {
    "full-9x1080x1920": (1080, 1920, 8),
    "ragged-9x543x967": (543, 967, 8),
    "S5-9x270x481": (270, 481, 5),
    "S12-9x301x533": (301, 533, 12),
}


@pytest.fixture(scope="module")
def slic_scenes():
    """Per SLIC_SHAPES entry: (lab, geom, params, converged labels and map
    from the kernels' ``segment``), built on first use."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cache = {}

    def get(name):
        if name not in cache:
            h, w, spx = SLIC_SHAPES[name]
            s = SystemSettings(spixl_size=spx)
            rgb, _ = synthetic.fronto_parallel_scene(h, w, 3, 3, disp=40.0, bl_ratio=s.bl_ratio, seed=0)
            lab = rgb_to_lab(torch.as_tensor(rgb, device="cuda")).contiguous()
            geom, p = DerivedGeometry.create(w, h, s), SlicParams.create(s)
            labels, spmap = slic.segment(lab, geom, p)
            cache[name] = (lab, geom, p, labels, spmap)
        return cache[name]

    return get


def _slic_update_close(got, want):
    """The kernel's map bitwise the plain form's: centre and count add
    integers below 2**24, and the colour's sums are added in the plain
    form's order."""
    for f in ("center", "count", "color"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), f"{int((a != b).sum())} values of {f} differ"
    assert got.disp is want.disp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SLIC_SHAPES))
@pytest.mark.parametrize("start", ["seeds", "converged"])
def test_slic_assign_bitwise(slic_scenes, shape, start):
    lab, geom, p, _, spmap = slic_scenes(shape)
    if start == "seeds":
        spmap = slic.init_cluster_centers(lab, geom)
    before = slic.LAUNCHES["slic_assign"]
    got = slic.find_center_association(lab, spmap, geom, p)
    torch.cuda.synchronize()
    assert slic.LAUNCHES["slic_assign"] == before + 1
    want = slic.find_center_association_reference(lab, spmap, geom, p)
    assert got.dtype == torch.int32
    assert torch.equal(got, want), f"{int((got != want).sum())} labels differ"


def _stray(labels, geom, seed=3):
    """Converged labels with -1, labels past Mh*Mw, labels two cells from
    their pixel and one view's top-left 4x4 cells all relabelled 0 (which
    empties clusters)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    flat = labels.clone().reshape(-1)
    n_cells = geom.map_h * geom.map_w
    pick = torch.randperm(flat.numel(), generator=gen)[:3000].to(labels.device)
    flat[pick[:1000]] = -1
    flat[pick[1000:2000]] = n_cells + 7
    flat[pick[2000:]] = (flat[pick[2000:]] + 2) % n_cells
    out = flat.reshape(labels.shape)
    s = geom.spixl_size
    out[2, :4 * s, :4 * s] = 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SLIC_SHAPES))
@pytest.mark.parametrize("labels_kind", ["converged", "stray"])
def test_slic_update_matches_reference(slic_scenes, shape, labels_kind):
    lab, geom, _, labels, spmap = slic_scenes(shape)
    if labels_kind == "stray":
        labels = _stray(labels, geom)
    before = slic.LAUNCHES["slic_update"]
    got = slic.update_cluster_centers(lab, labels, spmap, geom)
    torch.cuda.synchronize()
    assert slic.LAUNCHES["slic_update"] == before + 1
    want = slic.update_cluster_centers_reference(lab, labels, spmap, geom)
    _slic_update_close(got, want)
    if labels_kind == "stray":
        assert bool((want.count == 0).any())  # empty clusters, zeroed alike
        v, h, w = labels.shape
        assert float(got.count.sum()) < v * h * w  # the strays were dropped


def _vote_bitwise(labels, rounds=1):
    """``rounds`` chained launches of the vote bitwise as many rounds of
    its plain form, one launch a round; returns the kernel's labels."""
    before = slic.LAUNCHES["slic_vote"]
    got = want = labels
    for _ in range(rounds):
        got, want = slic.suppress_local_labels(got), slic.suppress_local_labels_reference(want)
    torch.cuda.synchronize()
    assert slic.LAUNCHES["slic_vote"] == before + rounds
    assert torch.equal(got, want), f"{int((got != want).sum())} labels differ"
    return got


def _vote_labels(shape, seed, values=None):
    """int32 labels on the card: 3 values (often enough >= 16 neighbours
    differ for the vote to fire), or ``values`` drawn uniformly."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if values is None:
        return torch.randint(0, 3, shape, generator=gen, dtype=torch.int32).cuda()
    pick = torch.randint(0, len(values), shape, generator=gen)
    return torch.tensor(values, dtype=torch.int32)[pick].cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SLIC_SHAPES))
@pytest.mark.parametrize("labels_kind", ["converged", "noisy"])
@pytest.mark.parametrize("rounds", [1, 2])
def test_slic_vote_bitwise(slic_scenes, shape, labels_kind, rounds):
    """One launch, or ``segment``'s two chained, bitwise the plain form."""
    _, geom, _, labels, _ = slic_scenes(shape)
    if labels_kind == "noisy":  # flips enough neighbours to trigger the vote often
        gen = torch.Generator(device="cpu").manual_seed(2)
        flip = (torch.rand(labels.shape, generator=gen) < 0.4).to(labels.device)
        other = torch.randint(0, geom.map_h * geom.map_w, labels.shape, generator=gen, dtype=torch.int32)
        labels = torch.where(flip, other.to(labels.device), labels)
    got = _vote_bitwise(labels, rounds)
    if labels_kind == "noisy":
        assert bool((got != labels).any())


INT32_MAX = 2**31 - 1
# (V, H, W) of labels that take the kernel's edges: widths not a multiple
# of 8 (1916), of 4 (1918) or of 2 (1919), views
# of 4 rows or columns (all border) and of 5 (one interior row or column),
# one view, and a height past 65,535 bands of 16 rows (the grid's y loop)
# at a width of a run and at an odd one
VOTE_SHAPES = {"w1916": (2, 67, 1916), "w1918": (2, 67, 1918), "w1919": (2, 67, 1919), "h4": (2, 4, 96),
               "w4": (2, 96, 4), "h5": (2, 5, 96), "w5": (2, 96, 5), "one-view": (1, 1080, 1920),
               "tall-w8": (1, 65535 * 16 + 37, 8), "tall-w7": (1, 65535 * 16 + 37, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VOTE_SHAPES))
def test_slic_vote_bitwise_on_edge_shapes(cuda, case):
    labels = _vote_labels(VOTE_SHAPES[case], seed=5)
    got = _vote_bitwise(labels)
    _, h, w = labels.shape
    assert bool((got != labels).any()) == (h >= 5 and w >= 5)


@pytest.mark.cuda
@pytest.mark.parametrize("values", [[0], [-1], [INT32_MAX], [0, -1, INT32_MAX]],
                         ids=["zero", "minus-one", "int32-max", "mixed"])
@pytest.mark.parametrize("shape", [(2, 40, 64), (2, 40, 63)], ids=["w64", "w63"])
def test_slic_vote_bitwise_on_extreme_labels(cuda, values, shape):
    got = _vote_bitwise(_vote_labels(shape, seed=3, values=values))
    if len(values) == 1:
        assert bool((got == values[0]).all())


@pytest.mark.cuda
def test_slic_vote_bitwise_on_a_base_off_16_byte_alignment(cuda):
    """A contiguous view ``labels[1:]`` whose H x W is odd: its base is 4
    bytes past a 16-byte boundary (12 past when H x W is 3 mod 4)."""
    whole = _vote_labels((4, 37, 63), seed=4)
    labels = whole[1:]
    assert labels.is_contiguous() and labels.data_ptr() % 16 != 0
    _vote_bitwise(labels)


@pytest.mark.cuda
def test_slic_vote_64_bit_offsets(cuda):
    """V x H x W >= 2**31 (64-bit offsets; 8.6 GB in and out): the first,
    a middle and the last 64 rows bitwise the plain form on those rows
    with a 2-row halo."""
    v, h, w = 1, 65600, 32768
    assert v * h * w >= 2**31
    labels = torch.randint(0, 3, (v, h, w), dtype=torch.int32, device=cuda)
    before = slic.LAUNCHES["slic_vote"]
    got = slic.suppress_local_labels(labels)
    torch.cuda.synchronize()
    assert slic.LAUNCHES["slic_vote"] == before + 1
    for y0 in (0, h // 2, h - 64):
        lo, hi = max(y0 - 2, 0), min(y0 + 66, h)
        want = slic.suppress_local_labels_reference(labels[:, lo:hi].contiguous())[:, y0 - lo:y0 - lo + 64]
        assert torch.equal(got[:, y0:y0 + 64], want), f"rows {y0}..{y0 + 63}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2**31 - 3, 1), (1, 1, 2**31 - 3)], ids=["high", "wide"])
def test_slic_vote_on_a_view_near_the_int_limit(cuda, shape):
    """A view 2**31 - 3 high or wide (8.6 GB in and out): the grid's last
    row or column steps stop at the view's end instead of wrapping.  Such a
    view is all border, so the plain form passes it through; its first and
    last 64 pixels are also held to the plain form on them."""
    labels = torch.randint(-2, 3, shape, dtype=torch.int32, device=cuda)
    before = slic.LAUNCHES["slic_vote"]
    got = slic.suppress_local_labels(labels)
    torch.cuda.synchronize()
    assert slic.LAUNCHES["slic_vote"] == before + 1
    assert torch.equal(got, labels)
    for part in (slice(0, 64), slice(-64, None)):
        x = labels[:, part] if shape[1] > 1 else labels[:, :, part]
        y = got[:, part] if shape[1] > 1 else got[:, :, part]
        assert torch.equal(y, slic.suppress_local_labels_reference(x.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["default", "connectivity"])
def test_slic_segment_agrees_with_reference(slic_scenes, flags):
    lab, geom, p, labels, spmap = slic_scenes("full-9x1080x1920")
    if flags == "connectivity":
        p = SlicParams.create(SystemSettings(enforce_connectivity=True))
        labels, spmap = slic.segment(lab, geom, p)
    want_labels, want_map = slic.segment_reference(lab, geom, p)
    agree = float((labels == want_labels).float().mean())
    assert agree >= 0.9999, agree
    assert torch.equal(spmap.count.sum(dim=(1, 2)), want_map.count.sum(dim=(1, 2)))


@pytest.mark.cuda
def test_slic_kernels_per_view_independent_of_the_batch(slic_scenes):
    """Views 3..5 alone give the bits of their rows of the 9-view call."""
    lab, geom, p, labels, spmap = slic_scenes("ragged-9x543x967")
    v0, nv = 3, 3
    part = slic.SuperpixelMap(*(x[v0:v0 + nv].contiguous() for x in spmap))
    lab3, labels3 = lab[v0:v0 + nv].contiguous(), labels[v0:v0 + nv].contiguous()
    assert torch.equal(slic.find_center_association(lab3, part, geom, p),
                       slic.find_center_association(lab, spmap, geom, p)[v0:v0 + nv])
    got = slic.update_cluster_centers(lab3, labels3, part, geom)
    whole = slic.update_cluster_centers(lab, labels, spmap, geom)
    for f in ("center", "color", "count"):
        assert torch.equal(getattr(got, f), getattr(whole, f)[v0:v0 + nv]), f
    assert torch.equal(slic.suppress_local_labels(labels3), slic.suppress_local_labels(labels)[v0:v0 + nv])


@pytest.mark.cuda
def test_slic_wrappers_reject_bad_input(slic_scenes):
    lab, geom, p, labels, spmap = slic_scenes("S5-9x270x481")
    with pytest.raises(TypeError):
        slic.find_center_association(lab.double(), spmap, geom, p)
    with pytest.raises(ValueError):
        slic.find_center_association(lab.transpose(1, 2).contiguous().transpose(1, 2), spmap, geom, p)
    with pytest.raises(ValueError):
        slic.find_center_association(lab, spmap._replace(color=spmap.color.cpu()), geom, p)
    with pytest.raises(TypeError):
        slic.update_cluster_centers(lab, labels.long(), spmap, geom)
    with pytest.raises(ValueError):
        slic.update_cluster_centers(lab, labels.transpose(1, 2).contiguous().transpose(1, 2), spmap, geom)
    with pytest.raises(ValueError, match="does not cover"):  # cells of a 135-row image
        slic.update_cluster_centers(lab, labels, spmap, DerivedGeometry.create(481, 135, SystemSettings(spixl_size=5)))
    with pytest.raises(TypeError):
        slic.suppress_local_labels(labels.long())
    with pytest.raises(ValueError):
        slic.suppress_local_labels(labels[:, :, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [False, True])
def test_slic_launches_of_one_run(cuda, connectivity):
    """One ``run`` launches the assignment no_iter + 1 times, the update
    no_iter times and the vote twice under enforce_connectivity; the graph
    of ``jitted()`` counts the same launches at each replay."""
    from cl_multiview_stereo_tpu_torch.models import mvs_pipeline

    s = SystemSettings(**JIT_SETTINGS, enforce_connectivity=connectivity)
    pipe = mvs_pipeline.MVSPipeline.create(96, 72, s, device=cuda)
    want = {"slic_assign": s.no_iter + 1, "slic_update": s.no_iter, "slic_vote": 2 if connectivity else 0}
    rgb = _jit_scene(7.0, 1)
    before = dict(slic.LAUNCHES)
    art = pipe.run(rgb)
    torch.cuda.synchronize()
    assert {k: slic.LAUNCHES[k] - before[k] for k in want} == want
    fwd = pipe.jitted()
    fwd(rgb)
    replayed = dict(mvs_pipeline.REPLAYED_LAUNCHES)
    got = fwd(rgb)
    torch.cuda.synchronize()
    assert {k: mvs_pipeline.REPLAYED_LAUNCHES.get(k, 0) - replayed.get(k, 0) for k in want} == want
    assert torch.equal(got.labels, art.labels)


# Smoothness on csrc/smoothness.cu: the sweep's cell table and ring
# (smooth_cache) and the moves' scores (smooth_moves), each bitwise its
# plain form (ops/refine's build_cell_cache and smoothness_from_cache, taps
# summed in tap order) on seeded cell maps: the main path's tap counts T =
# 8 (steps 0) and 60 (steps 13), the main path's move counts, a ragged map
# (61x45 pixels at S = 8: 8x6 cells) and a band of cell rows.  The card's
# cache holds no tap field, so each routed score is held to the plain scorer
# on the plain cache of the same inputs.
SMOOTH_MAPS = {"3x12x16": (3, 12, 16), "ragged-9x8x6": (9, 8, 6)}
SMOOTH_REACH = {"T8": (0, 328.0), "T60": (13, 1.5)}
SMOOTH_GAMMA, SMOOTH_ALPHA = 0.125, 0.013888888888888888
SMOOTH_TAP_FIELDS = ("tap_ax", "tap_ay", "tap_d", "tap_sim", "wn")


def _smooth_inputs(shape, device, seed=11):
    """(context, input disparities) of a seeded cell map: centres near each
    cell's middle, colours near one grey, one far colour (every weight of
    that cell flushes to 0)."""
    v, mh, mw = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(mh), np.arange(mw), indexing="ij")
    center = np.stack([xx * 8 + 3.5, yy * 8 + 3.5], -1)[None] + rng.uniform(-2, 2, (v, mh, mw, 2))
    color = np.array([50.0, 0.0, 0.0]) + rng.normal(0, [3.0, 1.5, 1.5], (v, mh, mw, 3))
    color[:, mh // 2, mw // 2] = (400.0, 90.0, -90.0)
    tgt_d = rng.uniform(5.0, 9.0, (v, mh, mw))
    fl = np.stack([rng.uniform(0.05, 1.0, (v, mh, mw)), rng.uniform(0.0, 1.0, (v, mh, mw))], -1)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    ctx = refine.RefineContext(center=f(center), color=f(color), disp0=None, labels=None, samples=None,
                               fl=f(fl), ras_color=None)
    return ctx, f(tgt_d)


def _smooth_moves_in(tgt_d, m, seed=3):
    """m candidate planes near ``tgt_d``; the first move's cells hold nz = 0,
    zero and NaN normals."""
    rng = np.random.default_rng(seed)
    shape = tuple(tgt_d.shape)
    d_c = tgt_d[None] + torch.as_tensor(rng.normal(0, 0.5, (m,) + shape), dtype=torch.float32, device=tgt_d.device)
    n_c = rng.normal(0, 0.2, (m,) + shape + (3,))
    n_c[..., 2] += 1.0
    n_c /= np.linalg.norm(n_c, axis=-1, keepdims=True)
    flat = n_c[0].reshape(-1, 3)
    flat[0::5] = (1.0, 0.0, 0.0)
    flat[1::5] = 0.0
    flat[2::5] = np.nan
    return d_c.contiguous(), torch.as_tensor(n_c, dtype=torch.float32, device=tgt_d.device)


def _caches_equal(got, want):
    """The routed cache's table, ring, tap weights and first row bitwise
    the plain cache's; nothing T-wide in it."""
    for f in (*smoothness._CACHE_FIELDS, "gammas"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{f}: {m}")
    assert got.row0 == want.row0
    assert all(getattr(got, f) is None for f in SMOOTH_TAP_FIELDS)


def _scores_equal(cache, plain, d_c, n_c):
    """The routed scores on the card's cache, and on the plain cache, bitwise
    the plain scorer's on the plain cache; returns them."""
    want = smoothness.smoothness_moves_reference(plain, d_c, n_c, alpha=SMOOTH_ALPHA)
    got = smoothness.smoothness_moves(cache, d_c, n_c, alpha=SMOOTH_ALPHA)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(smoothness.smoothness_moves(plain, d_c, n_c, alpha=SMOOTH_ALPHA), want, rtol=0,
                               atol=0, equal_nan=True)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("reach", list(SMOOTH_REACH))
@pytest.mark.parametrize("shape", list(SMOOTH_MAPS))
def test_smooth_cache_bitwise(cuda, shape, reach):
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS[shape], cuda)
    steps, step_size = SMOOTH_REACH[reach]
    kw = dict(gamma=SMOOTH_GAMMA, steps=steps, step_size=step_size)
    before = smoothness.LAUNCHES["smooth_cache"]
    got = smoothness.cell_cache(ctx, tgt_d, **kw)
    torch.cuda.synchronize()
    assert smoothness.LAUNCHES["smooth_cache"] == before + 1
    assert got.gammas.numel() == 8 + 4 * steps and got.cell_table.shape == tgt_d.shape + (8,)
    want = smoothness.cell_cache_reference(ctx, tgt_d, **kw)
    _caches_equal(got, want)
    assert bool((want.wn == 0).any()) and bool((want.wn > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 3), (4, 5), (9, 3)], ids=str)
def test_smooth_cache_row_band_bitwise(cuda, rows):
    """A band of cell rows (the row-sharded refinement's block): the kernel
    writes those rows' ring and the whole map's table; equal to the whole
    map's cache cut to them, and to the plain band; the band's scores, its
    taps read from the whole map, bitwise the plain band's."""
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS["3x12x16"], cuda)
    kw = dict(gamma=SMOOTH_GAMMA, steps=13, step_size=1.5)
    band = smoothness.cell_cache(ctx, tgt_d, **kw, rows=rows)
    assert band.ring_d.is_contiguous() and band.ring_d.shape[1] == rows[1] and band.row0 == rows[0]
    plain = smoothness.cell_cache_reference(ctx, tgt_d, **kw, rows=rows)
    _caches_equal(band, plain)
    whole = smoothness.cell_cache(ctx, tgt_d, **kw)
    _caches_equal(band, whole._replace(row0=rows[0], **{f: getattr(whole, f)[:, rows[0]:rows[0] + rows[1]]
                                                        for f in ("ring_dcx", "ring_dcy", "ring_d", "ring_ok")}))
    d_c, n_c = _smooth_moves_in(tgt_d[:, rows[0]:rows[0] + rows[1]].contiguous(), 8)
    _scores_equal(band, plain, d_c, n_c)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 13, 16])
@pytest.mark.parametrize("reach", list(SMOOTH_REACH))
@pytest.mark.parametrize("shape", list(SMOOTH_MAPS))
def test_smooth_moves_bitwise(cuda, shape, reach, m):
    """M = 1 (the init: 128 cells a block, 8 taps a chunk), 8 (the refits),
    13 (9 cells a block, 11 lanes idle) and 16 (sweep 4's updates), NaN and
    nz = 0 normals in the first move."""
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS[shape], cuda)
    steps, step_size = SMOOTH_REACH[reach]
    kw = dict(gamma=SMOOTH_GAMMA, steps=steps, step_size=step_size)
    cache, plain = smoothness.cell_cache(ctx, tgt_d, **kw), smoothness.cell_cache_reference(ctx, tgt_d, **kw)
    d_c, n_c = _smooth_moves_in(tgt_d, m)
    before = smoothness.LAUNCHES["smooth_moves"]
    got = _scores_equal(cache, plain, d_c, n_c)
    torch.cuda.synchronize()
    assert smoothness.LAUNCHES["smooth_moves"] == before + 2
    assert bool(torch.isnan(got[0]).any()) and bool((got == np.float32(1e-6)).any())
    # the refit phase's stride-0 input state, read in place (move stride 0)
    _scores_equal(cache, plain, tgt_d[None].expand(m, *tgt_d.shape), n_c)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["center", "d"])
def test_smooth_moves_nan_at_an_off_map_source(cuda, where):
    """NaN planted in the centre or the disparity of cell (0, 5), the
    clamped source of cell (2, 5)'s off-map U taps (every pitch 2 at this
    flatness) and of none of its on-map taps: the plain sum is NaN there,
    though the taps are off the map, and the kernel must not skip them."""
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS["3x12x16"], cuda)
    ctx = ctx._replace(fl=ctx.fl.clone())
    ctx.fl[..., 0] = 1.0
    if where == "center":
        ctx = ctx._replace(center=ctx.center.clone())
        ctx.center[:, 0, 5, 0] = float("nan")
    else:
        tgt_d = tgt_d.clone()
        tgt_d[:, 0, 5] = float("nan")
    kw = dict(gamma=SMOOTH_GAMMA, steps=13, step_size=1.5)
    cache, plain = smoothness.cell_cache(ctx, tgt_d, **kw), smoothness.cell_cache_reference(ctx, tgt_d, **kw)
    _caches_equal(cache, plain)
    d_c, n_c = _smooth_moves_in(tgt_d.nan_to_num(7.0), 8)
    n_c[0] = n_c[1]
    got = _scores_equal(cache, plain, d_c, n_c)
    nan = torch.isnan(got)
    assert bool(nan[:, :, 2, 5].all()) and not bool(nan[:, :, 2, 7].any()) and bool((~nan).any())
    assert not bool(cache.cell_table[:, 2, 5].isnan().any())


@pytest.mark.cuda
def test_smooth_moves_zero_divisor_and_numerator(cuda):
    """Moves whose every tap divides 0 by nz (d = 0, fronto normals: the
    full loop's zero quotient), 0 by 0 (nz = 0, d = 0, normal (0, 0, 0)),
    x by 0 (nz = 0), and divisors past the hoisted divide's range (2^-70,
    2^70): bitwise the plain form."""
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS["ragged-9x8x6"], cuda)
    ctx = ctx._replace(center=torch.zeros_like(ctx.center))  # ax = ay = 0 at every tap
    kw = dict(gamma=SMOOTH_GAMMA, steps=2, step_size=1.5)
    cache, plain = smoothness.cell_cache(ctx, tgt_d, **kw), smoothness.cell_cache_reference(ctx, tgt_d, **kw)
    d_c = torch.zeros((5,) + tuple(tgt_d.shape), device=cuda)
    d_c[3:] = tgt_d
    n_c = torch.zeros(tuple(d_c.shape) + (3,), device=cuda)
    n_c[0, ..., 2] = 1.0
    n_c[2, ..., 0] = 1.0
    n_c[3, ..., 2] = 2.0 ** -70
    n_c[4, ..., 2] = 2.0 ** 70
    got = _scores_equal(cache, plain, d_c, n_c)
    eps = got == np.float32(1e-6)  # the far colour's cell: no weight
    assert bool((torch.isnan(got[1]) | eps[1]).all()) and bool(torch.isnan(got[1]).any())
    assert not bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
def test_smooth_divide_matches_ieee(cuda):
    """``smooth_moves``' divide, a reciprocal per divisor and the quotient
    steps per numerator, bitwise CUDA's IEEE quotient: every float32
    mantissa as divisor against numerators across and past its range,
    random pairs over the whole exponent range, and the edge operands
    (zeros, subnormals, the range's ends, inf, NaN, the largest floats)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    den = (1.0 + torch.arange(1 << 23, device=cuda, dtype=torch.float64) / (1 << 23)).float()
    raw = torch.randint(0, 1 << 32, (1 << 22,), generator=g, device=cuda, dtype=torch.int64)
    bits = lambda r: (r - (1 << 32) * (r >> 31)).to(torch.int32).view(torch.float32)  # noqa: E731
    edge = torch.tensor([0.0, -0.0, 1e-45, -1e-40, 2.0 ** -126, 2.0 ** -60, -(2.0 ** -60), 2.0 ** 60,
                         2.0 ** 61, 3.4028235e38, float("inf"), -float("inf"), float("nan"), 1.0, -3.0, 7.5],
                        device=cuda)
    cases = [
        (torch.rand(1 << 23, generator=g, device=cuda) * 2.0 ** torch.randint(-64, 64, (1 << 23,), generator=g,
                                                                               device=cuda), den),
        (-(1.0 + torch.rand(1 << 23, generator=g, device=cuda)) * 2.0 ** 59, den * 2.0 ** -59),
        (bits(raw), bits(raw.flip(0) * 3 % (1 << 32))),
        (edge.repeat(edge.numel()), edge.repeat_interleave(edge.numel())),
    ]
    fast = 0
    for num, d in cases:
        q = smoothness.hoisted_divide(num, d)
        torch.testing.assert_close(q, num / d, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(torch.signbit(q[q == 0]), torch.signbit((num / d)[q == 0]))
        inside = lambda a: (a.abs() >= 2.0 ** -60) & (a.abs() <= 2.0 ** 60)  # noqa: E731
        fast += int((inside(num) & inside(d)).sum())
    assert fast > 3 * (1 << 22)


@pytest.mark.cuda
def test_smooth_moves_beyond_one_round(cuda):
    """M = 40 (3 cells a block, 8 lanes idle) and M = 130 (one cell a block,
    two rounds of its 128 lanes, each staging the taps again): bitwise the
    plain form and each move's row of a call with that move alone."""
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS["ragged-9x8x6"], cuda)
    kw = dict(gamma=SMOOTH_GAMMA, steps=2, step_size=1.5)
    cache, plain = smoothness.cell_cache(ctx, tgt_d, **kw), smoothness.cell_cache_reference(ctx, tgt_d, **kw)
    for m in (40, 130):
        d_c, n_c = _smooth_moves_in(tgt_d, m)
        got = _scores_equal(cache, plain, d_c, n_c)
        for k in (0, 17, 39, m - 1):
            torch.testing.assert_close(smoothness.smoothness_moves(cache, d_c[k:k + 1], n_c[k:k + 1],
                                                                   alpha=SMOOTH_ALPHA)[0],
                                       got[k], rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_smoothness_on_the_card_launches_the_kernels(strips_scene, monkeypatch):
    """``refine.refine`` on the card: ``smooth_cache`` once a sweep and at
    the init, ``smooth_moves`` at the init and twice a sweep, the plain
    forms never called, no cache holding a T-wide field; its state equals
    the run with the plain forms."""
    sc = strips_scene
    sched, pairs = sc["sched"], sc["kw"]["pairs"]
    real_cache, real_moves = smoothness.cell_cache, smoothness.smoothness_moves
    monkeypatch.setattr(smoothness, "cell_cache", smoothness.cell_cache_reference)
    monkeypatch.setattr(smoothness, "smoothness_moves", smoothness.smoothness_moves_reference)
    want = refine.refine(sc["ctx"], sched, pairs=pairs)
    caches = []

    def record(*a, **k):
        caches.append(real_cache(*a, **k))
        return caches[-1]

    monkeypatch.setattr(smoothness, "cell_cache", record)
    monkeypatch.setattr(smoothness, "smoothness_moves", real_moves)

    def plain(*a, **k):
        raise AssertionError("the card called a plain smoothness form")

    monkeypatch.setattr(smoothness, "build_cell_cache", plain)
    monkeypatch.setattr(smoothness, "smoothness_from_cache", plain)
    before = dict(smoothness.LAUNCHES)
    got = refine.refine(sc["ctx"], sched, pairs=pairs)
    torch.cuda.synchronize()
    assert {k: smoothness.LAUNCHES[k] - before[k] for k in before} == {
        "smooth_cache": 1 + sched.no_prop, "smooth_moves": 1 + 2 * sched.no_prop}
    for f in refine.RefineState._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{f}: {m}")
    assert len(caches) == 1 + sched.no_prop
    for cache in caches:
        assert all(getattr(cache, f) is None for f in SMOOTH_TAP_FIELDS)


@pytest.mark.cuda
def test_smooth_cache_allocates_nothing_t_wide(cuda, monkeypatch):
    """The card's cache at the main path's reach (T = 60) on a 9x135x240 map,
    the slice's: the tensors its call allocates (``torch.empty`` and
    ``torch.zeros`` on this thread, recorded) are the table, the ring and
    ``ras``'s zeros, none T wide, and the cache holds no tap field."""
    import threading

    ctx, tgt_d = _smooth_inputs((9, 135, 240), cuda)
    kw = dict(gamma=SMOOTH_GAMMA, steps=13, step_size=328.0)
    smoothness.cell_cache(ctx, tgt_d, **kw)  # builds the kernel, makes the weights' table
    shapes, me = [], threading.get_ident()

    def record(real):
        def alloc(*a, **k):
            out = real(*a, **k)
            if threading.get_ident() == me and out.is_cuda:
                shapes.append(tuple(out.shape))
            return out
        return alloc

    for name in ("empty", "zeros", "empty_like", "zeros_like"):
        monkeypatch.setattr(torch, name, record(getattr(torch, name)))
    cache = smoothness.cell_cache(ctx, tgt_d, **kw)
    monkeypatch.undo()
    torch.cuda.synchronize()
    cells = tuple(tgt_d.shape)
    assert sorted(shapes) == sorted([cells + (8,)] * 5 + [(1, 4)]), shapes
    assert cache.gammas.numel() == 60 and all(s[-1] != 60 for s in shapes)
    assert all(getattr(cache, f) is None for f in SMOOTH_TAP_FIELDS)


@pytest.mark.cuda
def test_smoothness_wrappers_reject_bad_input(cuda):
    ctx, tgt_d = _smooth_inputs(SMOOTH_MAPS["3x12x16"], cuda)
    kw = dict(gamma=SMOOTH_GAMMA, steps=2, step_size=1.5)
    with pytest.raises(TypeError):
        smoothness.cell_cache(ctx, tgt_d.double(), **kw)
    with pytest.raises(ValueError):
        smoothness.cell_cache(ctx._replace(fl=ctx.fl.cpu()), tgt_d, **kw)
    with pytest.raises(ValueError):
        smoothness.cell_cache(ctx, tgt_d, **kw, rows=(10, 4))
    cache = smoothness.cell_cache(ctx, tgt_d, **kw)
    d_c, n_c = _smooth_moves_in(tgt_d, 4)
    with pytest.raises(TypeError):
        smoothness.smoothness_moves(cache, d_c.double(), n_c, alpha=SMOOTH_ALPHA)
    with pytest.raises(ValueError):
        smoothness.smoothness_moves(cache, d_c[:, :, :-1], n_c, alpha=SMOOTH_ALPHA)
    with pytest.raises(ValueError):
        smoothness.smoothness_moves(cache._replace(cell_table=cache.cell_table.cpu()), d_c, n_c, alpha=SMOOTH_ALPHA)
    with pytest.raises(ValueError, match="band"):
        smoothness.smoothness_moves(cache._replace(row0=1), d_c, n_c, alpha=SMOOTH_ALPHA)
    with pytest.raises(ValueError, match="aligned"):
        table = torch.empty(cache.cell_table.numel() + 1, device=cuda)[1:].view(cache.cell_table.shape)
        smoothness.smoothness_moves(cache._replace(cell_table=table), d_c, n_c, alpha=SMOOTH_ALPHA)
    with pytest.raises(ValueError, match="step_size"):
        smoothness.cell_cache(ctx, tgt_d, gamma=SMOOTH_GAMMA, steps=2, step_size=2.0 ** 24)


# ---------------------------------------------------------------------------
# The plane rasterization (csrc/raster.cu) and the move chain (csrc/chain.cu)
# ---------------------------------------------------------------------------

# (views, cell rows, cell columns): a map of 8-pixel cells, and a ragged
# one whose image is not a whole number of cells
CHAIN_MAPS = {"3x12x16": (3, 12, 16), "ragged-9x7x5": (9, 7, 5)}
# chain_update's tiles are 32 cells: 33 cells leave a tail tile of one
UPDATE_MAPS = {**CHAIN_MAPS, "33-cells-1x3x11": (1, 3, 11)}
CHAIN_GAMMA = 0.125
# the update moves at M = 8 (immediate only) and M = 16 (two reach steps)
CHAIN_REACH = {8: (0, 1.0), 16: (2, 1.0)}
# M of the update walk, the first M of the moves of 8 reach steps of
# pitch 1 (CHAIN_REACH's at M = 8 and 16): none, the main path's sweeps
# 0-4 (8, 10, 14, 16) and 40, past the kernel's 16-move chunks (a map too
# small for 40 keeps the moves that lie on it)
UPDATE_M = (0, 8, 10, 14, 16, 40)
UPDATE_REACH = (8, 1.0)


def _exact(got, want, tag=""):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{tag}: {m}")


def _chain_inputs(shape, device, seed=21):
    """A seeded cell map, its image's labels and a state with every edge the
    kernels meet: NaN and +-inf disparities, nz = 0, zero and NaN normals,
    a far colour (its similarities flush to 0), scores whose products
    underflow to subnormals, NaN and inf scores."""
    v, mh, mw = shape
    h, w = mh * 8 - (3 if mh % 2 else 0), mw * 8 - (5 if mw % 2 else 0)
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(mh), np.arange(mw), indexing="ij")
    center = np.stack([xx * 8 + 3.5, yy * 8 + 3.5], -1)[None] + rng.uniform(-2, 2, (v, mh, mw, 2))
    color = np.array([50.0, 0.0, 0.0]) + rng.normal(0, [3.0, 1.5, 1.5], (v, mh, mw, 3))
    color[:, mh // 2, mw // 2] = (400.0, 90.0, -90.0)
    labels = rng.integers(0, mh * mw, (v, h, w)).astype(np.int32)
    d = rng.uniform(4.0, 11.0, (v, mh, mw))
    d.reshape(-1)[5::13] = np.nan
    d.reshape(-1)[7::17] = np.inf
    d.reshape(-1)[9::19] = -np.inf
    nrm = rng.normal(0, 0.2, (v, mh, mw, 3))
    nrm[..., 2] += 1.0
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    flat = nrm.reshape(-1, 3)
    flat[0::7] = (1.0, 0.0, 0.0)
    flat[1::11] = 0.0
    flat[2::23] = np.nan
    sm, cs = rng.uniform(0.01, 1.0, (2, v, mh, mw))
    sm.reshape(-1)[3::9] = 1e-20  # sm0 * cs0 underflows
    cs.reshape(-1)[3::9] = 1e-19
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    ctx = refine.RefineContext(center=f(center), color=f(color), disp0=None,
                               labels=torch.as_tensor(labels, device=device), samples=None, fl=None,
                               ras_color=None)
    state = refine.RefineState(d=f(d), sm=f(sm), cs=f(cs), n=f(nrm))
    return ctx, state


def _chain_scores(m, shape, device, seed):
    """(sm1, cs1) of m moves: uniform, with NaN, +inf, and products that
    underflow to subnormals (flushed: they never beat a normal product)."""
    rng = np.random.default_rng(seed)
    sm1, cs1 = rng.uniform(0.0, 1.2, (2, m) + shape)
    sm1.reshape(m, -1)[:, 1::10] = np.nan
    cs1.reshape(m, -1)[:, 2::10] = np.inf
    sm1.reshape(m, -1)[:, 3::10] = 2e-20
    cs1.reshape(m, -1)[:, 3::10] = 3e-20
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return f(sm1), f(cs1)


def _ring(shape, device, seed, ok="random"):
    """A cache holding only the ring fields the chain reads, (V, rows, Mw,
    8) each, with NaN and inf entries; ``ok`` "random" or "none"."""
    rng = np.random.default_rng(seed)
    dcx, dcy = rng.uniform(-12, 12, (2,) + shape + (8,))
    rd = rng.uniform(4.0, 11.0, shape + (8,))
    rd.reshape(-1)[4::29] = np.nan
    dcx.reshape(-1)[6::31] = np.inf
    dcx.reshape(-1)[8::37] = 0.0
    dcy.reshape(-1)[8::37] = 0.0
    rok = rng.random(shape + (8,)) < 0.8 if ok == "random" else np.zeros(shape + (8,), bool)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return refine.IterCache(tap_ax=None, tap_ay=None, tap_d=None, tap_sim=None, wn=None, ras=None,
                            ring_dcx=f(dcx), ring_dcy=f(dcy), ring_d=f(rd),
                            ring_ok=torch.as_tensor(rok, device=device), cell_table=None, gammas=None, row0=0)


@pytest.mark.cuda
@pytest.mark.parametrize("band", ["whole", "band", "offset"])
@pytest.mark.parametrize("shape", list(CHAIN_MAPS))
def test_raster_planes_bitwise(cuda, shape, band):
    """The table (rasterize_table) and the map (rasterize_planes) bitwise
    their plain forms, NaN and +-inf included; a band of pixel rows from
    ``row0`` > 0 as ``spatial.block_table`` takes it, for the map too (its
    disparities are the plain table's); labels 4 bytes off 16-byte
    alignment ("offset": the kernel's one-pixel-a-thread form).  The
    ragged map's 35-pixel rows are not a multiple of the kernel's 4 pixels
    a thread."""
    ctx, state = _chain_inputs(CHAIN_MAPS[shape], cuda)
    labels = ctx.labels
    h = labels.shape[1]
    row0, rows = (h // 3, h // 2) if band == "band" else (0, h)
    labels = labels[:, row0:row0 + rows]
    if band == "offset":
        flat = torch.empty(labels.numel() + 1, dtype=torch.int32, device=cuda)
        flat[1:] = labels.reshape(-1)
        labels = flat[1:].view(labels.shape)
        assert labels.data_ptr() % 16 == 4
    color = fusion.gather_cells(labels, ctx.color).reshape(-1, 3)
    before = raster.LAUNCHES["raster_planes"]
    got = raster.table(labels, ctx.center, color, state.d, state.n, row0)
    want = refine.rasterize_table_reference(labels, ctx.center, color, state.d, state.n, row0)
    _exact(got, want, "table")
    assert torch.isnan(got[:, 0]).any() and torch.isinf(got[:, 0]).any()
    _exact(refine.rasterize_table(labels, ctx.center, color, state.d, state.n, row0), want, "routed table")
    # the map of the same rows: the plain table's disparities
    _exact(raster._raster(labels, ctx.center, state.d, state.n, None, row0), want[:, 0].reshape(labels.shape),
           "map")
    if band == "whole":
        _exact(fusion.rasterize_planes(labels, ctx.center, state.d, state.n),
               fusion.rasterize_planes_reference(labels, ctx.center, state.d, state.n), "planes")
    torch.cuda.synchronize()
    assert raster.LAUNCHES["raster_planes"] - before == (4 if band == "whole" else 3)


@pytest.mark.cuda
def test_raster_planes_off_map_label_is_nan(cuda):
    """A label outside the view's map writes NaN (the plain gather raises)."""
    ctx, state = _chain_inputs(CHAIN_MAPS["3x12x16"], cuda)
    labels = ctx.labels.clone()
    labels[0, 0, 0], labels[1, 2, 3] = -1, 12 * 16
    got = raster.planes(labels, ctx.center, state.d, state.n)
    assert torch.isnan(got[0, 0, 0]) and torch.isnan(got[1, 2, 3])
    ok = labels == ctx.labels
    _exact(got[ok], fusion.rasterize_planes_reference(ctx.labels, ctx.center, state.d, state.n)[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, (2, 3), (0, 1)])
@pytest.mark.parametrize("m", list(CHAIN_REACH))
@pytest.mark.parametrize("shape", list(CHAIN_MAPS))
def test_chain_moves_bitwise(cuda, shape, m, rows):
    """``chain_moves`` bitwise ``update_candidates_reference`` at M = 8 and
    16, the whole map and bands of cell rows, the wrapped neighbours'
    values included (``ok`` masks them)."""
    ctx, state = _chain_inputs(CHAIN_MAPS[shape], cuda)
    v, mh, mw = state.d.shape
    offs = refine._update_move_offsets(*CHAIN_REACH[m], mw, mh)
    assert len(offs) == m
    got = chain.candidates(ctx, state, offs, CHAIN_GAMMA, rows=rows)
    want = refine.update_candidates_reference(ctx, state, offs, CHAIN_GAMMA, rows=rows)
    for name, a, b in zip(("d", "n", "sim", "ok"), got, want):
        assert a.is_contiguous() and a.dtype == b.dtype
        _exact(a, b, name)
    assert got[3].any() and not got[3].all()
    _exact(refine.update_candidates(ctx, state, offs, CHAIN_GAMMA, rows=rows)[0], want[0], "routed")


def _misaligned(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``a`` whose base is 4 bytes off 16-byte
    alignment."""
    flat = torch.empty(a.numel() * a.element_size() + 4, dtype=torch.uint8, device=a.device)
    out = flat[4:].view(a.dtype).view(a.shape)
    out.copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ok", ["random", "none", "offset"])
@pytest.mark.parametrize("it", [0, 4], ids=["greedy", "product"])
@pytest.mark.parametrize("m", UPDATE_M)
@pytest.mark.parametrize("shape", list(UPDATE_MAPS))
def test_chain_update_bitwise(cuda, shape, m, it, ok):
    """``chain_update`` bitwise ``update_phase_reference``: the state after
    the update moves and the 8 refit normals and their validity, greedy
    and not, with NaN, inf and underflowing scores, and with no move or
    ring neighbour valid; M = 0 (the refits alone) to 40 (more than one
    chunk of moves), a map whose cells end in a ragged tile, and
    ("offset") ring fields 4 bytes off 16-byte alignment."""
    ctx, state = _chain_inputs(UPDATE_MAPS[shape], cuda)
    v, mh, mw = state.d.shape
    offs = refine._update_move_offsets(*UPDATE_REACH, mw, mh)
    moves = tuple(a[:m] for a in refine.update_candidates_reference(ctx, state, offs, CHAIN_GAMMA))
    offs = offs[:m]
    assert len(offs) == m or m > 16
    if ok == "none":
        moves = (*moves[:3], torch.zeros_like(moves[3]))
    sm1, cs1 = (a[:len(offs)] for a in _chain_scores(max(m, 1), tuple(state.d.shape), cuda, seed=m + it))
    cache = _ring(tuple(state.d.shape), cuda, seed=7, ok="none" if ok == "none" else "random")
    if ok == "offset":
        cache = cache._replace(**{f: _misaligned(getattr(cache, f))
                                  for f in ("ring_dcx", "ring_dcy", "ring_d", "ring_ok")})
    got = chain.update(cache, state, moves, sm1, cs1, it < 4)
    want = refine.update_phase_reference(cache, state, moves, sm1, cs1, it < 4)
    for f in refine.RefineState._fields:
        _exact(getattr(got[0], f), getattr(want[0], f), f)
    _exact(got[1], want[1], "n_ref")
    _exact(got[2], want[2], "ok_ref")
    changed = (got[0].d != state.d) & ~torch.isnan(state.d)
    assert changed.any() == (ok != "none" and len(offs) > 0) and torch.isnan(got[1]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("ok", ["random", "none"])
@pytest.mark.parametrize("it", [0, 4], ids=["greedy", "product"])
@pytest.mark.parametrize("shape", list(CHAIN_MAPS))
def test_chain_refit_bitwise(cuda, shape, it, ok):
    """``chain_refit`` bitwise ``refit_phase_reference``, greedy and not,
    with NaN refit normals, NaN, inf and underflowing scores, and with no
    refit valid; d is the input state's own tensor."""
    ctx, state = _chain_inputs(CHAIN_MAPS[shape], cuda)
    cache = _ring(tuple(state.d.shape), cuda, seed=9, ok=ok)
    _, n_ref, ok_ref = refine.update_phase_reference(
        cache, state, tuple(a[:0] for a in refine.update_candidates_reference(ctx, state, [(1, 0)], CHAIN_GAMMA)),
        state.sm[None][:0], state.cs[None][:0], False)
    sm1, cs1 = _chain_scores(8, tuple(state.d.shape), cuda, seed=40 + it)
    got = chain.refit(state, n_ref, ok_ref, sm1, cs1, it < 4)
    want = refine.refit_phase_reference(state, n_ref, ok_ref, sm1, cs1, it < 4)
    assert got.d is state.d
    for f in refine.RefineState._fields:
        _exact(getattr(got, f), getattr(want, f), f)
    assert (got.sm != state.sm).any() == (ok == "random")


@pytest.mark.cuda
def test_move_chain_on_the_card_launches_the_kernels(strips_scene):
    """One sweep on the card (``refine.propagate_iteration``, greedy and
    not): ``chain_moves`` once, ``chain_update`` and ``chain_refit`` once
    each, the table once; its state bitwise the sweep on the plain forms
    (the plain table, candidates and chain, the routed scorers)."""
    sc = strips_scene
    ctx, sched, kw = sc["ctx"], sc["sched"], sc["kw"]
    state = refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    mh, mw = state.d.shape[1:]
    for it in (0, 4):  # the reach of the scene's last sweep at it = 4
        sweep = min(it, sched.no_prop - 1)
        reach = dict(steps=sched.steps_per_iter[sweep], step_size=sched.step_size_per_iter[sweep])
        before = dict(chain.LAUNCHES), raster.LAUNCHES["raster_planes"]
        got = refine.propagate_iteration(ctx, state, it, **kw, **reach)
        torch.cuda.synchronize()
        assert {k: chain.LAUNCHES[k] - before[0][k] for k in chain.LAUNCHES} == {
            "chain_moves": 1, "chain_update": 1, "chain_refit": 1}
        assert raster.LAUNCHES["raster_planes"] - before[1] == 1
        cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], **reach)
        cache = cache._replace(ras=refine.rasterize_table_reference(ctx.labels, ctx.center, ctx.ras_color,
                                                                    state.d, state.n))
        offs = refine._update_move_offsets(reach["steps"], reach["step_size"], mw, mh)
        moves = refine.update_candidates_reference(ctx, state, offs, kw["gamma"])
        want = refine.move_chain_reference(cache, state, moves, it, partial(refine.score_moves, ctx, cache, **kw))
        for f in refine.RefineState._fields:
            _exact(getattr(got, f), getattr(want, f), f"it {it} {f}")


@pytest.mark.cuda
def test_chain_and_raster_wrappers_reject_bad_input(cuda):
    ctx, state = _chain_inputs(CHAIN_MAPS["3x12x16"], cuda)
    offs = refine._update_move_offsets(0, 1.0, 16, 12)
    with pytest.raises(TypeError):
        chain.candidates(ctx, state._replace(n=state.n.double()), offs, CHAIN_GAMMA)
    with pytest.raises(ValueError, match="band"):
        chain.candidates(ctx, state, offs, CHAIN_GAMMA, rows=(10, 4))
    with pytest.raises(ValueError):
        chain.candidates(ctx._replace(color=ctx.color.cpu()), state, offs, CHAIN_GAMMA)
    moves = chain.candidates(ctx, state, offs, CHAIN_GAMMA)
    sm1, cs1 = _chain_scores(8, tuple(state.d.shape), cuda, seed=1)
    cache = _ring(tuple(state.d.shape), cuda, seed=2)
    with pytest.raises(ValueError):
        chain.update(cache, state, moves, sm1[:7], cs1, True)
    with pytest.raises(TypeError):
        chain.update(cache._replace(ring_ok=cache.ring_ok.float()), state, moves, sm1, cs1, True)
    _, n_ref, ok_ref = chain.update(cache, state, moves, sm1, cs1, True)
    with pytest.raises(ValueError):
        chain.refit(state, n_ref[:, :1], ok_ref, sm1, cs1, False)
    with pytest.raises(ValueError):
        raster.planes(ctx.labels[0], ctx.center, state.d, state.n)
    with pytest.raises(ValueError):
        raster.table(ctx.labels, ctx.center, torch.zeros((5, 3), device=cuda), state.d, state.n)


# the Lab conversion (csrc/color.cu) and the extent walk (csrc/extent.cu)


def _same_bits(got, want, tag=""):
    """float32 tensors equal bit for bit; the first differences shown."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, tag
    bad = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
    if len(bad):
        rows = [(tuple(i.tolist()), got[tuple(i)].item(), want[tuple(i)].item()) for i in bad[:8]]
        raise AssertionError(f"{tag}: {len(bad)} of {got.numel()} differ; (index, kernel, plain): {rows}")


def _lab_grid(is_float: bool) -> int:
    """The most blocks of a ``lab_convert`` launch: its blocks per SM
    (``lab_convert_blocks_per_sm``) times the SMs."""
    import ctypes

    from cl_multiview_stereo_tpu_torch.kernels import build

    fn = build.load("color").lab_convert_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    blocks = ctypes.c_int(0)
    assert fn(int(is_float), ctypes.byref(blocks)) == 0 and blocks.value >= 1
    return blocks.value * torch.cuda.get_device_properties(0).multi_processor_count


def _lab_input(case, device):
    """The image of a lab_convert case: every uint8 RGB triple once (a
    4096x4096 image), the 9-view scene, floats in [0, 255], a strided view,
    float64, no pixel, a contiguous view whose base sits 1 byte (uint8) or
    4 bytes (float32) past a 16-byte boundary, 1, 1,023 and 1,025 pixels
    (no whole 1,024-pixel tile, less than one, one and a pixel), or more
    whole tiles than the launch has blocks."""
    if case == "every_triple":
        code = torch.arange(2**24, dtype=torch.int32, device=device)
        return torch.stack([code >> 16, (code >> 8) & 255, code & 255], dim=-1).to(torch.uint8).reshape(4096, 4096, 3)
    rng = np.random.default_rng(3)
    if case in ("offset_uint8", "offset_float32"):
        n = 2 * 61 * 45 * 3 + 7 * 1024 * 3
        flat = rng.integers(0, 256, n + 1).astype(np.uint8 if case == "offset_uint8" else np.float32)
        rgb = torch.as_tensor(flat, device=device)[1:].view(-1, 3)
        assert rgb.is_contiguous() and rgb.data_ptr() % 16 == rgb.element_size()
        return rgb
    if case.startswith("pixels_"):
        return torch.as_tensor(rng.integers(0, 256, (int(case[7:]), 3), dtype=np.uint8), device=device)
    if case == "more_tiles":
        rgb = torch.as_tensor(rng.integers(0, 256, (2, 1000, 1000, 3), dtype=np.uint8), device=device)
        assert rgb.numel() // 3 // 1024 > _lab_grid(False)
        return rgb
    if case == "scene":
        rgb, _ = synthetic.fronto_parallel_scene(270, 480, 3, 3, disp=7.0, bl_ratio=1.0359)
        return torch.as_tensor(rgb, device=device)
    if case == "float32":
        return torch.as_tensor(rng.random((2, 61, 45, 3), dtype=np.float32) * 255, device=device)
    if case == "strided":
        rgb = torch.as_tensor(rng.integers(0, 256, (3, 40, 64, 3), dtype=np.uint8), device=device)
        return rgb.permute(0, 2, 1, 3)[:, ::3]
    if case == "float64":
        return torch.as_tensor(rng.random((5, 7, 3)) * 255, device=device)
    return torch.zeros((2, 0, 5, 3), dtype=torch.uint8, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["every_triple", "scene", "float32", "strided", "float64", "empty", "offset_uint8",
                                  "offset_float32", "pixels_1", "pixels_1023", "pixels_1025", "more_tiles"])
def test_lab_convert_bitwise(cuda, case):
    """``lab_convert`` bitwise the plain form run on the card: every uint8
    RGB triple, a float input, a non-contiguous view, a dtype the wrapper
    casts, bases off 16-byte alignment, ragged tiles and more tiles than
    blocks; one launch a call, none for no pixel."""
    rgb = _lab_input(case, cuda)
    before = color.LAUNCHES["lab_convert"]
    got = rgb_to_lab(rgb)
    torch.cuda.synchronize()
    assert color.LAUNCHES["lab_convert"] - before == (0 if case == "empty" else 1)
    assert got.is_contiguous() and got.shape == rgb.shape
    _same_bits(got, rgb_to_lab_reference(rgb), case)


def _extent_inputs(case, device):
    """(labels, centres, geometry) of an extent_walk case: SLIC's labels and
    map on a 2x2 two-plane scene (the CPU parity test's shapes, and a width
    of 70, not a multiple of 4), on the slice's 9-view 1080p scene, on a
    view narrower than 2 S, or that scene's labels with centres off the
    view (negative, huge, inf, NaN); at S = 4 and S = 16; labels whose base
    sits 4 bytes past a 16-byte boundary; or centres of one cell a view
    moved 100 rows down, 12 cells from its tile's other cells."""
    if case == "full":
        s, (h, w) = SystemSettings(), (1080, 1920)
        rgb, _ = synthetic.fronto_parallel_scene(h, w, 3, 3, disp=40.0, bl_ratio=s.bl_ratio)
    else:
        spixl = {"S4": 4, "S16": 16}.get(case, 8)
        s = SystemSettings(array_width=2, array_height=2, min_disp=2, max_disp=6, bl_ratio=1.0, no_prop=1,
                           spixl_size=spixl)
        h, w = {"narrow": (40, 12), "off_view": (48, 64), "S4": (48, 64), "S16": (96, 128), "offset": (48, 64),
                "moved": (192, 128)}.get(case, case)
        rgb, _ = synthetic.two_plane_scene(h, w, array_width=2, array_height=2, disp_bg=3.0, disp_fg=5.0,
                                           bl_ratio=1.0, seed=h)
    geom = DerivedGeometry.create(w, h, s)
    labels, spmap = slic.segment(rgb_to_lab(torch.as_tensor(rgb, device=device)), geom, SlicParams.create(s))
    centers = spmap.center
    if case == "off_view":
        odd = torch.tensor([-3.7, -1e30, 1e30, 3e9, float("inf"), float("-inf"), float("nan"), w + 0.5],
                           device=device)
        centers = centers.clone()
        centers.view(-1)[: 2 * len(odd):2] = odd
        centers.view(-1)[1: 2 * len(odd):2] = odd.flip(0)
    if case == "offset":
        flat = torch.empty(labels.numel() + 1, dtype=labels.dtype, device=device)
        flat[1:] = labels.reshape(-1)
        labels = flat[1:].view(labels.shape)
        assert labels.is_contiguous() and labels.data_ptr() % 16 == 4
    if case == "moved":
        centers = centers.clone()
        centers[:, 0, 0, 1] += 100.0
    return labels, centers, geom


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(48, 64), (37, 53), (61, 45), "full", "narrow", "off_view", (45, 70), "S4", "S16",
                                  "offset", "moved"], ids=str)
def test_extent_walk_bitwise(cuda, case):
    """``extent_walk`` bitwise the plain walk on the card: SLIC's labels at
    the CPU parity test's three shapes and the slice's, a view narrower
    than 2 S (rays leave it even after the centre clamp), centres off the
    view, a width not a multiple of 4, S = 4 and 16, a label base off
    16-byte alignment, and a centre far from its tile's other cells; one
    launch a call."""
    labels, centers, geom = _extent_inputs(case, cuda)
    if case == "narrow":
        assert labels.shape[2] < 2 * geom.spixl_size
    before = superpixel.LAUNCHES["extent_walk"]
    got = superpixel.superpixel_extent(labels, centers, geom)
    torch.cuda.synchronize()
    assert superpixel.LAUNCHES["extent_walk"] - before == 1
    want = superpixel.superpixel_extent_reference(labels, centers, geom)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want), f"{int((got != want).sum())} of {want.numel()} differ"
    assert int(got.max()) > 0


@pytest.mark.cuda
def test_lab_and_extent_wrappers_reject_bad_input(cuda):
    with pytest.raises(ValueError):
        rgb_to_lab(torch.zeros((2, 4, 5, 4), dtype=torch.uint8, device=cuda))
    labels, centers, geom = _extent_inputs((48, 64), cuda)
    with pytest.raises(ValueError):
        superpixel.superpixel_extent(labels[0], centers, geom)
    with pytest.raises(TypeError):
        superpixel.superpixel_extent(labels, centers.double(), geom)
    with pytest.raises(ValueError):
        superpixel.superpixel_extent(labels, centers[:, :-1], geom)
    with pytest.raises(ValueError):
        superpixel.superpixel_extent(labels, centers.cpu(), geom)


# ---------------------------------------------------------------------------
# Fusion's cross-check (csrc/crosscheck.cu) and the seeds' edge snap
# (csrc/slic.cu)
# ---------------------------------------------------------------------------

# view ranges of the cross-check: every view, a block of 3 (the sharded
# path's rank 1 of 3), two views and one (a warp thread's chains on 4 and 9
# rows), the last view alone, and none (no launch)
VIEW_RANGES = {"all": None, "3..5": (3, 3), "4..5": (4, 2), "first": (0, 1), "last": (8, 1), "none": (0, 0)}


def _seeded_maps(device, v=9, h=53, w=131, seed=0):
    """Piecewise disparities on a half-pixel grid with zeros, NaN, +inf and
    -inf: differences of exactly 0.5 and 1.0, the vote's ``fuse`` below,
    tie with it."""
    rng = np.random.default_rng(seed)
    d = rng.choice([0.0, 4.0, 7.0, 12.0], size=(v, h, w), p=[0.1, 0.4, 0.3, 0.2]) + rng.integers(0, 3, (v, h, w)) * 0.5
    d = d.astype(np.float32)
    u = rng.random((v, h, w))
    d[u < 0.01] = np.nan
    d[(u >= 0.01) & (u < 0.015)] = np.inf
    d[(u >= 0.015) & (u < 0.02)] = -np.inf
    return torch.as_tensor(d, device=device)


def _fuse_bitwise(disp, aw, bl, fuse, view_range):
    """fuse_warp and fuse_vote on ``disp`` against their plain forms, each
    launching once (none for an empty range); returns the vote."""
    before = dict(crosscheck.LAUNCHES)
    proj = crosscheck.warp(disp, aw, bl, view_range)
    _same_bits(proj, fusion.project_to_reference_inv_reference(disp, aw, bl, view_range), "warp")
    whole = fusion.project_to_reference_inv_reference(disp, aw, bl)
    got = crosscheck.vote(whole, disp, aw, bl, fuse, view_range)
    _same_bits(got, fusion.remove_view_inconsistency_reference(whole, disp, aw, bl, fuse, view_range), "vote")
    n = 0 if got.numel() == 0 else 1
    assert {k: crosscheck.LAUNCHES[k] - before[k] for k in before} == {"fuse_warp": n, "fuse_vote": n}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("view_range", list(VIEW_RANGES))
def test_fuse_kernels_bitwise_on_the_refined_disparity(cuda, view_range):
    """The slice's refined disparity of a 9x270x480 scene at the shipping
    settings: the warp and the vote bitwise their plain forms."""
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    s = SystemSettings()
    rgb, _ = synthetic.fronto_parallel_scene(270, 480, 3, 3, disp=10.0, bl_ratio=s.bl_ratio, seed=4)
    disp = MVSPipeline.create(480, 270, s, device=cuda).run(rgb).disp_full
    got = _fuse_bitwise(disp, s.array_width, s.bl_ratio, RefinementSchedule.create(s).fuse_eff,
                        VIEW_RANGES[view_range])
    if view_range == "all":
        assert (got == 0).any() and (got != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [0.5, 1.0])
@pytest.mark.parametrize("view_range", list(VIEW_RANGES))
def test_fuse_kernels_bitwise_on_seeded_maps(cuda, view_range, fuse):
    """An odd 9x53x131 map holding NaN, +-inf and differences equal to
    ``fuse``: NaN in the same places, ties abstaining as in the plain form."""
    disp = _seeded_maps(cuda)
    got = _fuse_bitwise(disp, 3, 1.0359, fuse, VIEW_RANGES[view_range])
    if view_range == "all":
        assert bool(torch.isnan(got).any()) and (got == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("view_range", [None, (2, 2)], ids=["all", "2..3"])
def test_fuse_kernels_bitwise_on_a_2x2_grid(cuda, view_range):
    """A 2x2 camera grid at bl_ratio 0.97 (other deltas, other rounding)."""
    _fuse_bitwise(_seeded_maps(cuda, v=4, h=37, w=64, seed=5), 2, 0.97, 1.0, view_range)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [0.5, 1.0])
@pytest.mark.parametrize("view_range", ["all", "4..5", "first"])
def test_fuse_vote_bitwise_where_nan_mixes_with_finite_candidates(cuda, view_range, fuse):
    """A NaN in a fifth of the map: most pixels' candidates mix NaN with
    finite values and take the view-order walk, whose result is NaN only
    where the first valid candidate is; the others walk in descending
    order."""
    disp = _seeded_maps(cuda, h=29, w=70, seed=11)
    disp[torch.rand(disp.shape, generator=torch.Generator().manual_seed(3)).to(cuda) < 0.2] = float("nan")
    got = _fuse_bitwise(disp, 3, 1.0359, fuse, VIEW_RANGES[view_range])
    proj = fusion.project_to_reference_inv_reference(disp, 3, 1.0359)
    mixed = torch.isnan(proj).any(0) & ~torch.isnan(proj).all(0)
    assert bool(mixed.any()) and bool((~torch.isnan(proj).any(0)).any())
    assert bool(torch.isnan(got[:, mixed]).any()) and bool((~torch.isnan(got[:, mixed])).any())


@pytest.mark.cuda
@pytest.mark.parametrize("view_range", ["all", "3..5", "first"])
def test_fuse_vote_bitwise_on_many_equal_candidates(cuda, view_range):
    """Four values shared by every view, the largest rare: most pixels'
    candidates repeat their largest value in several views (each value
    scored once), and most outputs take a value below the largest."""
    rng = np.random.default_rng(13)
    d = rng.choice(np.float32([0.0, 6.0, 6.5, 9.0]), size=(9, 31, 77), p=[0.05, 0.6, 0.3, 0.05])
    disp = torch.as_tensor(d, device=cuda)
    got = _fuse_bitwise(disp, 3, 1.0359, 0.5, VIEW_RANGES[view_range])
    proj = fusion.project_to_reference_inv_reference(disp, 3, 1.0359)
    top = proj.amax(0)
    assert float(((proj == top).sum(0) >= 3).float().mean()) > 0.5
    assert float((got != top).float().mean()) > 0.5


# (views, cameras a row, view range): the vote's kernel for any view count
# (candidates read from memory), a ragged last camera row, two passes of
# 32 reference views and four warp view groups
VIEW_COUNTS = {"6v-3": (6, 3, None), "5v-3": (5, 3, (1, 4)), "36v-6": (36, 6, None), "36v-6-2..34": (36, 6, (2, 33))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VIEW_COUNTS))
def test_fuse_kernels_bitwise_on_other_view_counts(cuda, case):
    v, aw, view_range = VIEW_COUNTS[case]
    _fuse_bitwise(_seeded_maps(cuda, v=v, h=16, w=40, seed=v), aw, 1.0359, 0.5, view_range)


# (height, width, cameras a row) of two views 2^23 + 37 pixels wide or high:
# every coordinate takes the exact float path
HUGE_VIEWS = {"wide": (1, (1 << 23) + 37, 2), "high": ((1 << 23) + 37, 1, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("view_range", ["all", "first"])
@pytest.mark.parametrize("case", list(HUGE_VIEWS))
def test_fuse_kernels_bitwise_on_views_2_23_wide_or_high(cuda, case, view_range):
    """Views of 2^23 + 37 columns (or rows), 32-bit offsets: the warp and
    the vote on the exact float coordinates, NaN and +-inf included."""
    h, w, aw = HUGE_VIEWS[case]
    _fuse_bitwise(_seeded_maps(cuda, v=2, h=h, w=w, seed=h), aw, 1.0359, 0.5, VIEW_RANGES[view_range])


# (height, width) of two views, a camera row, with 2^31 elements or more:
# 64-bit offsets, with integer coordinates (32768 x 32832) and with the
# exact float ones (128 rows of 2^23 + 37)
WIDE_INDEX = {"integer": (32768, 32832), "exact": (128, (1 << 23) + 37)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WIDE_INDEX))
def test_fuse_kernels_bitwise_with_64_bit_offsets(cuda, case):
    """Maps of 2 x H x W >= 2^31 elements.  Two cameras in a row shift only
    along x, so each row's outputs depend on that row alone: the first and
    the last two rows of both views (the latter at offsets past 2^31) are
    held bitwise against the plain forms on those rows."""
    h, w = WIDE_INDEX[case]
    g = torch.Generator(device=cuda).manual_seed(h)
    disp = torch.randint(0, 17, (2, h, w), generator=g, dtype=torch.float32, device=cuda).mul_(0.5)
    assert disp.numel() >= 1 << 31
    before = dict(crosscheck.LAUNCHES)
    proj = crosscheck.warp(disp, 2, 1.0359)
    got = crosscheck.vote(proj, disp, 2, 1.0359, 0.5)
    assert {k: crosscheck.LAUNCHES[k] - before[k] for k in before} == {"fuse_warp": 1, "fuse_vote": 1}
    for rows in (slice(0, 2), slice(h - 2, h)):
        part = disp[:, rows].contiguous()
        want = fusion.project_to_reference_inv_reference(part, 2, 1.0359)
        _same_bits(proj[:, rows].contiguous(), want, f"warp rows {rows}")
        want = fusion.remove_view_inconsistency_reference(want, part, 2, 1.0359, 0.5)
        _same_bits(got[:, rows].contiguous(), want, f"vote rows {rows}")
    assert (got[:, -2:] == 0).any() and (got[:, -2:] != 0).any()
    del disp, proj, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_crosscheck_fusion_launches_the_kernels(cuda):
    """fuse_views with cross_check on the card: one warp and one vote."""
    disp_seed = _seeded_maps(cuda, v=4, h=24, w=32, seed=1)
    labels = torch.arange(24 * 32, dtype=torch.int32, device=cuda).reshape(1, 24, 32).expand(4, 24, 32) % 12
    centers = torch.rand((4, 3, 4, 2), device=cuda) * 20
    d = torch.nan_to_num(disp_seed[:, :3, :4], posinf=9.0, neginf=4.0, nan=5.0).contiguous()
    nrm = torch.zeros((4, 3, 4, 3), device=cuda)
    nrm[..., 2] = 1.0
    before = dict(crosscheck.LAUNCHES)
    got = fusion.fuse_views(labels.contiguous(), centers, d, nrm, array_width=2, bl_ratio=1.0, fuse=0.5,
                            cross_check=True)
    assert {k: crosscheck.LAUNCHES[k] - before[k] for k in before} == {"fuse_warp": 1, "fuse_vote": 1}
    plain = fusion.rasterize_planes_reference(labels, centers, d, nrm)
    want = fusion.remove_view_inconsistency_reference(
        fusion.project_to_reference_inv_reference(plain, 2, 1.0), plain, 2, 1.0, 0.5)
    _same_bits(got, want, "fuse_views")


def _snap_inputs(case, device):
    """(lab, seeds) of a scene at the case's size and cell: SLIC's seed
    centres, or centres moved onto and past the image's border, or random
    ones reaching 2 pixels past it on every side."""
    kind, (h, w, cell) = case
    s = SystemSettings(array_width=3, array_height=3, spixl_size=cell)
    rgb, _ = synthetic.fronto_parallel_scene(h, w, 3, 3, disp=5.0, bl_ratio=1.0, seed=3)
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device)).contiguous()
    seeds = slic.init_cluster_centers(lab, DerivedGeometry.create(w, h, s))
    c = seeds.center.clone()
    gen = torch.Generator().manual_seed(7)
    if kind == "border":
        xs = torch.tensor([0.0, w - 1.0, float(w), -1.0, 0.7, w - 0.2])
        ys = torch.tensor([0.0, h - 1.0, float(h), -1.0, 0.3, h - 0.5])
        c[..., 0] = xs[torch.randint(0, 6, c.shape[:3], generator=gen)].to(device)
        c[..., 1] = ys[torch.randint(0, 6, c.shape[:3], generator=gen)].to(device)
    elif kind == "random":
        c[..., 0] = (torch.rand(c.shape[:3], generator=gen) * (w + 4) - 2).to(device)
        c[..., 1] = (torch.rand(c.shape[:3], generator=gen) * (h + 4) - 2).to(device)
    return lab, seeds._replace(center=c.contiguous())


# (centres, (H, W, cell)): the seeds at 8-pixel cells, on a ragged image
# whose last seed column lies on x = W (past the image), at 4-pixel cells;
# centres on the border, random centres
SNAP_CASES = {
    "seeds-54x96": ("init", (54, 96, 8)),
    "seeds-60x60": ("init", (60, 60, 8)),
    "seeds-61x45": ("init", (61, 45, 8)),
    "seeds-37x53-S4": ("init", (37, 53, 4)),
    "border-54x96": ("border", (54, 96, 8)),
    "border-61x45": ("border", (61, 45, 8)),
    "random-54x96": ("random", (54, 96, 8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SNAP_CASES))
def test_edge_snap_bitwise(cuda, case):
    lab, seeds = _snap_inputs(SNAP_CASES[case], cuda)
    before = slic.LAUNCHES["edge_snap"]
    got = slic.edge_snap(lab, seeds)
    want = slic.edge_snap_reference(lab, seeds)
    assert slic.LAUNCHES["edge_snap"] == before + 1
    _same_bits(got.center, want.center, "center")
    _same_bits(got.color, want.color, "color")
    assert got.count is seeds.count and got.disp is seeds.disp
    assert (want.center != seeds.center).any()
    if case == "seeds-60x60":  # the last seed column lies on x = 60, outside the view
        assert float(seeds.center[..., 0].max()) == 60.0


@pytest.mark.cuda
def test_run_sharded_crosscheck_bitwise_run(nccl_world1):
    """The view-sharded pipeline with the cross-check (one rank: the warp
    and the vote over its view range, the warped maps all-gathered between
    them) bitwise MVSPipeline.run."""
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.parallel.mesh import make_mesh
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import run_sharded

    s = SystemSettings(**JIT_SETTINGS)
    pipe = MVSPipeline.create(96, 72, s, device=nccl_world1, cross_check=True)
    rgb = _jit_scene(7.0, 1)
    want = pipe.run(rgb).disp_full
    before = dict(crosscheck.LAUNCHES)
    got = run_sharded(pipe, torch.as_tensor(rgb, device=nccl_world1), make_mesh())
    torch.cuda.synchronize()
    assert {k: crosscheck.LAUNCHES[k] - before[k] for k in before} == {"fuse_warp": 1, "fuse_vote": 1}
    _same_bits(got, want, "run_sharded")


@pytest.mark.cuda
def test_jitted_crosscheck_and_edge_snap_bitwise_run(cuda):
    """cross_check and edge_enable through the graph of ``jitted()``: each
    replay launches the warp, the vote and the snap once and gives run()'s
    bits."""
    from cl_multiview_stereo_tpu_torch.models import mvs_pipeline

    s = SystemSettings(**JIT_SETTINGS, edge_enable=True)
    pipe = mvs_pipeline.MVSPipeline.create(96, 72, s, device=cuda, cross_check=True)
    fwd = pipe.jitted()
    a, b = _jit_scene(7.0, 1), _jit_scene(5.0, 2)
    fwd(a)
    replayed = dict(mvs_pipeline.REPLAYED_LAUNCHES)
    got_a, got_b = fwd(a), fwd(b)
    want_a, want_b = pipe.run(a), pipe.run(b)
    torch.cuda.synchronize()
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for name, x, y in _leaf_pairs(got, want):
            assert torch.equal(x, y), name
    assert {k: mvs_pipeline.REPLAYED_LAUNCHES.get(k, 0) - replayed.get(k, 0)
            for k in ("fuse_warp", "fuse_vote", "edge_snap")} == {"fuse_warp": 2, "fuse_vote": 2, "edge_snap": 2}


@pytest.mark.cuda
def test_crosscheck_and_snap_wrappers_reject_bad_input(cuda):
    disp = _seeded_maps(cuda, v=4, h=8, w=8)
    with pytest.raises(ValueError):
        crosscheck.warp(disp[0], 2, 1.0)
    with pytest.raises(TypeError):
        crosscheck.warp(disp.double(), 2, 1.0)
    with pytest.raises(ValueError):
        crosscheck.warp(disp, 2, 1.0, (3, 2))
    with pytest.raises(ValueError):
        crosscheck.vote(disp, disp[:, :4], 2, 1.0, 0.5)
    with pytest.raises(ValueError):
        crosscheck.vote(disp, disp.cpu(), 2, 1.0, 0.5)
    with pytest.raises(RuntimeError, match="CUDA error"):
        crosscheck.warp(disp, 0, 1.0)
    lab, seeds = _snap_inputs(SNAP_CASES["seeds-54x96"], cuda)
    with pytest.raises(ValueError):
        slic.edge_snap(lab[0], seeds)
    with pytest.raises(TypeError):
        slic.edge_snap(lab, seeds._replace(center=seeds.center.double()))
    with pytest.raises(ValueError):
        slic.edge_snap(lab, seeds._replace(color=seeds.color[:, :1]))
    with pytest.raises(ValueError):
        slic.edge_snap(lab[..., ::2, :], seeds)
