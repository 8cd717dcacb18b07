"""The port's CUDA kernels against their plain twins, and the cross-check
fusion against its CPU run, on a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
CUDA device every test here skips.
"""

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
from cl_multiview_stereo_tpu_torch.ops import consistency, cost_volume, fusion, refine, slic, superpixel, sweep
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
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
    to_cpu = lambda tup: type(tup)(*(x.cpu() for x in tup))  # noqa: E731
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
# 1080p scene), ragged cells at the map's edge, and 5-pixel cells
SLIC_SHAPES = {
    "full-9x1080x1920": (1080, 1920, 8),
    "ragged-9x543x967": (543, 967, 8),
    "S5-9x270x481": (270, 481, 5),
}
# the update kernel's colour against the plain form's (the centre and the
# count add integers below 2**24, exact in any order)
SLIC_COLOR_RTOL, SLIC_COLOR_ATOL = 1e-5, 1e-4


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
    assert torch.equal(got.center, want.center), f"{int((got.center != want.center).sum())} centres differ"
    assert torch.equal(got.count, want.count), f"{int((got.count != want.count).sum())} counts differ"
    torch.testing.assert_close(got.color, want.color, rtol=SLIC_COLOR_RTOL, atol=SLIC_COLOR_ATOL)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SLIC_SHAPES))
@pytest.mark.parametrize("labels_kind", ["converged", "noisy"])
def test_slic_vote_bitwise(slic_scenes, shape, labels_kind):
    _, geom, _, labels, _ = slic_scenes(shape)
    if labels_kind == "noisy":  # flips enough neighbours to trigger the vote often
        gen = torch.Generator(device="cpu").manual_seed(2)
        flip = (torch.rand(labels.shape, generator=gen) < 0.4).to(labels.device)
        other = torch.randint(0, geom.map_h * geom.map_w, labels.shape, generator=gen, dtype=torch.int32)
        labels = torch.where(flip, other.to(labels.device), labels)
    before = slic.LAUNCHES["slic_vote"]
    got = slic.suppress_local_labels(labels)
    torch.cuda.synchronize()
    assert slic.LAUNCHES["slic_vote"] == before + 1
    want = slic.suppress_local_labels_reference(labels)
    assert torch.equal(got, want), f"{int((got != want).sum())} labels differ"
    if labels_kind == "noisy":
        assert bool((got != labels).any())


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
