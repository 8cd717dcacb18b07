"""The port's ``parallel/`` (mesh, distributed, spatial) against the port's
unsharded functions and the JAX package's sharded twins, on
tests/test_spatial_sharding.py's scene (64x64, 2x2 views, ladder 3..10).

The port's sharded functions run in gloo groups of 2 and 4 processes
(``torch_dist_worker.spawn``, once per world size for the module), fed the
JAX stages' own outputs through an npz.  Each is held bitwise to the
port's unsharded function, and to JAX's sharded twin (4 virtual CPU
devices, bitwise its unsharded form by its own tests) within the bound the
unsharded port-vs-JAX test of the same function states.  The local work of
every rank also runs here, rank after rank in this process, and a world
size 1 group (a ``HashStore``, destroyed after each test) covers the
mesh helpers.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.models import plane_sweep as jps
from cl_multiview_stereo_tpu.ops import cost_volume as jcv
from cl_multiview_stereo_tpu.ops import refine as jref
from cl_multiview_stereo_tpu.ops import slic as jslic
from cl_multiview_stereo_tpu.ops import superpixel as jsp
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from cl_multiview_stereo_tpu.parallel import spatial as jspatial
from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.models import plane_sweep
from cl_multiview_stereo_tpu_torch.ops import cost_volume, refine
from cl_multiview_stereo_tpu_torch.ops.sweep import RowWindow
from cl_multiview_stereo_tpu_torch.parallel import distributed, mesh, spatial
from torch_dist_worker import spawn
from torch_parity import jax_settings, n, scenes, small_settings, t

WORLDS = (2, 4)
S = small_settings(min_disp=3, max_disp=10, kernel_size=16, kernel_step=2, no_prop=2)
HALOS = {2: (2, 20), 4: (2, 10)}  # one within a block's rows, one beyond
SWEEP_BL = (1.0, 1.0359)
HALO_MODES = {"none": None, "bound": 2 * S.max_disp, "auto": "auto"}
# tests/test_torch_refine.py's bound for the port's refinement against
# JAX's: within 1e-3 on >= 0.98 of superpixels
REFINE_CLOSE = 0.98


def _jax_mesh(n_dev: int, name: str) -> Mesh:
    return Mesh(np.asarray(jax.devices("cpu")[:n_dev]), (name,))


@pytest.fixture(scope="module")
def scene():
    """JAX's stages up to the refinement context: the common inputs."""
    js = jax_settings(S)
    _, views = scenes("two_plane_scene", 64, 64, array_width=2, array_height=2, disp_bg=4.0,
                      disp_fg=9.0, bl_ratio=1.0, seed=5)
    geom = jcfg.DerivedGeometry.create(64, 64, js)
    lab = np.asarray(jax_rgb_to_lab(views))
    labels, spmap = jslic.segment(lab, geom, jcfg.SlicParams.create(js))
    extent = jsp.superpixel_extent(labels, spmap.center, geom)
    subset, counts = build_view_subsets(S)
    ladder = build_disp_levels(S)
    disp0 = jcv.initial_depth_estimation(lab, spmap.center, extent, ladder, subset, counts,
                                         S.array_width, S.bl_ratio, method="dense")
    sched = RefinementSchedule.create(S)
    fl = jref.compute_flatness(spmap.color, sched.gamma_eff)
    ins = dict(
        settings=json.dumps(S.to_dict()), lab=lab, center=np.asarray(spmap.center),
        color=np.asarray(spmap.color), labels=np.asarray(labels), extent=np.asarray(extent),
        step=np.asarray(jsp.extent_step(extent)), disp_init=np.asarray(disp0),
        flatness=np.asarray(fl), ladder=np.asarray(ladder, np.float32),
        ladder5=np.asarray(ladder[:5], np.float32), subset_num=np.asarray(counts),
        view_subset=np.asarray(subset), pairs=np.asarray(jps.build_pairs(subset, counts, S.array_width)),
        sweep_bl=np.asarray(SWEEP_BL), refine_knobs=np.asarray([S.kernel_size, S.kernel_step, S.no_prop]),
        halo_x=np.arange(32 * 3, dtype=np.float32).reshape(32, 3),
    )
    jctx = jref.make_context(spmap.center, spmap.color, disp0, labels, extent, fl, subset, S.array_width)
    return dict(ins=ins, sched=sched, js=js, jctx=jctx)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def runs(request, scene, tmp_path_factory):
    """Every rank's outputs of one gloo group of ``world`` processes."""
    world = request.param
    ins = dict(scene["ins"], halos=np.asarray(HALOS[world]))
    return world, spawn("spatial", world, ins, tmp_path_factory.mktemp(f"spatial{world}"))


@pytest.fixture(scope="module")
def port(scene):
    """The port's unsharded functions on the same inputs (CPU)."""
    ins = scene["ins"]
    lab, center, step = t(ins["lab"]), t(ins["center"]), t(ins["step"])
    pairs = tuple(tuple(int(x) for x in p) for p in ins["pairs"])
    ctx = refine.make_context(t(ins["center"]), t(ins["color"]), t(ins["disp_init"]),
                              t(ins["labels"], torch.int32), t(ins["extent"]), t(ins["flatness"]))
    rpairs = refine.pairs_from_subsets(ins["view_subset"], S.array_width)
    out = dict(ctx=ctx, pairs=pairs, rpairs=rpairs,
               refine=refine.refine(ctx, scene["sched"], pairs=rpairs))
    for name in ("ladder", "ladder5"):
        out[f"depth_{name}"] = n(cost_volume.initial_depth_estimation(
            lab, center, t(ins["extent"]), ins[name], ins["view_subset"], torch.as_tensor(ins["subset_num"]),
            S.array_width, S.bl_ratio, method="dense"))
    for bl in SWEEP_BL:
        out[f"sweep_{bl}"] = plane_sweep.plane_sweep_depth(lab, ins["ladder"], pairs, bl)
    return out


@pytest.fixture(scope="module")
def jax_sharded(scene):
    """JAX's sharded twins on 4 virtual devices."""
    ins, js = scene["ins"], scene["js"]
    pairs = tuple(tuple(int(x) for x in p) for p in ins["pairs"])
    out = {}
    for name in ("ladder", "ladder5"):
        out[f"depth_{name}"] = np.asarray(jspatial.disp_sharded_depth_init(
            ins["lab"], ins["center"], ins["step"], ins[name], ins["subset_num"], _jax_mesh(4, "disp"),
            S.array_width, S.bl_ratio))
    for bl in SWEEP_BL:
        d, c = jspatial.spatial_plane_sweep(ins["lab"], ins["ladder"], pairs, bl, _jax_mesh(4, "tile"))
        out[f"sweep_{bl}"] = (np.asarray(d), np.asarray(c))
    for mode, hd in HALO_MODES.items():
        out[f"refine_{mode}"] = jspatial.spatial_refine(
            scene["jctx"], jcfg.RefinementSchedule.create(js), _jax_mesh(4, "tile"), halo_disp=hd)
    return out


def _halo_want(x: np.ndarray, world: int, t_: int, halo: int) -> np.ndarray:
    rows = x.shape[0] // world
    lo = t_ * rows - halo
    want = np.zeros((rows + 2 * halo,) + x.shape[1:], x.dtype)
    src_lo, src_hi = max(lo, 0), min(lo + rows + 2 * halo, x.shape[0])
    want[src_lo - lo:src_hi - lo] = x[src_lo:src_hi]
    return want


def test_halo_exchange_rows_round_trip(runs, scene):
    """Every rank's block extended by its global neighbourhood, zero past
    the edges, with the halo within a block and beyond it; JAX's
    ``halo_exchange_rows`` under ``shard_map`` on the same blocks."""
    world, outs = runs
    x = scene["ins"]["halo_x"]
    for halo in HALOS[world]:
        fn = shard_map(lambda b, h=halo: jspatial.halo_exchange_rows(b, h, "tile"),
                       mesh=_jax_mesh(world, "tile"), in_specs=(PartitionSpec("tile", None),),
                       out_specs=PartitionSpec("tile", None))
        jout = np.asarray(fn(x)).reshape(world, -1, 3)
        for r in range(world):
            got = outs[r][f"halo_{halo}"]
            np.testing.assert_array_equal(got, _halo_want(x, world, r, halo), err_msg=f"halo {halo} rank {r}")
            np.testing.assert_array_equal(got, jout[r], err_msg=f"JAX halo {halo} rank {r}")


@pytest.mark.parametrize("ladder", ["ladder", "ladder5"], ids=["even", "uneven"])
def test_disp_sharded_depth_init(runs, port, jax_sharded, ladder):
    """Bitwise the port's unsharded dense depth init on every rank, and
    JAX's sharded result (tests/test_torch_cost_volume.py holds the two
    depth inits equal); the 5-level ladder pads unevenly."""
    world, outs = runs
    for r in range(world):
        got = outs[r][f"depth_{ladder}"]
        np.testing.assert_array_equal(got, port[f"depth_{ladder}"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, jax_sharded[f"depth_{ladder}"], err_msg=f"JAX rank {r}")


@pytest.mark.parametrize("bl", SWEEP_BL)
def test_spatial_plane_sweep(runs, port, jax_sharded, bl):
    """Bitwise the port's unsharded sweep on every rank, and bitwise JAX's
    sharded sweep (tests/test_torch_plane_sweep.py holds the sweeps
    bitwise)."""
    world, outs = runs
    want_d, want_c = (n(x) for x in port[f"sweep_{bl}"])
    jd, jc = jax_sharded[f"sweep_{bl}"]
    for r in range(world):
        np.testing.assert_array_equal(outs[r][f"sweep_{bl}_disp"], want_d)
        np.testing.assert_array_equal(outs[r][f"sweep_{bl}_cost"], want_c)
        np.testing.assert_array_equal(outs[r][f"sweep_{bl}_disp"], jd)
        np.testing.assert_array_equal(outs[r][f"sweep_{bl}_cost"], jc)


@pytest.mark.parametrize("mode", list(HALO_MODES))
def test_spatial_refine(runs, port, jax_sharded, mode):
    """Bitwise the port's ``refine.refine`` on every rank for each halo
    mode; against JAX's sharded refinement within REFINE_CLOSE."""
    world, outs = runs
    want, jwant = port["refine"], jax_sharded[f"refine_{mode}"]
    for r in range(world):
        for f in refine.RefineState._fields:
            got = outs[r][f"refine_{mode}_{f}"]
            np.testing.assert_array_equal(got, n(getattr(want, f)), err_msg=f"rank {r} {f}")
            if f != "n":
                close = (np.abs(got - np.asarray(getattr(jwant, f))) <= 1e-3).mean()
                assert close >= REFINE_CLOSE, (r, f, close)


@pytest.mark.parametrize("n_ranks", [2, 3, 4])
def test_slab_local_work_every_rank(scene, port, n_ranks):
    """Each rank's slab winners, run here rank after rank and combined,
    equal the unsharded depth init: 8 levels over 2, 3 and 4 slabs."""
    ins = scene["ins"]
    ladder = spatial.padded_ladder(ins["ladder"], n_ranks)
    wins = [spatial.slab_winners(t(ins["lab"]), t(ins["center"]), t(ins["step"]), ladder, r, n_ranks,
                                 S.array_width, S.bl_ratio) for r in range(n_ranks)]
    got = spatial.combine_slab_winners(torch.stack([c for c, _ in wins]), torch.stack([d for _, d in wins]))
    np.testing.assert_array_equal(n(got), port["depth_ladder"])


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_sweep_tile_local_work_every_rank(scene, port, n_ranks):
    """Each tile's row-window sweep on its locally cut halo band equals the
    unsharded sweep's rows (radius 2 and 0, both baselines)."""
    ins = scene["ins"]
    lab = t(ins["lab"])
    pairs = port["pairs"]
    ladder = [float(d) for d in ins["ladder"]]
    rows = 64 // n_ranks
    for bl in SWEEP_BL:
        for radius in (2, 0):
            want = plane_sweep.plane_sweep_depth(lab, ladder, pairs, bl, radius)
            halo = spatial.sweep_halo(ladder, pairs, bl, radius)
            for r in range(n_ranks):
                ext = spatial.halo_window(lab.transpose(0, 1), r, rows, halo).transpose(0, 1)
                band, band0 = spatial.tile_band(ext, r, rows, halo, 64)
                got = spatial.sweep_tile(band, band0, r, rows, 64, ladder, pairs, bl, radius)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(n(g), n(w[:, r * rows:(r + 1) * rows]))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("mode", ["none", "auto"])
def test_refine_local_work_every_rank(scene, port, n_ranks, mode):
    """The blocks' init and sweeps, run here rank after rank with the
    tables and states the collectives would carry, equal ``refine.refine``."""
    ctx, sched, pairs = port["ctx"], scene["sched"], port["rpairs"]
    h = ctx.labels.shape[1]
    bhp = h // n_ranks
    halo = spatial.refine_halo(ctx, sched, pairs, HALO_MODES[mode])
    blks = [spatial.block_context(ctx, r, n_ranks) for r in range(n_ranks)]

    def windows(d_full, n_full):
        full = torch.cat([spatial.block_table(ctx, blks[r], r, d_full, n_full) for r in range(n_ranks)], 1)
        if halo >= h:
            return [(full.reshape(-1, 4), (0, h))] * n_ranks
        return [(spatial.halo_window(full.transpose(0, 1), r, bhp, halo).transpose(0, 1).reshape(-1, 4),
                 (r * bhp - halo, bhp + 2 * halo)) for r in range(n_ranks)]

    ws = windows(ctx.disp0, refine._fronto_normals(ctx.disp0))
    states = [spatial.block_init(ctx, blks[r], sched, pairs, r, n_ranks, *ws[r]) for r in range(n_ranks)]
    for it in range(sched.no_prop):
        d_full = torch.cat([s_.d for s_ in states], 1)
        n_full = torch.cat([s_.n for s_ in states], 1)
        ws = windows(d_full, n_full)
        states = [spatial.block_sweep(ctx, blks[r], sched, pairs, r, n_ranks, it, states[r], d_full, n_full, *ws[r])
                  for r in range(n_ranks)]
    for f, parts in zip(refine.RefineState._fields, zip(*states)):
        np.testing.assert_array_equal(n(torch.cat(parts, 1)), n(getattr(port["refine"], f)), err_msg=f)


def test_sweep_row_window_twin_matches_jax(scene):
    """The plain twin's row window (the kernel's new mode) against JAX's
    whole sweep's rows, at the top, in the middle and at the bottom, with
    the band cut to what the rows read."""
    ins = scene["ins"]
    pairs = tuple(tuple(int(x) for x in p) for p in ins["pairs"])
    ladder = [float(d) for d in ins["ladder"]]
    jd, jc = (np.asarray(a) for a in jps.plane_sweep_depth(ins["lab"], tuple(ladder), pairs, 1.0359, 2))
    up, down = spatial.sweep.row_reach(ladder, pairs, 1.0359, 2)
    for out0, rows in ((0, 8), (27, 5), (56, 8)):
        b0, b1 = max(0, out0 - up), min(64, out0 + rows + down)
        got = plane_sweep.plane_sweep_reference(t(ins["lab"][:, b0:b1]), ladder, pairs, 1.0359, 2,
                                                rows=RowWindow(64, b0, out0, rows))
        np.testing.assert_array_equal(n(got[0]), jd[:, out0:out0 + rows])
        np.testing.assert_array_equal(n(got[1]), jc[:, out0:out0 + rows])


def test_sweep_row_window_refuses_a_short_band(scene):
    ins = scene["ins"]
    pairs = tuple(tuple(int(x) for x in p) for p in ins["pairs"])
    with pytest.raises(ValueError, match="band holds"):
        plane_sweep.plane_sweep_reference(t(ins["lab"][:, 20:30]), ins["ladder"], pairs, 1.0, 2,
                                          rows=RowWindow(64, 20, 22, 4))


def test_cost_volume_view_range_twin_matches_jax(scene):
    """The plain twin's view range (the kernel's new mode) against JAX's
    dense volume's views, at tests/test_torch_cost_volume.py's bound."""
    ins = scene["ins"]
    want = np.asarray(jcv.superpixel_cost_volume_dense(
        ins["lab"], ins["center"], ins["step"], ins["ladder"], S.array_width, S.bl_ratio, 1, 1,
        float(np.abs(ins["ladder"]).max())))
    full = cost_volume.cost_volume_reference(t(ins["lab"]), t(ins["center"]), t(ins["step"]), ins["ladder"],
                                             S.array_width, S.bl_ratio)
    for v0, nv in ((0, 1), (1, 2), (3, 1), (0, 4)):
        got = cost_volume.superpixel_cost_volume(t(ins["lab"]), t(ins["center"]), t(ins["step"]), ins["ladder"],
                                                 S.array_width, S.bl_ratio, view_range=(v0, nv))
        np.testing.assert_array_equal(n(got), n(full[v0:v0 + nv]))
        np.testing.assert_allclose(n(got), want[v0:v0 + nv], rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="view range"):
        cost_volume.superpixel_cost_volume(t(ins["lab"]), t(ins["center"]), t(ins["step"]), ins["ladder"],
                                           S.array_width, S.bl_ratio, view_range=(3, 2))


@pytest.fixture
def world1():
    """A world-size-1 gloo group on an in-memory store, destroyed after the
    test so that no group leaks into the next test on this worker."""
    distributed.initialize_distributed(device="cpu")
    yield
    dist.destroy_process_group()


def test_world1_meshes_and_placements(world1, monkeypatch):
    m = mesh.make_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("view", "disp") and tuple(m.mesh.shape) == (1, 1)
    assert [type(p).__name__ for p in mesh.view_sharding(m, 4)] == ["Shard", "Replicate"]
    assert [type(p).__name__ for p in mesh.replicated(m)] == ["Replicate", "Replicate"]
    with pytest.raises(ValueError, match="mesh != 1 devices"):
        mesh.make_mesh(2, 1, device_type="cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    hv = distributed.make_host_view_mesh(device_type="cpu")
    assert hv.mesh_dim_names == ("host", "view") and tuple(hv.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="views_per_host 2 != local device count 1"):
        distributed.make_host_view_mesh(2, device_type="cpu")


def test_world1_axis_of_flattened(world1, monkeypatch):
    """``axis_of`` over several axes: the flattened group, index and size;
    names out of the mesh's order or unknown are refused."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    hv = distributed.make_host_view_mesh(device_type="cpu")
    group, t_idx, size = mesh.axis_of(hv, ("host", "view"))
    assert (t_idx, size) == (0, 1) and dist.get_world_size(group) == 1
    assert mesh.axis_of(hv, ("view",))[1:] == mesh.axis_of(hv, "view")[1:] == (0, 1)
    with pytest.raises(ValueError, match="in the mesh's order"):
        mesh.axis_of(hv, ("view", "host"))
    with pytest.raises(ValueError, match="no axis 'disp'"):
        mesh.axis_of(hv, ("host", "disp"))


def test_world1_collectives_are_the_unsharded_functions(world1, scene, port):
    """At world size 1 the collective layer runs on the real backend and
    gives the unsharded results."""
    ins = scene["ins"]
    tile = torch.distributed.device_mesh.init_device_mesh("cpu", (1,), mesh_dim_names=("tile",))
    x = t(ins["halo_x"])
    np.testing.assert_array_equal(n(spatial.halo_exchange_rows(x, 3, tile, "tile")), _halo_want(n(x), 1, 0, 3))
    np.testing.assert_array_equal(n(spatial.halo_exchange_rows(x, 40, tile, "tile")), _halo_want(n(x), 1, 0, 40))
    got = spatial.spatial_refine(port["ctx"], scene["sched"], tile, pairs=port["rpairs"], halo_disp="auto")
    for f in refine.RefineState._fields:
        np.testing.assert_array_equal(n(getattr(got, f)), n(getattr(port["refine"], f)), err_msg=f)


def test_initialize_distributed_needs_a_whole_address(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="address, a world size and a rank"):
        distributed.initialize_distributed(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="no process-group backend"):
        distributed.initialize_distributed(device="tpu")
    assert not dist.is_initialized()
