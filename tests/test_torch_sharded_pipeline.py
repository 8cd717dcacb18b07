"""The port's view-sharded pipeline (``parallel/sharded_pipeline``) against
the port's unsharded ``MVSPipeline.run`` and the JAX package's
``run_sharded``, on tests/test_sharded_pipeline.py's scene (32x24, 4x2
views).

``run_sharded`` runs in gloo groups of 2 and 4 processes
(``torch_dist_worker.spawn``, once per world size for the module), each
rank given the whole batch: with both pair layouts, with ``cross_check``,
with the gather depth init, and over the view axis of the ``(host, view)``
mesh that ``make_host_view_mesh`` builds with two ranks a host, ``(2, 2)``
at world size 4, and over both of its axes flattened (the port's form of
tests/test_multihost.py).  Every
rank's ``disp_full`` is held bitwise to the unsharded run's, and to JAX's
sharded run (4 virtual CPU devices) at tests/test_torch_pipeline.py's
bound.  The view-range pieces that each rank runs are held against the
whole batch's here, rank after rank.
"""

import json

import jax
import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cl_multiview_stereo_tpu.parallel.sharded_pipeline import run_sharded as jax_run_sharded
from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_disp_levels, build_view_subsets
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.ops import cost_volume, fusion
from cl_multiview_stereo_tpu_torch.ops.superpixel import extent_step
from cl_multiview_stereo_tpu_torch.parallel import sharded_pipeline
from torch_dist_worker import spawn
from torch_parity import CPU, jax_settings, n, scenes, t

WORLDS = (2, 4)
S = SystemSettings(array_width=4, array_height=2, spixl_size=8, min_disp=2, max_disp=6, inc=1,
                   bl_ratio=1.0, kernel_size=8, kernel_step=2, no_prop=2)
CONFIGS = {"packed": {}, "view": dict(pair_layout="view"), "cross_check": dict(cross_check=True)}
# tests/test_torch_pipeline.py's bound for the port's disp_full against
# JAX's: within 1e-3 on >= 0.98 of pixels
FULL_CLOSE = 0.98


@pytest.fixture(scope="module")
def rgb():
    views, _ = scenes("two_plane_scene", 24, 32, array_width=4, array_height=2, disp_bg=3.0,
                      disp_fg=5.0, bl_ratio=1.0, seed=11)
    return views


@pytest.fixture(scope="module")
def unsharded(rgb):
    """The port's unsharded runs, per configuration (and the gather depth
    init, which the workers run as well)."""
    out = {name: MVSPipeline.create(32, 24, S, device=CPU, **kw).run(rgb) for name, kw in CONFIGS.items()}
    out["gather"] = MVSPipeline.create(32, 24, S, device=CPU, depth_method="gather").run(rgb)
    return out


@pytest.fixture(scope="module")
def jax_sharded(rgb):
    """JAX's ``run_sharded`` on 4 virtual devices: packed (its view layout
    equals packed bitwise, tests/test_sharded_pipeline.py) and with the
    cross-check vote."""
    js = jax_settings(S)
    mesh = jax_make_mesh(n_view=4, n_disp=1, devices=jax.devices()[:4])
    return {name: np.asarray(jax_run_sharded(JaxPipeline.create(32, 24, js, **kw), np.asarray(rgb), mesh))
            for name, kw in (("packed", {}), ("cross_check", dict(cross_check=True)))}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def runs(request, rgb, tmp_path_factory):
    world = request.param
    ins = dict(settings=json.dumps(S.to_dict()), rgb=rgb)
    return world, spawn("pipeline", world, ins, tmp_path_factory.mktemp(f"pipeline{world}"))


@pytest.mark.parametrize("config", list(CONFIGS) + ["gather"])
def test_run_sharded_equals_unsharded(runs, unsharded, config):
    world, outs = runs
    want = n(unsharded[config].disp_full)
    for r in range(world):
        np.testing.assert_array_equal(outs[r][config], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_run_sharded_near_jax_sharded(runs, jax_sharded, config):
    world, outs = runs
    jwant = jax_sharded["cross_check" if config == "cross_check" else "packed"]
    for r in range(world):
        close = (np.abs(outs[r][config] - jwant) <= 1e-3).mean()
        assert close >= FULL_CLOSE, (r, close)


def test_host_view_mesh(runs, unsharded):
    """With LOCAL_WORLD_SIZE=2: a (world / 2, 2) mesh, (2, 2) at world
    size 4, whose view axis holds the ranks of one host, and the pipeline
    over that axis."""
    world, outs = runs
    want = n(unsharded["packed"].disp_full)
    for r in range(world):
        np.testing.assert_array_equal(outs[r]["host_view_shape"], [world // 2, 2])
        np.testing.assert_array_equal(outs[r]["host_view_ranks"], np.arange(world).reshape(-1, 2))
        np.testing.assert_array_equal(outs[r]["host_view"], want, err_msg=f"rank {r}")


def test_host_view_flattened(runs, unsharded, jax_sharded):
    """The views sharded over both axes of that mesh, flattened host major
    (tests/multihost_worker.py's ``P(("host", "view"))``): rank r is index
    r of the world, every rank's ``disp_full`` is bitwise the unsharded
    run's and within the JAX worker's bound (rtol = atol = 1e-5) of JAX's
    sharded run."""
    world, outs = runs
    want = n(unsharded["packed"].disp_full)
    for r in range(world):
        np.testing.assert_array_equal(outs[r]["host_view_flat_index"], [r, world])
        np.testing.assert_array_equal(outs[r]["host_view_flat"], want, err_msg=f"rank {r}")
        np.testing.assert_allclose(outs[r]["host_view_flat"], jax_sharded["packed"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_view_range_cost_volume_every_rank(unsharded, n_ranks):
    """Each rank's view range of the cost volume and of the depth init,
    rank after rank, equals the whole batch's."""
    art = unsharded["packed"]
    levels = build_disp_levels(S)
    subset, counts = build_view_subsets(S)
    step = extent_step(art.extent).contiguous()
    args = (art.lab, art.spmap.center, step, levels, S.array_width, S.bl_ratio)
    full = cost_volume.superpixel_cost_volume(*args)
    counts_t = torch.as_tensor(counts)
    nv = S.view_num // n_ranks
    parts, inits = [], []
    for r in range(n_ranks):
        parts.append(cost_volume.superpixel_cost_volume(*args, view_range=(r * nv, nv)))
        inits.append(cost_volume.initial_depth_estimation(
            art.lab, art.spmap.center, art.extent, levels, subset, counts_t, S.array_width, S.bl_ratio,
            method="gather", view_range=(r * nv, nv)))
    np.testing.assert_array_equal(n(torch.cat(parts)), n(full))
    want = cost_volume.initial_depth_estimation(art.lab, art.spmap.center, art.extent, levels, subset, counts_t,
                                                S.array_width, S.bl_ratio, method="gather")
    np.testing.assert_array_equal(n(torch.cat(inits)), n(want))


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_view_range_vote_every_rank(unsharded, n_ranks):
    """The cross-check warp and vote for each rank's reference views,
    rank after rank, equal the whole batch's."""
    disp = n(unsharded["packed"].disp_full)
    disp_t = t(disp)
    proj = fusion.project_to_reference_inv(disp_t, S.array_width, S.bl_ratio)
    vote = fusion.remove_view_inconsistency(proj, disp_t, S.array_width, S.bl_ratio, 0.5)
    nv = S.view_num // n_ranks
    proj_r = [fusion.project_to_reference_inv(disp_t, S.array_width, S.bl_ratio, (r * nv, nv))
              for r in range(n_ranks)]
    np.testing.assert_array_equal(n(torch.cat(proj_r)), n(proj))
    vote_r = [fusion.remove_view_inconsistency(proj, disp_t, S.array_width, S.bl_ratio, 0.5, (r * nv, nv))
              for r in range(n_ranks)]
    np.testing.assert_array_equal(n(torch.cat(vote_r)), n(vote))


def test_view_blocks_and_own_pairs():
    assert sharded_pipeline.view_block(9, 3, 2) == (6, 3)
    with pytest.raises(ValueError, match="do not split"):
        sharded_pipeline.view_block(8, 3, 0)
    pairs = ((0, 1, 1.0, 0.0), (1, 0, -1.0, 0.0), (2, 3, 1.0, 0.0), (3, 2, -1.0, 0.0), (3, 1, 0.0, -1.0))
    assert sharded_pipeline.own_pairs(pairs, 2, 2) == ((0, 3, 1.0, 0.0), (1, 2, -1.0, 0.0), (1, 1, 0.0, -1.0))
    assert sharded_pipeline.own_pairs(pairs, 0, 1) == ((0, 1, 1.0, 0.0),)
