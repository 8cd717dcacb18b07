"""The port's SfM front-end chain (``models/sfm_pipeline``) and the MVS
pipeline's generalized projection path against the JAX package on the CPU,
with tests/test_sfm_pipeline.py's scenes and bounds.

Each ``run_sfm`` scenario runs once per module in each package.  On these
scenes the port finds JAX's keypoints and matches (the gray image is
bitwise JAX's, see tests/test_torch_features.py), gates the same
observations, and lands within the tolerances stated at each test.
"""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models import sfm_pipeline as jax_pipeline
from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu.ops.refine import pairs_from_subsets as jax_pairs_from_subsets
from cl_multiview_stereo_tpu_torch.config import SystemSettings, build_view_subsets
from cl_multiview_stereo_tpu_torch.models import sfm
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import (
    _unique_adjacent_pairs,
    pairs_from_poses,
    run_sfm,
)
from cl_multiview_stereo_tpu_torch.ops.refine import pairs_from_subsets
from torch_parity import CPU, jax_settings, n, scenes, small_settings

S = small_settings(no_prop=1)  # tests/test_sfm_pipeline.py's _scene_settings()


def _noisy_seed():
    rng = np.random.default_rng(3)
    aa0, t0 = sfm.grid_rig_poses(S.view_num, S.array_width, 1.0, S.bl_ratio)
    mask = np.asarray([0.0] + [1.0] * (t0.shape[0] - 1), np.float32)[:, None]
    noise = rng.normal(0, 0.08, t0.shape).astype(np.float32)
    noise[:, 2] = 0.0
    return aa0, t0, t0 + noise * mask


@pytest.fixture(scope="module")
def runs():
    """The plain chain on the fronto-parallel scene, and from a noisy seed on
    the two-plane scene, in both packages."""
    js = jax_settings(S)
    fp, jfp = scenes("fronto_parallel_scene", 120, 160, array_width=2, array_height=2, disp=8.0,
                     bl_ratio=1.0)
    tp, jtp = scenes("two_plane_scene", 120, 160, array_width=2, array_height=2, disp_bg=5.0,
                     disp_fg=11.0, bl_ratio=1.0)
    aa0, t0, t_noisy = _noisy_seed()
    plain = dict(k=192, max_matches=96, ba_iters=8)
    noisy = dict(k=192, max_matches=96, ba_iters=10, pose_seed=(aa0, t_noisy))
    return dict(
        t0=t0, t_noisy=t_noisy,
        plain=run_sfm(fp, S, device=CPU, **plain), jplain=jax_pipeline.run_sfm(jfp, js, **plain),
        noisy=run_sfm(tp, S, device=CPU, **noisy), jnoisy=jax_pipeline.run_sfm(jtp, js, **noisy),
    )


def _ate_xy(tr, t0):
    return float(np.sqrt(np.mean(np.sum((tr - t0)[:, :2] ** 2, -1))))


def test_unique_adjacent_pairs_equal_jax():
    for s in (S, SystemSettings()):
        np.testing.assert_array_equal(_unique_adjacent_pairs(s),
                                      jax_pipeline._unique_adjacent_pairs(jax_settings(s)))


def test_pairs_from_poses_matches_grid_special_case():
    s = SystemSettings()  # 3x3 reference defaults
    view_subset, _ = build_view_subsets(s)
    _, tr = sfm.grid_rig_poses(s.view_num, s.array_width, 1.0, s.bl_ratio)
    got = pairs_from_poses(tr, view_subset, 1.0, s.bl_ratio)
    want = pairs_from_subsets(view_subset, s.array_width)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_allclose(g[2:], w[2:], atol=1e-5)
    assert tuple(want) == tuple(jax_pairs_from_subsets(view_subset, s.array_width))


def test_pairs_from_poses_with_rotations_matches_jax():
    s = SystemSettings()
    view_subset, _ = build_view_subsets(s)
    rng = np.random.default_rng(5)
    aa = rng.normal(0, 0.02, (9, 3)).astype(np.float32)
    tr = sfm.grid_rig_poses(9, 3, 0.7, s.bl_ratio)[1] + rng.normal(0, 0.05, (9, 3)).astype(np.float32)
    got = pairs_from_poses(tr, view_subset, 0.7, s.bl_ratio, aa=aa)
    want = jax_pipeline.pairs_from_poses(tr, view_subset, 0.7, s.bl_ratio, aa=aa)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2:] for g in got], [w[2:] for w in want], rtol=0, atol=1e-6)


def test_run_sfm_on_synthetic_scene(runs):
    """tests/test_sfm_pipeline.py's bounds."""
    res = runs["plain"]
    assert res.n_matches > 100, res.n_matches
    assert res.rms_after <= res.rms_before + 1e-3, (res.rms_before, res.rms_after)
    assert res.rms_after < 1.5, res.rms_after
    assert res.ate_vs_grid < 0.25, res.ate_vs_grid


def test_run_sfm_on_synthetic_scene_matches_jax(runs):
    """Same matches and weights; the RMS values are ~1e-4 px and below, so
    they are held in absolute terms (1e-5 px), the poses within 1e-5."""
    res, jres = runs["plain"], runs["jplain"]
    assert res.n_matches == jres.n_matches
    np.testing.assert_array_equal(res.obs_w, jres.obs_w)
    np.testing.assert_array_equal(res.intr, jres.intr)
    np.testing.assert_allclose(res.rms_before, jres.rms_before, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.rms_after, jres.rms_after, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.t, jres.t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.aa, jres.aa, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.ate_vs_grid, jres.ate_vs_grid, rtol=0, atol=1e-5)


def test_run_sfm_recovers_from_noisy_seed(runs):
    """tests/test_sfm_pipeline.py's bounds."""
    res = runs["noisy"]
    seed_ate_xy = _ate_xy(runs["t_noisy"], runs["t0"])
    out_ate_xy = _ate_xy(res.t, runs["t0"])
    assert out_ate_xy < seed_ate_xy * 0.65, (seed_ate_xy, out_ate_xy)
    assert out_ate_xy < 0.12, out_ate_xy
    assert res.rms_after < res.rms_before * 0.5, (res.rms_before, res.rms_after)


def test_run_sfm_recovers_from_noisy_seed_matches_jax(runs):
    res, jres = runs["noisy"], runs["jnoisy"]
    assert res.n_matches == jres.n_matches
    np.testing.assert_array_equal(res.obs_w, jres.obs_w)
    np.testing.assert_allclose(res.rms_before, jres.rms_before, rtol=1e-5)
    np.testing.assert_allclose(res.rms_after, jres.rms_after, rtol=1e-4)
    np.testing.assert_allclose(res.t, jres.t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.X, jres.X, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """run_sfm(mesh=...) on the fronto-parallel scene with the plain chain's
    arguments, on 2 gloo ranks."""
    import json

    from torch_dist_worker import spawn

    fp, _ = scenes("fronto_parallel_scene", 120, 160, array_width=2, array_height=2, disp=8.0,
                   bl_ratio=1.0)
    ins = dict(settings=json.dumps(S.to_dict()), rgb=fp, k=192, max_matches=96, ba_iters=8)
    return spawn("sfm", 2, ins, tmp_path_factory.mktemp("sfm"))


def test_run_sfm_mesh_matches_jax(sharded, runs):
    """``run_sfm(mesh=...)`` at world size 2 against JAX's ``run_sfm``, at
    test_run_sfm_on_synthetic_scene_matches_jax's bounds; the same poses
    on both ranks, and the RMS within 1e-5 px of the port's unsharded run.
    JAX's ``run_sfm(mesh=make_mesh(4))`` runs its sharded solve's
    shard_map round eagerly, about six minutes on this scene on the CPU,
    so JAX is represented by its unsharded run (its sharded solve is held
    to that by tests/test_sfm.py)."""
    outs, jres = sharded, runs["jplain"]
    res = outs[0]
    for f in ("aa", "t", "X"):
        np.testing.assert_array_equal(outs[1][f], res[f], err_msg=f)
    assert int(res["n_matches"]) == jres.n_matches
    np.testing.assert_array_equal(res["obs_w"], jres.obs_w)
    np.testing.assert_allclose(res["rms_before"], jres.rms_before, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["rms_after"], jres.rms_after, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["t"], jres.t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["aa"], jres.aa, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["ate_vs_grid"], jres.ate_vs_grid, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["rms_after"], runs["plain"].rms_after, rtol=0, atol=1e-5)


def test_run_sfm_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        run_sfm(np.zeros((4, 32, 32, 3), np.uint8), S)


@pytest.fixture(scope="module")
def small_scene():
    return scenes("fronto_parallel_scene", 48, 64, array_width=2, array_height=2, disp=6.0, bl_ratio=1.0)


def test_pipeline_accepts_grid_pair_deltas_bitwise(small_scene):
    """tests/test_sfm_pipeline.py's generalized projection path: grid poses
    fed back through pairs_from_poses reproduce the default pipeline
    bit for bit."""
    rgb, _ = small_scene
    view_subset, _ = build_view_subsets(S)
    _, tr = sfm.grid_rig_poses(S.view_num, S.array_width, 1.0, S.bl_ratio)
    deltas = pairs_from_poses(tr, view_subset, 1.0, S.bl_ratio)
    base = MVSPipeline.create(64, 48, S, device=CPU).run(rgb)
    gen = MVSPipeline.create(64, 48, S, device=CPU, pair_deltas=deltas).run(rgb)
    np.testing.assert_array_equal(n(gen.disp_full), n(base.disp_full))


def test_pipeline_non_integer_pair_deltas_match_jax(small_scene):
    """Recovered-looking poses (off the grid by a few hundredths) give
    fractional deltas; the port's pipeline holds JAX's at
    tests/test_torch_pipeline.py's bounds."""
    rgb, jrgb = small_scene
    view_subset, _ = build_view_subsets(S)
    _, tr = sfm.grid_rig_poses(S.view_num, S.array_width, 1.0, S.bl_ratio)
    tr = tr + np.random.default_rng(8).normal(0, 0.03, tr.shape).astype(np.float32) * [[0], [1], [1], [1]]
    deltas = pairs_from_poses(tr, view_subset, 1.0, S.bl_ratio)
    assert any(d[2] != round(d[2]) for d in deltas)
    assert deltas == jax_pipeline.pairs_from_poses(tr, view_subset, 1.0, S.bl_ratio)
    port = MVSPipeline.create(64, 48, S, device=CPU, pair_deltas=deltas).run(rgb)
    ref = JaxPipeline.create(64, 48, jax_settings(S), pair_deltas=deltas).run(jrgb)
    assert (n(port.labels) == np.asarray(ref.labels)).mean() > 0.995
    assert (n(port.disp_init) == np.asarray(ref.disp_init)).mean() >= 0.99
    close = (np.abs(n(port.disp_full) - np.asarray(ref.disp_full)) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"
