"""The port's pose-graph backend (``models/sfm``: ``so3_log``,
``relative_from_absolute``, ``pose_graph_residuals``,
``pose_graph_optimize``, ``two_view_relative``) and ``run_sfm`` with it,
against the JAX package on the CPU, with tests/test_pose_graph.py's
scenarios and bounds.

Forward-mode Jacobians at a zero rotation, at exact relative factors and at
a generic pose are held within 1e-5 relative of JAX's and must be finite.
Each JAX scenario that needs a solve runs once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import test_pose_graph as jax_cases
from cl_multiview_stereo_tpu.models import sfm as jsfm
from cl_multiview_stereo_tpu.models.sfm_pipeline import run_sfm as jax_run_sfm
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.models import sfm
from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import run_sfm
from torch_parity import CPU, jax_settings, n, scenes, small_settings, t


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _graph(aa, tr, edges, info=None):
    """Exact factors of (aa, t) as both packages' PoseGraph."""
    rel_aa, rel_t = jsfm.relative_from_absolute(aa, tr, edges)
    ones = jnp.ones(edges.shape[0])
    g = jsfm.PoseGraph(edges=edges, rel_aa=rel_aa, rel_t=rel_t, w_rot=ones, w_t=ones, info=info)
    return g, convert.pose_graph(g, CPU)


def test_so3_log_roundtrip_and_jax():
    rng = np.random.default_rng(1)
    aa = rng.normal(0, 0.8, (32, 3)).astype(np.float32)
    back = n(sfm.so3_log(sfm.rodrigues(t(aa))))
    np.testing.assert_allclose(back, aa, atol=1e-4)
    R = np.asarray(jsfm.rodrigues(jnp.asarray(aa)))
    np.testing.assert_allclose(n(sfm.so3_log(t(R))), np.asarray(jsfm.so3_log(jnp.asarray(R))),
                               rtol=0, atol=2e-6)


def test_relative_from_absolute_consistency():
    """Factors from absolute poses reproduce x_j = R_ji x_i + t_ji, and equal
    JAX's."""
    aa, tr = jax_cases._rig_with_rotations()
    edges = jax_cases._grid_edges()
    rel_aa, rel_t = sfm.relative_from_absolute(t(aa), t(tr), t(edges, torch.int32))
    R = n(sfm.rodrigues(t(aa)))
    X = np.random.default_rng(2).normal(0, 2, (5, 3)).astype(np.float32)
    for e in range(edges.shape[0]):
        i, j = int(edges[e, 0]), int(edges[e, 1])
        xi = X @ R[i].T + np.asarray(tr)[i]
        xj = X @ R[j].T + np.asarray(tr)[j]
        xj_pred = xi @ n(sfm.rodrigues(rel_aa[e])).T + n(rel_t[e])
        np.testing.assert_allclose(xj_pred, xj, atol=1e-4)
    jaa, jt = jsfm.relative_from_absolute(aa, tr, edges)
    np.testing.assert_allclose(n(rel_aa), np.asarray(jaa), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(rel_t), np.asarray(jt), rtol=0, atol=1e-6)


def _edge_jacobians(g, aa, tr):
    """pose_graph_optimize's per-edge J (E, 6, 12), in each package."""
    if isinstance(aa, torch.Tensor):
        ei, ej = g.edges[:, 0].long(), g.edges[:, 1].long()
        packed = torch.cat([aa[ei], tr[ei], aa[ej], tr[ej]], -1)
        fn = lambda cv, raa, rt: sfm._pose_graph_residual(cv[0:3], cv[3:6], cv[6:9], cv[9:12], raa, rt)
        return vmap(jacfwd(fn))(packed, g.rel_aa, g.rel_t)
    packed = jax.vmap(lambda e: jnp.concatenate([aa[e[0]], tr[e[0]], aa[e[1]], tr[e[1]]]))(g.edges)
    fn = lambda cv, raa, rt: jsfm._pose_graph_residual(cv[0:3], cv[3:6], cv[6:9], cv[9:12], raa, rt)
    return jax.vmap(jax.jacfwd(fn))(packed, g.rel_aa, g.rel_t)


@pytest.mark.parametrize("pose", ["grid_rig", "exact_factors", "generic"])
def test_pose_graph_jacobian_matches_jax(pose):
    """At the grid rig every rotation is 0; at exact factors every residual
    rotation is the identity (arccos at its clip); "generic" is off both."""
    edges = jax_cases._grid_edges()
    if pose == "grid_rig":
        aa, tr = (jnp.asarray(x) for x in jsfm.grid_rig_poses(9, 3, 1.0, 1.0359))
    else:
        aa, tr = jax_cases._rig_with_rotations()
    g, pg = _graph(aa, tr, edges)
    if pose == "generic":
        aa, tr = aa * 1.3, tr + 0.1
    got = _edge_jacobians(pg, t(aa), t(tr))
    want = np.asarray(_edge_jacobians(g, aa, tr))
    assert got.dtype == torch.float32 and torch.isfinite(got).all() and np.isfinite(want).all()
    assert _rel(n(got), want) < 1e-5


def test_pose_graph_residuals_singular_info_is_nan_as_in_jax():
    """An information matrix that is not positive definite (exactly rank
    deficient, so the 1e-12 ridge vanishes in float32) whitens its edge to
    NaN in XLA's Cholesky; the port gives the same and raises nothing."""
    aa, tr = jax_cases._rig_with_rotations()
    edges = jax_cases._grid_edges()
    info = np.tile(np.eye(6, dtype=np.float32), (edges.shape[0], 1, 1))
    info[0] = 0.0
    info[0, :2, :2] = 1e8
    g, pg = _graph(aa, tr, edges, info=jnp.asarray(info))
    seed = np.asarray(tr) + 0.01
    got = n(sfm.pose_graph_residuals(pg, t(aa), t(seed)))
    want = np.asarray(jsfm.pose_graph_residuals(g, aa, jnp.asarray(seed)))
    assert np.isnan(want[0]).all() and np.isfinite(want[1:]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def rig_solve():
    """tests/test_pose_graph.py's perturbed-rig solve, in both packages."""
    aa_gt, t_gt = jax_cases._rig_with_rotations()
    edges = jax_cases._grid_edges()
    g, pg = _graph(aa_gt, t_gt, edges)
    rng = np.random.default_rng(4)
    mask = np.ones((9, 1), np.float32)
    mask[0] = 0.0
    aa0 = np.asarray(aa_gt) + rng.normal(0, 0.05, (9, 3)).astype(np.float32) * mask
    t0 = np.asarray(t_gt) + rng.normal(0, 0.15, (9, 3)).astype(np.float32) * mask
    out = sfm.pose_graph_optimize(pg, t(aa0), t(t0), iters=12)
    jout = jsfm.pose_graph_optimize(g, jnp.asarray(aa0), jnp.asarray(t0), iters=12)
    return dict(g=g, pg=pg, aa_gt=aa_gt, t_gt=t_gt, t0=t0, out=out, jout=jout)


def test_pose_graph_recovers_perturbed_rig(rig_solve):
    """tests/test_pose_graph.py's bounds."""
    t_gt = t(rig_solve["t_gt"])
    aa_out, t_out = rig_solve["out"]
    seed_ate = float(sfm.ate(t(rig_solve["t0"]), t_gt))
    out_ate = float(sfm.ate(t_out, t_gt))
    assert seed_ate > 0.05, seed_ate
    assert out_ate < 1e-3, (seed_ate, out_ate)
    rot_err = float((aa_out - t(rig_solve["aa_gt"])).norm(dim=-1).max())
    assert rot_err < 1e-3, rot_err
    r = sfm.pose_graph_residuals(rig_solve["pg"], aa_out, t_out)
    assert float(r.abs().max()) < 1e-3


def test_pose_graph_optimize_matches_jax(rig_solve):
    (aa, tr), (jaa, jt) = rig_solve["out"], rig_solve["jout"]
    np.testing.assert_allclose(n(aa), np.asarray(jaa), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(tr), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(sfm.pose_graph_residuals(rig_solve["pg"], aa, tr)),
                               np.asarray(jsfm.pose_graph_residuals(rig_solve["g"], jaa, jt)),
                               rtol=0, atol=1e-5)


def _jax_two_view_jacobians(camp, X, ua, ub, intr):
    """JAX's per-match jc, jp of two_view_relative's res_one (a closure
    there), as it writes them."""
    def res_one(c, Xp, u1, u2):
        ra = jsfm.project(jnp.zeros(3), jnp.zeros(3), Xp, intr) - u1
        rb = jsfm.project(c[0:3], c[3:6], Xp, intr) - u2
        return jnp.concatenate([ra, rb])

    one = lambda c, Xp, u1, u2: (jax.jacfwd(res_one, 0)(c, Xp, u1, u2), jax.jacfwd(res_one, 1)(c, Xp, u1, u2))
    return jax.vmap(lambda c, Xe, u1e, u2e: jax.vmap(lambda Xp, u1, u2: one(c, Xp, u1, u2))(Xe, u1e, u2e))(
        camp, X, ua, ub)


@pytest.fixture(scope="module")
def two_view():
    """tests/test_pose_graph.py's two-view scene: 48 points seen by camera i
    at the identity and two relative poses j, with perturbed seeds."""
    rng = np.random.default_rng(7)
    intr = jnp.asarray([200.0, 200.0, 80.0, 60.0])
    aa_true = jnp.asarray([[0.02, -0.03, 0.01], [0.0, 0.0, 0.0]], jnp.float32)
    t_true = jnp.asarray([[-1.0, 0.05, 0.02], [-1.0, 0.0, 0.0]], jnp.float32)
    m = 48
    X = jnp.asarray(
        np.stack([rng.uniform(-3, 3, m), rng.uniform(-2, 2, m), rng.uniform(6, 14, m)], -1), jnp.float32
    )
    proj = jax.vmap(jsfm.project, (None, None, 0, None))
    zero = jnp.zeros(3)
    uv_a = jnp.stack([proj(zero, zero, X, intr)] * 2)
    uv_b = jnp.stack([proj(aa_true[0], t_true[0], X, intr), proj(aa_true[1], t_true[1], X, intr)])
    seed_aa = aa_true + jnp.asarray(rng.normal(0, 0.02, (2, 3)).astype(np.float32))
    seed_t = t_true + jnp.asarray(rng.normal(0, 0.08, (2, 3)).astype(np.float32))
    seed_t = seed_t / jnp.linalg.norm(seed_t, axis=-1, keepdims=True) * jnp.linalg.norm(
        t_true, axis=-1, keepdims=True
    )
    args = (uv_a, uv_b, jnp.ones((2, m)), intr, seed_aa, seed_t)
    return dict(
        args=args, X=X, aa_true=aa_true, t_true=t_true,
        port=sfm.two_view_relative(*(t(a) for a in args)),
        jax=jsfm.two_view_relative(*args),
    )


def test_two_view_relative_recovers_pose(two_view):
    """tests/test_pose_graph.py's bounds."""
    rel_aa, rel_t, info = (n(x) for x in two_view["port"])
    assert info.shape == (2, 6, 6)
    np.testing.assert_allclose(info, info.transpose(0, 2, 1), rtol=1e-3)
    assert float(np.diagonal(info, axis1=1, axis2=2).min()) > -1.0
    np.testing.assert_allclose(rel_aa, np.asarray(two_view["aa_true"]), atol=2e-3)
    np.testing.assert_allclose(rel_t, np.asarray(two_view["t_true"]), atol=2e-2)


def test_two_view_relative_matches_jax(two_view):
    """The factors within 1e-5 and the information within 1e-4 relative of
    its largest entry (f^2-scale terms cancel in float32)."""
    (rel_aa, rel_t, info), (jaa, jt, jinfo) = two_view["port"], two_view["jax"]
    np.testing.assert_allclose(n(rel_aa), np.asarray(jaa), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(rel_t), np.asarray(jt), rtol=0, atol=1e-5)
    assert _rel(n(info), jinfo) < 1e-4


@pytest.mark.parametrize("pose", ["zero", "generic"])
def test_two_view_jacobians_match_jax(two_view, pose):
    uv_a, uv_b, _, intr, seed_aa, seed_t = two_view["args"]
    camp = jnp.concatenate([seed_aa, seed_t], -1)
    if pose == "zero":
        camp = camp.at[:, :3].set(0.0)
    X = jnp.stack([two_view["X"]] * 2)
    jc, jp = sfm._two_view_jacobians(t(camp), t(X), t(uv_a), t(uv_b), t(intr))
    jjc, jjp = _jax_two_view_jacobians(camp, X, uv_a, uv_b, intr)
    for got, want in ((jc, jjc), (jp, jjp)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert _rel(n(got), want) < 1e-5


def test_two_view_relative_fixed_rotation_matches_jax(two_view):
    """``fix_rotations`` (run_sfm's default): the rotation stays the seed's,
    the pinned rows carry the rig prior's weight."""
    args = two_view["args"]
    rel_aa, rel_t, info = sfm.two_view_relative(*(t(a) for a in args), fix_rotations=True)
    jaa, jt, jinfo = jsfm.two_view_relative(*args, fix_rotations=True)
    np.testing.assert_array_equal(n(rel_aa), np.asarray(args[4]))
    np.testing.assert_allclose(n(rel_t), np.asarray(jt), rtol=0, atol=1e-4)
    assert _rel(n(info), jinfo) < 1e-3


@pytest.fixture(scope="module")
def sfm_runs():
    """tests/test_pose_graph.py's full chain: a two-plane scene, a noisy
    seed, run_sfm(use_pose_graph=True), in both packages."""
    s = small_settings(no_prop=1)
    rgb, jrgb = scenes("two_plane_scene", 120, 160, array_width=2, array_height=2,
                       disp_bg=5.0, disp_fg=11.0, bl_ratio=1.0)
    rng = np.random.default_rng(3)
    aa0, t0 = sfm.grid_rig_poses(s.view_num, s.array_width, 1.0, s.bl_ratio)
    mask = np.asarray([0.0] + [1.0] * (t0.shape[0] - 1), np.float32)[:, None]
    noise = rng.normal(0, 0.08, t0.shape).astype(np.float32)
    noise[:, 2] = 0.0
    t_noisy = t0 + noise * mask
    kw = dict(k=192, max_matches=96, ba_iters=10, pose_seed=(aa0, t_noisy), use_pose_graph=True)
    return dict(t0=t0, t_noisy=t_noisy, port=run_sfm(rgb, s, device=CPU, **kw),
                jax=jax_run_sfm(jrgb, jax_settings(s), **kw))


def _ate_xy(tr, t0):
    return float(np.sqrt(np.mean(np.sum((tr - t0)[:, :2] ** 2, -1))))


def test_run_sfm_with_pose_graph_backend(sfm_runs):
    """tests/test_pose_graph.py's bounds."""
    res, t0 = sfm_runs["port"], sfm_runs["t0"]
    seed_ate_xy = _ate_xy(sfm_runs["t_noisy"], t0)
    out_ate_xy = _ate_xy(res.t, t0)
    assert out_ate_xy < seed_ate_xy * 0.65, (seed_ate_xy, out_ate_xy)
    assert res.rms_after < res.rms_before * 0.5, (res.rms_before, res.rms_after)


def test_run_sfm_with_pose_graph_matches_jax(sfm_runs):
    """The same matches and gate, and the poses within 1e-3 (measured:
    1.2e-4; the pose-graph solve passes the two-view information's float32
    cancellation on)."""
    res, jres = sfm_runs["port"], sfm_runs["jax"]
    assert res.n_matches == jres.n_matches
    np.testing.assert_array_equal(res.obs_w, jres.obs_w)
    np.testing.assert_allclose(res.t, jres.t, rtol=0, atol=1e-3)
    np.testing.assert_allclose(res.rms_before, jres.rms_before, rtol=1e-3)
    np.testing.assert_allclose(res.rms_after, jres.rms_after, rtol=1e-2)
    np.testing.assert_allclose(_ate_xy(res.t, sfm_runs["t0"]), _ate_xy(jres.t, sfm_runs["t0"]), rtol=1e-2)
