"""The port's camera model, triangulation and Schur bundle adjustment
(``models/sfm``) against ``cl_multiview_stereo_tpu/models/sfm.py`` on the
CPU, with tests/test_sfm.py's problems and bounds.  The observation-sharded
solve runs in a gloo group of 4 processes (``torch_dist_worker.spawn``).

Tolerances: products and reductions of a few terms differ from XLA's by
ulps (other summation orders, XLA's fused multiply-adds), so values are
held within 1e-5 relative (Jacobians, assembled blocks) and solver outputs
within the bounds stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_sfm as jax_cases
from cl_multiview_stereo_tpu.models import sfm as jsfm
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.models import sfm
from torch_dist_worker import spawn
from torch_parity import CPU, n, t


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _prob(p):
    return convert.ba_problem(p, CPU)


def _noisy(prob_gt, aa_scale, t_scale, x_scale, seed):
    """tests/test_sfm.py's perturbation: camera 0 stays the gauge."""
    rng = np.random.default_rng(seed)
    c = prob_gt.aa.shape[0]
    mask = np.asarray([0.0] + [1.0] * (c - 1))[:, None]
    return prob_gt._replace(
        aa=prob_gt.aa + jnp.asarray(rng.normal(0, aa_scale, (c, 3)) * mask, jnp.float32),
        t=prob_gt.t + jnp.asarray(rng.normal(0, t_scale, (c, 3)) * mask, jnp.float32),
        X=prob_gt.X + jnp.asarray(rng.normal(0, x_scale, prob_gt.X.shape), jnp.float32),
    )


def test_rodrigues_identity_and_90deg():
    np.testing.assert_allclose(n(sfm.rodrigues(torch.zeros(3))), np.eye(3), atol=1e-6)
    r = n(sfm.rodrigues(t([0.0, 0.0, np.pi / 2])))
    np.testing.assert_allclose(r @ [1, 0, 0], [0, 1, 0], atol=1e-6)


def test_rodrigues_and_project_match_jax():
    rng = np.random.default_rng(0)
    aa = rng.normal(0, 0.5, (16, 3)).astype(np.float32)
    aa[0] = 0.0
    aa[1] = [1e-9, 0.0, 0.0]  # below the small-angle switch
    tr = rng.normal(0, 1, (16, 3)).astype(np.float32)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (16, 3)).astype(np.float32)
    intr = np.asarray([500.0, 500.0, 320.0, 240.0], np.float32)
    np.testing.assert_allclose(n(sfm.rodrigues(t(aa))), np.asarray(jax.vmap(jsfm.rodrigues)(aa)),
                               rtol=0, atol=1e-6)
    want = np.asarray(jax.vmap(jsfm.project, (0, 0, 0, None))(aa, tr, X, intr))
    np.testing.assert_allclose(n(sfm.project(t(aa), t(tr), t(X), t(intr))), want, rtol=1e-5, atol=0)


def test_grid_rig_poses_equal_jax():
    for args in ((9, 3, 1.0, 1.0359), (4, 2, 0.5, 1.0), (12, 4, 2.0, 0.97)):
        for got, want in zip(sfm.grid_rig_poses(*args), jsfm.grid_rig_poses(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_project_triangulate_roundtrip():
    prob, aa, tr, X = jax_cases._synthetic_ba(n_cam=2, n_pt=20)
    p = _prob(prob)
    pairs = np.stack([np.zeros(20), np.ones(20)], -1).astype(np.int32)
    Xt = sfm.triangulate(p.aa, p.t, p.intr, t(pairs, torch.int32), p.obs_uv[:20], p.obs_uv[20:40])
    np.testing.assert_allclose(n(Xt), X, rtol=1e-3, atol=1e-3)
    want = jsfm.triangulate(prob.aa, prob.t, prob.intr, jnp.asarray(pairs), prob.obs_uv[:20],
                            prob.obs_uv[20:40])
    np.testing.assert_allclose(n(Xt), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_residuals_and_rms_match_jax():
    prob, *_ = jax_cases._synthetic_ba(noise=0.5, seed=3)
    prob = prob._replace(obs_w=prob.obs_w.at[::7].set(0.0))
    p = _prob(prob)
    # residuals of ~0.5 px from projections of ~500 px: their ulps
    np.testing.assert_allclose(n(sfm.residuals(p)), np.asarray(jsfm.residuals(prob)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(sfm.rms_error(p)), float(jsfm.rms_error(prob)), rtol=1e-4)
    np.testing.assert_allclose(float(sfm.ate(p.t, p.t + 1.0)), float(jsfm.ate(prob.t, prob.t + 1.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("rotation", ["zero", "generic"])
def test_obs_block_jacobians_match_jax(rotation):
    """jacfwd through rodrigues at aa = 0 (the grid rig's every camera) and
    at a generic pose: finite, float32, within 1e-5 relative of JAX's."""
    prob, *_ = jax_cases._synthetic_ba(noise=0.5, seed=3)
    if rotation == "zero":
        prob = prob._replace(aa=jnp.zeros_like(prob.aa))
    r, jc, jp = sfm._obs_blocks(_prob(prob))
    jr, jjc, jjp = jsfm._obs_blocks(prob)
    for got, want in ((jc, jjc), (jp, jjp)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert _rel(n(got), want) < 1e-5
    np.testing.assert_allclose(n(r), np.asarray(jr), rtol=0, atol=1e-4)


def test_assemble_and_point_slots_match_jax():
    prob, *_ = jax_cases._synthetic_ba(n_cam=5, n_pt=17, seed=3, noise=0.5)
    p = _prob(prob)
    blocks = sfm._assemble(p, *sfm._obs_blocks(p), 5, 17)
    jblocks = jsfm._assemble(prob, *jsfm._obs_blocks(prob), 5, 17)
    # hcc, hpp within 1e-5; bc, bp carry the residuals' ulps (~0.5 px left
    # of projections near 500 px, so ~1e-4 relative)
    for got, want, tol in zip(blocks, jblocks, (1e-5, 1e-5, 3e-4, 3e-4)):
        assert _rel(n(got), want) < tol
    # shuffled point ids: a stable sort, ranks within each point
    obs_pt = np.random.default_rng(1).permutation(np.repeat(np.arange(9), [1, 4, 2, 5, 3, 1, 2, 6, 3]))
    for got, want in zip(sfm._point_slots(t(obs_pt, torch.int32), 4),
                         jsfm._point_slots(jnp.asarray(obs_pt, jnp.int32), 4)):
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_blocked_schur_matches_dense_reference():
    """tests/test_sfm.py's case: the slot-table coupling equals the dense
    (P, 6C, 3) formula in numpy, and JAX's blocked form."""
    prob, *_ = jax_cases._synthetic_ba(n_cam=5, n_pt=17, seed=3, noise=0.5)
    n_cam, n_pt = 5, 17
    p = _prob(prob)
    r, jc, jp = sfm._obs_blocks(p)
    hcc, hpp, bc, bp = sfm._assemble(p, r, jc, jp, n_cam, n_pt)
    hpp_inv = torch.linalg.inv(sfm._damped(hpp, 1e-3, 3))
    w_obs = torch.einsum("nij,nik->njk", jc, jp)
    y_obs = torch.einsum("njk,nkl->njl", w_obs, hpp_inv[p.obs_pt.long()])

    c6 = n_cam * 6
    y_flat = np.zeros((n_pt, c6, 3), np.float64)
    w_flat = np.zeros((n_pt, c6, 3), np.float64)
    cams, pts = n(p.obs_cam), n(p.obs_pt)
    for i in range(len(cams)):
        y_flat[pts[i], cams[i] * 6: cams[i] * 6 + 6] += n(y_obs[i])
        w_flat[pts[i], cams[i] * 6: cams[i] * 6 + 6] += n(w_obs[i])
    want = np.einsum("pik,pjk->ij", y_flat, w_flat)

    order, pt_s, slot = sfm._point_slots(p.obs_pt, max_deg=5)
    got = sfm._schur_corr_blocked(pt_s, p.obs_cam[order], y_obs[order], w_obs[order],
                                  n_cam, n_pt, slot, max_deg=5, chunk=7)
    np.testing.assert_allclose(n(got), want, rtol=2e-4, atol=1e-5)

    jr, jjc, jjp = jsfm._obs_blocks(prob)
    _, jhpp, _, _ = jsfm._assemble(prob, jr, jjc, jjp, n_cam, n_pt)
    jhpp_inv = jnp.linalg.inv(jhpp + 1e-3 * jnp.eye(3)[None] * jnp.maximum(
        jnp.trace(jhpp, axis1=-2, axis2=-1)[..., None, None] / 3.0, 1e-6))
    jw = jnp.einsum("nij,nik->njk", jjc, jjp)
    jy = jnp.einsum("njk,nkl->njl", jw, jhpp_inv[prob.obs_pt])
    jorder, jpt_s, jslot = jsfm._point_slots(prob.obs_pt, 5)
    jgot = jsfm._schur_corr_blocked(jpt_s, prob.obs_cam[jorder], jy[jorder], jw[jorder],
                                    n_cam, n_pt, jslot, 5, chunk=7)
    assert _rel(n(got), jgot) < 1e-5


@pytest.mark.parametrize("fix_rotations", [False, True])
def test_schur_solve_matches_jax(fix_rotations):
    prob, *_ = jax_cases._synthetic_ba(n_cam=5, n_pt=17, seed=3, noise=0.5)
    p = _prob(prob)
    dc, dx = sfm._schur_solve(p, *sfm._obs_blocks(p), 5, 17, 1e-3, fix_rotations=fix_rotations, max_deg=6)
    jdc, jdx = jsfm._schur_solve(prob, *jsfm._obs_blocks(prob), 5, 17, 1e-3,
                                 fix_rotations=fix_rotations, max_deg=6)
    # the (6C x 6C) solve amplifies the blocks' ulps by its conditioning
    assert _rel(n(dc), jdc) < 1e-3 and _rel(n(dx), jdx) < 1e-3
    if fix_rotations:
        assert (n(dc)[:, :3] == 0).all()
    assert (n(dc)[0] == 0).all()


def test_check_max_deg_refuses_merged_couplings():
    prob, *_ = jax_cases._synthetic_ba(n_cam=3, n_pt=5)
    with pytest.raises(ValueError, match="max_deg=2 but a point has 3 observations"):
        sfm.bundle_adjust(_prob(prob), iters=1, max_deg=2)


def test_bundle_adjust_rejects_a_singular_step():
    """Zero damping and a point no weighted observation sees: its (3, 3)
    block is singular, the step non-finite, and the guard keeps the input
    (XLA gives NaN there too; nothing raises)."""
    prob, *_ = jax_cases._synthetic_ba(n_cam=3, n_pt=5, noise=0.5)
    prob = prob._replace(obs_w=prob.obs_w.at[jnp.asarray([0, 5, 10])].set(0.0))
    out = sfm.bundle_adjust(_prob(prob), iters=2, damping=0.0, max_deg=3)
    jout = jsfm.bundle_adjust(prob, iters=2, damping=0.0, max_deg=3)
    for f in ("aa", "t", "X"):
        np.testing.assert_array_equal(n(getattr(out, f)), np.asarray(getattr(prob, f)))
        np.testing.assert_array_equal(np.asarray(getattr(jout, f)), np.asarray(getattr(prob, f)))


def test_bundle_adjust_recovers_poses():
    """tests/test_sfm.py's bounds, and JAX's solution within 1e-4."""
    prob_gt, *_ = jax_cases._synthetic_ba(noise=0.0)
    noisy = _noisy(prob_gt, 0.01, 0.05, 0.1, seed=1)
    e0 = float(jsfm.rms_error(noisy))
    out = sfm.bundle_adjust(_prob(noisy), iters=8)
    e1 = float(sfm.rms_error(out))
    assert e1 < e0 * 0.05, f"rms {e0} -> {e1}"
    assert float(sfm.ate(out.t, t(prob_gt.t))) < 0.05
    jout = jsfm.bundle_adjust(noisy, iters=8)
    np.testing.assert_allclose(e1, float(jsfm.rms_error(jout)), rtol=1e-2)
    for f in ("aa", "t", "X"):
        np.testing.assert_allclose(n(getattr(out, f)), np.asarray(getattr(jout, f)), rtol=0, atol=1e-4)


def test_bundle_adjust_free_rotations_under_noise():
    """tests/test_sfm.py's bounds for fix_rotations=False, and JAX's
    solution within 1e-4."""
    prob_gt, *_ = jax_cases._synthetic_ba(noise=0.2, seed=5)
    noisy = _noisy(prob_gt, 0.02, 0.05, 0.1, seed=7)
    out = sfm.bundle_adjust(_prob(noisy), iters=10, fix_rotations=False)
    aa_err0 = float(jnp.abs(noisy.aa - prob_gt.aa).max())
    aa_err1 = float(np.abs(n(out.aa) - np.asarray(prob_gt.aa)).max())
    assert aa_err1 < 0.25 * aa_err0, f"rotation error {aa_err0} -> {aa_err1}"
    assert float(sfm.ate(out.t, t(prob_gt.t))) < 0.03
    jout = jsfm.bundle_adjust(noisy, iters=10, fix_rotations=False)
    for f in ("aa", "t", "X"):
        np.testing.assert_allclose(n(getattr(out, f)), np.asarray(getattr(jout, f)), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def sharded_ba(tmp_path_factory):
    """tests/test_sfm.py's sharded case (its problem and noise, 6
    iterations): the port's ``bundle_adjust_sharded`` on 4 gloo ranks, the
    port's single-device solve and JAX's.  JAX's own sharded solve runs
    its shard_map round eagerly, about 260 s on this problem on the CPU,
    so JAX is represented by its single-device solve, which
    tests/test_sfm.py holds to the sharded one at these bounds."""
    prob_gt, aa_gt, t_gt, X_gt = jax_cases._synthetic_ba()
    rng = np.random.default_rng(2)
    mask = jnp.asarray([0.0] + [1.0] * (aa_gt.shape[0] - 1))[:, None]
    noisy = prob_gt._replace(
        t=prob_gt.t + jnp.asarray(rng.normal(0, 0.05, t_gt.shape), jnp.float32) * mask,
        X=prob_gt.X + jnp.asarray(rng.normal(0, 0.1, X_gt.shape), jnp.float32),
    )
    ins = {f: np.asarray(getattr(noisy, f)) for f in noisy._fields}
    outs = spawn("ba", 4, dict(ins, iters=6), tmp_path_factory.mktemp("ba"))
    jout = jsfm.bundle_adjust(noisy, iters=6)
    return dict(prob_gt=prob_gt, noisy=_prob(noisy), outs=outs, jout=jout,
                single=sfm.bundle_adjust(_prob(noisy), iters=6))


def _with_state(prob, out: dict):
    return prob._replace(**{f: t(out[f]) for f in ("aa", "t", "X")})


def test_bundle_adjust_sharded_bounds(sharded_ba):
    """tests/test_sfm.py's bounds for the sharded solve: RMS < 0.05 px and
    ATE < 0.05."""
    out = _with_state(sharded_ba["noisy"], sharded_ba["outs"][0])
    assert float(sfm.rms_error(out)) < 0.05
    assert float(sfm.ate(out.t, t(sharded_ba["prob_gt"].t))) < 0.05


def test_bundle_adjust_sharded_state_is_the_same_on_every_rank(sharded_ba):
    outs = sharded_ba["outs"]
    for r in range(1, len(outs)):
        for f in ("aa", "t", "X"):
            np.testing.assert_array_equal(outs[r][f], outs[0][f], err_msg=f"rank {r} {f}")


def test_bundle_adjust_sharded_matches_single_device_and_jax(sharded_ba):
    """The reduced sums add in another order than one device's: the RMS
    within 1e-4 px of the port's single-device solve, and the solution at
    test_bundle_adjust_recovers_poses's bounds against JAX's (RMS within
    1 %, state within 1e-4)."""
    out = _with_state(sharded_ba["noisy"], sharded_ba["outs"][0])
    rms = float(sfm.rms_error(out))
    assert abs(rms - float(sfm.rms_error(sharded_ba["single"]))) < 1e-4
    jout = sharded_ba["jout"]
    np.testing.assert_allclose(rms, float(jsfm.rms_error(jout)), rtol=1e-2)
    for f in ("aa", "t", "X"):
        np.testing.assert_allclose(n(getattr(out, f)), np.asarray(getattr(jout, f)), rtol=0, atol=1e-4)


def test_observation_shares_cover_every_observation():
    for n_obs, n_ranks in ((360, 4), (361, 4), (5, 4), (7, 3)):
        shares = [sfm.observation_share(n_obs, n_ranks, r) for r in range(n_ranks)]
        assert shares[0][0] == 0 and shares[-1][1] == n_obs
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
