"""Structure-from-motion: pinhole cameras, triangulation, Schur-complement
bundle adjustment and the pose-graph backend (port of
``cl_multiview_stereo_tpu/models/sfm.py``).

The reference's implicit rectified-grid camera (disparity shift scaled by
``bl_ratio``, clcode.cl:1033-1034) is one special case of the pinhole model
here (``grid_rig_poses``).

Every quantity is a dense tensor of fixed shape: C cameras (axis-angle +
translation), P points, N observations (camera id, point id, uv, weight).
Gauss-Newton with Levenberg damping; the per-observation Jacobians come
from ``torch.func.jacfwd`` of the projection, vmapped over observations,
as JAX's ``jax.jacfwd`` does.  Forward mode matters at a zero rotation
(every camera of the grid rig): the branch of ``rodrigues`` and ``so3_log``
that ``torch.where`` leaves unselected has a NaN or infinite tangent there,
and forward mode drops it with the branch.

Each solver loops in Python and keeps its accept decision on the device
(``torch.where`` on a 0-dim or per-edge mask, no ``.item()``), as JAX's
``lax.scan`` does.  Linear algebra that raises in PyTorch where XLA returns
NaN goes through the ``_ex`` variants: a singular system gives a non-finite
step, which the accept guard rejects.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

# ---------------------------------------------------------------------------
# Camera model
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last axis: sqrt of the sum of squares."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (m @ x.unsqueeze(-1)).squeeze(-1)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = _norm(aa, keepdim=True)
    small = theta < 1e-8
    axis = aa / torch.where(small, 1.0, theta)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )
    t = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    r = eye + torch.sin(t) * k + (1.0 - torch.cos(t)) * (k @ k)
    return torch.where(small[..., None], eye + k, r)


def project(aa: torch.Tensor, t: torch.Tensor, X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of points X (..., 3) by cameras (aa, t), intrinsics
    (fx, fy, cx, cy).  Returns (..., 2) pixel coords."""
    Xc = _matvec(rodrigues(aa), X) + t
    z = Xc[..., 2]
    u = intr[0] * Xc[..., 0] / z + intr[2]
    v = intr[1] * Xc[..., 1] / z + intr[3]
    return torch.stack([u, v], -1)


def grid_rig_poses(
    view_num: int, array_width: int, baseline: float, bl_ratio: float
) -> tuple[np.ndarray, np.ndarray]:
    """The reference's implicit camera rig as explicit poses: identity
    rotations, translations on a regular grid with the vertical pitch scaled
    by ``bl_ratio`` (clcode.cl:1033-1034)."""
    z = np.arange(view_num)
    t = np.stack(
        [
            -(z % array_width) * baseline,
            -(z // array_width) * baseline * bl_ratio,
            np.zeros(view_num),
        ],
        axis=-1,
    ).astype(np.float32)
    return np.zeros((view_num, 3), np.float32), t


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------


def triangulate(
    aa: torch.Tensor,  # (C, 3)
    t: torch.Tensor,  # (C, 3)
    intr: torch.Tensor,  # (4,)
    cam_ab: torch.Tensor,  # (M, 2) int camera pair per match
    uv_a: torch.Tensor,  # (M, 2)
    uv_b: torch.Tensor,  # (M, 2)
) -> torch.Tensor:
    """Midpoint triangulation of matched rays.  Returns (M, 3) points."""
    R = rodrigues(aa)  # (C, 3, 3)
    centers = -torch.einsum("cij,ci->cj", R, t)  # camera centers (C, 3)
    cam_ab = cam_ab.long()

    def ray(cam, uv):
        d = torch.stack(
            [(uv[:, 0] - intr[2]) / intr[0], (uv[:, 1] - intr[3]) / intr[1], torch.ones_like(uv[:, 0])],
            -1,
        )
        dw = _matvec(R[cam].transpose(-1, -2), d)
        return centers[cam], dw / _norm(dw, keepdim=True)

    oa, da = ray(cam_ab[:, 0], uv_a)
    ob, db = ray(cam_ab[:, 1], uv_b)
    # closest points on the two rays
    w0 = oa - ob
    a = (da * da).sum(-1)
    b = (da * db).sum(-1)
    c = (db * db).sum(-1)
    d_ = (da * w0).sum(-1)
    e = (db * w0).sum(-1)
    denom = a * c - b * b
    ok = torch.abs(denom) > 1e-9
    s = torch.where(ok, (b * e - c * d_) / denom, 0.0)[:, None]
    r = torch.where(ok, (a * e - b * d_) / denom, 0.0)[:, None]
    return 0.5 * ((oa + s * da) + (ob + r * db))


# ---------------------------------------------------------------------------
# Bundle adjustment
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    aa: torch.Tensor  # (C, 3) axis-angle
    t: torch.Tensor  # (C, 3)
    X: torch.Tensor  # (P, 3)
    intr: torch.Tensor  # (4,)
    obs_cam: torch.Tensor  # (N,) int32
    obs_pt: torch.Tensor  # (N,) int32
    obs_uv: torch.Tensor  # (N, 2)
    obs_w: torch.Tensor  # (N,) float32 weights (0 disables an observation)


def residuals(p: BAProblem) -> torch.Tensor:
    cam, pt = p.obs_cam.long(), p.obs_pt.long()
    return project(p.aa[cam], p.t[cam], p.X[pt], p.intr) - p.obs_uv  # (N, 2)


def rms_error(p: BAProblem) -> torch.Tensor:
    r = residuals(p) * p.obs_w[:, None]
    denom = torch.clamp(p.obs_w.sum(), min=1.0)
    return torch.sqrt((r * r).sum() / (2.0 * denom))


def _obs_blocks(p: BAProblem):
    """Per-observation residual + Jacobian blocks (2x6 camera, 2x3 point)."""
    cam, pt = p.obs_cam.long(), p.obs_pt.long()
    camp = torch.cat([p.aa[cam], p.t[cam]], -1)  # (N, 6)
    X = p.X[pt]

    def res_fn(camp_, X_, uv):
        return project(camp_[..., :3], camp_[..., 3:], X_, p.intr) - uv

    r = project(camp[:, :3], camp[:, 3:], X, p.intr) - p.obs_uv
    jc, jp = vmap(jacfwd(res_fn, argnums=(0, 1)))(camp, X, p.obs_uv)  # (N, 2, 6), (N, 2, 3)
    w = p.obs_w[:, None]
    return r * w, jc * w[..., None], jp * w[..., None]


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``x`` summed into ``n`` segments
    (on a card in no fixed order)."""
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add_(0, ids.long(), x)


def _no_reduce(x: torch.Tensor) -> torch.Tensor:
    return x


def _assemble(p: BAProblem, r, jc, jp, n_cam: int, n_pt: int, reduce=_no_reduce):
    """Normal-equation blocks via segment sums; ``reduce`` sums each over
    the ranks of a sharded solve (identity on one device)."""
    hcc = _segment_sum(torch.einsum("nij,nik->njk", jc, jc), p.obs_cam, n_cam)  # (C, 6, 6)
    hpp = _segment_sum(torch.einsum("nij,nik->njk", jp, jp), p.obs_pt, n_pt)  # (P, 3, 3)
    bc = _segment_sum(-torch.einsum("nij,ni->nj", jc, r), p.obs_cam, n_cam)  # (C, 6)
    bp = _segment_sum(-torch.einsum("nij,ni->nj", jp, r), p.obs_pt, n_pt)  # (P, 3)
    return reduce(hcc), reduce(hpp), reduce(bc), reduce(bp)


def _point_slots(obs_pt: torch.Tensor, max_deg: int):
    """Sort observations by point and rank each within its point group.

    Returns ``(order, pt_sorted, slot)`` with ``slot[i] < max_deg`` for every
    observation of a point with degree <= ``max_deg``.  Observations past
    ``max_deg`` (caller sized it wrong) are clamped to the last slot —
    their couplings then merge, so callers must pass the true max degree
    (``run_sfm`` computes it from the match table).
    """
    order = torch.argsort(obs_pt, stable=True)
    pt_s = obs_pt[order].contiguous()
    first = torch.searchsorted(pt_s, pt_s, right=False)
    slot = torch.clamp(torch.arange(pt_s.shape[0], device=pt_s.device) - first, max=max_deg - 1)
    return order, pt_s, slot


def _schur_corr_blocked(
    pt_s, cam_s, y_s, w_s, n_cam: int, n_pt: int, slot, max_deg: int, chunk: int = 2048,
    reduce=_no_reduce,
):
    """The camera-coupling correction ``S -= sum_j Y_j Hpp_j^-1 W_j^T`` in
    blocked form: per-point compact slot tables (P, D, 6, 3) with D = max
    observations per point, then a point-chunked loop accumulating (6, 6)
    blocks into the (C, C) camera-pair grid.  Memory is O(P*D) +
    O(chunk*D^2) whatever the camera count.  ``reduce`` sums the slot
    tables over the ranks of a sharded solve, whose ``slot`` are global
    ranks: each (point, slot) cell is then written by one rank only.
    """
    pt_s, slot = pt_s.long(), slot.long()
    y_d = torch.zeros((n_pt, max_deg, 6, 3), dtype=y_s.dtype, device=y_s.device)
    y_d = reduce(y_d.index_put_((pt_s, slot), y_s, accumulate=True))
    w_d = reduce(torch.zeros_like(y_d).index_put_((pt_s, slot), w_s, accumulate=True))
    # camera id per slot (-1 = empty); +1 trick keeps 0 a valid camera, and
    # an empty cell stays 0 in the sum over ranks
    cam_d = torch.zeros((n_pt, max_deg), dtype=torch.long, device=y_s.device)
    cam_d = reduce(cam_d.index_put_((pt_s, slot), cam_s.long() + 1, accumulate=True)) - 1

    s_acc = torch.zeros((n_cam * n_cam, 6, 6), dtype=y_s.dtype, device=y_s.device)
    for q0 in range(0, n_pt, chunk):
        y_c, w_c, cam_c = y_d[q0:q0 + chunk], w_d[q0:q0 + chunk], cam_d[q0:q0 + chunk]
        contrib = torch.einsum("qaij,qbkj->qabik", y_c, w_c)  # (Q, D, D, 6, 6)
        ok = (cam_c[:, :, None] >= 0) & (cam_c[:, None, :] >= 0)
        blk = cam_c.clamp(0, n_cam - 1)[:, :, None] * n_cam + cam_c.clamp(0, n_cam - 1)[:, None, :]
        s_acc.index_add_(
            0, blk.reshape(-1), torch.where(ok[..., None, None], contrib, 0.0).reshape(-1, 6, 6)
        )
    # (C*C, 6, 6) -> (6C, 6C)
    return s_acc.reshape(n_cam, n_cam, 6, 6).permute(0, 2, 1, 3).reshape(n_cam * 6, n_cam * 6)


def _damped(h: torch.Tensor, lam, n: int) -> torch.Tensor:
    """``h + lam * I * max(trace(h) / n, 1e-6)`` per (n, n) block."""
    tr = torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    return h + lam * eye * torch.clamp(tr[..., None, None] / float(n), min=1e-6)


def _pin_mask(n_cam: int, first_camera: bool, rotations: bool, device) -> torch.Tensor:
    """(6 * n_cam,) bool: the gauge's pinned unknowns — camera 0's six,
    and/or every camera's three rotation entries.  Built by filling slices
    on the device: an index list would cost a host-to-device copy, and
    with it a wait for the device, in every solver iteration."""
    pin = torch.zeros((n_cam, 6), dtype=torch.bool, device=device)
    if first_camera:
        pin[0] = True
    if rotations:
        pin[:, :3] = True
    return pin.reshape(-1)


def _pin(s: torch.Tensor, rhs: torch.Tensor, pin: torch.Tensor):
    """Gauge pins: the rows and columns of ``s`` that ``pin`` marks set to
    the identity's, their right-hand side to 0 (``.at[fix, :].set(0)``,
    ``.at[:, fix].set(0)``, ``.at[fix, fix].set(1)`` in JAX)."""
    eye = torch.eye(pin.shape[0], dtype=s.dtype, device=s.device)
    return torch.where(pin[:, None] | pin[None, :], eye, s), torch.where(pin, 0.0, rhs)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.solve`` for a vector right-hand side; a singular ``a``
    gives a non-finite result instead of an error."""
    return torch.linalg.solve_ex(a, b.unsqueeze(-1))[0].squeeze(-1)


def _inv(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.inv``; a singular block gives a non-finite result
    instead of an error."""
    return torch.linalg.inv_ex(a)[0]


def _schur_solve(
    p: BAProblem, r, jc, jp, n_cam, n_pt, damping,
    fix_rotations: bool = False, max_deg: int = 16, reduce=_no_reduce, slot_info=None,
):
    """One damped Gauss-Newton step (dc (C, 6), dx (P, 3)).  A sharded solve
    gives this rank's observations, pre-sorted by point, their global slot
    ranks ``slot_info``, and a ``reduce`` that sums over the ranks."""
    hcc, hpp, bc, bp = _assemble(p, r, jc, jp, n_cam, n_pt, reduce)
    cam, pt = p.obs_cam.long(), p.obs_pt.long()

    lam = damping
    hpp_inv = _inv(_damped(hpp, lam, 3))  # (P, 3, 3)

    # W blocks per observation: jc^T jp (6, 3); Y = W Hpp^-1 per observation
    w_obs = torch.einsum("nij,nik->njk", jc, jp)  # (N, 6, 3)
    y_obs = torch.einsum("njk,nkl->njl", w_obs, hpp_inv[pt])  # (N, 6, 3)
    # rhs correction: bc - sum_j W_j Hpp_j^-1 bp_j (a local partial sum,
    # reduced before it meets the already reduced bc)
    rhs_corr = reduce(_segment_sum(torch.einsum("njk,nk->nj", y_obs, bp[pt]), cam, n_cam)).reshape(-1)
    rhs = bc.reshape(-1) - rhs_corr

    # blocked Schur coupling over per-point slot tables
    if slot_info is None:
        order, pt_s, slot = _point_slots(p.obs_pt, max_deg)
        s_corr = _schur_corr_blocked(
            pt_s, p.obs_cam[order], y_obs[order], w_obs[order], n_cam, n_pt, slot, max_deg,
        )
    else:
        s_corr = _schur_corr_blocked(
            p.obs_pt, p.obs_cam, y_obs, w_obs, n_cam, n_pt, slot_info, max_deg, reduce=reduce,
        )

    hcc_d = _damped(hcc, lam, 6)
    s_full = torch.zeros((n_cam, 6, n_cam, 6), dtype=hcc.dtype, device=hcc.device)
    ar = torch.arange(n_cam, device=hcc.device)
    s_full[ar, :, ar, :] = hcc_d  # block_diag(*hcc_d)
    s_full = s_full.reshape(n_cam * 6, n_cam * 6) - s_corr

    # Gauge fix: pin camera 0 by pinning its 6 rows/cols to identity.
    # ``fix_rotations`` additionally pins every camera's rotation block —
    # the right gauge for the reference's translation-only grid rig, where
    # the narrow FOV makes small rotations nearly indistinguishable from
    # translations (the classic BA ambiguity).
    pin = _pin_mask(n_cam, True, fix_rotations, hcc.device)
    s_full, rhs = _pin(s_full, rhs, pin)

    dc = _solve(s_full, rhs).reshape(n_cam, 6)

    # Back-substitute points: dX = Hpp^-1 (bp - W^T dc)
    wt_dc = reduce(_segment_sum(torch.einsum("njk,nj->nk", w_obs, dc[cam]), pt, n_pt))
    dx = torch.einsum("pij,pj->pi", hpp_inv, bp - wt_dc)
    return dc, dx


def _check_max_deg(obs_pt: torch.Tensor, max_deg: int) -> None:
    """``max_deg`` silently MERGES Schur couplings for points observed more
    than ``max_deg`` times, degrading the solution with no error: check the
    true degree bound (one read of the device)."""
    true_deg = int(torch.bincount(obs_pt.long()).max()) if obs_pt.numel() else 0
    if true_deg > max_deg:
        raise ValueError(
            f"max_deg={max_deg} but a point has {true_deg} observations — "
            f"Schur couplings would be silently merged; pass "
            f"max_deg={true_deg} (run_sfm derives it from the match table)"
        )


def bundle_adjust(
    p: BAProblem, iters: int = 10, damping: float = 1e-3,
    fix_rotations: bool = False, max_deg: int = 16,
) -> BAProblem:
    """Levenberg-damped Gauss-Newton BA (single device).

    ``max_deg``: bound on observations per point (the slot width of the
    blocked Schur assembly) — pass the true maximum track length (checked
    before the first iteration).  A step is kept only where it lowers the
    RMS error, decided on the device."""
    _check_max_deg(p.obs_pt, max_deg)
    n_cam = p.aa.shape[0]
    n_pt = p.X.shape[0]
    prob = p
    for _ in range(iters):
        r, jc, jp = _obs_blocks(prob)
        dc, dx = _schur_solve(
            prob, r, jc, jp, n_cam, n_pt, damping,
            fix_rotations=fix_rotations, max_deg=max_deg,
        )
        new = prob._replace(aa=prob.aa + dc[:, :3], t=prob.t + dc[:, 3:], X=prob.X + dx)
        # accept only if error improves (cheap LM-style guard)
        better = rms_error(new) < rms_error(prob)
        prob = prob._replace(
            aa=torch.where(better, new.aa, prob.aa),
            t=torch.where(better, new.t, prob.t),
            X=torch.where(better, new.X, prob.X),
        )
    return prob


def observation_share(n_obs: int, n: int, t: int) -> tuple[int, int]:
    """Rank ``t``'s contiguous share ``[lo, hi)`` of ``n_obs`` observations
    over ``n`` ranks: ``ceil(n_obs / n)`` each, the last share short."""
    per = -(-n_obs // n)
    return min(t * per, n_obs), min((t + 1) * per, n_obs)


def _weighted_sq(p: BAProblem) -> torch.Tensor:
    """(sum of squared weighted residuals, sum of weights) of ``p``'s
    observations: the two sums of :func:`rms_error`."""
    r = residuals(p) * p.obs_w[:, None]
    return torch.stack([(r * r).sum(), p.obs_w.sum()])


def bundle_adjust_sharded(
    p: BAProblem, mesh, iters: int = 10, damping: float = 1e-3,
    fix_rotations: bool = False, max_deg: int = 16,
) -> BAProblem:
    """:func:`bundle_adjust` with the observations sharded over the mesh's
    ``view`` axis: every normal-equation block, slot table and partial sum
    is summed over the ranks with ``all_reduce``; the camera and point
    state is replicated and stays bitwise the same on every rank.

    The observations are sorted by point first, over all of them, so that
    each rank fills the blocked Schur slot tables with global slot ranks
    (each (point, slot) cell is written by one rank, and the sum restores
    the whole coupling, :func:`_schur_corr_blocked`).  Each rank then takes
    its contiguous share (:func:`observation_share`).  JAX pads the shares
    to one length with rows of point id ``n_pt`` and weight 0, which its
    scatters drop; here a share is just shorter, since PyTorch's scatters
    raise on an out-of-range id and nothing reduced depends on a share's
    length.  The accept test compares the RMS of the new and the old state
    from reduced sums, on the device (``torch.where``), so the ranks decide
    alike with no host wait.  The sums over ranks add in another order than
    one device's, so the result equals :func:`bundle_adjust`'s within
    rounding, not bitwise."""
    import torch.distributed as dist

    from cl_multiview_stereo_tpu_torch.parallel.mesh import axis_of

    _check_max_deg(p.obs_pt, max_deg)
    group, t, n = axis_of(mesh, "view")
    n_cam, n_pt = p.aa.shape[0], p.X.shape[0]

    def reduce(x: torch.Tensor) -> torch.Tensor:
        if n > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    order, pt_s, slot = _point_slots(p.obs_pt, max_deg)
    lo, hi = observation_share(p.obs_pt.shape[0], n, t)
    take = order[lo:hi]
    prob = p._replace(obs_cam=p.obs_cam[take], obs_pt=pt_s[lo:hi], obs_uv=p.obs_uv[take],
                      obs_w=p.obs_w[take])
    slot = slot[lo:hi]
    for _ in range(iters):
        r, jc, jp = _obs_blocks(prob)
        dc, dx = _schur_solve(
            prob, r, jc, jp, n_cam, n_pt, damping, fix_rotations=fix_rotations,
            max_deg=max_deg, reduce=reduce, slot_info=slot,
        )
        new = prob._replace(aa=prob.aa + dc[:, :3], t=prob.t + dc[:, 3:], X=prob.X + dx)
        sums = reduce(torch.stack([_weighted_sq(new), _weighted_sq(prob)]))
        rms = torch.sqrt(sums[:, 0] / (2.0 * torch.clamp(sums[:, 1], min=1.0)))
        better = rms[0] < rms[1]
        prob = prob._replace(
            aa=torch.where(better, new.aa, prob.aa),
            t=torch.where(better, new.t, prob.t),
            X=torch.where(better, new.X, prob.X),
        )
    return p._replace(aa=prob.aa, t=prob.t, X=prob.X)


def ate(t_est: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (RMSE of camera translations; gauge is
    already fixed to camera 0)."""
    d = t_est - t_gt
    return torch.sqrt(torch.mean((d * d).sum(-1)))


# ---------------------------------------------------------------------------
# Pose-graph backend
# ---------------------------------------------------------------------------
#
# Edges are dense arrays of fixed shape; per-edge 6-DoF residuals and their
# Jacobians come from ``jacfwd`` vmapped over the edge axis; the (6C x 6C)
# normal equations are assembled with segment sums over edge blocks and
# solved densely (cameras are few).  The camera grid's adjacency graph is
# full of 4-cycles, which gives the loop-closure structure.


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) (inverse of
    ``rodrigues`` away from theta = pi)."""
    # a trailing axis of 1 throughout: under vmap a 0-dim tensor combined
    # with a Python scalar gets a float64 tangent from forward AD
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )  # = axis * sin(theta)
    sin = torch.sin(theta)
    f = torch.where(theta < 1e-6, 1.0, theta / torch.where(sin == 0, 1.0, sin))
    return w * f


class PoseGraph(NamedTuple):
    """Relative-pose factor graph.  Edge e measures the i->j transform
    x_j = R(rel_aa[e]) x_i + rel_t[e] for (i, j) = edges[e]; ``w_rot`` /
    ``w_t`` weight the rotation / translation residual blocks.

    ``info``: optional (E, 6, 6) per-edge information matrices (e.g. the
    reduced camera Hessian of the two-view solve that produced the factor).
    When given it REPLACES the scalar weights."""

    edges: torch.Tensor  # (E, 2) int camera ids (i, j)
    rel_aa: torch.Tensor  # (E, 3) measured relative rotation (axis-angle)
    rel_t: torch.Tensor  # (E, 3) measured relative translation
    w_rot: torch.Tensor  # (E,)
    w_t: torch.Tensor  # (E,)
    info: torch.Tensor | None = None  # (E, 6, 6)


def _edge_info(g: PoseGraph) -> torch.Tensor:
    """(E, 6, 6) information matrices: explicit ``info`` or the scalar
    weights on the diagonal."""
    if g.info is not None:
        return g.info
    w6 = torch.cat([g.w_rot[:, None].repeat(1, 3), g.w_t[:, None].repeat(1, 3)], dim=1)
    return torch.diag_embed(w6)


def relative_from_absolute(
    aa: torch.Tensor, t: torch.Tensor, edges: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute world->camera poses -> exact relative i->j factors:
    R_ji = R_j R_i^T, t_ji = t_j - R_ji t_i."""
    R = rodrigues(aa)
    ei, ej = edges[:, 0].long(), edges[:, 1].long()
    Rji = torch.einsum("eij,ekj->eik", R[ej], R[ei])  # R_j R_i^T
    tji = t[ej] - torch.einsum("eij,ej->ei", Rji, t[ei])
    return so3_log(Rji), tji


def _pose_graph_residual(aa_i, t_i, aa_j, t_j, rel_aa, rel_t):
    """6-vector residual per edge: [log(Rbar^T R_j R_i^T); (t_j - R_ji
    t_i) - tbar]."""
    Ri = rodrigues(aa_i)
    Rj = rodrigues(aa_j)
    Rji = Rj @ Ri.transpose(-1, -2)
    Rbar = rodrigues(rel_aa)
    r_rot = so3_log(Rbar.transpose(-1, -2) @ Rji)
    r_t = (t_j - _matvec(Rji, t_i)) - rel_t
    return torch.cat([r_rot, r_t], -1)


def _edge_residuals(g: PoseGraph, aa: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    ei, ej = g.edges[:, 0].long(), g.edges[:, 1].long()
    return _pose_graph_residual(aa[ei], t[ei], aa[ej], t[ej], g.rel_aa, g.rel_t)


def pose_graph_residuals(g: PoseGraph, aa: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(E, 6) information-whitened residuals (L^T r with info = L L^T).  An
    edge whose information is not positive definite gets NaN, as XLA's
    Cholesky gives."""
    r = _edge_residuals(g, aa, t)
    W = _edge_info(g)
    L, fail = torch.linalg.cholesky_ex(W + 1e-12 * torch.eye(6, dtype=W.dtype, device=W.device))
    L = torch.where((fail == 0)[:, None, None], L, torch.nan)
    return torch.einsum("eji,ej->ei", L, r)


def pose_graph_optimize(
    g: PoseGraph,
    aa0: torch.Tensor,  # (C, 3)
    t0: torch.Tensor,  # (C, 3)
    iters: int = 10,
    damping: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton pose-graph optimization (camera 0 pinned as gauge).

    Returns the optimized (aa, t).  Dense (6C x 6C) solve per iteration —
    the right trade at camera-array scale (C <= a few hundred)."""
    n_cam = aa0.shape[0]
    dev, dt = aa0.device, aa0.dtype
    ei, ej = g.edges[:, 0].long(), g.edges[:, 1].long()
    W = _edge_info(g)  # (E, 6, 6)

    def res_fn(cam_vec, raa, rt):
        # cam_vec: (12,) = [aa_i, t_i, aa_j, t_j]
        return _pose_graph_residual(cam_vec[0:3], cam_vec[3:6], cam_vec[6:9], cam_vec[9:12], raa, rt)

    def cost(aa_, t_):
        # quadratic-form cost — no Cholesky, so singular info is fine
        r_ = _edge_residuals(g, aa_, t_)
        return torch.einsum("ei,eij,ej->", r_, W, r_)

    ids = torch.stack([ei * n_cam + ei, ei * n_cam + ej, ej * n_cam + ei, ej * n_cam + ej], dim=1)
    pin = _pin_mask(n_cam, True, False, dev)
    aa, t = aa0, t0
    for _ in range(iters):
        packed = torch.cat([aa[ei], t[ei], aa[ej], t[ej]], -1)  # (E, 12)
        r = _edge_residuals(g, aa, t)  # (E, 6)
        J = vmap(jacfwd(res_fn))(packed, g.rel_aa, g.rel_t)  # (E, 6, 12)
        Jw = torch.einsum("ers,esi->eri", W, J)  # (E, 6, 12)
        # normal equations: H += J^T W J scattered into the 4 (i/j, i/j)
        # 6x6 blocks; b -= J^T W r into the 2 camera rows
        h_blk = torch.einsum("eri,erj->eij", Jw, J)  # (E, 12, 12)
        b_blk = -torch.einsum("eri,er->ei", Jw, r)  # (E, 12)
        quads = torch.stack(
            [h_blk[:, 0:6, 0:6], h_blk[:, 0:6, 6:12], h_blk[:, 6:12, 0:6], h_blk[:, 6:12, 6:12]], dim=1
        )  # (E, 4, 6, 6)
        h_cells = _segment_sum(quads.reshape(-1, 6, 6), ids.reshape(-1), n_cam * n_cam)
        H = h_cells.reshape(n_cam, n_cam, 6, 6).permute(0, 2, 1, 3).reshape(n_cam * 6, n_cam * 6)
        b = _segment_sum(
            torch.cat([b_blk[:, 0:6], b_blk[:, 6:12]], dim=0), torch.cat([ei, ej]), n_cam
        ).reshape(-1)
        # damping scaled to the problem's curvature (info-weighted graphs
        # can be orders of magnitude off unit scale)
        H = H + (damping * torch.clamp(torch.trace(H) / (6.0 * n_cam), min=1e-12)) * torch.eye(
            n_cam * 6, dtype=dt, device=dev
        )
        H, b = _pin(H, b, pin)  # gauge: pin camera 0
        delta = _solve(H, b).reshape(n_cam, 6)
        aa_n, t_n = aa + delta[:, :3], t + delta[:, 3:]
        # accept only improving steps (same cheap LM guard as the BA)
        better = cost(aa_n, t_n) < cost(aa, t)
        aa, t = torch.where(better, aa_n, aa), torch.where(better, t_n, t)
    return aa, t


def _psd(info: torch.Tensor) -> torch.Tensor:
    """Nearest PSD matrix by clipping negative eigenvalues; a non-finite
    matrix stays NaN (``eigh`` would raise on it)."""
    finite = torch.isfinite(info).all(-1).all(-1)[:, None, None]
    evals, evecs = torch.linalg.eigh(torch.where(finite, info, 0.0))
    out = (evecs * torch.clamp(evals, min=0.0)[:, None, :]) @ evecs.transpose(-1, -2)
    return torch.where(finite, out, torch.nan)


def _two_view_residual(camp, Xp, ua, ub, intr):
    """(..., 4) reprojection residuals of a match's point ``Xp`` in camera i
    (identity) and camera j (``camp`` = [aa, t])."""
    zero = torch.zeros(3, dtype=Xp.dtype, device=Xp.device)
    ra = project(zero, zero, Xp, intr) - ua
    rb = project(camp[..., 0:3], camp[..., 3:6], Xp, intr) - ub
    return torch.cat([ra, rb], -1)


def _two_view_jacobians(camp, X, ua, ub, intr):
    """Jacobians of ``_two_view_residual`` for (E, 6) cameras and (E, M, 3)
    points: (E, M, 4, 6) and (E, M, 4, 3)."""
    n_e, m = X.shape[:2]
    flat = camp[:, None, :].expand(n_e, m, 6).reshape(-1, 6)
    jc, jp = vmap(jacfwd(_two_view_residual, argnums=(0, 1)), in_dims=(0, 0, 0, 0, None))(
        flat, X.reshape(-1, 3), ua.reshape(-1, 2), ub.reshape(-1, 2), intr
    )
    return jc.reshape(n_e, m, 4, 6), jp.reshape(n_e, m, 4, 3)


def two_view_relative(
    uv_a: torch.Tensor,  # (E, M, 2) matched pixels in view i
    uv_b: torch.Tensor,  # (E, M, 2) matched pixels in view j
    w: torch.Tensor,  # (E, M) match weights (0 = padding/outlier)
    intr: torch.Tensor,  # (4,)
    aa_seed: torch.Tensor,  # (E, 3) relative rotation seed
    t_seed: torch.Tensor,  # (E, 3) relative translation seed (sets the scale
    #                            gauge: the estimate is renormalized to
    #                            ||t_seed|| — monocular two-view scale is
    #                            unobservable)
    iters: int = 20,
    damping: float = 1e-3,
    fix_rotations: bool = False,
    outlier_px: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-edge two-view BA, batched over the edge axis: camera i pinned at
    identity, camera j's relative 6-DoF and the pair's M points free —
    Schur-eliminated like the global solver (H_pp is (M, 3, 3)
    block-diagonal, the reduced camera system is 6x6).  Returns
    ``(rel_aa, rel_t, info)`` — the measured relative factors a pose graph
    consumes plus their (E, 6, 6) information matrices (``PoseGraph.info``).

    ``fix_rotations``: pin the relative rotation at the seed (on a
    narrow-FOV translation rig a small rotation is observationally
    degenerate with a lateral translation)."""
    n_e, m = w.shape
    dev, dt = w.device, w.dtype

    # triangulate each edge's matches: camera i at identity, j at the seed
    # (the edges' camera pairs laid out side by side as cameras 2e, 2e+1)
    e_of = torch.arange(n_e, device=dev).repeat_interleave(m)
    X = triangulate(
        torch.stack([torch.zeros_like(aa_seed), aa_seed], 1).reshape(-1, 3),
        torch.stack([torch.zeros_like(t_seed), t_seed], 1).reshape(-1, 3),
        intr, torch.stack([2 * e_of, 2 * e_of + 1], -1), uv_a.reshape(-1, 2), uv_b.reshape(-1, 2),
    ).reshape(n_e, m, 3)
    X = torch.where(
        (torch.isfinite(X).all(-1) & (X[..., 2] > 1e-3))[..., None], X,
        torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev),
    )
    t_norm0 = _norm(t_seed)  # (E,)
    # scale-gauge pin INSIDE the solve: monocular two-view leaves ||t||
    # unobservable (a rank-1 null space that stalls GN); one penalty row
    # kappa*(||t|| - ||t_seed||) on the camera block conditions the reduced
    # 6x6 system
    kappa = torch.maximum(intr[0], intr[1])

    def res_all(camp, X_):
        # (E, 6), (E, M, 3) -> (E, M, 4)
        return _two_view_residual(camp[:, None, :], X_, uv_a, uv_b, intr)

    def jac_all(camp, X_):
        return _two_view_jacobians(camp, X_, uv_a, uv_b, intr)

    def scale_res(camp, tn0):
        return kappa * (_norm(camp[..., 3:6]) - tn0)

    camp = torch.cat([aa_seed, t_seed], -1)  # (E, 6)
    wm = w
    if outlier_px > 0.0:
        # same gate as run_sfm's global stage: a mutual-nearest match that
        # is far off at the SEED geometry is an outlier, and one bad match
        # dominates a 6-DoF least-squares fit
        r0 = res_all(camp, X)
        wm = wm * (_norm(r0.reshape(n_e, m, 2, 2)).amax(-1) < outlier_px).to(dt)

    rot = _pin_mask(1, False, True, dev)  # the relative rotation's three rows
    wv = wm[..., None]  # (E, M, 1)
    lam = torch.full((n_e,), damping, dtype=dt, device=dev)
    for _ in range(iters):
        # adaptive Levenberg damping per edge: the two-view cost surface is
        # a long narrow valley in f32 — a constant lambda stalls on its floor
        r = res_all(camp, X)  # (E, M, 4)
        jc, jp = jac_all(camp, X)
        jcw = jc * wv[..., None]
        jpw = jp * wv[..., None]
        hcc = torch.einsum("emri,emrj->eij", jcw, jc)  # (E, 6, 6)
        r_s = scale_res(camp, t_norm0)  # (E,)
        j_s = vmap(jacfwd(scale_res))(camp, t_norm0)  # (E, 6)
        hcc = hcc + j_s[:, :, None] * j_s[:, None, :]
        hpp = torch.einsum("emri,emrj->emij", jpw, jp)  # (E, M, 3, 3)
        hcp = torch.einsum("emri,emrj->emij", jcw, jp)  # (E, M, 6, 3)
        bc = -torch.einsum("emri,emr->ei", jcw, r) - j_s * r_s[:, None]
        bp = -torch.einsum("emri,emr->emi", jpw, r)
        hpp_inv = _inv(_damped(hpp, lam[:, None, None, None], 3))
        s = _damped(hcc, lam[:, None, None], 6) - torch.einsum("emij,emjk,emlk->eil", hcp, hpp_inv, hcp)
        rhs = bc - torch.einsum("emij,emjk,emk->ei", hcp, hpp_inv, bp)
        if fix_rotations:
            s, rhs = _pin(s, rhs, rot)
        dc = _solve(s, rhs)
        # back-substitute points: dX = Hpp^-1 (bp - Hcp^T dc)
        dX = torch.einsum("emij,emj->emi", hpp_inv, bp - torch.einsum("emij,ei->emj", hcp, dc))
        camp_n = camp + dc
        X_n = X + dX
        c_new = ((res_all(camp_n, X_n) * wv) ** 2).sum((1, 2)) + scale_res(camp_n, t_norm0) ** 2
        c_old = ((r * wv) ** 2).sum((1, 2)) + r_s ** 2
        better = c_new < c_old  # (E,)
        camp = torch.where(better[:, None], camp_n, camp)
        X = torch.where(better[:, None, None], X_n, X)
        lam = torch.clamp(torch.where(better, lam * 0.4, lam * 4.0), 1e-9, 1e3)

    # factor information = reduced camera Hessian at the solution
    # (reprojection terms only — no damping, no scale pin): directions this
    # pair never observed carry ~zero information into the graph
    jc, jp = jac_all(camp, X)
    wv4 = wm[..., None, None]
    hcc = torch.einsum("emri,emrj->eij", jc * wv4, jc)
    hpp = torch.einsum("emri,emrj->emij", jp * wv4, jp) + 1e-8 * torch.eye(3, dtype=dt, device=dev)
    hcp = torch.einsum("emri,emrj->emij", jc * wv4, jp)
    info = hcc - torch.einsum("emij,emjk,emlk->eil", hcp, _inv(hpp), hcp)
    info = 0.5 * (info + info.transpose(-1, -2))
    # PSD projection: the f32 Schur complement cancels ~f^2-scale terms, and
    # roundoff leaves slightly NEGATIVE eigenvalues — an indefinite
    # "information" matrix gives the pose graph descent directions that
    # COLLAPSE the rig
    info = _psd(info)
    # the monocular scale gauge leaves ~zero information ALONG the
    # translation direction; the factor's norm is pinned to the seed
    # baseline (a real prior), so that prior's curvature — the same kappa^2
    # row the solve used — must ride along
    t_hat = camp[:, 3:6] / torch.clamp(_norm(camp[:, 3:6], keepdim=True), min=1e-9)
    info = info.clone()
    info[:, 3:6, 3:6] += kappa * kappa * (t_hat[:, :, None] * t_hat[:, None, :])
    if fix_rotations:
        # the pinned rotation is rig-prior knowledge, not a two-view
        # measurement: give it weight comparable to the strongest
        # translation direction
        rot_w = torch.diagonal(info, dim1=-2, dim2=-1)[:, 3:6].amax(-1) + 1.0
        eye = torch.eye(6, dtype=dt, device=dev)
        info = torch.where(rot[:, None] | rot[None, :], eye * rot_w[:, None, None], info)

    aa_out, t_out = camp[:, 0:3], camp[:, 3:6]
    # scale gauge: renormalize to the seed baseline length
    norm = _norm(t_out)
    scale = torch.where(norm > 1e-9, t_norm0 / norm, 1.0)
    return aa_out, t_out * scale[:, None], info
