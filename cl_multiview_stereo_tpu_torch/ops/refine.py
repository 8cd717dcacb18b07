"""Superpixel plane refinement (port of ``cl_multiview_stereo_tpu/ops/refine.py``).

Flatness, state init and PatchMatch propagation (``clcode.cl:1076-1900``),
structured as in the JAX module: within one Jacobi sweep the input state is
frozen, so every move-independent quantity (smoothness taps, the rasterized
input state, the update-move candidate planes) is built once per sweep, all
candidate moves are scored in batches, and the acceptance chain then runs
over the precomputed scores in the reference's move order.

The JAX ``lax.scan`` chains are Python loops here; the batch of moves
scored together is the explicit ``score_chunk`` argument.  Only the
``"packed"`` pair layout and the ``"gather"`` consistency engine are
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.ops.fusion import gather_cells, plane_disparity
from cl_multiview_stereo_tpu_torch.ops.superpixel import consistency_samples
from cl_multiview_stereo_tpu_torch.utils.timing import maybe_stage

_MARGIN = 0.01
_EPS_SM = 0.000001
# Smallest normal float32.  The JAX reference runs with subnormals flushed
# to zero (XLA on the CPU and the TPU both do); torch keeps them on the CPU
# and on CUDA.  A weight that underflows to a subnormal instead of 0 flips
# ``wn > 0`` and the accept products, so every exp and product feeding
# those decisions is flushed explicitly (:func:`_ftz`).
_FLT_MIN = float(torch.finfo(torch.float32).tiny)
# Moves scored together: bounds the (C, P, Mh, 9, Mw) consistency
# temporaries to about C x 50 MB each at 1080p x 9 views.
SCORE_CHUNK = 4


class RefineState(NamedTuple):
    """The reference's per-superpixel state (cl:1398-1403)."""

    d: torch.Tensor  # (V, Mh, Mw)
    sm: torch.Tensor  # (V, Mh, Mw)
    cs: torch.Tensor  # (V, Mh, Mw)
    n: torch.Tensor  # (V, Mh, Mw, 3)


class RefineContext(NamedTuple):
    """Per-scene tensors shared by every scoring call."""

    center: torch.Tensor  # (V, Mh, Mw, 2) float32
    color: torch.Tensor  # (V, Mh, Mw, 3) float32 Lab
    disp0: torch.Tensor  # (V, Mh, Mw) float32 initial disparity
    labels: torch.Tensor  # (V, H, W) int32
    samples: torch.Tensor  # (V, Mh, 9, Mw, 2) int32 consistency offsets
    fl: torch.Tensor  # (V, Mh, Mw, 2) float32 flatness weights
    ras_color: torch.Tensor  # (V*H*W, 3) float32 owning superpixel's colour


def make_context(center, color, disp0, labels, extent, fl) -> RefineContext:
    """The neighbour views come with the static ``pairs`` list of each
    scoring call (:func:`pairs_from_subsets`), not from the context."""
    return RefineContext(
        center=center,
        color=color,
        disp0=disp0,
        labels=labels,
        samples=consistency_samples(extent).movedim(3, 2).contiguous(),
        fl=fl,
        ras_color=gather_cells(labels, color).reshape(-1, 3),
    )


# ---------------------------------------------------------------------------
# Flatness (cl:1076-1132)
# ---------------------------------------------------------------------------


def _sqdist3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over a trailing 3-channel axis, summed in order."""
    return (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2 + (a[..., 2] - b[..., 2]) ** 2


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to zero, as the JAX reference's arithmetic does."""
    return torch.where(torch.abs(x) < _FLT_MIN, 0.0, x)


def _grid(mh: int, mw: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(col, row) index grids of shape (1, Mh, Mw), int64."""
    row, col = torch.meshgrid(
        torch.arange(mh, device=device), torch.arange(mw, device=device), indexing="ij"
    )
    return col[None], row[None]


def compute_flatness(color: torch.Tensor, gamma: float) -> torch.Tensor:
    """``color`` (V, Mh, Mw, 3) -> (V, Mh, Mw, 2) = (fl, i_fl)."""
    v, mh, mw = color.shape[:3]
    col, row = _grid(mh, mw, color.device)
    fl = torch.ones((v, mh, mw), dtype=torch.float32, device=color.device)
    for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
        shifted = torch.roll(color, shifts=(-dy, -dx), dims=(1, 2))
        ok = (col + dx >= 0) & (col + dx < mw) & (row + dy >= 0) & (row + dy < mh)
        fl = fl + torch.where(ok, _sqdist3(shifted, color), 0.0)
    return torch.stack([torch.exp(-fl * gamma), 1.0 - torch.exp(-0.25 * fl * gamma)], dim=-1)


# ---------------------------------------------------------------------------
# Iteration cache
# ---------------------------------------------------------------------------


class IterCache(NamedTuple):
    """Move-independent data for one Jacobi sweep (input state frozen)."""

    tap_ax: torch.Tensor  # (V, Mh, Mw, T) cx - tap_cx
    tap_ay: torch.Tensor  # (V, Mh, Mw, T) cy - tap_cy
    tap_d: torch.Tensor  # (V, Mh, Mw, T) input-state disparity at the tap
    tap_sim: torch.Tensor  # (V, Mh, Mw, T) similarity weight (0 if invalid)
    wn: torch.Tensor  # (V, Mh, Mw) weight normalizer
    ras: torch.Tensor  # (V*H*W, 4) [state disparity, Lab colour] per pixel
    ring_dcx: torch.Tensor  # (V, Mh, Mw, 8) ring-neighbour cx - cx
    ring_dcy: torch.Tensor  # (V, Mh, Mw, 8)
    ring_d: torch.Tensor  # (V, Mh, Mw, 8) input-state d at the ring neighbour
    ring_ok: torch.Tensor  # (V, Mh, Mw, 8) bool


# Ring neighbour order of the refinement stage (cl:1865-1873), (dx, dy).
_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))
# Immediate-neighbour tap order (cl:1144): i (x) outer, j (y) inner.
_IMM = tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if not (i == 0 and j == 0))


def _roll_cells(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[v, y, x] = a[v, y + dy, x + dx], wrapped (callers mask the wrap)."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))


def _rasterize_flat(ctx: RefineContext, state_d, state_n) -> torch.Tensor:
    """``spixl_to_image`` of the input state (cl:1906-1931) packed with the
    per-pixel superpixel colour: (V*H*W, 4)."""
    pack = torch.cat([ctx.center, state_d[..., None], state_n], dim=-1)
    disp = plane_disparity(gather_cells(ctx.labels, pack))
    return torch.cat([disp.reshape(-1, 1), ctx.ras_color], dim=-1)


def build_cell_cache(
    ctx: RefineContext, tgt_d: torch.Tensor, *, gamma: float, steps: int, step_size: float
) -> IterCache:
    """Smoothness taps and ring data of one sweep; ``ras`` is left empty."""
    v, mh, mw = tgt_d.shape
    dev = tgt_d.device
    center, color = ctx.center, ctx.color
    col, row = _grid(mh, mw, dev)
    packed = torch.cat([center, color, tgt_d[..., None]], dim=-1)  # (V, Mh, Mw, 6)

    # 8 immediate taps at static cell offsets
    tap_parts, g_list, ok_list = [], [], []
    for dx, dy in _IMM:
        tap_parts.append(_roll_cells(packed, dx, dy))
        ok = (col + dx >= 0) & (row + dy >= 0) & (col + dx < mw) & (row + dy < mh)
        g_list.append(gamma)
        ok_list.append(ok.expand(v, mh, mw))
    tap = torch.stack(tap_parts, dim=-2)

    # 4 * steps long-range taps at flatness-scaled pitch
    # (cl:1169 / cl:1437: step_sz = max(1, (int)(fl.x*kss + 0.5)))
    if steps > 0:
        step_sz = torch.clamp((ctx.fl[..., 0] * step_size + 0.5).to(torch.int64), min=1)
        colb, rowb = col.expand(v, mh, mw), row.expand(v, mh, mw)
        tx_list, ty_list = [], []
        for i in range(1, steps + 1):
            step = i * step_sz
            off = step + 1
            for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1)):  # L R U D
                if axis == 0:
                    tx, ty = colb + sign * off, rowb
                    ok = (colb > step) if sign < 0 else (colb < mw - step - 1)
                else:
                    tx, ty = colb, rowb + sign * off
                    ok = (rowb > step) if sign < 0 else (rowb < mh - step - 1)
                tx_list.append(tx)
                ty_list.append(ty)
                g_list.append(gamma * (1 + i))
                ok_list.append(ok)
        tx = torch.stack(tx_list, dim=-1)
        ty = torch.stack(ty_list, dim=-1)
        vid = torch.arange(v, device=dev)[:, None, None, None]
        flat = vid * (mh * mw) + ty.clamp(0, mh - 1) * mw + tx.clamp(0, mw - 1)
        lr = packed.reshape(-1, 6)[flat]  # (V, Mh, Mw, 4*steps, 6)
        tap = torch.cat([tap, lr], dim=-2)

    ok = torch.stack(ok_list, dim=-1)
    gammas = torch.tensor(g_list, dtype=torch.float32, device=dev)
    cdiff = _sqdist3(color[..., None, :], tap[..., 2:5])
    tap_sim = torch.where(ok, _ftz(torch.exp(-cdiff * gammas)), 0.0)

    rpack = torch.stack([_roll_cells(packed, dx, dy) for dx, dy in _RING], dim=-2)
    rtx = torch.stack([(col + dx).expand(1, mh, mw) for dx, _ in _RING], dim=-1)
    rty = torch.stack([(row + dy).expand(1, mh, mw) for _, dy in _RING], dim=-1)
    rok = (rtx >= 0) & (rty >= 0) & (rtx < mw) & (rty < mh)
    return IterCache(
        tap_ax=center[..., 0:1] - tap[..., 0],
        tap_ay=center[..., 1:2] - tap[..., 1],
        tap_d=tap[..., 5],
        tap_sim=tap_sim,
        wn=tap_sim.sum(dim=-1),
        ras=torch.zeros((1, 4), dtype=torch.float32, device=dev),
        ring_dcx=rpack[..., 0] - center[..., 0:1],
        ring_dcy=rpack[..., 1] - center[..., 1:2],
        ring_d=rpack[..., 5],
        ring_ok=rok.expand(v, mh, mw, 8),
    )


def _fronto_normals(d: torch.Tensor) -> torch.Tensor:
    n = torch.zeros(d.shape + (3,), dtype=torch.float32, device=d.device)
    n[..., 2] = 1.0
    return n


def build_cache(
    ctx: RefineContext, tgt_d, state_n, *, gamma: float, steps: int, step_size: float
) -> IterCache:
    """Every move-independent quantity of one sweep.  ``state_n=None``
    means fronto-parallel normals (the init forms)."""
    cache = build_cell_cache(ctx, tgt_d, gamma=gamma, steps=steps, step_size=step_size)
    if state_n is None:
        state_n = _fronto_normals(tgt_d)
    return cache._replace(ras=_rasterize_flat(ctx, tgt_d, state_n))


# ---------------------------------------------------------------------------
# Scoring from the cache.  d0/n0 may carry leading batch axes (moves).
# ---------------------------------------------------------------------------


def smoothness_from_cache(cache: IterCache, d0, n0, *, alpha: float) -> torch.Tensor:
    """cl:1136-1254 / cl:1407-1525: ``d_intrp = (n.(c - c_tap) + nz*d0)/nz``
    per tap, weighted by the move-independent similarities."""
    nx, ny, nz = n0[..., 0:1], n0[..., 1:2], n0[..., 2:3]
    d_intrp = (nx * cache.tap_ax + ny * cache.tap_ay + nz * d0[..., None]) / nz
    diff = d_intrp - cache.tap_d
    sm = torch.sum(_ftz(cache.tap_sim * _ftz(torch.exp(-diff * diff * alpha))), dim=-1)
    return torch.where(cache.wn > 0, _ftz(sm / cache.wn), _EPS_SM)


def _cl_round(x: torch.Tensor) -> torch.Tensor:
    """OpenCL round(): half away from zero (torch.round rounds half to even)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def pairs_from_subsets(view_subset, array_width: int) -> tuple:
    """Static (ref, view, dvx, dvy) pair list from a -1 padded (V, max_n)
    subset table, in the reference's enumeration order (pipeline.cpp:130-142)."""
    vs = np.asarray(view_subset)
    pairs = []
    for z in range(vs.shape[0]):
        for k in range(vs.shape[1]):
            if vs[z, k] >= 0:
                n = int(vs[z, k])
                pairs.append((
                    z, n,
                    float(n % array_width - z % array_width),
                    float(n // array_width - z // array_width),
                ))
    return tuple(pairs)


def consistency_from_cache(
    ctx: RefineContext,
    cache: IterCache,
    d0: torch.Tensor,  # (B, V, Mh, Mw)
    n0: torch.Tensor,  # (B, V, Mh, Mw, 3)
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    pairs: tuple,
) -> torch.Tensor:
    """cl:1260-1357 / cl:1528-1631, packed pair layout: the stored-plane
    interpolation at the projected pixel equals the rasterized input state
    there, so each (pair, sample) is one row of ``cache.ras``.  Per-view
    sums run over the pairs in subset order.  Returns (B, V, Mh, Mw)."""
    h, w = ctx.labels.shape[1:3]
    b, v = d0.shape[:2]
    dev = d0.device
    if len(pairs) == 0:
        return torch.full(d0.shape, _MARGIN, dtype=torch.float32, device=dev)

    refs_np = np.asarray([p[0] for p in pairs], np.int64)
    bounds = np.searchsorted(refs_np, np.arange(v + 1))
    refs = torch.as_tensor(refs_np, device=dev)
    nbrs = torch.tensor([p[1] for p in pairs], dtype=torch.int64, device=dev)
    dvx = torch.tensor([p[2] for p in pairs], dtype=torch.float32, device=dev)[:, None, None, None]
    dvy = torch.tensor([p[3] for p in pairs], dtype=torch.float32, device=dev)[:, None, None, None]

    # sample axis at -2: (V, Mh, 9, Mw)
    cx = ctx.center[..., 0][:, :, None, :]
    cy = ctx.center[..., 1][:, :, None, :]
    sx = cx.to(torch.int64) + ctx.samples[..., 0]
    sy = cy.to(torch.int64) + ctx.samples[..., 1]
    nx = n0[..., 0].unsqueeze(-2)  # (B, V, Mh, 1, Mw)
    ny = n0[..., 1].unsqueeze(-2)
    nz = n0[..., 2].unsqueeze(-2)
    d_intrp = (
        nx * (cx - sx.to(torch.float32))
        + ny * (cy - sy.to(torch.float32))
        + nz * d0.unsqueeze(-2)
    ) / nz  # (B, V, Mh, 9, Mw)

    dip = d_intrp[:, refs]  # (B, P, Mh, 9, Mw)
    xp = sx[refs] - _cl_round(dip * dvx).to(torch.int64)
    yp = sy[refs] - _cl_round(bl_ratio * dip * dvy).to(torch.int64)
    inbf = ((xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)).to(torch.float32)
    flat = nbrs[:, None, None, None] * (h * w) + yp.clamp(0, h - 1) * w + xp.clamp(0, w - 1)
    del xp, yp
    g = cache.ras[flat]  # (B, P, Mh, 9, Mw, 4)
    del flat

    diff = g[..., 0] - dip
    when_visible = (torch.abs(diff) < fuse).to(torch.float32)
    visible = torch.sum(inbf * when_visible * _ftz(torch.exp(-diff * diff * alpha)), dim=-2)
    visib_sum = torch.sum(inbf * when_visible, dim=-2)
    occl_sum = torch.sum(inbf * (1.0 - when_visible), dim=-2)
    del diff, when_visible
    colp = ctx.color[refs]  # (P, Mh, Mw, 3)
    cdiff = sum((g[..., 1 + c] - colp[..., c][:, :, None, :]) ** 2 for c in range(3))
    del g
    visibility = torch.sum(inbf * _ftz(torch.exp(-cdiff * gamma)), dim=-2)
    num = torch.sum(inbf, dim=-2)  # (B, P, Mh, Mw)

    contrib = torch.where(
        visib_sum > 0,
        _ftz(
            (visib_sum / torch.clamp(num, min=1.0))
            * (visibility / torch.clamp(visib_sum, min=1e-30))
            * (visible / torch.clamp(visib_sum, min=1e-30))
        ),
        0.0,
    )
    contrib = contrib + torch.where(occl_sum > 0, 0.5 * ctx.fl[..., 1][refs], 0.0)
    has = (num > 0).to(torch.float32)

    # per-view aggregation in subset order (sequential adds)
    cons_rows, cnt_rows = [], []
    zero = torch.zeros((b,) + tuple(d0.shape[2:]), dtype=torch.float32, device=dev)
    for z in range(v):
        lo, hi = int(bounds[z]), int(bounds[z + 1])
        if lo == hi:
            cons_rows.append(zero)
            cnt_rows.append(zero)
            continue
        acc, cnt = contrib[:, lo], has[:, lo]
        for p in range(lo + 1, hi):
            acc = acc + contrib[:, p]
            cnt = cnt + has[:, p]
        cons_rows.append(acc)
        cnt_rows.append(cnt)
    consistency = torch.stack(cons_rows, dim=1)
    view_counter = torch.stack(cnt_rows, dim=1)
    return torch.where(
        view_counter > 0,
        torch.clamp(consistency / torch.clamp(view_counter, min=1.0), min=_MARGIN),
        _MARGIN,
    )


# ---------------------------------------------------------------------------
# State init (cl:1362-1404)
# ---------------------------------------------------------------------------


def init_state(
    ctx: RefineContext,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    steps: int,
    step_size: float,
    pairs: tuple,
) -> RefineState:
    """``init_current_state``: score the initial fronto-parallel planes."""
    d0 = ctx.disp0
    n0 = _fronto_normals(d0)
    cache = build_cache(ctx, d0, None, gamma=gamma, steps=steps, step_size=step_size)
    sm = smoothness_from_cache(cache, d0, n0, alpha=alpha)
    cs = consistency_from_cache(
        ctx, cache, d0[None], n0[None], gamma=gamma, alpha=alpha, fuse=fuse,
        bl_ratio=bl_ratio, pairs=pairs,
    )[0]
    return RefineState(d=d0, sm=sm, cs=cs, n=n0)


# ---------------------------------------------------------------------------
# Propagation (cl:1727-1900)
# ---------------------------------------------------------------------------


def _update_move_offsets(steps: int, step_size: float, mw: int, mh: int) -> list[tuple[int, int]]:
    """(dx, dy) of the ``update`` moves in reference order: 8 immediate
    (i outer = x), then per reach step UP, DOWN, LEFT, RIGHT at pitch
    ``(int)step_size`` (cl:1768-1857).  Offsets past the map can never pass
    the bounds guard (cl:1797-1842) and are dropped."""
    offs = list(_IMM)
    pitch = int(step_size)
    for i in range(1, steps + 1):
        off = i * pitch + 1
        offs += [(0, -off), (0, off), (-off, 0), (off, 0)]
    return [(dx, dy) for dx, dy in offs if abs(dx) < mw and abs(dy) < mh]


def _cross(v1, v2):
    """Device ``cross_product_test`` (cl:1676-1685)."""
    return (
        v1[1] * v2[2] - v1[2] * v2[1],
        v2[0] * v1[2] - v1[0] * v2[2],
        v1[0] * v2[1] - v1[1] * v2[0],
    )


def gather_update_moves(ctx: RefineContext, state_in: RefineState, offs, gamma: float):
    """Candidate planes of the ``update`` moves (cl:1649): each offset's
    neighbour plane extrapolated to the home centre, its colour similarity
    and validity.  Returns (d_adopt, n1x, n1y, n1z, sim, ok), each
    (V, Mh, Mw, M)."""
    v, mh, mw = state_in.d.shape
    center = ctx.center
    col, row = _grid(mh, mw, center.device)
    dxs = torch.tensor([o[0] for o in offs], device=center.device)
    dys = torch.tensor([o[1] for o in offs], device=center.device)
    tx = col[..., None] + dxs
    ty = row[..., None] + dys
    ok_m = ((tx >= 0) & (ty >= 0) & (tx < mw) & (ty < mh)).expand(v, mh, mw, len(offs))
    packed = torch.cat([center, ctx.color, state_in.d[..., None], state_in.n], dim=-1)
    nb = torch.stack([_roll_cells(packed, dx, dy) for dx, dy in offs], dim=-2)  # (V, Mh, Mw, M, 9)
    n1x, n1y, n1z = nb[..., 6], nb[..., 7], nb[..., 8]
    d_adopt = (
        n1x * (nb[..., 0] - center[..., 0:1])
        + n1y * (nb[..., 1] - center[..., 1:2])
        + n1z * nb[..., 5]
    ) / n1z
    sim_m = _ftz(torch.exp(-_sqdist3(ctx.color[..., None, :], nb[..., 2:5]) * gamma))
    return d_adopt, n1x, n1y, n1z, sim_m, ok_m


def propagate_iteration(
    ctx: RefineContext,
    state_in: RefineState,
    it: int,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    steps: int,
    step_size: float,
    pairs: tuple,
    score_chunk: int = SCORE_CHUNK,
) -> RefineState:
    """One Jacobi sweep: every superpixel walks the move chain, scoring
    candidate planes against the frozen input state
    (depth_refinement.cpp:744-753)."""
    mh, mw = state_in.d.shape[1:]
    greedy = it < 4  # cl:1663 / cl:1713
    cache = build_cache(
        ctx, state_in.d, state_in.n, gamma=gamma, steps=steps, step_size=step_size
    )
    offs = _update_move_offsets(steps, step_size, mw, mh)
    d_adopt, n1x, n1y, n1z, sim_m, ok_m = gather_update_moves(ctx, state_in, offs, gamma)

    def score(d_c, n_c):
        """(M, V, Mh, Mw), (M, V, Mh, Mw, 3) -> (sm1, cs1), each (M, V, Mh, Mw).
        A candidate's scores depend only on it and the frozen input state."""
        sm_parts, cs_parts = [], []
        for k in range(0, d_c.shape[0], score_chunk):
            dci, nci = d_c[k:k + score_chunk], n_c[k:k + score_chunk]
            sm_parts.append(smoothness_from_cache(cache, dci, nci, alpha=alpha))
            cs_parts.append(consistency_from_cache(
                ctx, cache, dci, nci, gamma=gamma, alpha=alpha, fuse=fuse,
                bl_ratio=bl_ratio, pairs=pairs,
            ))
        return torch.cat(sm_parts), torch.cat(cs_parts)

    mv = lambda a: a.movedim(-1, 0)  # noqa: E731  (move axis leads)
    d_upd = mv(d_adopt)
    n_upd = torch.stack([mv(n1x), mv(n1y), mv(n1z)], dim=-1)
    sm1_upd, cs1_upd = score(d_upd, n_upd)
    sim_upd, ok_upd = mv(sim_m), mv(ok_m)

    d0, sm0, cs0, n0 = state_in.d, state_in.sm, state_in.cs, state_in.n
    # update moves, in order (cl:1779-1857)
    for k in range(len(offs)):
        sm1, cs1 = sm1_upd[k], cs1_upd[k]
        cond = _ftz(cs1 * sm1) > _ftz(sm0 * cs0)
        if greedy:
            cond = cond | (_ftz(sm1 * sim_upd[k]) > sm0)
        accept = ok_upd[k] & cond
        d0 = torch.where(accept, d_upd[k], d0)
        sm0 = torch.where(accept, sm1, sm0)
        cs0 = torch.where(accept, cs1, cs0)
        n0 = torch.where(accept[..., None], n_upd[k], n0)

    # spatial refinement: d is frozen, only the normal is re-fit through
    # two ring neighbours (cl:1687-1723, cl:1865-1891)
    n_ref, ok_ref = [], []
    for r in range(8):
        r2 = (r + 1) % 8
        v1 = (cache.ring_dcx[..., r], cache.ring_dcy[..., r], cache.ring_d[..., r] - d0)
        v2 = (cache.ring_dcx[..., r2], cache.ring_dcy[..., r2], cache.ring_d[..., r2] - d0)
        cx_, cy_, cz_ = _cross(v1, v2)
        norm = torch.sqrt(cx_ * cx_ + cy_ * cy_ + cz_ * cz_)
        n_ref.append(torch.stack([cx_ / norm, cy_ / norm, cz_ / norm], dim=-1))
        ok_ref.append(cache.ring_ok[..., r] & cache.ring_ok[..., r2])
    n_ref = torch.stack(n_ref)
    sm1_ref, cs1_ref = score(d0[None].expand((8,) + tuple(d0.shape)), n_ref)
    for r in range(8):
        sm1, cs1 = sm1_ref[r], cs1_ref[r]
        cond = _ftz(sm1 * cs1) > _ftz(sm0 * cs0)
        if greedy:
            cond = cond | (sm1 > sm0)
        accept = ok_ref[r] & cond
        sm0 = torch.where(accept, sm1, sm0)
        cs0 = torch.where(accept, cs1, cs0)
        n0 = torch.where(accept[..., None], n_ref[r], n0)
    return RefineState(d=d0, sm=sm0, cs=cs0, n=n0)


def refine(
    ctx: RefineContext,
    schedule,
    *,
    pairs: tuple,
    pair_layout: str = "packed",
    cons_engine: str = "gather",
    score_chunk: int = SCORE_CHUNK,
    timer=None,
) -> RefineState:
    """Init state, then ``no_prop`` Jacobi sweeps with decaying reach
    (depth_refinement.cpp:105-106, 767-769).  ``timer``: an optional
    ``utils.timing.StageTimer`` for the init and propagate stages."""
    if pair_layout != "packed":
        raise NotImplementedError(f"pair_layout={pair_layout!r} is not ported yet")
    if cons_engine != "gather":
        raise NotImplementedError(f"cons_engine={cons_engine!r} is not ported yet")
    kw = dict(
        gamma=schedule.gamma_eff,
        alpha=schedule.alpha_eff,
        fuse=schedule.fuse_eff,
        bl_ratio=schedule.bl_ratio,
        pairs=pairs,
    )
    with maybe_stage(timer, "init_state"):
        state = init_state(
            ctx, **kw, steps=schedule.kernel_steps, step_size=schedule.sp_kernel_step
        )
    for it in range(schedule.no_prop):
        with maybe_stage(timer, "propagate"):
            state = propagate_iteration(
                ctx, state, it, **kw,
                steps=schedule.steps_per_iter[it],
                step_size=schedule.step_size_per_iter[it],
                score_chunk=score_chunk,
            )
    return state
