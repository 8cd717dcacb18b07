"""Superpixel plane refinement (port of ``cl_multiview_stereo_tpu/ops/refine.py``).

Flatness, state init and PatchMatch propagation (``clcode.cl:1076-1900``),
structured as in the JAX module: within one Jacobi sweep the input state is
frozen, so every move-independent quantity (smoothness taps, the rasterized
input state, the update-move candidate planes) is built once per sweep, all
candidate moves are scored in batches, and the acceptance chain then runs
over the precomputed scores in the reference's move order.

The JAX ``lax.scan`` chains are Python loops here; the batch of moves
scored together is the explicit ``score_chunk`` argument.  The gather
engine scores the static pair list as one packed batch.  JAX's other pair
layout, ``"view"``, regroups the pairs into per-view slots so that its
temporaries shard with a view mesh, and is bitwise equal to packed.  The
port runs the packed scorer for either: its view-sharded pipeline
(``parallel/sharded_pipeline``) filters the pairs to each rank's own
reference views, which is the job the view layout does in JAX.  The move
chain of a sweep (:func:`move_chain`) and its scorer (:func:`score_moves`)
are shared with the row-sharded refinement (``parallel/spatial``) and the
view-sharded pipeline, so the accept rule lives here only.
Consistency is scored by the ``"gather"`` engine (:func:`consistency_from_cache`)
or by the ``"strips"`` engine, which differs only for candidates whose
disparity is not finite; ``"strips_xla"`` names the same function as
``"strips"``, since its lane resolve differs from Pallas only on a TPU.
Both go through ``ops/consistency.consistency_moves``: on the CPU its plain
twin (per ``score_chunk`` batch of moves), on a card one launch of the CUDA
kernel for all moves of a phase, under the engine's rule.  Smoothness goes
the same way through ``ops/smoothness``: the sweep's cache
(:func:`build_cell_cache` on the CPU, its T-wide tap fields and a 32-byte
row a cell of the whole map, ``cell_table``) and the scores of all moves of
a phase (:func:`smoothness_from_cache` per ``score_chunk`` batch on the
CPU), each one launch of ``csrc/smoothness.cu`` on a card, whose cache is
the table alone and whose scorer derives each tap from it.  Both plain
forms add their taps one at a time in tap order (:func:`_sum_taps`), the
order the kernels keep.  The rest of a sweep goes the same way: the
rasterized table (:func:`rasterize_table`, ``ops/raster``), the update
moves' candidates (:func:`update_candidates`) and the move chain's two
accept walks (:func:`move_chain`, ``ops/chain``), each the plain form
beside it (``*_reference``) on the CPU and one launch of
``csrc/raster.cu`` or ``csrc/chain.cu`` on a card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.ops.fusion import cl_round, gather_cells, plane_disparity
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
CONS_ENGINES = ("gather", "strips", "strips_xla")
PAIR_LAYOUTS = ("packed", "view")


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
    """Move-independent data for one Jacobi sweep (input state frozen), for
    the cells of rows ``row0`` .. of the map (every row, or a band).  The
    plain form (:func:`build_cell_cache`) fills every field; the card's
    cache (``ops/smoothness``) leaves the T-wide tap fields and ``wn``
    None, since its moves kernel scores each tap from ``cell_table``."""

    tap_ax: torch.Tensor | None  # (V, rows, Mw, T) cx - tap_cx
    tap_ay: torch.Tensor | None  # (V, rows, Mw, T) cy - tap_cy
    tap_d: torch.Tensor | None  # (V, rows, Mw, T) input-state disparity at the tap
    tap_sim: torch.Tensor | None  # (V, rows, Mw, T) similarity weight (0 if invalid)
    wn: torch.Tensor | None  # (V, rows, Mw) weight normalizer
    ras: torch.Tensor  # (V*H*W, 4) [state disparity, Lab colour] per pixel
    ring_dcx: torch.Tensor  # (V, rows, Mw, 8) ring-neighbour cx - cx
    ring_dcy: torch.Tensor  # (V, rows, Mw, 8)
    ring_d: torch.Tensor  # (V, rows, Mw, 8) input-state d at the ring neighbour
    ring_ok: torch.Tensor  # (V, rows, Mw, 8) bool
    # (V, Mh, Mw, 8) of the whole map, 32 bytes a cell: [cx, cy, L, a, b,
    # input-state d, step_sz (float32 of the long taps' integer pitch), 0]
    cell_table: torch.Tensor
    gammas: torch.Tensor  # (T,) float32 similarity weight of each tap (tap_gammas)
    row0: int  # the map row of the cells' first row


# Ring neighbour order of the refinement stage (cl:1865-1873), (dx, dy).
_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))
# Immediate-neighbour tap order (cl:1144): i (x) outer, j (y) inner.
_IMM = tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if not (i == 0 and j == 0))


def _roll_cells(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[v, y, x] = a[v, y + dy, x + dx], wrapped (callers mask the wrap)."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))


def rasterize_table_reference(labels, center, ras_color, state_d, state_n, row0: int = 0) -> torch.Tensor:
    """``spixl_to_image`` of the input state (cl:1906-1931) for the pixel
    rows ``labels`` holds (the image's rows from ``row0``), packed with
    each pixel's superpixel colour ``ras_color``: (V*rows*W, 4).  The plain
    form of ``ops/raster.table``, on any device."""
    pack = torch.cat([center, state_d[..., None], state_n], dim=-1)
    disp = plane_disparity(gather_cells(labels, pack), row0)
    return torch.cat([disp.reshape(-1, 1), ras_color], dim=-1)


def rasterize_table(labels, center, ras_color, state_d, state_n, row0: int = 0) -> torch.Tensor:
    """:func:`rasterize_table_reference`'s table: one launch of
    ``csrc/raster.cu`` on a card, the plain form on the CPU
    (``ops/raster.table``)."""
    from cl_multiview_stereo_tpu_torch.ops import raster

    return raster.table(labels, center, ras_color, state_d, state_n, row0)


def tap_gammas(gamma: float, steps: int) -> list[float]:
    """The similarity weight of each of the ``8 + 4 * steps`` taps, as
    Python floats: ``gamma`` for the immediate taps, ``gamma * (1 + i)`` for
    reach step ``i``.  A device table rounds each once to float32."""
    return [gamma] * len(_IMM) + [gamma * (1 + i) for i in range(1, steps + 1) for _ in range(4)]


def _sum_taps(a: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing tap axis, one tap at a time in tap order (the
    order ``csrc/smoothness.cu`` keeps; ``torch.sum`` leaves it open)."""
    acc = a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
    return acc


def tap_step(fl: torch.Tensor, step_size: float) -> torch.Tensor:
    """The long-range taps' pitch of each cell, int64 (cl:1169 / cl:1437:
    ``step_sz = max(1, (int)(fl.x*kss + 0.5))``) from the flatness ``fl``
    (V, Mh, Mw, 2)."""
    return torch.clamp((fl[..., 0] * step_size + 0.5).to(torch.int64), min=1)


def _imm_ok(v: int, mh: int, mw: int, device) -> torch.Tensor:
    """(V, Mh, Mw, 8) bool: each immediate tap on the map, in tap order."""
    col, row = _grid(mh, mw, device)
    ok = [(col + dx >= 0) & (row + dy >= 0) & (col + dx < mw) & (row + dy < mh) for dx, dy in _IMM]
    return torch.stack(ok, dim=-1).expand(v, mh, mw, len(_IMM))


def _long_taps(step_sz: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tx, ty, ok) of the ``4 * steps`` long-range taps of each cell, each
    (V, Mh, Mw, 4 * steps): the unclamped position at ``i * step_sz + 1``
    cells in the order L, R, U, D for reach step ``i``, and whether it lies
    on the map."""
    v, mh, mw = step_sz.shape
    if steps == 0:
        empty = torch.zeros((v, mh, mw, 0), dtype=torch.int64, device=step_sz.device)
        return empty, empty, empty.bool()
    col, row = _grid(mh, mw, step_sz.device)
    colb, rowb = col.expand(v, mh, mw), row.expand(v, mh, mw)
    tx_list, ty_list, ok_list = [], [], []
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
            ok_list.append(ok)
    return torch.stack(tx_list, dim=-1), torch.stack(ty_list, dim=-1), torch.stack(ok_list, dim=-1)


def tap_on_map(step_sz: torch.Tensor, steps: int) -> torch.Tensor:
    """(V, Mh, Mw, 8 + 4 * steps) bool: each tap of each cell on the map, in
    tap order: the plain form's ``ok``, which zeroes an off-map tap's
    similarity.  ``step_sz`` from :func:`tap_step`."""
    v, mh, mw = step_sz.shape
    return torch.cat([_imm_ok(v, mh, mw, step_sz.device), _long_taps(step_sz, steps)[2]], dim=-1)


def build_cell_cache(
    ctx: RefineContext, tgt_d: torch.Tensor, *, gamma: float, steps: int, step_size: float
) -> IterCache:
    """Smoothness taps and ring data of one sweep; ``ras`` is left empty.
    The plain form of ``ops/smoothness.cell_cache``."""
    v, mh, mw = tgt_d.shape
    dev = tgt_d.device
    center, color = ctx.center, ctx.color
    col, row = _grid(mh, mw, dev)
    packed = torch.cat([center, color, tgt_d[..., None]], dim=-1)  # (V, Mh, Mw, 6)
    step_sz = tap_step(ctx.fl, step_size)

    # 8 immediate taps at static cell offsets
    tap = torch.stack([_roll_cells(packed, dx, dy) for dx, dy in _IMM], dim=-2)

    # 4 * steps long-range taps at flatness-scaled pitch, read at the
    # position clamped to the map
    tx, ty, long_ok = _long_taps(step_sz, steps)
    if steps > 0:
        vid = torch.arange(v, device=dev)[:, None, None, None]
        flat = vid * (mh * mw) + ty.clamp(0, mh - 1) * mw + tx.clamp(0, mw - 1)
        lr = packed.reshape(-1, 6)[flat]  # (V, Mh, Mw, 4*steps, 6)
        tap = torch.cat([tap, lr], dim=-2)

    ok = torch.cat([_imm_ok(v, mh, mw, dev), long_ok], dim=-1)
    gammas = device_table(tap_gammas(gamma, steps), torch.float32, dev)
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
        wn=_sum_taps(tap_sim),
        ras=torch.zeros((1, 4), dtype=torch.float32, device=dev),
        ring_dcx=rpack[..., 0] - center[..., 0:1],
        ring_dcy=rpack[..., 1] - center[..., 1:2],
        ring_d=rpack[..., 5],
        ring_ok=rok.expand(v, mh, mw, 8),
        cell_table=torch.cat([packed, step_sz[..., None].to(torch.float32), torch.zeros_like(tgt_d)[..., None]],
                             dim=-1),
        gammas=gammas,
        row0=0,
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
    from cl_multiview_stereo_tpu_torch.ops import smoothness

    cache = smoothness.cell_cache(ctx, tgt_d, gamma=gamma, steps=steps, step_size=step_size)
    if state_n is None:
        state_n = _fronto_normals(tgt_d)
    return cache._replace(ras=rasterize_table(ctx.labels, ctx.center, ctx.ras_color, tgt_d, state_n))


# ---------------------------------------------------------------------------
# Scoring from the cache.  d0/n0 may carry leading batch axes (moves).
# ---------------------------------------------------------------------------


def smoothness_from_cache(cache: IterCache, d0, n0, *, alpha: float) -> torch.Tensor:
    """cl:1136-1254 / cl:1407-1525: ``d_intrp = (n.(c - c_tap) + nz*d0)/nz``
    per tap, weighted by the move-independent similarities, summed in tap
    order.  The plain form of ``ops/smoothness.smoothness_moves``."""
    nx, ny, nz = n0[..., 0:1], n0[..., 1:2], n0[..., 2:3]
    d_intrp = (nx * cache.tap_ax + ny * cache.tap_ay + nz * d0[..., None]) / nz
    diff = d_intrp - cache.tap_d
    sm = _sum_taps(_ftz(cache.tap_sim * _ftz(torch.exp(-diff * diff * alpha))))
    return torch.where(cache.wn > 0, _ftz(sm / cache.wn), _EPS_SM)


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
    blown_up_outside: bool = False,
    img_hw: tuple[int, int] | None = None,
    ras_rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """cl:1260-1357 / cl:1528-1631, packed pair layout: the stored-plane
    interpolation at the projected pixel equals the rasterized input state
    there, so each (pair, sample) is one row of ``cache.ras``.  Per-view
    sums run over the pairs in subset order.  Returns (B, V, Mh, Mw).

    ``blown_up_outside``: a sample whose candidate-plane disparity is not
    finite counts as outside the image for every pair (the strips engine's
    rule, ``ops/consistency.py``); finite samples are scored unchanged.

    ``img_hw``/``ras_rows`` (JAX's arguments of the same names): the image
    size, when ``ctx`` holds a band of cell rows (``parallel/spatial``), and
    the rows ``(row_lo, rows_ext)`` of each view that ``cache.ras`` holds;
    a projection outside that window counts as outside the image.  The
    bounds test stays on the float, so a NaN shift reads offset 0 there as
    well."""
    h, w = ctx.labels.shape[1:3] if img_hw is None else img_hw
    b, v = d0.shape[:2]
    dev = d0.device
    if len(pairs) == 0:
        return torch.full(d0.shape, _MARGIN, dtype=torch.float32, device=dev)

    refs_np = np.asarray([p[0] for p in pairs], np.int64)
    bounds = np.searchsorted(refs_np, np.arange(v + 1))
    refs = device_table(refs_np, torch.int64, dev)
    nbrs = device_table([p[1] for p in pairs], torch.int64, dev)
    dvx = device_table([p[2] for p in pairs], torch.float32, dev)[:, None, None, None]
    dvy = device_table([p[3] for p in pairs], torch.float32, dev)[:, None, None, None]

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
    finite = torch.isfinite(dip) if blown_up_outside else None
    if finite is not None:
        dip = torch.where(finite, dip, 0.0)
    # A NaN shift (an nz = 0 plane) reads as XLA casts it to int, 0; the
    # bounds test is made on the float, so +-inf leaves the image on the
    # CPU and the card alike (as in ``fusion._probe``).
    xp = sx[refs].to(torch.float32) - torch.nan_to_num(cl_round(dip * dvx), nan=0.0)
    yp = sy[refs].to(torch.float32) - torch.nan_to_num(cl_round(bl_ratio * dip * dvy), nan=0.0)
    inb = (xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)
    if ras_rows is None:
        row_lo, rows_ext = 0, h
    else:
        row_lo, rows_ext = ras_rows
        inb = inb & (yp >= row_lo) & (yp < row_lo + rows_ext)
    inbf = (inb if finite is None else inb & finite).to(torch.float32)
    flat = (nbrs[:, None, None, None] * (rows_ext * w)
            + (yp - row_lo).clamp(0, rows_ext - 1).to(torch.int64) * w
            + xp.clamp(0, w - 1).to(torch.int64))
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
    cache = build_cache(ctx, d0, None, gamma=gamma, steps=steps, step_size=step_size)
    return init_scores(
        ctx, cache, d0, _fronto_normals(d0), gamma=gamma, alpha=alpha, fuse=fuse,
        bl_ratio=bl_ratio, pairs=pairs,
    )


def init_scores(
    ctx: RefineContext, cache: IterCache, d0, n0, *, gamma: float, alpha: float, fuse: float,
    bl_ratio: float, pairs: tuple, img_hw=None, ras_rows=None,
) -> RefineState:
    """The state of planes ``(d0, n0)`` scored against ``cache`` (the cells
    of ``ctx``: a whole map, a band of rows or a block of views), by the
    gather form: :func:`consistency_from_cache` on the CPU, one launch of
    the consistency kernel under its gather rule on a card."""
    from cl_multiview_stereo_tpu_torch.ops import consistency, smoothness

    cs = consistency.consistency_moves(
        ctx, cache, d0[None].contiguous(), n0[None].contiguous(), gamma=gamma, alpha=alpha,
        fuse=fuse, bl_ratio=bl_ratio, pairs=pairs, rule="gather", img_hw=img_hw, ras_rows=ras_rows,
    )[0]
    sm = smoothness.smoothness_moves(cache, d0[None], n0[None], alpha=alpha)[0]
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
    dxs = device_table([o[0] for o in offs], torch.int64, center.device)
    dys = device_table([o[1] for o in offs], torch.int64, center.device)
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


def update_candidates_reference(ctx: RefineContext, state_in: RefineState, offs, gamma: float,
                                rows: tuple[int, int] | None = None):
    """:func:`gather_update_moves` with the move axis leading: (d (M, V,
    Mh, Mw), n (M, V, Mh, Mw, 3), sim, ok); with ``rows`` = (row0, n) the
    cell rows row0 .. row0 + n - 1 of each (their neighbours still read
    the whole map).  The plain form of ``ops/chain.candidates``."""
    d_adopt, n1x, n1y, n1z, sim_m, ok_m = gather_update_moves(ctx, state_in, offs, gamma)
    mv = lambda a: a.movedim(-1, 0)  # noqa: E731  (move axis leads)
    moves = mv(d_adopt), torch.stack([mv(n1x), mv(n1y), mv(n1z)], dim=-1), mv(sim_m), mv(ok_m)
    if rows is None:
        return moves
    return tuple(a[:, :, rows[0]:rows[0] + rows[1]] for a in moves)


def update_candidates(ctx: RefineContext, state_in: RefineState, offs, gamma: float,
                      rows: tuple[int, int] | None = None):
    """The update moves' candidates (:func:`update_candidates_reference`):
    one launch of ``csrc/chain.cu``'s ``chain_moves`` on a card, the plain
    form on the CPU (``ops/chain.candidates``)."""
    from cl_multiview_stereo_tpu_torch.ops import chain

    return chain.candidates(ctx, state_in, offs, gamma, rows=rows)


def score_moves(
    ctx: RefineContext,
    cache: IterCache,
    d_c: torch.Tensor,
    n_c: torch.Tensor,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    pairs: tuple,
    score_chunk: int = SCORE_CHUNK,
    cons_engine: str = "gather",
    img_hw: tuple[int, int] | None = None,
    ras_rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, V, Mh, Mw), (M, V, Mh, Mw, 3) candidates -> (sm1, cs1), each
    (M, V, Mh, Mw), scored against the frozen input state in ``cache``.
    Smoothness goes to ``ops/smoothness.smoothness_moves`` and consistency
    to ``ops/consistency.consistency_moves`` under the engine's rule: on the
    CPU their plain forms (:func:`smoothness_from_cache` and, under the
    gather engine, :func:`consistency_from_cache`, per ``score_chunk``
    batch), on a card one kernel launch each for all moves.
    ``img_hw``/``ras_rows``: see :func:`consistency_from_cache` (gather
    engine only)."""
    from cl_multiview_stereo_tpu_torch.ops import consistency, smoothness

    if cons_engine != "gather" and (img_hw is not None or ras_rows is not None):
        raise ValueError("the strips engines score a whole map against the whole table")
    cs = consistency.consistency_moves(
        ctx, cache, d_c.contiguous(), n_c.contiguous(), gamma=gamma, alpha=alpha, fuse=fuse,
        bl_ratio=bl_ratio, pairs=pairs, score_chunk=score_chunk,
        rule="gather" if cons_engine == "gather" else "strips", img_hw=img_hw, ras_rows=ras_rows,
    )
    sm = smoothness.smoothness_moves(cache, d_c, n_c, alpha=alpha, score_chunk=score_chunk)
    return sm, cs


def update_phase_reference(cache: IterCache, state: RefineState, moves, sm1_upd, cs1_upd, greedy: bool):
    """The accept walk over the update moves ``moves`` (from
    :func:`update_candidates`) on their scores (cl:1779-1857), then the 8
    ring refit normals of the new d and their validity (cl:1687-1723,
    cl:1865-1891): (state, n_ref (8, ..., 3), ok_ref (8, ...)).  The plain
    form of ``ops/chain.update``."""
    d_upd, n_upd, sim_upd, ok_upd = moves
    d0, sm0, cs0, n0 = state.d, state.sm, state.cs, state.n
    for k in range(d_upd.shape[0]):
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
    # two ring neighbours
    n_ref, ok_ref = [], []
    for r in range(8):
        r2 = (r + 1) % 8
        v1 = (cache.ring_dcx[..., r], cache.ring_dcy[..., r], cache.ring_d[..., r] - d0)
        v2 = (cache.ring_dcx[..., r2], cache.ring_dcy[..., r2], cache.ring_d[..., r2] - d0)
        cx_, cy_, cz_ = _cross(v1, v2)
        norm = torch.sqrt(cx_ * cx_ + cy_ * cy_ + cz_ * cz_)
        n_ref.append(torch.stack([cx_ / norm, cy_ / norm, cz_ / norm], dim=-1))
        ok_ref.append(cache.ring_ok[..., r] & cache.ring_ok[..., r2])
    return RefineState(d=d0, sm=sm0, cs=cs0, n=n0), torch.stack(n_ref), torch.stack(ok_ref)


def refit_phase_reference(state: RefineState, n_ref, ok_ref, sm1_ref, cs1_ref, greedy: bool) -> RefineState:
    """The accept walk over the 8 refits on their scores; d is unchanged.
    The plain form of ``ops/chain.refit``."""
    sm0, cs0, n0 = state.sm, state.cs, state.n
    for r in range(8):
        sm1, cs1 = sm1_ref[r], cs1_ref[r]
        cond = _ftz(sm1 * cs1) > _ftz(sm0 * cs0)
        if greedy:
            cond = cond | (sm1 > sm0)
        accept = ok_ref[r] & cond
        sm0 = torch.where(accept, sm1, sm0)
        cs0 = torch.where(accept, cs1, cs0)
        n0 = torch.where(accept[..., None], n_ref[r], n0)
    return RefineState(d=state.d, sm=sm0, cs=cs0, n=n0)


def _walk(update, refit, cache: IterCache, state: RefineState, moves, it: int, score) -> RefineState:
    greedy = it < 4  # cl:1663 / cl:1713
    sm1, cs1 = score(moves[0], moves[1])
    state, n_ref, ok_ref = update(cache, state, moves, sm1, cs1, greedy)
    d0 = state.d
    sm1, cs1 = score(d0[None].expand((8,) + tuple(d0.shape)), n_ref)
    return refit(state, n_ref, ok_ref, sm1, cs1, greedy)


def move_chain(cache: IterCache, state: RefineState, moves, it: int, score) -> RefineState:
    """The move chain of one Jacobi sweep for the cells of ``state`` (a
    whole map, a band of cell rows or a block of views), scored by
    ``score(d_c, n_c) -> (sm1, cs1)`` against the frozen input state that
    ``cache`` and ``score`` hold: the update moves ``moves`` (from
    :func:`update_candidates`, for these cells) in reference order, then
    the normal refits through pairs of ring neighbours.  The port's one
    accept rule: :func:`refine`, ``parallel/spatial.spatial_refine`` and
    ``parallel/sharded_pipeline`` all run it.  Each walk goes through
    ``ops/chain``: on a card ``chain_update``, the refits' scores, then
    ``chain_refit``; on the CPU :func:`update_phase_reference` and
    :func:`refit_phase_reference`."""
    from cl_multiview_stereo_tpu_torch.ops import chain

    return _walk(chain.update, chain.refit, cache, state, moves, it, score)


def move_chain_reference(cache: IterCache, state: RefineState, moves, it: int, score) -> RefineState:
    """:func:`move_chain` on the plain forms, on any device."""
    return _walk(update_phase_reference, refit_phase_reference, cache, state, moves, it, score)


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
    cons_engine: str = "gather",
) -> RefineState:
    """One Jacobi sweep: every superpixel walks the move chain, scoring
    candidate planes against the frozen input state
    (depth_refinement.cpp:744-753).  ``cons_engine``: see the module
    docstring; on the CPU both scores run in ``score_chunk`` batches."""
    check_options(cons_engine)
    mh, mw = state_in.d.shape[1:]
    cache = build_cache(
        ctx, state_in.d, state_in.n, gamma=gamma, steps=steps, step_size=step_size
    )
    offs = _update_move_offsets(steps, step_size, mw, mh)
    moves = update_candidates(ctx, state_in, offs, gamma)

    def score(d_c, n_c):
        return score_moves(
            ctx, cache, d_c, n_c, gamma=gamma, alpha=alpha, fuse=fuse, bl_ratio=bl_ratio,
            pairs=pairs, score_chunk=score_chunk, cons_engine=cons_engine,
        )

    return move_chain(cache, state_in, moves, it, score)


def check_options(cons_engine: str = "gather", pair_layout: str = "packed") -> None:
    """Refuse an unknown engine or layout, and the strips engines under
    the view layout (JAX refine.py:1063)."""
    if cons_engine not in CONS_ENGINES:
        raise ValueError(f"unknown cons_engine {cons_engine!r}; expected one of {CONS_ENGINES}")
    if pair_layout not in PAIR_LAYOUTS:
        raise ValueError(f"unknown pair_layout {pair_layout!r}; expected one of {PAIR_LAYOUTS}")
    if cons_engine != "gather" and pair_layout == "view":
        raise ValueError("the strips engines are packed-layout only")


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
    (depth_refinement.cpp:105-106, 767-769).  ``cons_engine`` picks the
    propagation sweeps' consistency engine; the init state is scored by
    the gather form under every engine, as in JAX.  ``pair_layout``
    ("packed" or "view", gather engine only) is JAX's pair axis layout:
    the two give the same bits, and the packed scorer runs for either.
    ``timer``: an optional ``utils.timing.StageTimer`` for the init and
    propagate stages."""
    check_options(cons_engine, pair_layout)
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
                score_chunk=score_chunk, cons_engine=cons_engine,
            )
    return state
