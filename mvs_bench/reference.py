"""The plain reference of the benchmark: the depth pipeline in plain PyTorch.

A frozen copy of the port's plain forms (the ``*_reference`` functions
beside each hand kernel of ``cl_multiview_stereo_tpu_torch/ops``, and the
plain stages between them) at the settings the benchmark's configurations
run: dense depth init, the gather consistency rule, the packed pair list,
no SLIC edge snap, no connectivity vote, no cross-check fusion.  Nothing
here imports the port or JAX, and nothing takes what the port derived: the
reference starts from the uint8 capture and works out the Lab image, the
superpixels, the extent, the initial disparity, the refined planes and the
fused maps again.  It runs on any device, in float32 (it has no matrix
product, so TF32 never enters).

``lowp=True`` is the control: the same stages with every float tensor that
one stage hands to the next (the Lab image, the superpixel map, the cost
volume, the flatness, the scores and planes of each sweep, the fused maps)
rounded to bfloat16, the precision below the configuration's float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_FLT_MIN = float(torch.finfo(torch.float32).tiny)
_MARGIN = 0.01
_EPS_SM = 0.000001
_OOB_PENALTY = 30.0
_BIG = 1.0e6
SCORE_CHUNK = 4
# settings the reference does not implement; a configuration that sets
# them is refused rather than judged against another function
_UNSUPPORTED = {"edge_enable": False, "enforce_connectivity": False}


# ---------------------------------------------------------------------------
# Settings (clMVDE/header.h:55-77 and the quantities the reference derives)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Settings:
    """The ``system_settings`` fields the depth pipeline reads."""

    spixl_size: int = 8
    slic_color_weight: float = 0.6
    no_iter: int = 5
    array_width: int = 3
    array_height: int = 3
    neib_hor: int = 1
    neib_ver: int = 1
    bl_ratio: float = 1.03590
    min_disp: int = 30
    max_disp: int = 60
    inc: int = 1
    kernel_size: int = 1080
    kernel_step: int = 13
    fuse: float = 1.0
    gamma: float = 2.0
    alpha: float = 6.0
    no_prop: int = 5

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        for key, want in _UNSUPPORTED.items():
            if d.get(key, want) != want:
                raise ValueError(f"the reference does not implement {key}={d[key]!r}")
        known = cls.__dataclass_fields__
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def view_num(self) -> int:
        return self.array_width * self.array_height


def map_size(img_w: int, img_h: int, s: int) -> tuple[int, int]:
    """(map_w, map_h) = ceil(img / spixl_size)."""
    return int(math.ceil(img_w / float(s))), int(math.ceil(img_h / float(s)))


def disp_levels(s: Settings) -> np.ndarray:
    """The ladder min + i * inc, the upper end included."""
    n = (s.max_disp - s.min_disp) // s.inc + 1
    return np.asarray([s.min_disp + i * s.inc for i in range(n)], dtype=np.float32)


def view_subsets(s: Settings) -> tuple[np.ndarray, np.ndarray]:
    """-1 padded (V, V) neighbour table and (V,) counts, x outer, y inner."""
    v = s.view_num
    subset = np.full((v, v), -1, dtype=np.int32)
    counts = np.zeros((v,), dtype=np.int32)
    for i in range(v):
        k = 0
        for x in range(i % s.array_width - s.neib_hor, i % s.array_width + s.neib_hor + 1):
            for y in range(i // s.array_width - s.neib_ver, i // s.array_width + s.neib_ver + 1):
                idx = y * s.array_width + x
                if 0 <= x < s.array_width and 0 <= y < s.array_height and idx != i:
                    subset[i, k] = idx
                    k += 1
        counts[i] = k
    return subset, counts


def pairs_from_subsets(view_subset: np.ndarray, array_width: int) -> tuple:
    """(ref, view, dvx, dvy) pairs in the subset table's order."""
    pairs = []
    for z in range(view_subset.shape[0]):
        for k in range(view_subset.shape[1]):
            n = int(view_subset[z, k])
            if n >= 0:
                pairs.append((z, n, float(n % array_width - z % array_width),
                              float(n // array_width - z // array_width)))
    return tuple(pairs)


class Schedule(NamedTuple):
    """The refinement engine's parameters after the reference's transforms."""

    gamma: float
    alpha: float
    fuse: float
    kernel_steps: int
    sp_kernel_step: float
    steps_per_iter: tuple
    step_size_per_iter: tuple


def schedule(s: Settings) -> Schedule:
    sp = float(max(1, ((s.kernel_size // 2) // s.kernel_step) * s.spixl_size))
    return Schedule(
        gamma=1.0 / (2.0 * s.gamma**2), alpha=1.0 / (2.0 * s.alpha**2), fuse=0.5 * s.fuse,
        kernel_steps=s.kernel_step, sp_kernel_step=sp,
        steps_per_iter=tuple(s.kernel_step // (i + 1) for i in range(s.no_prop)),
        step_size_per_iter=tuple(sp / (i + 1) for i in range(s.no_prop)),
    )


def update_move_offsets(steps: int, step_size: float, mw: int, mh: int) -> list[tuple[int, int]]:
    """(dx, dy) of a sweep's update moves: 8 immediate, then per reach step
    up, down, left, right; offsets past the map dropped."""
    offs = list(_IMM)
    pitch = int(step_size)
    for i in range(1, steps + 1):
        off = i * pitch + 1
        offs += [(0, -off), (0, off), (-off, 0), (off, 0)]
    return [(dx, dy) for dx, dy in offs if abs(dx) < mw and abs(dy) < mh]


def _table(values, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), device=device).to(dtype)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < _FLT_MIN, 0.0, x)


def _bf16(x):
    """Every float32 tensor of ``x`` (a tensor or a NamedTuple of them)
    rounded to bfloat16 and back."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(torch.float32) if x.dtype == torch.float32 else x
    return type(x)(*(_bf16(t) for t in x))


def _keep(x):
    return x


# ---------------------------------------------------------------------------
# Lab (clcode.cl colour conversion, the reference's constants)
# ---------------------------------------------------------------------------

_SCALE, _EPSILON, _KAPPA = 0.0039216, 0.008856, 903.3
_WHITE = (0.950456, 1.0, 1.088754)
_RGB2XYZ = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169), (0.019334, 0.119193, 0.950227))


def _f_cbrt(t):
    return torch.where(t > _EPSILON, torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0), (_KAPPA * t + 16.0) / 116.0)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    x = rgb.to(torch.float32) * _SCALE
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    m = _RGB2XYZ
    fx = _f_cbrt((r * m[0][0] + g * m[0][1] + b * m[0][2]) / _WHITE[0])
    fy = _f_cbrt((r * m[1][0] + g * m[1][1] + b * m[1][2]) / _WHITE[1])
    fz = _f_cbrt((r * m[2][0] + g * m[2][1] + b * m[2][2]) / _WHITE[2])
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


# ---------------------------------------------------------------------------
# SLIC (clcode.cl:259-773)
# ---------------------------------------------------------------------------


class SuperpixelMap(NamedTuple):
    center: torch.Tensor  # (V, Mh, Mw, 2)
    color: torch.Tensor  # (V, Mh, Mw, 3)
    count: torch.Tensor  # (V, Mh, Mw)


def slic_init(lab, s: int, mh: int, mw: int) -> SuperpixelMap:
    v, h, w = lab.shape[:3]
    dev = lab.device
    col = torch.arange(mw, dtype=torch.int64, device=dev)
    row = torch.arange(mh, dtype=torch.int64, device=dev)
    cx = torch.where(col * s + s // 2 > w, (col * s + w) // 2, col * s + s // 2)
    cy = torch.where(row * s + s // 2 > h, (row * s + h) // 2, row * s + s // 2)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    center = torch.stack([cxg, cyg], dim=-1).to(torch.float32)[None].expand(v, mh, mw, 2).contiguous()
    color = lab[:, cyg.clamp(0, h - 1), cxg.clamp(0, w - 1), :]
    return SuperpixelMap(center, color, torch.zeros((v, mh, mw), dtype=torch.float32, device=dev))


def slic_assign(lab, spmap: SuperpixelMap, s: int, mh: int, mw: int, mcd: float, mxy: float, cw: float):
    v, h, w = lab.shape[:3]
    dev = lab.device
    col = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    row = torch.arange(h, dtype=torch.int64, device=dev)[:, None]
    cx, cy = col // s, row // s
    dxp = ((col % s) + s // 2) // s
    dyp = ((row % s) + s // 2) // s
    colf, rowf = col.to(torch.float32), row.to(torch.float32)
    packed = torch.cat([spmap.center, spmap.color], dim=-1).reshape(v, mh * mw, 5)
    best = torch.full((v, h, w), float("inf"), dtype=torch.float32, device=dev)
    best_id = torch.full((v, h, w), -1, dtype=torch.int64, device=dev)
    for i_off in (-1, 0):
        for j_off in (-1, 0):
            qy = cy + dxp + i_off
            qx = cx + dyp + j_off
            ok = (qy >= 0) & (qy < mh) & (qx >= 0) & (qx < mw)
            cid = qy.clamp(0, mh - 1) * mw + qx.clamp(0, mw - 1)
            fld = packed[:, cid]
            color_d = ((lab[..., 0] - fld[..., 2]) ** 2 + (lab[..., 1] - fld[..., 3]) ** 2
                       + (lab[..., 2] - fld[..., 4]) ** 2)
            space_d = (colf - fld[..., 0]) ** 2 + (rowf - fld[..., 1]) ** 2
            dist = torch.where(ok, torch.sqrt(color_d * mcd + cw * space_d * mxy), float("inf"))
            take = dist < best
            best = torch.where(take, dist, best)
            best_id = torch.where(take, cid, best_id)
    return best_id.to(torch.int32)


def slic_update(lab, labels, s: int, mh: int, mw: int) -> SuperpixelMap:
    v, h, w = lab.shape[:3]
    dev = lab.device
    col = torch.arange(w, dtype=torch.int64, device=dev)[None, None, :]
    row = torch.arange(h, dtype=torch.int64, device=dev)[None, :, None]
    lab_l = labels.to(torch.int64)
    rel_x = lab_l % mw - col // s
    rel_y = lab_l // mw - row // s
    planes = torch.stack([lab[..., 0], lab[..., 1], lab[..., 2], col.to(torch.float32).expand(v, h, w),
                          row.to(torch.float32).expand(v, h, w),
                          torch.ones((v, h, w), dtype=torch.float32, device=dev)])
    colm = torch.arange(mw, device=dev)[None, :]
    rowm = torch.arange(mh, device=dev)[:, None]
    sums = torch.zeros((6, v, mh, mw), dtype=torch.float32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sel = (rel_x == dx) & (rel_y == dy)
            contrib = F.pad(torch.where(sel, planes, 0.0), (0, mw * s - w, 0, mh * s - h)).reshape(6, v, mh, s, mw, s)
            # a column's rows first, then the cell's columns, one add at a time
            rows_s = torch.zeros_like(contrib[:, :, :, 0])
            for r in range(s):
                rows_s = rows_s + contrib[:, :, :, r]
            block = torch.zeros_like(rows_s[..., 0])
            for c in range(s):
                block = block + rows_s[..., c]
            shifted = torch.roll(block, shifts=(dy, dx), dims=(2, 3))
            okm = (colm - dx >= 0) & (colm - dx < mw) & (rowm - dy >= 0) & (rowm - dy < mh)
            sums = sums + torch.where(okm, shifted, 0.0)
    n = sums[5]
    nz = n > 0
    denom = torch.where(nz, n, 1.0)
    color = torch.where(nz[..., None], torch.stack(list(sums[0:3]), dim=-1) / denom[..., None], 0.0)
    center = torch.where(nz[..., None], torch.stack(list(sums[3:5]), dim=-1) / denom[..., None], 0.0)
    return SuperpixelMap(center, color, torch.where(nz, n, 0.0))


def segment(lab, st: Settings, mh: int, mw: int, q=_keep):
    s = st.spixl_size
    xy = 1.0 / (1.4242 * s)
    col = 15.0 / (1.7321 * 128.0)
    mxy = float(np.float32(np.float32(xy) * np.float32(xy)))
    mcd = float(np.float32(np.float32(col) * np.float32(col)))
    cw = st.slic_color_weight
    spmap = q(slic_init(lab, s, mh, mw))
    labels = slic_assign(lab, spmap, s, mh, mw, mcd, mxy, cw)
    for _ in range(st.no_iter):
        spmap = q(slic_update(lab, labels, s, mh, mw))
        labels = slic_assign(lab, spmap, s, mh, mw, mcd, mxy, cw)
    return labels, spmap


# ---------------------------------------------------------------------------
# Superpixel extent (clcode.cl:791-855) and the sample grids
# ---------------------------------------------------------------------------

_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def clamp_center(cx, cy, w: int, h: int, s: int):
    cx = torch.where(cx < s, s, cx)
    cx = torch.where(cx + s > w, cx - s, cx)
    cy = torch.where(cy < s, s, cy)
    cy = torch.where(cy + s > h, cy - s, cy)
    return cx, cy


def superpixel_extent(labels, centers, s: int) -> torch.Tensor:
    v, h, w = labels.shape
    mh, mw = centers.shape[1:3]
    cx, cy = clamp_center(centers[..., 0].to(torch.int64), centers[..., 1].to(torch.int64), w, h, s)
    own = torch.arange(mh * mw, dtype=torch.int32, device=labels.device).reshape(1, mh, mw)
    flat = labels.reshape(v, h * w)
    ext = torch.zeros((v, mh, mw, 8), dtype=torch.int32, device=labels.device)
    for i in range(1, s):
        for k, (dx, dy) in enumerate(_DIRS):
            px, py = cx + i * dx, cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).reshape(v, -1)
            match = inb & (torch.gather(flat, 1, idx).reshape(v, mh, mw) == own)
            ext[..., k] = torch.where(match, i - 1, ext[..., k])
    return ext


def extent_step(ext):
    e = ext.to(torch.float32)
    bb_l = torch.maximum(e[..., 0], torch.maximum(e[..., 1], e[..., 2]))
    bb_r = torch.maximum(e[..., 5], torch.maximum(e[..., 6], e[..., 7]))
    bb_t = torch.maximum(e[..., 0], torch.maximum(e[..., 3], e[..., 5]))
    bb_b = torch.maximum(e[..., 2], torch.maximum(e[..., 4], e[..., 7]))
    return torch.stack([torch.clamp(0.25 * (bb_l + bb_r), min=1.0), torch.clamp(0.25 * (bb_t + bb_b), min=1.0)], -1)


def consistency_samples(ext):
    zeros = torch.zeros_like(ext[..., 0])
    radii = torch.stack([ext[..., 0], ext[..., 1], ext[..., 2], ext[..., 3], zeros,
                         ext[..., 4], ext[..., 5], ext[..., 6], ext[..., 7]], dim=-1)
    ii = _table([-1, -1, -1, 0, 0, 0, 1, 1, 1], torch.int32, ext.device)
    jj = _table([-1, 0, 1, -1, 0, 1, -1, 0, 1], torch.int32, ext.device)
    return torch.stack([radii * ii, radii * jj], dim=-1)


# ---------------------------------------------------------------------------
# Depth init: cost volume and WTA (clcode.cl:972-1069)
# ---------------------------------------------------------------------------


def cost_volume(lab, centers, step, levels: np.ndarray, st: Settings) -> torch.Tensor:
    v, h, w = lab.shape[:3]
    mh, mw = centers.shape[1:3]
    dev = lab.device
    dl = torch.as_tensor(levels, dtype=torch.float32, device=dev)
    n_d = dl.shape[0]
    aw, ah = st.array_width, v // st.array_width
    flat = lab.reshape(v * h * w, 3)
    vid = torch.arange(v, dtype=torch.int64, device=dev)
    cx, cy, sx, sy = centers[..., 0], centers[..., 1], step[..., 0], step[..., 1]
    samples = []
    for i in range(-2, 3):
        xr = (cx + float(i) * sx).to(torch.int64)
        for j in range(-2, 3):
            yr = (cy + float(j) * sy).to(torch.int64)
            ref_ok = (xr >= 0) & (yr >= 0) & (xr < w) & (yr < h)
            ref_idx = (vid[:, None, None] * h + yr.clamp(0, h - 1)) * w + xr.clamp(0, w - 1)
            samples.append((xr, yr, ref_ok, flat[ref_idx]))
    vol = torch.full((v, n_d, mh, mw), _BIG, dtype=torch.float32, device=dev)
    bl_d = dl * float(np.float32(st.bl_ratio))
    deltas = [(gx, gy) for gx in range(-st.neib_hor, st.neib_hor + 1)
              for gy in range(-st.neib_ver, st.neib_ver + 1) if not (gx == 0 and gy == 0)]
    for gx, gy in deltas:
        valid_np = np.array([0 <= z % aw + gx < aw and 0 <= z // aw + gy < ah for z in range(v)])
        if not valid_np.any():
            continue
        valid = torch.as_tensor(valid_np, device=dev)[:, None, None, None]
        nv = (vid + gy * aw + gx) % v
        cxs = (dl * float(gx))[None, :, None, None]
        cys = (bl_d * float(gy))[None, :, None, None]
        shx, shy = torch.ceil(cxs).to(torch.int64), torch.ceil(cys).to(torch.int64)
        acc = torch.zeros((v, n_d, mh, mw), dtype=torch.float32, device=dev)
        for xr, yr, ref_ok, ref in samples:
            xr4, yr4 = xr[:, None], yr[:, None]
            px = xr4.to(torch.float32) - cxs
            py = yr4.to(torch.float32) - cys
            ok = ref_ok[:, None] & (px > -1.0) & (px < w) & (py > -1.0) & (py < h)
            xp = (xr4 - shx).clamp(0, w - 1)
            yp = (yr4 - shy).clamp(0, h - 1)
            qv = flat[(nv[:, None, None, None] * h + yp) * w + xp]
            r = ref[:, None]
            sad = torch.abs(r[..., 0] - qv[..., 0]) + torch.abs(r[..., 1] - qv[..., 1]) + torch.abs(r[..., 2] - qv[..., 2])
            acc = acc + torch.where(ok, sad, _OOB_PENALTY)
        vol = torch.where(valid, torch.minimum(vol, acc), vol)
    return vol


def depth_init(lab, centers, extent, st: Settings, q=_keep) -> torch.Tensor:
    levels = disp_levels(st)
    vol = q(cost_volume(lab, centers, extent_step(extent).contiguous(), levels, st))
    dl = torch.as_tensor(levels, dtype=torch.float32, device=lab.device)
    disp = dl[torch.argmin(vol, dim=1)]
    has_views = _table(view_subsets(st)[1], torch.int32, lab.device) > 0
    return torch.where(has_views[:, None, None], disp, 0.0)


# ---------------------------------------------------------------------------
# Planes to pixels (clcode.cl:1906-1931)
# ---------------------------------------------------------------------------


def cl_round(x):
    """OpenCL round(): half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def gather_cells(labels, fields):
    v, h, w = labels.shape
    c = fields.shape[-1]
    idx = labels.reshape(v, h * w, 1).to(torch.int64).expand(v, h * w, c)
    return torch.gather(fields.reshape(v, -1, c), 1, idx).reshape(v, h, w, c)


def plane_disparity(g):
    h, w = g.shape[1:3]
    px = torch.arange(w, dtype=torch.float32, device=g.device)[None, None, :]
    py = torch.arange(h, dtype=torch.float32, device=g.device)[None, :, None]
    return (g[..., 3] * (g[..., 0] - px) + g[..., 4] * (g[..., 1] - py) + g[..., 5] * g[..., 2]) / g[..., 5]


def rasterize_planes(labels, centers, d, n):
    return plane_disparity(gather_cells(labels, torch.cat([centers, d[..., None], n], dim=-1)))


# ---------------------------------------------------------------------------
# Refinement (clcode.cl:1076-1900)
# ---------------------------------------------------------------------------


class RefineState(NamedTuple):
    d: torch.Tensor  # (V, Mh, Mw)
    sm: torch.Tensor
    cs: torch.Tensor
    n: torch.Tensor  # (V, Mh, Mw, 3)


class Context(NamedTuple):
    center: torch.Tensor
    color: torch.Tensor
    disp0: torch.Tensor
    labels: torch.Tensor
    samples: torch.Tensor  # (V, Mh, 9, Mw, 2)
    fl: torch.Tensor  # (V, Mh, Mw, 2)
    ras_color: torch.Tensor  # (V*H*W, 3)


class Cache(NamedTuple):
    tap_ax: torch.Tensor
    tap_ay: torch.Tensor
    tap_d: torch.Tensor
    tap_sim: torch.Tensor
    wn: torch.Tensor
    ras: torch.Tensor  # (V*H*W, 4)
    ring_dcx: torch.Tensor
    ring_dcy: torch.Tensor
    ring_d: torch.Tensor
    ring_ok: torch.Tensor


_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))
_IMM = tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if not (i == 0 and j == 0))


def _sqdist3(a, b):
    return (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2 + (a[..., 2] - b[..., 2]) ** 2


def _grid(mh: int, mw: int, device):
    row, col = torch.meshgrid(torch.arange(mh, device=device), torch.arange(mw, device=device), indexing="ij")
    return col[None], row[None]


def _roll_cells(a, dx: int, dy: int):
    return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))


def _sum_taps(a):
    acc = a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
    return acc


def flatness(color, gamma: float):
    v, mh, mw = color.shape[:3]
    col, row = _grid(mh, mw, color.device)
    fl = torch.ones((v, mh, mw), dtype=torch.float32, device=color.device)
    for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
        shifted = torch.roll(color, shifts=(-dy, -dx), dims=(1, 2))
        ok = (col + dx >= 0) & (col + dx < mw) & (row + dy >= 0) & (row + dy < mh)
        fl = fl + torch.where(ok, _sqdist3(shifted, color), 0.0)
    return torch.stack([torch.exp(-fl * gamma), 1.0 - torch.exp(-0.25 * fl * gamma)], dim=-1)


def _imm_ok(v: int, mh: int, mw: int, device):
    col, row = _grid(mh, mw, device)
    ok = [(col + dx >= 0) & (row + dy >= 0) & (col + dx < mw) & (row + dy < mh) for dx, dy in _IMM]
    return torch.stack(ok, dim=-1).expand(v, mh, mw, len(_IMM))


def _long_taps(step_sz, steps: int):
    v, mh, mw = step_sz.shape
    if steps == 0:
        empty = torch.zeros((v, mh, mw, 0), dtype=torch.int64, device=step_sz.device)
        return empty, empty, empty.bool()
    col, row = _grid(mh, mw, step_sz.device)
    colb, rowb = col.expand(v, mh, mw), row.expand(v, mh, mw)
    tx_l, ty_l, ok_l = [], [], []
    for i in range(1, steps + 1):
        step = i * step_sz
        off = step + 1
        for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1)):
            if axis == 0:
                tx, ty = colb + sign * off, rowb
                ok = (colb > step) if sign < 0 else (colb < mw - step - 1)
            else:
                tx, ty = colb, rowb + sign * off
                ok = (rowb > step) if sign < 0 else (rowb < mh - step - 1)
            tx_l.append(tx)
            ty_l.append(ty)
            ok_l.append(ok)
    return torch.stack(tx_l, dim=-1), torch.stack(ty_l, dim=-1), torch.stack(ok_l, dim=-1)


def tap_gammas(gamma: float, steps: int) -> list[float]:
    return [gamma] * len(_IMM) + [gamma * (1 + i) for i in range(1, steps + 1) for _ in range(4)]


def build_cache(ctx: Context, tgt_d, state_n, *, gamma: float, steps: int, step_size: float) -> Cache:
    v, mh, mw = tgt_d.shape
    dev = tgt_d.device
    center, color = ctx.center, ctx.color
    col, row = _grid(mh, mw, dev)
    packed = torch.cat([center, color, tgt_d[..., None]], dim=-1)
    step_sz = torch.clamp((ctx.fl[..., 0] * step_size + 0.5).to(torch.int64), min=1)
    tap = torch.stack([_roll_cells(packed, dx, dy) for dx, dy in _IMM], dim=-2)
    tx, ty, long_ok = _long_taps(step_sz, steps)
    if steps > 0:
        vid = torch.arange(v, device=dev)[:, None, None, None]
        flat = vid * (mh * mw) + ty.clamp(0, mh - 1) * mw + tx.clamp(0, mw - 1)
        tap = torch.cat([tap, packed.reshape(-1, 6)[flat]], dim=-2)
    ok = torch.cat([_imm_ok(v, mh, mw, dev), long_ok], dim=-1)
    gammas = _table(tap_gammas(gamma, steps), torch.float32, dev)
    tap_sim = torch.where(ok, _ftz(torch.exp(-_sqdist3(color[..., None, :], tap[..., 2:5]) * gammas)), 0.0)
    rpack = torch.stack([_roll_cells(packed, dx, dy) for dx, dy in _RING], dim=-2)
    rtx = torch.stack([(col + dx).expand(1, mh, mw) for dx, _ in _RING], dim=-1)
    rty = torch.stack([(row + dy).expand(1, mh, mw) for _, dy in _RING], dim=-1)
    rok = (rtx >= 0) & (rty >= 0) & (rtx < mw) & (rty < mh)
    if state_n is None:
        state_n = torch.zeros(tgt_d.shape + (3,), dtype=torch.float32, device=dev)
        state_n[..., 2] = 1.0
    disp = plane_disparity(gather_cells(ctx.labels, torch.cat([center, tgt_d[..., None], state_n], dim=-1)))
    return Cache(
        tap_ax=center[..., 0:1] - tap[..., 0], tap_ay=center[..., 1:2] - tap[..., 1], tap_d=tap[..., 5],
        tap_sim=tap_sim, wn=_sum_taps(tap_sim),
        ras=torch.cat([disp.reshape(-1, 1), ctx.ras_color], dim=-1),
        ring_dcx=rpack[..., 0] - center[..., 0:1], ring_dcy=rpack[..., 1] - center[..., 1:2],
        ring_d=rpack[..., 5], ring_ok=rok.expand(v, mh, mw, 8),
    )


def smoothness(cache: Cache, d0, n0, *, alpha: float):
    nx, ny, nz = n0[..., 0:1], n0[..., 1:2], n0[..., 2:3]
    diff = (nx * cache.tap_ax + ny * cache.tap_ay + nz * d0[..., None]) / nz - cache.tap_d
    sm = _sum_taps(_ftz(cache.tap_sim * _ftz(torch.exp(-diff * diff * alpha))))
    return torch.where(cache.wn > 0, _ftz(sm / cache.wn), _EPS_SM)


def consistency(ctx: Context, cache: Cache, d0, n0, *, gamma, alpha, fuse, bl_ratio, pairs):
    """Gather rule, packed pairs: (B, V, Mh, Mw) scores of (B, ...) planes."""
    h, w = ctx.labels.shape[1:3]
    b, v = d0.shape[:2]
    dev = d0.device
    if len(pairs) == 0:
        return torch.full(d0.shape, _MARGIN, dtype=torch.float32, device=dev)
    refs_np = np.asarray([p[0] for p in pairs], np.int64)
    bounds = np.searchsorted(refs_np, np.arange(v + 1))
    refs = _table(refs_np, torch.int64, dev)
    nbrs = _table([p[1] for p in pairs], torch.int64, dev)
    dvx = _table([p[2] for p in pairs], torch.float32, dev)[:, None, None, None]
    dvy = _table([p[3] for p in pairs], torch.float32, dev)[:, None, None, None]
    cx = ctx.center[..., 0][:, :, None, :]
    cy = ctx.center[..., 1][:, :, None, :]
    sx = cx.to(torch.int64) + ctx.samples[..., 0]
    sy = cy.to(torch.int64) + ctx.samples[..., 1]
    nx, ny, nz = (n0[..., k].unsqueeze(-2) for k in range(3))
    d_intrp = (nx * (cx - sx.to(torch.float32)) + ny * (cy - sy.to(torch.float32)) + nz * d0.unsqueeze(-2)) / nz
    dip = d_intrp[:, refs]
    xp = sx[refs].to(torch.float32) - torch.nan_to_num(cl_round(dip * dvx), nan=0.0)
    yp = sy[refs].to(torch.float32) - torch.nan_to_num(cl_round(bl_ratio * dip * dvy), nan=0.0)
    inbf = ((xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)).to(torch.float32)
    flat = nbrs[:, None, None, None] * (h * w) + yp.clamp(0, h - 1).to(torch.int64) * w + xp.clamp(0, w - 1).to(torch.int64)
    del xp, yp
    g = cache.ras[flat]
    del flat
    diff = g[..., 0] - dip
    when_visible = (torch.abs(diff) < fuse).to(torch.float32)
    visible = torch.sum(inbf * when_visible * _ftz(torch.exp(-diff * diff * alpha)), dim=-2)
    visib_sum = torch.sum(inbf * when_visible, dim=-2)
    occl_sum = torch.sum(inbf * (1.0 - when_visible), dim=-2)
    del diff, when_visible
    colp = ctx.color[refs]
    cdiff = sum((g[..., 1 + c] - colp[..., c][:, :, None, :]) ** 2 for c in range(3))
    del g
    visibility = torch.sum(inbf * _ftz(torch.exp(-cdiff * gamma)), dim=-2)
    num = torch.sum(inbf, dim=-2)
    contrib = torch.where(
        visib_sum > 0,
        _ftz((visib_sum / torch.clamp(num, min=1.0)) * (visibility / torch.clamp(visib_sum, min=1e-30))
             * (visible / torch.clamp(visib_sum, min=1e-30))),
        0.0,
    )
    contrib = contrib + torch.where(occl_sum > 0, 0.5 * ctx.fl[..., 1][refs], 0.0)
    has = (num > 0).to(torch.float32)
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
    cons, counter = torch.stack(cons_rows, dim=1), torch.stack(cnt_rows, dim=1)
    return torch.where(counter > 0, torch.clamp(cons / torch.clamp(counter, min=1.0), min=_MARGIN), _MARGIN)


def score(ctx, cache, d_c, n_c, *, gamma, alpha, fuse, bl_ratio, pairs):
    """(sm, cs), each (M, V, Mh, Mw), SCORE_CHUNK moves at a time."""
    sm, cs = [], []
    for k in range(0, d_c.shape[0], SCORE_CHUNK):
        d, n = d_c[k:k + SCORE_CHUNK], n_c[k:k + SCORE_CHUNK]
        cs.append(consistency(ctx, cache, d, n, gamma=gamma, alpha=alpha, fuse=fuse, bl_ratio=bl_ratio, pairs=pairs))
        sm.append(smoothness(cache, d, n, alpha=alpha))
    return torch.cat(sm), torch.cat(cs)


def update_candidates(ctx: Context, state: RefineState, offs, gamma: float):
    """(d, n, sim, ok) of the update moves, move axis leading."""
    v, mh, mw = state.d.shape
    center = ctx.center
    col, row = _grid(mh, mw, center.device)
    tx = col[..., None] + _table([o[0] for o in offs], torch.int64, center.device)
    ty = row[..., None] + _table([o[1] for o in offs], torch.int64, center.device)
    ok_m = ((tx >= 0) & (ty >= 0) & (tx < mw) & (ty < mh)).expand(v, mh, mw, len(offs))
    packed = torch.cat([center, ctx.color, state.d[..., None], state.n], dim=-1)
    nb = torch.stack([_roll_cells(packed, dx, dy) for dx, dy in offs], dim=-2)
    n1x, n1y, n1z = nb[..., 6], nb[..., 7], nb[..., 8]
    d_adopt = (n1x * (nb[..., 0] - center[..., 0:1]) + n1y * (nb[..., 1] - center[..., 1:2]) + n1z * nb[..., 5]) / n1z
    sim = _ftz(torch.exp(-_sqdist3(ctx.color[..., None, :], nb[..., 2:5]) * gamma))
    mv = lambda a: a.movedim(-1, 0)  # noqa: E731
    return mv(d_adopt), torch.stack([mv(n1x), mv(n1y), mv(n1z)], dim=-1), mv(sim), mv(ok_m)


def _cross(v1, v2):
    return (v1[1] * v2[2] - v1[2] * v2[1], v2[0] * v1[2] - v1[0] * v2[2], v1[0] * v2[1] - v1[1] * v2[0])


def update_walk(cache: Cache, state: RefineState, moves, sm1_upd, cs1_upd, greedy: bool):
    d_upd, n_upd, sim_upd, ok_upd = moves
    d0, sm0, cs0, n0 = state
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
    n_ref, ok_ref = [], []
    for r in range(8):
        r2 = (r + 1) % 8
        v1 = (cache.ring_dcx[..., r], cache.ring_dcy[..., r], cache.ring_d[..., r] - d0)
        v2 = (cache.ring_dcx[..., r2], cache.ring_dcy[..., r2], cache.ring_d[..., r2] - d0)
        cx_, cy_, cz_ = _cross(v1, v2)
        norm = torch.sqrt(cx_ * cx_ + cy_ * cy_ + cz_ * cz_)
        n_ref.append(torch.stack([cx_ / norm, cy_ / norm, cz_ / norm], dim=-1))
        ok_ref.append(cache.ring_ok[..., r] & cache.ring_ok[..., r2])
    return RefineState(d0, sm0, cs0, n0), torch.stack(n_ref), torch.stack(ok_ref)


def refit_walk(state: RefineState, n_ref, ok_ref, sm1_ref, cs1_ref, greedy: bool) -> RefineState:
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
    return RefineState(state.d, sm0, cs0, n0)


def refine(ctx: Context, st: Settings, q=_keep) -> RefineState:
    """The init state, then ``no_prop`` Jacobi sweeps of the move chain."""
    sc = schedule(st)
    pairs = pairs_from_subsets(view_subsets(st)[0], st.array_width)
    kw = dict(gamma=sc.gamma, alpha=sc.alpha, fuse=sc.fuse, bl_ratio=st.bl_ratio, pairs=pairs)
    d0 = ctx.disp0
    n0 = torch.zeros(d0.shape + (3,), dtype=torch.float32, device=d0.device)
    n0[..., 2] = 1.0
    cache = build_cache(ctx, d0, None, gamma=sc.gamma, steps=sc.kernel_steps, step_size=sc.sp_kernel_step)
    sm, cs = score(ctx, cache, d0[None], n0[None], **kw)
    state = q(RefineState(d0, sm[0], cs[0], n0))
    mh, mw = d0.shape[1:]
    for it in range(st.no_prop):
        steps, step_size = sc.steps_per_iter[it], sc.step_size_per_iter[it]
        cache = build_cache(ctx, state.d, state.n, gamma=sc.gamma, steps=steps, step_size=step_size)
        moves = update_candidates(ctx, state, update_move_offsets(steps, step_size, mw, mh), sc.gamma)
        greedy = it < 4
        sm1, cs1 = score(ctx, cache, moves[0], moves[1], **kw)
        new, n_ref, ok_ref = update_walk(cache, state, moves, sm1, cs1, greedy)
        sm1, cs1 = score(ctx, cache, new.d[None].expand((8,) + tuple(new.d.shape)), n_ref, **kw)
        state = q(refit_walk(new, n_ref, ok_ref, sm1, cs1, greedy))
    return state


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class Outputs(NamedTuple):
    lab: torch.Tensor
    labels: torch.Tensor
    center: torch.Tensor
    color: torch.Tensor
    extent: torch.Tensor
    disp_init: torch.Tensor
    d: torch.Tensor
    n: torch.Tensor
    disp_full: torch.Tensor


def run(rgb: torch.Tensor, st: Settings, *, lowp: bool = False) -> Outputs:
    """The whole pipeline on a (V, H, W, 3) uint8 capture, on its device."""
    q = _bf16 if lowp else _keep
    v, h, w = rgb.shape[:3]
    if v != st.view_num:
        raise ValueError(f"a capture of {v} views for a {st.array_width}x{st.array_height} rig")
    mw, mh = map_size(w, h, st.spixl_size)
    lab = q(rgb_to_lab(rgb))
    labels, spmap = segment(lab, st, mh, mw, q)
    extent = superpixel_extent(labels, spmap.center, st.spixl_size)
    disp_init = depth_init(lab, spmap.center, extent, st, q)
    sc = schedule(st)
    fl = q(flatness(spmap.color, sc.gamma))
    ctx = Context(spmap.center, spmap.color, disp_init, labels,
                  consistency_samples(extent).movedim(3, 2).contiguous(), fl,
                  gather_cells(labels, spmap.color).reshape(-1, 3))
    state = refine(ctx, st, q)
    disp_full = q(rasterize_planes(labels, spmap.center, state.d, state.n))
    return Outputs(lab, labels, spmap.center, spmap.color, extent, disp_init, state.d, state.n, disp_full)
