"""The Lab conversion and the superpixel extent on the CPU: the routing
that ``ops/color`` and ``ops/superpixel`` do (the CPU runs the plain forms,
never builds a kernel and launches nothing; CUDA takes the kernel; another
device raises), the ctypes bindings against the C entries of
``csrc/color.cu`` and ``csrc/extent.cu``, what the wrappers hand those
entries (the launch itself replaced), the plain forms against the code
they were before the kernels (a frozen copy below), and
``tools.roofline``'s work counts for the two kernels and its issue time.  No JAX: the plain
forms are held to JAX by test_torch_color.py and test_torch_superpixel.py;
the kernels against the plain forms are in test_torch_kernels_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu_torch.config import DerivedGeometry, SystemSettings
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.ops import color, superpixel
from cl_multiview_stereo_tpu_torch.tools import roofline

CSRC = Path(color.__file__).resolve().parent.parent / "csrc"
# 2x2 views of 21x30 pixels at S = 8: a 3x4 map whose last row and column
# of cells are ragged
V, H, W, S = 4, 21, 30, 8
MH, MW = 3, 4


@pytest.fixture
def geom():
    g = DerivedGeometry.create(W, H, SystemSettings(array_width=2, array_height=2, spixl_size=S))
    assert (g.map_h, g.map_w) == (MH, MW)
    return g


def _rgb(dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return torch.from_numpy(rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8))
    return torch.from_numpy((rng.random((V, H, W, 3)) * 255).astype(dtype))


def _walk_inputs(seed=1):
    """Labels that are each pixel's own cell, or with a third of them moved
    to a random cell, and centres jittered inside their cells."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[:H, :W]
    own = (ys // S) * MW + xs // S
    labels = np.where(rng.random((V, H, W)) < 0.33, rng.integers(0, MH * MW, (V, H, W)), own[None])
    cy, cx = np.mgrid[:MH, :MW]
    centers = np.stack([cx * S + S / 2, cy * S + S / 2], axis=-1)[None] + rng.uniform(-3, 3, (V, MH, MW, 2))
    return torch.from_numpy(labels.astype(np.int32)), torch.from_numpy(centers.astype(np.float32))


# -- the plain forms as they were before the kernels (frozen copies)

def _lab_before(rgb):
    def f(t):
        return torch.where(t > 0.008856, torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0), (903.3 * t + 16.0) / 116.0)

    x = rgb.to(torch.float32) * 0.0039216
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    fx = f((r * 0.412453 + g * 0.357580 + b * 0.180423) / 0.950456)
    fy = f((r * 0.212671 + g * 0.715160 + b * 0.072169) / 1.0)
    fz = f((r * 0.019334 + g * 0.119193 + b * 0.950227) / 1.088754)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def _extent_before(labels, centers, geom):
    v, h, w = labels.shape
    s, mh, mw = geom.spixl_size, geom.map_h, geom.map_w
    cx, cy = superpixel.clamp_center(centers[..., 0].to(torch.int64), centers[..., 1].to(torch.int64), w, h, s)
    own_id = torch.arange(mh * mw, dtype=torch.int32).reshape(1, mh, mw)
    flat = labels.reshape(v, h * w)
    ext = torch.zeros((v, mh, mw, 8), dtype=torch.int32)
    for i in range(1, s):
        for k, (dx, dy) in enumerate(superpixel._DIRS):
            px, py = cx + i * dx, cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).reshape(v, -1)
            match = inb & (torch.gather(flat, 1, idx).reshape(v, mh, mw) == own_id)
            ext[..., k] = torch.where(match, i - 1, ext[..., k])
    return ext


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_rgb_to_lab_on_the_cpu_is_the_plain_form_as_before(dtype):
    rgb = _rgb(dtype)
    got = color.rgb_to_lab(rgb)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), color.rgb_to_lab_reference(rgb).view(torch.int32))
    assert torch.equal(got.view(torch.int32), _lab_before(rgb).view(torch.int32))


@pytest.mark.parametrize("seed", [1, 2])
def test_superpixel_extent_on_the_cpu_is_the_plain_form_as_before(geom, seed):
    labels, centers = _walk_inputs(seed)
    got = superpixel.superpixel_extent(labels, centers, geom)
    assert got.dtype == torch.int32 and got.shape == (V, MH, MW, 8)
    assert torch.equal(got, superpixel.superpixel_extent_reference(labels, centers, geom))
    assert torch.equal(got, _extent_before(labels, centers, geom))
    assert 0 < int(got.max()) <= S - 2


@pytest.mark.parametrize("mod", [color, superpixel], ids=["color", "superpixel"])
def test_route_by_device_type(mod):
    assert mod.route("cpu") == mod.route(torch.device("cpu")) == "plain"
    assert mod.route("cuda") == mod.route(torch.device("cuda", 1)) == "kernel"
    with pytest.raises(ValueError, match="no (Lab|extent) kernel"):
        mod.route("meta")


def test_other_devices_raise(geom):
    with pytest.raises(ValueError, match="no Lab kernel"):
        color.rgb_to_lab(torch.zeros((2, 3, 3), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="no extent kernel"):
        superpixel.superpixel_extent(torch.zeros((V, H, W), dtype=torch.int32, device="meta"),
                                     torch.zeros((V, MH, MW, 2), device="meta"), geom)


def test_cpu_never_builds_or_launches(geom, monkeypatch):
    """With the build refused (as where there is no nvcc), CPU calls still
    run, and neither count moves."""
    def refuse(name):
        raise AssertionError(f"a CPU call built {name}")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "_nvcc", lambda: refuse("nvcc"))
    before = (dict(color.LAUNCHES), dict(superpixel.LAUNCHES))
    color.rgb_to_lab(_rgb())
    superpixel.superpixel_extent(*_walk_inputs(), geom)
    assert (color.LAUNCHES, superpixel.LAUNCHES) == before


def _c_entries(source: str) -> dict[str, list[str]]:
    """Each ``extern "C"`` ``*_launch`` of ``csrc/<source>.cu``: its
    parameters' kinds in order, "ptr", "int", "float" or "stream"."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)_launch\(([^)]*)\)', (CSRC / f"{source}.cu").read_text()):
        kinds = []
        for param in (p.strip() for p in " ".join(params.split()).split(",")):
            if param == "void* stream":
                kinds.append("stream")
            elif "*" in param:
                kinds.append("ptr")
            else:
                kinds.append(param.split()[0])
        out[name] = kinds
    return out


@pytest.mark.parametrize("mod, source", [(color, "color"), (superpixel, "extent")], ids=["color", "extent"])
def test_ctypes_signature_matches_the_c_entry(mod, source):
    """Every C entry is bound and counted, and nothing else is; ``_ENTRIES``
    gives ctypes its pointers, ints and floats, then the stream."""
    entries = _c_entries(source)
    assert set(entries) == set(mod._ENTRIES) == set(mod.LAUNCHES)
    for name, (ptrs, ints, floats) in mod._ENTRIES.items():
        assert entries[name] == ["ptr"] * ptrs + ["int"] * ints + ["float"] * floats + ["stream"]


@pytest.mark.parametrize("case", ["uint8", "float32", "float64", "strided", "empty"])
def test_lab_wrapper_passes_the_c_entrys_arguments(monkeypatch, case):
    """What the card's wrapper hands ``lab_convert_launch``, the launch
    itself replaced (CPU tensors): the image as it is when uint8 or
    float32, else a float32 copy, contiguous; the pixel count; the float
    flag; no launch for no pixel."""
    calls = []
    monkeypatch.setattr(color, "_launch", lambda name, dev, *a: calls.append((name, a)))
    rgb = {"uint8": _rgb(), "float32": _rgb(np.float32), "float64": _rgb(np.float64),
           "strided": _rgb().transpose(1, 2)[:, ::2], "empty": _rgb()[:, :0]}[case]
    out = color._lab_kernel(rgb)
    assert out.shape == rgb.shape and out.dtype == torch.float32 and out.is_contiguous()
    if case == "empty":
        assert calls == []
        return
    (name, args), = calls
    assert name == "lab_convert" and len(args) == sum(color._ENTRIES[name])
    assert args[1:] == (out.data_ptr(), rgb.numel() // 3, int(case in ("float32", "float64")))
    assert (args[0] == rgb.data_ptr()) == (case in ("uint8", "float32"))
    with pytest.raises(ValueError, match="expected"):
        color._lab_kernel(rgb[..., :2])
    with pytest.raises(ValueError, match="expected"):
        color._lab_kernel(torch.zeros((), dtype=torch.uint8))


@pytest.mark.parametrize("case", ["int32", "int64", "empty"])
def test_extent_wrapper_passes_the_c_entrys_arguments(geom, monkeypatch, case):
    """What the card's wrapper hands ``extent_walk_launch``, the launch
    itself replaced (CPU tensors): int32 labels (int64 converted), the
    centres, the output, V, H, W, the map's Mh and Mw and S; no launch for
    no superpixel."""
    calls = []
    monkeypatch.setattr(superpixel, "_launch", lambda name, dev, *a: calls.append((name, a)))
    labels, centers = _walk_inputs()
    if case == "int64":
        labels = labels.long()
    if case == "empty":
        labels, centers = labels[:0], centers[:0]
    out = superpixel._extent_kernel(labels, centers, geom)
    assert out.shape == (labels.shape[0], MH, MW, 8) and out.dtype == torch.int32
    if case == "empty":
        assert calls == []
        return
    (name, args), = calls
    assert name == "extent_walk" and len(args) == sum(superpixel._ENTRIES[name])
    assert args[1:] == (centers.data_ptr(), out.data_ptr(), V, H, W, MH, MW, S)
    assert (args[0] == labels.data_ptr()) == (case == "int32")
    with pytest.raises(TypeError):
        superpixel._extent_kernel(labels, centers.double(), geom)
    with pytest.raises(ValueError):
        superpixel._extent_kernel(labels, centers[:, :, :2], geom)


@pytest.mark.parametrize("instructions, items, ghz", [(140, 18_662_400, 1.98), (64, 2_332_800, 1.755), (1, 32, 1.0)])
def test_issue_ms_hand_count(instructions, items, ghz):
    """Issue time: items x instructions lane-instructions, 32 a warp
    instruction, one warp instruction a clock on each of 132 x 4
    schedulers.  At 140 instructions a pixel on the 9x1080x1920 scene and
    1.98 GHz: 81.6 M warp instructions over 1,045 G a second."""
    warp_instructions = instructions * items / 32
    want = warp_instructions / (132 * 4 * ghz * 1e9) * 1e3
    assert roofline.issue_ms(instructions, items, ghz) == pytest.approx(want, rel=1e-12)
    if items == 18_662_400:
        assert warp_instructions == 81_648_000
        assert roofline.issue_ms(instructions, items, ghz) == pytest.approx(0.0781, abs=1e-4)


def test_lab_work_hand_count():
    rgb = _rgb()
    pixels = V * H * W
    assert roofline.lab_work(rgb, color.rgb_to_lab(rgb)) == ((3 + 12) * pixels, 33 * pixels)


def test_extent_work_counts_the_sectors_the_rays_read(geom):
    """The label sectors read, counted one ray pixel at a time: each
    in-view pixel of each ray of each cell marks its 32-byte sector."""
    labels, centers = _walk_inputs()
    sectors = set()
    for v in range(V):
        for my in range(MH):
            for mx in range(MW):
                cx, cy = (int(c) for c in centers[v, my, mx].tolist())
                cx = S if cx < S else cx
                cx = cx - S if cx + S > W else cx
                cy = S if cy < S else cy
                cy = cy - S if cy + S > H else cy
                for i in range(1, S):
                    for dx, dy in superpixel._DIRS:
                        px, py = cx + i * dx, cy + i * dy
                        if 0 <= px < W and 0 <= py < H:
                            sectors.add(((v * H + py) * W + px) * 4 // 32)
    out = superpixel.superpixel_extent(labels, centers, geom)
    assert roofline.extent_work(labels, centers, geom, out) == (32 * len(sectors) + 8 * V * MH * MW + 32 * V * MH * MW,
                                                                0)
