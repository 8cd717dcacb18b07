"""The port's copies of the JAX package's numpy-only modules against the
originals: ``config``, ``io.images``, ``io.pointcloud`` and
``testing.synthetic`` give equal settings, derived quantities, scenes,
decoded images, points and file bytes."""

import dataclasses
import json

import numpy as np
import pytest

from cl_multiview_stereo_tpu import config as jcfg
from cl_multiview_stereo_tpu.io import images as jimages
from cl_multiview_stereo_tpu.io import pointcloud as jpointcloud
from cl_multiview_stereo_tpu.testing import synthetic as jsynthetic
from cl_multiview_stereo_tpu_torch import config
from cl_multiview_stereo_tpu_torch.io import images, pointcloud
from cl_multiview_stereo_tpu_torch.testing import synthetic
from torch_parity import jax_settings, small_settings

# the settings the port's tests and chip_smoke.py use: the defaults, the 2x2
# and 3x2 (spixl_size 8) parity fixtures, the ragged 16-pixel superpixels,
# and one built by replace()
SETTINGS = {
    "default": lambda: config.SystemSettings(),
    "2x2": small_settings,
    "3x2": lambda: small_settings(array_width=3, array_height=2, bl_ratio=1.0359),
    "spixl16": lambda: config.SystemSettings(spixl_size=16),
    "replaced": lambda: small_settings().replace(
        min_disp=2, max_disp=9, inc=2, neib_hor=2, edge_enable=True, no_prop=1
    ),
}


def _asdicts(mod, s, w=64, h=48):
    return dict(
        settings=dataclasses.asdict(s),
        geometry=dataclasses.asdict(mod.DerivedGeometry.create(w, h, s)),
        slic=dataclasses.asdict(mod.SlicParams.create(s)),
        schedule=dataclasses.asdict(mod.RefinementSchedule.create(s)),
    )


@pytest.mark.parametrize("name", list(SETTINGS))
def test_config_matches_jax(name):
    s = SETTINGS[name]()
    js = jax_settings(s)
    assert isinstance(s, config.SystemSettings) and isinstance(js, jcfg.SystemSettings)
    assert _asdicts(config, s) == _asdicts(jcfg, js)
    got, want = config.build_disp_levels(s), jcfg.build_disp_levels(js)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for a, b in zip(config.build_view_subsets(s), jcfg.build_view_subsets(js)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert config.map_size_for(967, 543, s.spixl_size) == jcfg.map_size_for(967, 543, js.spixl_size)
    np.testing.assert_array_equal(
        config.camera_grid_coords(s.view_num, s.array_width),
        jcfg.camera_grid_coords(js.view_num, js.array_width),
    )


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_settings_json_loads_in_both(tmp_path, writer):
    """A settings file written from either package loads in both, equal."""
    s = SETTINGS["replaced"]()
    src = s if writer == "port" else jax_settings(s)
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(src.to_dict()))
    got, want = config.SystemSettings.from_json(str(path)), jcfg.SystemSettings.from_json(str(path))
    assert got == s and dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="unknown settings keys"):
        config.SystemSettings.from_dict({"no_such_knob": 1})


@pytest.mark.parametrize(
    "scene,kw",
    [("fronto_parallel_scene", dict(disp=7.0, bl_ratio=1.0, seed=5)),
     ("fronto_parallel_scene", dict(disp=40.0, bl_ratio=1.0359)),
     ("two_plane_scene", dict(disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=11)),
     ("two_plane_scene", dict(array_width=3, array_height=2, disp_bg=5.0, disp_fg=9.0,
                              bl_ratio=1.0359, seed=3))],
    ids=["fronto-d7", "fronto-d40", "planes-2x2", "planes-3x2"],
)
def test_synthetic_scenes_bitwise(scene, kw):
    got = getattr(synthetic, scene)(48, 64, **kw)
    want = getattr(jsynthetic, scene)(48, 64, **kw)
    assert got[0].dtype == want[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_image_list_round_trip(tmp_path):
    """PNGs written by the port's save_png; the list read and decoded by both
    packages gives equal arrays; the overlays and gray dumps are equal."""
    views, _ = synthetic.two_plane_scene(37, 53, array_width=2, array_height=2, seed=4)
    for i, im in enumerate(views):
        images.save_png(str(tmp_path / "img" / f"view_{i}.png"), im)
    lst = tmp_path / "data.txt"
    lst.write_text("".join(f"img/view_{i}.png\n\n" for i in range(4)))
    assert images.read_image_list(str(lst)) == jimages.read_image_list(str(lst))
    got, want = images.load_image_array(str(lst), 4), jimages.load_image_array(str(lst), 4)
    np.testing.assert_array_equal(got, views)
    np.testing.assert_array_equal(got, want)
    labels = (np.arange(37 * 53).reshape(37, 53) // 7 % 5).astype(np.int32)
    labels = np.broadcast_to(labels, (4, 37, 53))
    np.testing.assert_array_equal(
        images.draw_segmentation_lines(got, labels), jimages.draw_segmentation_lines(want, labels)
    )
    disp = np.linspace(0, 12, 37 * 53, dtype=np.float32).reshape(37, 53)
    images.save_gray_png(str(tmp_path / "port.png"), disp, 2.0, 11.0)
    jimages.save_gray_png(str(tmp_path / "jax.png"), disp, 2.0, 11.0)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


@pytest.mark.parametrize("stride", [1, 3])
def test_pointcloud_matches_jax(tmp_path, stride):
    rng = np.random.default_rng(stride)
    disp = rng.uniform(-1.0, 12.0, (6, 20, 24)).astype(np.float32)
    disp[2] = 0.0  # a view the vote rejected whole
    rgb = rng.integers(0, 256, (6, 20, 24, 3), dtype=np.uint8)
    got = pointcloud.disparity_to_points(disp, rgb, 3, 1.0359, stride=stride)
    want = jpointcloud.disparity_to_points(disp, rgb, 3, 1.0359, stride=stride)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for colors in (got[1], None):
        pointcloud.save_ply(str(tmp_path / "port.ply"), got[0], colors)
        jpointcloud.save_ply(str(tmp_path / "jax.ply"), want[0], colors)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
        pts, cols = pointcloud.load_ply(str(tmp_path / "jax.ply"))
        np.testing.assert_array_equal(pts, want[0])
        assert (cols is None) == (colors is None)
