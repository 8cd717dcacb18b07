"""The port's scene prefetcher and ``run_scenes`` against the JAX package's:
the same scenes in the same order with the same bytes, the same errors,
and ``run_scenes`` on a CPU pipeline bitwise the port's ``run()`` per scene
and within tests/test_torch_pipeline.py's bounds of JAX's ``run_scenes``."""

import numpy as np
import pytest
import torch
from PIL import Image

from cl_multiview_stereo_tpu.io import prefetcher as jprefetcher
from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu_torch.io import native_loader, prefetcher
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from torch_parity import CPU, jax_settings, n, scenes, small_settings


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """tests/test_prefetcher.py's fixture: 3 scenes of 2 random 24x32 views."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(0)
    scene_paths, arrays = [], []
    for s in range(3):
        paths, views = [], []
        for v in range(2):
            arr = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
            p = root / f"s{s}_v{v}.png"
            Image.fromarray(arr).save(p)
            paths.append(str(p))
            views.append(arr)
        scene_paths.append(paths)
        arrays.append(np.stack(views))
    return scene_paths, arrays


def _all(cls, scene_paths, **kw):
    with cls(scene_paths, 24, 32, depth=2, **kw) as pf:
        return [(i, n(a)) for i, a in pf], pf


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_matches_jax_order_and_bytes(scene_files, depth):
    scene_paths, arrays = scene_files
    with prefetcher.ScenePrefetcher(scene_paths, 24, 32, depth=depth) as pf:
        got = list(pf)
        assert pf.backend == "native"
    with jprefetcher.ScenePrefetcher(scene_paths, 24, 32, depth=depth) as jpf:
        want = list(jpf)
    assert [i for i, _ in got] == [i for i, _ in want] == [0, 1, 2]
    for (_, a), (_, b), direct in zip(got, want, arrays):
        assert isinstance(a, np.ndarray) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, direct)


def test_prefetcher_cpu_device_yields_tensors(scene_files):
    scene_paths, arrays = scene_files
    got, _ = _all(prefetcher.ScenePrefetcher, scene_paths, device="cpu")
    assert [i for i, _ in got] == [0, 1, 2]
    for (_, a), want in zip(got, arrays):
        np.testing.assert_array_equal(a, want)


def test_prefetcher_pil_backend_when_toolchain_missing(scene_files, monkeypatch):
    _pil_backend(monkeypatch)
    scene_paths, arrays = scene_files
    got, pf = _all(prefetcher.ScenePrefetcher, scene_paths)
    assert pf.backend == "pil"
    for (_, a), want in zip(got, arrays):
        np.testing.assert_array_equal(a, want)


def test_prefetcher_rejects_unequal_view_counts(scene_files):
    scene_paths, _ = scene_files
    ragged = [scene_paths[0], scene_paths[1][:1]]
    with pytest.raises(ValueError, match="same view count"):
        prefetcher.ScenePrefetcher(ragged, 24, 32)
    with pytest.raises(ValueError, match="same view count"):
        jprefetcher.ScenePrefetcher(ragged, 24, 32)


def _pil_backend(monkeypatch):
    monkeypatch.setattr(native_loader, "_library", lambda: (None, "g++ not found"))


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_prefetcher_decode_failure(tmp_path, monkeypatch, backend):
    if backend == "pil":
        _pil_backend(monkeypatch)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    with prefetcher.ScenePrefetcher([[str(bad), str(bad)]], 24, 32) as pf:
        assert pf.backend == backend
        with pytest.raises(IOError):
            list(pf)


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_prefetcher_close_before_the_end(scene_files, monkeypatch, backend):
    """Leaving early stops the decoders (close joins them)."""
    if backend == "pil":
        _pil_backend(monkeypatch)
    scene_paths, arrays = scene_files
    pf = prefetcher.ScenePrefetcher(scene_paths * 3, 24, 32, depth=1)
    first = next(iter(pf))
    pf.close()
    pf.close()
    np.testing.assert_array_equal(first[1], arrays[0])


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetcher_pil_backend_decodes_ahead_in_order(scene_files, monkeypatch, depth):
    _pil_backend(monkeypatch)
    scene_paths, arrays = scene_files
    with prefetcher.ScenePrefetcher(scene_paths * 2, 24, 32, depth=depth, threads=3) as pf:
        got = list(pf)
    assert [i for i, _ in got] == list(range(6))
    for (_, a), want in zip(got, arrays * 2):
        np.testing.assert_array_equal(a, want)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """tests/test_pipeline.py's scene and a second one of other disparities,
    as PNG lists, streamed in the order a, b, a by both packages."""
    root = tmp_path_factory.mktemp("stream")
    s = small_settings()
    kw = dict(array_width=2, array_height=2, bl_ratio=1.0)
    made = {
        "a": scenes("two_plane_scene", 48, 64, disp_bg=5.0, disp_fg=9.0, seed=11, **kw),
        "b": scenes("two_plane_scene", 48, 64, disp_bg=6.0, disp_fg=8.0, seed=3, **kw),
    }
    lists = {}
    for name, (views, jviews) in made.items():
        np.testing.assert_array_equal(views, jviews)
        for v, im in enumerate(views):
            Image.fromarray(im).save(root / f"{name}{v}.png")
        lists[name] = str(root / f"{name}.txt")
        (root / f"{name}.txt").write_text("".join(f"{name}{v}.png\n" for v in range(4)))
    order = [lists["a"], lists["b"], lists["a"]]
    pipe = MVSPipeline.create(64, 48, s, device=CPU)
    got = list(prefetcher.run_scenes(pipe, order, depth=2))
    jpipe = JaxPipeline.create(64, 48, jax_settings(s))
    want = list(jprefetcher.run_scenes(jpipe, order, depth=2))
    return pipe, made, got, want


def test_run_scenes_is_bitwise_run_per_scene(stream):
    pipe, made, got, _ = stream
    assert [i for i, _ in got] == [0, 1, 2]
    for (_, art), name in zip(got, "aba"):
        ref = pipe.run(made[name][0])
        for f in ("lab", "labels", "extent", "disp_init", "flatness", "disp_full"):
            assert torch.equal(getattr(art, f), getattr(ref, f)), f
        for f in ("d", "sm", "cs", "n"):
            assert torch.equal(getattr(art.state, f), getattr(ref.state, f)), f


def test_run_scenes_matches_jax(stream):
    _, _, got, want = stream
    assert [i for i, _ in want] == [0, 1, 2]
    for (_, port), (_, ref) in zip(got, want):
        assert (n(port.labels) == np.asarray(ref.labels)).mean() > 0.995
        agree = (n(port.disp_init) == np.asarray(ref.disp_init)).mean()
        assert agree >= 0.99, f"disp_init agreement {agree}"
        close = (np.abs(n(port.disp_full) - np.asarray(ref.disp_full)) <= 1e-3).mean()
        assert close >= 0.98, f"disp_full within 1e-3 on {close}"
