"""The port's native image loader against the JAX package's: the same C
source, built by the port's own g++ build, decodes PNGs and a JPEG to the
same bytes as JAX's loader and as the port's PIL loader, and raises
``IOError`` on a missing file and on bad bytes."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cl_multiview_stereo_tpu.io import native_loader as jnative
from cl_multiview_stereo_tpu_torch.io import native_loader
from cl_multiview_stereo_tpu_torch.io.images import load_image_array
from cl_multiview_stereo_tpu_torch.native import build

REPO = Path(__file__).resolve().parent.parent


def _list(tmp_path, names) -> str:
    lst = tmp_path / "data.txt"
    lst.write_text("\n".join(names))
    return str(lst)


@pytest.fixture()
def scene_list(tmp_path):
    """tests/test_native_loader.py's four random 30x40 PNGs."""
    rng = np.random.default_rng(0)
    names = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(tmp_path / f"v{i}.png")
        names.append(f"v{i}.png")
    return _list(tmp_path, names)


@pytest.fixture()
def jpeg_list(tmp_path):
    """One PNG and one JPEG of a smooth image (the JPEG decode is lossy, so
    only the two libjpeg builds are held bitwise to each other)."""
    y, x = np.mgrid[0:30, 0:40]
    img = np.stack([x * 6, y * 8, (x + y) * 3], -1).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray(img).save(tmp_path / "b.jpg", quality=90)
    return _list(tmp_path, ["a.png", "b.jpg"])


def test_loader_source_is_jax_copy():
    port = (REPO / "cl_multiview_stereo_tpu_torch" / "native" / "loader.cc").read_bytes()
    assert port == (REPO / "cl_multiview_stereo_tpu" / "native" / "loader.cc").read_bytes()


def test_library_builds_into_build_dir():
    path, _ = build.build()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libmvsloader-")
    assert native_loader.native_available()


def test_native_matches_pil_and_jax_on_pngs(scene_list):
    got = native_loader.load_image_array_native(scene_list)
    assert got.dtype == np.uint8 and got.shape == (4, 30, 40, 3)
    np.testing.assert_array_equal(got, load_image_array(scene_list))
    np.testing.assert_array_equal(got, jnative.load_image_array_native(scene_list))


def test_native_matches_jax_on_jpeg(jpeg_list):
    got = native_loader.load_image_array_native(jpeg_list, threads=1)
    want = jnative.load_image_array_native(jpeg_list, threads=1)
    np.testing.assert_array_equal(got, want)
    # the JPEG is lossy, not a copy of the PNG
    assert np.abs(got[1].astype(int) - got[0]).max() <= 16


def test_view_num_takes_the_first_views(scene_list):
    got = native_loader.load_image_array_native(scene_list, view_num=2)
    np.testing.assert_array_equal(got, load_image_array(scene_list)[:2])


@pytest.mark.parametrize("case", ["missing", "bad_bytes", "bad_second"])
def test_errors_raise_ioerror_as_jax(tmp_path, scene_list, case):
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"not a png at all")
    names = {"missing": ["nope.png"], "bad_bytes": ["bad.png"], "bad_second": ["v0.png", "bad.png"]}[case]
    lst = _list(tmp_path, names)
    with pytest.raises(IOError) as got:
        native_loader.load_image_array_native(lst)
    with pytest.raises(IOError) as want:
        jnative.load_image_array_native(lst)
    assert str(got.value) == str(want.value)


def test_missing_toolchain_falls_back_to_pil(scene_list, monkeypatch):
    monkeypatch.setattr(native_loader, "_library", lambda: (None, "g++ not found"))
    assert not native_loader.native_available()
    np.testing.assert_array_equal(native_loader.load_image_array_native(scene_list), load_image_array(scene_list))


def test_missing_compiler_is_reported_as_missing_toolchain(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(build.ToolchainMissing, match="g.. not found"):
        build.build()


def test_compile_error_raises_with_the_log(monkeypatch, tmp_path):
    """Only a missing toolchain falls back; a source that does not compile
    raises with g++'s message."""
    src = tmp_path / "loader.cc"
    src.write_text("int broken(\n")
    monkeypatch.setattr(build, "SRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for loader.cc") as err:
        build.build()
    assert not isinstance(err.value, build.ToolchainMissing)
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.fixture()
def stale_library(tmp_path, monkeypatch):
    """A ``BUILD_DIR`` holding, under the cached name, a file that does not
    open (as a library built against libpng, on a host without it); the
    loader's caches cleared before and after."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.BUILD_DIR.mkdir()
    stale = build.library_path()
    stale.write_bytes(b"not a shared library\n")
    build.load.cache_clear()
    native_loader._library.cache_clear()
    yield stale
    build.load.cache_clear()
    native_loader._library.cache_clear()


def _require_toolchain():
    try:
        build._check_headers(build._gxx())
    except build.ToolchainMissing as e:
        pytest.skip(f"needs g++ and the libpng/libjpeg headers: {e}")


@pytest.mark.parametrize("host", ["headers_missing", "toolchain_present", "fresh_build_will_not_open"])
def test_cached_library_that_will_not_open(stale_library, scene_list, monkeypatch, host):
    """A cached library that does not open is built again through the host
    checks: without the headers the decode is PIL's, with a warning (as the
    JAX loader's); with them the rebuilt library decodes natively; a fresh
    build that still does not open raises ``OSError``, never
    ``ToolchainMissing``."""
    from cl_multiview_stereo_tpu_torch.io.images import read_image_list
    from cl_multiview_stereo_tpu_torch.io.prefetcher import ScenePrefetcher

    pil = load_image_array(scene_list)
    if host == "headers_missing":
        def no_headers(gxx):
            raise build.ToolchainMissing("libpng/libjpeg headers not found (png.h: No such file)")

        monkeypatch.setattr(build, "_check_headers", no_headers)
        with pytest.warns(UserWarning, match="decoding with PIL") as caught:
            got = native_loader.load_image_array_native(scene_list)
        message = str(caught[0].message)
        assert "png.h" in message and f"the cached {stale_library.name} does not open" in message
        np.testing.assert_array_equal(got, pil)
        with ScenePrefetcher([read_image_list(scene_list)], 30, 40) as pf:
            assert pf.backend == "pil"
            (idx, rgb), = list(pf)
        assert idx == 0
        np.testing.assert_array_equal(rgb, pil)
        assert stale_library.read_bytes() == b"not a shared library\n"  # not deleted, not replaced
        return
    _require_toolchain()
    if host == "toolchain_present":
        got = native_loader.load_image_array_native(scene_list)
        assert native_loader.native_available()
        np.testing.assert_array_equal(got, pil)
        assert stale_library.read_bytes().startswith(b"\x7fELF")  # rebuilt in place
        build.ctypes.CDLL(str(stale_library))  # the cached name now opens
        return

    def will_not_open(path, *args, **kwargs):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(build.ctypes, "CDLL", will_not_open)
    with pytest.raises(OSError, match="the freshly built .* does not open") as err:
        native_loader.load_image_array_native(scene_list)
    assert not isinstance(err.value, build.ToolchainMissing)
    assert str(stale_library) in str(err.value)
