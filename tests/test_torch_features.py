"""The port's ``ops/features`` (Harris corners, descriptors, mutual-nearest
matching) against ``cl_multiview_stereo_tpu/ops/features.py`` on the CPU.

Agreement on these scenes, as measured: the gray image is bitwise JAX's;
the box sums differ by ulps (XLA rewrites its cumulative sum as a tree
scan, torch sums in order) and every keypoint position still equals JAX's;
with at least as many match slots as good matches the match tables are
equal slot for slot, padding included.  Where ``max_matches`` truncates
the good matches, the pick among similarities tied within ulps follows
each library's matmul rounding, so only the count of valid slots is equal
and the sets overlap (bound below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.ops import features as jf
from cl_multiview_stereo_tpu.testing import synthetic as jax_synthetic
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import gray_image
from cl_multiview_stereo_tpu_torch.ops import features
from cl_multiview_stereo_tpu_torch.testing import synthetic
from torch_parity import CPU, n, t

PAIRS = np.asarray([[0, 1], [0, 2], [1, 3], [2, 3], [0, 3], [1, 2]], np.int32)


def _jax_gray(rgb):
    return jnp.asarray(rgb).astype(jnp.float32) @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32)


@pytest.fixture(scope="module")
def scene():
    """tests/test_sfm_pipeline.py's 2x2 scene through both Harris detectors."""
    rgb, _ = synthetic.fronto_parallel_scene(120, 160, array_width=2, array_height=2, disp=8.0, bl_ratio=1.0)
    jgray = _jax_gray(rgb)
    gray = gray_image(torch.as_tensor(rgb))
    return dict(rgb=rgb, gray=gray, jgray=jgray,
                kp=features.harris_keypoints(gray, k=192), jkp=jf.harris_keypoints(jgray, k=192))


def test_gray_image_is_jax_gray_bitwise(scene):
    np.testing.assert_array_equal(n(scene["gray"]), np.asarray(scene["jgray"]))


def test_box_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 41, 53)).astype(np.float32)
    got = n(features._box(t(x), 2))
    want = np.asarray(jf._box(jnp.asarray(x), 2))
    # differences of running sums that reach ~60 (a few of their ulps)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _rolled_neighbour_max(resp: np.ndarray, rad: int) -> np.ndarray:
    """JAX's NMS neighbourhood: 80 wrapped rolls, centre left out."""
    out = np.full_like(resp, -np.inf)
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            if dx or dy:
                out = np.maximum(out, np.roll(resp, (-dy, -dx), axis=(1, 2)))
    return out


@pytest.mark.parametrize("rad", [1, 4])
def test_neighbour_max_keeps_strict_maxima_only(rad):
    """Plateaus (equal neighbours) are no maxima, as in JAX; with the -inf
    border band the separable form equals the rolled one wherever the
    response is finite."""
    rng = np.random.default_rng(rad)
    resp = rng.integers(0, 6, (2, 30, 37)).astype(np.float32)  # many ties
    m = max(rad, 5)
    resp[:, :m], resp[:, -m:], resp[:, :, :m], resp[:, :, -m:] = -np.inf, -np.inf, -np.inf, -np.inf
    got = n(features._neighbour_max(t(resp), rad))
    want = _rolled_neighbour_max(resp, rad)
    inner = np.isfinite(resp)
    np.testing.assert_array_equal(got[inner], want[inner])
    np.testing.assert_array_equal(resp > got, resp > want)
    assert (resp == got)[inner].any(), "the case has no plateau"


def test_harris_keypoints_match_jax(scene):
    kp, jkp = scene["kp"], scene["jkp"]
    # every keypoint position equals JAX's, in JAX's order
    np.testing.assert_array_equal(n(kp.xy), np.asarray(jkp.xy))
    s, js = n(kp.score), np.asarray(jkp.score)
    np.testing.assert_array_equal(np.isfinite(s), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(s[fin], js[fin], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(kp.desc), np.asarray(jkp.desc), rtol=0, atol=1e-6)


def test_harris_keypoints_on_a_constant_image_tie_in_index_order():
    """All scores -inf: lax.top_k keeps the lowest pixel indices, in order."""
    gray = np.full((2, 24, 32), 0.5, np.float32)
    kp = features.harris_keypoints(t(gray), k=40)
    jkp = jf.harris_keypoints(jnp.asarray(gray), k=40)
    assert np.isneginf(n(kp.score)).all()
    np.testing.assert_array_equal(n(kp.xy), np.asarray(jkp.xy))
    np.testing.assert_array_equal(n(kp.xy)[0, :3], [[0, 0], [1, 0], [2, 0]])
    np.testing.assert_array_equal(n(kp.desc), np.asarray(jkp.desc))


def test_match_pairs_equal_jax_when_slots_hold_every_match(scene):
    """Fewer good rows than ``max_matches``: the padding slots tie at -inf
    and take the lowest rows in order, as in JAX."""
    jm = jf.match_pairs(scene["jkp"], jnp.asarray(PAIRS), max_matches=192)
    m = features.match_pairs(convert.keypoints(scene["jkp"], CPU), t(PAIRS, torch.int32), max_matches=192)
    valid = np.asarray(jm.valid)
    assert 0 < valid.sum(1).max() < 192, "the case needs padding slots"
    np.testing.assert_array_equal(n(m.valid), valid)
    np.testing.assert_array_equal(n(m.idx), np.asarray(jm.idx))
    assert all(torch.equal(a, b) for a, b in zip(m, convert.matches(jm, CPU)))


def test_match_pairs_truncated_overlaps_jax(scene):
    """``max_matches`` below the good count: the valid counts are equal and
    the chosen sets overlap on >= 0.85 of their matches (all of them here;
    0.9375 on the shifted texture below, and 0.875 for the worst pair when
    each side matches its own keypoints: similarities of an exactly shifted
    scene tie within ulps)."""
    jm = jf.match_pairs(scene["jkp"], jnp.asarray(PAIRS), max_matches=96)
    m = features.match_pairs(convert.keypoints(scene["jkp"], CPU), t(PAIRS, torch.int32), max_matches=96)
    np.testing.assert_array_equal(n(m.valid).sum(1), np.asarray(jm.valid).sum(1))
    for p in range(len(PAIRS)):
        mine = _match_set(n(m.idx)[p][n(m.valid)[p]])
        ref = _match_set(np.asarray(jm.idx)[p][np.asarray(jm.valid)[p]])
        assert len(mine & ref) >= 0.85 * len(ref), (p, len(mine & ref), len(ref))


def test_match_pairs_screens_only_view_a():
    """JAX screens view a's padding keypoints only: a pair whose b side is
    all padding still matches, and the port keeps that.  The similarities
    of the true matches are 1 within ulps, so the slot order may differ and
    the match sets are compared."""
    rng = np.random.default_rng(2)
    desc = rng.normal(size=(2, 16, 8)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    desc[1] = desc[0][rng.permutation(16)]
    score = np.zeros((2, 16), np.float32)
    score[1] = -np.inf
    kp = jf.Keypoints(xy=jnp.zeros((2, 16, 2)), score=jnp.asarray(score), desc=jnp.asarray(desc))
    jm = jf.match_pairs(kp, jnp.asarray([[0, 1], [1, 0]], jnp.int32), max_matches=16)
    m = features.match_pairs(convert.keypoints(kp, CPU), t([[0, 1], [1, 0]], torch.int32), max_matches=16)
    assert np.asarray(jm.valid)[0].sum() == 16 and not np.asarray(jm.valid)[1].any()
    np.testing.assert_array_equal(n(m.valid), np.asarray(jm.valid))
    assert _match_set(n(m.idx)[0]) == _match_set(np.asarray(jm.idx)[0])
    np.testing.assert_array_equal(n(m.idx)[1], np.asarray(jm.idx)[1])


def _match_set(idx: np.ndarray) -> set:
    return {tuple(int(i) for i in row) for row in idx}


def test_harris_and_matching_on_shifted_texture():
    """tests/test_sfm.py's scene and bounds, on each package's texture."""
    out = {}
    for name, tex, harris, match, to in (
        ("port", synthetic.texture, features.harris_keypoints, features.match_pairs,
         lambda a, dt=torch.float32: t(a, dt)),
        ("jax", jax_synthetic.texture, jf.harris_keypoints, jf.match_pairs, lambda a, dt=None: jnp.asarray(a)),
    ):
        img = tex(120, 160, seed=4).astype(np.float32).mean(-1)
        gray = to(np.stack([img, np.roll(img, 7, axis=1)]) / 255.0)
        kp = harris(gray, k=128, nms_radius=4, patch=8)
        assert np.isfinite(n(kp.score)).any()
        m = match(kp, to(np.asarray([[0, 1]], np.int32), torch.int32), max_matches=64)
        idx, valid = n(m.idx)[0], n(m.valid)[0]
        assert valid.sum() > 20
        d = n(kp.xy)[1][idx[valid, 1]] - n(kp.xy)[0][idx[valid, 0]]
        good = (np.abs(d[:, 0] - 7) <= 1) & (np.abs(d[:, 1]) <= 1)
        assert good.mean() > 0.8, f"{name}: shift agreement {good.mean()}"
        out[name] = (n(kp.xy), _match_set(idx[valid]))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    # 64 slots truncate the good matches: as in test_match_pairs_truncated_overlaps_jax
    shared = len(out["port"][1] & out["jax"][1])
    assert shared >= 0.85 * len(out["jax"][1]), (shared, len(out["jax"][1]))
