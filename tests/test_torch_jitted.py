"""``MVSPipeline.jitted()`` on a CPU pipeline against ``run()`` and against
the JAX package's ``pipe.jitted()``, and the device tables that let the
forward be captured on a card (``device.device_table``)."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline, PipelineArtifacts
from torch_parity import CPU, jax_settings, n, scenes, small_settings

SCENES = {
    "a": dict(disp_bg=5.0, disp_fg=9.0, seed=11),
    "b": dict(disp_bg=6.0, disp_fg=8.0, seed=3),
}


def _scene(name):
    return scenes("two_plane_scene", 48, 64, array_width=2, array_height=2, bl_ratio=1.0, **SCENES[name])


def _leaves(art: PipelineArtifacts):
    for f in art._fields:
        x = getattr(art, f)
        if isinstance(x, torch.Tensor):
            yield f, x
        else:
            yield from ((f"{f}.{g}", getattr(x, g)) for g in x._fields)


@pytest.fixture(scope="module")
def runs():
    s = small_settings()
    pipe = MVSPipeline.create(64, 48, s, device=CPU)
    fwd = pipe.jitted()
    jfwd = JaxPipeline.create(64, 48, jax_settings(s)).jitted()
    out = {}
    for name in ("a", "b"):
        views, jviews = _scene(name)
        out[name] = (pipe.run(views), fwd(views), jfwd(jviews))
    return pipe, fwd, out


@pytest.mark.parametrize("name", list(SCENES))
def test_jitted_equals_run(runs, name):
    eager, jitted, _ = runs[2][name]
    for (f, a), (_, b) in zip(_leaves(jitted), _leaves(eager)):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("name", list(SCENES))
def test_jitted_matches_jax_jitted(runs, name):
    """tests/test_torch_pipeline.py's bounds against JAX's one-jit forward."""
    _, port, ref = runs[2][name]
    assert (n(port.labels) == np.asarray(ref.labels)).mean() > 0.995
    agree = (n(port.disp_init) == np.asarray(ref.disp_init)).mean()
    assert agree >= 0.99, f"disp_init agreement {agree}"
    close = (np.abs(n(port.disp_full) - np.asarray(ref.disp_full)) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"


@pytest.mark.parametrize("shape", [(3, 48, 64, 3), (4, 64, 48, 3), (4, 48, 64)])
def test_jitted_rejects_another_shape(runs, shape):
    with pytest.raises(ValueError, match="the pipeline takes"):
        runs[1](np.zeros(shape, np.uint8))


def test_jitted_refuses_an_unknown_device():
    pipe = MVSPipeline.create(64, 48, small_settings(), device="meta")
    with pytest.raises(ValueError, match="no one-program forward"):
        pipe.jitted()


@pytest.mark.parametrize("values, dtype", [
    ([0.1, 1.0 / 3.0, 2.5e-8, -7.0], torch.float32),
    ([-1, 0, 1, 40], torch.int64),
    ([3, 0, 8], torch.int32),
    (np.array([[1.5, 2.25], [0.98765, 1e30]]), torch.float32),
    (np.arange(6, dtype=np.int32), torch.int32),
])
def test_device_table_has_torch_tensor_bits(values, dtype):
    got = device_table(values, dtype, CPU)
    want = torch.tensor(np.asarray(values).tolist(), dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert device_table(values, dtype, CPU) is got  # built once, then shared


def test_device_table_keys_on_value_and_dtype():
    a = device_table([1.0, 2.0], torch.float32, CPU)
    assert device_table([1.0, 2.5], torch.float32, CPU) is not a
    assert device_table([1.0, 2.0], torch.float64, CPU).dtype == torch.float64
    t = torch.arange(3, dtype=torch.int32)
    assert device_table(t, torch.int32, CPU) is t  # a tensor passes through
