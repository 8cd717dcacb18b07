"""utils/debug: the port's fail-fast checks raise the JAX module's
``FloatingPointError`` messages on the same values."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.ops.slic import SuperpixelMap as JaxSuperpixelMap
from cl_multiview_stereo_tpu.utils import debug as jdebug
from cl_multiview_stereo_tpu_torch.ops.slic import SuperpixelMap
from cl_multiview_stereo_tpu_torch.utils import debug


def _spmap(cls, module, bad):
    a = module.zeros((2, 3, 4), dtype=module.float32)
    center = module.ones((2, 3, 4, 2), dtype=module.float32)
    if bad:
        center[0, 1, 2, 0] = float("nan")
        center[1, 0, 0, 1] = float("inf")
    return cls(center=center, color=module.ones((2, 3, 4, 3), dtype=module.float32), count=a, disp=a)


CASES = {
    "nan_array": lambda m: (np.array([1.0, np.nan, np.inf], np.float32), {}),
    "all_zero": lambda m: (np.zeros((2, 2), np.float32), {"allow_zero": False}),
    "int_ignored": lambda m: (np.zeros((2, 2), np.int32), {"allow_zero": False}),
    "finite": lambda m: (np.ones((2, 2), np.float32), {"allow_zero": False}),
}


def _message(fn, *a, **k):
    try:
        fn(*a, **k)
    except FloatingPointError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_validate_stage_matches_jax(case):
    value, kw = CASES[case](np)
    want = _message(jdebug.validate_stage, "stage_x", value, **kw)
    got = _message(debug.validate_stage, "stage_x", torch.as_tensor(value), **kw)
    assert got == want
    assert (got is None) == (case in ("int_ignored", "finite"))


def test_validate_stage_names_the_field_as_jax_does():
    want = _message(jdebug.validate_stage, "spmap", _spmap(JaxSuperpixelMap, np, True))
    got = _message(debug.validate_stage, "spmap", _spmap(SuperpixelMap, torch, True))
    assert got == want == "stage 'spmap.center': 2/48 non-finite values"


def test_validate_artifacts_walks_every_field():
    good = _spmap(SuperpixelMap, torch, False)
    debug.validate_stage("spmap", good)
    art = SuperpixelMap(center=good.center, color=good.color, count=good.count,
                        disp=torch.full((2, 3, 4), float("nan")))
    with pytest.raises(FloatingPointError, match="stage 'disp': 24/24 non-finite values"):
        debug.validate_artifacts(art)


def test_checked_matches_jax_checked_on_log():
    """tests/test_utils_io.py's case: log(1) passes as 0, log(-1) raises."""
    import jax
    import jax.numpy as jnp

    g = jdebug.checked(jax.jit(jnp.log))
    f = debug.checked(torch.log)
    np.testing.assert_allclose(np.asarray(g(jnp.asarray([1.0]))), [0.0])
    np.testing.assert_array_equal(f(torch.tensor([1.0])).numpy(), np.asarray(g(jnp.asarray([1.0]))))
    with pytest.raises(Exception, match="nan"):
        g(jnp.asarray([-1.0]))
    with pytest.raises(FloatingPointError, match="stage 'log': 1/1 non-finite values"):
        f(torch.tensor([-1.0]))


def test_checked_walks_nested_outputs_and_keeps_the_name():
    def stages(x):
        return {"a": x, "b": (x, torch.log(x))}

    f = debug.checked(stages)
    assert f.__name__ == "stages"
    f(torch.ones(2))
    with pytest.raises(FloatingPointError, match=r"stage 'stages\['b'\]\[1\]': 1/2 non-finite"):
        f(torch.tensor([1.0, -1.0]))
