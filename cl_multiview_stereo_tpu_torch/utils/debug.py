"""Fail-fast validation of stage outputs (port of
``cl_multiview_stereo_tpu/utils/debug.py``).

``validate_stage``/``validate_artifacts`` raise the JAX module's
``FloatingPointError`` messages, and :func:`checked` stands in for the JAX
module's ``checkify`` wrapper.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator

import torch


def _leaves(value: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(key path, leaf) pairs in JAX's ``keystr`` notation: ``.field`` for
    NamedTuple fields, ``[i]`` for sequence items, ``['k']`` for dict keys."""
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        for f in value._fields:
            yield from _leaves(getattr(value, f), f"{path}.{f}")
    elif isinstance(value, (list, tuple)):
        for i, x in enumerate(value):
            yield from _leaves(x, f"{path}[{i}]")
    elif isinstance(value, dict):
        for k in sorted(value):
            yield from _leaves(value[k], f"{path}[{k!r}]")
    elif value is not None:
        yield path, value


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that it raises ``FloatingPointError`` at the first
    non-finite floating-point leaf of its outputs, with
    :func:`validate_stage`'s message under ``fn``'s name: the opt-in debug
    mode of JAX's ``checkify`` float checks, applied to what ``fn``
    returns.  Out-of-bounds indices need no check of their own: torch's
    indexing raises on them (a device-side assert on a card), where XLA
    clamps, which is what JAX's index checks are for.  The check reads the
    outputs on the host, so it waits for the device."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        validate_stage(getattr(fn, "__name__", "output"), out)
        return out

    return wrapper


def validate_stage(name: str, value: Any, *, allow_zero: bool = True) -> None:
    """Fail fast if a stage emitted non-finite values (or all zeros when a
    stage can never legitimately produce them)."""
    for path, leaf in _leaves(value):
        t = torch.as_tensor(leaf)
        if not t.is_floating_point():
            continue
        label = f"{name}{path}"
        finite = torch.isfinite(t)
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise FloatingPointError(f"stage '{label}': {bad}/{t.numel()} non-finite values")
        if not allow_zero and t.numel() and not bool(t.any()):
            raise FloatingPointError(f"stage '{label}': all-zero output")


def validate_artifacts(art) -> None:
    """Fail-fast sweep over a full PipelineArtifacts."""
    for field in art._fields:
        validate_stage(field, getattr(art, field))
