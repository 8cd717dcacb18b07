"""PatchMatch's move chain on the card: the update moves' candidates and
the two accept walks of a sweep (``csrc/chain.cu``).

The JAX package computes them with XLA (``ops/refine.py``:
``gather_update_moves`` and ``_propagate_iteration``'s ``update_body`` and
``refine_body`` scans); the reference ran them inside its propagate kernel
(``clcode.cl:1649-1900``).  The port's plain forms are in ``ops/refine``:
``update_candidates_reference`` (M ``torch.roll``s of a 9-wide cell pack),
``update_phase_reference`` (the update moves' walk and the 8 ring refit
normals) and ``refit_phase_reference`` (the refits' walk), about 500
launches a sweep together; the kernels are bitwise them on the card.

:func:`candidates`, :func:`update` and :func:`refit` launch
``chain_moves``, ``chain_update`` and ``chain_refit`` on CUDA tensors (or
raise) and run the plain forms on CPU tensors (:func:`route`); nothing
falls back from one to the other.  ``refine.update_candidates`` and
``refine.move_chain`` call them, so a sweep's chain on the card is
``chain_moves``, the update moves' scores, ``chain_update``, the refits'
scores, ``chain_refit``: the same for ``refine.propagate_iteration``,
``parallel/spatial.block_sweep`` (which builds only its band's candidates,
``rows``) and ``parallel/sharded_pipeline``.

The kernels take dense arrays, so the wrappers make every input
contiguous, a copy only where it is not; they launch on the current stream
(so ``MVSPipeline.jitted()``'s graph captures them) and launch nothing for
an empty output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.kernels import build
from cl_multiview_stereo_tpu_torch.kernels.build import check_input
from cl_multiview_stereo_tpu_torch.ops.refine import (
    IterCache,
    RefineContext,
    RefineState,
    refit_phase_reference,
    update_candidates_reference,
    update_phase_reference,
)

# Each kernel's launches since import (or since the caller reset them):
# chip_smoke.py reads them to show that the main path went through the
# kernels.
LAUNCHES = {"chain_moves": 0, "chain_update": 0, "chain_refit": 0}
# pointer, int and float arguments of each C entry, in order, before the
# stream (kernels/build.py's library "chain")
_ENTRIES = {
    "chain_moves": (9, 6, 1),
    "chain_update": (20, 3, 0),
    "chain_refit": (10, 2, 0),
}
# the ring refits a cell walks after its update moves
REFITS = 8
# the largest |dx|, |dy| of an update move: cell indices stay in int32
MAX_OFFSET = 2 ** 30


def route(device) -> str:
    """Where a tensor on ``device`` walks its chain: ``"plain"`` (the plain
    forms) on the CPU, ``"kernel"`` on a CUDA device; any other device
    raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no chain kernel for device {device}")


@functools.cache
def _entry(name: str):
    """The C entry ``<name>_launch`` of ``csrc/chain.cu``, built at first use."""
    fn = getattr(build.load("chain"), f"{name}_launch")
    ptrs, ints, floats = _ENTRIES[name]
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_float] * floats + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, dev: torch.device, *args) -> None:
    """Calls kernel ``name``'s entry with ``args`` and the current stream of
    ``dev``; raises on a CUDA error and counts the launch."""
    fn = _entry(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _dense(name: str, t: torch.Tensor, dtype, shape: tuple, dev) -> torch.Tensor:
    """``t`` contiguous (a copy only where it is not), checked for the C entry."""
    t = t.contiguous()
    check_input(name, t, dtype, shape, dev)
    return t


def _launch_candidates(ctx, state_in, offs, gamma, rows):
    dev = state_in.d.device
    v, mh, mw = state_in.d.shape
    row0, n = (0, mh) if rows is None else (int(rows[0]), int(rows[1]))
    if row0 < 0 or n < 0 or row0 + n > mh:
        raise ValueError(f"rows {rows} are not a band of the map's {mh} cell rows")
    if any(abs(int(o)) >= MAX_OFFSET for off in offs for o in off):
        raise ValueError(f"an update move's offset is not below {MAX_OFFSET}")
    f32 = torch.float32
    center = _dense("ctx.center", ctx.center, f32, (v, mh, mw, 2), dev)
    color = _dense("ctx.color", ctx.color, f32, (v, mh, mw, 3), dev)
    d = _dense("state_in.d", state_in.d, f32, (v, mh, mw), dev)
    nrm = _dense("state_in.n", state_in.n, f32, (v, mh, mw, 3), dev)
    m = len(offs)
    table = device_table([[int(dx), int(dy)] for dx, dy in offs] or [[0, 0]], torch.int32, dev)
    d_c = torch.empty((m, v, n, mw), dtype=f32, device=dev)
    n_c = torch.empty((m, v, n, mw, 3), dtype=f32, device=dev)
    sim = torch.empty((m, v, n, mw), dtype=f32, device=dev)
    ok = torch.empty((m, v, n, mw), dtype=torch.bool, device=dev)
    if d_c.numel():
        _launch("chain_moves", dev, center.data_ptr(), color.data_ptr(), d.data_ptr(), nrm.data_ptr(),
                table.data_ptr(), d_c.data_ptr(), n_c.data_ptr(), sim.data_ptr(), ok.data_ptr(),
                m, v, mh, mw, row0, n, gamma)
    return d_c, n_c, sim, ok


def candidates(ctx: RefineContext, state_in: RefineState, offs, gamma: float,
               rows: tuple[int, int] | None = None):
    """The update moves at offsets ``offs`` ((dx, dy) each, in move order)
    for the cells of the whole map, or of its cell rows ``rows`` = (row0,
    n): (d (M, V, rows, Mw), n (M, V, rows, Mw, 3), sim, ok), each
    neighbour read wrapped around the whole map and ``ok`` where it lies
    on it.

    A CUDA ``state_in.d`` launches ``chain_moves`` once (``gamma`` rounded
    to float32, as torch's multiply by a Python float rounds it); a CPU one
    runs ``refine.update_candidates_reference``; another device raises."""
    if route(state_in.d.device) == "plain":
        return update_candidates_reference(ctx, state_in, offs, gamma, rows=rows)
    return _launch_candidates(ctx, state_in, offs, gamma, rows)


def _launch_update(cache, state, moves, sm1, cs1, greedy):
    dev = state.d.device
    shape = tuple(state.d.shape)
    m = moves[0].shape[0]
    f32, u8 = torch.float32, torch.bool
    ms, ms3, r8 = (m, *shape), (m, *shape, 3), (*shape, 8)
    ins = [
        _dense("d_c", moves[0], f32, ms, dev), _dense("n_c", moves[1], f32, ms3, dev),
        _dense("sim", moves[2], f32, ms, dev), _dense("ok", moves[3], u8, ms, dev),
        _dense("sm1", sm1, f32, ms, dev), _dense("cs1", cs1, f32, ms, dev),
        _dense("state.d", state.d, f32, shape, dev), _dense("state.sm", state.sm, f32, shape, dev),
        _dense("state.cs", state.cs, f32, shape, dev), _dense("state.n", state.n, f32, (*shape, 3), dev),
        _dense("cache.ring_dcx", cache.ring_dcx, f32, r8, dev), _dense("cache.ring_dcy", cache.ring_dcy, f32, r8, dev),
        _dense("cache.ring_d", cache.ring_d, f32, r8, dev), _dense("cache.ring_ok", cache.ring_ok, u8, r8, dev),
    ]
    out = RefineState(*(torch.empty(shape, dtype=f32, device=dev) for _ in range(3)),
                      n=torch.empty((*shape, 3), dtype=f32, device=dev))
    n_ref = torch.empty((REFITS, *shape, 3), dtype=f32, device=dev)
    ok_ref = torch.empty((REFITS, *shape), dtype=u8, device=dev)
    cells = state.d.numel()
    if cells:
        _launch("chain_update", dev, *(t.data_ptr() for t in (*ins, *out, n_ref, ok_ref)), m, cells, int(greedy))
    return out, n_ref, ok_ref


def update(cache: IterCache, state: RefineState, moves, sm1, cs1, greedy: bool):
    """The walk over the update moves ``moves`` (from :func:`candidates`,
    for the cells of ``state``) on their scores ``sm1``, ``cs1`` (M, ...),
    then the 8 ring refit normals of the new d from ``cache``'s ring
    fields: (state, n_ref (8, ..., 3), ok_ref (8, ...)).

    A CUDA ``state.d`` launches ``chain_update`` once; a CPU one runs
    ``refine.update_phase_reference``; another device raises."""
    if route(state.d.device) == "plain":
        return update_phase_reference(cache, state, moves, sm1, cs1, greedy)
    return _launch_update(cache, state, moves, sm1, cs1, greedy)


def _launch_refit(state, n_ref, ok_ref, sm1, cs1, greedy):
    dev = state.d.device
    shape = tuple(state.d.shape)
    f32 = torch.float32
    rs = (REFITS, *shape)
    ins = [
        _dense("n_ref", n_ref, f32, (*rs, 3), dev), _dense("ok_ref", ok_ref, torch.bool, rs, dev),
        _dense("sm1", sm1, f32, rs, dev), _dense("cs1", cs1, f32, rs, dev),
        _dense("state.sm", state.sm, f32, shape, dev), _dense("state.cs", state.cs, f32, shape, dev),
        _dense("state.n", state.n, f32, (*shape, 3), dev),
    ]
    sm, cs = (torch.empty(shape, dtype=f32, device=dev) for _ in range(2))
    nrm = torch.empty((*shape, 3), dtype=f32, device=dev)
    cells = state.d.numel()
    if cells:
        _launch("chain_refit", dev, *(t.data_ptr() for t in (*ins, sm, cs, nrm)), cells, int(greedy))
    return RefineState(d=state.d, sm=sm, cs=cs, n=nrm)


def refit(state: RefineState, n_ref, ok_ref, sm1, cs1, greedy: bool) -> RefineState:
    """The walk over the 8 refits (from :func:`update`) on their scores
    ``sm1``, ``cs1`` (8, ...); d is ``state.d``, unchanged.

    A CUDA ``state.d`` launches ``chain_refit`` once; a CPU one runs
    ``refine.refit_phase_reference``; another device raises."""
    if route(state.d.device) == "plain":
        return refit_phase_reference(state, n_ref, ok_ref, sm1, cs1, greedy)
    return _launch_refit(state, n_ref, ok_ref, sm1, cs1, greedy)
