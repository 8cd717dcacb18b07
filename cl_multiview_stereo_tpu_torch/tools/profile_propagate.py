"""Each component of one propagate sweep, and the card's gather rate on the
sweep's table (port of the JAX package's ``tools/profile_propagate.py`` and
``tools/profile_gathers.py``, one tool since the card needs one timing
method).

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.profile_propagate [--engine gather|strips|both] \\
      [--hw 1080x1920] [--set key=val ...] [--runs 5] [--save state.npz] [--device cuda|cpu]

On ``bench.py``'s scene (``profile_stages.scene``), the slice's own stages
build the refinement's initial state (``roofline.sweep0_state``); every
component then runs at sweep 0's ``steps``/``step_size`` on that state:

- ``propagate_iteration[0]``: the whole sweep (``refine.propagate_iteration``);
- under the gather engine ``propagate_iteration[0], plain form``: the same
  sweep on the plain forms, ``build_cell_cache``, ``smoothness_from_cache``
  and ``consistency_from_cache`` per ``score_chunk`` batch, as the card ran
  it before the scoring went to the kernels (on the CPU the two are one
  function);
- ``rasterize_table`` and ``build_cell_cache``: the sweep's cache, the
  former ``refine.rasterize_table`` (on a card one launch of
  ``raster_planes``), the latter ``smoothness.cell_cache`` (on a card one
  launch of ``smooth_cache``); ``build_cell_cache, plain form`` beside it;
- ``consistency_moves (update)``: the consistency of all update moves as
  the sweep scores them, ``consistency.consistency_moves`` under the
  engine's rule (on a card one launch of the CUDA kernel);
- under the gather engine ``consistency_from_cache x1``: the plain form on
  one ``score_chunk`` batch of the update moves (its ``cache.ras[flat]``
  gather), beside the sweep;
- ``smoothness_moves (update)``: the smoothness of all update moves,
  ``smoothness.smoothness_moves`` (on a card one launch of
  ``smooth_moves``), and ``smoothness_from_cache x1``, the plain form on
  one batch, beside the sweep;
- ``update_candidates``: the update moves' candidate planes (on a card one
  launch of ``chain_moves``);
- ``accept_chain``: ``refine.move_chain`` scored by a function that returns
  the real scorer's outputs, recorded beforehand, so only the accept work
  and the refit normals run (on a card ``chain_update`` and
  ``chain_refit``);
- ``init_state``: the initial state's own stage, beside the sweep.

A component beside the sweep has ``per_iteration`` 0 and no share.

Each is timed with CUDA events on the current stream after one warm-up:
the median of ``--runs`` runs, each started on an idle device (a
synchronize before its start event) and with no host read inside.  These
ms hold the host's launch gaps, and an eager component of hundreds of
launches varies by up to twofold between calls.  Beside them each prints
its device ms and kernel launches (one more run under ``torch.profiler``:
the device ops' own time summed, copies and fills not counted as
launches), how often one sweep runs it and its share of the sweep; one
line then sets the sum of the parts against the total, in both ms.

The gather-rate ladder reads a table of ``V*H*W`` rows (one per pixel, as
``cache.ras``) with as many indices as one ``score_chunk`` batch of
``consistency_from_cache`` gathers (``B*P*Mh*9*Mw``): table widths 1, 4 and
8 f32; uniform random, sorted, row-coherent (``profile_gathers.py``'s
``(y // 8 * 8) * W + x``) and the real indices of sweep 0's first batch;
int64 through indexing (PyTorch's ``vectorized_gather_kernel``), int32
through ``index_select``, and the 2-D ``(V*H, W, 4)`` form.  Each entry
prints its M rows/s and GB/s against its byte bound
(``roofline.gather_work``: the distinct 32-byte sectors that hold the rows
read, the indices and the output, over 3.35 TB/s).

The last line is one JSON object: ``engine``, ``components`` (engine ->
name -> ms, device_ms, launches, per_iteration, share), ``parts_vs_total``,
``ladder`` (entry -> rows, ms, m_rows_per_s, gb_per_s, bytes, bound_ms),
``scene``, ``card``, ``settings``, ``hw``.  ``--save`` writes each engine's
``propagate_iteration[0]`` state as an npz (``<engine>_<field>``).  With
``--device cpu`` every component and entry runs once and every time, rate
and launch count is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.tools import profile_stages
from cl_multiview_stereo_tpu_torch.tools.profile_stages import PROFILE_TRIES  # noqa: F401  (the tries, here too)

ENGINES = ("gather", "strips")
LADDER_WIDTHS = (1, 4, 8)
# row-coherent indices: rows in bands of this many (profile_gathers.py)
COHERENT_ROWS = 8
TOTAL = "propagate_iteration[0]"


class Sweep0(NamedTuple):
    """Sweep 0's inputs and the pieces its components share."""

    ctx: object  # refine.RefineContext
    state: object  # refine.RefineState, the initial state
    kw: dict  # gamma, alpha, fuse, bl_ratio, pairs
    sched: object  # config.RefinementSchedule
    cache: object  # refine.IterCache of sweep 0
    moves: tuple  # refine.update_candidates of sweep 0
    score_chunk: int


class Component(NamedTuple):
    fn: Callable[[], object]
    per_iteration: int  # runs of it in one sweep (0: not part of the sweep)


class Entry(NamedTuple):
    """One gather of the ladder: ``fn()`` reads ``rows`` (flat row ids) of a
    table of ``n_rows`` rows of ``row_bytes`` through ``indices``."""

    name: str
    fn: Callable[[], torch.Tensor]
    table: torch.Tensor
    rows: torch.Tensor
    indices: tuple
    n_rows: int
    row_bytes: int


class RecordIndex:
    """Stands in for ``cache.ras``: gathers as the table does and keeps the
    index it was given."""

    def __init__(self, table: torch.Tensor) -> None:
        self.table, self.index = table, None

    def __getitem__(self, index):
        self.index = index
        return self.table[index]


def setup(settings, h: int, w: int, device) -> Sweep0:
    from cl_multiview_stereo_tpu_torch.ops import refine
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import scene
    from cl_multiview_stereo_tpu_torch.tools.roofline import sweep0_state

    rgb = torch.as_tensor(scene(settings, h, w), device=device)
    ctx, state, kw, sched = sweep0_state(settings, rgb, device)
    steps, step_size = sched.steps_per_iter[0], sched.step_size_per_iter[0]
    cache = refine.build_cache(ctx, state.d, state.n, gamma=kw["gamma"], steps=steps, step_size=step_size)
    mh, mw = state.d.shape[1:]
    offs = refine._update_move_offsets(steps, step_size, mw, mh)
    moves = refine.update_candidates(ctx, state, offs, kw["gamma"])
    return Sweep0(ctx, state, kw, sched, cache, moves, refine.SCORE_CHUNK)


def components(sw: Sweep0, engine: str) -> dict[str, Component]:
    """The sweep's components under ``engine``, in the sweep's order, and
    ``init_state``."""
    from cl_multiview_stereo_tpu_torch.ops import consistency, refine, smoothness

    ctx, state, kw, sched, cache, moves, chunk = sw
    steps, step_size = sched.steps_per_iter[0], sched.step_size_per_iter[0]
    d_upd, n_upd = moves[0], moves[1]
    d_b, n_b = d_upd[:chunk], n_upd[:chunk]

    def score(d_c, n_c):
        return refine.score_moves(ctx, cache, d_c, n_c, **kw, score_chunk=chunk, cons_engine=engine)

    def total():
        return refine.propagate_iteration(ctx, state, 0, **kw, steps=steps, step_size=step_size,
                                          score_chunk=chunk, cons_engine=engine)

    scores = []

    def record(d_c, n_c):
        scores.append(score(d_c, n_c))
        return scores[-1]

    refine.move_chain(cache, state, moves, 0, record)

    def accept_chain():
        replay = iter(scores)
        return refine.move_chain(cache, state, moves, 0, lambda d_c, n_c: next(replay))

    d_c, n_c = d_upd.contiguous(), n_upd.contiguous()
    rule = "gather" if engine == "gather" else "strips"
    cons = [("consistency_moves (update)", Component(
        lambda: consistency.consistency_moves(ctx, cache, d_c, n_c, score_chunk=chunk, rule=rule, **kw), 2))]
    plain = []
    if engine == "gather":
        plain = [(f"{TOTAL}, plain form", Component(lambda: plain_sweep(sw), 0))]
        cons.append(("consistency_from_cache x1", Component(
            lambda: refine.consistency_from_cache(ctx, cache, d_b, n_b, **kw), 0)))
    reach = dict(gamma=kw["gamma"], steps=steps, step_size=step_size)
    # the plain scorer reads the plain cache's tap fields, which the card's
    # cache does not hold
    plain_cache = refine.build_cell_cache(ctx, state.d, **reach)
    return dict([
        (TOTAL, Component(total, 1)),
        *plain,
        ("rasterize_table", Component(
            lambda: refine.rasterize_table(ctx.labels, ctx.center, ctx.ras_color, state.d, state.n), 1)),
        ("build_cell_cache", Component(lambda: smoothness.cell_cache(ctx, state.d, **reach), 1)),
        ("build_cell_cache, plain form", Component(lambda: refine.build_cell_cache(ctx, state.d, **reach), 0)),
        *cons,
        ("smoothness_moves (update)", Component(
            lambda: smoothness.smoothness_moves(cache, d_c, n_c, alpha=kw["alpha"], score_chunk=chunk), 2)),
        ("smoothness_from_cache x1", Component(
            lambda: refine.smoothness_from_cache(plain_cache, d_b, n_b, alpha=kw["alpha"]), 0)),
        ("update_candidates", Component(
            lambda: refine.update_candidates(ctx, state, refine._update_move_offsets(
                steps, step_size, state.d.shape[2], state.d.shape[1]), kw["gamma"]), 1)),
        ("accept_chain", Component(accept_chain, 1)),
        ("init_state", Component(lambda: refine.init_state(
            ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step), 0)),
    ])


def plain_sweep(sw: Sweep0):
    """Sweep 0 on the plain forms on any device: ``refine.propagate_iteration``
    with ``build_cell_cache``, ``rasterize_table_reference``,
    ``update_candidates_reference``, ``move_chain_reference``, and
    ``smoothness_from_cache`` and ``consistency_from_cache`` per
    ``score_chunk`` batch, in place of the routed cache, table, candidates,
    chain and scorers."""
    from cl_multiview_stereo_tpu_torch.ops import consistency, refine

    ctx, state, kw, sched, chunk = sw.ctx, sw.state, sw.kw, sw.sched, sw.score_chunk
    steps, step_size = sched.steps_per_iter[0], sched.step_size_per_iter[0]
    cache = refine.build_cell_cache(ctx, state.d, gamma=kw["gamma"], steps=steps, step_size=step_size)._replace(
        ras=refine.rasterize_table_reference(ctx.labels, ctx.center, ctx.ras_color, state.d, state.n))
    mh, mw = state.d.shape[1:]
    moves = refine.update_candidates_reference(ctx, state, refine._update_move_offsets(steps, step_size, mw, mh),
                                               kw["gamma"])

    def score(d_c, n_c):
        sm = torch.cat([refine.smoothness_from_cache(cache, d_c[k:k + chunk], n_c[k:k + chunk], alpha=kw["alpha"])
                        for k in range(0, d_c.shape[0], chunk)])
        return sm, consistency.consistency_moves_reference(ctx, cache, d_c.contiguous(), n_c.contiguous(),
                                                           score_chunk=chunk, rule="gather", **kw)

    return refine.move_chain_reference(cache, state, moves, 0, score)


def real_indices(sw: Sweep0) -> torch.Tensor:
    """The flat row ids that ``consistency_from_cache`` gathers from
    ``cache.ras`` for sweep 0's first batch of update moves."""
    from cl_multiview_stereo_tpu_torch.ops import refine

    rec = RecordIndex(sw.cache.ras)
    refine.consistency_from_cache(sw.ctx, sw.cache._replace(ras=rec), sw.moves[0][:sw.score_chunk],
                                  sw.moves[1][:sw.score_chunk], **sw.kw)
    return rec.index.reshape(-1)


def ladder(sw: Sweep0, real: torch.Tensor, seed: int = 0) -> Iterator[Entry]:
    """The gather-rate ladder's entries, one table alive at a time."""
    v, h, w = sw.ctx.labels.shape
    n, r = v * h * w, real.numel()
    dev = real.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda hi: torch.randint(0, hi, (r,), generator=g, device=dev)  # noqa: E731
    idx = {"random": rand(n)}
    idx["sorted"] = torch.sort(idx["random"]).values
    yy, xx = rand(h), rand(w)
    idx["coherent"] = yy // COHERENT_ROWS * COHERENT_ROWS * w + xx
    idx["real"] = real
    del yy
    for width in LADDER_WIDTHS:
        shape = (n,) if width == 1 else (n, width)
        table = torch.rand(shape, generator=g, device=dev)
        for pattern, rows in idx.items():
            yield Entry(f"(N,{width}) {pattern} int64", lambda t=table, i=rows: t[i], table, rows, (rows,), n,
                        4 * width)
        if width == 4:
            for pattern in ("random", "real"):
                i32 = idx[pattern].to(torch.int32)
                yield Entry(f"(N,4) {pattern} int32 index_select", lambda t=table, i=i32: torch.index_select(t, 0, i),
                            table, idx[pattern], (i32,), n, 16)
                del i32
            table3 = table.view(v * h, w, 4)
            rr = rand(v * h)
            yield Entry("(V*H,W,4) random 2-D int64", lambda: table3[rr, xx], table3, rr * w + xx, (rr, xx), n, 16)
            del table3, rr
        del table


def median_ms(fn: Callable, runs: int) -> float:
    """Median device ms of ``fn()`` over ``runs`` runs after one warm-up,
    each run between CUDA events on the current stream, started on an idle
    device."""
    fn()
    marks = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def device_work(fn: Callable) -> tuple[float, int]:
    """(device ms, kernel launches) of one ``fn()`` under torch.profiler:
    every device op's own time, and its kernels (copies and fills not
    counted), from a whole trace (``profile_stages.whole_profile``)."""
    p = profile_stages.whole_profile(fn)
    return p.device_ms, profile_stages.trace_launches(p)[0]


def profile_engine(sw: Sweep0, engine: str, runs: int, on_card: bool) -> tuple[dict, dict, object]:
    """(component records, parts against the total, the total's state)."""
    comps = components(sw, engine)
    recs, state = {}, comps[TOTAL].fn()
    for name, c in comps.items():
        if on_card:
            ms = median_ms(c.fn, runs)
            device_ms, launches = device_work(c.fn)
            recs[name] = {"ms": ms, "device_ms": device_ms, "launches": launches, "per_iteration": c.per_iteration}
        else:
            c.fn()
            recs[name] = {"ms": None, "device_ms": None, "launches": None, "per_iteration": c.per_iteration}
    total = recs[TOTAL]
    parts = {"parts_ms": None, "total_ms": total["ms"], "parts_device_ms": None, "total_device_ms": total["device_ms"],
             "parts_launches": None, "total_launches": total["launches"]}
    for name, r in recs.items():
        r["share"] = None if not on_card or r["per_iteration"] == 0 else r["ms"] * r["per_iteration"] / total["ms"]
    if on_card:
        inner = [r for name, r in recs.items() if name != TOTAL]
        parts.update({f"parts_{k}": sum(r[k] * r["per_iteration"] for r in inner)
                      for k in ("ms", "device_ms", "launches")})
    for name, r in recs.items():
        ms = "not measured" if r["ms"] is None else f"{r['ms']:10.3f} ms {r['device_ms']:8.3f} device ms"
        launches = "" if r["launches"] is None else f"{r['launches']:6d} launches"
        share = "" if r["share"] is None else f"{r['share']:7.1%} of the sweep"
        how = "beside" if r["per_iteration"] == 0 else f"x{r['per_iteration']}"
        print(f"[{engine}] {name:28s} {how:9s} {ms} {launches} {share}", flush=True)
    if on_card:
        print(f"[{engine}] sum of the parts {parts['parts_ms']:.3f} ms, {parts['parts_device_ms']:.3f} device ms "
              f"({parts['parts_launches']} launches) against the total {parts['total_ms']:.3f} ms, "
              f"{parts['total_device_ms']:.3f} device ms ({parts['total_launches']} launches)", flush=True)
    return recs, parts, state


def measure_ladder(sw: Sweep0, runs: int, on_card: bool) -> dict:
    from cl_multiview_stereo_tpu_torch.tools.roofline import bound, gather_work

    real = real_indices(sw)
    recs = {}
    for e in ladder(sw, real):
        out = e.fn()
        n_bytes, n_ops = gather_work(e.n_rows, e.row_bytes, e.rows, out, *e.indices)
        del out
        rec = {"rows": e.rows.numel(), "ms": None, "m_rows_per_s": None, "gb_per_s": None, "bytes": n_bytes,
               "bound_ms": bound(n_bytes, n_ops)[0]}
        rate = "not measured"
        if on_card:
            ms = median_ms(e.fn, runs)
            rec.update(ms=ms, m_rows_per_s=rec["rows"] / ms / 1e3, gb_per_s=n_bytes / ms / 1e6)
            rate = f"{ms:9.3f} ms {rec['m_rows_per_s']:10.1f} M rows/s {rec['gb_per_s']:8.1f} GB/s"
        print(f"[ladder] {e.name:32s} {rec['rows']:,} rows {rate}, bound {rec['bound_ms']:.4f} ms", flush=True)
        recs[e.name] = rec
    return recs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="profile_propagate")
    ap.add_argument("--engine", default="both", choices=ENGINES + ("both",))
    ap.add_argument("--hw", default="1080x1920", help="image height x width")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="override a SystemSettings field")
    ap.add_argument("--runs", type=int, default=5, help="timed runs per component, after one warm-up")
    ap.add_argument("--save", metavar="NPZ", help="write each engine's propagate_iteration[0] state here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (runs, measures nothing)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from cl_multiview_stereo_tpu_torch.cli import _parse_overrides, resolve_device
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.device import card_name
    from cl_multiview_stereo_tpu_torch.tools.profile_stages import parse_hw

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    overrides = _parse_overrides(args.set)
    s = SystemSettings().replace(**overrides)
    h, w = parse_hw(args.hw)
    sw = setup(s, h, w, dev)
    v, mh, mw = sw.state.d.shape
    scene = {"views": v, "map": [mh, mw], "pairs": len(sw.kw["pairs"]), "update_moves": sw.moves[0].shape[0],
             "score_chunk": sw.score_chunk, "table_rows": v * h * w}
    print(f"scene: {v} views of {h}x{w}, map {mh}x{mw}, {scene['pairs']} pairs, "
          f"{scene['update_moves']} update moves, score_chunk {sw.score_chunk}", flush=True)
    rec = {"engine": args.engine, "components": {}, "parts_vs_total": {}, "ladder": None, "scene": scene,
           "card": card_name() if on_card else "cpu", "settings": overrides, "hw": f"{h}x{w}"}
    states = {}
    for engine in ENGINES if args.engine == "both" else (args.engine,):
        rec["components"][engine], rec["parts_vs_total"][engine], st = profile_engine(sw, engine, args.runs, on_card)
        states.update({f"{engine}_{f}": getattr(st, f).cpu().numpy() for f in st._fields})
    if args.save:
        np.savez(args.save, **states)
    rec["ladder"] = measure_ladder(sw, args.runs, on_card)
    scene["ladder_rows"] = next(iter(rec["ladder"].values()))["rows"]
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
