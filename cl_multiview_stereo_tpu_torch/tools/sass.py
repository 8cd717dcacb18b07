"""What the compiler made of each hand kernel: registers and spills from
ptxas, and the count of SASS instructions from ``cuobjdump -sass``.

Usage:

  python -m cl_multiview_stereo_tpu_torch.tools.sass [slic cost_volume ...] \\
      [--csrc DIR]

Each named ``csrc/<name>.cu`` (default: every source) is compiled afresh
with ``kernels/build.py``'s flags into ``_build/sass/`` (``--csrc`` takes
the sources from another directory, e.g. an unpacked parent commit's
``cl_multiview_stereo_tpu_torch/csrc``).  Prints one JSON line per kernel
entry: ``source``, ``kernel``, ``registers``, ``spill_bytes`` (stores plus
loads), ``sass_instructions`` (the static count of the kernel's code, NOPs
left out), ``sfu`` (the static count of each special-function op,
``MUFU.EX2``, ``MUFU.RCP``, ..., and of ``FCHK``, the divide's range check
that guards its slow path), ``inner_loops`` (each innermost loop of the
code: a backward branch and the instructions from its target to it, with
its start address, its instruction count and its ``sfu`` counts) and
``card`` (name, power limit, SM clock and its maximum, as nvidia-smi reads
them).  Needs nvcc and cuobjdump, so it runs where the kernels build.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

from cl_multiview_stereo_tpu_torch.kernels import build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(\S[^;]*);")
_BRANCH = re.compile(r"^BRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)")


# Itanium codes of the builtin types a kernel template takes
_TYPE_CODES = {"h": "unsigned char", "f": "float", "i": "int", "j": "unsigned int", "x": "long long",
               "d": "double"}


# an integer or bool template argument: L, its type's code, its value, E
_LITERAL = re.compile(r"L([bij])(n?\d+)E")


def short_name(sym: str) -> str:
    """The innermost identifier of an Itanium-mangled symbol, with its
    template arguments spelled out where each is a builtin type or an
    integer or bool value
    (``_ZN12_GLOBAL__N_113assign_kernelE...`` -> ``assign_kernel``;
    ``..._118consistency_kernelILb1EEEv...`` -> ``consistency_kernel<true>``;
    ``..._110lab_kernelIhEEv...`` -> ``lab_kernel<unsigned char>``;
    ``..._113raster_kernelILi4ELi4ELb0EEEv...`` -> ``raster_kernel<4, 4,
    false>``); an unmangled symbol as it is."""
    if not sym.startswith("_Z"):
        return sym
    i = 3 if sym.startswith("_ZN") else 2
    name = sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        n = int(sym[i:j])
        name, i = sym[j:j + n], j + n
    if not sym.startswith("I", i):
        return name
    args, i = [], i + 1
    while not sym.startswith("E", i):
        if m := _LITERAL.match(sym, i):
            kind, value = m.groups()
            value = value.replace("n", "-")
            args.append(("true" if value == "1" else "false") if kind == "b" else value)
            i = m.end()
        elif sym[i:i + 1] in _TYPE_CODES:
            args.append(_TYPE_CODES[sym[i]])
            i += 1
        else:
            return name
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log: str) -> dict[str, dict]:
    """Per kernel entry of a ``-Xptxas=-v`` log: registers and spill bytes."""
    out: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = short_name(m.group(1))
            out[cur] = {"registers": None, "spill_bytes": 0}
        elif cur is not None and (m := _SPILL.search(line)):
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := _REGS.search(line)):
            out[cur]["registers"] = int(m.group(1))
    return out


def sass_code(listing: str) -> dict[str, list[tuple[int, str]]]:
    """Per function of a ``cuobjdump -sass`` listing: its instructions as
    (address, text without the predicate), NOPs left out."""
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in listing.splitlines():
        if m := _FUNCTION.match(line):
            cur = short_name(m.group(1))
            out[cur] = []
        elif cur is not None and (m := _INSTR.match(line)):
            op = m.group(2).split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op and op[0] != "NOP":
                out[cur].append((int(m.group(1), 16), " ".join(op)))
    return out


def sass_counts(listing: str) -> dict[str, int]:
    """Per function of a ``cuobjdump -sass`` listing: its instructions,
    NOPs left out."""
    return {name: len(code) for name, code in sass_code(listing).items()}


def sfu_counts(code) -> dict[str, int]:
    """The ``MUFU.*`` and ``FCHK`` instructions of ``code`` ((address,
    text) pairs), by op."""
    out: dict[str, int] = {}
    for _, text in code:
        op = text.split()[0]
        if op.startswith("MUFU.") or op == "FCHK":
            out[op] = out.get(op, 0) + 1
    return dict(sorted(out.items()))


def inner_loops(code) -> list[dict]:
    """The innermost loops of ``code``: each backward branch with the
    instructions from its target to it, when no other such span lies
    inside; their start address, instruction count and :func:`sfu_counts`."""
    spans = []
    for addr, text in code:
        if (m := _BRANCH.match(text)) and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [a for a in spans if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in spans)]
    loops = []
    for lo, hi in sorted(set(inner)):
        body = [(a, t) for a, t in code if lo <= a <= hi]
        loops.append({"at": hex(lo), "instructions": len(body), "sfu": sfu_counts(body)})
    return loops


def _card() -> str:
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def report(name: str, csrc: Path) -> list[dict]:
    """Builds ``csrc/<name>.cu`` afresh and returns one record per kernel."""
    nvcc = build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    out_dir = build.BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}")
    listing = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    regs, code = ptxas_report(proc.stderr), sass_code(listing)
    recs = []
    for k in sorted(set(regs) | set(code)):
        body = code.get(k)
        recs.append({"source": name, "kernel": k, **regs.get(k, {}),
                     "sass_instructions": None if body is None else len(body),
                     "sfu": None if body is None else sfu_counts(body),
                     "inner_loops": None if body is None else inner_loops(body)})
    return recs


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="sass")
    ap.add_argument("names", nargs="*", help="csrc/<name>.cu sources (default: all)")
    ap.add_argument("--csrc", type=Path, default=build.CSRC, help="directory of the sources")
    args = ap.parse_args(argv)
    names = args.names or sorted(p.stem for p in args.csrc.glob("*.cu"))
    card = _card()
    recs = []
    for name in names:
        for rec in report(name, args.csrc):
            rec["card"] = card
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
