"""Issue-pipe counts of the built kernels, read from their SASS.

``cuobjdump -sass`` of the kernel library lists each entry function's
instructions in address order, branch and call targets as addresses, and
the bodies of the device functions it calls (``fe_inv``) after its own
``EXIT``.  The counts here are per thread, each instruction weighted by how
often it runs: the product of the trip counts of the loops around it (a
loop is a branch back to an earlier address; the caller gives the trip
counts region by region, the entry's own body first and then each called
body in address order, each in the order of its back branches), and a
called body by its call site's weight.  Both arms of a branch inside a
loop count at the loop's weight; a warp runs both wherever its lanes
diverge.

Pipes, per the SM's issue rates (four sub-partitions, each issuing one warp
instruction a clock):

- ALU: ``LOP3, SHF, IADD3, PRMT, ISETP, SEL, LEA``, 16 lanes a clock a
  sub-partition (64 per SM): 2 issue cycles a warp;
- FMA: ``IMAD.WIDE`` 4 issue cycles a warp; every other ``IMAD`` and
  ``VIADD`` 2.  ``fma`` counts 2-cycle units, so both pipes run at 64 a
  clock per SM.

Moves, loads, stores, branches and uniform-datapath instructions count
only in ``issued``.  What a kernel issues is not the work its function
needs: ``chip_smoke.py`` reads these counts in its build phase and prints
them beside the operations of ``kernels/work.py``, from which the bounds
are computed, so the gap between the two shows the compiled code's own
overhead.  ``cuobjdump`` sits beside ``nvcc`` on the card's machine.  Run alone: ``python -m
vuke_tpu_torch.kernels.sass LIBRARY`` prints every entry function's loops
per region (what its trip counts must list) and opcode counts, unweighted.
"""

from __future__ import annotations

import os
import re
import subprocess
from dataclasses import dataclass

from . import entry_name, find_nvcc

ALU_OPS = ("LOP3", "SHF", "IADD3", "PRMT", "ISETP", "SEL", "LEA")
FMA_OPS = ("IMAD", "VIADD")

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")


@dataclass
class Pipes:
    """Per-thread weighted counts of one kernel."""
    alu: float = 0.0       # ALU-pipe instructions
    fma: float = 0.0       # FMA-pipe issue cycles / 2
    issued: float = 0.0    # every instruction

    def add(self, other: "Pipes", weight: float = 1.0) -> None:
        self.alu += weight * other.alu
        self.fma += weight * other.fma
        self.issued += weight * other.issued


def find_cuobjdump() -> str:
    path = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.access(path, os.X_OK):
        raise FileNotFoundError(f"cuobjdump not found beside nvcc ({path})")
    return path


def dump(binary) -> str:
    """``cuobjdump -sass`` of a cubin, object or shared library."""
    return subprocess.run([find_cuobjdump(), "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout


def parse(text: str) -> dict[str, list[tuple]]:
    """SASS text -> {mangled entry name: [(address, opcode, target)]}, the
    target the address a branch or call goes to, else None.  A function
    listed twice keeps its first listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = [] if m.group(1) in funcs else funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line) if cur is not None else None
        if m:
            op, target = m.group(2), None
            if op.startswith(("BRA", "CALL")):
                t = _TARGET.search(m.group(3))
                target = int(t.group(1), 16) if t else None
            cur.append((int(m.group(1), 16), op, target))
    return funcs


def _classify(op: str) -> Pipes:
    if op.startswith(FMA_OPS):
        return Pipes(fma=2.0 if op.startswith("IMAD.WIDE") else 1.0, issued=1.0)
    if op.split(".")[0] in ALU_OPS:
        return Pipes(alu=1.0, issued=1.0)
    return Pipes(issued=1.0)


def regions(insns: list[tuple]) -> tuple[list[int], list[list[tuple]]]:
    """(the called bodies' start addresses, the instructions of each
    region): the entry's own body first, then each called body in address
    order."""
    starts = sorted({t for _, op, t in insns if op.startswith("CALL") and t is not None})
    bounds = [0] + starts + [float("inf")]
    return starts, [[i for i in insns if lo <= i[0] < hi] for lo, hi in zip(bounds, bounds[1:])]


def loops(region: list[tuple]) -> list[tuple[int, int]]:
    """(first, last) address of each loop of a region, in the order of the
    back branches; a branch to itself (the padding after ``EXIT``) is none."""
    return [(t, a) for a, op, t in region if op.startswith("BRA") and t is not None and t < a]


def weighted(insns: list[tuple], trips: list[list[int]], what: str = "") -> Pipes:
    """Per-thread counts of one entry function (``parse``'s list).

    ``trips``: the loops' trip counts of each region (``regions``), each in
    the order of its back branches; each region must list as many as its
    SASS has loops."""
    starts, regions_ = regions(insns)
    if len(trips) != len(regions_):
        raise ValueError(f"{what}: {len(regions_)} regions (the body and {len(starts)} called "
                         f"bodies) in its SASS, trip counts for {len(trips)}")
    memo: dict[int, Pipes] = {}

    def count(r: int, stack: tuple = ()) -> Pipes:
        if r in memo:
            return memo[r]
        if r in stack:
            raise ValueError(f"{what}: recursive call")
        found = loops(regions_[r])
        if len(found) != len(trips[r]):
            raise ValueError(f"{what}: region {r} has {len(found)} loops in its SASS, "
                             f"{len(trips[r])} trip counts given ({trips[r]})")
        total = Pipes()
        for a, op, t in regions_[r]:
            w = 1.0
            for (lo, hi), n in zip(found, trips[r]):
                if lo <= a <= hi:
                    w *= n
            total.add(_classify(op), w)
            if op.startswith("CALL") and t is not None:
                total.add(count(1 + starts.index(t), stack + (r,)), w)
        memo[r] = total
        return total

    return count(0)


def kernel_pipes(text: str, trips: dict[str, list[list[int]]]) -> dict[str, Pipes]:
    """``weighted`` counts of every entry of ``trips`` (keyed by the entry's
    unqualified name, ``kernels.entry_name``) found in the SASS ``text``;
    raises if one is missing."""
    funcs = {entry_name(m): items for m, items in parse(text).items()}
    missing = sorted(set(trips) - set(funcs))
    if missing:
        raise ValueError(f"no SASS for {missing} (found {sorted(funcs)})")
    return {name: weighted(funcs[name], t, name) for name, t in trips.items()}


def _main(argv=None) -> int:
    import argparse
    import collections

    p = argparse.ArgumentParser(prog="python -m vuke_tpu_torch.kernels.sass")
    p.add_argument("binary", help="cubin, object or shared library")
    args = p.parse_args(argv)
    for mangled, insns in sorted(parse(dump(args.binary)).items()):
        ops = collections.Counter(op for _, op, _ in insns)
        print(f"{entry_name(mangled)}: {len(insns)} instructions, loops per region "
              f"{[len(loops(r)) for r in regions(insns)[1]]}; {dict(ops.most_common())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
