"""Run a cell with its control (``portbench/controls.py``) in place of the
program's exact path:

    python3 -m portbench.control --workload NAME --seed N --seconds S

The result line is the benchmark's; a sound control reads ``"correct":
false``.  The benchmark's own runs never run this.
"""

import sys

from . import run
from .controls import BY_DRIVER
from .harness import ROOT, Cell, load_json


def main(argv=None) -> int:
    args = run.parse(argv)
    cell = Cell.load(load_json(ROOT / "BENCHMARK.json"), args.workload)
    return run.main(argv, patch=f"portbench.controls:{BY_DRIVER[cell.traffic['driver']]}")


if __name__ == "__main__":
    sys.exit(main())
