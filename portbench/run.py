"""Run one cell of the benchmark of ``vuke_tpu_torch`` on the card:

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration (``portbench/configs/<config>.json``, with
its plain reference beside it), its traffic (``portbench/traffic/
<traffic>.json``, whose ``driver`` names the generator in ``portbench/
drivers/``) and its per-layer metrics (``portbench/metrics/<metric>.py``)
are found by the names there.  With ``--trace 0`` the last line of standard
output holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones; either way ``correct`` says whether what the timed path
produced agrees with the reference, and the numbers compared stand beside
their limits under ``checks``, and on the last lines of standard error.

A run needs as many CUDA cards as the cell asks for, and fails without
them; it fails too if JAX or the JAX package is loaded by the time the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .harness import PKG, ROOT, Cell, banned_modules, load_json, load_module, power_limit_w  # noqa: E402,E501

# the caches a CUDA or Triton build would keep, at fixed places in the
# checkout (the program's own kernels build into vuke_tpu_torch/_build/)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}


class Env:
    """Where a run executes and what it may change: the device ("cuda", or
    "cpu" for the tests, which run the program's plain versions), sizes
    that replace the cell's (tests), and a ``module:function`` of the cell
    that breaks the program underneath (the controls and the tests'
    faults)."""

    def __init__(self, device: str = "cuda", overrides: dict | None = None,
                 patch: str | None = None):
        import torch

        self.t0 = T0
        self.overrides = overrides or {}
        self.patch = patch
        self.device = torch.device("cpu") if device == "cpu" else torch.device("cuda", 0)

    def apply(self, cell: Cell):
        cell.config.update(self.overrides.get("config", {}))
        cell.traffic.update(self.overrides.get("traffic", {}))
        if self.patch:
            mod, fn = self.patch.split(":")
            getattr(importlib.import_module(mod), fn)(cell)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        return torch.cuda.max_memory_allocated()

    def free(self):
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()

    def device_info(self, peaks: list, chips: int = 1) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
        from .harness import device_info
        return device_info(chips, peaks)

    def mark(self, what: str):
        """Log how far into the run a step of set-up ended."""
        self.log(f"{time.perf_counter() - self.t0:.3f} s: {what}")

    @staticmethod
    def log(msg: str):
        # one write, so that the lines of several ranks on one pipe stay whole
        sys.stderr.write(f"portbench: {msg}\n")
        sys.stderr.flush()


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def line(cell: Cell, out, trace: bool) -> dict:
    """The result line: the end-to-end metrics (``--trace 0``) or the
    per-layer ones the readers find (``--trace 1``), then the checks."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(PKG / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    res = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": dict(out.device)}
    if trace:
        res["device"]["busy_s"] = out.record["trace"].busy_s
        res["device"]["window_s"] = out.record["trace"].window_s
        res["breakdown"] = out.breakdown
    if out.samples:
        res["samples"] = out.samples
    res["checks"] = {name: {"value": v, "limit": lim, "kind": kind}
                     for name, v, lim, kind in out.checks}
    return res


def main(argv=None, *, device: str = "cuda", overrides: dict | None = None,
         patch: str | None = None) -> int:
    """One run; returns the exit code.  ``device``, ``overrides`` and
    ``patch`` serve the tests (see ``Env``)."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    cell = Cell.load(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA cards, found {have}",
              file=sys.stderr)
        return 2
    env = Env(device, overrides, patch)
    env.apply(cell)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, args, env)
    found = banned_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    res = line(cell, out, bool(args.trace))
    if env.cuda:
        res["power_limit"] = power_limit_w()
        res["checks"] = res.pop("checks")
    for name, c in res["checks"].items():
        bound = "at most" if c["kind"] == "max" else "at least"
        print(f"check {name} {c['value']} limit {bound} {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
