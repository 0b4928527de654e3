"""What every driver shares: the files a cell is made of, the host spans
around calls into the program, the reading of a device trace, and the
result line.

Nothing here imports the program: the drivers do, once the cell is known.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that may not be loaded in a run's process: JAX and
# the JAX package the program was ported from (compared whole, so the
# port's own name, which begins with it, passes)
BANNED = ("jax", "jaxlib", "flax", "vuke_tpu")
LABEL = "pb:"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A harness file by its path: configuration references and metric
    readers are named after their configuration or metric, dots and all."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with the files it
    names: the configuration, its reference, the traffic, and the metrics
    it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    reference: object = None

    @classmethod
    def load(cls, bench: dict, workload: str) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
        w = cells[workload]
        config = load_json(PKG / "configs" / f"{w['config']}.json")
        traffic = load_json(PKG / "traffic" / f"{w['traffic']}.json")
        e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
        return cls(workload, w["chips"], config, traffic, e2e, layer)

    def load_reference(self):
        self.reference = load_module(ROOT / self.config["reference"],
                                     f"portbench_ref_{self.config['name']}")
        return self.reference


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Spans:
    """Host seconds and calls of the program's functions that the harness
    wraps, each also a ``torch.profiler.record_function`` range named
    ``pb:<label>`` so that the trace can attribute device time and idle
    gaps to it.  ``restore`` puts the functions back."""

    def __init__(self):
        self.seconds: dict = {}
        self.calls: dict = {}
        self._undo = []

    def wrap(self, owner, attr: str, label: str):
        import torch

        fn = getattr(owner, attr)
        name = LABEL + label

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            finally:
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0
                self.calls[label] = self.calls.get(label, 0) + 1

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def summary(self) -> dict:
        return {k: {"seconds": self.seconds[k], "calls": self.calls[k]} for k in self.seconds}


def kernel_name(raw: str) -> str:
    """A device operation's name without its return type, namespace of the
    anonymous kind, template arguments and parameters."""
    name = raw.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0][:120]


@dataclass
class Trace:
    """What one traced slice of the window read from ``torch.profiler``:
    the slice's length, the device's busy seconds (the union of every
    operation's interval), each device operation's seconds and count by
    name, the device seconds under each ``pb:`` label, and the idle gaps
    named by the innermost label open on the host at their midpoint."""
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)
    under: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)

    def seconds_of(self, names) -> float:
        return sum(self.ops.get(n, (0.0, 0))[0] for n in names)

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = {}
        for label, s in self.gaps:
            gaps[label] = gaps.get(label, 0.0) + s
        return {"device_ops": [[n, s] for n, (s, _) in top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10]}

    @classmethod
    def merge(cls, traces: list) -> "Trace":
        """Several chips' traces: seconds averaged over the chips."""
        n = len(traces)
        out = cls(sum(t.window_s for t in traces) / n, sum(t.busy_s for t in traces) / n)
        for t in traces:
            for k, (s, c) in t.ops.items():
                s0, c0 = out.ops.get(k, (0.0, 0))
                out.ops[k] = (s0 + s / n, c0 + c / n)
            for k, s in t.under.items():
                out.under[k] = out.under.get(k, 0.0) + s / n
            out.gaps += [(label, s / n) for label, s in t.gaps]
        return out

    def to_dict(self) -> dict:
        return {"window_s": self.window_s, "busy_s": self.busy_s, "ops": self.ops,
                "under": self.under, "gaps": self.gaps}

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls(d["window_s"], d["busy_s"], {k: tuple(v) for k, v in d["ops"].items()},
                   d["under"], [tuple(g) for g in d["gaps"]])


@contextlib.contextmanager
def traced(enabled: bool, device, ready=None):
    """Profile the body on the host and ``device`` when ``enabled``; the
    ``Trace`` is ``holder[0]`` after the block.  The body's device work is
    synchronized inside the window.  ``ready``, where given, is called once
    the profiler runs and before the window opens: several ranks wait there
    for each other, so that no rank's window holds the others' start."""
    holder = []
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        if ready is not None:
            ready()
        with torch.profiler.record_function(LABEL + "window"):
            yield holder
            sync()
    holder.append(read_profile(prof))


def read_profile(prof) -> Trace:
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == LABEL + "window" and e.device_type == DeviceType.CPU]
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = []                     # the device's operations, in microseconds
    ops: dict = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(LABEL):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = kernel_name(e.name)
        s, c = ops.get(name, (0.0, 0))
        ops[name] = (s + (e.time_range.end - e.time_range.start) / 1e6, c + 1)
    spans.sort()
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    labels, under = [], {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(LABEL):
            name = e.name[len(LABEL):]
            labels.append((e.time_range.start, e.time_range.end, name))
            under[name] = under.get(name, 0.0) + e.device_time_total / 1e6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [lab for lab in labels if lab[0] <= mid < lab[1]]
        name = min(inner, key=lambda lab: lab[1] - lab[0])[2] if inner else "outside the window"
        gaps.append((name, (b - a) / 1e6))
    return Trace((w1 - w0) / 1e6, busy, ops, under, gaps)


def device_info(chips: int, peaks: list) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(peaks))}


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or "unknown"."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    if out.returncode != 0 or not out.stdout.strip():
        return "unknown"
    return out.stdout.strip().splitlines()[0]


@dataclass
class Outcome:
    """What a driver hands back: the counts of the comparison with the
    reference, the end-to-end values it measured, the record that the
    per-layer readers read (traced runs), and the device."""
    attempted: int
    failed: int
    checks: list                  # (name, value, limit, "max" or "min")
    end_to_end: dict
    record: dict
    device: dict
    samples: dict = field(default_factory=dict)
    breakdown: dict | None = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim if kind == "max" else v >= lim
                                        for _, v, lim, kind in self.checks)
