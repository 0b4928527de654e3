"""Rate measurement on the card: the two derive paths of a scan.

- ``bench_derive``, port of ``vuke_tpu.benchmark.bench_derive``: milksad
  seeds -> K1 -> normalize -> K3 (or K6 with ``smul13`` off, as
  ``VUKE_TPU_SMUL13=0`` selects) -> K4 -> K2 -> fragments, under the JAX
  package's metric name ``seed_to_hash160_derivations_per_sec`` for either
  kernel; the result's ``smul`` names the kernel;
- ``bench_sequential``, port of ``vuke_tpu.benchmark.bench_sequential``:
  contiguous keys -> K5 -> K4 -> K2 -> fragments from a cached offset
  table, the base point stepped on the host inside the timed window,
  under ``sequential_scan_derivations_per_sec``.

Both are timed with CUDA events after a warm-up, each measured window
fenced by ``torch.cuda.synchronize()``, best of 3 windows.  They run only
on a CUDA device: a measurement never falls back to the CPU.
"""

from __future__ import annotations

import time

import torch

from ._device import require_cuda, u32
from .ecc.incremental import BaseStepper, build_offset_table, offset_table, sequential_core
from .ecc.tiled import derive_hash160s_tiled, use_smul13

METRIC = "seed_to_hash160_derivations_per_sec"
SEQ_METRIC = "sequential_scan_derivations_per_sec"
SEQ_START = 1 << 48


def time_cuda(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per ``fn()`` call on the current CUDA stream,
    from CUDA events around ``iters`` back-to-back calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _derive_step(dev: torch.device, batch: int, smul13: bool):
    """A callable deriving a fresh batch of ``batch`` seeds per call."""
    offsets = torch.arange(batch, dtype=torch.int64, device=dev)
    state = {"i": 0}

    def step():
        state["i"] += 1
        seeds = u32(offsets + state["i"] * batch)
        return derive_hash160s_tiled(seeds, smul13=smul13)["frag_c"][0]

    return step


def _sequential_step(dev: torch.device, batch: int, table):
    """A callable deriving the next ``batch`` contiguous keys per call, from
    ``SEQ_START`` on: the host steps the base point, then K5 -> K4 -> K2."""
    offx, offy = table
    stepper = BaseStepper(batch)
    state = {"start": SEQ_START}

    def step():
        bx, by = stepper.base_for(state["start"])
        state["start"] += batch
        return sequential_core(bx, by, offx, offy)["frag_c"][0]

    return step


def _rate(metric: str, step, batch: int, iters: int, dev) -> dict:
    """The best of 3 measured windows (each ``iters`` calls on fresh keys,
    the first after 3 warm-up calls), with every window's time beside it."""
    window_ms = [time_cuda(step, iters=iters, warmup=3 if w == 0 else 0)
                 for w in range(3)]
    ms = min(window_ms)
    return {
        "metric": metric,
        "derivations_per_sec": batch / (ms / 1e3),
        "ms_per_batch": ms,
        "window_ms": window_ms,
        "batch": batch,
        "iterations": iters,
        "device": torch.cuda.get_device_name(dev),
    }


def bench_derive(batch: int = 1 << 19, iters: int = 20,
                 smul13: bool | None = None) -> dict:
    """Full milksad seed -> hash160 derive rate at ``batch`` seeds per call,
    through K3 or K6 (``smul13``; None reads the environment,
    ``ecc/tiled.use_smul13``)."""
    dev = require_cuda()
    smul13 = use_smul13(smul13)
    out = _rate(METRIC, _derive_step(dev, batch, smul13), batch, iters, dev)
    out["smul"] = "smul" if smul13 else "smul_w8"
    return out


def bench_sequential(batch: int = 1 << 19, iters: int = 20) -> dict:
    """Sequential-scan derive rate at ``batch`` keys per call.  The offset
    table is built (K3 + K4 over 1..batch) before the clock starts; its
    seconds are reported beside the rate."""
    dev = require_cuda()
    t0 = time.perf_counter()
    table = build_offset_table(batch, dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    out = _rate(SEQ_METRIC, _sequential_step(dev, batch, table), batch, iters, dev)
    out["offset_table_seconds"] = table_s
    out["start"] = SEQ_START
    return out


SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")


def _profile(step, dev, batch: int, iters: int) -> dict:
    """Where a call's time goes on the card: device time per kernel
    (``torch.profiler``, CUPTI) and the device's idle share of the host
    wall clock, per batch, over ``iters`` calls after a warm-up.  The
    profiler's own overhead is inside the wall clock.

    Before the profiler starts, ``iters`` calls are timed on the host's
    clock alone: ``host_issue_ms_per_batch`` is the host's time per call
    and ``device_drain_ms`` the wait after the last one until the device
    is done.  Where the calls return before their kernels end (the
    profile's ``host_waits_per_batch`` is 0), a host that issues slower
    than the device computes leaves a drain below one batch's device
    time; a device that computes slower leaves the backlog to drain."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t1) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t2) * 1e3 / iters
    per_kernel, waits = {}, -1          # -1: the synchronize that closes the loop
    for e in prof.key_averages():
        if e.key in SYNC_CALLS:
            waits += e.count
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:120]
            per_kernel[name] = per_kernel.get(name, 0.0) + us / 1e3 / iters
    busy = sum(per_kernel.values())
    return {
        "batch": batch,
        "host_issue_ms_per_batch": (t1 - t0) * 1e3 / iters,
        "device_drain_ms": drain_ms,
        "host_waits_per_batch": waits / iters,
        "wall_ms_per_batch": wall_ms,
        "device_busy_ms_per_batch": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "kernels_ms_per_batch": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])),
        "device": torch.cuda.get_device_name(dev),
    }


def profile_derive(batch: int = 1 << 19, iters: int = 10,
                   smul13: bool | None = None) -> dict:
    """``_profile`` of the milksad derive step (``smul13`` as in
    ``bench_derive``)."""
    dev = require_cuda()
    smul13 = use_smul13(smul13)
    out = _profile(_derive_step(dev, batch, smul13), dev, batch, iters)
    out["smul"] = "smul" if smul13 else "smul_w8"
    return out


def profile_sequential(batch: int = 1 << 19, iters: int = 10) -> dict:
    """``_profile`` of the sequential-scan step (table built beforehand)."""
    dev = require_cuda()
    table = offset_table(batch, dev)
    return _profile(_sequential_step(dev, batch, table), dev, batch, iters)
