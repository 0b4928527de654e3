"""Rate measurement on the card: the two derive paths of a scan.

- ``bench_derive``, port of ``vuke_tpu.benchmark.bench_derive``: milksad
  seeds -> K1 -> normalize -> K3 (or K6 with ``smul13`` off, as
  ``VUKE_TPU_SMUL13=0`` selects) -> K4 -> K2 -> fragments, under the JAX
  package's metric name ``seed_to_hash160_derivations_per_sec`` for either
  kernel, on every visible card (``parallel/mesh.py``: each card its
  contiguous slice of the global batch); the result's ``smul`` names the
  kernel and ``devices`` counts the cards;
- ``bench_sequential``, port of ``vuke_tpu.benchmark.bench_sequential``:
  contiguous keys -> K5 -> K4 -> K2 -> fragments from a cached offset
  table, the base point stepped on the host inside the timed window,
  under ``sequential_scan_derivations_per_sec``.

Both are timed with CUDA events after a warm-up, each measured window
fenced by ``torch.cuda.synchronize()``, best of 3 windows.  Beside them:

- ``bench_keygen``: the keygen-only rate of one numeric transform
  (inputs/s and keys/s), the same way;
- ``bench_scan``: keys/s of a whole scan through the pipelined driver
  (``pipeline.ForwardDriver``) on the host's clock, against a pool of
  random fragments, with where its time goes (``_profile``'s fields per
  superbatch);
- ``bench_generate``: lines/s of ``generate`` over a range through the
  driver's generate mode (D2 on the card, ``pipeline.format_lines`` on the
  host) into a discarding sink and into a file;
- ``bench_storage``: records/s of ``generate --storage`` into Parquet (E1
  on the card, the host's hex columns, Arrow and the Parquet write), with
  a superbatch's time split, beside the host path (``KeyDeriver.derive``,
  ``ResultRecord``, ``records_to_batch``) on 256 keys;
- ``bench_strings``: words/s and keys/s of a wordlist scan through
  ``pipeline.StringDriver``, batch by batch as ``sources.WordlistSource``
  feeds it;
- ``bench_wallet``: mnemonics/s of the multibit-hd dictionary attack (W1
  on the card, beside the hashlib host path's rate) or seeds/s of an
  electrum scan over timestamps (W2 and K3 -> K4 on the card), each with
  the host's share by step.  ``profile_*``
say where a batch's time goes (``torch.profiler``); ``kernel_cases`` holds
each kernel and its plain version at the derive's shapes, for timing them
alone.  They run only on a CUDA device: a measurement never falls back to
the CPU.

``run_benchmark`` and ``bench_transform`` are the JAX command's ``bench``
(``vuke_tpu/benchmark.py``): a transform's inputs/s and keys/s over whole
calls after a 2 s warm-up, best of 5 windows, on the card, or on the CPU
through the plain versions when the caller asks for it (``--no-tpu``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import time

import numpy as np
import torch

from ._device import device_key, i64, require_cuda, u32
from .cores import hash160, keygen, mt19937
from .derive import KeyDeriver
from .ecc import incremental as inc
from .ecc import inv, ref, scalar, smul, smul_w8
from .ecc.incremental import BaseStepper, build_offset_table, offset_table, sequential_core
from .ecc.tiled import derive_hash160s_tiled, use_smul13
from .kernels import Kernel
from .cores import p2pkh
from .matcher import TargetPools
from .parallel import mesh
from .output import ConsoleOutput
from .pipeline import ORDER_BATCH, ForwardDriver, StringDriver
from .transforms import parse_transform

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


def time_cards(steps, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of the slowest card: ``steps`` is a list
    of (card, ``fn``); CUDA events on each card's current stream around
    ``iters`` rounds of one ``fn()`` a card, after ``warmup`` rounds, every
    card launched before any is waited on.  With one card it is
    ``time_cuda``."""
    def rounds(n):
        for _ in range(n):
            for dev, fn in steps:
                with torch.cuda.device(dev):
                    fn()

    rounds(warmup)
    for dev, _ in steps:
        torch.cuda.synchronize(dev)
    events = []
    for dev, _ in steps:
        with torch.cuda.device(dev):
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
    rounds(iters)
    for (dev, _), (_, end) in zip(steps, events):
        with torch.cuda.device(dev):
            end.record()
    for dev, _ in steps:
        torch.cuda.synchronize(dev)
    return max(start.elapsed_time(end) for start, end in events) / iters


def _derive_step(dev: torch.device, batch: int, smul13: bool, first: int = 0,
                 stride: int | None = None):
    """A callable deriving a fresh batch of ``batch`` seeds per call: call i
    the seeds ``first + i * stride + j``, j < ``batch`` (``stride``: the
    global batch a call, default ``batch``)."""
    offsets = torch.arange(first, first + batch, dtype=torch.int64, device=dev)
    stride = batch if stride is None else stride
    state = {"i": 0}

    def step():
        state["i"] += 1
        seeds = u32(offsets + state["i"] * stride)
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


def _rate(metric: str, step, batch: int, iters: int, dev, timer=time_cuda) -> dict:
    """The best of 3 measured windows (each ``iters`` calls on fresh keys,
    the first after 3 warm-up calls), with every window's time beside it."""
    window_ms = [timer(step, iters=iters, warmup=3 if w == 0 else 0)
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
    ``ecc/tiled.use_smul13``), over every visible card: each derives its
    contiguous slice of the global batch on its own stream
    (``time_cards``), and the rate is the global batch over the slowest
    card's window."""
    devices = mesh.get_devices()
    smul13 = use_smul13(smul13)
    steps = [(dev, _derive_step(dev, n, smul13, first, batch))
             for dev, first, n in mesh.split_seeds(batch, devices)]
    out = _rate(METRIC, steps, batch, iters, devices[0], timer=time_cards)
    out["smul"] = "smul" if smul13 else "smul_w8"
    out["devices"] = len(devices)
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
    # the visible cards, as the JAX package reports them; the rate is card 0's
    out["devices"] = torch.cuda.device_count()
    return out


SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")


def _device_events(prof, iters: int) -> dict:
    """{kernel or copy name: (device ms per call, launches per call)} of a
    ``torch.profiler`` run of ``iters`` calls."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            # a template's instantiations count under its name
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0][:120]
            ms, count = out.get(name, (0.0, 0.0))
            out[name] = (ms + us / 1e3 / iters, count + e.count / iters)
    return out


def _profiled(fn, iters: int, expected):
    """``torch.profiler`` over ``iters`` calls of ``fn`` ending in a
    synchronize: (the profile, ``_device_events``, host wall ms per call).
    Now and then CUPTI records a window only in part, or not at all (on the
    H100: 1 of 20 launches of a kernel, or none).  Every kernel of a steady
    loop runs a whole number of times a call, and each name in ``expected``
    (``Kernel.entry`` of the kernels ``fn`` launches) at least once; a window
    where one does not runs again, three times at most, and then this
    raises."""
    from torch.profiler import ProfilerActivity, profile

    expected = set(expected)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        events = _device_events(prof, iters)
        if (expected <= set(events)
                and all(float(n).is_integer() for _, n in events.values())):
            return prof, events, wall_ms
    raise RuntimeError(f"torch.profiler recorded three windows of {iters} calls in part: "
                       f"missing {sorted(expected - set(events))}, launches a call "
                       f"{ {k: n for k, (_, n) in events.items()} }")


def device_ms(fn, kernels, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per ``fn()`` call under ``torch.profiler``: the
    sum of the kernels' own times, without the host's share that CUDA
    events around a short launch take in.  ``kernels``: the ``Kernel``s
    ``fn`` launches."""
    for _ in range(warmup):
        fn()
    return sum(ms for ms, _ in _profiled(fn, iters, {k.entry for k in kernels})[1].values())


def _profile(step, kernels, dev, batch: int, iters: int) -> dict:
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
    time; a device that computes slower leaves the backlog to drain.

    ``launches_per_batch`` counts every kernel and copy on the device,
    ``glue_*`` those that are not the port's own kernels (torch's
    elementwise ops between them).  ``kernels``: the ``Kernel``s a step
    launches; a profile that misses one is taken again."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t1) * 1e3
    prof, events, wall_ms = _profiled(step, iters, {k.entry for k in kernels})
    waits = sum(e.count for e in prof.key_averages() if e.key in SYNC_CALLS)
    ours = {k.entry for k in Kernel.registry.values()}
    glue = {name: v for name, v in events.items() if name not in ours}
    busy = sum(ms for ms, _ in events.values())
    return {
        "batch": batch,
        "host_issue_ms_per_batch": (t1 - t0) * 1e3 / iters,
        "device_drain_ms": drain_ms,
        "host_waits_per_batch": (waits - 1) / iters,   # less the closing synchronize
        "wall_ms_per_batch": wall_ms,
        "device_busy_ms_per_batch": busy,
        "device_idle_share": 1.0 - busy / wall_ms,
        "launches_per_batch": sum(n for _, n in events.values()),
        "glue_launches_per_batch": sum(n for _, n in glue.values()),
        "glue_ms_per_batch": sum(ms for ms, _ in glue.values()),
        "kernels_ms_per_batch": {name: ms for name, (ms, _) in
                                 sorted(events.items(), key=lambda kv: -kv[1][0])},
        "device": torch.cuda.get_device_name(dev),
    }


def profile_derive(batch: int = 1 << 19, iters: int = 10,
                   smul13: bool | None = None) -> dict:
    """``_profile`` of the milksad derive step (``smul13`` as in
    ``bench_derive``)."""
    dev = require_cuda()
    smul13 = use_smul13(smul13)
    kernels = (mt19937.KERNEL, smul.KERNEL if smul13 else smul_w8.KERNEL, inv.KERNEL,
               hash160.KERNEL)
    out = _profile(_derive_step(dev, batch, smul13), kernels, dev, batch, iters)
    out["smul"] = "smul" if smul13 else "smul_w8"
    return out


def profile_sequential(batch: int = 1 << 19, iters: int = 10) -> dict:
    """``_profile`` of the sequential-scan step (table built beforehand)."""
    dev = require_cuda()
    table = offset_table(batch, dev)
    kernels = (inc.KERNEL, inv.KERNEL, hash160.KERNEL)
    return _profile(_sequential_step(dev, batch, table), kernels, dev, batch, iters)


def _cold(fn, inputs):
    """A call of ``fn`` on each of ``inputs`` in turn, its last four results
    kept alive: with four 16 MiB inputs and outputs in the ring, no call
    finds its input or output in the 50 MB L2, so a kernel that only moves
    bytes is timed against the HBM it is bound by."""
    ring = collections.deque(maxlen=4)
    turn = itertools.count()

    def call():
        ring.append(fn(inputs[next(turn) % len(inputs)]))

    return call


def kernel_cases(dev, seeds: torch.Tensor) -> dict:
    """{kernel name: (kernel call, plain call)} on the inputs the derive
    hands each kernel for the milksad ``seeds`` (N,): their raw and
    normalized key words, the K3 outputs, their affine points, the offset
    table and a base point.  K1 with normalize and K2 with its fragments, as
    the derive runs them; the normalize kernel on four sets of raw words in
    turn (``_cold``)."""
    batch = seeds.shape[0]
    raw = mt19937.milksad_key_words(seeds)
    raws = [raw] + [mt19937.milksad_key_words(u32(i64(seeds) + i * batch)) for i in (1, 2, 3)]
    norm = mt19937.milksad_key_words(seeds, normalize=True)
    table, table_w8 = smul.table_on(device_key(dev)), smul_w8.table_on(device_key(dev))
    outs = smul.scalar_mul(norm)
    x, y = inv.affine(*outs)
    offx, offy = inc.offset_table(batch, dev)
    bx, by = ref.point_mul((1 << 48) - 1)
    return {
        "mt19937": (lambda: mt19937.milksad_key_words(seeds, normalize=True),
                    lambda: mt19937.milksad_key_words_plain(seeds, normalize=True)),
        "normalize": (_cold(scalar.normalize_words, raws),
                      lambda: scalar.normalize_words_plain(raw)),
        "smul": (lambda: smul.scalar_mul(norm), lambda: smul.scalar_mul_plain(norm, table)),
        "smul_w8": (lambda: smul_w8.scalar_mul(norm),
                    lambda: smul_w8.scalar_mul_plain(norm, table_w8)),
        "seq_madd": (lambda: inc.seq_madd(offx, offy, bx, by),
                     lambda: inc.seq_madd_plain(offx, offy, bx, by)),
        "inv_affine": (lambda: inv.affine(*outs), lambda: inv.affine_plain(*outs)),
        "hash160": (lambda: hash160.hash160s_and_fragments(x, y),
                    lambda: hash160.hash160s_and_fragments_plain(x, y)),
        # K1 without its epilogue, as the scan's keygen runs it
        "mt19937 raw": (lambda: mt19937.milksad_key_words(seeds),
                        lambda: mt19937.milksad_key_words_plain(seeds)),
    } | keygen_cases(seeds)


def keygen_cases(lo: torch.Tensor) -> dict:
    """{kernel name: (kernel call, plain call)} of the keygen kernels on the
    seeds (0, ``lo``), in the modes the planted scans run: sha256, the four
    LCGs and every sha256_chain variant."""
    hi = u32(i64(lo) * 0)
    return {
        "keygen_hash": (lambda: keygen.keygen_hash(hi, lo, "sha256"),
                        lambda: keygen.keygen_hash_plain(hi, lo, "sha256")),
        "keygen_prng": (lambda: keygen.keygen_prng(hi, lo, "lcg"),
                        lambda: keygen.keygen_prng_plain(hi, lo, "lcg")),
        "keygen_chain": (lambda: keygen.keygen_chain(hi, lo),
                         lambda: keygen.keygen_chain_plain(hi, lo)),
    }


def bench_keygen(transform: str, batch: int = 1 << 19, iters: int = 20) -> dict:
    """Keygen-only rate of the numeric ``transform`` at ``batch`` seeds a
    call (seeds below 2^32, fresh ones on each of four calls in turn) from
    CUDA events: the best of 3 windows, as ``_rate`` takes them."""
    dev = require_cuda()
    spec = parse_transform(transform)
    offsets = torch.arange(batch, dtype=torch.int64, device=dev)
    lattices = [(u32(offsets * 0), u32(offsets + (1 << 24) + i * batch)) for i in range(4)]
    turn = itertools.count()

    def step():
        return spec.numeric.keygen(*lattices[next(turn) % 4])

    window_ms = [time_cuda(step, iters=iters, warmup=3 if w == 0 else 0) for w in range(3)]
    ms = min(window_ms)
    return {
        "transform": spec.name,
        "inputs_per_sec": batch / (ms / 1e3),
        "keys_per_sec": batch * spec.numeric.n_slots / (ms / 1e3),
        "slots": spec.numeric.n_slots,
        "ms_per_batch": ms,
        "window_ms": window_ms,
        "batch": batch,
        "iterations": iters,
        "device": torch.cuda.get_device_name(dev),
    }


# --- the JAX command's ``bench`` (vuke_tpu/benchmark.py:28-126, 253-263) ---

def _time_loop(fn, dev: torch.device, warmup_s: float, measure_s: float, depth: int = 2,
               windows: int = 5):
    """(iterations, seconds) of the fastest of ``windows`` windows of whole
    ``fn()`` calls, each window ``measure_s / windows`` long, after
    ``warmup_s`` of calls: ``vuke_tpu.benchmark._time_loop``.  On the card at
    most ``depth`` calls are in flight (an event recorded after each) and a
    window ends in ``torch.cuda.synchronize()``; on the CPU every call is
    done when it returns."""
    cuda = dev.type == "cuda"

    def issue():
        fn()
        if not cuda:
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    end = time.time() + warmup_s
    while time.time() < end:
        ev = issue()
        if ev is not None:
            ev.synchronize()
    win_s = measure_s / windows
    best = None
    for _ in range(windows):
        n = 0
        pending = []
        t0 = time.time()
        while n == 0 or time.time() - t0 < win_s:
            ev = issue()
            n += 1
            if ev is not None:
                pending.append(ev)
                if len(pending) >= depth:
                    pending.pop(0).synchronize()
        if cuda:
            torch.cuda.synchronize()
        dt = time.time() - t0
        if best is None or n / dt > best[0] / best[1]:
            best = (n, dt)
    return best


def bench_transform(transform: str, batch: int = 1 << 16, warmup_s: float = 2.0,
                    measure_s: float = 5.0, device=None) -> dict:
    """The rate of one transform as the JAX command's ``bench`` measures it
    (``vuke_tpu.benchmark.bench_transform``): a numeric transform's keygen
    on ``batch`` seeds a call, (0, start + i) with start stepping by
    ``batch``; a string-only one over decimal strings
    (``_bench_string_transform``).  ``device``: the card when None, or
    ``"cpu"`` for the plain versions on the host's clock."""
    dev = require_cuda() if device is None or str(device) == "cuda" else torch.device(device)
    spec = parse_transform(transform)
    if spec.numeric is None:
        return _bench_string_transform(spec, batch, warmup_s, measure_s, dev)
    offsets = torch.arange(batch, dtype=torch.int64, device=dev)
    hi = u32(offsets * 0)
    turn = itertools.count(1)

    def step():
        return spec.numeric.keygen(hi, u32(offsets + next(turn) * batch))

    iters, secs = _time_loop(step, dev, warmup_s, measure_s)
    rate = iters * batch / secs
    return {"transform": spec.name, "inputs_per_sec": rate,
            "keys_per_sec": rate * spec.numeric.n_slots, "batch": batch,
            "iterations": iters, "elapsed_secs": secs}


def _bench_string_transform(spec, batch: int, warmup_s: float, measure_s: float, dev) -> dict:
    """The host-batch rate of a string transform over the decimal strings
    ``str(1_000_000_000 + i)``, ``min(batch, 1000)`` a call (the forward
    drivers' string batch): ``vuke_tpu.benchmark._bench_string_transform``."""
    bsz = min(batch, 1000)
    turn = itertools.count()

    def step():
        base = next(turn) * bsz
        strings = [str(1_000_000_000 + base + j) for j in range(bsz)]
        keys = spec.string.fn(strings, dev)
        if spec.string.valid_fn is not None:
            spec.string.valid_fn(strings)
        return keys

    iters, secs = _time_loop(step, dev, warmup_s, measure_s, depth=1)
    rate = iters * bsz / secs
    return {"transform": spec.name, "inputs_per_sec": rate,
            "keys_per_sec": rate * len(spec.string.slots), "batch": bsz,
            "iterations": iters, "elapsed_secs": secs}


def run_benchmark(transform: str, as_json: bool = False, batch: int = 1 << 16,
                  seconds: float = 5.0, device=None):
    """``bench_transform`` printed as ``vuke_tpu.benchmark.run_benchmark``
    prints it: three lines, or one JSON object with ``as_json``."""
    r = bench_transform(transform, batch=batch, measure_s=seconds, device=device)
    if as_json:
        print(json.dumps(r))
    else:
        print(f"Benchmark: {r['transform']}")
        print(f"  {r['inputs_per_sec'] / 1e6:.2f} M inputs/sec "
              f"({r['keys_per_sec'] / 1e6:.2f} M keys/sec)")
        print(f"  batch={r['batch']} iters={r['iterations']} "
              f"elapsed={r['elapsed_secs']:.2f}s")


SCAN_METRIC = "scan_keys_per_sec"


def _scan_start(spec) -> int:
    """Where ``bench_scan`` starts: 2^48 for a transform with a sequential
    slot (every superbatch takes it), else 2^24 (seeds below 2^32, where
    milksad, the LCGs and the 4-byte chains yield keys)."""
    return 1 << 48 if spec.numeric.sequential_slot is not None else 1 << 24


def bench_scan(transform: str, pool_size: int = 4096, batch: int = 1 << 19,
               superbatches: int = 16, seed: int = 6) -> dict:
    """Keys/s of a scan of ``transform`` through ``pipeline.ForwardDriver``
    at ``batch`` seeds a superbatch, on the host's clock from the first
    launch to the last read, against pools of ``pool_size`` random
    fragments each.  A warm-up of two superbatches (kernel build, offset
    table, host tables) holds one planted target, which must be found; the
    timed run of ``superbatches`` follows it and is then profiled
    (``torch.profiler``) once more over the next ``superbatches``:
    device busy, launches and the idle share a superbatch, and the host's
    time in ``ScanProgram.run`` (its issue time)."""
    dev = require_cuda()
    spec = parse_transform(transform)
    start = _scan_start(spec)
    planted = start + batch // 3
    hi = torch.tensor([planted >> 32], dtype=torch.int64).to(torch.uint32)
    lo = torch.tensor([planted & 0xFFFFFFFF], dtype=torch.int64).to(torch.uint32)
    key = b"".join(int(w).to_bytes(4, "big") for w in
                   spec.numeric.keygen(hi, lo, plain=True)[0][0, :, 0].to(torch.int64))
    address = KeyDeriver().derive(key).p2pkh_compressed
    one = TargetPools.from_addresses([address])
    rng = np.random.default_rng(seed)
    pools = TargetPools(
        np.concatenate([one.comp, rng.integers(-(1 << 63), 1 << 63, pool_size - 1)]),
        np.concatenate([one.uncomp, rng.integers(-(1 << 63), 1 << 63, pool_size - 1)]),
        one.targets)
    driver = ForwardDriver([spec], pools, batch=batch, device=dev)
    issue = [0.0]
    prog = driver.programs[0]
    run = prog.run

    def timed_run(*args):
        t0 = time.perf_counter()
        out = run(*args)
        issue[0] += time.perf_counter() - t0
        return out

    warm = driver.run_range(start, start + 2 * batch - 1)
    if [h.seed for h in warm.hits] != [planted]:
        raise RuntimeError(f"bench_scan {transform}: the planted seed {planted} was not "
                           f"found: {[h.source for h in warm.hits]}")
    first = start + 2 * batch
    span = superbatches * batch
    prog.run = timed_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = driver.run_range(first, first + span - 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prog.run = run
    # every slot's path ends in K4 and K2, whichever it takes
    _, events, wall_ms = _profiled(
        lambda: driver.run_range(first + span, first + 2 * span - 1), 1,
        {inv.KERNEL.entry, hash160.KERNEL.entry})
    ours = {k.entry for k in Kernel.registry.values()}
    busy = sum(ms for ms, _ in events.values()) / superbatches
    wall = wall_ms / superbatches
    return {
        "metric": SCAN_METRIC,
        "transform": spec.name,
        "keys_per_sec": res.keys_generated / secs,
        "inputs_per_sec": res.inputs_processed / secs,
        "slots": spec.numeric.n_slots,
        "pool_size": pool_size,
        "batch": batch,
        "superbatches": superbatches,
        "start": first,
        "seconds": secs,
        "ms_per_superbatch": secs * 1e3 / superbatches,
        "host_issue_ms_per_superbatch": issue[0] * 1e3 / superbatches,
        "wall_ms_per_superbatch": wall,
        "device_busy_ms_per_superbatch": busy,
        "device_idle_share": 1.0 - busy / wall,
        "launches_per_superbatch": sum(n for _, n in events.values()) / superbatches,
        "glue_launches_per_superbatch": sum(n for name, (_, n) in events.items()
                                            if name not in ours) / superbatches,
        "kernels_ms_per_superbatch": {name: ms / superbatches for name, (ms, _) in
                                      sorted(events.items(), key=lambda kv: -kv[1][0])},
        "device": torch.cuda.get_device_name(dev),
    }


def _wrap(obj, name: str, acc: dict, key: str):
    """Add the host seconds of each call of ``obj.name`` to ``acc[key]``;
    returns a function that undoes it."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)
    return lambda: setattr(obj, name, fn)


def _breakdown(events: dict, wall_ms: float, per: float) -> dict:
    """Device busy, launches, glue launches and idle share of a profiled
    window of ``wall_ms``, each divided by ``per``."""
    ours = {k.entry for k in Kernel.registry.values()}
    busy = sum(ms for ms, _ in events.values())
    return {
        "wall_ms": wall_ms / per,
        "device_busy_ms": busy / per,
        "device_idle_share": 1.0 - busy / wall_ms,
        "launches": sum(n for _, n in events.values()) / per,
        "glue_launches": sum(n for name, (_, n) in events.items() if name not in ours) / per,
        "kernels_ms": {name: ms / per for name, (ms, _) in
                       sorted(events.items(), key=lambda kv: -kv[1][0])},
    }


def bench_generate(transform: str = "sha256", seeds: int = 1 << 20, batch: int = 1 << 19,
                   path=None) -> dict:
    """Lines/s of ``generate`` over ``seeds`` seeds from 2^24 at ``batch``
    a superbatch (the output in the JAX package's order, ``ORDER_BATCH``),
    on the host's clock, after a warm-up of two superbatches (the kernels,
    and the pinned buffers of two superbatches in flight): into a
    discarding sink (``os.devnull``) and into ``path`` (a file under the
    package's ``_build/`` when None, removed afterwards).  For the sink run,
    where the host's time goes a superbatch (``ScanProgram.run``: the
    launches; ``_write_keys``: formatting and writing) and, from one more
    run under ``torch.profiler``, device busy, launches and the idle share."""
    import os
    from . import kernels as kernels_mod
    from .pipeline import ScanProgram

    dev = require_cuda()
    spec = parse_transform(transform)
    if path is None:
        kernels_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = kernels_mod.BUILD_DIR / "bench_generate.txt"
    start = 1 << 24
    out = {"metric": "generate_lines_per_sec", "transform": spec.name, "seeds": seeds,
           "batch": batch, "order_batch": ORDER_BATCH, "slots": spec.numeric.n_slots}
    for sink, target in (("devnull", os.devnull), ("file", str(path))):
        console = ConsoleOutput(open(target, "w"))
        driver = ForwardDriver([spec], None, batch=batch, device=dev, output=console,
                               order_batch=ORDER_BATCH)
        driver.run_range(start, start + 2 * batch - 1)
        pos = start + 2 * batch
        acc: dict = {}
        undo = [_wrap(ScanProgram, "run", acc, "issue"),
                _wrap(driver, "_write_keys", acc, "write")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = driver.run_range(pos, pos + seeds - 1)
        console.flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for u in undo:
            u()
        out[sink] = {"lines_per_sec": res.keys_generated / secs, "lines": res.keys_generated,
                     "seconds": secs}
        if sink == "devnull":
            per = seeds / batch
            out[sink]["host_issue_ms_per_superbatch"] = acc["issue"] * 1e3 / per
            out[sink]["host_write_ms_per_superbatch"] = acc["write"] * 1e3 / per
            pos += seeds
            _, events, wall_ms = _profiled(lambda: driver.run_range(pos, pos + seeds - 1), 1,
                                           {p2pkh.KERNEL.entry, hash160.KERNEL.entry})
            out[sink].update({f"{k}_per_superbatch": v
                              for k, v in _breakdown(events, wall_ms, per).items()})
        console.close()
    os.remove(path)
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def bench_storage(transform: str = "sha256", directory=None, seeds: int = 1 << 20,
                  batch: int = 1 << 19, host_keys: int = 256) -> dict:
    """Records/s of ``generate --storage`` over ``seeds`` seeds from 2^24 at
    ``batch`` a superbatch into Parquet under a fresh subdirectory of
    ``directory`` (the package's ``_build/`` when None), which is all it
    writes and all it removes (zstd 3, the command line's default), on the
    host's clock after a warm-up (4096 seeds: the kernels); then one
    superbatch under
    ``torch.profiler``, with the host's time split: the launches
    (``ScanProgram.run``), the wait for the copies (``HostCopy.arrays``),
    the numpy and Arrow column assembly (``RecordBlock.record_batch``), the
    Arrow concatenation and Parquet write (``StorageOutput._write_pending``);
    the device's busy time with E1's share and the copies', and the idle
    share.  Beside it the host path on ``host_keys`` keys of the same
    transform: ``KeyDeriver.derive``, ``ResultRecord`` and
    ``records_to_batch``, as the JAX package's ``StorageOutput.key_fast``
    runs them."""
    import os
    import shutil
    import tempfile
    from . import kernels as kernels_mod

    dev = require_cuda()
    spec = parse_transform(transform)
    parent = kernels_mod.BUILD_DIR if directory is None else directory
    os.makedirs(parent, exist_ok=True)
    directory = tempfile.mkdtemp(prefix="bench_storage_", dir=parent)
    try:
        return _bench_storage(spec, directory, seeds, batch, host_keys, dev)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _bench_storage(spec, directory: str, seeds: int, batch: int, host_keys: int, dev) -> dict:
    """``bench_storage``'s runs, each into its own subdirectory of
    ``directory``, removed once measured."""
    import os
    import shutil
    from .cores import records as rec
    from .pipeline import HostCopy, ScanProgram
    from .storage import ParquetBackend, StorageOutput
    from .storage import output as storage_output
    from .storage.records import ResultRecord, records_to_batch

    start = 1 << 24
    out = {"metric": "generate_storage_records_per_sec", "transform": spec.name,
           "seeds": seeds, "batch": batch, "order_batch": ORDER_BATCH,
           "slots": spec.numeric.n_slots, "compression": "zstd", "compression_level": 3}

    def run(sub: str, first: int, n: int, width: int = batch):
        storage = StorageOutput(ParquetBackend(os.path.join(directory, sub)))
        driver = ForwardDriver([spec], None, batch=width, device=dev, output=storage,
                               order_batch=ORDER_BATCH)
        res = driver.run_range(first, first + n - 1)
        paths = storage.finish().paths
        nbytes = sum(os.path.getsize(p) for p in paths)
        shutil.rmtree(os.path.join(directory, sub))
        return res, paths, nbytes

    run("warmup", start, 4096, 4096)
    pos = start + 4096
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, paths, nbytes = run("timed", pos, seeds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out.update({"records": res.keys_generated, "seconds": secs,
                "records_per_sec": res.keys_generated / secs, "files": len(paths),
                "bytes": nbytes})
    acc: dict = {}
    undo = [_wrap(ScanProgram, "run", acc, "issue"), _wrap(HostCopy, "arrays", acc, "copy_wait"),
            _wrap(rec.RecordBlock, "record_batch", acc, "columns"),
            _wrap(storage_output.StorageOutput, "_write_pending", acc, "write")]
    try:
        pos += seeds
        _, events, wall_ms = _profiled(lambda: run("profiled", pos, batch), 1,
                                       {rec.KERNEL.entry, hash160.KERNEL.entry})
    finally:
        for u in undo:
            u()
    out.update({f"host_{k}_ms_per_superbatch": v * 1e3 for k, v in acc.items()})
    out.update({f"{k}_per_superbatch": v for k, v in _breakdown(events, wall_ms, 1).items()})
    out["e1_ms_per_superbatch"] = events.get(rec.KERNEL.entry, (0.0, 0))[0]
    out["copy_ms_per_superbatch"] = sum(ms for name, (ms, _) in events.items()
                                        if name.startswith("Memcpy"))
    deriver = KeyDeriver()
    keys, _ = spec.numeric.keygen(*(u32(torch.tensor([pos >> 32] * host_keys)),
                                    u32(torch.arange(pos, pos + host_keys) & 0xFFFFFFFF)),
                                  plain=True)
    blobs = [b"".join(int(w).to_bytes(4, "big") for w in i64(keys[0, :, j]))
             for j in range(host_keys)]
    t1 = time.perf_counter()
    records_to_batch([ResultRecord.from_derived(str(pos + j), spec.name, deriver.derive(b))
                      for j, b in enumerate(blobs)])
    host_secs = time.perf_counter() - t1
    out.update({"host_path_records": host_keys, "host_path_seconds": host_secs,
                "host_path_records_per_sec": host_keys / host_secs})
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def seeded_words(n: int, seed: int = 7) -> list:
    """``n`` distinct lowercase words of 4 to 14 letters from ``seed``
    (numpy), each with its index appended."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, 15, n)
    letters = rng.integers(0, 26, int(lens.sum())).astype(np.uint8) + ord("a")
    text = letters.tobytes().decode()
    ends = np.cumsum(lens)
    return [f"{text[e - k:e]}{i}" for i, (e, k) in enumerate(zip(ends.tolist(), lens.tolist()))]


def bench_strings(transform: str = "sha256", words: int = 1 << 20, pool_size: int = 4096,
                  seed: int = 7) -> dict:
    """Words/s and keys/s of a wordlist scan of ``transform`` through
    ``StringDriver`` over ``words`` seeded words, a batch of
    ``sources.STRING_BATCH`` at a time, on the host's clock, against a pool
    of ``pool_size`` random fragments holding one planted word's address,
    which must be found.  Where the host's time goes a batch (the keys:
    ``StringTransform.fn``; the device match with its read; the rest) and,
    from 16 batches under ``torch.profiler``, device busy, launches and the
    idle share a batch."""
    import io
    from .sources import STRING_BATCH

    dev = require_cuda()
    spec = parse_transform(transform)
    ws = seeded_words(words, seed)
    planted = ws[words // 3]
    keys = spec.string.fn([planted])
    address = KeyDeriver().derive(keys[0, 0].astype(">u4").tobytes()).p2pkh_compressed
    one = TargetPools.from_addresses([address])
    rng = np.random.default_rng(seed)
    pools = TargetPools(
        np.concatenate([one.comp, rng.integers(-(1 << 63), 1 << 63, pool_size - 1)]),
        np.concatenate([one.uncomp, rng.integers(-(1 << 63), 1 << 63, pool_size - 1)]),
        one.targets)
    acc: dict = {}
    fn = spec.string.fn

    def timed_fn(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc["keys"] = acc.get("keys", 0.0) + time.perf_counter() - t0

    timed = dataclasses.replace(spec, string=dataclasses.replace(spec.string, fn=timed_fn))
    buf = io.StringIO()
    driver = StringDriver([timed], pools, ConsoleOutput(buf), device=dev)
    driver.process_batch(ws[:STRING_BATCH])
    acc.clear()
    undo = _wrap(driver, "_device_match", acc, "match")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matches = keys_generated = 0
    for i in range(0, words, STRING_BATCH):
        st = driver.process_batch(ws[i:i + STRING_BATCH])
        matches += st.matches_found
        keys_generated += st.keys_generated
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    undo()
    keys_s, match_s = acc["keys"], acc["match"]
    if matches != 1 or f"Source: {planted}{spec.string.slots[0]}\n" not in buf.getvalue():
        raise RuntimeError(f"bench_strings {transform}: the planted word {planted!r} was "
                           f"not found exactly once ({matches} matches)")
    batches = -(-words // STRING_BATCH)
    span = 16 * STRING_BATCH
    _, events, wall_ms = _profiled(
        lambda: [driver.process_batch(ws[i:i + STRING_BATCH]) for i in range(0, span, STRING_BATCH)],
        1, {hash160.KERNEL.entry})
    out = {"metric": "wordlist_scan_words_per_sec", "transform": spec.name, "words": words,
           "words_per_sec": words / secs, "keys_per_sec": keys_generated / secs,
           "slots": len(spec.string.slots), "pool_size": pool_size,
           "string_batch": STRING_BATCH, "pad": driver.pad, "seconds": secs,
           "host_keys_ms_per_batch": keys_s * 1e3 / batches,
           "host_match_ms_per_batch": match_s * 1e3 / batches,
           "host_other_ms_per_batch": (secs - keys_s - match_s) * 1e3 / batches}
    out.update({f"{k}_per_batch": v for k, v in _breakdown(events, wall_ms, 16).items()})
    out["device"] = torch.cuda.get_device_name(dev)
    return out


ANALYZE_FAMILIES = ("milksad", "mt64", "lcg", "xorshift", "sha256_chain")


def bench_analyze(family: str = "milksad", mode: str = "exact", max_seeds: int = 1 << 32,
                  batch: int | None = None, seed: int = 7) -> dict:
    """Seeds/s of one reverse analyzer's sweeps on the card: the
    ``analyze`` analyzer of ``family`` (every variant of lcg, xorshift and
    sha256_chain in turn, as ``analyze --analyzer F`` runs them) over its
    whole space, each 2^64 space bounded by ``max_seeds`` (at least 2^32),
    against a seeded random key that no seed gives, in ``mode`` (exact,
    mask: 40 bits, or cascade: 3 random targets of 8, 16 and 24 bits;
    mt64 and xorshift take only cascade), on the host's clock after a
    warm-up batch.  ``seeds`` counts the seeds swept (a sha256_chain seed
    is 10 chain positions).  Then where 16 batches' time goes on the card
    (``torch.profiler``): each kernel's device ms, device busy, launches and
    the idle share a batch."""
    from .analyze import analyzers as A
    from .analyze import sweeps
    from .cores import sweep as S

    if family not in ANALYZE_FAMILIES:
        raise ValueError(f"bench_analyze: unknown family {family!r}; one of {ANALYZE_FAMILIES}")
    if family in ("mt64", "xorshift") and mode != "cascade":
        raise ValueError(f"bench_analyze: {family} sweeps a 2^64 space under a cascade only")
    dev = require_cuda()
    rng = np.random.default_rng(seed)
    key = rng.bytes(32)
    make = {"milksad": A.MilksadAnalyzer, "mt64": A.Mt64Analyzer, "lcg": A.LcgAnalyzer,
            "xorshift": A.XorshiftAnalyzer, "sha256_chain": A.Sha256ChainAnalyzer}[family]
    batch = batch or sweeps.CARD_SWEEP_BATCH
    config = A.AnalysisConfig(batch=batch, max_seeds=max_seeds, device=dev.type)
    if mode == "mask":
        config.mask_bits = 40
    elif mode == "cascade":
        config.cascade_targets = [(b, int(rng.integers(0, 1 << (b - 1))) | 1 << (b - 1))
                                  for b in (8, 16, 24)]
    kern = S.CHAIN_KERNEL if family == "sha256_chain" else S.PRNG_KERNEL
    searched = []
    sweep_fn = sweeps.sweep

    def counted(*a, **k):
        r = sweep_fn(*a, **k)
        searched.append(r.searched)
        return r

    sweeps.sweep = counted
    try:
        make().analyze(key, dataclasses.replace(config, max_seeds=batch))
        torch.cuda.synchronize()
        searched.clear()
        t0 = time.perf_counter()
        result = make().analyze(key, config)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        sweeps.sweep = sweep_fn
    if result.status != A.AnalysisStatus.NOT_FOUND:
        raise RuntimeError(f"bench_analyze {family}: a random key gave {result}")
    # the profile: 16 batches of one variant
    one = {"lcg": lambda: A.LcgAnalyzer(A.lcg_core.BORLAND),
           "xorshift": lambda: A.XorshiftAnalyzer("xorshift128+"),
           "sha256_chain": lambda: A.Sha256ChainAnalyzer("iterated")}.get(family, make)()
    span = dataclasses.replace(config, max_seeds=16 * (
        batch // 4 if family == "sha256_chain" else batch))
    _, events, wall_ms = _profiled(lambda: one.analyze(key, span), 1, {kern.entry})
    searched = sum(searched)
    out = {"metric": "analyze_seeds_per_sec", "family": family, "mode": mode,
           "seeds": searched, "seconds": secs, "seeds_per_sec": searched / secs,
           "batch": batch if family != "sha256_chain" else batch // 4,
           "chain_positions_per_seed": 10 if family == "sha256_chain" else None,
           "details": result.details}
    out.update({f"{k}_per_batch": v for k, v in _breakdown(events, wall_ms, 16).items()})
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def seeded_mnemonics(n: int, seed: int = 7) -> list:
    """``n`` valid 12-word mnemonics (BIP39 words; the checksum is not
    checked), from ``seed``."""
    from .wallets import bip39

    wl = np.array(bip39.wordlist())
    idx = np.random.default_rng(seed).integers(0, 2048, (n, 12))
    return [" ".join(row) for row in wl[idx].tolist()]


def bench_wallet(wallet: str = "multibit", n: int | None = None, seed: int = 7) -> dict:
    """The wallet paths' rates on the card, on the host's clock, each run
    once under ``torch.profiler`` (device busy, launches and the idle share
    come from the same run; the path's own host work is Python, which the
    profiler does not slow).

    multibit: mnemonics/s of the dictionary attack over ``n`` (2^14) seeded
    valid mnemonics in the analyzer's chunks of 4096
    (``wallets/multibit.multibit_hd_keys_batch``: W1 twice a chunk, the
    BIP39 re-encoding and the BIP32 tail on the host), the host seconds of
    each step, and the hashlib host path's rate on 256 of the same
    mnemonics.

    electrum: seeds/s of ``scan --transform electrum`` over ``n`` (2^16)
    unix timestamps from 1,400,000,000 through ``StringDriver`` as a range
    source feeds it (``sources.STRING_BATCH`` decimal strings a batch: W2
    once, the master public keys through K3 -> K4, 20 child keys a seed on
    the host, their derive and match on the card), with one planted key at
    derivation index 7 that must be found, and the host seconds of each
    step."""
    import io

    dev = require_cuda()
    acc: dict = {}
    if wallet == "multibit":
        from .analyze.multibit import CHUNK
        from .wallets import bip39, multibit, pbkdf2_device
        from .wallets.pbkdf2_device import KERNEL as W1

        n = n or 1 << 14
        ms = seeded_mnemonics(n, seed)
        multibit.multibit_hd_keys_batch(ms[:64], "", 20, device=dev)
        undo = [_wrap(pbkdf2_device, "pbkdf2_hmac_sha512_batch", acc, "w1"),
                _wrap(bip39, "entropy_to_mnemonic", acc, "bip39"),
                _wrap(multibit, "_tail", acc, "bip32")]
        done = []
        try:
            _, events, wall_ms = _profiled(lambda: done.append(sum(
                len(multibit.multibit_hd_keys_batch(ms[i:i + CHUNK], "", 20, device=dev))
                for i in range(0, n, CHUNK))), 1, {W1.entry})
        finally:
            for u in undo:
                u()
        secs = wall_ms / 1e3
        runs = len(done)
        host_n = min(n, 256)
        t1 = time.perf_counter()
        multibit.multibit_hd_keys_batch(ms[:host_n], "", 20, device=None)
        host_secs = time.perf_counter() - t1
        out = {"metric": "multibit_dictionary_mnemonics_per_sec", "mnemonics": done[-1],
               "seconds": secs, "mnemonics_per_sec": done[-1] / secs,
               "host_w1_call_s": acc.get("w1", 0.0) / runs, "host_bip39_s": acc["bip39"] / runs,
               "host_bip32_s": acc["bip32"] / runs,
               "host_other_s": secs - sum(acc.values()) / runs,
               "hashlib_mnemonics": host_n, "hashlib_seconds": host_secs,
               "hashlib_mnemonics_per_sec": host_n / host_secs, "chunk": CHUNK}
        out.update(_breakdown(events, wall_ms, 1))
    elif wallet == "electrum":
        from . import sources
        from .wallets import electrum
        from .wallets.electrum import KERNEL as W2

        n = n or 1 << 16
        start = 1_400_000_000
        spec = parse_transform("electrum")
        planted = start + n // 3
        key = electrum.ElectrumDeriver.from_hex_seed(str(planted)).derive_key(7)
        address = KeyDeriver().derive(key).p2pkh_compressed
        one = TargetPools.from_addresses([address])
        rng = np.random.default_rng(seed)
        pools = TargetPools(np.concatenate([one.comp, rng.integers(-(1 << 63), 1 << 63, 4095)]),
                            np.concatenate([one.uncomp, rng.integers(-(1 << 63), 1 << 63, 4095)]),
                            one.targets)
        buf = io.StringIO()
        driver = StringDriver([spec], pools, ConsoleOutput(buf), device=dev)
        sources._strings_over_range(driver, 1_300_000_000, 1_300_000_000 + 63, False)
        undo = [_wrap(electrum, "stretch_keys_device", acc, "w2"),
                _wrap(electrum, "master_pubkeys_device", acc, "mpk"),
                _wrap(electrum.ElectrumDeriver, "derive_keys", acc, "children"),
                _wrap(driver, "_device_match", acc, "match")]
        stats = []
        try:
            _, events, wall_ms = _profiled(lambda: stats.append(sources._strings_over_range(
                driver, start, start + n - 1, False)), 1, {W2.entry})
        finally:
            for u in undo:
                u()
        secs, runs, st = wall_ms / 1e3, len(stats), stats[-1]
        if st.matches_found != 1 or f"Source: {planted}[0/7]\n" not in buf.getvalue():
            raise RuntimeError(f"bench_wallet electrum: the planted seed {planted} was not "
                               f"found exactly once ({st.matches_found} matches)")
        out = {"metric": "electrum_scan_seeds_per_sec", "seeds": n, "seconds": secs,
               "seeds_per_sec": n / secs, "keys_per_sec": st.keys_generated / secs,
               "string_batch": sources.STRING_BATCH}
        out.update({f"host_{k}_s": v / runs for k, v in (
            ("w2_call", acc.get("w2", 0.0)), ("master_pubkeys", acc.get("mpk", 0.0)),
            ("child_keys", acc["children"]), ("match", acc["match"]))})
        out["host_other_s"] = secs - sum(acc.values()) / runs
        out.update(_breakdown(events, wall_ms, 1))
    else:
        raise ValueError(f"bench_wallet: unknown wallet {wallet!r}; multibit or electrum")
    out["device"] = torch.cuda.get_device_name(dev)
    return out
