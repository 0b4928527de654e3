"""Command line of the port.

    python -m vuke_tpu_torch scan [--transform T ...] --targets FILE \\
        [--batch N] range --start A --end B
    python -m vuke_tpu_torch bench [--batch N] [--sequential] [--profile]
    python -m vuke_tpu_torch bench --transform T [--transform T ...] [--batch N]
    python -m vuke_tpu_torch bench --scan T [--pool N] [--batch N]

``scan`` takes every numeric transform of the JAX package's registry
(``transforms/registry.py``; ``--transform`` may be given more than once
and defaults to sha256) over a range source, and prints what the
reference prints: the hit banners on stdout, ``Scanning...`` and ``Done.
Inputs: N, Keys: K, Matches: M`` on stderr.  A range shorter than the batch
clamps the batch to it, 1024-aligned (``vuke_tpu/cli.py:293-302``).  The
wallet transforms and the other sources stop with a "not ported yet"
error.  ``VUKE_TPU_SMUL13=0`` in the environment switches the scalar
multiplication from K3 to K6 (``ecc/tiled.use_smul13``) and
``VUKE_TPU_SEQUENTIAL=0`` turns the sequential path off
(``ecc/incremental.use_sequential``), as they do for the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ._device import require_cuda
from .matcher import TargetPools
from .pipeline import DEFAULT_BATCH, ForwardDriver
from .transforms import NotPortedError, parse_transform


def _not_ported(what: str):
    raise SystemExit(f"vuke_tpu_torch: {what} is not ported yet")


def _print_hit(hit):
    out = sys.stdout
    d = hit.derived
    out.write("\n========== HIT ==========\n")
    out.write(f"Source: {hit.source}\n")
    out.write(f"Transform: {hit.transform}\n")
    out.write(f"Matched: {hit.address} ({hit.address_type})\n")
    out.write("---\n")
    out.write(f"Private Key: {d.private_key_hex}\n")
    out.write(f"WIF (compressed): {d.wif_compressed}\n")
    out.write(f"WIF (uncompressed): {d.wif_uncompressed}\n")
    out.write("---\n")
    out.write(f"P2PKH (compressed): {d.p2pkh_compressed}\n")
    out.write(f"P2PKH (uncompressed): {d.p2pkh_uncompressed}\n")
    out.write(f"P2WPKH: {d.p2wpkh}\n")
    out.write("=========================\n")
    out.flush()


def _device(name: str) -> torch.device:
    return require_cuda() if name == "cuda" else torch.device(name)


def _parse_specs(names):
    specs = []
    for t in names:
        try:
            specs.append(parse_transform(t))
        except NotPortedError:
            _not_ported(f"transform {t!r}")
        except ValueError as e:
            raise SystemExit(f"vuke_tpu_torch: {e}") from None
    return specs


def _clamp_batch(batch, total: int) -> int:
    """The superbatch for a range of ``total`` seeds: ``batch`` (the port's
    default when None), clamped 1024-aligned to a shorter range, with the
    reference's note when the batch was given (``vuke_tpu/cli.py:293-302``)."""
    size = batch or DEFAULT_BATCH
    if total < size:
        clamped = max(1024, -(-total // 1024) * 1024)
        if batch is not None:
            print(f"note: --batch {size} exceeds the {total}-seed range; clamping to "
                  f"{clamped}", file=sys.stderr)
        size = clamped
    return size


def cmd_scan(args) -> int:
    specs = _parse_specs(args.transform or ["sha256"])
    if args.source != "range":
        _not_ported(f"source {args.source!r}")
    pools = TargetPools.load(args.targets)
    if pools.unparsed:
        print(f"warning: {len(pools.unparsed)} targets are not addresses and "
              f"cannot match", file=sys.stderr)
    print("Scanning...", file=sys.stderr)
    batch = _clamp_batch(args.batch, args.end - args.start + 1)
    res = ForwardDriver(specs, pools, batch=batch, device=_device(args.device),
                        on_hit=_print_hit).run_range(args.start, args.end)
    sys.stdout.flush()
    print(f"Done. Inputs: {res.inputs_processed}, Keys: {res.keys_generated}, "
          f"Matches: {len(res.hits)}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from . import benchmark

    if args.transform:
        for name in args.transform:
            print(json.dumps(benchmark.bench_transform(name, batch=args.batch)), flush=True)
        return 0
    if args.scan:
        print(json.dumps(benchmark.bench_scan(args.scan, pool_size=args.pool,
                                              batch=args.batch)))
        return 0
    if args.sequential:
        bench, prof = benchmark.bench_sequential, benchmark.profile_sequential
    else:
        bench, prof = benchmark.bench_derive, benchmark.profile_derive
    print(json.dumps(bench(batch=args.batch)))
    if args.profile:
        print(json.dumps(prof(batch=args.batch)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m vuke_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    scan = sub.add_parser("scan", help="forward search against target addresses")
    scan.add_argument("--transform", action="append",
                      help="transform to apply (sha256, lcg, lcg:glibc:le, ...); may be "
                           "given more than once; default sha256")
    scan.add_argument("--targets", required=True, help="file of target addresses")
    scan.add_argument("--batch", type=int, default=None,
                      help=f"seeds per superbatch (default {DEFAULT_BATCH}, clamped to "
                           f"short ranges)")
    scan.add_argument("--device", default="cuda",
                      help="cuda (the kernels) or cpu (the plain versions)")
    src = scan.add_subparsers(dest="source", required=True)
    rng = src.add_parser("range", help="inclusive u64 seed range")
    rng.add_argument("--start", type=int, required=True)
    rng.add_argument("--end", type=int, required=True)
    for name in ("timestamps", "wordlist", "stdin", "files"):
        src.add_parser(name, help="not ported yet")
    scan.set_defaults(func=cmd_scan)

    bench = sub.add_parser("bench", help="derive, keygen or scan rate on the card")
    bench.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    bench.add_argument("--sequential", action="store_true",
                       help="the sequential scan's rate (direct:be) instead of "
                            "the milksad seed -> hash160 derive")
    bench.add_argument("--profile", action="store_true",
                       help="also print device time per kernel and the idle share")
    bench.add_argument("--transform", action="append",
                       help="the keygen-only rate of this transform (inputs/s and keys/s) "
                            "instead; may be given more than once")
    bench.add_argument("--scan", metavar="TRANSFORM",
                       help="keys/s of a scan with this transform through the "
                            "pipelined driver, with its profile, instead")
    bench.add_argument("--pool", type=int, default=4096,
                       help="fragments in the target pool of --scan (default 4096)")
    bench.set_defaults(func=cmd_bench)

    for name in ("generate", "warmup", "single", "analyze", "query"):
        sub.add_parser(name, help="not ported yet").set_defaults(
            func=lambda a, n=name: _not_ported(f"command {n!r}"))
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
