"""Command line of the port.

    python -m vuke_tpu_torch scan --transform milksad|direct:be --targets FILE \\
        [--batch N] range --start A --end B
    python -m vuke_tpu_torch bench [--batch N] [--sequential] [--profile]

Only the milksad and direct:be transforms over a range source are ported;
anything else stops with a "not ported yet" error.  ``VUKE_TPU_SMUL13=0``
in the environment switches both commands' scalar multiplication from K3
to K6 (``ecc/tiled.use_smul13``), as it does for the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import transforms
from ._device import require_cuda

PORTED_TRANSFORMS = tuple(transforms.TRANSFORMS)      # milksad, direct:be


def _not_ported(what: str):
    raise SystemExit(f"vuke_tpu_torch: {what} is not ported yet")


def _print_hit(hit):
    out = sys.stdout
    d = hit.derived
    out.write("\n========== HIT ==========\n")
    out.write(f"Source: {hit.seed}\n")
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


def cmd_scan(args) -> int:
    from .matcher import TargetPools
    from .pipeline import scan_range

    if args.transform.lower() not in PORTED_TRANSFORMS:
        _not_ported(f"transform {args.transform!r}")
    if args.source != "range":
        _not_ported(f"source {args.source!r}")
    pools = TargetPools.load(args.targets)
    if pools.unparsed:
        print(f"warning: {len(pools.unparsed)} targets are not addresses and "
              f"cannot match", file=sys.stderr)
    res = scan_range(args.start, args.end, pools, transform=args.transform,
                     batch=args.batch, device=_device(args.device), on_hit=_print_hit)
    print(json.dumps({"inputs_processed": res.inputs_processed,
                      "keys_generated": res.keys_generated,
                      "candidates": res.candidates,
                      "matches_found": len(res.hits)}))
    return 0


def cmd_bench(args) -> int:
    from . import benchmark

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
    scan.add_argument("--transform", required=True)
    scan.add_argument("--targets", required=True, help="file of target addresses")
    scan.add_argument("--batch", type=int, default=1 << 19)
    scan.add_argument("--device", default="cuda",
                      help="cuda (the kernels) or cpu (the plain versions)")
    src = scan.add_subparsers(dest="source", required=True)
    rng = src.add_parser("range", help="inclusive u64 seed range")
    rng.add_argument("--start", type=int, required=True)
    rng.add_argument("--end", type=int, required=True)
    for name in ("timestamps", "wordlist", "stdin", "files"):
        src.add_parser(name, help="not ported yet")
    scan.set_defaults(func=cmd_scan)

    bench = sub.add_parser("bench", help="derive rate on the card")
    bench.add_argument("--batch", type=int, default=1 << 19)
    bench.add_argument("--sequential", action="store_true",
                       help="the sequential scan's rate (direct:be) instead of "
                            "the milksad seed -> hash160 derive")
    bench.add_argument("--profile", action="store_true",
                       help="also print device time per kernel and the idle share")
    bench.set_defaults(func=cmd_bench)

    for name in ("generate", "warmup", "single", "analyze", "query"):
        sub.add_parser(name, help="not ported yet").set_defaults(
            func=lambda a, n=name: _not_ported(f"command {n!r}"))
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
