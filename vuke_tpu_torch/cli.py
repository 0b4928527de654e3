"""Command line of the port.

    python -m vuke_tpu_torch generate [OPTIONS] SOURCE
    python -m vuke_tpu_torch scan --targets FILE [OPTIONS] SOURCE
    python -m vuke_tpu_torch single PASSPHRASE [--transform T] [--network N]
    python -m vuke_tpu_torch warmup [--transform T ...] [--batch N] [--device D]
    python -m vuke_tpu_torch [--no-tpu] COMMAND ...
    python -m vuke_tpu_torch bench [--transform T] [--batch N] [--seconds S] [--json]
    python -m vuke_tpu_torch bench --derive [--sequential] [--profile] [--batch N]
    python -m vuke_tpu_torch bench --scan T [--pool N] [--batch N]
    python -m vuke_tpu_torch bench --generate T | --strings T [--batch N]
    python -m vuke_tpu_torch bench --analyze F [--mode M]
    python -m vuke_tpu_torch bench --wallet multibit|electrum
    python -m vuke_tpu_torch bench --generate T --storage DIR
    python -m vuke_tpu_torch analyze KEY [--fast] [--mask N] [--cascade C]
        [--analyzer A ...] [--mnemonic M | --mnemonic-file F] [--passphrase P]
        [--chain-depth D] [--puzzle P] [--verify C] [--json]
        [--batch N] [--max-seeds N] [--checkpoint FILE] [--device D]
    python -m vuke_tpu_torch query PATH [SQL] [--format/-f table|json|csv] [--schema]

OPTIONS are those of ``vuke_tpu/cli.py``: ``--transform`` (repeatable,
default sha256), ``--network``, ``-v``, ``-o FILE``, ``--storage DIR`` with
``--chunk-records``, ``--chunk-bytes``, ``--compression`` and
``--compression-level``, the ``--cloud-*`` and ``--iceberg-*`` options
(and their ``CLOUD_*`` and ``ICEBERG_*`` environment variables),
``--batch``, ``--checkpoint``, the ``--bitimage-*`` options (for
``--transform bitimage``) and ``--device`` (cuda, the kernels, or cpu, the
plain versions).  SOURCE is ``range --start A --end
B``, ``wordlist --file F``, ``timestamps --start DATE --end DATE
[--microseconds]``, ``stdin`` or ``files --file F | --dir D``.  Stdout and
stderr are the JAX package's for the same command line (``vuke_tpu/cli.py:
256-340, 469-514``): hit banners or key lines on stdout, in its order
(``pipeline.ORDER_BATCH``); ``Loaded N target addresses``, ``Scanning...``
or ``Generating keys...``, and ``Done. Inputs: N, Keys: K, Matches: M`` on
stderr.  A range shorter than the batch clamps it, 1024-aligned.
``--targets`` takes a file or a provider reference (``boha:...``,
``provider.py``).  Every transform of the JAX registry runs, the wallet
ones (electrum, electrum:change, multibit, armory, bitimage) included.
``analyze`` is ``vuke_tpu/cli.py:543-575``: every option, its stdout and
stderr, its sweeps on the card (S1 and S2) and the multibit-hd analyzer's
PBKDF2 (W1) unless ``--device cpu``.  ``--storage`` writes the JAX
package's Parquet files (``storage/``): every generate record, its string
columns from E1 (``cores/records.py``) on the card, or a scan's hits; then
``Storage: N files written (X)`` on stderr, the cloud upload and the
Iceberg registration (``vuke_tpu/cli.py:160-230``).  ``single`` and
``query`` (``vuke_tpu/cli.py:581-597``) run on the host alone, as the JAX
package's do.  ``--no-tpu`` before the command is the JAX group's flag: the
device commands run on the CPU (``--device cpu``), ``single`` and
``query`` ignore it; without it every device command runs on the card.
``bench`` is the JAX command's (``vuke_tpu/cli.py:527-535``,
``benchmark.run_benchmark``).  ``VUKE_TPU_SMUL13=0`` in
the environment switches the scalar multiplication from K3 to K6 and
``VUKE_TPU_SEQUENTIAL=0`` turns the sequential path off, as they do for
the JAX package.  With ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
and ``JAX_PROCESS_ID`` set, ``generate``, ``scan`` and ``analyze`` join a
gloo world of that many processes (``parallel/multihost.py``): rank r runs
on ``cuda:{r % device_count}``, takes its shard of a range or timestamps
source (``Host r/n: seeds [a, b]`` on stderr, ``--checkpoint PATH.h{r}``)
or of each brute-force space, as the JAX package's processes do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from . import encode
from ._device import run_device
from .derive import KeyDeriver
from .matcher import TargetPools
from .output import ConsoleOutput
from .pipeline import DEFAULT_BATCH, ORDER_BATCH, ForwardDriver, ProcessStats, StringDriver
from .progress import Progress
from .transforms import parse_transform

COMPRESSIONS = ("zstd", "snappy", "gzip", "lz4", "none")


def _usage_error(msg: str):
    """The last line and the exit code of the JAX command line's usage
    errors (click's ``Error: ...``, 2)."""
    print(f"Error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _fail(msg: str):
    """The last line and the exit code of the JAX command line's own
    errors (click's ``ClickException``: ``Error: ...``, 1)."""
    print(f"Error: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _parse_byte_size(s: str) -> int:
    """100M / 1G / plain bytes (``vuke_tpu/cli.py:19-32``)."""
    s = s.strip().upper()
    mult = 1
    if s.endswith("K"):
        mult, s = 1024, s[:-1]
    elif s.endswith("M"):
        mult, s = 1024 ** 2, s[:-1]
    elif s.endswith("G"):
        mult, s = 1024 ** 3, s[:-1]
    try:
        return int(s) * mult
    except ValueError:
        _usage_error(f"Invalid value for '--chunk-bytes': invalid byte size: {s!r}")


def _format_bytes(n: int) -> str:
    for unit, div in (("GB", 1024 ** 3), ("MB", 1024 ** 2), ("KB", 1024)):
        if n >= div:
            return f"{n / div:.1f} {unit}"
    return f"{n} B"


def _env_default(value, name: str, default=None):
    """An option's value, else its environment variable's, else the default
    (click's ``envvar``)."""
    return value if value is not None else os.environ.get(name) or default


def _build_outputs(args):
    """The console (or ``-o`` file) and, with ``--storage``, the Parquet
    output behind it (``vuke_tpu/cli.py:160-181``): (output, the storage
    output or None)."""
    from .output import MultiOutput

    # the options' checks, with or without --storage, as click's
    chunk_bytes = _parse_byte_size(args.chunk_bytes)
    if not 1 <= args.compression_level <= 22:
        _usage_error(f"Invalid value for '--compression-level': {args.compression_level} is "
                     f"not in the range 1<=x<=22.")
    console = (ConsoleOutput.to_file(args.output_path, verbose=args.verbose) if args.output_path
               else ConsoleOutput(verbose=args.verbose))
    if not args.storage_dir:
        return console, None
    from .storage import ParquetBackend, StorageOutput

    storage = StorageOutput(ParquetBackend(
        args.storage_dir, max_records_per_chunk=args.chunk_records,
        max_bytes_per_chunk=chunk_bytes, compression=args.compression,
        compression_level=args.compression_level))
    return MultiOutput([console, storage]), storage


def _post_run_storage(args, storage_output):
    """finish -> the chunks' sizes on stderr -> stat -> cloud upload ->
    Iceberg registration (``vuke_tpu/cli.py:184-226``)."""
    if storage_output is None:
        return
    summary = storage_output.finish()
    if summary.paths:
        total = sum(os.path.getsize(p) for p in summary.paths if os.path.exists(p))
        print(f"\nStorage: {len(summary.paths)} files written ({_format_bytes(total)})",
              file=sys.stderr)
        for p in summary.paths:
            sz = os.path.getsize(p) if os.path.exists(p) else 0
            print(f"  {p} ({_format_bytes(sz)})", file=sys.stderr)
    if not (args.cloud_upload and summary.paths):
        return
    from .storage.cloud import CloudConfig, sync_to_cloud

    endpoint = _env_default(args.cloud_endpoint, "CLOUD_ENDPOINT")
    catalog = _env_default(args.iceberg_catalog, "ICEBERG_CATALOG")
    cfg = CloudConfig(endpoint=endpoint, bucket=_env_default(args.cloud_bucket, "CLOUD_BUCKET"),
                      delete_local=args.cloud_delete_local, fail_fast=args.cloud_fail_fast)
    stats_by_key = None
    if catalog:
        # stat the local chunks before the upload: --cloud-delete-local
        # removes them, and the snapshot needs their sizes and record counts
        from .storage.iceberg import stat_local_files
        try:
            stats_by_key = stat_local_files(summary.paths, args.storage_dir)
        except Exception as e:
            print(f"Iceberg: could not stat local chunks: {e}", file=sys.stderr)
    uploaded = sync_to_cloud(summary.paths, args.storage_dir, cfg)
    if catalog and uploaded:
        from .storage.iceberg import join_uploaded_metadata, register_snapshot
        files = (join_uploaded_metadata(stats_by_key, uploaded, endpoint=endpoint)
                 if stats_by_key is not None else uploaded)
        register_snapshot(catalog_url=catalog,
                          namespace=_env_default(args.iceberg_namespace, "ICEBERG_NAMESPACE",
                                                 "vuke"),
                          table=_env_default(args.iceberg_table, "ICEBERG_TABLE", "results"),
                          files=files)


def _parse_specs(names, args=None):
    """The specs of ``--transform`` values; ``bitimage`` takes the
    ``--bitimage-*`` options of ``args`` (``vuke_tpu/cli.py:236-252``)."""
    from .transforms.wallets import bitimage_spec

    specs = []
    for t in names:
        try:
            if t.lower() == "bitimage" and args is not None:
                specs.append(bitimage_spec(
                    path=args.bitimage_path, passphrase=args.bitimage_passphrase,
                    passphrase_wordlist=args.bitimage_passphrase_wordlist,
                    derive_count=args.bitimage_derive_count))
            else:
                specs.append(parse_transform(t))
        except ValueError as e:
            _usage_error(str(e))
    return specs


def _clamp_batch(batch, total: int, default: int | None = None) -> int:
    """The superbatch for a range of ``total`` seeds: ``batch`` (``default``,
    or the port's ``DEFAULT_BATCH``, when None), clamped 1024-aligned to a
    shorter range, with the reference's note when the batch was given
    (``vuke_tpu/cli.py:293-302``)."""
    size = batch or default or DEFAULT_BATCH
    if total < size:
        clamped = max(1024, -(-total // 1024) * 1024)
        if batch is not None:
            print(f"note: --batch {size} exceeds the {total}-seed range; clamping to "
                  f"{clamped}", file=sys.stderr)
        size = clamped
    return size


def _make_source(args):
    from . import sources

    if args.source == "range":
        return sources.RangeSource(args.start, args.end)
    if args.source == "timestamps":
        return sources.TimestampSource.from_dates(args.start, args.end, args.microseconds)
    if args.source == "stdin":
        return sources.StdinSource()
    if args.source == "wordlist":
        paths = [("--file", args.path)]
    else:
        if bool(args.file_path) == bool(args.dir_path):
            _usage_error("exactly one of --file / --dir required")
        paths = [("--file", args.file_path), ("--dir", args.dir_path)]
    for flag, path in paths:
        if path is not None and not os.path.exists(path):
            _usage_error(f"Invalid value for '{flag}': Path {path!r} does not exist.")
    if args.source == "wordlist":
        return sources.WordlistSource(args.path)
    return sources.FilesSource(args.file_path or args.dir_path, recursive=bool(args.dir_path))


def _run_forward(args, specs, source, pools) -> int:
    """generate (``pools`` None) or scan over ``source``: the port of
    ``vuke_tpu/cli.py::_run_forward``.  In a world of several processes
    (``parallel/multihost.py``) each rank takes its own shard of a range
    or timestamps source, and its checkpoint path gains ``.h{rank}``; the
    other sources run whole on every rank."""
    from .parallel.checkpoint import SweepCheckpoint
    from .parallel.multihost import maybe_initialize_distributed, partition_range
    from .sources import RangeSource, TimestampSource

    deriver = KeyDeriver(encode.parse_network(args.network))
    transforms = args.transform or ["sha256"]
    pidx, pcount = maybe_initialize_distributed()
    dev = run_device(args.device)
    out, storage = _build_outputs(args)
    print("Scanning..." if pools is not None else "Generating keys...", file=sys.stderr)
    label = "scan" if pools is not None else "generate"
    ranged = isinstance(source, (RangeSource, TimestampSource))
    if pcount > 1 and ranged:
        # static per-rank ownership of the seed range (multihost.py)
        shard = partition_range(source.start, source.end, pcount, pidx)
        print(f"Host {pidx}/{pcount}: seeds [{shard.start}, {shard.end}]", file=sys.stderr)
        source = dataclasses.replace(source, start=shard.start, end=shard.end)
    fwd = None
    if ranged:
        total = source.end - source.start + 1
        if getattr(source, "microseconds", False):
            total += (source.end + 1) * 1000 - source.start * 1000
        progress = Progress(total=total, label=label)
        # the device superbatch, and the JAX package's, which sets the order
        batch = _clamp_batch(args.batch, total)
        order = batch if args.batch else _clamp_batch(None, total, ORDER_BATCH)
        fwd = ForwardDriver(specs, pools, batch=batch, device=dev, output=out, deriver=deriver,
                            progress=progress, order_batch=order)
    else:
        progress = Progress(total=None, label=label)
    sd = StringDriver(specs, pools, out, deriver, device=dev, progress=progress)

    ckpt = None
    if args.checkpoint_path and ranged:
        job = f"{label}:{','.join(sorted(transforms))}:{source.start}-{source.end}"
        path = args.checkpoint_path
        if pcount > 1:
            path = f"{path}.h{pidx}"
        ckpt = SweepCheckpoint.load(path, job)
    if ckpt is not None:
        stats = ProcessStats()
        chunk = order * 16
        for s, e in ckpt.pending_ranges(source.start, source.end):
            pos = s
            while pos <= e:
                ce = min(e, pos + chunk - 1)
                stats.merge(dataclasses.replace(source, start=pos, end=ce).process(fwd, sd))
                ckpt.mark_completed(pos, ce)
                ckpt.save()
                pos = ce + 1
    else:
        stats = source.process(fwd, sd)
    progress.finish()
    out.flush()
    out.close()
    print(f"Done. Inputs: {stats.inputs_processed}, Keys: {stats.keys_generated}, "
          f"Matches: {stats.matches_found}", file=sys.stderr)
    _post_run_storage(args, storage)
    return 0


def cmd_generate(args) -> int:
    specs = _parse_specs(args.transform or ["sha256"], args)
    return _run_forward(args, specs, _make_source(args), None)


def cmd_scan(args) -> int:
    specs = _parse_specs(args.transform or ["sha256"], args)
    source = _make_source(args)
    return _run_forward(args, specs, source, _load_targets(args.targets))


def _load_targets(t: str) -> TargetPools:
    """A target file, or a provider reference resolved to its addresses,
    with the JAX command line's stderr (``vuke_tpu/cli.py:360-383``)."""
    from . import provider

    resolved = provider.resolve(t)
    if resolved is None:
        pools = TargetPools.load(t)
        print(f"Loaded {pools.count()} target addresses", file=sys.stderr)
        return pools
    if not resolved.addresses:
        # a scan against zero targets finds nothing by construction
        _fail(f"{resolved.description} resolved to 0 usable addresses"
              + (f" ({resolved.skipped_offline} matching entries ship "
                 f"address: null in the offline dataset — see "
                 f"tools/build_puzzles.py provenance notes)"
                 if resolved.skipped_offline else ""))
    if resolved.skipped_offline:
        print(f"warning: {resolved.skipped_offline} matching puzzles have "
              f"no offline address and are NOT scanned for", file=sys.stderr)
    pools = TargetPools.from_addresses(resolved.addresses)
    print(f"Loaded {pools.count()} target addresses from provider {t}", file=sys.stderr)
    return pools


def cmd_single(args) -> int:
    """One passphrase through a string transform, every representation of
    each key: ``vuke_tpu/cli.py:469-514`` line for line, on the host."""
    try:
        spec = parse_transform(args.transform)
    except ValueError as e:
        _usage_error(str(e))
    deriver = KeyDeriver(encode.parse_network(args.network))
    p = args.passphrase
    keys = []
    if spec.string is not None:
        kw = spec.string.fn([p], torch.device("cpu"))
        valid = spec.string.valid_fn([p]) if spec.string.valid_fn else None
        for s_i, slot in enumerate(spec.string.slots):
            if valid is not None and not valid[0, s_i]:
                continue
            keys.append((f"{spec.string.label(p)}{slot}", kw[0, s_i].astype(">u4").tobytes()))
    if not keys:
        print("No key generated from passphrase.", file=sys.stderr)
        return 0
    for source, key in keys:
        d = deriver.derive(key)
        print(f'Passphrase: "{p}"\nTransform: {spec.name}\nSource: {source}\n---\n'
              f"Private Key (hex):     {d.private_key_hex}\n"
              f"Private Key (decimal): {d.private_key_decimal}\n"
              f"Private Key (binary):  {d.private_key_binary}\n"
              f"Bit Length:            {d.bit_length}\n"
              f"Hamming Weight:        {d.hamming_weight}\n"
              f"Leading Zeros (hex):   {d.leading_zeros}\n"
              f"WIF (compressed):      {d.wif_compressed}\n"
              f"WIF (uncompressed):    {d.wif_uncompressed}\n---\n"
              f"P2PKH (compressed):   {d.p2pkh_compressed}\n"
              f"P2PKH (uncompressed): {d.p2pkh_uncompressed}\n"
              f"P2WPKH:               {d.p2wpkh}")
    return 0


def cmd_warmup(args) -> int:
    """Build and launch once, at the batch, every kernel each transform's
    scan of a range runs: two superbatches from seed 2 (the first below
    batch + 2, so a sequential slot takes the keygen there and the
    sequential path, table included, in the second).  A string-only or
    host-only transform is skipped with the JAX package's line
    (``vuke_tpu/cli.py:448-455``)."""
    from .kernels import Kernel

    dev = run_device(args.device)
    b = args.batch or DEFAULT_BATCH
    pools = TargetPools.from_addresses(["1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH"])
    for t in args.transform or ["milksad", "direct"]:
        spec = _parse_specs([t])[0]
        if spec.numeric is None:
            print(f"skipping {t}: string transform (host path)", file=sys.stderr)
            continue
        if spec.numeric.host_only:
            print(f"skipping {t}: host-only transform", file=sys.stderr)
            continue
        before = {name: k.launches for name, k in Kernel.registry.items()}
        t0 = time.perf_counter()
        ForwardDriver([spec], pools, batch=b, device=dev).run_range(2, 2 * b + 1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = [name for name, k in Kernel.registry.items() if k.launches > before[name]]
        print(f"warmed {t} at batch {b}: {', '.join(launched) or 'no kernels (plain versions)'}"
              f" in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 0


def cmd_analyze(args) -> int:
    """``analyze KEY``: ``vuke_tpu/cli.py:543-575`` and ``run_analyze``; in
    a world of several processes (``parallel/multihost.py``, joined here,
    where JAX's runtime finds a pod's processes by itself) each rank sweeps
    its shard of every brute-force space."""
    from .analyze import run_analyze
    from .parallel.multihost import maybe_initialize_distributed

    if args.mask is not None and not 1 <= args.mask <= 64:
        _usage_error(f"Invalid value for '--mask': {args.mask} is not in the range 1<=x<=64.")
    maybe_initialize_distributed()
    dev = run_device(args.device)
    run_analyze(key_str=args.key, fast=args.fast, mask=args.mask, cascade=args.cascade,
                analyzers=list(args.analyzers or ()), mnemonic=args.mnemonic,
                mnemonic_file=args.mnemonic_file, passphrase=args.passphrase,
                chain_depth=args.chain_depth, puzzle=args.puzzle, verify=args.verify,
                as_json=args.as_json, batch=args.batch, max_seeds=args.max_seeds,
                checkpoint=args.checkpoint_path, device=str(dev))
    return 0


def cmd_query(args) -> int:
    """SQL over stored results (``vuke_tpu/cli.py:581-597``), on the host."""
    from .storage.query import QueryExecutor, format_results

    if not os.path.exists(args.path):
        _usage_error(f"Invalid value for 'PATH': Path {args.path!r} does not exist.")
    ex = QueryExecutor(args.path)
    if args.show_schema:
        print(ex.schema_text())
        return 0
    if not args.sql:
        _usage_error("SQL query required (or use --schema)")
    rows, columns = ex.query(args.sql)
    print(format_results(rows, columns, args.fmt))
    return 0


def cmd_bench(args) -> int:
    """The JAX command's ``bench`` (``vuke_tpu/cli.py:527-535``) unless one
    of the port's own benches is named: ``--derive`` (or ``--sequential``,
    ``--profile``), ``--scan``, ``--generate`` [``--storage``],
    ``--strings``, ``--analyze``, ``--wallet``, each one JSON line."""
    from . import benchmark

    batch = args.batch or DEFAULT_BATCH
    own = (args.derive or args.sequential or args.profile or args.scan or args.generate
           or args.strings or args.analyze or args.wallet)
    if own and args.device != "cuda":
        _usage_error("the port's own benches (--derive, --sequential, --profile, --scan, "
                     "--generate, --strings, --analyze, --wallet) measure the card: drop "
                     "--no-tpu")
    if args.analyze:
        print(json.dumps(benchmark.bench_analyze(args.analyze, args.mode)), flush=True)
        return 0
    if args.wallet:
        print(json.dumps(benchmark.bench_wallet(args.wallet)), flush=True)
        return 0
    if args.scan:
        print(json.dumps(benchmark.bench_scan(args.scan, pool_size=args.pool, batch=batch)))
        return 0
    if args.generate and args.storage:
        print(json.dumps(benchmark.bench_storage(args.generate, args.storage)))
        return 0
    if args.generate:
        print(json.dumps(benchmark.bench_generate(args.generate, batch=batch)))
        return 0
    if args.strings:
        print(json.dumps(benchmark.bench_strings(args.strings)))
        return 0
    if args.derive or args.sequential or args.profile:
        if args.sequential:
            bench, prof = benchmark.bench_sequential, benchmark.profile_sequential
        else:
            bench, prof = benchmark.bench_derive, benchmark.profile_derive
        print(json.dumps(bench(batch=batch)))
        if args.profile:
            print(json.dumps(prof(batch=batch)))
        return 0
    benchmark.run_benchmark(args.transform, as_json=args.as_json,
                            batch=args.batch or 1 << 16, seconds=args.seconds,
                            device=args.device)
    return 0


def _run_options(p: argparse.ArgumentParser):
    p.add_argument("--transform", action="append",
                   help="transform to apply (sha256, lcg, lcg:glibc:le, ...); may be given "
                        "more than once; default sha256")
    p.add_argument("--network", default="bitcoin",
                   help="bitcoin, testnet, signet or regtest")
    p.add_argument("--verbose", "-v", action="store_true", help="verbose key blocks")
    p.add_argument("--output", "-o", dest="output_path", default=None,
                   help="output file (default: stdout)")
    p.add_argument("--batch", type=int, default=None,
                   help=f"seeds per superbatch (default {DEFAULT_BATCH}, clamped to short "
                        f"ranges)")
    p.add_argument("--checkpoint", dest="checkpoint_path", default=None,
                   help="manifest of the completed seed ranges, skipped on a rerun "
                        "(numeric sources)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    p.add_argument("--bitimage-path", default="m/84'/0'/0'/0/0",
                   help="bitimage: the BIP32 path (default m/84'/0'/0'/0/0)")
    p.add_argument("--bitimage-passphrase", default="", help="bitimage: the BIP39 passphrase")
    p.add_argument("--bitimage-passphrase-wordlist", default=None,
                   help="bitimage: a file of passphrases, one a line, each tried")
    p.add_argument("--bitimage-derive-count", type=int, default=1,
                   help="bitimage: addresses a passphrase, the path's last index incremented")
    p.add_argument("--storage", dest="storage_dir", default=None,
                   help="storage directory for Parquet output")
    p.add_argument("--chunk-records", type=int, default=1_000_000,
                   help="records a Parquet chunk (default 1000000; 0: no limit)")
    p.add_argument("--chunk-bytes", default="100M",
                   help="bytes a Parquet chunk: 100M, 1G, plain bytes (default 100M; 0: no limit)")
    p.add_argument("--compression", default="zstd", choices=COMPRESSIONS)
    p.add_argument("--compression-level", type=int, default=3, help="1-22 (zstd, gzip)")
    p.add_argument("--cloud-upload", action="store_true",
                   help="upload the chunks to S3-compatible storage after the run")
    p.add_argument("--cloud-endpoint", default=None, help="(env CLOUD_ENDPOINT)")
    p.add_argument("--cloud-bucket", default=None, help="(env CLOUD_BUCKET)")
    p.add_argument("--cloud-delete-local", action="store_true",
                   help="delete each chunk once it is uploaded")
    p.add_argument("--cloud-fail-fast", action="store_true",
                   help="stop the upload at the first failure")
    p.add_argument("--iceberg-catalog", default=None,
                   help="Iceberg REST catalog to register the uploads in (env ICEBERG_CATALOG)")
    p.add_argument("--iceberg-namespace", default=None,
                   help="(env ICEBERG_NAMESPACE, default vuke)")
    p.add_argument("--iceberg-table", default=None, help="(env ICEBERG_TABLE, default results)")


def _sources(p: argparse.ArgumentParser):
    src = p.add_subparsers(dest="source", required=True)
    rng = src.add_parser("range", help="inclusive u64 seed range")
    rng.add_argument("--start", type=int, required=True)
    rng.add_argument("--end", type=int, required=True)
    words = src.add_parser("wordlist", help="one string a line")
    words.add_argument("--file", dest="path", required=True)
    ts = src.add_parser("timestamps", help="unix seconds of a date range (UTC)")
    ts.add_argument("--start", required=True, help="start date (YYYY-MM-DD)")
    ts.add_argument("--end", required=True, help="end date (YYYY-MM-DD)")
    ts.add_argument("--microseconds", action="store_true", help="also test milliseconds")
    src.add_parser("stdin", help="one string a line on standard input")
    files = src.add_parser("files", help="each file's path as a string")
    files.add_argument("--file", dest="file_path", default=None)
    files.add_argument("--dir", dest="dir_path", default=None)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m vuke_tpu_torch")
    p.add_argument("--no-tpu", dest="no_tpu", action="store_true",
                   help="run on the CPU through the plain versions (the JAX command's flag; "
                        "single and query ignore it)")
    sub = p.add_subparsers(dest="command", required=True)

    gen = sub.add_parser("generate", help="generate keys and print every one")
    _run_options(gen)
    _sources(gen)
    gen.set_defaults(func=cmd_generate)

    scan = sub.add_parser("scan", help="forward search against target addresses")
    _run_options(scan)
    scan.add_argument("--targets", required=True,
                      help="target addresses: a file or a provider (e.g. boha:b1000:unsolved)")
    _sources(scan)
    scan.set_defaults(func=cmd_scan)

    single = sub.add_parser("single", help="every representation of one passphrase's key")
    single.add_argument("passphrase")
    single.add_argument("--transform", default="sha256")
    single.add_argument("--network", default="bitcoin")
    single.set_defaults(func=cmd_single)

    warm = sub.add_parser("warmup", help="build and launch the scan kernels once")
    warm.add_argument("--transform", action="append",
                      help="transform to warm (repeatable; default milksad and direct)")
    warm.add_argument("--batch", type=int, default=None,
                      help=f"superbatch to warm (default {DEFAULT_BATCH})")
    warm.add_argument("--device", default="cuda")
    warm.set_defaults(func=cmd_warmup)

    bench = sub.add_parser("bench", help="inputs/s of a transform (2 s warm-up, then "
                                         "--seconds), or one of the port's own rates")
    bench.add_argument("--transform", default="sha256",
                       help="the transform to time (default sha256; the last one given counts)")
    bench.add_argument("--json", dest="as_json", action="store_true",
                       help="one JSON object instead of the three lines")
    bench.add_argument("--batch", type=int, default=None,
                       help=f"inputs a call (default 65536; string transforms at most 1000; "
                            f"{DEFAULT_BATCH} for the port's own benches)")
    bench.add_argument("--seconds", type=float, default=5.0,
                       help="seconds measured after the warm-up (default 5)")
    bench.add_argument("--derive", action="store_true",
                       help="seed_to_hash160_derivations_per_sec (milksad seeds -> hash160 "
                            "on the card) as JSON, instead")
    bench.add_argument("--sequential", action="store_true",
                       help="the sequential scan's rate (direct:be) instead of "
                            "the milksad seed -> hash160 derive")
    bench.add_argument("--profile", action="store_true",
                       help="also print device time per kernel and the idle share")
    bench.add_argument("--scan", metavar="TRANSFORM",
                       help="keys/s of a scan with this transform through the "
                            "pipelined driver, with its profile, instead")
    bench.add_argument("--pool", type=int, default=4096,
                       help="fragments in the target pool of --scan (default 4096)")
    bench.add_argument("--generate", metavar="TRANSFORM",
                       help="lines/s of generate over a range with this transform, into "
                            "a discarding sink and into a file, with its profile, instead")
    bench.add_argument("--storage", metavar="DIR",
                       help="with --generate: records/s of generate --storage into Parquet "
                            "in a fresh subdirectory of DIR (removed after the run), a "
                            "superbatch's time split, and the host path's rate")
    bench.add_argument("--strings", metavar="TRANSFORM",
                       help="words/s and keys/s of a wordlist scan with this transform, "
                            "with its profile, instead")
    bench.add_argument("--analyze", metavar="FAMILY",
                       help="seeds/s of a reverse sweep of this family (milksad, mt64, lcg, "
                            "xorshift, sha256_chain) over 2^32 seeds or more, with each "
                            "kernel's device ms, instead")
    bench.add_argument("--mode", default="exact", choices=("exact", "mask", "cascade"),
                       help="the --analyze sweep's compare (default exact)")
    bench.add_argument("--wallet", choices=("multibit", "electrum"),
                       help="mnemonics/s of the multibit-hd dictionary attack (beside the "
                            "hashlib host path's) or seeds/s of an electrum timestamp scan, "
                            "with the kernel's time and the host's, instead")
    bench.set_defaults(func=cmd_bench, device="cuda")

    an = sub.add_parser("analyze", help="analyze a private key for vulnerable origins")
    an.add_argument("key")
    an.add_argument("--fast", action="store_true", help="skip brute-force checks")
    an.add_argument("--mask", type=int, default=None, help="bits of the key known (1-64)")
    an.add_argument("--cascade", default=None, help="bits:target,bits:target,... or boha:...")
    an.add_argument("--analyzer", dest="analyzers", action="append",
                    help="analyzer to run (repeatable; default all)")
    an.add_argument("--mnemonic", default=None, help="multibit-hd: the mnemonic to check")
    an.add_argument("--mnemonic-file", default=None,
                    help="multibit-hd: a file of candidate mnemonics, one a line")
    an.add_argument("--passphrase", default="", help="multibit-hd: the BIP39 passphrase")
    an.add_argument("--chain-depth", type=int, default=10)
    an.add_argument("--puzzle", default=None, help="boha:collection:id[:n]")
    an.add_argument("--verify", default=None, help="boha:collection")
    an.add_argument("--json", dest="as_json", action="store_true")
    an.add_argument("--batch", type=int, default=None,
                    help="sweep batch (default 2^24 on the card, 2^20 on the CPU)")
    an.add_argument("--max-seeds", type=int, default=None,
                    help="bound open-ended sweeps (default unbounded)")
    an.add_argument("--checkpoint", dest="checkpoint_path", default=None,
                    help="manifest path for durable brute-force progress")
    an.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    an.set_defaults(func=cmd_analyze)

    query = sub.add_parser("query", help="query stored results using SQL")
    query.add_argument("path")
    query.add_argument("sql", nargs="?", default=None)
    query.add_argument("--format", "-f", dest="fmt", default="table",
                       choices=("table", "json", "csv"))
    query.add_argument("--schema", dest="show_schema", action="store_true")
    query.set_defaults(func=cmd_query)
    return p


# subcommands that never touch a device ignore --no-tpu, as the JAX
# command's group does (vuke_tpu/cli.py:125)
_HOST_ONLY_COMMANDS = {"single", "query"}


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's options, ``--no-tpu`` applied: ``device`` is
    "cpu" for every device command, as the JAX group switches to its CPU
    backend."""
    args = build_parser().parse_args(argv)
    if args.no_tpu and args.command not in _HOST_ONLY_COMMANDS:
        args.device = "cpu"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    return args.func(args)
