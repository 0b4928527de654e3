"""Reverse key-origin analysis: registry + command-line runner.

The port of ``vuke_tpu/analyze/__init__.py`` (the reference's
AnalyzerType::{all,fast,from_str} and its run_analyze): the analyzers run
in turn over the parsed key with the mask and cascade config, their sweeps
on the card (S1, S2) unless ``device`` is "cpu"; the wallet analyzer
(``multibit``/``multibit-hd``, with ``--mnemonic``/``--mnemonic-file``)
is ``multibit.py``, its PBKDF2 on the card (W1).  The JAX package's
profiler hook (``telemetry.profile_trace``) is a JAX tool and has no
counterpart.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from .analyzers import (  # noqa: F401
    AnalysisConfig, AnalysisResult, AnalysisStatus, DirectAnalyzer,
    HeuristicAnalyzer, KeyMetadata, LcgAnalyzer, MilksadAnalyzer,
    Mt64Analyzer, Sha256ChainAnalyzer, XorshiftAnalyzer,
    calculate_bit_length,
)
from .key_parser import ParseError, apply_mask, parse_cascade, parse_private_key  # noqa: F401
from .output import format_results, format_results_json  # noqa: F401
from .sweeps import CARD_SWEEP_BATCH, DEFAULT_SWEEP_BATCH


def all_analyzers() -> List:
    """Default set (AnalyzerType::all, analyze/mod.rs:199-209)."""
    return [
        MilksadAnalyzer(),
        Mt64Analyzer(),
        LcgAnalyzer(),
        XorshiftAnalyzer(),
        Sha256ChainAnalyzer(),
        DirectAnalyzer(),
        HeuristicAnalyzer(),
    ]


def fast_analyzers() -> List:
    return [DirectAnalyzer(), HeuristicAnalyzer()]


def analyzer_from_str(s: str, mnemonic=None, mnemonic_file=None, passphrase="",
                      chain_depth: int = 10):
    from ..transforms.registry import _parse_chain, _parse_lcg, _parse_xorshift
    sl = s.lower()
    if sl == "milksad":
        return MilksadAnalyzer()
    if sl == "mt64":
        return Mt64Analyzer()
    if sl in ("multibit-hd", "multibit"):
        from .multibit import MultibitAnalyzer
        return MultibitAnalyzer(mnemonic=mnemonic, mnemonic_file=mnemonic_file,
                                passphrase=passphrase)
    if sl == "direct":
        return DirectAnalyzer()
    if sl == "heuristic":
        return HeuristicAnalyzer()
    if sl == "lcg" or sl.startswith("lcg:"):
        variant, endian = _parse_lcg(sl)
        return LcgAnalyzer(variant, endian == "be")
    if sl == "xorshift" or sl.startswith("xorshift:"):
        return XorshiftAnalyzer(_parse_xorshift(sl))
    if sl == "sha256_chain" or sl.startswith("sha256_chain:"):
        variant, _depth = _parse_chain(sl)
        return Sha256ChainAnalyzer(variant, chain_depth)
    raise ValueError(
        f"Unknown analyzer: {s}. Valid: milksad, mt64, multibit-hd, direct, "
        f"heuristic, lcg[:variant][:endian], xorshift[:variant], "
        f"sha256_chain[:variant]")


def run_analyze(key_str: str, fast: bool = False, mask: Optional[int] = None,
                cascade: Optional[str] = None, analyzers: Optional[List[str]] = None,
                mnemonic=None, mnemonic_file=None, passphrase: str = "",
                chain_depth: int = 10, puzzle: Optional[str] = None,
                verify: Optional[str] = None, as_json: bool = False,
                batch: Optional[int] = None, max_seeds: Optional[int] = None,
                checkpoint: Optional[str] = None, out=None, device: str = "cuda"):
    out = out if out is not None else sys.stdout
    if batch is None:
        # the JAX rule "accelerator -> 2^24": one launch a batch, so a
        # smaller batch spends the card's time on the host's round trip
        batch = CARD_SWEEP_BATCH if torch.device(device).type == "cuda" else DEFAULT_SWEEP_BATCH
    config = AnalysisConfig(mask_bits=mask, batch=batch, max_seeds=max_seeds,
                            checkpoint_path=checkpoint, device=device)

    from .. import provider as provider_mod

    if puzzle:
        res = provider_mod.resolve(puzzle)
        if res is not None and res.context is not None:
            ctx = res.context
            if config.mask_bits is None and ctx.mask_bits and ctx.mask_bits <= 64:
                config.mask_bits = ctx.mask_bits
                print(f"Puzzle {puzzle}: auto-set mask to {ctx.mask_bits} bits",
                      file=sys.stderr)
            if ctx.cascade_targets:
                config.cascade_targets = ctx.cascade_targets
                print(f"Puzzle {puzzle}: cascade from {len(ctx.cascade_targets)} "
                      f"solved neighbors", file=sys.stderr)

    if cascade:
        # provider reference (boha:b1000:66[:n]) or literal bits:target list
        # (main.rs:1371-1378 resolve_cascade)
        targets = provider_mod.parse_cascade_ref(cascade)
        config.cascade_targets = (targets if targets is not None
                                  else parse_cascade(cascade))

    key = parse_private_key(key_str)

    if verify:
        parts = verify.split(":")
        coll = parts[1] if len(parts) > 1 else parts[0]
        report = provider_mod.verify_key(key, coll)
        for m in report.matches:
            print(f"Key matches puzzle #{m.puzzle.id} in {m.collection} via "
                  f"{m.address_type}: {m.puzzle.address}", file=out)
        if not report.matches:
            print(f"Key does not match any puzzle in {coll} "
                  f"({report.total_checked} checked)", file=out)

    if analyzers:
        selected = [analyzer_from_str(a, mnemonic, mnemonic_file, passphrase,
                                      chain_depth) for a in analyzers]
    elif fast:
        selected = fast_analyzers()
    else:
        selected = all_analyzers()

    from ..progress import Progress

    results = []
    for analyzer in selected:
        progress = None
        if analyzer.is_brute_force:
            print(f"Running {analyzer.name} (brute-force)...", file=sys.stderr)
            progress = Progress(label=analyzer.name)
        results.append(analyzer.analyze(key, config, progress=progress))
        if progress is not None:
            progress.finish()

    metadata = KeyMetadata.from_key(key)
    if as_json:
        print(format_results_json(metadata, results), file=out)
    else:
        print(format_results(metadata, results), file=out, end="")
    return results
