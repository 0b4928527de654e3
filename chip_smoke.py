"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                   # every phase
    python3 chip_smoke.py --phases 7b,10a   # phases 1, 2 and the named ones

The tags of ``--phases`` are the numbers below (3a the field self-test, 3b
K1-K6 and 3c the keygens against their plain versions, 6s the scan rates;
``PHASES`` lists them).  A selection runs the environment, the build, the
named phases and the kernels line over the kernels they held against
their plain versions and timed (3b and 6 for K1-K6), each of which must
have been launched on a main-path run of those phases.

Drives vuke_tpu_torch's scan paths on the card, the milksad seed ->
hash160 -> target match (K1 with normalize in its epilogue -> K3 -> K4 ->
K2 with the match fragments in its epilogue; the scan's superbatches
normalize K1's raw words with the normalize kernel), the sequential
direct:be scan (K5 -> K4 -> K2), both again with the byte-window scalar
multiplication (``VUKE_TPU_SMUL13=0``: K6 in place of K3), and the
transforms whose keys come from the three keygen kernels (keygen_hash,
keygen_prng, keygen_chain: one launch a superbatch for all of a
transform's slots, then per slot normalize -> K3 -> K4 -> K2), and fails
(non-zero exit, no result line) unless every phase passes:

1. environment: torch / CUDA / nvcc versions, capability (9, 0), the
   card's name, power limit and maximum SM clock;
2. build: one nvcc per csrc/*.cu, all at once (time, and each kernel's
   registers, stack and spill bytes from ``-Xptxas -v``); then the issued
   instructions per thread of K1-K6, D2 and E1 (E1: its code once, a
   role-0 and a base58check thread's) on the ALU and FMA pipes from their SASS
   (``kernels/sass.py``), weighted by their loops' trip counts
   (``LOOP_TRIPS``), printed beside the operations the function needs;
3. the field library's self-test (``csrc/fe_selftest.cu``: fe_mul, fe_sqr,
   fe_inv, fe_canon, fe_add, fe_sub) against Python integers on every pair
   of adversarial operands and 16384 random pairs; then each kernel against
   its plain PyTorch version on the card at N = 16384, lane-exact, on
   adversarial inputs, and 64 lanes against host oracles (numpy's MT19937,
   the port's bignum secp256k1 and encodings, hashlib): K1 raw and with
   normalize, K2's digests and its fragments; the normalize
   kernel on every ``scalar_edge`` word and 2^19 random ones, lane-exact
   and the edge words against Python's k mod n (0 -> 1); the three keygen
   kernels in every mode and variant on the edge seeds (decimal strings of
   1 to 20 bytes) and random ones, lane-exact, and 64 lanes of each hash
   mode against hashlib; then every mode and variant again at the scans'
   batch, 2^19 seeds above and below 2^32, lane-exact;
4. the milksad derive at batch 2^19 through the kernels against the plain
   path on the card (lane-exact) and 256 sampled lanes against the host;
   4b. the sequential derive at batch 2^19 across 2^63 against the K3 path
   on the same keys, the plain path and 256 host lanes;
   4c. the milksad derive with ``smul13=False`` (K6) against the K3 path
   and the plain K6 path on the same seeds; K6 launched, K3 not;
   4d. the lane-major ``ecc/pubkey.derive_hash160s`` under each kernel
   against the tile-layout path, and 256 lanes of x, y, parity against
   the host;
5. the milksad main path through the user's entry point (the ``scan``
   command) over 2^22 seeds with one planted target among 4096 decoys:
   exactly that hit; the path's launch counts are reset before and read
   after (the normalize kernel once a superbatch);
   5b. the direct:be path through ``scan``: 2^24 keys across 2^63 (every
   superbatch sequential), and [1, 2^21], whose first two superbatches
   take K3 and last two K5; each finds exactly its planted key, and each
   run's launch counts are reset before and read after;
   5c. both scans again with ``VUKE_TPU_SMUL13=0`` set around the command:
   milksad over 2^22 seeds and direct:be over [1, 2^21], with K6 launched
   in place of K3 (also for the offset table) and K3 never;
   5d. planted scans of the keygen kernels' transforms: sha256 over 2^22
   seeds (a key in the string slot, then one in the LE slot), lcg (its
   four variants), mt64 (seeds above 2^32) and sha256_chain over 2^19 seeds
   (a key at depth 7 of the 4-byte half); each keygen kernel once a
   superbatch, normalize, K3, K4 and K2 once a slot a superbatch;
   5e. direct:be with ``VUKE_TPU_SEQUENTIAL=0`` over two superbatches that
   would be sequential: K5 never, the keygen and K3 once each;
   every scan prints exactly its hit on stdout, with the reference's
   ``Source:`` and ``Transform:`` lines, and ``Loaded N target
   addresses``, ``Scanning...`` and ``Done. Inputs: N, Keys: K, Matches:
   1`` on stderr;
6. the derive rates (seed_to_hash160_derivations_per_sec through K3 and
   through K6, sequential_scan_derivations_per_sec), each derive's profile
   (device launches a batch, torch glue, device busy, the host's issue
   time), and each kernel's time (CUDA events, and its device time from
   ``torch.profiler``; the normalize kernel with its input and output out
   of L2) against its plain version's and its bound at the path's shapes:
   the larger of its bytes over the HBM rate and the operations its
   function needs (``kernels/work.py``) over the issue pipes' rate; the
   keygen kernels in the modes the scans run (sha256, the four LCGs,
   every sha256_chain variant); then the scan rate through the pipelined
   driver (``benchmark.bench_scan``) of milksad, direct:be and sha256
   against 4096 and 2^20 fragments;
7. the string and generate paths, with D1 (``csrc/digest.cu``, the string
   digests) and D2 (``csrc/p2pkh.cu``, generate's P2PKH encoding):
   7a. D1 in every mode on 2^16 strings of 0 to 300 bytes (the padding
   edges and UTF-8 text included) and its chain mode at depth 10, against
   its plain version and hashlib on every lane; then at its edges
   (``digest_edges``: a warp of 1 to 6 blocks a string, empty strings,
   55 to 120 bytes, a 10 KB string, blocks past its shared tile, every
   byte alignment and words off 16 bytes, M = 1, 255, 257, 1869); its time
   on 2^19 strings of 1 to 64 bytes with bound and share, and hashlib's on
   the host;
   7b. D2 on 2^19 random and edge hash160s (all zeros, all 0xff, 8 zero
   bytes first) and at the tail sizes 1, 255, 257 and 1869 for the
   versions 0x00 and 0x6F against its plain version on every row and
   ``encode.p2pkh_address`` on 4096; ``generate`` sha256 over 4096 seeds
   (D2 on the main path) against the host;
   7c. ``generate --transform sha256 --transform md5`` over 70,000 seeds
   without ``--batch``: the line count, the JAX package's order (65536-seed
   chunks, then transform, seed, slot), 4096 sampled lines against the
   host ``KeyDeriver``; then the lines/s of 2^20 sha256 seeds
   (``benchmark.bench_generate``);
   7d. a wordlist scan of 2^20 seeded words with sha256, double_sha256,
   md5 and direct against 4096 decoys and four planted words: exactly
   those hits; the words/s (``benchmark.bench_strings``); then
   sha256_chain over 2^14 words with ``VUKE_HOST_DIGEST_MAX=0``, so that
   D1 runs on the path, with one planted key;
   7e. ``timestamps --microseconds`` over one day (86,486,400 seeds) with
   a hit planted in the millisecond lattice; stdin and files scans in
   subprocesses;
   7f. the JAX command's ``bench`` through the command line: sha256 (its
   three lines) and electrum (``--json``: 1000 decimal strings a call, W2
   behind it), one second each after the warm-up;
8. ``analyze`` on the card, with S1 (``csrc/sweep_prng.cu``, the PRNG
   families' keystream and compare fused) and S2 (``csrc/sweep_chain.cu``,
   the sha256 chains'):
   8a. S1 in every family, variant and mode (exact, mask of 64 and 12 bits,
   cascades of 5 and 2 targets with the first-filter count, and of 40, past
   MT19937's init block) and S2 in every variant and mode at depth 10 (and a
   cascade of 40), against their plain versions on 2^24 and 2^22 lanes
   with hits planted in the middle lane and the last, across the carry into
   the high word (mt64, xorshift) and the u32 wrap (chains): the records
   must be equal; S1's LCG grid at its edges in every variant and byte
   order (``lcg_edges_against_plain``: the least hit in a later thread's
   earlier lane, first and last lanes, one lane, the u32 wrap, the count
   tracked, all 2^32 seeds against the planted one); then each kernel's
   time at the sweeps' batches (S1 2^24: milksad exact, mt64 and xorshift
   cascades, every LCG variant and byte order exact; S2 2^22) beside its
   plain version's, its bound and share, and the LCG instantiations'
   registers;
   8b. ``analyze`` through the command line over the full spaces, keys from
   the host oracles: milksad exact (seed 2^32 - 17, then a random key:
   NOT_FOUND over 2^32), ``--mask 40``, lcg planted in borland near its
   max_seed, sha256_chain:iterated at depth 10 planted at chain index 7,
   mt64 and xorshift (xorshift128+) with a ``--cascade`` from a planted
   seed's keys and ``--max-seeds 2^32``, the default ``analyze KEY`` (every
   analyzer), ``--puzzle boha:b1000:40:3``, ``--cascade boha:b1000:67``,
   ``--verify boha:b1000``, and ``--checkpoint`` over the first half, then
   resumed to the planted seed; each with its seeds/s and launches; then a
   milksad ``--cascade`` of 40 targets from a planted seed's keys;
   8c. ``scan --transform direct:be --targets boha:b1000:solved`` over
   [2^20, 2^32 - 1]: exactly puzzles 21..32, and the provider's stderr;
9. the wallet paths, with W1 (``csrc/pbkdf2_sha512.cu``, PBKDF2-HMAC-SHA512)
   and W2 (``csrc/electrum_stretch.cu``, Electrum's key stretch):
   9a. W1 against its plain version at 2 and 7 iterations on 4096
   candidates (keys of 0 to 330 bytes, salts to 107 bytes), at 2048 on 2^16
   against hashlib on 263 lanes and the BIP39 Trezor vector; its time,
   bound and share;
   9b. W2 against its plain version at 1, 2 and 17 rounds at every seed
   length edge, at 99,999 rounds on 64 seeds against hashlib and the
   official Electrum seed's master public key (K3 -> K4); its time on 2^16
   10-byte and 2^14 32-byte seeds;
   9c. ``scan --transform electrum`` over 2^16 timestamps with a key planted
   at derivation index 7: W2 once a 1000-seed batch, the seeds/s;
   9d. ``analyze --analyzer multibit-hd --mnemonic-file`` over 4096
   mnemonics, the MultiBit bug vector planted: CONFIRMED, W1 twice; then
   ``bench_wallet("multibit")`` on 1024 beside the hashlib host path;
   9e. planted armory (range), multibit (wordlist) and bitimage (files)
   scans, and ``generate --transform electrum`` against the host
   ``KeyDeriver``;
10. the storage tail, with E1 (``csrc/records.cu``, a record's string
   columns: decimal, WIFs, P2PKH, P2WPKH, statistics):
   10a. E1 against ``records_plain`` on the card at 2^19 lanes and at the
   tail sizes 1, 255, 257 and 1869 on bitcoin, testnet, signet and
   regtest, lane-exact, the edge keys (1, 2, 9, 10^9 - 1, 10^9, 2^32,
   2^255, n - 1, 2^256 - 1 - n, 1..31 leading zero bytes) and
   digests with leading zero bytes among them, the edge keys also against
   ``KeyDeriver``; 256 lanes a network of ``pipeline.derive_records``
   against ``KeyDeriver.derive``; E1's time, bound and share; ``generate
   -v`` over 4096 seeds against the host (E1 once, D2 never);
   10b (only where pyarrow is installed, decided before it starts):
   ``generate --storage`` over 2^20 sha256 seeds, then sha256 and milksad
   with ``--chunk-records 300000``: one record a line, the chunks and
   their sizes as the ``Storage:`` lines name them, 256 sampled records
   equal to the host ``KeyDeriver``'s (every column but ``timestamp``);
   ``scan --storage`` with a planted key: one record, ``matched_target``
   set; ``query`` on a 65,536-record run; E1's launches on every run; then
   ``benchmark.bench_storage``'s records/s and a superbatch's split;
11. runs across processes (``parallel/multihost.py``): ranks of one gloo
   world on a free local port, each a subprocess given the JAX_* variables
   (``chip_smoke.py --rank REPORT ARGV...``: the command line with its
   launch counts and sweep results written to REPORT), all on the one card
   after phase 2's build, each with a time limit:
   11a. ``analyze --analyzer milksad`` (exact) over 2^32 seeds in two ranks,
   the key of a seed planted near the end of rank 1's shard, then of one
   in rank 0's first round: both ranks print the seed and each searched
   what the protocol says (``protocol_searched``; rank 1 one round in the
   second); the two ranks' seeds/s beside one process's on the same key;
   11b. ``scan --transform milksad`` over 2^24 seeds at batch 2^19 in two
   ranks, a target planted in each shard among phase 5's decoys: each rank
   its ``Host i/2`` line and its hit, the two ranks' stdout the one-process
   run's;
   11c. ``python -m vuke_tpu_torch.parallel.dryrun 4`` (S1 and K1 -> K2 in
   four ranks) and ``bench_derive`` over every visible card (``devices``);
   every rank's launch counts join the kernels line.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Every comparison is exact (tolerance 0):
the kernels compute integers.  The script imports nothing of jax and
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from vuke_tpu_torch import cli, encode, kernels, pipeline
from vuke_tpu_torch._device import require_cuda
from vuke_tpu_torch.benchmark import (bench_derive, bench_sequential, device_ms,
                                      kernel_cases, profile_derive, profile_sequential,
                                      time_cuda)
from vuke_tpu_torch.benchmark import bench_generate, bench_scan, bench_strings
from vuke_tpu_torch.analyze.key_parser import apply_mask
from vuke_tpu_torch.analyze.sweeps import CARD_SWEEP_BATCH
from vuke_tpu_torch.cores import (digest, hash160, keygen, lcg, mt19937, p2pkh, records,
                                  sha256_chain, sweep)
from vuke_tpu_torch.derive import KeyDeriver
from vuke_tpu_torch.ecc import field as F
from vuke_tpu_torch.ecc import incremental as inc
from vuke_tpu_torch.ecc import inv, pubkey, ref, scalar, smul, smul_w8, tiled
from vuke_tpu_torch.kernels import sass, work
from vuke_tpu_torch.wallets import electrum, multibit, pbkdf2_device

N_KERNEL = 16384
BATCH = 1 << 19
SCAN_SEEDS = 1 << 22
SEQ_SCAN_KEYS = 1 << 24
KERNELS = {"mt19937": mt19937.KERNEL, "normalize": scalar.KERNEL, "smul": smul.KERNEL,
           "smul_w8": smul_w8.KERNEL, "seq_madd": inc.KERNEL, "inv_affine": inv.KERNEL,
           "hash160": hash160.KERNEL}
KEYGEN = {"keygen_hash": keygen.HASH_KERNEL, "keygen_prng": keygen.PRNG_KERNEL,
          "keygen_chain": keygen.CHAIN_KERNEL}
STRING_KERNELS = {"digest": digest.KERNEL, "p2pkh": p2pkh.KERNEL}
SWEEP_KERNELS = {"sweep_prng": sweep.PRNG_KERNEL, "sweep_chain": sweep.CHAIN_KERNEL}
WALLET_KERNELS = {"pbkdf2_sha512": pbkdf2_device.KERNEL, "electrum_stretch": electrum.KERNEL}
RECORD_KERNELS = {"records": records.KERNEL}
ALL_KERNELS = (KERNELS | KEYGEN | STRING_KERNELS | SWEEP_KERNELS | WALLET_KERNELS
               | RECORD_KERNELS)
N_STRINGS = 1 << 16
GEN_SEEDS = 70_000
WORDS = 1 << 20
CHAIN_WORDS = 1 << 14
DAY = "2015-06-01"
SPACE = 1 << 32
# phase 9: W1 against its plain version on W1_LANES candidates, at 2048
# iterations on W1_FULL; W2 at every length edge on W2_LANES; the electrum
# scan's timestamps; the multibit dictionary (the BIP32 tail is Python EC)
W1_LANES = 4096
W1_FULL = 1 << 16
W2_LANES = 4096
W2_LENGTHS = (1, 10, 23, 24, 32, 87, 88, 150)
ELECTRUM_SEEDS = 1 << 16
MNEMONICS = 4096
CASCADE = 40
# phase 10: E1 on the generate path's batch; generate --storage over
# STORAGE_SEEDS seeds; query on a run of QUERY_RECORDS records
STORAGE_SEEDS = 1 << 20
QUERY_RECORDS = 1 << 16
ELECTRUM_SEED = "acb740e454c3134901d7c8f16497cc1c"
ELECTRUM_MPK = ("e9d4b7866dd1e91c862aebf62a49548c7dbf7bcc6e4b7b8c9da820c7737968df"
                "9c09d5a3e271dc814a29981f81b3faaf2737b551ef5dcc6189cf0f8252c442b3")
MNEMONIC_445 = ("skin join dog sponsor camera puppy ritual diagram arrow poverty boy "
                "elbow")
TREZOR = ("legal winner thank year wave sausage worth useful legal winner thank yellow",
          "2e8905819b8723fe2c1d161860e5ee1830318dbf49a83bd451cfb8440c28bd6f"
          "a457fe1296106559a3c80937a1c1069be3a3a5bd381ee6260e8d9739fce1f607")
# the lanes of a sweep batch on the main path (analyze/analyzers.py): S1 takes the
# card's batch, S2 a quarter of it
S1_LANES = CARD_SWEEP_BATCH
S2_LANES = CARD_SWEEP_BATCH // 4
MILKSAD_PATH = ("mt19937", "smul", "inv_affine", "hash160")
SLOT_PATH = ("normalize", "smul", "inv_affine", "hash160")
KEYGEN_MODE = {"keygen_hash": "sha256", "keygen_prng": "lcg, four variants",
               "keygen_chain": "sha256_chain, four variants, depth 10"}

# Least time for each kernel's work at N lanes: the larger of its bytes
# over the HBM rate and the operations its function needs per lane
# (kernels/work.py: multiply results on the FMA pipe, logic, shifts and
# selects on the ALU pipe, adds on either) over the SMs' issue rate, 64 a
# clock on each pipe.  Bytes per lane: each input read once and each output
# written once.
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
INT_OPS_PER_SM_CLOCK = 64            # 32-bit integer operations per SM per clock, each pipe
BYTES_PER_LANE = {
    "mt19937": 36,       # 4 B seed in, 32 B key out
    "normalize": 64,     # 32 B in, 32 B out
    "smul": 160,         # 32 B scalar in, 4 x 32 B out (+ the 0.85 MB table once)
    "smul_w8": 160,      # 32 B scalar in, 4 x 32 B out (+ the 512 KiB table once)
    "seq_madd": 192,     # 2 x 32 B offset in, 4 x 32 B out
    "inv_affine": 192,   # 4 x 32 B in, 2 x 32 B out
    "hash160": 120,      # 2 x 32 B in, 2 x 20 B digests and 16 B of fragments out
    # the keygens in the scans' modes: the seed words they read, 32 B a slot out
    "keygen_hash": 8 + 3 * 32,      # sha256: hi and lo in, 3 slots
    "keygen_prng": 4 + 4 * 32,      # lcg: lo alone in, 4 variants
    "keygen_chain": 8 + 80 * 32,    # sha256_chain: hi and lo in, 4 variants x depth 10, twice
}
# The diagnostic beside the bound: each kernel's SASS (phase 2), every
# instruction weighted by the trip counts of the loops around it, listed
# here per region (the kernel's own body, then each called body) in the
# order of the loops' back branches.  inv_affine's thread works for
# inv.CHUNK lanes.
LANES_PER_THREAD = {"inv_affine": inv.CHUNK}
LOOP_TRIPS = {
    # the init_genrand steps 9..396, unrolled by 4
    "mt19937_kernel": [[97]],
    "normalize_kernel": [[]],
    "hash160_kernel": [[]],
    # 25 digits recoded; windows 1..25 added
    "smul_kernel": [[25, 25]],
    # 32 byte windows, the first only seeds: 31 additions (the digit shifts
    # of window 0 go uncounted, so the bound stays below)
    "smul_w8_kernel": [[31]],
    "seq_madd_kernel": [[]],
    # 16 lanes forward and back; then fe_inv (a call), its squaring runs of
    # 2 or more
    "inv_affine_kernel": [[16, 16], [3, 3, 2, 11, 22, 44, 88, 44, 3, 23, 5, 3, 2]],
    # every loop unrolled; D2's count is a lane's, E1's the function's code
    # once: a role-0 thread's and one base58check thread's (the checksum
    # once, the WIF's and the address's digits)
    "p2pkh_kernel": [[]],
    "records_kernel": [[]],
}
TABLE_BYTES = {"smul": smul.WINDOWS * smul.TSIZE * 64,
               "smul_w8": smul_w8.WINDOWS * smul_w8.TSIZE * 64}


def say(msg: str) -> None:
    print(msg, flush=True)


def as_i64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64)


def exact_err(name: str, got, want) -> int:
    """Max |got - want| over paired tensors; raise unless it is 0."""
    err = max(int((as_i64(g) - as_i64(w)).abs().max()) for g, w in zip(got, want))
    mism = sum(int((as_i64(g) != as_i64(w)).any(dim=0).sum()) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"{name}: {mism} lanes differ, max abs err {err}")
    return err


# ---------------------------------------------------------------------------
# host oracles: the port's bignum curve and encodings (host code, never on
# the card), hashlib and numpy's MT19937
# ---------------------------------------------------------------------------

P, N, GX = ref.P, ref.N, ref.GX
point_mul = ref.point_mul
p2pkh_address = encode.p2pkh_address
host_hash160 = encode.hash160


def ripemd160_source() -> str:
    try:
        hashlib.new("ripemd160", b"")
        return "hashlib"
    except ValueError:
        return "the written-out RIPEMD-160 of vuke_tpu_torch.encode (hashlib has none here)"


def host_milksad_key(seed: int) -> bytes:
    """numpy's MT19937 (init_genrand seeding): 32 key bytes of a seed."""
    return np.random.RandomState(seed).bytes(32)


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def host_hash_keys(mode: str, seed: int) -> list:
    """The 32-byte keys of keygen_hash's ``mode`` for a u64 seed, slot by
    slot, from hashlib and Python's integers."""
    text, be, le = str(seed).encode(), seed.to_bytes(8, "big"), seed.to_bytes(8, "little")
    if mode == "direct":
        return [seed.to_bytes(32, "big"), le + bytes(24), text.ljust(32, b"\0")]
    if mode == "md5":
        d = hashlib.md5(text).digest()
        return [d + d]
    keys = [sha256(text), sha256(be), sha256(le)]
    return [sha256(k) for k in keys] if mode == "double_sha256" else keys


def host_lcg_key(seed: int, v, big_endian: bool = True) -> bytes:
    """8 outputs of the LCG variant ``v`` from a u32 seed, 4 bytes each."""
    out = b""
    for _ in range(8):
        seed = (v.a * seed + v.c) % v.m
        out += seed.to_bytes(4, "big" if big_endian else "little")
    return out


def host_mt64_key(seed: int, n_keys: int = 1) -> bytes:
    """MT19937-64 (init_genrand64, then the generator's in-place twist of
    its 312 words, again every 312 outputs): its first 4 x ``n_keys``
    tempered outputs, serialized little-endian (``n_keys`` keys of 32
    bytes)."""
    m64 = (1 << 64) - 1
    mt = [seed & m64]
    for i in range(1, 312):
        mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i) & m64)
    out = b""
    for i in range(4 * n_keys):
        if i % 312 == 0:
            for k in range(312):
                y = (mt[k] & 0xFFFFFFFF80000000) | (mt[(k + 1) % 312] & 0x7FFFFFFF)
                mt[k] = mt[(k + 156) % 312] ^ (y >> 1) ^ (0xB5026F5AA96619E9 if y & 1 else 0)
        x = mt[i % 312]
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        out += x.to_bytes(8, "little")
    return out


def host_xorshift128p_keys(seed: int, n_keys: int) -> list:
    """The first ``n_keys`` keys of the reference's "xorshift128+" (a
    xoroshiro128 state from two splitmix64 steps, outputs s0 + s1 written
    big-endian; a zero seed becomes 1)."""
    m64 = (1 << 64) - 1

    def splitmix(x):
        x = (x + 0x9E3779B97F4A7C15) & m64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m64
        return x ^ (x >> 31)

    def rotl(x, k):
        return ((x << k) | (x >> (64 - k))) & m64

    s0 = splitmix(seed or 1)
    s1 = splitmix(s0)
    out = b""
    for _ in range(4 * n_keys):
        out += ((s0 + s1) & m64).to_bytes(8, "big")
        s1 ^= s0
        s0 = rotl(s0, 24) ^ s1 ^ ((s1 << 16) & m64)
        s1 = rotl(s1, 37)
    return [out[32 * j:32 * j + 32] for j in range(n_keys)]


def host_chain_key(message: bytes, variant: str, d: int) -> bytes:
    """Key ``d`` of the sha256_chain ``variant`` over the seed's bytes."""
    if variant == "iterated":
        key = sha256(message)
        for _ in range(d):
            key = sha256(key)
        return key
    return sha256(message + sha256_chain.suffix(variant, d))


def host_h160s(k: int):
    x, y = point_mul(k)
    comp = bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    uncomp = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return host_hash160(comp), host_hash160(uncomp)


def words_be(vals) -> torch.Tensor:
    """Python ints (< 2^256) -> (8, N) uint32 BE words on the CPU."""
    arr = np.array([[(v >> (32 * (7 - i))) & 0xFFFFFFFF for v in vals] for i in range(8)],
                   dtype=np.uint32)
    return torch.from_numpy(arr)


def lane_int_be(words: torch.Tensor, j: int) -> int:
    return int.from_bytes(b"".join(int(v).to_bytes(4, "big") for v in as_i64(words[:, j])), "big")


def lane_int_le(limbs: torch.Tensor, j: int) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(as_i64(limbs[:, j]).tolist()))


def digest_le(words5: torch.Tensor, j: int) -> bytes:
    return b"".join(int(v).to_bytes(4, "little") for v in as_i64(words5[:, j]).tolist())


# ---------------------------------------------------------------------------
# operands of the field self-test (phase 3, tests/test_torch_cuda.py,
# tests/test_torch_inv.py, tests/test_torch_field_ptx.py)
# ---------------------------------------------------------------------------

# The edges of p and of the weak range, single full limbs; every pair of
# them includes products whose top limb is full (the first fold's carry
# c >= 2^32) and sums that fold twice.
FIELD_EDGE = ((0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 256) - 1, (1 << 256) - (1 << 32) - 978,
               1 << 255, (1 << 256) - (1 << 32), (1 << 32) + 977)
              + tuple(0xFFFFFFFF << (32 * i) for i in range(8)))


def scalar_edge() -> list[int]:
    """Scalars below 2^256 at the edges of the reduction mod n: 0, 1, n-1,
    n, n+1, 2^256-1 and others; n's top seven words with each edge low
    word; and n with any one word set to 0, its value -1 or +1, or 2^32-1
    (each word's compare decides there)."""
    words = [(N >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)]
    out = [0, 1, 2, N - 2, N - 1, N, N + 1, N + 2, 1 << 255, P - 1, P, (1 << 256) - N,
           (1 << 256) - 2, (1 << 256) - 1]
    top = N >> 32 << 32
    out += [top | low for low in (0, 1, words[7] - 1, words[7], words[7] + 1, 0xFFFFFFFF)]
    for i in range(8):
        for v in {0, words[i] - 1, min(words[i] + 1, 0xFFFFFFFF), 0xFFFFFFFF}:
            w = list(words)
            w[i] = v
            out.append(sum(x << (32 * (7 - j)) for j, x in enumerate(w)))
    return sorted(set(out))


def field_operands(n_random: int, seed: int) -> tuple[list[int], list[int]]:
    """(a, b) Python ints: every pair of ``FIELD_EDGE`` values, then
    ``n_random`` random pairs below 2^256."""
    rng = np.random.default_rng(seed)
    a = [x for x in FIELD_EDGE for _ in FIELD_EDGE]
    b = [y for _ in FIELD_EDGE for y in FIELD_EDGE]
    a += [int.from_bytes(rng.bytes(32), "little") for _ in range(n_random)]
    b += [int.from_bytes(rng.bytes(32), "little") for _ in range(n_random)]
    return a, b


def limbs_le(vals) -> torch.Tensor:
    """Python ints below 2^256 -> (8, N) uint32 LE limbs on the CPU."""
    return torch.from_numpy(np.array([[(v >> (32 * j)) & 0xFFFFFFFF for v in vals]
                                      for j in range(8)], dtype=np.uint32))


def field_mismatches(a: list[int], b: list[int], outs: dict) -> list[str]:
    """The lanes where ``field.selftest``'s results are not what Python
    integers give: each below 2^256 and congruent mod p to a*b, a^2,
    a^(p-2), a+b, a-b, and ``canon`` exactly a mod p."""
    bad = []
    got = {}
    for op, limbs in outs.items():
        arr = as_i64(limbs.cpu()).numpy().astype(object)
        got[op] = list(sum(arr[j] << (32 * j) for j in range(8)))
    for j, (x, y) in enumerate(zip(a, b)):
        want = {"mul": x * y % P, "sqr": x * x % P, "inv": pow(x, P - 2, P),
                "add": (x + y) % P, "sub": (x - y) % P}
        for op, w in want.items():
            if got[op][j] % P != w:
                bad.append(f"{op} lane {j}: a={x:#x} b={y:#x} got {got[op][j]:#x}")
        if got["canon"][j] != x % P:
            bad.append(f"canon lane {j}: a={x:#x} got {got['canon'][j]:#x}")
    return bad


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: no card, no result")
    dev = require_cuda()
    nvcc = kernels.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int_ops_per_s = sms * INT_OPS_PER_SM_CLOCK * clock_mhz * 1e6
    say(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc_ver}' "
        f"capability {torch.cuda.get_device_capability(dev)} devices {torch.cuda.device_count()}; "
        f"{sms} SMs, max SM clock {clock_mhz:.0f} MHz: bounds assume "
        f"{int_ops_per_s:.4g} 32-bit integer ops/s and {HBM_BYTES_PER_S:.3g} B/s")
    return dev, smi, int_ops_per_s


def phase_build(card: str) -> dict:
    """Build the library; return each kernel's ``sass.Pipes`` per thread."""
    lib = kernels.library()
    parts = []
    for name, regs, stack, spill in kernels.ptxas_usage(lib.log):
        parts.append(f"{kernels.entry_name(name)}: {regs} regs, stack {stack} B, "
                     f"spills {spill} B")
    summary = ", ".join(parts)
    say(f"[2 build] nvcc (one per source, in parallel) built {lib.path.name} in {lib.build_seconds:.1f} s [{card}]; {summary}")
    counted = KERNELS | RECORD_KERNELS | {"p2pkh": p2pkh.KERNEL}
    counts = sass.kernel_pipes(sass.dump(lib.path),
                               {k.entry: LOOP_TRIPS[k.entry] for k in counted.values()})
    pipes = {name: counts[k.entry] for name, k in counted.items()}
    say("[2 sass] per thread, weighted by loop trips (LOOP_TRIPS): " + "; ".join(
        f"{name}: ALU {p.alu:.0f}, FMA {p.fma:.0f} (2-cycle units), issued {p.issued:.0f}"
        for name, p in pipes.items()))
    return pipes


def phase_field(dev, rng):
    """The field library's primitives on the card (``vk_fe_selftest``)
    against Python integers: every pair of ``FIELD_EDGE`` operands and
    N_KERNEL random pairs."""
    a, b = field_operands(N_KERNEL, int(rng.integers(1 << 31)))
    before = F.SELFTEST_KERNEL.launches
    outs = F.selftest(limbs_le(a).to(dev), limbs_le(b).to(dev))
    torch.cuda.synchronize()
    if F.SELFTEST_KERNEL.launches != before + 1:
        raise AssertionError("the field self-test did not launch its kernel")
    bad = field_mismatches(a, b, outs)
    if bad:
        raise AssertionError(f"field self-test: {len(bad)} results differ: {bad[:8]}")
    say(f"[3 field] fe_selftest on {len(a)} lanes ({len(FIELD_EDGE)}^2 adversarial pairs: "
        f"0, 1, 2, p-2, p-1, p, p+1, 2^256-1, 2^256-2^32-978, 2^255, 2^32-1 in each limb, ...; "
        f"{N_KERNEL} random): fe_mul, fe_sqr, fe_inv, fe_add, fe_sub == Python ints mod p, "
        f"below 2^256; fe_canon == a mod p exactly")


def phase_kernels(dev, rng) -> dict:
    errs = {}
    # K1: adversarial seeds then random ones
    seeds_np = rng.integers(0, 1 << 32, N_KERNEL, dtype=np.uint32)
    seeds_np[:4] = [0, 1, 5489, 0xFFFFFFFF]
    seeds = torch.from_numpy(seeds_np).to(dev)
    kw = mt19937.milksad_key_words(seeds)
    errs["mt19937"] = exact_err("K1", [kw], [mt19937.milksad_key_words_plain(seeds)])
    kwn = mt19937.milksad_key_words(seeds, normalize=True)
    errs["mt19937"] = max(errs["mt19937"], exact_err(
        "K1 normalize", [kwn], [mt19937.milksad_key_words_plain(seeds, normalize=True)]))
    exact_err("K1 normalize vs K1 + normalize_words_plain", [kwn],
              [scalar.normalize_words_plain(kw)])
    kw_cpu = kw.cpu()
    oracle = list(range(4)) + rng.choice(np.arange(4, N_KERNEL), 60, replace=False).tolist()
    for j in oracle:
        if lane_int_be(kw_cpu, j).to_bytes(32, "big") != host_milksad_key(int(seeds_np[j])):
            raise AssertionError(f"K1 lane {j} (seed {seeds_np[j]}) differs from numpy's MT19937")
    say(f"[3 K1 mt19937] N={N_KERNEL} kernel == plain lane-exact (max abs err 0), raw and "
        f"with normalize (== the raw words through normalize_words_plain); 64 lanes == "
        f"numpy MT19937 (seeds 0, 1, 5489, 2^32-1 included)")
    errs["normalize"] = phase_normalize(dev, rng)

    # K3: adversarial scalars (before normalization), then random ones
    n, p = N, P
    adv = [1, 2, 3, 4, 6, n - 1, n - 2, n - 3, (1 << 255) + 12345, 0xDEADBEEF,
           1 << 128, 1 << 250, 0x3FF, 0x400, 0x401, GX, p, p - 1,
           n, n + 1, n + 2, (1 << 256) - 1, (1 << 256) - 2, 0, (1 << 256) - (1 << 230)]
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(N_KERNEL - len(adv))]
    raw = words_be(adv + rand).to(dev)
    norm = tiled.normalize_words(raw)
    outs = smul.scalar_mul(norm)
    table = smul.table_on(str(dev))
    plain = smul.scalar_mul_plain(norm, table)
    canon = [F.canonical(F.from_u32_le(a)) for a in outs]
    canon_p = [F.canonical(F.from_u32_le(a)) for a in plain]
    errs["smul"] = exact_err("K3 (mod p)", canon, canon_p)
    oracle = list(range(len(adv))) + rng.choice(
        np.arange(len(adv), N_KERNEL), 64 - len(adv), replace=False).tolist()
    X, Y, ZZ, ZZZ = (a.cpu() for a in outs)
    norm_cpu = norm.cpu()
    for j in oracle:
        k = lane_int_be(norm_cpu, j)
        ex, ey = point_mul(k)
        gx = lane_int_le(X, j) * pow(lane_int_le(ZZ, j), -1, p) % p
        gy = lane_int_le(Y, j) * pow(lane_int_le(ZZZ, j), -1, p) % p
        if (gx, gy) != (ex, ey):
            raise AssertionError(f"K3 lane {j} (k={k:#x}) differs from point_mul")
    say(f"[3 K3 smul] N={N_KERNEL} kernel == plain mod p, lane-exact after canonical "
        f"reduction (max abs err 0); 64 lanes == point_mul (1, 2, 3, n-1, n-2, even, "
        f"(1<<255)+12345, 0xDEADBEEF, words >= n included)")

    # K4: the K3 outputs, chains of 16 lanes spread over 1024 threads; the
    # last 8 lanes hold (X, Y, ZZ, ZZZ) representatives in [p, 2^256), which
    # K3 may hand over, checked against X / ZZ and Y / ZZZ mod p
    top = (1 << 256) - 1
    weak = [(p, p + 1, p + 1, p + 2), (top, p + 5, top, top - 1), (p - 1, 0, p + 3, 1),
            (1, top, 2, p + 1), (top - 1, p, (1 << 32) + 977, top), (p + 7, p + 9, p + 11, p + 13),
            (0, 1, p + 1, p + 1), (5, 7, 1, 1)]
    k4_in = [as_i64(a).cpu() for a in outs]
    for i, lane in enumerate(range(N_KERNEL - len(weak), N_KERNEL)):
        for c in range(4):
            k4_in[c][:, lane] = torch.tensor([(weak[i][c] >> (32 * j)) & 0xFFFFFFFF
                                              for j in range(8)], dtype=torch.int64)
    k4_in = [a.to(torch.uint32).to(dev) for a in k4_in]
    x, y = inv.affine(*k4_in)
    xp, yp = inv.affine_plain(*k4_in)
    errs["inv_affine"] = exact_err("K4", [x, y], [xp, yp])
    x_cpu, y_cpu = x.cpu(), y.cpu()
    for j in oracle:
        if j >= N_KERNEL - len(weak):
            continue
        if (lane_int_be(x_cpu, j), lane_int_be(y_cpu, j)) != point_mul(lane_int_be(norm_cpu, j)):
            raise AssertionError(f"K4 lane {j} differs from point_mul")
    for i, (wx, wy, wzz, wzzz) in enumerate(weak):
        j = N_KERNEL - len(weak) + i
        want = (wx * pow(wzz, -1, p) % p, wy * pow(wzzz, -1, p) % p)
        if (lane_int_be(x_cpu, j), lane_int_be(y_cpu, j)) != want:
            raise AssertionError(f"K4 lane {j} (unreduced inputs) differs from the host")
    say(f"[3 K4 inv_affine] N={N_KERNEL} ({N_KERNEL // inv.CHUNK} chains of {inv.CHUNK}) "
        f"kernel == plain bit-exact (max abs err 0); K3-output lanes == point_mul; "
        f"8 lanes of unreduced inputs in [p, 2^256) == X/ZZ, Y/ZZZ mod p")

    errs["smul_w8"] = phase_k6(dev, rng)
    errs["seq_madd"] = phase_k5(dev, rng)

    # K2: random x, y
    xw = torch.from_numpy(rng.integers(0, 1 << 32, (8, N_KERNEL), dtype=np.uint32)).to(dev)
    yw = torch.from_numpy(rng.integers(0, 1 << 32, (8, N_KERNEL), dtype=np.uint32)).to(dev)
    hc, hu, fc, fu = hash160.hash160s_and_fragments(xw, yw)
    pc, pu, pfc, pfu = hash160.hash160s_and_fragments_plain(xw, yw)
    errs["hash160"] = exact_err("K2", [hc, hu, *fc, *fu], [pc, pu, *pfc, *pfu])
    xw_c, yw_c, hc_c, hu_c = xw.cpu(), yw.cpu(), hc.cpu(), hu.cpu()
    frags = [as_i64(f).cpu() for f in (*fc, *fu)]
    for j in rng.choice(N_KERNEL, 64, replace=False).tolist():
        xb = lane_int_be(xw_c, j).to_bytes(32, "big")
        yb = lane_int_be(yw_c, j).to_bytes(32, "big")
        dc = host_hash160(bytes([2 + (yb[-1] & 1)]) + xb)
        du = host_hash160(b"\x04" + xb + yb)
        if digest_le(hc_c, j) != dc or digest_le(hu_c, j) != du:
            raise AssertionError(f"K2 lane {j} differs from the host hash160")
        got = b"".join(int(f[j]).to_bytes(4, "big") for f in frags)
        if got != dc[:8] + du[:8]:
            raise AssertionError(f"K2 lane {j}: fragments differ from the host digests' 8 bytes")
    say(f"[3 K2 hash160] N={N_KERNEL} kernel == plain lane-exact (max abs err 0) for the "
        f"digests and the 4 fragment words; 64 lanes == host "
        f"SHA-256 + {ripemd160_source()}, fragments == each digest's first 8 bytes")
    return errs


def phase_normalize(dev, rng) -> int:
    """The normalize kernel on every ``scalar_edge`` word and random words
    up to 2^19 lanes, lane-exact against its plain version; the edge words
    against Python's k mod n (0 -> 1)."""
    edge = scalar_edge()
    raw = rng.integers(0, 1 << 32, (8, BATCH), dtype=np.uint32)
    raw[:, :len(edge)] = words_be(edge).numpy()
    w = torch.from_numpy(raw).to(dev)
    before = scalar.KERNEL.launches
    got = scalar.normalize_words(w)
    torch.cuda.synchronize()
    if scalar.KERNEL.launches != before + 1:
        raise AssertionError("normalize_words did not launch its kernel once")
    err = exact_err("normalize", [got], [scalar.normalize_words_plain(w)])
    got_cpu = got[:, :len(edge)].cpu()
    for j, k in enumerate(edge):
        if lane_int_be(got_cpu, j) != (k % N or 1):
            raise AssertionError(f"normalize lane {j} (k={k:#x}) differs from k mod n")
    say(f"[3 normalize] N={BATCH}: kernel == plain lane-exact (max abs err 0); {len(edge)} "
        f"edge words (0, 1, n-1, n, n+1, 2^256-1, n's top words with each low word, n with "
        f"one word changed) == k mod n, 0 -> 1")
    return err


def phase_k6(dev, rng) -> int:
    """K6 against its plain version at N_KERNEL, lane-exact after canonical
    reduction mod p, on byte-window edge cases before normalization (zero
    windows below the only digit, n - 1 with top byte 0xFF, the largest
    k < n whose low 31 bytes are 0xFF, k with only the top byte set) and
    random scalars; 64 lanes against point_mul."""
    n, p = N, P
    adv = [0, 1, 2, 255, 256, 257, 1 << 32, 1 << 128, 1 << 248, 1 << 255, n - 1, n - 2,
           n, n + 1, (1 << 256) - 1, (0xFF << 248) - 1, 0xFF << 248]
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(N_KERNEL - len(adv))]
    norm = tiled.normalize_words(words_be(adv + rand).to(dev))
    outs = smul_w8.scalar_mul(norm)
    plain = smul_w8.scalar_mul_plain(norm, smul_w8.table_on(str(dev)))
    err = exact_err("K6 (mod p)", [F.canonical(F.from_u32_le(a)) for a in outs],
                    [F.canonical(F.from_u32_le(a)) for a in plain])
    oracle = list(range(len(adv))) + rng.choice(
        np.arange(len(adv), N_KERNEL), 64 - len(adv), replace=False).tolist()
    X, Y, ZZ, ZZZ = (a.cpu() for a in outs)
    norm_cpu = norm.cpu()
    for j in oracle:
        k = lane_int_be(norm_cpu, j)
        gx = lane_int_le(X, j) * pow(lane_int_le(ZZ, j), -1, p) % p
        gy = lane_int_le(Y, j) * pow(lane_int_le(ZZZ, j), -1, p) % p
        if (gx, gy) != point_mul(k):
            raise AssertionError(f"K6 lane {j} (k={k:#x}) differs from point_mul")
    say(f"[3 K6 smul_w8] N={N_KERNEL} kernel == plain mod p, lane-exact after canonical "
        f"reduction (max abs err 0); 64 lanes == point_mul (0, 1, 2, 255, 256, 257, 2^32, "
        f"2^128, 2^248, 2^255, n-1, n-2, n, n+1, 2^256-1, 0xFEFF..FF, 0xFF<<248 included)")
    return err


def phase_k5(dev, rng) -> int:
    """K5 against its plain version at N_KERNEL, lane-exact after canonical
    reduction mod p, for three base points k * G and an off-curve base with
    bx = p - 1.  Offsets (i + 1) * G from K3 + K4; the first lanes hold
    adversarial coordinates instead (0, p - 1, p, 2^256 - 1; ox < bx and
    oy < by borrow on most lanes).  64 curve lanes per real base against
    the host: X3 / ZZ, Y3 / ZZZ == point_mul(k + i + 1)."""
    offx, offy = (as_i64(a).cpu() for a in inc.build_offset_table(N_KERNEL, dev))
    top = (1 << 256) - 1
    adv = [(0, 0), (P - 1, 1), (top, P), (1, top), (P, P - 1), (5, 7)]
    for j, (x, y) in enumerate(adv):
        offx[:, j] = torch.tensor([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
        offy[:, j] = torch.tensor([(y >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
    offx, offy = offx.to(torch.uint32).to(dev), offy.to(torch.uint32).to(dev)
    ks = [(1 << 64) - 2, (1 << 32) + 1, 1026]
    bases = [point_mul(k) for k in ks] + [(P - 1, P - 2)]
    for i, (bx, by) in enumerate(bases):
        outs = inc.seq_madd(offx, offy, bx, by)
        plain = inc.seq_madd_plain(offx, offy, bx, by)
        exact_err(f"K5 base {i} (mod p)", [F.canonical(F.from_u32_le(a)) for a in outs],
                  [F.canonical(F.from_u32_le(a)) for a in plain])
        if i == len(ks):
            continue
        X, Y, ZZ, ZZZ = (a.cpu() for a in outs)
        lanes = [j for j in rng.choice(np.arange(len(adv), N_KERNEL), 65, replace=False).tolist()
                 if j + 1 != ks[i]][:64]
        for j in lanes:
            gx = lane_int_le(X, j) * pow(lane_int_le(ZZ, j), -1, P) % P
            gy = lane_int_le(Y, j) * pow(lane_int_le(ZZZ, j), -1, P) % P
            if (gx, gy) != point_mul(ks[i] + j + 1):
                raise AssertionError(f"K5 lane {j} (base {ks[i]}) differs from point_mul")
    say(f"[3 K5 seq_madd] N={N_KERNEL} kernel == plain mod p, lane-exact after canonical "
        f"reduction (max abs err 0), bases k*G for k = 2^64-2, 2^32+1, 1026 and an off-curve "
        f"bx = p-1; offsets (i+1)*G with 0, p-1, p, 2^256-1 lanes; 64 lanes per real base "
        f"== point_mul(k+i+1)")
    return 0


def seq_words(start: int, n: int) -> torch.Tensor:
    """(8, n) uint32 BE key words of the keys start .. start + n - 1 (< 2^64)."""
    vals = np.uint64(start) + np.arange(n, dtype=np.uint64)
    words = np.zeros((8, n), dtype=np.uint32)
    words[7] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words[6] = (vals >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(words)


def phase_seq_derive(dev, rng):
    """The sequential derive at batch 2^19 from 2^63 - 2^18 (crossing 2^63
    and a carry out of the low 32 bits) through K5 -> K4 -> K2 against the
    K3 path on the same keys, the plain sequential path and the host."""
    start = (1 << 63) - BATCH // 2
    before = inc.KERNEL.launches
    offx, offy = inc.offset_table(BATCH, dev)
    bx, by = point_mul(start - 1)
    d = inc.sequential_core(bx, by, offx, offy)
    d_k3 = tiled.derive_tiled_from_words(seq_words(start, BATCH).to(dev))
    d_p = inc.sequential_core(bx, by, offx, offy, plain=True)
    keys = ("h160c", "h160u", "frag_c", "frag_u")

    def flat(dd):
        return [dd["h160c"], dd["h160u"], *dd["frag_c"], *dd["frag_u"]]

    exact_err("sequential vs K3 path", flat(d), flat(d_k3))
    exact_err("sequential vs plain", flat(d), flat(d_p))
    if inc.KERNEL.launches <= before:
        raise AssertionError("the sequential derive did not launch seq_madd")
    hc, hu = d["h160c"].T.cpu(), d["h160u"].T.cpu()
    lanes = [0, 1, BATCH // 2 - 1, BATCH // 2, BATCH - 1] + rng.choice(
        np.arange(2, BATCH - 1), 251, replace=False).tolist()
    for j in lanes:
        if (digest_le(hc, j), digest_le(hu, j)) != host_h160s(start + j):
            raise AssertionError(f"sequential lane {j} (key {start + j}) differs from the host")
    say(f"[4b sequential derive] batch {BATCH} keys [2^63 - {BATCH // 2}, 2^63 + {BATCH // 2}): "
        f"K5 path == K3 "
        f"path == plain path lane-exact for {', '.join(keys)}; 256 sampled lanes (both "
        f"sides of 2^63 included) == host point_mul + hashlib")


def phase_derive(dev, rng):
    before = {k: v.launches for k, v in KERNELS.items()}
    seeds_np = rng.integers(0, 1 << 32, BATCH, dtype=np.uint32)
    seeds_np[:4] = [0, 1, 5489, 0xFFFFFFFF]
    seeds = torch.from_numpy(seeds_np).to(dev)
    t0 = time.perf_counter()
    d = tiled.derive_hash160s_tiled(seeds)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = tiled.derive_hash160s_tiled(seeds, plain=True)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    exact_err("derive", [d["h160c"], d["h160u"], *d["frag_c"], *d["frag_u"]],
              [dp["h160c"], dp["h160u"], *dp["frag_c"], *dp["frag_u"]])
    for name in MILKSAD_PATH:
        if KERNELS[name].launches <= before[name]:
            raise AssertionError(f"derive did not launch {name}")
    hc, hu = d["h160c"].T.cpu(), d["h160u"].T.cpu()
    lanes = [0, 1, 2, 3] + rng.choice(np.arange(4, BATCH), 252, replace=False).tolist()
    for j in lanes:
        k = int.from_bytes(host_milksad_key(int(seeds_np[j])), "big") % N or 1
        if (digest_le(hc, j), digest_le(hu, j)) != host_h160s(k):
            raise AssertionError(f"derive lane {j} (seed {seeds_np[j]}) differs from the host")
    say(f"[4 derive] batch {BATCH}: kernels == plain path lane-exact for h160c, h160u, "
        f"frag_c, frag_u; 256 sampled lanes == host (numpy MT19937 + host point_mul + hashlib); "
        f"K1, K3, K4, K2 launched (host wall clock: kernels {t_k:.3f} s incl. first use, "
        f"plain {t_p:.3f} s)")


def launch_counts() -> dict:
    return {name: kern.launches for name, kern in ALL_KERNELS.items()}


def phase_derive_k6(dev, rng):
    """The milksad derive at batch 2^19 with ``smul13=False``: K6 in place
    of K3, lane-exact against the K3 path and the plain K6 path."""
    seeds_np = rng.integers(0, 1 << 32, BATCH, dtype=np.uint32)
    seeds_np[:4] = [0, 1, 5489, 0xFFFFFFFF]
    seeds = torch.from_numpy(seeds_np).to(dev)
    before = launch_counts()
    d = tiled.derive_hash160s_tiled(seeds, smul13=False)
    torch.cuda.synchronize()
    after = launch_counts()
    if after["smul_w8"] != before["smul_w8"] + 1 or after["smul"] != before["smul"]:
        raise AssertionError(f"smul13=False derive: launches {before} -> {after}")
    d3 = tiled.derive_hash160s_tiled(seeds, smul13=True)
    t0 = time.perf_counter()
    dp = tiled.derive_hash160s_tiled(seeds, smul13=False, plain=True)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0

    def flat(dd):
        return [dd["h160c"], dd["h160u"], *dd["frag_c"], *dd["frag_u"]]

    exact_err("K6 derive vs K3 derive", flat(d), flat(d3))
    exact_err("K6 derive vs plain K6 path", flat(d), flat(dp))
    say(f"[4c K6 derive] batch {BATCH}, smul13=False: K6 launched once, K3 not; == K3 path "
        f"and == plain K6 path lane-exact for h160c, h160u, frag_c, frag_u (plain path "
        f"{t_p:.3f} s host wall clock)")


def phase_pubkey(dev, rng):
    """``pubkey.derive_hash160s`` (lane-major words) at 2^19 under each
    kernel against the tile-layout path; x, y and parity on 256 lanes
    against the host."""
    raw = rng.integers(0, 1 << 32, (8, BATCH), dtype=np.uint32)
    raw[:, :4] = words_be([0, 1, N - 1, (1 << 256) - 1]).numpy()
    norm = tiled.normalize_words(torch.from_numpy(raw).to(dev))
    lanes = norm.T.contiguous()
    tile = tiled.derive_tiled_from_words(norm, smul13=True)
    outs = {}
    for smul13, name in ((True, "smul"), (False, "smul_w8")):
        before = launch_counts()
        outs[name] = pubkey.derive_hash160s(lanes, smul13=smul13)
        other = "smul_w8" if smul13 else "smul"
        after = launch_counts()
        if after[name] != before[name] + 1 or after[other] != before[other]:
            raise AssertionError(f"pubkey smul13={smul13}: launches {before} -> {after}")
        exact_err(f"pubkey ({name}) vs tile path", [outs[name]["h160c"], outs[name]["h160u"]],
                  [tile["h160c"], tile["h160u"]])
    keys = ("x_words", "y_words", "y_odd")
    exact_err("pubkey K6 vs K3", [outs["smul_w8"][k] for k in keys],
              [outs["smul"][k] for k in keys])
    d = {k: outs["smul_w8"][k].cpu() for k in keys}
    norm_cpu = norm.cpu()
    for j in [0, 1, 2, 3] + rng.choice(np.arange(4, BATCH), 252, replace=False).tolist():
        x, y = point_mul(lane_int_be(norm_cpu, j))
        if (lane_int_be(d["x_words"].T, j), lane_int_be(d["y_words"].T, j),
                bool(d["y_odd"][j])) != (x, y, bool(y & 1)):
            raise AssertionError(f"pubkey lane {j} differs from the host")
    say(f"[4d pubkey] derive_hash160s of {BATCH} lane-major words under K3 and under K6: "
        f"h160c, h160u == tile-layout path lane-exact; x_words, y_words, y_odd equal across "
        f"kernels; 256 lanes (k = 1, 1, n-1, 2^256-1-n first) == host point_mul")


@contextlib.contextmanager
def env_set(name: str, value: str):
    """``name=value`` in the environment for the block; the variable alone
    is restored."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old



def run_scan(transform: str, start: int, end: int, source: str, target: str, decoys: list,
             keys: int, display: str, key_hex: str | None = None):
    """One ``scan`` through the command line against the decoys plus
    ``target``, with every launch count set to 0 just before and read just
    after.  Its stdout must be exactly one hit block, for ``source``,
    ``display`` and ``target`` (and the private key ``key_hex`` where
    given), and its stderr the reference's three lines.  Returns the launch
    counts and the host's seconds."""
    path = kernels.BUILD_DIR / "smoke_targets.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(decoys[:2048] + [target] + decoys[2048:]) + "\n")
    for kern in ALL_KERNELS.values():
        kern.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["scan", "--transform", transform, "--targets", str(path),
                       "--batch", str(BATCH), "range", "--start", str(start),
                       "--end", str(end)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    text, log = out.getvalue(), err.getvalue()
    done = f"Done. Inputs: {end - start + 1}, Keys: {keys}, Matches: 1"
    loaded = f"Loaded {len(set(decoys + [target]))} target addresses"
    if (rc != 0 or log.splitlines() != [loaded, "Scanning...", done]
            or text.count("========== HIT") != 1
            or not text.startswith("\n========== HIT ==========\n")
            or not text.endswith("\n=========================\n")):
        raise AssertionError(f"scan {transform}: expected exactly one hit block on stdout and "
                             f"{done!r} on stderr, got rc {rc}\n{text}\n{log}")
    if (f"Source: {source}\nTransform: {display}\n" not in text
            or f"Matched: {target} (p2pkh_compressed)" not in text
            or (key_hex is not None and f"Private Key: {key_hex}\n" not in text)):
        raise AssertionError(f"scan {transform}: the hit is not {source} / {target}:\n{text}")
    return launches, secs


def check_launches(what: str, launches: dict, want: dict):
    """``want``: exact counts, or None for 'at least once'."""
    for name, n in want.items():
        got = launches[name]
        if (n is None and got == 0) or (n is not None and got != n):
            raise AssertionError(f"{what}: {name} launched {got} times, expected "
                                 f"{'at least once' if n is None else n}: {launches}")


def phase_scan(dev, rng, decoys) -> dict:
    start = 3_000_000_000
    end = start + SCAN_SEEDS - 1
    planted = int(rng.integers(start, end + 1))
    k = int.from_bytes(host_milksad_key(planted), "big") % N or 1
    target = p2pkh_address(host_h160s(k)[0])
    launches, secs = run_scan("milksad", start, end, str(planted), target, decoys,
                              SCAN_SEEDS, "milksad")
    check_launches("milksad scan", launches,
                   {name: None for name in MILKSAD_PATH}
                   | {"normalize": SCAN_SEEDS // BATCH, "seq_madd": 0, "smul_w8": 0})
    say(f"[5 scan] milksad range [{start}, {end}] ({SCAN_SEEDS} seeds, batch {BATCH}) vs "
        f"4096 decoys + 1 planted: exactly 1 hit, seed {planted} -> {target}; "
        f"{secs:.2f} s host wall clock; main-path launches {launches}")
    return launches


def phase_seq_scan(dev, rng, decoys) -> list:
    """direct:be through ``scan``: 2^24 keys from 2^63 - 2^23, every
    superbatch sequential (the offset table was cached by phase 4b, so K3
    runs 0 times), then [1, 4 * BATCH] = [1, 2^21]: the superbatches from 1
    and BATCH + 1 start below BATCH + 2 and take K3, the last two take K5."""
    runs = []
    start = (1 << 63) - SEQ_SCAN_KEYS // 2
    end = start + SEQ_SCAN_KEYS - 1
    planted = start + int(rng.integers(0, SEQ_SCAN_KEYS))
    target = p2pkh_address(host_h160s(planted)[0])
    batches = SEQ_SCAN_KEYS // BATCH
    launches, secs = run_scan("direct:be", start, end, str(planted), target, decoys,
                              SEQ_SCAN_KEYS, "direct")
    check_launches("direct:be scan across 2^63", launches,
                   {"seq_madd": batches, "inv_affine": batches, "hash160": batches,
                    "smul": 0, "smul_w8": 0, "mt19937": 0, "normalize": 0})
    runs.append(launches)
    say(f"[5b direct:be scan] range [2^63 - {SEQ_SCAN_KEYS // 2}, 2^63 + {SEQ_SCAN_KEYS // 2}) "
        f"({SEQ_SCAN_KEYS} keys, batch "
        f"{BATCH}) vs 4096 decoys + 1 planted: exactly 1 hit, key {planted} -> {target}, "
        f"'Transform: direct'; {secs:.2f} s host wall clock; launches {launches}")

    end = 4 * BATCH
    target = p2pkh_address(host_h160s(700)[0])
    launches, secs = run_scan("direct:be", 1, end, "700", target, decoys, end, "direct")
    check_launches("direct:be scan of [1, 2^21]", launches,
                   {"smul": 2, "smul_w8": 0, "seq_madd": 2, "inv_affine": 4, "hash160": 4,
                    "mt19937": 0, "normalize": 2, "keygen_hash": 2})
    runs.append(launches)
    say(f"[5b direct:be scan] range [1, {end}] vs 4096 decoys + key 700: exactly 1 hit; "
        f"superbatches from 1 and {BATCH + 1} took K3, from {2 * BATCH + 1} and "
        f"{3 * BATCH + 1} took K5; "
        f"{secs:.2f} s host wall clock; launches {launches}")
    return runs


def phase_scan_k6(dev, rng, decoys) -> list:
    """Both scans through ``scan`` with ``VUKE_TPU_SMUL13=0`` around the
    command.  milksad over 2^22 seeds: K6 once per superbatch, K3 never.
    direct:be over [1, 2^21]: K6 for the two unsafe superbatches and once
    more for the offset table, which no earlier phase built with K6 (its
    cache key holds the kernel); K5 for the last two."""
    runs = []
    start = 1_000_000_000
    end = start + SCAN_SEEDS - 1
    planted = int(rng.integers(start, end + 1))
    k = int.from_bytes(host_milksad_key(planted), "big") % N or 1
    target = p2pkh_address(host_h160s(k)[0])
    batches = SCAN_SEEDS // BATCH
    with env_set("VUKE_TPU_SMUL13", "0"):
        launches, secs = run_scan("milksad", start, end, str(planted), target, decoys,
                                  SCAN_SEEDS, "milksad")
    check_launches("milksad scan, VUKE_TPU_SMUL13=0", launches,
                   {"smul_w8": batches, "smul": 0, "mt19937": batches, "inv_affine": batches,
                    "hash160": batches, "seq_madd": 0, "normalize": batches})
    runs.append(launches)
    say(f"[5c scan, VUKE_TPU_SMUL13=0] milksad range [{start}, {end}] ({SCAN_SEEDS} seeds, "
        f"batch {BATCH}) vs 4096 decoys + 1 planted: exactly 1 hit, seed {planted} -> "
        f"{target}; {secs:.2f} s host wall clock; launches {launches}")

    end = 4 * BATCH
    target = p2pkh_address(host_h160s(700)[0])
    with env_set("VUKE_TPU_SMUL13", "0"):
        launches, secs = run_scan("direct:be", 1, end, "700", target, decoys, end, "direct")
    check_launches("direct:be scan of [1, 2^21], VUKE_TPU_SMUL13=0", launches,
                   {"smul_w8": 3, "smul": 0, "seq_madd": 2, "inv_affine": 5, "hash160": 4,
                    "mt19937": 0, "normalize": 2, "keygen_hash": 2})
    runs.append(launches)
    say(f"[5c direct:be scan, VUKE_TPU_SMUL13=0] range [1, {end}] vs 4096 decoys + key 700: "
        f"exactly 1 hit; superbatches from 1 and {BATCH + 1} took K6, the offset table was "
        f"built with K6, from {2 * BATCH + 1} and {3 * BATCH + 1} took K5; {secs:.2f} s "
        f"host wall clock; launches {launches}")
    return runs


def keygen_seeds(rng, n: int) -> list:
    """u64 seeds: the edges (0, 9, 10, 2^31 - 2 .. 2^31, 2^32 - 1, 2^32,
    10^19, 2^64 - 1, each power of ten and the number below it: decimal
    strings of 1 to 20 bytes), then random ones below 2^64 and below 2^32
    in turn."""
    edge = sorted({0, 9, 10, (1 << 31) - 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
                   10 ** 19, (1 << 64) - 1} | {10 ** k for k in range(20)}
                  | {10 ** k - 1 for k in range(2, 20)})
    rand = [int(v) for v in rng.integers(0, 1 << 64, n - len(edge), dtype=np.uint64)]
    return edge + [v if i % 2 else v & 0xFFFFFFFF for i, v in enumerate(rand)]


def seed_words(seeds: list, dev):
    """u64 seeds -> their (hi, lo) (N,) uint32 words on ``dev``."""
    arr = np.array(seeds, dtype=np.uint64)
    return (torch.from_numpy((arr >> np.uint64(32)).astype(np.uint32)).to(dev),
            torch.from_numpy((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to(dev))


def keygen_modes():
    """(kernel name, label, keygen arguments after (hi, lo)) of every mode
    and variant of the three keygen kernels."""
    out = [("keygen_hash", mode, (mode,)) for mode in keygen.HASH_MODES]
    out += [("keygen_prng", f"lcg {v} {'be' if be else 'le'}", ("lcg", v, be))
            for v in range(-1, 4) for be in (True, False)]
    out += [("keygen_prng", f"xorshift {v}", ("xorshift", v)) for v in range(-1, 4)]
    out += [("keygen_prng", "mt64", ("mt64",))]
    out += [("keygen_chain", f"sha256_chain {v}", (v,)) for v in range(-1, 4)]
    return out


def keygen_against_plain(hi, lo, errs: dict, keep: dict | None = None):
    """Every mode and variant of the three keygen kernels on the seeds (hi,
    lo) against their plain versions, lane-exact, each call one launch;
    the max abs error of each kernel goes into ``errs``, each mode's keys
    into ``keep`` (on the host) when it is given."""
    fns = {"keygen_hash": (keygen.keygen_hash, keygen.keygen_hash_plain),
           "keygen_prng": (keygen.keygen_prng, keygen.keygen_prng_plain),
           "keygen_chain": (keygen.keygen_chain, keygen.keygen_chain_plain)}
    for name, label, args in keygen_modes():
        kern, plain = fns[name]
        before = KEYGEN[name].launches
        keys = kern(hi, lo, *args)
        torch.cuda.synchronize()
        if KEYGEN[name].launches != before + 1:
            raise AssertionError(f"{name} {label}: {KEYGEN[name].launches - before} launches")
        errs[name] = max(errs[name], exact_err(f"{name} {label} N={hi.numel()}", [keys],
                                               [plain(hi, lo, *args)]))
        if keep is not None:
            keep[label] = keys.cpu()
        del keys


def phase_keygen(dev, rng) -> dict:
    """The three keygen kernels against their plain versions on the card,
    in every mode and variant, lane-exact (``keygen_against_plain``): at
    N_KERNEL seeds (``keygen_seeds``), whose 64 lanes (the edges first) are
    then held against the host (the hash modes against hashlib, the LCGs
    and MT19937-64 against Python's integers, the chains against hashlib);
    then at the scans' BATCH, on fresh ``keygen_seeds``."""
    seeds = keygen_seeds(rng, N_KERNEL)
    hi, lo = seed_words(seeds, dev)
    errs, got = {name: 0 for name in KEYGEN}, {}
    keygen_against_plain(hi, lo, errs, got)
    lanes = list(range(40)) + rng.choice(np.arange(40, N_KERNEL), 24, replace=False).tolist()

    def key(label, slot, j):
        return lane_int_be(got[label][slot], j).to_bytes(32, "big")

    for j in lanes:
        seed = seeds[j]
        for mode in keygen.HASH_MODES:
            for slot, want in enumerate(host_hash_keys(mode, seed)):
                if key(mode, slot, j) != want:
                    raise AssertionError(f"keygen_hash {mode} slot {slot} seed {seed} "
                                         f"differs from hashlib")
        for v, variant in enumerate(lcg.ALL_VARIANTS):
            for be in (True, False):
                if key(f"lcg -1 {'be' if be else 'le'}", v, j) != host_lcg_key(
                        seed & 0xFFFFFFFF, variant, be):
                    raise AssertionError(f"keygen_prng lcg {variant.name} seed {seed} differs")
        if key("mt64", 0, j) != host_mt64_key(seed):
            raise AssertionError(f"keygen_prng mt64 seed {seed} differs from the host")
        messages = (str(seed).encode(), (seed & 0xFFFFFFFF).to_bytes(4, "big"))
        for half, message in enumerate(messages):
            for k, variant in enumerate(sha256_chain.VARIANTS):
                for d in range(sha256_chain.DEFAULT_CHAIN_DEPTH):
                    slot = (half * 4 + k) * sha256_chain.DEFAULT_CHAIN_DEPTH + d
                    if key("sha256_chain -1", slot, j) != host_chain_key(message, variant, d):
                        raise AssertionError(f"keygen_chain {variant} {d} seed {seed} differs")
    say(f"[3 keygen] N={N_KERNEL} (0, 9, 10, 2^31-2..2^31, 2^32-1, 2^32, 10^k and 10^k-1, "
        f"10^19, 2^64-1, random): keygen_hash (direct, sha256, double_sha256, md5), "
        f"keygen_prng (lcg each variant and all, be and le; xorshift each and all; mt64), "
        f"keygen_chain (each variant and all) == plain lane-exact (max abs err 0), one "
        f"launch a call; 64 lanes == hashlib (hash modes, chains) and Python integers "
        f"(LCGs, MT19937-64)")
    del got
    big = keygen_seeds(rng, BATCH)
    above = sum(v >> 32 != 0 for v in big)
    hi, lo = seed_words(big, dev)
    t0 = time.perf_counter()
    keygen_against_plain(hi, lo, errs)
    say(f"[3 keygen] N={BATCH}, the scans' batch ({above} seeds above 2^32, "
        f"{BATCH - above} below): every mode and variant of the three keygen kernels == "
        f"plain lane-exact (max abs err 0), one launch a call; "
        f"{time.perf_counter() - t0:.1f} s")
    return errs


def phase_keygen_scans(dev, rng, decoys) -> list:
    """Planted scans of the keygen kernels' transforms through ``scan``: each
    finds exactly its hit, under the reference's ``Source:`` label, and each
    superbatch launches its keygen kernel once and normalize, K3, K4 and K2
    once a slot."""
    runs = []

    def scan(transform, kern, start, seeds, slots, label, key, note):
        k = int.from_bytes(key, "big") % N or 1
        target = p2pkh_address(host_h160s(k)[0])
        batches = seeds // BATCH
        launches, secs = run_scan(transform, start, start + seeds - 1, label, target, decoys,
                                  seeds * slots, transform, key_hex=f"{k:064x}")
        want = {name: batches * slots for name in SLOT_PATH}
        want |= {kern: batches, "mt19937": 0, "seq_madd": 0, "smul_w8": 0}
        want |= {other: 0 for other in KEYGEN if other != kern}
        check_launches(f"{transform} scan", launches, want)
        runs.append(launches)
        say(f"[5d {transform} scan] range [{start}, {start + seeds - 1}] ({seeds} seeds, "
            f"{slots} slots, batch {BATCH}) vs 4096 decoys + 1 planted: exactly 1 hit, "
            f"'Source: {label}', 'Transform: {transform}' ({note}); {secs:.2f} s host wall "
            f"clock; launches {launches}")

    start = 7_000_000_000
    planted = start + int(rng.integers(0, SCAN_SEEDS))
    scan("sha256", "keygen_hash", start, SCAN_SEEDS, 3, str(planted),
         host_hash_keys("sha256", planted)[0], "the string slot: SHA-256 of the decimal string")
    planted = start + int(rng.integers(0, SCAN_SEEDS))
    scan("sha256", "keygen_hash", start, SCAN_SEEDS, 3, str(planted),
         host_hash_keys("sha256", planted)[2], "the LE slot: SHA-256 of the 8 LE bytes")
    start = 1_500_000_000
    planted = start + int(rng.integers(0, 4 * BATCH))
    scan("lcg", "keygen_prng", start, 4 * BATCH, 4, f"{planted}:msvc",
         host_lcg_key(planted, lcg.VARIANTS_BY_NAME["msvc"]), "the msvc slot of four")
    start = 5 << 40
    planted = start + int(rng.integers(0, 4 * BATCH))
    scan("mt64", "keygen_prng", start, 4 * BATCH, 1, str(planted), host_mt64_key(planted),
         "seeds above 2^32")
    start = 3_000_000_000
    planted = start + int(rng.integers(0, BATCH))
    scan("sha256_chain", "keygen_chain", start, BATCH, 80, f"{planted}[indexed:le:7]",
         host_chain_key(planted.to_bytes(4, "big"), "indexed:le", 7),
         "depth 7 of the 4-byte half")
    return runs


def phase_sequential_off(dev, rng, decoys) -> dict:
    """direct:be with ``VUKE_TPU_SEQUENTIAL=0`` around the command, over two
    superbatches from 2^48 that would take K5: the keygen and K3 path in
    both, K5 never."""
    start = 1 << 48
    planted = start + int(rng.integers(0, 2 * BATCH))
    target = p2pkh_address(host_h160s(planted)[0])
    with env_set("VUKE_TPU_SEQUENTIAL", "0"):
        launches, secs = run_scan("direct:be", start, start + 2 * BATCH - 1, str(planted),
                                  target, decoys, 2 * BATCH, "direct")
    check_launches("direct:be scan, VUKE_TPU_SEQUENTIAL=0", launches,
                   {"seq_madd": 0, "keygen_hash": 2, "normalize": 2, "smul": 2,
                    "inv_affine": 2, "hash160": 2})
    say(f"[5e direct:be scan, VUKE_TPU_SEQUENTIAL=0] range [2^48, 2^48 + {2 * BATCH}) vs "
        f"4096 decoys + key {planted}: exactly 1 hit; both superbatches took keygen_hash + "
        f"K3, K5 never; {secs:.2f} s host wall clock; launches {launches}")
    return launches


def work_per_lane(name: str, k6_additions: float) -> work.Ops:
    """The operations ``name``'s function needs per lane; K6's depend on its
    scalars: ``k6_additions`` mixed additions per lane."""
    return {"mt19937": work.mt19937(), "normalize": work.NORMALIZE, "smul": work.smul(),
            "smul_w8": work.smul_w8(k6_additions), "seq_madd": work.seq_madd(),
            "inv_affine": work.inv_affine(inv.CHUNK), "hash160": work.hash160()}[name]


def k6_additions(words: torch.Tensor) -> float:
    """Mixed additions per lane that K6 runs on the (8, N) scalar words,
    averaged: the non-zero bytes after the first (zero digits are skipped)."""
    w = as_i64(words)
    nonzero = sum((((w >> s) & 0xFF) != 0).sum(dim=0) for s in (0, 8, 16, 24))
    return float((nonzero - 1).clamp(min=0).double().mean())


def bound(name: str, n: int, int_ops_per_s: float, ops: work.Ops):
    """(bound_ms, bound_by, limit) of ``name``'s work at ``n`` lanes, ``ops``
    its operations per lane: ``bound_by`` is "bytes" or "operations",
    ``limit`` the term that sets it ("bytes", or the pipe: "FMA", "ALU" or
    "both")."""
    t_bytes = (BYTES_PER_LANE[name] * n + TABLE_BYTES.get(name, 0)) / HBM_BYTES_PER_S
    t_ops = ops.cycles() * n / int_ops_per_s
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", "bytes"
    return t_ops * 1e3, "operations", ops.pipe()


def phase_profiles(card: str):
    """Each derive's rate, then its profile: device launches and torch glue
    a batch, device busy, the host's issue time and the idle share.  A
    milksad batch may launch 8 kernels (its four, the bench's 3 of seed
    arithmetic and one spare), a sequential one 4 (its three and a spare)."""
    runs = (("6", "K3 derive", 8, lambda: bench_derive(batch=BATCH),
             lambda: profile_derive(batch=BATCH)),
            ("6c", "K6 derive", 8, lambda: bench_derive(batch=BATCH, smul13=False),
             lambda: profile_derive(batch=BATCH, smul13=False)),
            ("6b", "sequential", 4, lambda: bench_sequential(batch=BATCH),
             lambda: profile_sequential(batch=BATCH)))
    for tag, what, most, bench, prof in runs:
        r = bench()
        extra = (f"; offset table built in {r['offset_table_seconds']:.3f} s before the clock"
                 if "offset_table_seconds" in r else f" through {r['smul']}")
        say(f"[{tag} rate] {r['metric']}{extra} = {r['derivations_per_sec']:.0f} at batch "
            f"{BATCH} ({r['ms_per_batch']:.4f} ms/batch, best of windows {r['window_ms']}) "
            f"[{card}]")
        p = prof()
        kern = ", ".join(f"{k} {v:.4f}" for k, v in p["kernels_ms_per_batch"].items())
        say(f"[{tag} profile] {what}: {p['launches_per_batch']:g} device launches a batch, "
            f"{p['glue_launches_per_batch']:g} of them torch glue ({p['glue_ms_per_batch']:.4f} "
            f"ms); device busy {p['device_busy_ms_per_batch']:.4f} ms; host issue "
            f"{p['host_issue_ms_per_batch']:.4f} ms a batch, drain {p['device_drain_ms']:.4f} ms; "
            f"wall under the profiler {p['wall_ms_per_batch']:.4f} ms, idle share "
            f"{p['device_idle_share']:.3f}; host waits {p['host_waits_per_batch']:g}; "
            f"device ms: {kern} [{card}]")
        if p["launches_per_batch"] > most:
            raise AssertionError(f"{what}: {p['launches_per_batch']} device launches a batch, "
                                 f"more than {most}: torch glue is back between the kernels")


def phase_rate(dev, rng, card: str, int_ops_per_s: float, pipes: dict) -> dict:
    """Each kernel at the main path's shapes: CUDA events around 20 launches,
    the device time of 20 under ``torch.profiler`` (without the host's share
    that events around a short launch take in), the plain version and the
    bound; beside the bound, the operations the function needs per lane
    and what the kernel's SASS issues (phase 2)."""
    phase_profiles(card)
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, BATCH, dtype=np.uint32)).to(dev)
    cases = kernel_cases(dev, seeds)
    adds = k6_additions(mt19937.milksad_key_words(seeds, normalize=True))
    times = {}
    for name in KERNELS:
        kern, plain = cases[name]
        ms = time_cuda(kern, iters=20, warmup=3)
        dev_ms = device_ms(kern, [KERNELS[name]], iters=20)
        plain_ms = time_cuda(plain, iters=2, warmup=1)
        ops = work_per_lane(name, adds)
        bound_ms, bound_by, limit = bound(name, BATCH, int_ops_per_s, ops)
        times[name] = (ms, plain_ms, bound_ms, bound_by)
        note = ""
        if name == "mt19937":
            fn = cases["mt19937 raw"][0]
            note = (f"; raw words: {time_cuda(fn, iters=20, warmup=3):.4f} ms events, "
                    f"{device_ms(fn, [KERNELS[name]], iters=20):.4f} ms device")
        if name == "smul_w8":
            note = f"; {adds:.4f} additions a lane on these scalars"
        lanes = LANES_PER_THREAD.get(name, 1)
        p = pipes[name]
        say(f"[6 time] {name} at N={BATCH}: kernel {ms:.4f} ms (CUDA events), {dev_ms:.4f} ms "
            f"device (profiler), plain {plain_ms:.2f} ms ({plain_ms / ms:.1f}x), bound "
            f"{bound_ms:.4f} ms by {limit} ({100 * bound_ms / dev_ms:.1f}% of the device "
            f"time); needs a lane {ops.mul:.0f} multiplies, {ops.alu:.0f} ALU, {ops.add:.0f} "
            f"adds; SASS issues a lane {p.alu / lanes:.0f} ALU, {p.fma / lanes:.0f} FMA "
            f"2-cycle units, {p.issued / lanes:.0f} in all{note} [{card}]")
    digits = float(np.mean([len(str(v)) for v in seeds.cpu().tolist()]))
    for name in KEYGEN:
        kern, plain = cases[name]
        ms = time_cuda(kern, iters=20, warmup=3)
        dev_ms = device_ms(kern, [KEYGEN[name]], iters=20)
        plain_ms = time_cuda(plain, iters=2, warmup=1)
        ops = keygen_work(name, digits)
        bound_ms, bound_by, limit = bound(name, BATCH, int_ops_per_s, ops)
        times[name] = (ms, plain_ms, bound_ms, bound_by)
        say(f"[6 time] {name} ({KEYGEN_MODE[name]}) at N={BATCH}: kernel {ms:.4f} ms (CUDA "
            f"events), {dev_ms:.4f} ms device (profiler), plain {plain_ms:.2f} ms "
            f"({plain_ms / ms:.1f}x), bound {bound_ms:.4f} ms by {limit} "
            f"({100 * bound_ms / dev_ms:.1f}% of the device time); needs a lane "
            f"{ops.mul:.0f} multiplies, {ops.alu:.0f} ALU, {ops.add:.0f} adds (seeds of "
            f"{digits:.3f} digits on average) [{card}]")
    return times


def keygen_work(name: str, digits: float) -> work.Ops:
    """The operations a lane of ``name`` needs in ``KEYGEN_MODE``'s mode, for
    seeds of ``digits`` decimal digits on average."""
    return {"keygen_hash": work.keygen_hash("sha256", digits),
            "keygen_prng": work.keygen_prng("lcg"),
            "keygen_chain": work.keygen_chain(digits)}[name]


def phase_scan_rates(card: str):
    """Keys/s of whole scans through the pipelined driver (``bench_scan``),
    with where a superbatch's time goes."""
    for transform, pool in (("milksad", 4096), ("direct:be", 4096), ("sha256", 4096),
                            ("sha256", 1 << 20)):
        r = bench_scan(transform, pool_size=pool, batch=BATCH)
        kern = ", ".join(f"{k} {v:.4f}" for k, v in r["kernels_ms_per_superbatch"].items())
        say(f"[6 scan rate] {transform} vs {pool} fragments: {r['keys_per_sec']:.0f} keys/s "
            f"({r['inputs_per_sec']:.0f} seeds/s, {r['slots']} slots) over "
            f"{r['superbatches']} superbatches of {BATCH} from {r['start']}, "
            f"{r['ms_per_superbatch']:.4f} ms a superbatch on the host's clock; host issue "
            f"{r['host_issue_ms_per_superbatch']:.4f} ms, device busy "
            f"{r['device_busy_ms_per_superbatch']:.4f} ms, wall under the profiler "
            f"{r['wall_ms_per_superbatch']:.4f} ms, idle share {r['device_idle_share']:.3f}, "
            f"{r['launches_per_superbatch']:g} launches a superbatch "
            f"({r['glue_launches_per_superbatch']:g} torch glue); device ms: {kern} [{card}]")


# ---------------------------------------------------------------------------
# phase 7: the string and generate paths, D1 and D2
# ---------------------------------------------------------------------------

def digest_strings(rng, n: int) -> list:
    """``n`` byte strings of 0 to 300 bytes: the padding edges (0, 1, 55,
    56, 63, 64, 119, 120, 300 bytes), UTF-8 text, then random bytes."""
    base = [bytes(k) for k in (0, 1, 55, 56, 63, 64, 119, 120, 300)]
    base += [b"\xff" * k for k in (55, 56, 119, 120)]
    base += [t.encode() for t in ("correct horse battery staple", "ünïcödé pässwörd €",
                                  "語" * 20, "é" * 28)]
    lens = rng.integers(0, 301, n - len(base))
    blob = rng.bytes(int(lens.sum()))
    ends = np.cumsum(lens).tolist()
    return base + [blob[e - k:e] for e, k in zip(ends, lens.tolist())]


def host_digest(data: bytes, mode: str) -> bytes:
    if mode == "md5":
        return hashlib.md5(data).digest()
    d = hashlib.sha256(data).digest()
    return hashlib.sha256(d).digest() if mode == "double_sha256" else d


def digest_mismatches(datas, got: torch.Tensor, mode: str, lanes) -> list:
    """The lanes of ``got`` (D1's (M, 8) or (M, 4) words) that are not
    hashlib's digest of ``datas``."""
    arr = as_i64(got.cpu()).numpy().astype("<u4" if mode == "md5" else ">u4")
    return [j for j in lanes if arr[j].tobytes() != host_digest(datas[j], mode)]


def digest_edges(rng) -> list:
    """(what, strings, offset) of D1's edges: a warp of strings of 1 to 6
    blocks, empty strings, the padding edges, a 10 KB string and blocks
    whose 256 strings exceed the kernel's 16 KB tile, strings at every
    byte alignment (and, with ``offset`` 1, the words one u32 off a 16-byte
    boundary), and the batch sizes 1, 255, 257 and 1869."""
    rand = lambda lens: [rng.bytes(int(k)) for k in lens]
    blocks = [0, 55, 56, 119, 120, 183, 184, 247, 248, 311, 312, 375]
    warp = rand(blocks + list(rng.integers(0, 376, 20)))
    pads = rand([55, 56, 63, 64, 119, 120] * 43)
    edges = [("a warp of 1 to 6 blocks", warp * 9, 0),
             ("empty strings", [b""] * 300 + rand(rng.integers(0, 3, 300)), 0),
             ("55, 56, 63, 64, 119, 120 bytes", pads, 0),
             ("a 10 KB string among short ones", rand(rng.integers(1, 65, 300)) +
              [rng.bytes(10240)] + rand(rng.integers(1, 65, 300)), 0),
             ("700 strings of 100 bytes (25.6 KB a block)", rand([100] * 700), 0)]
    aligned = [s for k in range(64) for s in rand([k % 4, 1 + k % 40])]
    edges += [("every byte alignment", aligned, 0),
              ("every byte alignment, words off 16 bytes", aligned, 1)]
    edges += [(f"M = {m}", rand(rng.integers(0, 131, m)), 0) for m in TAILS]
    return edges


def digest_edges_against_plain(dev, rng, modes=digest.MODES + ("chain",)) -> list:
    """D1 on each of ``digest_edges`` in ``modes``, one launch a call,
    against its plain version and hashlib on every lane (the chain at depth
    3 from the strings' SHA-256); returns the edges held."""
    held = []
    for what, datas, shift in digest_edges(rng):
        words, offsets = digest.pack(datas)
        buf = torch.zeros(words.numel() + 4, dtype=torch.uint32, device=dev)
        wd = buf[shift:shift + words.numel()]
        wd.copy_(words.to(dev))
        od = offsets.to(dev)
        for mode in modes:
            if mode == "chain":
                keys = digest.digest_plain(words, offsets, "sha256")
                got = launched_once(digest.KERNEL, lambda: digest.digest_chain(keys.to(dev), 3))
                if not torch.equal(as_i64(got.cpu()), as_i64(digest.digest_chain_plain(keys, 3))):
                    raise AssertionError(f"D1 chain on {what}: differs from plain")
            else:
                got = launched_once(digest.KERNEL, lambda: digest.digest(wd, od, mode))
                if not torch.equal(as_i64(got.cpu()),
                                   as_i64(digest.digest_plain(words, offsets, mode))):
                    raise AssertionError(f"D1 {mode} on {what}: differs from plain")
                bad = digest_mismatches(datas, got, mode, range(len(datas)))
                if bad:
                    raise AssertionError(f"D1 {mode} on {what}: lanes {bad[:8]} differ from "
                                         f"hashlib")
        held.append(what)
    return held


def p2pkh_digests(rng, n: int) -> torch.Tensor:
    """(5, n) uint32 LE hash160 words: all zeros, all 0xff, 8 zero bytes
    first, then random ones."""
    h = rng.integers(0, 1 << 32, (5, n), dtype=np.uint32)
    h[:, 0] = 0
    h[:, 1] = 0xFFFFFFFF
    h[:2, 2] = 0
    return torch.from_numpy(h)


def launch_device_ms(fn, kern, iters: int = 20, missing_ok: bool = False):
    """Device milliseconds of one launch of ``kern`` under
    ``torch.profiler``, ``fn`` launching it once a call: its recorded time
    over the launches recorded.  CUPTI drops one launch of a window now and
    then, and now and then most of one (as ``benchmark._profiled`` sees):
    a window that records fewer than half the launches runs again, three
    times at most, and then this raises, or with ``missing_ok`` returns
    None."""
    from torch.profiler import ProfilerActivity, profile
    from vuke_tpu_torch.benchmark import _device_events

    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, n = _device_events(prof, 1).get(kern.entry, (0.0, 0))
        if n >= iters // 2:
            return ms / n
    if missing_ok:
        return None
    raise RuntimeError(f"torch.profiler recorded {n} of {iters} launches of {kern.name}")


def launched_once(kern, fn):
    before = kern.launches
    out = fn()
    torch.cuda.synchronize()
    if kern.launches != before + 1:
        raise AssertionError(f"{kern.name}: {kern.launches - before} launches, expected 1")
    return out


def phase_digest(dev, rng, card: str, int_ops_per_s: float):
    """7a: D1 against its plain version and hashlib, every mode and the
    chain; then its time at 2^19 short strings beside hashlib's."""
    datas = digest_strings(rng, N_STRINGS)
    words, offsets = digest.pack(datas)
    wd, od = words.to(dev), offsets.to(dev)
    err = 0
    for mode in digest.MODES:
        got = launched_once(digest.KERNEL, lambda: digest.digest(wd, od, mode))
        err = max(err, exact_err(f"D1 {mode}", [got.cpu()],
                                 [digest.digest_plain(words, offsets, mode)]))
        bad = digest_mismatches(datas, got, mode, range(N_STRINGS))
        if bad:
            raise AssertionError(f"D1 {mode}: {len(bad)} lanes differ from hashlib: {bad[:8]}")
    keys = digest.digest(wd, od, "sha256")
    chain = launched_once(digest.KERNEL, lambda: digest.digest_chain(keys, 10))
    err = max(err, exact_err("D1 chain", [chain], [digest.digest_chain_plain(keys, 10)]))
    arr = as_i64(chain.cpu()).numpy().astype(">u4")
    for j in range(N_STRINGS):
        cur = hashlib.sha256(datas[j]).digest()
        for d in range(10):
            if arr[d, j].tobytes() != cur:
                raise AssertionError(f"D1 chain lane {j} depth {d} differs from hashlib")
            cur = hashlib.sha256(cur).digest()
    say(f"[7a D1 digest] {N_STRINGS} strings of 0..300 bytes (0, 1, 55, 56, 63, 64, 119, 120, "
        f"300 and UTF-8 included): sha256, double_sha256, md5 == plain lane-exact (max abs "
        f"err 0) and == hashlib on every lane; the chain at depth 10 == plain and hashlib; "
        f"one launch a call")
    held = digest_edges_against_plain(dev, rng)
    say(f"[7a D1 edges] {'; '.join(held)}: sha256, double_sha256, md5 and the chain at depth "
        f"3 == plain and hashlib on every lane, one launch a call")

    short = [rng.bytes(int(k)) for k in rng.integers(1, 65, BATCH)]
    sw, so = digest.pack(short)
    swd, sod = sw.to(dev), so.to(dev)
    ms = time_cuda(lambda: digest.digest(swd, sod, "sha256"), iters=20, warmup=3)
    dev_ms = launch_device_ms(lambda: digest.digest(swd, sod, "sha256"), digest.KERNEL)
    t0 = time.perf_counter()
    digest.digest_plain(sw, so, "sha256")
    plain_ms = (time.perf_counter() - t0) * 1e3
    blocks = float(np.mean([(len(d) + 9 + 63) // 64 for d in short]))
    ops = work.digest("sha256", blocks)
    nbytes = 4 * sw.numel() + 8 * so.numel() + 32 * BATCH
    bound_ms, bound_by, limit = bound_of(nbytes, ops, BATCH, int_ops_per_s)
    host = {}
    for k in (1000, BATCH):
        t0 = time.perf_counter()
        for d in short[:k]:
            hashlib.sha256(d).digest()
        host[k] = (time.perf_counter() - t0) * 1e6 / k
    say(f"[7a time] D1 sha256 on {BATCH} strings of 1..64 bytes ({blocks:.3f} blocks a "
        f"string): kernel {ms:.4f} ms (CUDA events), {dev_ms:.4f} ms device (profiler), plain "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {limit} "
        f"({100 * bound_ms / dev_ms:.1f}% of the device time; {ops.alu:.0f} ALU, {ops.add:.0f} "
        f"adds a string); hashlib on the host {host[1000]:.3f} us a string over 1000, "
        f"{host[BATCH]:.3f} over {BATCH} ({host[BATCH] * BATCH / 1e3:.1f} ms) [{card}]")
    return err, (ms, plain_ms, bound_ms, bound_by)


def bound_of(nbytes: float, ops: work.Ops, n: int, int_ops_per_s: float):
    """(bound_ms, bound_by, limit) of work that moves ``nbytes`` and needs
    ``ops`` a lane on ``n`` lanes, as ``bound`` gives them."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops.cycles() * n / int_ops_per_s
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", "bytes"
    return t_ops * 1e3, "operations", ops.pipe()


TAILS = (1, 255, 257, 1869)      # beside BATCH: below, around and off the kernels' tiles


def phase_p2pkh(dev, rng, card: str, int_ops_per_s: float, pipes: dict):
    """7b: D2 against its plain version on every row at 2^19 lanes and at
    the tail sizes (1, 255, 257, 1869: D2's tile is 256 rows), and
    ``encode.p2pkh_address`` on 4096, for 0x00 and 0x6F; a short
    ``generate`` through the command line (D2 on the main path); its time."""
    h = p2pkh_digests(rng, BATCH)
    hd = h.to(dev)
    plain_ms = None
    for net in (encode.BITCOIN, encode.TESTNET):
        v = net.p2pkh_version
        for n in TAILS:
            got = launched_once(p2pkh.KERNEL, lambda: p2pkh.batch_p2pkh(hd[:, :n].contiguous(), v))
            want = p2pkh.batch_p2pkh_plain(h[:, :n].contiguous(), v)
            if not torch.equal(got.cpu(), want):
                bad = (got.cpu() != want).any(dim=1).nonzero().flatten().tolist()
                raise AssertionError(f"D2 version {v:#x} at n = {n}: {len(bad)} rows differ: "
                                     f"{bad[:8]}")
        rows = launched_once(p2pkh.KERNEL, lambda: p2pkh.batch_p2pkh(hd, v)).cpu()
        t0 = time.perf_counter()
        want = p2pkh.batch_p2pkh_plain(h, v)
        plain_ms = plain_ms or (time.perf_counter() - t0) * 1e3
        if not torch.equal(rows, want):
            bad = (rows != want).any(dim=1).nonzero().flatten().tolist()
            raise AssertionError(f"D2 version {v:#x}: {len(bad)} rows differ: {bad[:8]}")
        addrs = p2pkh.addresses(rows.numpy())
        hb = h.numpy().astype("<u4").T.copy().tobytes()
        for j in [0, 1, 2] + rng.choice(np.arange(3, BATCH), min(4093, BATCH - 3),
                                        replace=False).tolist():
            if addrs[j] != p2pkh_address(hb[20 * j:20 * j + 20], net):
                raise AssertionError(f"D2 version {v:#x} row {j} differs from p2pkh_address")
    start = 10 ** 11 + int(rng.integers(0, 1 << 20))
    rc, text, log, launches, secs = run_cli(
        ["generate", "--transform", "sha256", "range", "--start", str(start), "--end",
         str(start + 4095)])
    lines = text.splitlines()
    if rc != 0 or len(lines) != 3 * 4096:
        raise AssertionError(f"7b generate: rc {rc}, {len(lines)} lines, stderr {log!r}")
    check_launches("7b generate", launches, {"p2pkh": 3, "keygen_hash": 1, "records": 0})
    for i in rng.choice(len(lines), 256, replace=False).tolist():
        seed = int(lines[i].split(",")[0])
        if host_line(lines[i], host_hash_keys("sha256", seed)[i % 3]) != lines[i]:
            raise AssertionError(f"7b generate: line {i} differs from the host: {lines[i]}")
    ms = time_cuda(lambda: p2pkh.batch_p2pkh(hd, 0), iters=20, warmup=3)
    dev_ms = launch_device_ms(lambda: p2pkh.batch_p2pkh(hd, 0), p2pkh.KERNEL)
    ops = work.p2pkh()
    bound_ms, bound_by, limit = bound_of(55 * BATCH, ops, BATCH, int_ops_per_s)
    sass_p = pipes["p2pkh"]
    say(f"[7b D2 p2pkh] {BATCH} hash160s (all zeros, all 0xff, 8 zero bytes, random), versions "
        f"0x00 and 0x6f: kernel == plain byte-exact on every row, and at n = "
        f"{', '.join(map(str, TAILS))}; 4096 rows == encode.p2pkh_address; generate sha256 "
        f"over 4096 seeds: D2 3 times, 256 sampled lines == host KeyDeriver; kernel {ms:.4f} "
        f"ms (CUDA events), {dev_ms:.4f} ms device (profiler), plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms by {limit} ({100 * bound_ms / dev_ms:.1f}% of the device time; "
        f"needs a lane {ops.mul:.0f} multiplies, {ops.alu:.0f} ALU, {ops.add:.0f} adds; SASS "
        f"issues a lane {sass_p.alu:.0f} ALU, {sass_p.fma:.0f} FMA 2-cycle units, "
        f"{sass_p.issued:.0f} in all) [{card}]")
    return 0, (ms, plain_ms, bound_ms, bound_by), launches


def run_cli(argv, stdin=None):
    """``cli.main(argv)`` with every launch count set to 0 just before and
    read just after, stdout and stderr captured: (rc, stdout, stderr,
    launches, seconds)."""
    for kern in ALL_KERNELS.values():
        kern.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), err.getvalue(), launch_counts(), time.perf_counter() - t0


def host_line(line: str, key: bytes) -> str:
    """The generate line of ``line``'s source and transform for the raw
    ``key``, from the host ``KeyDeriver``."""
    source, name = line.split(",")[:2]
    d = KeyDeriver().derive(key)
    return f"{source},{name},{d.private_key_hex},{d.p2pkh_compressed}"


def phase_generate(dev, rng, card: str) -> dict:
    """7c: ``generate`` with two transforms over 70,000 seeds, no
    ``--batch``: one device superbatch, the lines in the JAX package's
    65536-seed order; 4096 sampled lines against the host; then the
    lines/s of 2^20 sha256 seeds."""
    start = 10 ** 12 + int(rng.integers(0, 1 << 20))
    n, chunk = GEN_SEEDS, pipeline.ORDER_BATCH
    rc, text, log, launches, secs = run_cli(
        ["generate", "--transform", "sha256", "--transform", "md5", "range", "--start",
         str(start), "--end", str(start + n - 1)])
    done = f"Generating keys...\nDone. Inputs: {2 * n}, Keys: {4 * n}, Matches: 0\n"
    lines = text.splitlines()
    if rc != 0 or log != done or len(lines) != 4 * n:
        raise AssertionError(f"generate: rc {rc}, {len(lines)} lines, stderr {log!r}")
    order, slots = [], []
    for a in range(0, n, chunk):
        seeds = range(start + a, start + min(n, a + chunk))
        order += [(str(s), "sha256") for s in seeds for _ in range(3)]
        slots += [0, 1, 2] * len(seeds)
        order += [(str(s), "md5") for s in seeds]
        slots += [0] * len(seeds)
    got = [tuple(line.split(",")[:2]) for line in lines]
    if got != order:
        first = next(i for i, (g, w) in enumerate(zip(got, order)) if g != w)
        raise AssertionError(f"generate: line {first} is {got[first]}, expected {order[first]}")
    check_launches("generate", launches, {"keygen_hash": 2, "normalize": 4, "smul": 4,
                                          "inv_affine": 4, "hash160": 4, "p2pkh": 4,
                                          "seq_madd": 0, "digest": 0, "mt19937": 0})
    bad = []
    for i in rng.choice(len(lines), 4096, replace=False).tolist():
        want = host_line(lines[i], host_hash_keys(got[i][1], int(got[i][0]))[slots[i]])
        if want != lines[i]:
            bad.append(want)
    if bad:
        raise AssertionError(f"generate: {len(bad)} sampled lines differ from the host: {bad[:3]}")
    say(f"[7c generate] sha256 + md5 over [{start}, {start + n - 1}] without --batch: "
        f"{4 * n} lines in the JAX order ({chunk}-seed chunks, then transform, seed, slot), "
        f"stderr {log!r}; 4096 sampled lines == host KeyDeriver; {secs:.2f} s host wall clock; "
        f"launches {launches}")
    r = bench_generate("sha256", seeds=1 << 20, batch=BATCH)
    for sink in ("devnull", "file"):
        say(f"[7c generate rate] sha256 over {r['seeds']} seeds, batch {BATCH}, into {sink}: "
            f"{r[sink]['lines_per_sec']:.0f} lines/s ({r[sink]['lines']} lines in "
            f"{r[sink]['seconds']:.3f} s) [{card}]")
    d = r["devnull"]
    kern = ", ".join(f"{k} {v:.4f}" for k, v in d["kernels_ms_per_superbatch"].items())
    say(f"[7c generate profile] a superbatch: host issue {d['host_issue_ms_per_superbatch']:.3f} "
        f"ms, format + write {d['host_write_ms_per_superbatch']:.3f} ms; wall under the "
        f"profiler {d['wall_ms_per_superbatch']:.3f} ms, device busy "
        f"{d['device_busy_ms_per_superbatch']:.4f} ms, idle share "
        f"{d['device_idle_share_per_superbatch']:.3f}, {d['launches_per_superbatch']:g} "
        f"launches ({d['glue_launches_per_superbatch']:g} torch glue); device ms: {kern} [{card}]")
    return launches


def phase_bench(card: str) -> list:
    """7f: the JAX command's ``bench`` on the card: sha256 (the keygen
    kernel, 65536 seeds a call) with its three lines, and electrum (a
    string-only transform: 1000 decimal strings a call, W2 and K3 -> K4
    behind it) with ``--json``; each after its 2 s warm-up, over 1 s."""
    three = re.compile(r"Benchmark: sha256\n  \d+\.\d\d M inputs/sec \(\d+\.\d\d M keys/sec\)\n"
                       r"  batch=65536 iters=\d+ elapsed=\d+\.\d\ds\n")
    rc, lines, log, sha, secs = run_cli(["bench", "--seconds", "1"])
    if rc != 0 or not three.fullmatch(lines):
        raise AssertionError(f"bench: rc {rc}, stdout {lines!r}, stderr {log!r}")
    check_launches("bench sha256", sha, {"keygen_hash": None})
    rc, text, log, elec, secs_e = run_cli(["bench", "--transform", "electrum", "--batch", "1000",
                                           "--seconds", "1", "--json"])
    r = json.loads(text)
    if (rc != 0 or list(r) != ["transform", "inputs_per_sec", "keys_per_sec", "batch",
                               "iterations", "elapsed_secs"]
            or r["batch"] != 1000 or r["keys_per_sec"] != 20 * r["inputs_per_sec"]):
        raise AssertionError(f"bench electrum: rc {rc}, stdout {text!r}, stderr {log!r}")
    check_launches("bench electrum", elec, {"electrum_stretch": None, "smul": None,
                                            "inv_affine": None})
    say(f"[7f bench] `bench --seconds 1`: {' / '.join(lines.splitlines()[1:])}, the keygen "
        f"launched {sha['keygen_hash']} times in {secs:.1f} s; `bench --transform electrum "
        f"--batch 1000 --seconds 1 --json`: {r['inputs_per_sec']:.0f} seeds/s, "
        f"{r['iterations']} calls in the best window, W2 launched {elec['electrum_stretch']} "
        f"times in {secs_e:.1f} s [{card}]")
    return [sha, elec]


def write_targets(name: str, targets: list, decoys: list):
    path = kernels.BUILD_DIR / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(decoys[:2048] + targets + decoys[2048:]) + "\n")
    return str(path)


def hit_sources(text: str) -> list:
    """(Source, Transform) of each hit block of a scan's stdout."""
    lines = text.splitlines()
    return [(lines[i][8:], lines[i + 1][11:]) for i, line in enumerate(lines)
            if line.startswith("Source: ")]


def phase_wordlist(dev, rng, card: str, decoys: list) -> list:
    """7d: a wordlist scan of 2^20 seeded words with four transforms and a
    planted word each; its words/s; then sha256_chain over 2^14 words with
    ``VUKE_HOST_DIGEST_MAX=0`` (D1 on the path)."""
    from vuke_tpu_torch.benchmark import seeded_words
    runs = []
    n = WORDS
    words = seeded_words(n, int(rng.integers(1 << 31)))
    picks = rng.choice(n, 4, replace=False).tolist()
    keys = {"sha256": sha256(words[picks[0]].encode()),
            "double_sha256": sha256(sha256(words[picks[1]].encode())),
            "md5": hashlib.md5(words[picks[2]].encode()).digest() * 2,
            "direct": words[picks[3]].encode().ljust(32, b"\0")}
    planted = [(words[i], t) for i, t in zip(picks, keys)]
    targets = [p2pkh_address(host_h160s(int.from_bytes(k, "big") % N or 1)[0]) for k in keys.values()]
    tpath = write_targets("smoke_words_targets.txt", targets, decoys)
    wpath = kernels.BUILD_DIR / "smoke_words.txt"
    wpath.write_text("\n".join(words) + "\n")
    rc, text, log, launches, secs = run_cli(
        ["scan"] + sum((["--transform", t] for t in keys), []) + ["--targets", tpath,
                                                                  "wordlist", "--file", str(wpath)])
    done = (f"Loaded {len(decoys) + 4} target addresses\nScanning...\n"
            f"Done. Inputs: {n}, Keys: {4 * n}, Matches: 4\n")
    if rc != 0 or log != done or sorted(hit_sources(text)) != sorted(planted):
        raise AssertionError(f"wordlist scan: rc {rc}, hits {hit_sources(text)} (expected "
                             f"{planted}), stderr {log!r}")
    batches = -(-n // 1000)
    check_launches("wordlist scan", launches, {"hash160": 4 * batches, "normalize": 4 * batches,
                                               "digest": 0, "p2pkh": 0, "keygen_hash": 0})
    runs.append(launches)
    say(f"[7d wordlist scan] {n} seeded words x sha256, double_sha256, md5, direct vs "
        f"{len(decoys)} decoys + 4 planted: exactly the 4 hits {planted}; {n / secs:.0f} "
        f"words/s through the command line ({secs:.2f} s, file read included); launches "
        f"{launches} [{card}]")
    r = bench_strings("sha256", words=n)
    kern = ", ".join(f"{k} {v:.4f}" for k, v in r["kernels_ms_per_batch"].items())
    say(f"[7d wordlist rate] sha256 over {n} words: {r['words_per_sec']:.0f} words/s, "
        f"{r['keys_per_sec']:.0f} keys/s; a batch of {r['string_batch']} (pad {r['pad']}): "
        f"keys (hashlib) {r['host_keys_ms_per_batch']:.3f} ms, device match with its read "
        f"{r['host_match_ms_per_batch']:.3f} ms, rest {r['host_other_ms_per_batch']:.3f} ms; "
        f"under the profiler wall {r['wall_ms_per_batch']:.3f} ms, device busy "
        f"{r['device_busy_ms_per_batch']:.4f} ms, idle share {r['device_idle_share_per_batch']:.3f}, "
        f"{r['launches_per_batch']:g} launches ({r['glue_launches_per_batch']:g} torch glue); "
        f"device ms: {kern} [{card}]")

    n = CHAIN_WORDS
    words = words[:n]
    i = int(rng.integers(0, n))
    key = sha256(words[i].encode() + b"7")
    tpath = write_targets("smoke_chain_targets.txt",
                          [p2pkh_address(host_h160s(int.from_bytes(key, "big") % N or 1)[0])],
                          decoys)
    wpath.write_text("\n".join(words) + "\n")
    with env_set("VUKE_HOST_DIGEST_MAX", "0"):
        rc, text, log, launches, secs = run_cli(
            ["scan", "--transform", "sha256_chain", "--targets", tpath, "wordlist", "--file",
             str(wpath)])
    want = [(f"{words[i]}[counter:7]", "sha256_chain")]
    done = (f"Loaded {len(decoys) + 1} target addresses\nScanning...\n"
            f"Done. Inputs: {n}, Keys: {40 * n}, Matches: 1\n")
    if rc != 0 or log != done or hit_sources(text) != want:
        raise AssertionError(f"chain wordlist scan: rc {rc}, hits {hit_sources(text)} "
                             f"(expected {want}), stderr {log!r}")
    batches = -(-n // 1000)
    check_launches("chain wordlist scan", launches, {"digest": 32 * batches,
                                                     "hash160": batches, "p2pkh": 0})
    runs.append(launches)
    say(f"[7d chain wordlist scan, VUKE_HOST_DIGEST_MAX=0] {n} words x sha256_chain (40 "
        f"slots): exactly 1 hit {want[0]}; D1 once per digest call (32 a batch); "
        f"{secs:.2f} s; launches {launches} [{card}]")
    return runs


def phase_timestamps(dev, rng, card: str, decoys: list) -> dict:
    """7e: one day with ``--microseconds`` and a hit in the millisecond
    lattice; then stdin and files scans in subprocesses."""
    from vuke_tpu_torch.sources import TimestampSource
    src = TimestampSource.from_dates(DAY, DAY, True)
    ms = (src.end + 1 - src.start) * 1000
    planted = src.start * 1000 + int(rng.integers(0, ms))
    tpath = write_targets("smoke_ts_targets.txt",
                          [p2pkh_address(host_h160s(int.from_bytes(
                              sha256(str(planted).encode()), "big") % N or 1)[0])], decoys)
    rc, text, log, launches, secs = run_cli(
        ["scan", "--targets", tpath, "timestamps", "--start", DAY, "--end", DAY,
         "--microseconds"])
    seeds = src.end + 1 - src.start + ms
    done = (f"Loaded {len(decoys) + 1} target addresses\nScanning...\n"
            f"Done. Inputs: {seeds}, Keys: {3 * seeds}, Matches: 1\n")
    if rc != 0 or log != done or hit_sources(text) != [(str(planted), "sha256")]:
        raise AssertionError(f"timestamps scan: rc {rc}, hits {hit_sources(text)}, "
                             f"stderr {log!r}")
    supers = -(-(src.end + 1 - src.start) // BATCH) + -(-ms // BATCH)
    check_launches("timestamps scan", launches, {"keygen_hash": supers, "hash160": 3 * supers,
                                                 "seq_madd": 0, "p2pkh": 0, "digest": 0})
    say(f"[7e timestamps scan] {DAY} with --microseconds ({seeds} seeds, 3 slots) vs "
        f"{len(decoys)} decoys + ms {planted}: exactly 1 hit; {seeds / secs:.0f} seeds/s "
        f"({secs:.2f} s host wall clock); launches {launches} [{card}]")

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    words = [f"stdin word {i}" for i in range(5000)]
    j = int(rng.integers(0, 5000))
    tpath = write_targets("smoke_stdin_targets.txt", [p2pkh_address(host_h160s(
        int.from_bytes(sha256(words[j].encode()), "big") % N or 1)[0])], decoys)
    files = kernels.BUILD_DIR / "smoke_files"
    (files / "sub").mkdir(parents=True, exist_ok=True)
    names = [files / f"f{i}" for i in range(8)] + [files / "sub" / f"g{i}" for i in range(8)]
    for p in names:
        p.write_text(p.name)
    k = str(names[int(rng.integers(0, len(names)))])
    fpath = write_targets("smoke_files_targets.txt", [p2pkh_address(host_h160s(
        int.from_bytes(sha256(k.encode()), "big") % N or 1)[0])], decoys)
    for what, argv, stdin, source, inputs in (
            ("stdin", ["scan", "--targets", tpath, "stdin"], "\n".join(words) + "\n",
             words[j], 5000),
            ("files", ["scan", "--targets", fpath, "files", "--dir", str(files)], None, k,
             len(names))):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vuke_tpu_torch", *argv], input=stdin,
                           capture_output=True, text=True, env=env, timeout=300)
        done = (f"Loaded {len(decoys) + 1} target addresses\nScanning...\n"
                f"Done. Inputs: {inputs}, Keys: {inputs}, Matches: 1\n")
        if r.returncode != 0 or r.stderr != done or hit_sources(r.stdout) != [(source, "sha256")]:
            raise AssertionError(f"{what} scan: rc {r.returncode}, hits {hit_sources(r.stdout)}"
                                 f", stderr {r.stderr!r}")
        say(f"[7e {what} scan] a subprocess over {inputs} inputs vs {len(decoys)} decoys + 1: "
            f"exactly 1 hit, 'Source: {source}'; {time.perf_counter() - t0:.2f} s with the "
            f"process's start [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 8: analyze on the card, S1 and S2
# ---------------------------------------------------------------------------

def key_words(key: bytes) -> list:
    return [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(8)]


def words_key(words) -> bytes:
    return b"".join((int(w) & 0xFFFFFFFF).to_bytes(4, "big") for w in words)


def plain_keys(family: str, variant: int, be: bool, seed: int, n_keys: int) -> list:
    """The first ``n_keys`` keys (bytes) of one seed's stream, from the plain
    keystreams on the CPU."""
    hi, lo = torch.tensor([seed >> 32]), torch.tensor([seed & 0xFFFFFFFF])
    return [words_key(k) for k in sweep.prng_keys_plain(family, variant, be, hi, lo, n_keys)]


def plain_chain(variant: str, seed: int, depth: int) -> list:
    s = torch.tensor([seed & 0xFFFFFFFF])
    return [words_key(k) for k in sha256_chain.chain([s], torch.full_like(s, 4), variant, depth)]


def sweep_compares(keys_mid: list, keys_last: list, cascade: bool, track: bool = True) -> list:
    """exact and 64-bit mask on the middle lane's key 0, exact and a 12-bit
    mask (many earlier hits) on the last lane's; cascades of 5 targets from
    the middle lane's keys and 2 from the last lane's, the first filter
    tracked (S1)."""
    cmp = [sweep.Compare("exact", words=tuple(key_words(keys_mid[0]))),
           sweep.Compare("exact", words=tuple(key_words(keys_last[0]))),
           sweep.Compare("mask", targets=((64, apply_mask(keys_mid[0], 64)),)),
           sweep.Compare("mask", targets=((12, apply_mask(keys_last[0], 12)),))]
    if cascade:
        cmp += [sweep.Compare("cascade", track=track, targets=tuple(
                    (b, apply_mask(k, b)) for b, k in zip((4, 8, 12, 16, 20), keys_mid))),
                sweep.Compare("cascade", track=track, targets=tuple(
                    (b, apply_mask(k, b)) for b, k in zip((6, 30), keys_last)))]
    return cmp


def long_cascade(keys: list, track: bool) -> sweep.Compare:
    """A cascade of ``CASCADE`` targets from one seed's keys (past the
    MT19937 init block's 28 keys): 4 bits on key 0, so that an eighth of
    the lanes pass the first filter, then 8 to 24 bits."""
    bits = [4] + [8 + j % 17 for j in range(1, len(keys))]
    return sweep.Compare("cascade", track=track,
                         targets=tuple((b, apply_mask(k, b)) for b, k in zip(bits, keys)))


def sweep_against_plain(dev, rng, n_prng: int = S1_LANES, n_chain: int = S2_LANES) -> dict:
    """S1 in every family, variant and mode on ``n_prng`` lanes and S2 in
    every variant and mode at depth 10 on ``n_chain`` (by default the
    batches the analyzers give them on the card), each against its plain
    version on the card on the same lanes: the 64-bit families from (5 << 32) + 2^32 - n/2 (the carry
    mid-batch), milksad and the LCGs the top n seeds of the u32 space, the
    chains from 2^32 - n/2 (the u32 wrap); hits planted in the middle lane
    and the last; a cascade of ``CASCADE`` targets from the middle lane's
    keys in every family but the LCGs' and every chain variant.  Records
    (first hit, first-filter count) must be equal; returns {kernel: (cases,
    max abs err)}."""
    got = torch.empty(2, dtype=torch.int64, device=dev)
    want = torch.empty(2, dtype=torch.int64, device=dev)
    out = {}

    def hold(name, kern, fn, plain, cmp, planted: int):
        before = kern.launches
        fn(got, cmp)
        torch.cuda.synchronize()
        if kern.launches != before + 1:
            raise AssertionError(f"{name}: {kern.launches - before} launches, expected 1")
        plain(want, cmp)
        g, w = got.tolist(), want.tolist()
        if g != w or not 0 <= g[0] <= planted:
            raise AssertionError(f"{name} {cmp.mode} {cmp.targets or cmp.words}: kernel {g}, "
                                 f"plain {w}, planted at {planted}")
        cases, err = out.get(kern.name, (0, 0))
        out[kern.name] = (cases + 1, max(err, abs(g[0] - w[0]), abs(g[1] - w[1])))

    off = int(rng.integers(0, 64))
    n = n_prng
    mid = n // 2 + off
    for family in sweep.FAMILIES:
        wide = family in ("mt64", "xorshift")
        start = ((5 << 32) + SPACE - n // 2) if wide else SPACE - n
        streams = ([(v, be) for v in range(4) for be in (True, False)] if family == "lcg"
                   else [(v, True) for v in range(4 if family == "xorshift" else 1)])
        for v, be in streams:
            nk = 1 if family == "lcg" else CASCADE
            keys_mid = plain_keys(family, v, be, start + mid, nk)
            cmps = sweep_compares(keys_mid[:5], plain_keys(family, v, be, start + n - 1, 5)[:nk],
                                  family != "lcg")
            if family != "lcg":
                cmps.append(long_cascade(keys_mid, True))
            for j, cmp in enumerate(cmps):
                hold(f"S1 {family}:{v}:{'be' if be else 'le'}", sweep.PRNG_KERNEL,
                     lambda r, c: sweep.sweep_prng(r, start, n, family, v, be, c),
                     lambda r, c: sweep.sweep_prng_plain(r, start, n, family, v, be, c),
                     cmp, mid if j % 2 == 0 else n - 1)
    n = n_chain
    mid = n // 2 + off
    start = SPACE - n // 2
    for v in sweep.CHAIN_VARIANTS:
        km, kl = plain_chain(v, start + mid, CASCADE), plain_chain(v, start + n - 1, 10)
        cmps = sweep_compares([km[7]], [kl[9]], False)
        cmps += sweep_compares(km[:5], kl[:2], True, track=False)[4:]
        cmps.append(long_cascade(km, False))
        for j, cmp in enumerate(cmps):
            depth = cmp.n_targets if cmp.mode == "cascade" else 10
            last = (n - 1) * (1 if cmp.mode == "cascade" else 10) + (9 if j in (1, 3) else 0)
            planted = mid * (1 if cmp.mode == "cascade" else 10) + (7 if j in (0, 2) else 0)
            hold(f"S2 {v}", sweep.CHAIN_KERNEL,
                 lambda r, c: sweep.sweep_chain(r, start, n, v, depth, c),
                 lambda r, c: sweep.sweep_chain_plain(r, start, n, v, depth, c),
                 cmp, planted if j % 2 == 0 else last)
    return out


def lcg_alias(seed: int, v: int) -> int:
    """The least u32 seed with ``seed``'s LCG key: glibc's state is the
    seed mod 2^31, minstd's mod 2^31 - 1; msvc's and borland's are the seed."""
    m = lcg.ALL_VARIANTS[v].m
    return seed % m if m < SPACE else seed


def lcg_grid_threads(dev, limit: int) -> int:
    """The threads of S1's LCG grid for ``limit`` lanes (csrc/sweep_prng.cu,
    ``lcg_launch``): 256 a block, two blocks an SM (``kLcgBlocksPerSm``),
    no more than the lanes need.  Lane i runs on thread i mod that, in its
    loop's iteration i // that."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(-(-limit // 256), 2 * sms) * 256


def lcg_edges_against_plain(dev, v: int, be: bool) -> list:
    """S1's LCG launch shape (a grid of T threads, thread t taking lanes t,
    t + T, ...) at its edges, for variant ``v`` and byte order ``be``:
    - a mask whose least hit is a thread's earlier lane while a lower
      thread hits in a later one, with and without the first-filter count
      (a thread that tracks goes on past its hit): thread 63's first lane
      and a later lane of one of threads 32..62 (the same warp), or, for BE
      power-of-two LCGs, whose masked bits repeat with the seed's low bits
      (every 2^(bits-1) seeds, a period that divides T up to 2^12), a 20-bit
      mask's hits 2^19 lanes apart, the later in a lower thread of another
      block;
    - exact hits in the first and the last lane of 5 T + 12,345 lanes;
    - one lane (exact and mask);
    - a batch across the u32 wrap of the low seed word, from (3 << 32) +
      2^32 - 100;
    - all 2^32 lanes from 0, exact, against the planted seed (or the least
      seed with its key, ``lcg_alias``): no plain version at that size.
    Each record must equal the plain version's; returns the cases held."""
    got = torch.empty(2, dtype=torch.int64, device=dev)
    want = torch.empty(2, dtype=torch.int64, device=dev)
    var, tag = lcg.ALL_VARIANTS[v], f"S1 lcg:{v}:{'be' if be else 'le'}"
    held = []

    def hold(what, start, limit, cmp, at):
        before = sweep.PRNG_KERNEL.launches
        sweep.sweep_prng(got, start, limit, "lcg", v, be, cmp)
        torch.cuda.synchronize()
        if sweep.PRNG_KERNEL.launches != before + 1:
            raise AssertionError(f"{tag} {what}: no launch")
        g = got.tolist()
        if limit < SPACE:
            sweep.sweep_prng_plain(want, start, limit, "lcg", v, be, cmp)
            if g != want.tolist():
                raise AssertionError(f"{tag} {what}: kernel {g}, plain {want.tolist()}")
        if g[0] != at and (at is not None or not 0 <= g[0] <= 300 or g[1] < 1):
            raise AssertionError(f"{tag} {what}: first hit {g[0]}, planted at {at}")
        held.append(what)

    exact = lambda seed: sweep.Compare("exact", words=tuple(key_words(
        plain_keys("lcg", v, be, seed, 1)[0])))
    mask = lambda seed, bits, track=False: sweep.Compare(
        "mask", targets=((bits, apply_mask(plain_keys("lcg", v, be, seed, 1)[0], bits)),),
        track=track)

    threads = lcg_grid_threads(dev, 1 << 24)
    if be and var.m != (1 << 31) - 1:
        # a power-of-two modulus: a BE word's low bits follow the seed's low
        # bits alone, so a 20-bit mask's hits are 2^19 seeds apart
        bits, lead, seed = 20, threads + 20_000, 1 << 28
        limit, other = lead + (1 << 19) + 5000, lead + (1 << 19)
    else:
        # an 8-bit mask from a seed 63 lanes into the batch; some thread of
        # 32..62 (the same warp) hits in a later lane
        bits, lead, limit = 8, 63, 16 * threads + 5000
        for seed in range(1 << 28, (1 << 28) + 1000 * 4096, 4096):
            lo = (seed - lead + torch.arange(limit, dtype=torch.int64, device=dev)) & 0xFFFFFFFF
            hits = sweep.mask_ok(lcg.lcg_key_words(lo, var, be), bits,
                                 apply_mask(plain_keys("lcg", v, be, seed, 1)[0], bits))
            lower = torch.nonzero(hits[threads:]).flatten() + threads
            lower = lower[(lower % threads >= 32) & (lower % threads < lead)]
            if bool(hits[lead]) and not bool(hits[:lead].any()) and lower.numel():
                other = int(lower[0])
                break
        else:
            raise AssertionError(f"{tag}: no seed whose mask hits as planned")
    (k_x, t_x), (k_y, t_y) = divmod(lead, threads), divmod(other, threads)
    if lcg_grid_threads(dev, limit) != threads or not (
            t_y < t_x and k_y > k_x):
        raise AssertionError(f"{tag}: lanes {lead} and {other} of {threads} threads")
    for track in (False, True):
        hold(f"thread {t_x}'s lane {k_x} before thread {t_y}'s lane {k_y}"
             + (", tracked" if track else ""), seed - lead, limit, mask(seed, bits, track), lead)
    start, limit = 1 << 30, 5 * threads + 12_345
    hold("the first lane", start, limit, exact(start), 0)
    hold("the last lane", start, limit, exact(start + limit - 1), limit - 1)
    hold("one lane, exact", start, 1, exact(start), 0)
    hold("one lane, mask", start, 1, mask(start, 64), 0)
    start = (3 << 32) + SPACE - 100
    hold("across the u32 wrap", start, 1000, exact(start + 300), 300)
    # an 8-bit mask: lanes before the planted one hit too; the plain decides
    hold("across the u32 wrap, tracked", start, 1000, mask(start + 300, 8, True), None)
    planted = SPACE - 5
    hold("2^32 lanes", 0, SPACE, exact(planted), lcg_alias(planted, v))
    return held


def sweep_timing(dev, card: str, int_ops_per_s: float) -> dict:
    """Each S1 family in its analyzer's mode on S1_LANES seeds and S2 in each
    variant (exact, depth 10) on S2_LANES: CUDA events, device time
    (profiler), the plain version on the card (its record must equal the
    kernel's), and the bound from ``kernels/work.py``.  The targets are
    random, so a cascade's key j reaches the lanes that pass the targets
    before it, the product of their 2^-(bits - 1).  Returns the kernels
    line's numbers: milksad exact for S1, iterated for S2."""
    rng = np.random.default_rng(8)
    rec = torch.empty(2, dtype=torch.int64, device=dev)
    want = torch.empty_like(rec)
    rnd = tuple(int(x) for x in rng.integers(0, 1 << 32, 8))
    cascade = tuple((b, int(rng.integers(0, 1 << (b - 1))) | 1 << (b - 1)) for b in (8, 16, 24))
    times = {}

    def plain_run(plain, what: str) -> float:
        t0 = time.perf_counter()
        plain(want)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if rec.tolist() != want.tolist():
            raise AssertionError(f"{what}: kernel {rec.tolist()}, plain {want.tolist()}")
        return plain_ms

    n = S1_LANES
    exact = sweep.Compare("exact", words=rnd)
    cases = [("milksad", 0, True, exact),
             ("mt64", 0, True, sweep.Compare("cascade", targets=cascade, track=True))]
    cases += [("lcg", v, be, exact) for v in range(4) for be in (True, False)]
    cases.append(("xorshift", 2, True, sweep.Compare("cascade", targets=cascade, track=True)))
    for family, v, be, cmp in cases:
        start = 1 << 40 if family in ("mt64", "xorshift") else 0
        fn = lambda: sweep.sweep_prng(rec, start, n, family, v, be, cmp)
        ms = time_cuda(fn, iters=10, warmup=2)
        dev_ms = launch_device_ms(fn, sweep.PRNG_KERNEL, iters=10)
        plain_ms = plain_run(lambda r: sweep.sweep_prng_plain(r, start, n, family, v, be, cmp),
                             f"S1 {family}:{v} {cmp.mode}")
        reach = [1.0]
        if cmp.mode == "exact":
            reach.append(word0_passes(dev, family, v, be, start, n, rnd[0]) / n)
        for b, _ in cmp.targets[:-1]:
            reach.append(reach[-1] * 2.0 ** (1 - b))
        ops = work.sweep_prng(family, cmp.mode, v, be, reach)
        bound_ms, bound_by, limit = bound_of(16, ops, n, int_ops_per_s)
        name = f"{family}:{v}" + (f":{'be' if be else 'le'}" if family == "lcg" else "")
        say(f"[8a time] S1 {name} {cmp.mode} on {n} seeds: kernel {ms:.4f} ms (CUDA "
            f"events), {dev_ms:.4f} ms device (profiler), {n / dev_ms / 1e6:.3f} G seeds/s; "
            f"plain {plain_ms:.1f} ms, record == the kernel's; bound {bound_ms:.4f} ms by "
            f"{limit} ({100 * bound_ms / dev_ms:.1f}% of the device time; a lane needs "
            f"{ops.mul:.1f} multiplies, {ops.alu:.1f} ALU, {ops.add:.1f} adds; "
            f"{'lanes past word 0' if cmp.mode == 'exact' else 'further keys'} "
            f"reach {[f'{r:.3g}' for r in reach[1:]]}) [{card}]")
        if family == "milksad":
            times["sweep_prng"] = (ms, plain_ms, bound_ms, bound_by)
    usage = [(re.search(r"sweep_prng_kernelILi(\d)ELb([01])ELb([01])E", name), regs, stack, spill)
             for name, regs, stack, spill in kernels.ptxas_usage(kernels.library().log)]
    say("[8a build] S1's LCG instantiations: " + ", ".join(
        f"{m[1]}:{'be' if m[2] == '1' else 'le'}:{'exact' if m[3] == '1' else 'mask'} {regs} regs, "
        f"stack {stack} B, spills {spill} B" for m, regs, stack, spill in usage if m))
    n = S2_LANES
    for v in sweep.CHAIN_VARIANTS:
        cmp = sweep.Compare("exact", words=rnd)
        fn = lambda: sweep.sweep_chain(rec, 0, n, v, 10, cmp)
        ms = time_cuda(fn, iters=5, warmup=1)
        dev_ms = launch_device_ms(fn, sweep.CHAIN_KERNEL, iters=5)
        plain_ms = plain_run(lambda r: sweep.sweep_chain_plain(r, 0, n, v, 10, cmp),
                             f"S2 {v} exact")
        ops = work.sweep_chain(v, "exact", [1.0] * 10)
        bound_ms, bound_by, limit = bound_of(16, ops, n, int_ops_per_s)
        say(f"[8a time] S2 {v} exact, depth 10, on {n} seeds: kernel {ms:.4f} ms (CUDA "
            f"events), {dev_ms:.4f} ms device (profiler), {n / dev_ms / 1e6:.3f} G seeds/s; "
            f"plain {plain_ms:.1f} ms, record == the kernel's; bound {bound_ms:.4f} ms by "
            f"{limit} ({100 * bound_ms / dev_ms:.1f}% of the device time; a lane needs "
            f"{ops.alu:.0f} ALU, {ops.add:.0f} adds) [{card}]")
        if v == "iterated":
            times["sweep_chain"] = (ms, plain_ms, bound_ms, bound_by)
    return times


def word0_passes(dev, family: str, v: int, be: bool, start: int, n: int, word0: int) -> int:
    """The lanes of a batch whose key word 0 equals ``word0`` (the lanes an
    exact sweep takes past its first compare), from the plain keystream."""
    lo = (start & 0xFFFFFFFF) + torch.arange(n, dtype=torch.int64, device=dev)
    hi = ((start >> 32) + (lo >> 32)) & 0xFFFFFFFF
    key = sweep.prng_keys_plain(family, v, be, hi, lo & 0xFFFFFFFF)[0]
    return int((key[0] == word0).sum())


def phase_sweep_kernels(dev, rng, card: str, int_ops_per_s: float):
    """8a: S1 and S2 against their plain versions on the main path's
    batches, then their times."""
    t0 = time.perf_counter()
    held = sweep_against_plain(dev, rng)
    say(f"[8a S1, S2] the main path's batches, hits planted in the middle lane and the last: "
        f"S1 {held['sweep_prng'][0]} cases on {S1_LANES} lanes (milksad, mt64, lcg x4 x BE/LE, "
        f"xorshift x4; exact, mask 64 and 12 bits, cascades of 5 and 2 targets with the first "
        f"filter and of {CASCADE}; mt64 and xorshift across the carry into the high word), S2 "
        f"{held['sweep_chain'][0]} cases on {S2_LANES} lanes (4 variants at depth 10 and a "
        f"cascade of {CASCADE}, across the u32 wrap): first hit and first-filter count == "
        f"plain on every case (max abs err 0); {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    edges = [lcg_edges_against_plain(dev, v, be) for v in range(4) for be in (True, False)]
    say(f"[8a S1 lcg edges] every LCG variant, BE and LE: {'; '.join(edges[0])}: first hit "
        f"(and first-filter count) == plain and the planted seed, {sum(map(len, edges))} "
        f"cases; {time.perf_counter() - t0:.1f} s")
    times = sweep_timing(dev, card, int_ops_per_s)
    return {k: err for k, (_, err) in held.items()}, times


def analyze_cli(argv: list, what: str, seeds: int, card: str, want_err: str | None = None):
    """One ``analyze`` through the command line (launch counts reset, read
    after); its stderr must be ``want_err`` (default: the ``Running``
    lines of its analyzers); prints its seeds/s.  Returns (stdout,
    launches)."""
    rc, text, log, launches, secs = run_cli(["analyze", *argv])
    if rc != 0 or (want_err is not None and log != want_err):
        raise AssertionError(f"analyze {what}: rc {rc}, stderr {log!r}\n{text}")
    say(f"[8b analyze] {what}: {seeds} seeds in {secs:.3f} s, {seeds / secs:.0f} seeds/s "
        f"(host wall clock, the process's start excluded); launches S1 "
        f"{launches['sweep_prng']}, S2 {launches['sweep_chain']} [{card}]")
    return text, launches


def result_line(text: str, name: str) -> str:
    for line in text.splitlines():
        if line.startswith("  ") and line[4:].startswith(f"{name}: "):
            return line[4 + len(name) + 2:]
    raise AssertionError(f"no {name} line in:\n{text}")


def phase_analyze(dev, rng, card: str) -> list:
    """8b: ``analyze`` through the command line at full width, planted keys
    from the host oracles; every run's launch counts."""
    from vuke_tpu_torch import provider

    runs = []
    running = lambda *names: "".join(f"Running {n} (brute-force)...\n" for n in names)

    def expect(text, name, status, details):
        got = result_line(text, name)
        if got != f"{status} ({details})":
            raise AssertionError(f"analyze {name}: {got!r}, expected {status} ({details})")

    seed = SPACE - 17
    text, l = analyze_cli(["0x" + host_milksad_key(seed).hex(), "--analyzer", "milksad"],
                          "milksad exact, key of seed 2^32 - 17", SPACE, card, running("milksad"))
    expect(text, "milksad", "CONFIRMED", f"seed = {seed}")
    runs.append(l)
    text, l = analyze_cli([rng.bytes(32).hex(), "--analyzer", "milksad"],
                          "milksad exact, a random key", SPACE, card, running("milksad"))
    expect(text, "milksad", "NOT_FOUND", f"checked {SPACE} seeds")
    runs.append(l)

    planted = SPACE - 1000 - int(rng.integers(0, 1000))
    key = rng.bytes(24) + host_milksad_key(planted)[24:]
    text, l = analyze_cli([key.hex(), "--analyzer", "milksad", "--mask", "40"],
                          "milksad --mask 40", SPACE, card, running("milksad"))
    found = int(result_line(text, "milksad").split("seed = ")[1].split(",")[0])
    if found > planted or apply_mask(host_milksad_key(found), 40) != apply_mask(key, 40):
        raise AssertionError(f"milksad --mask 40: seed {found}, planted {planted}")
    full = host_milksad_key(found).hex()
    expect(text, "milksad", "CONFIRMED",
           f"seed = {found}, full_key={full}, masked=0x{apply_mask(key, 40):x}, mask_bits=40, "
           f"formula=(key & 0xffffffffff) | 0x8000000000")
    runs.append(l)

    seed = lcg.BORLAND.max_seed - int(rng.integers(1, 1 << 16))
    seeds = sum(min(v.max_seed, SPACE - 1) + 1 for v in lcg.ALL_VARIANTS[:3]) + seed + 1
    text, l = analyze_cli([host_lcg_key(seed, lcg.BORLAND).hex(), "--analyzer", "lcg"],
                          "lcg, planted in borland near its max_seed", seeds, card,
                          running("lcg"))
    expect(text, "lcg", "CONFIRMED", f"variant=borland, seed={seed}, endian=be")
    runs.append(l)

    seed = SPACE - 1 - int(rng.integers(1, 1 << 16))
    key = host_chain_key(seed.to_bytes(4, "big"), "iterated", 7)
    text, l = analyze_cli([key.hex(), "--analyzer", "sha256_chain:iterated"],
                          "sha256_chain:iterated, depth 10, planted near the top at index 7",
                          seed + 1, card, running("sha256_chain"))
    expect(text, "sha256_chain", "CONFIRMED",
           f"seed={seed} (0x{seed:08x}), variant=iterated, chain_index=7")
    runs.append(l)

    seed = SPACE - 1 - int(rng.integers(1, 1 << 20))
    keys = [host_mt64_key(seed, 3)[32 * j:32 * j + 32] for j in range(3)]
    cascade = ",".join(f"{b}:0x{apply_mask(k, b):x}" for b, k in zip((24, 32, 40), keys))
    text, l = analyze_cli([rng.bytes(32).hex(), "--analyzer", "mt64", "--cascade", cascade,
                           "--max-seeds", str(SPACE)], "mt64 --cascade of 3 from a planted seed",
                          seed + 1, card, running("mt64"))
    desc = ",".join(f"P{b}:0x{apply_mask(k, b):x}" for b, k in zip((24, 32, 40), keys))
    expect(text, "mt64", "CONFIRMED", f"seed = {seed}, cascade=[{desc}]")
    runs.append(l)

    seed = SPACE - 1 - int(rng.integers(1, 1 << 20))
    keys = host_xorshift128p_keys(seed, 3)
    cascade = ",".join(f"{b}:0x{apply_mask(k, b):x}" for b, k in zip((24, 32, 40), keys))
    desc = ",".join(f"P{b}:0x{apply_mask(k, b):x}" for b, k in zip((24, 32, 40), keys))
    text, l = analyze_cli([rng.bytes(32).hex(), "--analyzer", "xorshift", "--cascade", cascade,
                           "--max-seeds", str(SPACE)],
                          "xorshift --cascade of 3 from a planted xorshift128+ seed",
                          3 * SPACE + seed + 1, card, running("xorshift"))
    expect(text, "xorshift", "CONFIRMED",
           f"variant=xorshift128+, seed={seed}, cascade=[{desc}]")
    runs.append(l)

    key = rng.bytes(32)
    rc, text, log, launches, secs = run_cli(["analyze", key.hex(), "--json"])
    got = {r["analyzer"]: (r["status"], r.get("details")) for r in json.loads(text)["results"]}
    lcg_seeds = sum(min(v.max_seed, SPACE - 1) + 1 for v in lcg.ALL_VARIANTS)
    if (rc != 0 or log != running("milksad", "mt64", "lcg", "xorshift", "sha256_chain")
            or got["milksad"] != ("not_found", f"checked {SPACE} seeds")
            or got["mt64"][0] != "unknown" or got["xorshift"][0] != "unknown"
            or got["lcg"] != ("not_found", f"checked {lcg_seeds} seeds across variants: "
                                           f"glibc, minstd, msvc, borland")
            or got["sha256_chain"] != ("not_found", f"checked {4 * SPACE} seeds, variants="
                                                    f"[iterated, indexed:be, indexed:le, "
                                                    f"counter], chain_depth=10")
            or list(got) != ["milksad", "mt64", "lcg", "xorshift", "sha256_chain", "direct",
                             "heuristic"]):
        raise AssertionError(f"default analyze: rc {rc}, stderr {log!r}\n{text}")
    say(f"[8b analyze] the default analyze of a random key, every analyzer (milksad 2^32, "
        f"lcg x4, sha256_chain x4 over 2^32 x depth 10; mt64 and xorshift UNKNOWN without a "
        f"cascade): {secs:.3f} s host wall clock; launches S1 {launches['sweep_prng']}, S2 "
        f"{launches['sweep_chain']} [{card}]")
    runs.append(launches)

    b1000 = {p.id: p for p in provider._collection("b1000")}
    key = bytes.fromhex(b1000[40].key_hex.rjust(64, "0"))
    text, l = analyze_cli([key.hex(), "--puzzle", "boha:b1000:40:3", "--analyzer", "milksad"],
                          "--puzzle boha:b1000:40:3 (mask 40, cascade of 3)", SPACE, card,
                          "Puzzle boha:b1000:40:3: auto-set mask to 40 bits\n"
                          "Puzzle boha:b1000:40:3: cascade from 3 solved neighbors\n"
                          + running("milksad"))
    expect(text, "milksad", "NOT_FOUND", f"checked {SPACE} seeds with cascade filter")
    runs.append(l)
    text, l = analyze_cli([key.hex(), "--cascade", "boha:b1000:67", "--analyzer", "mt64",
                           "--max-seeds", str(SPACE)],
                          "--cascade boha:b1000:67 (puzzles 62 and 63)", SPACE, card,
                          running("mt64"))
    c = provider.parse_cascade_ref("boha:b1000:67")
    line = result_line(text, "mt64")
    if (len(c) != 2 or not line.startswith(f"NOT_FOUND (searched {SPACE} seeds in ")
            or f"cascade=[{','.join(f'P{b}:0x{t:x}' for b, t in c)}], cascade_hits=" not in line):
        raise AssertionError(f"--cascade boha:b1000:67: {line}")
    runs.append(l)
    p21 = b1000[21]
    rc, text, log, _, _ = run_cli(["analyze", p21.key_hex, "--verify", "boha:b1000", "--fast"])
    if rc != 0 or not text.startswith(f"Key matches puzzle #21 in b1000 via p2pkh_compressed: "
                                      f"{p21.address}\n"):
        raise AssertionError(f"--verify boha:b1000: {text!r}")
    say(f"[8b analyze] --verify boha:b1000 with puzzle 21's key: 'Key matches puzzle #21 in "
        f"b1000 via p2pkh_compressed: {p21.address}' [{card}]")

    ckpt = kernels.BUILD_DIR / "smoke_analyze_ckpt.json"
    ckpt.unlink(missing_ok=True)
    seed = SPACE - 1 - int(rng.integers(1, 1 << 20))
    key = host_milksad_key(seed)
    argv = [key.hex(), "--analyzer", "milksad", "--checkpoint", str(ckpt)]
    text, l = analyze_cli(argv + ["--max-seeds", str(SPACE // 2)],
                          "milksad --checkpoint, the first half", SPACE // 2, card,
                          running("milksad"))
    expect(text, "milksad", "NOT_FOUND", f"checked {SPACE // 2} seeds")
    manifest = json.loads(ckpt.read_text())
    if manifest["completed"] != [[0, SPACE // 2 - 1]] or manifest["found_seed"] is not None:
        raise AssertionError(f"checkpoint after the first half: {manifest}")
    runs.append(l)
    text, l = analyze_cli(argv, "milksad --checkpoint, resumed", seed + 1 - SPACE // 2, card,
                          running("milksad"))
    expect(text, "milksad", "CONFIRMED", f"seed = {seed}")
    if json.loads(ckpt.read_text())["found_seed"] != seed:
        raise AssertionError("checkpoint: the found seed is not in the manifest")
    runs.append(l)
    return runs


def phase_provider_scan(card: str) -> dict:
    """8c: ``scan --transform direct:be --targets boha:b1000:solved`` over
    [2^20, 2^32 - 1]: exactly the solved puzzles whose key lies there."""
    from vuke_tpu_torch import provider

    b1000 = {p.id: p for p in provider._collection("b1000")}
    res = provider.resolve("boha:b1000:solved")
    lo, hi = 1 << 20, SPACE - 1
    want = sorted(p.id for p in b1000.values()
                  if p.solved and p.address and lo <= int(p.key_hex, 16) <= hi)
    rc, text, log, launches, secs = run_cli(
        ["scan", "--transform", "direct:be", "--targets", "boha:b1000:solved", "range",
         "--start", str(lo), "--end", str(hi)])
    hits = sorted(int(s) for s, _ in hit_sources(text))
    n = hi - lo + 1
    done = (f"Loaded {len(res.addresses)} target addresses from provider boha:b1000:solved\n"
            f"Scanning...\nDone. Inputs: {n}, Keys: {n}, Matches: {len(want)}\n")
    if (rc != 0 or log != done or res.skipped_offline != 0
            or hits != sorted(int(b1000[i].key_hex, 16) for i in want)):
        raise AssertionError(f"scan boha:b1000:solved: rc {rc}, stderr {log!r}, hits {hits}")
    say(f"[8c provider scan] direct:be [2^20, 2^32 - 1] vs boha:b1000:solved "
        f"({len(res.addresses)} addresses, {res.skipped_offline} skipped): exactly puzzles "
        f"{want[0]}..{want[-1]} ({len(want)} hits); {n / secs:.0f} keys/s ({secs:.2f} s host "
        f"wall clock); launches {launches} [{card}]")
    return launches

# ---------------------------------------------------------------------------
# phase 9: the wallet kernels W1 (csrc/pbkdf2_sha512.cu) and W2
# (csrc/electrum_stretch.cu) and the wallet paths
# ---------------------------------------------------------------------------

W1_KEYS = (0, 1, 127, 128, 129, 330)      # key lengths across the block edge
W1_SALTS = (b"mnemonic", b"mnemonicTREZOR", b"s" * 107)


def w1_passwords(rng, n: int) -> list:
    """The edge key lengths, then random keys of 0 to 200 bytes."""
    return ([bytes(rng.bytes(k)) for k in W1_KEYS]
            + [bytes(rng.bytes(int(rng.integers(0, 201)))) for _ in range(n - len(W1_KEYS))])


def w1_against_plain(dev, rng, n: int = W1_LANES) -> dict:
    """W1 against its plain version on the card at 2 and 7 iterations, on
    ``n`` candidates and every salt of ``W1_SALTS``: {iterations: max abs
    err}."""
    keys = pbkdf2_device.key_blocks(w1_passwords(rng, n)).to(dev)
    errs = {}
    for it in (2, 7):
        for salt in W1_SALTS:
            sb = pbkdf2_device._salt_block_words(salt)
            got = launched_once(pbkdf2_device.KERNEL,
                                lambda: pbkdf2_device.pbkdf2_sha512(keys, sb, it))
            want = pbkdf2_device.pbkdf2_sha512_plain(keys, sb, it)
            errs[it] = max(errs.get(it, 0), exact_err(f"W1 {it} iterations, salt {len(salt)} B",
                                                      [got], [want]))
    return errs


def w1_full(dev, rng, n: int = W1_FULL, sample: int = 256):
    """W1 at 2048 iterations on ``n`` candidates (one launch), ``sample``
    lanes against hashlib, and the BIP39 Trezor vector; returns the key
    blocks and the salt block (the timing's inputs)."""
    pws = w1_passwords(rng, n - 1) + [TREZOR[0].encode()]
    salt = b"mnemonicTREZOR"
    keys = pbkdf2_device.key_blocks(pws).to(dev)
    sb = pbkdf2_device._salt_block_words(salt)
    out = launched_once(pbkdf2_device.KERNEL, lambda: pbkdf2_device.pbkdf2_sha512(keys, sb))
    raw = np.ascontiguousarray(out.view(torch.int32).cpu().numpy().view(np.uint32).T)
    lanes = list(range(len(W1_KEYS))) + rng.choice(n - 1, sample, replace=False).tolist()
    for j in lanes + [n - 1]:
        if raw[j].astype(">u4").tobytes() != hashlib.pbkdf2_hmac("sha512", pws[j], salt, 2048):
            raise AssertionError(f"W1 at 2048 iterations: lane {j} differs from hashlib")
    if raw[n - 1].astype(">u4").tobytes().hex() != TREZOR[1]:
        raise AssertionError("W1: the BIP39 Trezor vector differs")
    return keys, sb, len(lanes) + 1


def phase_w1(dev, rng, card: str, int_ops_per_s: float):
    """9a: W1 against its plain version and hashlib; its time, bound and
    share at 2048 iterations, and, for the kernels line, at 7 iterations
    beside its plain version (which cannot run 2048 in the time limit)."""
    t0 = time.perf_counter()
    errs = w1_against_plain(dev, rng)
    keys, sb, checked = w1_full(dev, rng)
    n = W1_FULL
    ms = time_cuda(lambda: pbkdf2_device.pbkdf2_sha512(keys, sb), iters=3, warmup=1)
    # CUPTI now and then records none of these ~63 ms launches (as it
    # records none of W2's): the share is then taken against the events
    dev_ms = launch_device_ms(lambda: pbkdf2_device.pbkdf2_sha512(keys, sb),
                              pbkdf2_device.KERNEL, iters=3, missing_ok=True)
    how = "device (profiler)"
    if dev_ms is None:
        dev_ms, how = ms, "by CUDA events (the profiler recorded no launch)"
    ops = work.pbkdf2_sha512(2048)
    bound_ms, _, limit = bound_of(192 * n, ops, n, int_ops_per_s)
    k7 = keys[:, :W1_LANES].contiguous()
    ms7 = time_cuda(lambda: pbkdf2_device.pbkdf2_sha512(k7, sb, 7), iters=10, warmup=2)
    t1 = time.perf_counter()
    pbkdf2_device.pbkdf2_sha512_plain(k7, sb, 7)
    torch.cuda.synchronize()
    plain7 = (time.perf_counter() - t1) * 1e3
    bound7, by7, _ = bound_of(192 * W1_LANES, work.pbkdf2_sha512(7), W1_LANES, int_ops_per_s)
    say(f"[9a W1 pbkdf2_sha512] {W1_LANES} candidates (keys of {list(W1_KEYS)} bytes and "
        f"random ones, salts of 8, 14 and 107 bytes): kernel == plain at 2 and 7 iterations "
        f"(max abs err 0); {n} candidates at 2048 iterations, {checked} lanes == "
        f"hashlib.pbkdf2_hmac and the BIP39 Trezor vector; {time.perf_counter() - t0:.1f} s")
    say(f"[9a W1 time] {n} candidates x 2048 iterations: kernel {ms:.3f} ms (CUDA events), "
        f"{dev_ms:.3f} ms {how}, {n / dev_ms * 1e3:.4g} PBKDF2/s; bound "
        f"{bound_ms:.3f} ms by {limit} ({100 * bound_ms / dev_ms:.1f}% of the device time; a "
        f"lane needs {ops.alu:.4g} ALU, {ops.add:.4g} adds); at 7 iterations on {W1_LANES}: "
        f"kernel {ms7:.4f} ms, plain {plain7:.1f} ms, bound {bound7:.4f} ms [{card}]")
    return max(errs.values()), (ms7, plain7, bound7, by7)


def w2_inputs(rng, length: int, n: int):
    """``n`` seeds of ``length`` random bytes (the first the ASCII of the
    official Electrum seed where the length fits): (seeds, x0 (8, n), seed
    words)."""
    seeds = [bytes(rng.bytes(length)) for _ in range(n)]
    if length == 32:
        seeds[0] = ELECTRUM_SEED.encode()
    raw = b"".join(hashlib.sha256(sd + sd).digest() for sd in seeds)
    w = np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(n, 8)
    x0 = torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)).view(torch.uint32)
    return seeds, x0, electrum.seed_words(seeds)


def w2_against_plain(dev, rng, n: int = W2_LANES) -> int:
    """W2 against its plain version on the card at 1, 2 and 17 rounds for
    each length of ``W2_LENGTHS`` (one block to 23 bytes, two to 87, three
    beyond; 32: the padding block alone): max abs err."""
    err = 0
    for length in W2_LENGTHS:
        _, x0, sw = w2_inputs(rng, length, n)
        x0, sw = x0.to(dev), sw.to(dev)
        for rounds in (1, 2, 17):
            got = launched_once(electrum.KERNEL, lambda: electrum.stretch(x0, sw, length, rounds))
            err = max(err, exact_err(f"W2 length {length}, {rounds} rounds",
                                     [got], [electrum.stretch_plain(x0, sw, length, rounds)]))
    return err


def w2_full(dev, rng, n: int = 64):
    """W2 at 99,999 rounds on ``n`` seeds of 10 and of 32 bytes against
    ``electrum.stretch_key`` (hashlib), the official Electrum seed among
    them, and its master public key through ``master_pubkeys_device`` (K3
    -> K4 on the card)."""
    for length in (10, 32):
        seeds = w2_inputs(rng, length, n)[0]
        got = electrum.stretch_keys_device(seeds, dev)
        for j, sd in enumerate(seeds):
            if got[j] != electrum.stretch_key(sd):
                raise AssertionError(f"W2 at 99,999 rounds: seed {sd!r} differs from hashlib")
    mpk = electrum.master_pubkeys_device(got[:1], dev)[0]
    if mpk.hex() != ELECTRUM_MPK:
        raise AssertionError(f"the Electrum seed's master public key: {mpk.hex()}")


def phase_w2(dev, rng, card: str, int_ops_per_s: float):
    """9b: W2 against its plain version and hashlib; its time on 2^16
    10-byte seeds and 2^14 32-byte ones with bound and share, and, for the
    kernels line, at 17 rounds beside its plain version."""
    t0 = time.perf_counter()
    err = w2_against_plain(dev, rng)
    w2_full(dev, rng)
    say(f"[9b W2 electrum_stretch] {W2_LANES} seeds of each length {list(W2_LENGTHS)}: kernel "
        f"== plain at 1, 2 and 17 rounds (max abs err 0); 64 seeds of 10 and of 32 bytes at "
        f"99,999 rounds == electrum.stretch_key (hashlib); the official seed's master public "
        f"key (master_pubkeys_device: K3 -> K4) == {ELECTRUM_MPK[:16]}...; "
        f"{time.perf_counter() - t0:.1f} s")
    for length, n in ((10, 1 << 16), (32, 1 << 14)):
        _, x0, sw = w2_inputs(rng, length, n)
        x0, sw = x0.to(dev), sw.to(dev)
        # CUDA events alone: torch.profiler recorded none of these half-second
        # launches in a trial run, and the host's share of events around one
        # is below 0.01%
        ms = time_cuda(lambda: electrum.stretch(x0, sw, length), iters=2, warmup=1)
        ops = work.electrum_stretch(length, electrum.ROUNDS)
        bound_ms, _, limit = bound_of((64 + 4 * sw.shape[0]) * n, ops, n, int_ops_per_s)
        say(f"[9b W2 time] {n} seeds of {length} bytes x 99,999 rounds: kernel {ms:.2f} ms "
            f"(CUDA events), {n / ms * 1e3:.4g} seeds/s; bound {bound_ms:.2f} ms by {limit} "
            f"({100 * bound_ms / ms:.1f}% of the kernel time; a lane needs {ops.alu:.4g} ALU, "
            f"{ops.add:.4g} adds) [{card}]")
    _, x0, sw = w2_inputs(rng, 10, W2_LANES)
    x0, sw = x0.to(dev), sw.to(dev)
    ms17 = time_cuda(lambda: electrum.stretch(x0, sw, 10, 17), iters=10, warmup=2)
    t1 = time.perf_counter()
    electrum.stretch_plain(x0, sw, 10, 17)
    torch.cuda.synchronize()
    plain17 = (time.perf_counter() - t1) * 1e3
    bound17, by17, _ = bound_of((64 + 12) * W2_LANES, work.electrum_stretch(10, 17), W2_LANES,
                                int_ops_per_s)
    say(f"[9b W2 time] {W2_LANES} seeds of 10 bytes x 17 rounds: kernel {ms17:.4f} ms, plain "
        f"{plain17:.1f} ms, bound {bound17:.5f} ms [{card}]")
    return err, (ms17, plain17, bound17, by17)


def phase_electrum_scan(dev, rng, card: str, decoys: list) -> dict:
    """9c: ``scan --transform electrum`` over ``ELECTRUM_SEEDS`` unix
    timestamps (a range source: each one's decimal string, 1000 a batch,
    one length, so W2 once a batch) with one key planted at derivation
    index 7: exactly that hit, the JAX command line's stderr; W2 once a
    batch; the seeds/s."""
    start = 1_400_000_000 + int(rng.integers(0, 1 << 20))
    end = start + ELECTRUM_SEEDS - 1
    planted = start + int(rng.integers(0, ELECTRUM_SEEDS))
    key = electrum.ElectrumDeriver.from_hex_seed(str(planted)).derive_key(7)
    addr = KeyDeriver().derive(key).p2pkh_uncompressed
    targets = write_targets("electrum_targets.txt", [addr], decoys)
    rc, text, log, launches, secs = run_cli(
        ["scan", "--transform", "electrum", "--targets", targets, "range", "--start", str(start),
         "--end", str(end)])
    batches = -(-ELECTRUM_SEEDS // 1000)
    want = (f"Loaded {len(decoys) + 1} target addresses\nScanning...\nDone. Inputs: "
            f"{ELECTRUM_SEEDS}, Keys: {20 * ELECTRUM_SEEDS}, Matches: 1\n")
    if (rc != 0 or log != want or hit_sources(text) != [(f"{planted}[0/7]", "electrum")]
            or launches["electrum_stretch"] != batches or launches["smul"] < 2 * batches):
        raise AssertionError(f"electrum scan: rc {rc}, stderr {log!r}, hits "
                             f"{hit_sources(text)}, launches {launches}")
    say(f"[9c electrum scan] {ELECTRUM_SEEDS} timestamps from {start}: exactly the planted "
        f"{planted}[0/7]; {ELECTRUM_SEEDS / secs:.0f} seeds/s ({20 * ELECTRUM_SEEDS / secs:.0f} "
        f"keys/s, {secs:.2f} s host wall clock); launches W2 {launches['electrum_stretch']} "
        f"(one a 1000-seed batch), K3 {launches['smul']}, K4 {launches['inv_affine']}, K2 "
        f"{launches['hash160']} [{card}]")
    return launches


def phase_multibit(dev, rng, card: str) -> dict:
    """9d: ``analyze --analyzer multibit-hd --mnemonic-file`` over
    ``MNEMONICS`` valid mnemonics with the MultiBit bug vector planted on
    the last line: CONFIRMED with its line, W1 twice (one chunk); then
    ``bench_wallet("multibit")`` over 1024 of them beside the hashlib host
    path (the BIP32 tail is Python EC: ~6 ms a mnemonic)."""
    from vuke_tpu_torch.benchmark import bench_wallet, seeded_mnemonics

    path = kernels.BUILD_DIR / "smoke_mnemonics.txt"
    path.write_text("\n".join(seeded_mnemonics(MNEMONICS - 1, int(rng.integers(1 << 30)))
                              + [MNEMONIC_445]) + "\n")
    idx = int(rng.integers(0, 20))
    key = multibit.multibit_hd_keys(MNEMONIC_445, "", idx + 1)[idx]
    rc, text, log, launches, secs = run_cli(["analyze", key.hex(), "--analyzer", "multibit-hd",
                                             "--mnemonic-file", str(path)])
    want = (f"CONFIRMED (mnemonic=\"skin join dog ... poverty boy elbow\", "
            f"path=m/0'/0/{idx}, line={MNEMONICS})")
    if (rc != 0 or log != "Running multibit-hd (brute-force)...\n"
            or result_line(text, "multibit-hd") != want or launches["pbkdf2_sha512"] != 2):
        raise AssertionError(f"analyze multibit-hd: rc {rc}, stderr {log!r}, launches "
                             f"{launches}\n{text}")
    say(f"[9d multibit-hd] --mnemonic-file of {MNEMONICS} valid mnemonics, the MultiBit "
        f"bug vector on the last line: {want}; {MNEMONICS / secs:.0f} mnemonics/s ({secs:.2f} "
        f"s host wall clock); W1 launches {launches['pbkdf2_sha512']} (two a 4096 chunk) "
        f"[{card}]")
    b = bench_wallet("multibit", n=1024)
    say(f"[9d bench_wallet multibit] {json.dumps(b)} [{card}]")
    return launches


def phase_wallet_scans(dev, rng, card: str, decoys: list) -> list:
    """9e: planted scans of armory (a range, its host-only numeric path),
    multibit (a wordlist) and bitimage (files with two addresses a
    passphrase), then ``generate --transform electrum`` over 4 seeds
    against the host ``KeyDeriver``."""
    from vuke_tpu_torch.benchmark import seeded_mnemonics
    from vuke_tpu_torch.wallets import armory, bitimage

    runs = []
    start = int(rng.integers(1 << 20, 1 << 40))
    seed = start + int(rng.integers(0, 256))
    key = armory.armory_key(seed.to_bytes(32, "big"))
    targets = write_targets("armory_targets.txt", [KeyDeriver().derive(key).p2pkh_compressed],
                            decoys)
    rc, text, log, launches, secs = run_cli(
        ["scan", "--transform", "armory", "--targets", targets, "range", "--start", str(start),
         "--end", str(start + 255)])
    if rc != 0 or hit_sources(text) != [(str(seed), "armory")] or launches["smul"] < 1:
        raise AssertionError(f"armory scan: rc {rc}, stderr {log!r}, hits {hit_sources(text)}")
    runs.append(launches)
    say(f"[9e armory] range of 256 seeds from {start}, two slots, the host computing the keys: "
        f"exactly {seed}; {secs:.2f} s; launches K3 {launches['smul']}, K2 "
        f"{launches['hash160']} [{card}]")

    words = seeded_mnemonics(200, int(rng.integers(1 << 30))) + [MNEMONIC_445, "not a mnemonic"]
    wl = kernels.BUILD_DIR / "smoke_multibit_words.txt"
    wl.write_text("\n".join(words) + "\n")
    key = multibit.multibit_hd_keys(MNEMONIC_445, "", 13)[12]
    targets = write_targets("multibit_targets.txt", [KeyDeriver().derive(key).p2wpkh], decoys)
    rc, text, log, launches, secs = run_cli(["scan", "--transform", "multibit", "--targets",
                                             targets, "wordlist", "--file", str(wl)])
    if rc != 0 or hit_sources(text) != [("skin join...boy elbow[m/0'/0/12]", "multibit")]:
        raise AssertionError(f"multibit scan: rc {rc}, stderr {log!r}, hits {hit_sources(text)}")
    runs.append(launches)
    say(f"[9e multibit] wordlist of {len(words)} lines (201 valid mnemonics): exactly "
        f"skin join...boy elbow[m/0'/0/12]; {secs:.2f} s; launches K3 {launches['smul']} "
        f"[{card}]")

    d = kernels.BUILD_DIR / "smoke_bitimage"
    d.mkdir(parents=True, exist_ok=True)
    blobs = [bytes(rng.bytes(int(rng.integers(1, 5000)))) for _ in range(3)]
    for i, blob in enumerate(blobs):
        (d / f"img{i}.bin").write_bytes(blob)
    pp = kernels.BUILD_DIR / "smoke_passphrases.txt"
    pp.write_text("alpha\nbeta\n")
    key = bitimage.BitimageDeriver(blobs[2], "beta").derive_path("m/84'/0'/0'/0/1")
    targets = write_targets("bitimage_targets.txt", [KeyDeriver().derive(key).p2wpkh], decoys)
    rc, text, log, launches, secs = run_cli(
        ["scan", "--transform", "bitimage", "--targets", targets, "--bitimage-derive-count", "2",
         "--bitimage-passphrase-wordlist", str(pp), "files", "--dir", str(d)])
    if rc != 0 or hit_sources(text) != [(f"{d / 'img2.bin'}:beta[m/84'/0'/0'/0/1]", "bitimage")]:
        raise AssertionError(f"bitimage scan: rc {rc}, stderr {log!r}, hits {hit_sources(text)}")
    runs.append(launches)
    say(f"[9e bitimage] 3 files x 2 passphrases x 2 addresses: exactly img2.bin:beta"
        f"[m/84'/0'/0'/0/1] (host derive) [{card}]")

    rc, text, log, launches, secs = run_cli(["generate", "--transform", "electrum", "range",
                                             "--start", "1", "--end", "4"])
    lines = text.splitlines()
    if rc != 0 or len(lines) != 80:
        raise AssertionError(f"generate electrum: rc {rc}, {len(lines)} lines, {log!r}")
    for j, line in enumerate(lines):
        d_ = electrum.ElectrumDeriver.from_hex_seed(str(j // 20 + 1))
        if line != host_line(line, d_.derive_key(j % 20)) or not line.startswith(
                f"{j // 20 + 1}[0/{j % 20}],electrum,"):
            raise AssertionError(f"generate electrum line {j}: {line}")
    runs.append(launches)
    say(f"[9e generate electrum] 4 seeds: 80 lines == the host KeyDeriver, in the JAX order; "
        f"launches K3 {launches['smul']}, D2 {launches['p2pkh']} [{card}]")
    return runs


def phase_long_cascade(card: str) -> dict:
    """8b (R1): ``analyze --cascade`` of ``CASCADE`` targets from a planted
    milksad seed's own keys through the command line, over the full u32
    space: CONFIRMED."""
    rng = np.random.default_rng(40)
    seed = SPACE - 1 - int(rng.integers(1, 1 << 20))
    raw = np.random.RandomState(seed).bytes(32 * CASCADE)
    keys = [raw[32 * j:32 * j + 32] for j in range(CASCADE)]
    bits = [24 + j for j in range(CASCADE)]      # the command line sorts targets by bits
    cascade = ",".join(f"{b}:0x{apply_mask(k, b):x}" for b, k in zip(bits, keys))
    text, launches = analyze_cli([rng.bytes(32).hex(), "--analyzer", "milksad", "--cascade",
                                  cascade], f"milksad --cascade of {CASCADE} targets", SPACE,
                                 card, "Running milksad (brute-force)...\n")
    if not result_line(text, "milksad").startswith(f"CONFIRMED (seed = {seed}, cascade=["):
        raise AssertionError(f"milksad --cascade of {CASCADE}: {result_line(text, 'milksad')}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the storage tail, with E1 (csrc/records.cu)
# ---------------------------------------------------------------------------

def record_edge_keys(rng) -> list:
    """Normalized keys at E1's edges: 1, 2, 9, 10^9 - 1, 10^9, 2^32, 2^255,
    n - 1, 2^256 - 1 - n, and keys with 1 to 31 leading zero bytes."""
    keys = [1, 2, 9, 10 ** 9 - 1, 10 ** 9, 1 << 32, 1 << 255, N - 1, (1 << 256) - 1 - N]
    return keys + [int.from_bytes(b"\0" * z + b"\x01" + rng.bytes(31 - z), "big")
                   for z in range(1, 32)]


def record_inputs(rng, n: int):
    """(8, n) key words (random below 2^255, the edge keys first) and two
    (5, n) digests (random; rows 100..103 with 20, 8, 2 and 1 leading zero
    bytes, so that P2PKH addresses start with several '1's), on the CPU."""
    keys = record_edge_keys(rng)
    kw = rng.integers(0, 1 << 32, (8, n), dtype=np.uint32)
    kw[0] &= 0x7FFFFFFF
    kw[:, :len(keys)] = words_be(keys).numpy()
    h = rng.integers(0, 1 << 32, (2, 5, n), dtype=np.uint32)
    for row, zero_bytes in zip(range(100, 104), (20, 8, 2, 1)):
        b = bytearray(rng.bytes(20))
        b[:zero_bytes] = bytes(zero_bytes)
        h[:, :, row] = np.frombuffer(bytes(b), dtype="<u4")
    as_u32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).view(torch.uint32)
    return as_u32(kw), as_u32(h[0]), as_u32(h[1]), len(keys)


def record_row_strings(rows: np.ndarray, j: int) -> dict:
    out = {name: bytes(rows[j, off:off + w]).rstrip(b"\0").decode()
           for name, off, w in records.FIELDS}
    st = rows[j, records.STATS:records.STATS + 5].astype(int)
    out["stats"] = (st[0] | st[1] << 8, st[2] | st[3] << 8, st[4])
    return out


def derived_strings(d) -> dict:
    return {"private_key_decimal": d.private_key_decimal, "wif_compressed": d.wif_compressed,
            "wif_uncompressed": d.wif_uncompressed,
            "address_p2pkh_compressed": d.p2pkh_compressed,
            "address_p2pkh_uncompressed": d.p2pkh_uncompressed, "address_p2wpkh": d.p2wpkh,
            "stats": (d.bit_length, d.hamming_weight, d.leading_zeros)}


def phase_records(dev, rng, card: str, int_ops_per_s: float, pipes: dict):
    """10a: E1 against ``records_plain`` on the card at the generate path's
    batch and at the tail sizes (1, 255, 257, 1869: E1's tile is 64
    records) on every network, lane-exact, the edge keys and digests among
    the lanes; 256 lanes of the derive path (``pipeline.derive_records``)
    against ``KeyDeriver.derive`` on each network; E1's time, bound and
    share; then ``generate -v`` (E1 on the path without pyarrow) against
    the host."""
    k, hc, hu, n_edge = record_inputs(rng, BATCH)
    kd, hcd, hud = k.to(dev), hc.to(dev), hu.to(dev)
    plain_ms = None
    for net in encode.NETWORKS.values():
        for n in TAILS:
            part = [t[:, :n].contiguous() for t in (kd, hcd, hud)]
            got = launched_once(records.KERNEL, lambda: records.encode_records(*part, net))
            if not torch.equal(got, records.records_plain(*part, net)):
                raise AssertionError(f"E1 {net.name} at n = {n}: rows differ from "
                                     f"records_plain")
        got = launched_once(records.KERNEL, lambda: records.encode_records(kd, hcd, hud, net))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = records.records_plain(kd, hcd, hud, net)
        torch.cuda.synchronize()
        plain_ms = plain_ms or (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero().flatten().tolist()
            raise AssertionError(f"E1 {net.name}: {len(bad)} rows differ from records_plain: "
                                 f"{bad[:8]}")
        rows = got.cpu().numpy()
        for j in range(n_edge):
            key = lane_int_be(k, j).to_bytes(32, "big")
            d = KeyDeriver(net).derive(key)
            want_j = derived_strings(d)
            got_j = record_row_strings(rows, j)
            for name in ("private_key_decimal", "wif_compressed", "wif_uncompressed", "stats"):
                if got_j[name] != want_j[name]:
                    raise AssertionError(f"E1 {net.name} edge key {j} {name}: {got_j[name]} "
                                         f"!= {want_j[name]}")
        for j in range(100, 104):
            hb = bytes(hc[:, j].numpy().astype("<u4").tobytes())
            if record_row_strings(rows, j)["address_p2pkh_compressed"] != p2pkh_address(hb, net):
                raise AssertionError(f"E1 {net.name} row {j}: P2PKH of a digest with leading "
                                     f"zero bytes differs")
    words = torch.from_numpy(rng.integers(0, 1 << 32, (8, 4096), dtype=np.uint32)
                             .view(np.int32)).view(torch.uint32).to(dev)
    for net in encode.NETWORKS.values():
        norm, x, y, rows = pipeline.derive_records(words, net)
        host = lambda t: t.T.contiguous().view(torch.int32).cpu().numpy().view(np.uint32)
        block = records.RecordBlock("t", [str(j) for j in range(4096)], host(norm), host(x),
                                    host(y), rows.cpu().numpy())
        lanes = rng.choice(4096, 256, replace=False).tolist()
        derived = block.derived()
        deriver = KeyDeriver(net)
        bad = [j for j in lanes if derived[j] != deriver.derive(derived[j].raw)]
        if bad:
            raise AssertionError(f"E1 {net.name}: derive_records lanes {bad[:8]} differ from "
                                 f"KeyDeriver.derive")
    say(f"[10a E1 records] {BATCH} lanes (the edge keys 1, 2, 9, 10^9 - 1, 10^9, 2^32, 2^255, "
        f"n - 1, 2^256 - 1 - n and 1..31 leading zero bytes; digests with 20, 8, 2, 1 leading "
        f"zero bytes) on bitcoin, testnet, signet, regtest: kernel == records_plain "
        f"byte-exact on every row (max abs err 0), and at n = {', '.join(map(str, TAILS))}; "
        f"the edge keys' decimal, WIFs and statistics == KeyDeriver; 256 lanes a network of "
        f"derive_records (K3 -> K4 -> K2 -> E1) == KeyDeriver.derive string for string [{card}]")
    ms = time_cuda(lambda: records.encode_records(kd, hcd, hud), iters=20, warmup=3)
    dev_ms = launch_device_ms(lambda: records.encode_records(kd, hcd, hud), records.KERNEL)
    ops = work.records()
    nbytes = (32 + 20 + 20 + records.ROW) * BATCH
    bound_ms, bound_by, limit = bound_of(nbytes, ops, BATCH, int_ops_per_s)
    sass_p = pipes["records"]
    say(f"[10a E1 time] {BATCH} lanes: kernel {ms:.4f} ms (CUDA events), {dev_ms:.4f} ms device "
        f"(profiler), plain {plain_ms:.1f} ms (torch ops on the card), bound {bound_ms:.4f} ms "
        f"by {limit} ({100 * bound_ms / dev_ms:.1f}% of the device time; needs a lane "
        f"{ops.mul:.0f} multiplies, {ops.alu:.0f} ALU, {ops.add:.0f} adds; {nbytes / BATCH:.0f} "
        f"B; SASS, the function's code once (role 0, one base58check thread): "
        f"{sass_p.alu:.0f} ALU, {sass_p.fma:.0f} FMA 2-cycle units, {sass_p.issued:.0f} in "
        f"all) [{card}]")
    start = 10 ** 9 + int(rng.integers(0, 1 << 20))
    rc, text, log, launches, secs = run_cli(
        ["generate", "-v", "--transform", "md5", "--network", "testnet", "range", "--start",
         str(start), "--end", str(start + 4095)])
    blocks = text.split("---\n")[1:]
    if rc != 0 or len(blocks) != 4096:
        raise AssertionError(f"generate -v: rc {rc}, {len(blocks)} blocks, stderr {log!r}")
    check_launches("generate -v", launches, {"records": 1, "p2pkh": 0, "keygen_hash": 1})
    deriver = KeyDeriver(encode.TESTNET)
    for j in rng.choice(4096, 64, replace=False).tolist():
        d = deriver.derive(host_hash_keys("md5", start + j)[0])
        want = (f"source: {start + j}\ntransform: md5\nprivate_key: {d.private_key_hex}\n"
                f"wif_compressed: {d.wif_compressed}\nwif_uncompressed: {d.wif_uncompressed}\n"
                f"p2pkh_compressed: {d.p2pkh_compressed}\n"
                f"p2pkh_uncompressed: {d.p2pkh_uncompressed}\np2wpkh: {d.p2wpkh}\n")
        if blocks[j] != want:
            raise AssertionError(f"generate -v block {j}: {blocks[j]!r} != {want!r}")
    say(f"[10a generate -v] md5 over 4096 seeds on testnet: 4096 blocks, 64 sampled == host "
        f"KeyDeriver; E1 once, D2 never; {secs:.2f} s [{card}]")
    return 0, (ms, plain_ms, bound_ms, bound_by), launches


def storage_lines(log: str, directory: str) -> list:
    """The chunk paths of the ``Storage:`` lines on stderr, each checked
    against its file's size, and the total."""
    lines = log.splitlines()
    i = next(j for j, line in enumerate(lines) if line.startswith("Storage: "))
    n = int(lines[i].split()[1])
    paths, total = [], 0
    for line in lines[i + 1:i + 1 + n]:
        path, size = line.strip().rsplit(" (", 1)
        if size != f"{cli._format_bytes(os.path.getsize(path))})":
            raise AssertionError(f"storage: {line!r} is not the size of {path}")
        paths.append(path)
        total += os.path.getsize(path)
    if lines[i] != f"Storage: {n} files written ({cli._format_bytes(total)})":
        raise AssertionError(f"storage: {lines[i]!r} is not the {n} files' total")
    on_disk = sorted(str(p) for p in __import__("pathlib").Path(directory).rglob("*.parquet"))
    if sorted(paths) != on_disk:
        raise AssertionError(f"storage: stderr names {len(paths)} chunks, {len(on_disk)} on disk")
    return paths


def host_record(source: str, transform: str, key: bytes, matched=None) -> dict:
    """The record the JAX package writes for ``key``, without ``timestamp``."""
    d = KeyDeriver().derive(key)
    return {"source": source, "transform": transform, "chain": "bitcoin",
            "matched_target": matched, "private_key_raw": d.raw,
            "private_key_hex": d.private_key_hex, "private_key_decimal": d.private_key_decimal,
            "private_key_binary": d.private_key_binary, "private_key_bit_length": d.bit_length,
            "private_key_hamming_weight": d.hamming_weight,
            "private_key_leading_zeros": d.leading_zeros,
            "pubkey_compressed": d.pubkey_compressed, "pubkey_uncompressed": d.pubkey_uncompressed,
            "address_p2pkh_compressed": d.p2pkh_compressed,
            "address_p2pkh_uncompressed": d.p2pkh_uncompressed, "address_p2wpkh": d.p2wpkh,
            "wif_compressed": d.wif_compressed, "wif_uncompressed": d.wif_uncompressed}


def pa_equal(table, column: str, value: str):
    import pyarrow.compute as pc

    return pc.equal(table[column], value)


def read_records(paths: list):
    """The chunks' records in order (each transform's chunks in order), each
    file read alone (no Hive partition columns from its path)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    return pa.concat_tables([pq.ParquetFile(p).read() for p in paths])


def phase_storage(dev, rng, card: str) -> list:
    """10b: ``generate --storage`` over 2^20 sha256 seeds, then sha256 and
    milksad with ``--chunk-records 300000``: one record a line, the chunks
    on stderr, 256 sampled records == the host; ``scan --storage`` with a
    planted key: one record, ``matched_target`` set; ``query`` on a
    65,536-record run (the sqlite fallback loads every row); E1's launches
    on every run; then ``bench_storage``'s split, into a directory holding
    a file it must leave."""
    from vuke_tpu_torch.benchmark import bench_storage
    import shutil

    base = kernels.BUILD_DIR / "smoke_storage"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    runs = []
    start = 3_000_000_000 + int(rng.integers(0, 1 << 20))     # milksad takes u32 seeds
    for tag, transforms, extra, want_e1 in (
            ("sha256", ["sha256"], [], 2 * 3),
            ("sha256+milksad", ["sha256", "milksad"], ["--chunk-records", "300000"], 2 * 4)):
        d, lines_path = str(base / tag), str(base / f"{tag}.txt")
        argv = ["generate", "-o", lines_path, "--storage", d, *extra]
        for t in transforms:
            argv += ["--transform", t]
        end = start + STORAGE_SEEDS - 1
        rc, text, log, launches, secs = run_cli(argv + ["range", "--start", str(start), "--end",
                                                       str(end)])
        n_keys = STORAGE_SEEDS * (3 + (len(transforms) > 1))
        if rc != 0 or not log.startswith(f"Generating keys...\nDone. Inputs: "
                                         f"{len(transforms) * STORAGE_SEEDS}, Keys: {n_keys}, "
                                         f"Matches: 0\n\nStorage: "):
            raise AssertionError(f"generate --storage {tag}: rc {rc}, stderr {log[:300]!r}")
        check_launches(f"generate --storage {tag}", launches,
                       {"records": want_e1, "p2pkh": 0, "hash160": want_e1})
        paths = storage_lines(log, d)
        with open(lines_path) as f:
            lines = f.read().splitlines()
        table = read_records(paths)
        if table.num_rows != len(lines) or len(lines) != n_keys:
            raise AssertionError(f"generate --storage {tag}: {table.num_rows} records, "
                                 f"{len(lines)} lines, {n_keys} keys")
        if len(transforms) > 1:
            for t in transforms:
                counts = [read_records([p]).num_rows for p in paths if f"transform={t}" in p]
                if max(counts) > 300000 or sum(counts) != STORAGE_SEEDS * (3 if t == "sha256"
                                                                           else 1):
                    raise AssertionError(f"--chunk-records 300000: {t} chunks {counts}")
        # each transform's records are its lines, in order
        for t in transforms:
            t_lines = [line for line in lines if line.split(",")[1] == t]
            t_rows = table.filter(pa_equal(table, "transform", t)).drop_columns(["timestamp"])
            for j in rng.choice(len(t_lines), 256 // len(transforms), replace=False).tolist():
                source, name, key_hex, addr = t_lines[j].split(",")
                seed = int(source)
                keys = (host_hash_keys("sha256", seed) if t == "sha256"
                        else [host_milksad_key(seed)])
                if key_hex not in [KeyDeriver().derive(k).private_key_hex for k in keys]:
                    raise AssertionError(f"generate --storage {tag}: line {t_lines[j]!r} is "
                                         f"not a key of seed {seed}")
                row = t_rows.slice(j, 1).to_pylist()[0]
                if row != host_record(source, name, bytes.fromhex(key_hex)):
                    raise AssertionError(f"generate --storage {tag}: record {j} of {t} "
                                         f"differs from the host: {row}")
                if addr != row["address_p2pkh_compressed"]:
                    raise AssertionError(f"generate --storage {tag}: line {t_lines[j]!r} "
                                         f"and its record differ in the address")
        nbytes = sum(os.path.getsize(p) for p in paths)
        shutil.rmtree(d, ignore_errors=True)
        os.remove(lines_path)
        runs.append(launches)
        say(f"[10b generate --storage] {tag} over {STORAGE_SEEDS} seeds{' ' + ' '.join(extra) if extra else ''}: "
            f"{table.num_rows} records == {len(lines)} lines, {len(paths)} chunks "
            f"({nbytes} B) as stderr names them, 256 sampled records == host KeyDeriver "
            f"(every column but timestamp) and == their lines; E1 {launches['records']} "
            f"launches, D2 0; {secs:.2f} s [{card}]")
    # scan --storage: the planted key's record alone
    seed = start + 12345
    target = KeyDeriver().derive(host_hash_keys("sha256", seed)[1]).p2pkh_compressed
    tpath = write_targets("smoke_storage_targets.txt", [target],
                          [p2pkh_address(rng.bytes(20)) for _ in range(4096)])
    d = str(base / "scan")
    rc, text, log, launches, secs = run_cli(
        ["scan", "--transform", "sha256", "--targets", tpath, "--storage", d, "range",
         "--start", str(start), "--end", str(start + (1 << 19) - 1)])
    table = read_records(storage_lines(log, d)).drop_columns(["timestamp"]).to_pylist()
    want = host_record(str(seed), "sha256", host_hash_keys("sha256", seed)[1], target)
    if rc != 0 or text.count("========== HIT") != 1 or table != [want]:
        raise AssertionError(f"scan --storage: rc {rc}, {len(table)} records: {table[:2]}")
    check_launches("scan --storage", launches, {"records": 0, "hash160": None})
    runs.append(launches)
    say(f"[10b scan --storage] sha256 over 2^19 seeds, one key planted: exactly one record, "
        f"matched_target {target}, every column == the host; E1 0 launches [{card}]")
    # query on a 65,536-record run
    d = str(base / "query")
    rc, _, log, launches, _ = run_cli(
        ["generate", "-o", os.devnull, "--transform", "md5", "--storage", d, "range", "--start",
         str(start), "--end", str(start + QUERY_RECORDS - 1)])
    check_launches("generate --storage md5", launches, {"records": 1})
    runs.append(launches)
    sql = "SELECT transform, COUNT(*) AS n FROM results GROUP BY transform"
    t0 = time.perf_counter()
    rc, text, log, launches, _ = run_cli(["query", d, sql, "--format", "csv"])
    qs = time.perf_counter() - t0
    if rc != 0 or text != f"transform,n\nmd5,{QUERY_RECORDS}\n":
        raise AssertionError(f"query: rc {rc}, {text!r}")
    if any(launches.values()):
        raise AssertionError(f"query launched kernels: {launches}")
    from vuke_tpu_torch.storage import query as q
    engine = "duckdb" if q._duckdb() is not None else "the sqlite fallback"
    say(f"[10b query] {sql!r} over {QUERY_RECORDS} records through {engine}: {text!r} in "
        f"{qs:.2f} s, no kernel [{card}]")
    bench_dir = base / "bench"          # a user's directory: bench_storage leaves its files
    bench_dir.mkdir()
    (bench_dir / "keep.txt").write_text("kept\n")
    r = bench_storage("sha256", str(bench_dir))
    if os.listdir(bench_dir) != ["keep.txt"]:
        raise AssertionError(f"bench_storage left {os.listdir(bench_dir)} in its directory")
    shutil.rmtree(base, ignore_errors=True)
    say(f"[10b storage rate] generate --storage sha256 over {r['seeds']} seeds, batch "
        f"{r['batch']}, zstd 3: {r['records_per_sec']:.0f} records/s ({r['records']} records "
        f"in {r['seconds']:.3f} s, {r['files']} chunks, {r['bytes']} B); a superbatch: host "
        f"issue {r['host_issue_ms_per_superbatch']:.3f} ms, copy wait "
        f"{r['host_copy_wait_ms_per_superbatch']:.3f} ms, columns "
        f"{r['host_columns_ms_per_superbatch']:.3f} ms, Arrow + Parquet write "
        f"{r['host_write_ms_per_superbatch']:.3f} ms; wall under the profiler "
        f"{r['wall_ms_per_superbatch']:.3f} ms, device busy "
        f"{r['device_busy_ms_per_superbatch']:.4f} ms (E1 {r['e1_ms_per_superbatch']:.4f}, "
        f"copies {r['copy_ms_per_superbatch']:.4f}), idle share "
        f"{r['device_idle_share_per_superbatch']:.4f}; host path (KeyDeriver.derive -> "
        f"ResultRecord -> records_to_batch) {r['host_path_records_per_sec']:.1f} records/s on "
        f"{r['host_path_records']} [{card}]")
    return runs


def phase_storage_tail(dev, rng, card: str) -> list:
    """10b, decided before it starts: pyarrow present or not."""
    import importlib.util

    if importlib.util.find_spec("pyarrow") is None:
        say(f"[10b] not run: pyarrow is not installed on this machine (10a ran) [{card}]")
        return []
    return phase_storage(dev, rng, card)


# ---------------------------------------------------------------------------
# phase 11: runs across processes (parallel/multihost.py), ranks sharing the card
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
RANKS = 2
RANK_TIMEOUT_S = 150
ROUND_BATCHES = 8            # multihost.DistributedSweep's default, as dispatch_sweep runs it
DRYRUN_RANKS = 4


@contextlib.contextmanager
def recorded_sweeps():
    """Every ``analyze/sweeps.dispatch_sweep`` result of the block, as a
    list of dicts (found, seed, searched, elapsed)."""
    from vuke_tpu_torch.analyze import sweeps as psweeps

    results, dispatch = [], psweeps.dispatch_sweep

    def recorded(*args, **kwargs):
        res = dispatch(*args, **kwargs)
        results.append({"found": res.found, "seed": res.seed, "searched": res.searched,
                        "elapsed": res.elapsed})
        return res

    psweeps.dispatch_sweep = recorded
    try:
        yield results
    finally:
        psweeps.dispatch_sweep = dispatch


def rank_main(report: str, argv: list) -> int:
    """One rank of phase 11 (``chip_smoke.py --rank REPORT ARGV...``):
    ``cli.main(argv)`` with every launch count set to 0 just before and
    read just after, each sweep's result recorded; writes (rc, launches,
    seconds, sweeps) as JSON to ``REPORT``."""
    for kern in ALL_KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    with recorded_sweeps() as sweeps_run:
        rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with open(report, "w") as f:
        json.dump({"rc": rc, "launches": launch_counts(), "seconds": time.perf_counter() - t0,
                   "sweeps": sweeps_run}, f)
    return rc


def stop_group(proc: subprocess.Popen) -> None:
    """Kill ``proc``'s process group (started with ``start_new_session``)
    if it still runs, and reap ``proc``."""
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
    proc.wait()


def run_ranks(argv: list, what: str, n: int = RANKS) -> list:
    """``argv`` of the command line in ``n`` rank processes of one gloo world
    on a free local port, each given the JAX_* variables and run through
    ``rank_main``: each rank's (stdout, stderr, report, seconds of its
    process).  Fails if a rank exits non-zero or the ranks outlast
    ``RANK_TIMEOUT_S``; every rank is stopped either way."""
    from vuke_tpu_torch.parallel.dryrun import free_port

    port = free_port()
    out_dir = kernels.BUILD_DIR / "ranks"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(n):
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(rank))
            files.append([out_dir / f"{rank}.{ext}" for ext in ("out", "err", "json")])
            with open(files[-1][0], "w") as o, open(files[-1][1], "w") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--rank",
                     str(files[-1][2]), *argv], cwd=REPO, env=env, stdout=o, stderr=e,
                    start_new_session=True))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        secs = []
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            secs.append(time.perf_counter() - t0)
    finally:
        for p in procs:
            stop_group(p)
    ranks = []
    for rank, (p, (out, err, report)) in enumerate(zip(procs, files)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: rank {rank} exited {p.returncode}\n"
                                 f"{out.read_text()}\n{err.read_text()[-4000:]}")
        ranks.append((out.read_text(), err.read_text(), json.loads(report.read_text()),
                      secs[rank]))
    return ranks


def rank_seconds(ranks: list) -> str:
    """Each rank's seconds in its command (``cli.main``) and in its process
    (from the start of the first rank)."""
    command = ", ".join(f"{rep['seconds']:.2f}" for _, _, rep, _ in ranks)
    process = ", ".join(f"{secs:.2f}" for *_, secs in ranks)
    return f"seconds per rank: command {command}, process {process}"


def protocol_searched(start: int, end: int, world: int, batch: int, seed: int) -> list:
    """Each rank's searched count under ``DistributedSweep``'s protocol
    over [start, end] with the one hit at ``seed``: every rank sweeps
    rounds of ``ROUND_BATCHES`` batches until the round in which the
    owner of ``seed`` finds it, the owner up to the batch that holds it."""
    from vuke_tpu_torch.parallel.multihost import partition_range

    shards = partition_range(start, end, world)
    per_round = batch * ROUND_BATCHES
    owner = next(h for h, s in enumerate(shards) if s.start <= seed <= s.end)
    off = seed - shards[owner].start
    stop = off // per_round
    return [min(s.count, stop * per_round + (off % per_round // batch + 1) * batch
                if h == owner else (stop + 1) * per_round)
            for h, s in enumerate(shards)]


def phase_ranks_analyze(rng, card: str) -> list:
    """11a: ``analyze --analyzer milksad`` (exact) over the whole 2^32 space
    in two ranks on the card, the key from a seed planted near the end of
    rank 1's shard, then one in rank 0's first round: both ranks print the
    seed, each searched what the protocol says (in the second, rank 1 one
    round), and the two ranks' seeds/s beside one process's on the first
    key; every run's launches."""
    runs = []
    per_round = CARD_SWEEP_BATCH * ROUND_BATCHES
    cases = (("planted near the end of rank 1's shard", SPACE - 1 - int(rng.integers(0, 1 << 16))),
             ("planted in rank 0's first round", int(rng.integers(0, per_round))))
    for i, (what, seed) in enumerate(cases):
        argv = ["analyze", "0x" + host_milksad_key(seed).hex(), "--analyzer", "milksad"]
        want = protocol_searched(0, SPACE - 1, RANKS, CARD_SWEEP_BATCH, seed)
        if i == 1 and want[1] != per_round:
            raise AssertionError(f"11a: the protocol's model gives rank 1 {want[1]} seeds")
        ranks = run_ranks(argv, f"11a analyze, {what}")
        for rank, (text, log, rep, secs) in enumerate(ranks):
            got = result_line(text, "milksad")
            searched = [s["searched"] for s in rep["sweeps"]]
            if (got != f"CONFIRMED (seed = {seed})" or searched != [want[rank]]
                    or "Running milksad (brute-force)...\n" not in log):
                raise AssertionError(f"11a {what}: rank {rank} printed {got!r}, searched "
                                     f"{searched} (protocol: {want[rank]})\n{log[-2000:]}")
            runs.append(rep["launches"])
        window = max(rep["sweeps"][0]["elapsed"] for _, _, rep, _ in ranks)
        say(f"[11a ranks] analyze milksad exact, {what} (seed {seed}): both ranks CONFIRMED, "
            f"searched {want} as the protocol says; sweep {sum(want) / window:.4g} seeds/s for "
            f"the two ranks together ({sum(want)} seeds, slowest rank's sweep {window:.3f} s); "
            f"{rank_seconds(ranks)}; launches S1 "
            f"{[rep['launches']['sweep_prng'] for _, _, rep, _ in ranks]} [{card}]")
        if i == 0:
            with recorded_sweeps() as one:
                rc, text, log, launches, secs = run_cli(argv)
            if rc != 0 or result_line(text, "milksad") != f"CONFIRMED (seed = {seed})":
                raise AssertionError(f"11a one process: rc {rc}\n{text}")
            runs.append(launches)
            say(f"[11a one process] the same command: sweep "
                f"{one[0]['searched'] / one[0]['elapsed']:.4g} seeds/s ({one[0]['searched']} "
                f"seeds in {one[0]['elapsed']:.3f} s); two ranks / one process "
                f"{(sum(want) / window) / (one[0]['searched'] / one[0]['elapsed']):.3f} [{card}]")
    return runs


def phase_ranks_scan(rng, card: str, decoys: list) -> list:
    """11b: ``scan --transform milksad`` over 2^24 seeds at batch 2^19 in two
    ranks, a target planted in each shard among phase 5's decoys: each rank
    its ``Host i/2`` line and its one hit, the ranks' hits together the
    one-process run's stdout; every run's launches."""
    start = 3_500_000_000
    end = start + (1 << 24) - 1
    half = 1 << 23
    planted = [int(rng.integers(start, start + half)), int(rng.integers(start + half, end + 1))]
    targets = [p2pkh_address(host_h160s(int.from_bytes(host_milksad_key(s), "big") % N or 1)[0])
               for s in planted]
    path = write_targets("ranks_targets.txt", targets, decoys)
    argv = ["scan", "--transform", "milksad", "--targets", path, "--batch", str(BATCH),
            "range", "--start", str(start), "--end", str(end)]
    rc, text, log, launches, secs = run_cli(argv)
    if rc != 0 or sorted(int(s) for s, _ in hit_sources(text)) != planted:
        raise AssertionError(f"11b one process: rc {rc}, hits {hit_sources(text)}\n{log}")
    runs = [launches]
    ranks = run_ranks(argv, "11b scan")
    for rank, (out, err, rep, _) in enumerate(ranks):
        lo = start + rank * half
        host = f"Host {rank}/{RANKS}: seeds [{lo}, {lo + half - 1}]\n"
        done = f"Done. Inputs: {half}, Keys: {half}, Matches: 1\n"
        if ([int(s) for s, _ in hit_sources(out)] != [planted[rank]] or host not in err
                or done not in err):
            raise AssertionError(f"11b rank {rank}: hits {hit_sources(out)}\n{err[-2000:]}")
        check_launches(f"11b rank {rank}", rep["launches"],
                       {name: None for name in MILKSAD_PATH} | {"normalize": half // BATCH})
        runs.append(rep["launches"])
    if "".join(out for out, *_ in ranks) != text:
        raise AssertionError("11b: the ranks' hits are not the one-process run's stdout")
    say(f"[11b ranks] scan milksad [{start}, {end}] (batch {BATCH}) in {RANKS} ranks: hits "
        f"{planted} == one process's, each rank its Host line; {rank_seconds(ranks)} (one "
        f"process, in this one: {secs:.2f} s) [{card}]")
    return runs


def phase_ranks_dryrun(card: str) -> list:
    """11c: ``python -m vuke_tpu_torch.parallel.dryrun 4`` on the card (its
    step lines, hits 0, the planted seed found; its ranks' launches), then
    ``bench_derive`` over every visible card."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "vuke_tpu_torch.parallel.dryrun",
                             str(DRYRUN_RANKS), "--device", "cuda", "--timeout", "120"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        stop_group(proc)
    secs = time.perf_counter() - t0
    lines = out.splitlines()
    space = 4 * 32 * DRYRUN_RANKS
    if proc.returncode != 0 or len(lines) != 3:
        raise AssertionError(f"11c dryrun: rc {proc.returncode}\n{out}\n{err[-4000:]}")
    rep = json.loads(lines[2])
    if (not lines[0].startswith("[dryrun 1/2]") or not lines[1].startswith("[dryrun 2/2]")
            or rep["ranks"] != DRYRUN_RANKS or rep["hits"] != 0
            or rep["found"] != space // 2 + 3):
        raise AssertionError(f"11c dryrun:\n{out}")
    # a rank registers the kernels of the modules it imports; the others ran 0 times
    launches = {name: rep["launches"].get(name, 0) for name in ALL_KERNELS}
    check_launches("11c dryrun", launches,
                   {name: None for name in MILKSAD_PATH + ("sweep_prng",)})
    b = bench_derive()
    if b["devices"] != torch.cuda.device_count():
        raise AssertionError(f"11c bench_derive: devices {b['devices']}")
    say(f"[11c dryrun] {DRYRUN_RANKS} ranks on the card: {lines[0]} / {lines[1]}; "
        f"{secs:.2f} s; launches {launches} [{card}]")
    say(f"[11c bench_derive] every visible card: devices {b['devices']}, "
        f"{b['derivations_per_sec']:.4g} derivations/s (windows {b['window_ms']} ms) [{card}]")
    return [launches]


class Run:
    """What the phases share and fill in: the card, the build's SASS counts,
    each kernel's max abs error against its plain version and its times
    (``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``), and the launch counts
    of every main-path run."""

    def __init__(self, dev, card: str, int_ops_per_s: float, pipes: dict):
        self.dev, self.card, self.int_ops_per_s, self.pipes = dev, card, int_ops_per_s, pipes
        self.rng = np.random.default_rng(20261016)
        self.errs, self.times, self.runs = {}, {}, []
        self._decoys = None

    @property
    def decoys(self) -> list:
        """4096 random P2PKH addresses, made once, when a phase first asks."""
        if self._decoys is None:
            self._decoys = [p2pkh_address(self.rng.bytes(20)) for _ in range(4096)]
        return self._decoys

    def kernel(self, name: str, result):
        """Record a kernel phase's (max abs err, times)."""
        self.errs[name], self.times[name] = result


def run_records(r: Run):
    err, times, verbose = phase_records(r.dev, r.rng, r.card, r.int_ops_per_s, r.pipes)
    r.kernel("records", (err, times))
    r.runs.append(verbose)


def run_p2pkh(r: Run):
    err, times, launches = phase_p2pkh(r.dev, r.rng, r.card, r.int_ops_per_s, r.pipes)
    r.kernel("p2pkh", (err, times))
    r.runs.append(launches)


def run_sweeps(r: Run):
    errs, times = phase_sweep_kernels(r.dev, r.rng, r.card, r.int_ops_per_s)
    r.errs |= errs
    r.times |= times


def run_processes(r: Run):
    r.runs.extend(phase_ranks_analyze(r.rng, r.card))
    r.runs.extend(phase_ranks_scan(r.rng, r.card, r.decoys))
    r.runs.extend(phase_ranks_dryrun(r.card))

# (tag, what, step) in the run's order; the tags are the phase numbers of
# the module's docstring
PHASES = (
    ("3a", "field self-test", lambda r: phase_field(r.dev, r.rng)),
    ("3b", "K1-K6 against plain", lambda r: r.errs.update(phase_kernels(r.dev, r.rng))),
    ("3c", "keygens against plain", lambda r: r.errs.update(phase_keygen(r.dev, r.rng))),
    ("4", "milksad derive", lambda r: phase_derive(r.dev, r.rng)),
    ("4b", "sequential derive", lambda r: phase_seq_derive(r.dev, r.rng)),
    ("4c", "K6 derive", lambda r: phase_derive_k6(r.dev, r.rng)),
    ("4d", "lane-major derive", lambda r: phase_pubkey(r.dev, r.rng)),
    ("5", "milksad scan", lambda r: r.runs.append(phase_scan(r.dev, r.rng, r.decoys))),
    ("5b", "direct:be scans", lambda r: r.runs.extend(phase_seq_scan(r.dev, r.rng, r.decoys))),
    ("5c", "K6 scans", lambda r: r.runs.extend(phase_scan_k6(r.dev, r.rng, r.decoys))),
    ("5d", "keygen scans", lambda r: r.runs.extend(phase_keygen_scans(r.dev, r.rng, r.decoys))),
    ("5e", "sequential off", lambda r: r.runs.append(phase_sequential_off(r.dev, r.rng,
                                                                          r.decoys))),
    ("6", "rates and kernel times", lambda r: r.times.update(
        phase_rate(r.dev, r.rng, r.card, r.int_ops_per_s, r.pipes))),
    ("6s", "scan rates", lambda r: phase_scan_rates(r.card)),
    ("7a", "D1", lambda r: r.kernel("digest", phase_digest(r.dev, r.rng, r.card,
                                                           r.int_ops_per_s))),
    ("7b", "D2", run_p2pkh),
    ("7c", "generate", lambda r: r.runs.append(phase_generate(r.dev, r.rng, r.card))),
    ("7d", "wordlist scans", lambda r: r.runs.extend(phase_wordlist(r.dev, r.rng, r.card,
                                                                    r.decoys))),
    ("7e", "timestamps, stdin, files", lambda r: r.runs.append(
        phase_timestamps(r.dev, r.rng, r.card, r.decoys))),
    ("7f", "bench", lambda r: r.runs.extend(phase_bench(r.card))),
    ("8a", "S1, S2", run_sweeps),
    ("8b", "analyze", lambda r: r.runs.extend(phase_analyze(r.dev, r.rng, r.card)
                                              + [phase_long_cascade(r.card)])),
    ("8c", "provider scan", lambda r: r.runs.append(phase_provider_scan(r.card))),
    ("9a", "W1", lambda r: r.kernel("pbkdf2_sha512", phase_w1(r.dev, r.rng, r.card,
                                                              r.int_ops_per_s))),
    ("9b", "W2", lambda r: r.kernel("electrum_stretch", phase_w2(r.dev, r.rng, r.card,
                                                                 r.int_ops_per_s))),
    ("9c", "electrum scan", lambda r: r.runs.append(phase_electrum_scan(r.dev, r.rng, r.card,
                                                                        r.decoys))),
    ("9d", "multibit-hd", lambda r: r.runs.append(phase_multibit(r.dev, r.rng, r.card))),
    ("9e", "wallet scans", lambda r: r.runs.extend(phase_wallet_scans(r.dev, r.rng, r.card,
                                                                      r.decoys))),
    ("10a", "E1", run_records),
    ("10b", "storage tail", lambda r: r.runs.extend(phase_storage_tail(r.dev, r.rng, r.card))),
    ("11", "processes", run_processes),
)


def parse_phases(argv) -> list:
    """The tags ``--phases A,B,...`` names, in the run's order; every phase
    without it."""
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--phases", default=None,
                   help="comma-separated phase tags (e.g. 7b,10a): run the environment, the "
                        "build, these phases and the kernels line over their kernels")
    args = p.parse_args(argv)
    tags = [tag for tag, _, _ in PHASES]
    if args.phases is None:
        return tags
    want = [t.strip() for t in args.phases.split(",") if t.strip()]
    unknown = sorted(set(want) - set(tags))
    if unknown or not want:
        p.error(f"unknown phases {unknown}; one or more of {', '.join(tags)}")
    return [t for t in tags if t in want]


def kernels_line(r: Run, every: bool) -> dict:
    """The per-kernel summary over the kernels the run held against their
    plain versions and timed: each must have been launched on a main-path
    run of these phases, and with ``every`` (the whole run) every kernel of
    the port must be there."""
    names = [name for name in ALL_KERNELS if name in r.times and name in r.errs]
    if every and names != list(ALL_KERNELS):
        raise AssertionError(f"no times for {sorted(set(ALL_KERNELS) - set(names))}")
    summary = {"kernels": [
        {"name": name, "route": ALL_KERNELS[name].route, "source": ALL_KERNELS[name].source,
         "replaces": ALL_KERNELS[name].replaces,
         "launches": sum(run[name] for run in r.runs), "max_abs_err": r.errs[name],
         "ms": r.times[name][0], "plain_ms": r.times[name][1], "bound_ms": r.times[name][2],
         "bound_by": r.times[name][3], "library_ms": None}
        for name in names]}
    for row in summary["kernels"]:
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was launched no time on the main path")
    return summary


def main(argv=None) -> int:
    tags = parse_phases(sys.argv[1:] if argv is None else argv)
    dev, card, int_ops_per_s = phase_environment()
    r = Run(dev, card, int_ops_per_s, phase_build(card))
    for tag, what, step in PHASES:
        if tag in tags:
            t0 = time.perf_counter()
            step(r)
            say(f"[phase {tag}] {what}: passed in {time.perf_counter() - t0:.1f} s")
    say(json.dumps(kernels_line(r, every=len(tags) == len(PHASES))))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
