"""The fewest 32-bit integer operations each kernel's function needs per
lane, by issue pipe, and the H100's peak: the operations term of the
roofline shares.

A frozen copy of the counts the port keeps in ``vuke_tpu_torch/kernels/
work.py`` (the functions the benchmark's cells drive), with its own
constants, so that a change to the program cannot move the yardstick.

Counted from the functions, not from the compiled kernels: moves, address
and loop arithmetic, loads and stores are not work, and an operation whose
inputs are all known before the launch (hash IVs, round constants, padding
words, the group order) folds away.  Three classes, by the pipes an H100 SM
issues them to (64 a clock on each):

- ``mul``: multiply results, FMA pipe only.  A 32 x 32 -> 64-bit product
  is 2 (its low and high words); a low-word multiply-add is 1, its add
  included.
- ``alu``: ALU pipe only: bitwise logic (any function of up to three words
  is one LOP3), right shifts, rotates and funnel shifts, byte permutes,
  compares and selects.
- ``add``: either pipe: adds and subtracts of up to three terms, with or
  without carry, and left shifts by a constant.

``Ops.cycles`` is the busier pipe's issue slots once the ``add`` work is
spread over both.  The hash and generator counts come from running the
functions below on words that are either known (an int) or the lane's own
(``None``); run on known words alone they compute the real outputs, which
is how the tests check them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .reference.address import _KL as RMD_KL, _KR as RMD_KR, _RL as RMD_RL, _RR as RMD_RR
from .reference.address import _SL as RMD_SL, _SR as RMD_SR

M32 = 0xFFFFFFFF

# NVIDIA H100 SXM: 132 SMs, 64 lanes a clock on each of the ALU and FMA
# pipes, 1.98 GHz (the published maximum boost clock)
SMS, LANES_PER_CLOCK, CLOCK_HZ = 132, 64, 1.98e9
PIPE_OPS_PER_S = SMS * LANES_PER_CLOCK * CLOCK_HZ


def _primes(n: int) -> list:
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out):
            out.append(k)
        k += 1
    return out


def _icbrt(v: int) -> int:
    r = int(round(v ** (1 / 3)))
    while r ** 3 > v:
        r -= 1
    while (r + 1) ** 3 <= v:
        r += 1
    return r


# SHA-256's constants: the first 32 bits of the fractional parts of the
# square roots of the first 8 primes and the cube roots of the first 64
SHA_IV = tuple(math.isqrt(p << 64) & M32 for p in _primes(8))
SHA_K = tuple(_icbrt(p << 96) & M32 for p in _primes(64))
RMD_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


@dataclass(frozen=True)
class Ops:
    """Operations per lane: multiply results (FMA pipe), ALU-only
    operations and adds (either pipe)."""
    mul: float = 0.0
    alu: float = 0.0
    add: float = 0.0

    def __add__(self, other: "Ops") -> "Ops":
        return Ops(self.mul + other.mul, self.alu + other.alu, self.add + other.add)

    def __sub__(self, other: "Ops") -> "Ops":
        return Ops(self.mul - other.mul, self.alu - other.alu, self.add - other.add)

    def __rmul__(self, k: float) -> "Ops":
        return Ops(k * self.mul, k * self.alu, k * self.add)

    def cycles(self) -> float:
        """Issue slots of the busier pipe, at one operation a slot."""
        return max(self.mul, self.alu, (self.mul + self.alu + self.add) / 2)

    def seconds(self, lanes: float) -> float:
        """The least time the card takes for ``lanes`` lanes of this work."""
        return self.cycles() * lanes / PIPE_OPS_PER_S


# --- the secp256k1 field: 8 x 32-bit limbs, weak residues below 2^256 ---

# 512 -> 256 bits: H * 977 into L (16 results), H * 2^32 (9 adds), the carry
# c < 2^33 times 2^32 + 977 (3 results, 11 adds), the last carry (1, 7).
FOLD = Ops(mul=20, add=29)
# 64 products, each row's multiply-adds taking its accumulation; a carry
# out of each of rows 1..7.
FE_MUL = Ops(mul=128, add=7) + FOLD
# 28 cross products and 8 squares; a carry out of each of the cross rows
# 1..6, and the doubling of 15 words.
FE_SQR = Ops(mul=72, add=6 + 15) + FOLD
# 8 subtracts and the borrow, then a borrow folds twice, masked.
FE_SUB = Ops(alu=4, add=26)
# x >= p: the AND of the top six limbs, compares and their combination.
FE_CANON = Ops(alu=8)
# mixed addition (X, Y, ZZ, ZZZ) + (x, y): 8M + 2S and 7 subtractions.
MADD = 8 * FE_MUL + 2 * FE_SQR + 7 * FE_SUB
# a^(p-2): 255 squarings and 15 products.
FE_INV = 255 * FE_SQR + 15 * FE_MUL
# k -> [1, n-1]: 8 subtracts with borrow, 8 selects, the OR of the 8 words
# in 4 three-input LOP3s, a compare and a select.
NORMALIZE = Ops(alu=14, add=8)


def smul() -> Ops:
    """Fixed-base scalar multiplication by 13-bit signed windows: even k
    gains n (9 adds); each of the 26 odd signed digits taken from its
    window (6 operations) and its table point's y negated where the digit is
    negative (8 subtracts, 8 selects); 25 mixed additions."""
    return Ops(alu=1, add=9) + 26 * Ops(alu=5 + 8, add=1 + 8) + 25 * MADD


def inv_affine(m: int) -> Ops:
    """Batched affine conversion per lane, chains of ``m`` lanes: T_j = ZZ_j
    * ZZZ_j, the prefix products, 1/T_j and the running inverse (m - 1
    each), X/ZZ and Y/ZZZ (2 products each) made canonical, and the chain's
    one inversion shared by its m lanes."""
    per_chain = (m + 3 * (m - 1) + 4 * m) * FE_MUL + (2 * m) * FE_CANON + FE_INV
    return (1 / m) * per_chain


# --- straight-line functions on known and lane words ---

class Trace:
    """Counts the operations of a function on 32-bit words: each word is an
    int (known before the launch) or None (the lane's own).  An operation on
    known words alone computes its value and counts nothing."""

    def __init__(self):
        self.mul = self.alu = self.add_ = 0

    @property
    def ops(self) -> Ops:
        return Ops(self.mul, self.alu, self.add_)

    def lop(self, fn, *xs):
        """Any bitwise function of up to three words: one LOP3."""
        if None in xs:
            self.alu += 1
            return None
        return fn(*xs) & M32

    def shr(self, x, s):
        return self.lop(lambda v: v >> s, x)

    def rotr(self, x, s):
        return self.lop(lambda v: (v >> s) | (v << (32 - s)), x)

    def rotl(self, x, s):
        return self.rotr(x, 32 - s)

    def funnel(self, hi, lo, s):
        """The low word of (hi:lo) >> s: one SHF."""
        return self.lop(lambda h, l: ((h << 32) | l) >> s, hi, lo)

    def bswap(self, x):
        """One PRMT."""
        return self.lop(lambda v: int.from_bytes(v.to_bytes(4, "little"), "big"), x)

    def shl(self, x, s):
        if x is None:
            self.add_ += 1
            return None
        return (x << s) & M32

    def add(self, *xs):
        """A sum mod 2^32: the known terms fold into one, then one IADD3
        for each two terms beyond the first."""
        known = sum(x for x in xs if x is not None) & M32
        lanes = sum(x is None for x in xs)
        if not lanes:
            return known
        self.add_ += (lanes + (known != 0)) // 2
        return None

    def mad(self, a, b, c):
        """a * b + c mod 2^32: one low-word multiply-add."""
        if None in (a, b, c):
            self.mul += 1
            return None
        return (a * b + c) & M32


def _xor3(a, b, c):
    return a ^ b ^ c


def sha256_block(t: Trace, state, block):
    """One SHA-256 compression of 16 BE words."""
    a, b, c, d, e, f, g, h = state
    w = list(block)
    for i in range(64):
        if i >= 16:
            x, y = w[i - 15], w[i - 2]
            s0 = t.lop(_xor3, t.rotr(x, 7), t.rotr(x, 18), t.shr(x, 3))
            s1 = t.lop(_xor3, t.rotr(y, 17), t.rotr(y, 19), t.shr(y, 10))
            w.append(t.add(w[i - 16], s0, w[i - 7], s1))
        s1e = t.lop(_xor3, t.rotr(e, 6), t.rotr(e, 11), t.rotr(e, 25))
        ch = t.lop(lambda e_, f_, g_: (e_ & f_) ^ (~e_ & g_), e, f, g)
        t1 = t.add(h, s1e, ch, SHA_K[i], w[i])
        s0a = t.lop(_xor3, t.rotr(a, 2), t.rotr(a, 13), t.rotr(a, 22))
        maj = t.lop(lambda a_, b_, c_: (a_ & b_) ^ (a_ & c_) ^ (b_ & c_), a, b, c)
        h, g, f, e = g, f, e, t.add(d, t1)
        d, c, b, a = c, b, a, t.add(t1, s0a, maj)
    return [t.add(x, s) for x, s in zip((a, b, c, d, e, f, g, h), state)]


_RMD_F = (_xor3,
          lambda x, y, z: (x & y) | (~x & z),
          lambda x, y, z: (x | ~y) ^ z,
          lambda x, y, z: (x & z) | (y & ~z),
          lambda x, y, z: x ^ (y | ~z))


def ripemd160_of_digest(t: Trace, digest):
    """RIPEMD-160 of a SHA-256 digest (8 BE words) -> 5 LE words."""
    m = [t.bswap(v) for v in digest] + [0x80, 0, 0, 0, 0, 0, 256, 0]
    left = list(RMD_IV)
    right = list(RMD_IV)
    for j in range(80):
        r = j // 16
        for st, f, rl, sl, k in ((left, _RMD_F[r], RMD_RL, RMD_SL, RMD_KL[r]),
                                 (right, _RMD_F[4 - r], RMD_RR, RMD_SR, RMD_KR[r])):
            a, b, c, d, e = st
            s = t.rotl(t.add(a, t.lop(f, b, c, d), m[rl[j]], k), sl[j])
            st[:] = [e, t.add(s, e), b, t.rotl(c, 10), d]
    h = RMD_IV
    (al, bl, cl, dl, el), (ar, br, cr, dr, er) = left, right
    return [t.add(h[1], cl, dr), t.add(h[2], dl, er), t.add(h[3], el, ar),
            t.add(h[4], al, br), t.add(h[0], bl, cr)]


def hash160_lane(t: Trace, x, y):
    """Both hash160s of a lane's affine point (8 BE words of x and y) and the
    4 fragment words; words 1..7 of the two SHA-256 messages are the same and
    are formed once."""
    mid = [t.funnel(x[j - 1], x[j], 8) for j in range(1, 8)]
    prefix = t.lop(lambda v: 2 | (v & 1), y[7])
    comp = ([t.funnel(prefix, x[0], 8)] + mid + [t.funnel(x[7], 0x80000000, 8)]
            + [0] * 6 + [33 * 8])
    hc = ripemd160_of_digest(t, sha256_block(t, SHA_IV, comp))
    uncomp = ([t.funnel(4, x[0], 8)] + mid + [t.funnel(x[7], y[0], 8)]
              + [t.funnel(y[j - 1], y[j], 8) for j in range(1, 8)])
    s = sha256_block(t, SHA_IV, uncomp)
    block2 = [t.funnel(y[7], 0x80000000, 8)] + [0] * 14 + [65 * 8]
    hu = ripemd160_of_digest(t, sha256_block(t, s, block2))
    frags = [t.bswap(hc[0]), t.bswap(hc[1]), t.bswap(hu[0]), t.bswap(hu[1])]
    return hc, hu, frags


def hash160() -> Ops:
    t = Trace()
    hash160_lane(t, [None] * 8, [None] * 8)
    return t.ops


def mt19937_lane(t: Trace, seed, n_keys: int = 1, n_out: int | None = None):
    """MT19937 on one seed: init_genrand to state index 8 n_keys + 396, then
    the first 8 n_keys outputs twisted, tempered and byteswapped into BE key
    words; with ``n_out``, that many outputs alone."""
    n_out = 8 * n_keys if n_out is None else n_out
    state = [seed]
    for k in range(1, n_out + 397):
        s = state[-1]
        state.append(t.mad(1812433253, t.lop(lambda v, u: v ^ u, s, t.shr(s, 30)), k))
    key = []
    for k in range(n_out):
        y = t.lop(lambda u, v: (u & 0x80000000) | (v & 0x7FFFFFFF), state[k], state[k + 1])
        odd = t.mad(t.lop(lambda v: v & 1, y), 0x9908B0DF, 0)
        x = t.lop(_xor3, state[397 + k], t.shr(y, 1), odd)
        x = t.lop(lambda v, u: v ^ u, x, t.shr(x, 11))
        x = t.lop(lambda v, u: v ^ (u & 0x9D2C5680), x, t.shl(x, 7))
        x = t.lop(lambda v, u: v ^ (u & 0xEFC60000), x, t.shl(x, 15))
        x = t.lop(lambda v, u: v ^ u, x, t.shr(x, 18))
        key.append(t.bswap(x))
    return key


def mt19937() -> Ops:
    """The milksad keygen per lane: a key's 8 outputs, raw (the scan
    normalizes in its own pass)."""
    t = Trace()
    mt19937_lane(t, None)
    return t.ops


def decimal(digits: float) -> Ops:
    """The decimal string of a seed of ``digits`` digits: one division by 10
    each, at its 32-bit cost (a multiply-high by the reciprocal, the
    remainder's multiply-add, the quotient's shift)."""
    return digits * Ops(mul=2, alu=1)


def _str_block(length_word=None):
    return [None] * 6 + [0] * 8 + [0, length_word]


def keygen_hash(mode: str, digits: float) -> Ops:
    """The three slots of ``direct``, ``sha256`` or ``double_sha256`` per
    seed of ``digits`` decimal digits: the string, the BE and the LE 8
    bytes of the seed; the messages' forming is not counted."""
    t = Trace()
    if mode == "direct":
        t.bswap(None), t.bswap(None)
    else:
        le = [t.bswap(None), t.bswap(None)]
        keys = [sha256_block(t, SHA_IV, _str_block()),
                sha256_block(t, SHA_IV, [None, None, 0x80000000] + [0] * 12 + [64]),
                sha256_block(t, SHA_IV, le + [0x80000000] + [0] * 12 + [64])]
        if mode == "double_sha256":
            for k in keys:
                sha256_block(t, SHA_IV, k + [0x80000000] + [0] * 6 + [256])
    return t.ops + decimal(digits)


# u64 values as (hi, lo) words, each an int or None

def xor64(t: Trace, a, b):
    return t.lop(lambda x, y: x ^ y, a[0], b[0]), t.lop(lambda x, y: x ^ y, a[1], b[1])


def and64(t: Trace, a, b):
    return t.lop(lambda x, y: x & y, a[0], b[0]), t.lop(lambda x, y: x & y, a[1], b[1])


def shl64(t: Trace, a, n: int):
    if n >= 32:
        return t.shl(a[1], n - 32), 0
    return t.lop(lambda h, l: (h << n) | (l >> (32 - n)), a[0], a[1]), t.shl(a[1], n)


def shr64(t: Trace, a, n: int):
    if n >= 32:
        return 0, t.shr(a[0], n - 32)
    return t.shr(a[0], n), t.funnel(a[0], a[1], n)


def add64(t: Trace, a, b):
    """An add, then an add with its carry."""
    if None not in (*a, *b):
        v = ((a[0] << 32 | a[1]) + (b[0] << 32 | b[1])) & ((1 << 64) - 1)
        return v >> 32, v & M32
    t.add_ += 2
    return None, None


def mul64(t: Trace, a, b):
    """The low 64 bits of a product: the low words' wide product (2
    results) and the two cross products' multiply-adds into its high word."""
    if None not in (*a, *b):
        v = ((a[0] << 32 | a[1]) * (b[0] << 32 | b[1])) & ((1 << 64) - 1)
        return v >> 32, v & M32
    t.mul += 2 + (a[0] != 0 and b[1] != 0) + (a[1] != 0 and b[0] != 0)
    return None, None


def _c64(v: int):
    return v >> 32 & M32, v & M32


def mt64_lane(t: Trace, hi, lo, n_keys: int = 1, n_out: int | None = None):
    """The 8 BE words of each of the first ``n_keys`` keys of MT19937-64:
    4 n_keys + 155 init steps, each a 64-bit multiply-add, and 4 n_keys
    outputs twisted and tempered; with ``n_out``, that many outputs alone."""
    n_out = 4 * n_keys if n_out is None else n_out
    s = (hi, lo)
    taps = {0: s}
    for k in range(1, n_out + 156):
        s = add64(t, mul64(t, xor64(t, s, shr64(t, s, 62)), _c64(6364136223846793005)),
                  (0, k))
        if k <= n_out or k >= 156:
            taps[k] = s
    out = []
    for j in range(n_out):
        # the upper mask keeps all of the high word
        y = (taps[j][0],
             t.lop(lambda a, b: (a & 0x80000000) | (b & 0x7FFFFFFF), taps[j][1], taps[j + 1][1]))
        if None in y:
            t.alu += 3            # the low bit's select of the matrix's two words
            mag = (None, None)
        else:
            mag = _c64(0xB5026F5AA96619E9 if y[1] & 1 else 0)
        x = xor64(t, xor64(t, taps[j + 156], shr64(t, y, 1)), mag)
        x = xor64(t, x, and64(t, shr64(t, x, 29), _c64(0x5555555555555555)))
        x = xor64(t, x, and64(t, shl64(t, x, 17), _c64(0x71D67FFFEDA60000)))
        x = xor64(t, x, and64(t, shl64(t, x, 37), _c64(0xFFF7EEE000000000)))
        x = xor64(t, x, shr64(t, x, 43))
        out += [t.bswap(x[1]), t.bswap(x[0])]
    return out


def _compare_ops(mode: str) -> Ops:
    """exact: 8 word compares; mask: key words 6 and 7 masked and or-ed (2
    LOP3) and compared (2)."""
    return Ops(alu=8 if mode == "exact" else 4)


def sweep_prng(family: str, mode: str, reach=(1.0,)) -> Ops:
    """A reverse sweep per lane over the ``milksad`` (MT19937) or ``mt64``
    keystream: the seed's lattice (an add; mt64 also the carry's compare
    and add), then
    - exact: the stream's first output (which holds key word 0) and one
      compare for every lane, and for the share ``reach[1]`` (0 without it)
      of lanes whose word 0 passed, the rest of key 0 and its 7 compares;
    - mask and cascade: key 0 of the stream and its compare, then for each
      further key j of a cascade the share ``reach[j]`` of lanes that
      passed targets 0..j-1: the stream's next key and its compare."""
    if family not in ("milksad", "mt64"):
        raise ValueError(f"no count for the {family!r} sweep")

    def stream(n: int, n_out: int | None = None) -> Ops:
        t = Trace()
        if family == "milksad":
            mt19937_lane(t, None, n, n_out)
        else:
            mt64_lane(t, None, None, n, n_out)
        return t.ops

    lattice = Ops(add=1) if family == "milksad" else Ops(alu=1, add=2)
    if mode == "exact":
        first = lattice + stream(1, 1)
        rest = lattice + stream(1) - first + Ops(alu=7)
        return first + Ops(alu=1) + (reach[1] if len(reach) > 1 else 0.0) * rest
    ops = lattice + stream(1) + _compare_ops(mode)
    for j in range(1, len(reach)):
        ops = ops + reach[j] * (stream(j + 1) - stream(j) + _compare_ops(mode))
    return ops


def derive_seconds(keygen: Ops, seeds: float, slots: int, chain: int = 16) -> float:
    """The least time the card takes to scan ``seeds`` seeds of ``slots``
    keys each: the keygen kernel over the seeds, then per key the
    normalize, the scalar multiplication, the affine conversion in chains
    of ``chain`` lanes and both hash160s, each kernel on its busier pipe."""
    per_key = (NORMALIZE.seconds(1) + smul().seconds(1) + inv_affine(chain).seconds(1)
               + hash160().seconds(1))
    return keygen.seconds(seeds) + per_key * seeds * slots
