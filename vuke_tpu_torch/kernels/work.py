"""The fewest 32-bit integer operations each kernel's function needs per
lane, by issue pipe: the operations term of the kernels' bounds.

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
- ``add``: either pipe (IADD3 on the ALU pipe, IMAD on the FMA pipe): adds
  and subtracts of up to three terms, with or without carry, and left
  shifts by a constant.

``Ops.cycles`` is the busier pipe's issue slots once the ``add`` work is
spread over both.  The field counts follow the field library's algorithm
(``csrc/secp256k1.cuh``: schoolbook rows whose multiply-adds take their
accumulation, a weak reduction by two folds of 2^256 == 2^32 + 977); the
hash and MT19937 counts come from running the functions below on words
that are either known (an int) or the lane's own (``None``), counting each
operation on a lane's word.  Run on known words alone they compute the real
outputs, which is how the tests check them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..cores.hash160 import (RMD_IV, RMD_KL, RMD_KR, RMD_RL, RMD_RR, RMD_SL, RMD_SR, SHA_IV,
                             SHA_K)

M32 = 0xFFFFFFFF


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
        """Issue slots of the busier pipe, at one operation a slot: the
        multiplies, the ALU-only operations, or half of all of them."""
        return max(self.mul, self.alu, (self.mul + self.alu + self.add) / 2)

    def pipe(self) -> str:
        """The term that sets ``cycles``: "FMA", "ALU" or "both"."""
        c = self.cycles()
        return "FMA" if c == self.mul else "ALU" if c == self.alu else "both"


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
# 8 adds and the carry, then a carry c folds twice as c * 977 and c * 2^32.
FE_ADD = Ops(mul=2, add=24)
# 8 subtracts and the borrow, then a borrow folds twice, masked (2 ANDs each).
FE_SUB = Ops(alu=4, add=26)
# x >= p: the AND of the top six limbs, compares and their combination (the
# subtract that follows is taken by a lane once in ~2^128).
FE_CANON = Ops(alu=8)
# mixed addition (X, Y, ZZ, ZZZ) + (x, y): 8M + 2S and 7 subtractions.
MADD = 8 * FE_MUL + 2 * FE_SQR + 7 * FE_SUB
# a^(p-2): 255 squarings and 15 products.
FE_INV = 255 * FE_SQR + 15 * FE_MUL
# k -> [1, n-1] (csrc/scalar.cuh): 8 subtracts with borrow, 8 selects, the
# OR of the 8 words in 4 three-input LOP3s, a compare and a select.
NORMALIZE = Ops(alu=14, add=8)


def smul() -> Ops:
    """K3: even k gains n (9 adds); each of the 26 odd signed digits taken
    from its window (a funnel shift, a LOP3, the sign's compare, |d| as an
    add and an ABS, the index's shift) and its table point's y negated where
    the digit is negative (8 subtracts, 8 selects); 25 mixed additions."""
    return Ops(alu=1, add=9) + 26 * Ops(alu=5 + 8, add=1 + 8) + 25 * MADD


def smul_w8(additions: float) -> Ops:
    """K6: each of the 32 byte digits extracted and tested for 0 (2), and
    one mixed addition for each non-zero digit after the first:
    ``additions`` per lane, counted from the run's scalars (zero digits are
    skipped)."""
    return 32 * Ops(alu=2) + additions * MADD


def seq_madd() -> Ops:
    """K5: B + O_i, 5M + 2S, 5 subtractions and 1 addition."""
    return 5 * FE_MUL + 2 * FE_SQR + 5 * FE_SUB + FE_ADD


def inv_affine(m: int) -> Ops:
    """K4 per lane, for chains of ``m`` lanes: T_j = ZZ_j * ZZZ_j, the
    prefix products, 1/T_j and the running inverse (m - 1 each), X/ZZ and
    Y/ZZZ (2 products each) made canonical, and the chain's one inversion
    shared by its m lanes."""
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
    """One SHA-256 compression (cores/hash160.py::_sha_compress)."""
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
    """RIPEMD-160 of a SHA-256 digest (8 BE words) -> 5 LE words
    (cores/hash160.py::_ripemd_of_digest)."""
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
    """K2 on one lane's 8 BE words of x and y: (h160c, h160u, the 4
    fragment words), as csrc/hash160.cu computes them; words 1..7 of the
    two SHA-256 messages are the same and are formed once."""
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


def mt19937_lane(t: Trace, seed, n_keys: int = 1, n_out: int | None = None):
    """K1 on one seed (without the normalize epilogue): init_genrand to
    state index 8 n_keys + 396, then the first 8 n_keys outputs twisted,
    tempered and byteswapped into BE key words (csrc/mt19937.cu; S1 streams
    further keys); with ``n_out``, that many outputs (key words) alone."""
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


def hash160() -> Ops:
    """K2 per lane, x and y the lane's."""
    t = Trace()
    hash160_lane(t, [None] * 8, [None] * 8)
    return t.ops


def mt19937() -> Ops:
    """K1 per lane with its normalize epilogue, as the derive runs it."""
    t = Trace()
    mt19937_lane(t, None)
    return t.ops + NORMALIZE


# --- the keygens (cores/keygen.py): counted on the hashes, the generators
# and the decimal divisions; forming the messages (the string's alignment,
# terminators, bytes appended at a per-lane offset) is not counted, so these
# bounds sit below what any kernel needs by that much ---

_MD5_S = (7, 12, 17, 22) * 4 + (5, 9, 14, 20) * 4 + (4, 11, 16, 23) * 4 + (6, 10, 15, 21) * 4
_MD5_F = (lambda b, c, d: (b & c) | (~b & d), lambda b, c, d: (d & b) | (~d & c),
          _xor3, lambda b, c, d: c ^ (b | ~d))


def md5_block(t: Trace, state, m):
    """One MD5 compression of the 16 LE words ``m`` (cores/md5.py::compress)."""
    from ..cores.md5 import K
    a, b, c, d = state
    for i in range(64):
        r = i // 16
        g = (i, (5 * i + 1) % 16, (3 * i + 5) % 16, (7 * i) % 16)[r]
        f = t.add(t.lop(_MD5_F[r], b, c, d), a, K[i], m[g])
        a, d, c, b = d, c, b, t.add(b, t.rotl(f, _MD5_S[i]))
    return [t.add(x, y) for x, y in zip(state, (a, b, c, d))]


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


def rotl64(t: Trace, a, n: int):
    """Two funnel shifts."""
    hi, lo = (a[0], a[1]) if n < 32 else (a[1], a[0])
    n %= 32
    return (t.lop(lambda h, l: ((h << n) | (l >> (32 - n))) & M32, hi, lo),
            t.lop(lambda h, l: ((l << n) | (h >> (32 - n))) & M32, hi, lo))


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


def decimal(digits: float) -> Ops:
    """The decimal string of a seed of ``digits`` digits: one division by 10
    each, counted at its 32-bit cost (a multiply-high by the reciprocal, the
    remainder's multiply-add, the quotient's shift), below the 64-bit one."""
    return digits * Ops(mul=2, alu=1)


def _str_block(length_word=None):
    return [None] * 6 + [0] * 8 + [0, length_word]


def keygen_hash(mode: str, digits: float) -> Ops:
    """keygen_hash per lane in ``mode`` for seeds of ``digits`` decimal
    digits on average (csrc/keygen_hash.cu)."""
    t = Trace()
    if mode == "direct":
        t.bswap(None), t.bswap(None)
    elif mode == "md5":
        for w in md5_block(t, [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476],
                           [None] * 6 + [0] * 8 + [None, 0]):
            t.bswap(w)
    else:
        le = [t.bswap(None), t.bswap(None)]
        keys = [sha256_block(t, SHA_IV, _str_block()),
                sha256_block(t, SHA_IV, [None, None, 0x80000000] + [0] * 12 + [64]),
                sha256_block(t, SHA_IV, le + [0x80000000] + [0] * 12 + [64])]
        if mode == "double_sha256":
            for k in keys:
                sha256_block(t, SHA_IV, k + [0x80000000] + [0] * 6 + [256])
    return t.ops + decimal(digits)


def lcg_lane(t: Trace, seed, v, big_endian: bool = True, n_out: int = 8):
    """The first ``n_out`` outputs (8: the key) of the LCG variant ``v``
    (cores/lcg.py) from a u32 seed: a multiply-add a step; glibc masks it
    (1); minstd takes the wide product (2 results) and folds mod 2^31 - 1
    twice (5 ALU, 3 adds) and keeps 0 canonical (a compare and a select)."""
    out, s = [], seed
    for _ in range(n_out):
        if v.m == (1 << 31) - 1:
            if s is None:
                t.mul += 2
                t.alu += 5 + 2
                t.add_ += 3
            else:
                s = (v.a * s + v.c) % v.m
        else:
            s = t.mad(v.a, s, v.c)
            if v.m == 1 << 31:
                s = t.lop(lambda x: x & 0x7FFFFFFF, s)
        out.append(s if big_endian else t.bswap(s))
    return out


def _nonzero(t: Trace, hi, lo):
    """A zero seed becomes 1: a compare and a select."""
    if None in (hi, lo):
        t.alu += 2
        return hi, None
    return hi, lo or (0 if hi else 1)


def splitmix64_lane(t: Trace, x):
    x = add64(t, x, _c64(0x9E3779B97F4A7C15))
    x = mul64(t, xor64(t, x, shr64(t, x, 30)), _c64(0xBF58476D1CE4E5B9))
    x = mul64(t, xor64(t, x, shr64(t, x, 27)), _c64(0x94D049BB133111EB))
    return xor64(t, x, shr64(t, x, 31))


def xorshift_lane(t: Trace, name: str, hi, lo, n_keys: int = 1, n_out: int | None = None):
    """The 8 BE words of each of the first ``n_keys`` keys of xorshift
    variant ``name`` (cores/xorshift.py); with ``n_out``, the generator's
    first ``n_out`` outputs alone (64 bits each, two words; xorshift128's
    32)."""
    per_key = 8 if name == "xorshift128" else 4
    n_out = per_key * n_keys if n_out is None else n_out
    hi, lo = _nonzero(t, hi, lo)
    out = []
    if name == "xorshift64":
        s = (hi, lo)
        for _ in range(n_out):
            s = xor64(t, s, shl64(t, s, 13))
            s = xor64(t, s, shr64(t, s, 7))
            s = xor64(t, s, shl64(t, s, 17))
            out += list(s)
    elif name == "xorshift128":
        x, y = lo, hi
        z = t.lop(lambda v: v ^ 0x12345678, lo)
        w = t.lop(lambda v: v ^ 0x87654321, hi)
        for _ in range(n_out):
            tt = t.lop(lambda a, b: a ^ b, x, t.shl(x, 11))
            x, y, z = y, z, w
            w = t.lop(_xor3, w, t.shr(w, 19), t.lop(lambda a, b: a ^ b, tt, t.shr(tt, 8)))
            out.append(w)
    else:
        s0 = splitmix64_lane(t, (hi, lo))
        s1 = splitmix64_lane(t, s0)
        for _ in range(n_out):
            if name == "xorshift128+":
                out += list(add64(t, s0, s1))
            else:
                out += list(mul64(t, rotl64(t, mul64(t, s0, (0, 5)), 7), (0, 9)))
            s1 = xor64(t, s1, s0)
            s0 = xor64(t, xor64(t, rotl64(t, s0, 24), s1), shl64(t, s1, 16))
            s1 = rotl64(t, s1, 37)
    return out


def mt64_lane(t: Trace, hi, lo, n_keys: int = 1, n_out: int | None = None):
    """The 8 BE words of each of the first ``n_keys`` keys of MT19937-64
    (cores/mt19937.py): 4 n_keys + 155 init steps, each a 64-bit
    multiply-add, and 4 n_keys outputs twisted and tempered; with ``n_out``,
    that many outputs (two key words each) alone."""
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


def keygen_prng(family: str, variant: int = -1, big_endian: bool = True) -> Ops:
    """keygen_prng per lane: every slot of ``family`` (csrc/keygen_prng.cu)."""
    from ..cores import lcg, xorshift
    t = Trace()
    if family == "lcg":
        for v in (lcg.ALL_VARIANTS if variant < 0 else [lcg.ALL_VARIANTS[variant]]):
            lcg_lane(t, None, v, big_endian)
    elif family == "xorshift":
        names = xorshift.VARIANT_NAMES
        for name in (names if variant < 0 else [names[variant]]):
            xorshift_lane(t, name, None, None)
    else:
        mt64_lane(t, None, None)
    return t.ops


def keygen_chain(digits: float, variant: int = -1, depth: int = 10) -> Ops:
    """keygen_chain per lane: one SHA-256 compression a slot over the
    seed's string, then over its 4 bytes (csrc/keygen_chain.cu)."""
    from ..cores.sha256_chain import VARIANTS
    t = Trace()
    for v in (VARIANTS if variant < 0 else [VARIANTS[variant]]):
        for d in range(depth):
            # the decimal string: up to 7 lane words once bytes are appended
            sha256_block(t, SHA_IV, _str_block() if v == "iterated" and d == 0 else
                         [None] * 8 + [0x80000000] + [0] * 6 + [256] if v == "iterated"
                         else [None] * 7 + [0] * 7 + [0, None])
            sha256_block(t, SHA_IV, _seed4_block(v, d))
    return t.ops + decimal(digits)


def _seed4_block(v: str, d: int) -> list:
    """The block of chain key ``d`` of variant ``v`` over a 4-byte seed: one
    lane word, the appended bytes known (iterated: the previous key)."""
    from ..cores.sha256_chain import suffix
    if v == "iterated":
        return ([None, 0x80000000] + [0] * 13 + [32] if d == 0 else
                [None] * 8 + [0x80000000] + [0] * 6 + [256])
    tail = suffix(v, d)
    pad = (tail + b"\x80").ljust(-(-(len(tail) + 1) // 4) * 4, b"\x00")
    words = [int.from_bytes(pad[i:i + 4], "big") for i in range(0, len(pad), 4)]
    return [None] + words + [0] * (14 - len(words)) + [0, (4 + len(tail)) * 8]


def digest(mode: str, blocks: float) -> Ops:
    """D1 per string in ``mode`` (sha256, double_sha256, md5) for strings
    of ``blocks`` compressions on average (their bytes plus the padding, in
    64-byte blocks: this run's data): the first block from the known IV,
    the rest from the lane's state (csrc/digest.cu); forming the message
    words is layout, not counted."""
    lane = [None] * 16
    t1, tn = Trace(), Trace()
    if mode == "md5":
        md5_block(t1, [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476], lane)
        md5_block(tn, [None] * 4, lane)
    else:
        sha256_block(t1, SHA_IV, lane)
        sha256_block(tn, [None] * 8, lane)
        if mode == "double_sha256":
            sha256_block(t1, SHA_IV, [None] * 8 + [0x80000000] + [0] * 6 + [256])
    return t1.ops + (blocks - 1) * tn.ops


def digest_chain(depth: int) -> Ops:
    """D1's chain mode per key: ``depth - 1`` SHA-256s of a 32-byte key."""
    t = Trace()
    sha256_block(t, SHA_IV, [None] * 8 + [0x80000000] + [0] * 6 + [256])
    return (depth - 1) * t.ops


def p2pkh() -> Ops:
    """D2 per lane (csrc/p2pkh.cu): the 21-byte payload's 6 message words
    (a funnel shift each), SHA-256 of it and of its digest; then base58 of
    the 200-bit number: seven divisions by 58^5, each over the limbs still
    non-zero (7, 6, ..., 1: 28 steps of a 64-by-32-bit division by a
    constant, a 64-bit multiply-high (4 wide products), the quotient's
    shift, the remainder's wide product and subtract), five digits from
    each remainder (4 divisions by 58: a multiply-high, the remainder's
    multiply-add, a shift); each character is its digit's entry of a
    shared-memory alphabet, a load on neither pipe."""
    t = Trace()
    words = [t.funnel(None, None, 8) for _ in range(6)]
    state = sha256_block(t, SHA_IV, words + [0] * 9 + [168])
    sha256_block(t, SHA_IV, state + [0x80000000] + [0] * 6 + [256])
    return t.ops + 28 * Ops(mul=2 * 4 + 2, alu=1, add=6) + 28 * Ops(mul=3, alu=1)


# --- E1 (csrc/records.cu): a record's string columns.  Counted on known and
# lane words as the hashes are; run on known words it returns the record's
# strings and statistics ---

_B58_ALPHABET = b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_BECH32_CHARSET = b"qpzry9x8gf2tvdw0s3jn54khce6mua7l"
_BECH32_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)
# a step of a multi-limb division by a constant below 2^32: the 64-bit
# multiply-high (4 wide products), the quotient's shift, the remainder's
# wide product and subtract (as ``p2pkh``); a digit off a remainder: a
# multiply-high, the remainder's multiply-add, a shift
_DIV_STEP = Ops(mul=2 * 4 + 2, alu=1, add=6)
_DIGIT = Ops(mul=3, alu=1)


def _count(t: Trace, ops: Ops, k: float = 1):
    t.mul += k * ops.mul
    t.alu += k * ops.alu
    t.add_ += k * ops.add


def _divide_out(t: Trace, limbs: list, nbits: int, divisor: int, passes: int, per: int,
                radix: int) -> list:
    """``passes`` divisions of the BE limbs (a number below 2^nbits) by
    ``divisor`` = radix^per, ``per`` digits off each remainder: the digits,
    most significant first.  A step whose remainder and limb are both
    known zero folds; after each pass the limbs the number has outgrown are
    known zero."""
    limbs, digits = list(limbs), []
    for r in range(passes):
        rem = 0
        for j, limb in enumerate(limbs):
            if rem is None or limb is None:
                _count(t, _DIV_STEP)
                rem, limbs[j] = None, None
            elif rem or limb:
                cur = (rem << 32) | limb
                rem, limbs[j] = cur % divisor, cur // divisor
        keep = max(0, math.ceil((nbits - (r + 1) * math.log2(divisor)) / 32))
        limbs[:len(limbs) - keep] = [0] * (len(limbs) - keep)
        group = []
        for _ in range(per):
            group.append(None if rem is None else rem % radix)
            rem = None if rem is None else rem // radix
        if None in group:
            _count(t, _DIGIT, per - 1)
        digits = group[::-1] + digits
    return digits


def _base58_lane(t: Trace, limbs: list, nbytes: int, zeros):
    """base58 of the number in ``limbs`` (``nbytes`` bytes) after ``zeros``
    leading zero bytes, each character its digit's entry of a shared-memory
    alphabet (a load on neither pipe)."""
    passes = -(-math.ceil(8 * nbytes / math.log2(58)) // 5)
    digits = _divide_out(t, limbs, 8 * nbytes, 58 ** 5, passes, 5, 58)
    if None in digits or zeros is None:
        return None
    body = bytes(_B58_ALPHABET[d] for d in digits).lstrip(b"1")
    return b"1" * zeros + body


def _zero_bytes(t: Trace, byts: list):
    """Leading zero bytes (a count leading zeros and a select a limb)."""
    if None in byts:
        t.alu += 2 * -(-len(byts) // 4)
        return None
    return len(byts) - len(bytes(byts).lstrip(b"\0"))


def _sha256d_word0(t: Trace, m: list, nbytes: int):
    """The checksum word: SHA-256 of the payload's one block, then of its
    digest."""
    block = list(m) + [0] * (14 - len(m))
    block[nbytes // 4] = t.lop(lambda v: v | (0x80 << (8 * (3 - nbytes % 4))), block[nbytes // 4])
    s = sha256_block(t, SHA_IV, block + [0, 8 * nbytes])
    return sha256_block(t, SHA_IV, s + [0x80000000] + [0] * 6 + [256])[0]


def _bytes_be(words: list) -> list:
    return [None if w is None else (w >> s) & 0xFF for w in words for s in (24, 16, 8, 0)]


def _base58check_lane(t: Trace, words: list, version: int, one: bool):
    """base58check of version || the payload (the BE ``words`` [|| 0x01]):
    its message words and limbs from funnel shifts, the checksum, the
    digits of the number."""
    tail = 0x01000000 if one else 0
    m = ([t.funnel(version, words[0], 8)]
         + [t.funnel(words[j - 1], words[j], 8) for j in range(1, len(words))]
         + [t.funnel(words[-1], tail, 8)])
    nbytes = 1 + 4 * len(words) + one
    chk = _sha256d_word0(t, m, nbytes)
    byts = [version] + _bytes_be(words) + [1] * one + _bytes_be([chk])
    if one:        # 38 bytes: the top limb holds two
        limbs = ([t.funnel(version, words[0], 24)]
                 + [t.funnel(words[j - 1], words[j], 24) for j in range(1, len(words))]
                 + [t.funnel(words[-1], tail, 24), chk])
    else:
        limbs = [version] + list(words) + [chk]
    return _base58_lane(t, limbs, nbytes + 4, _zero_bytes(t, byts))


def _bech32_lane(t: Trace, d: list, hrp: str):
    """bech32 v0 of the 20 bytes in BE words d: 32 groups (a funnel shift
    and a mask each), the polymod over them and 7 zeros from the hrp's
    state (a shift, a mask-shift-xor, 5 selects and xors a step)."""
    chk = 1
    for v in [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i, gen in enumerate(_BECH32_GEN):
            chk ^= gen if (top >> i) & 1 else 0
    groups = [0]
    for g in range(32):
        bit = 5 * g
        w, off = bit >> 5, bit & 31
        lo = d[w + 1] if w + 1 < 5 else 0
        groups.append(t.lop(lambda v: v & 31, t.funnel(d[w], lo, 27 - off + 32)
                            if off > 27 else t.shr(d[w], 27 - off)))
    for v in groups + [0] * 6:
        top = t.shr(chk, 25)
        chk = t.lop(lambda c, x: ((c & 0x1FFFFFF) << 5) ^ x, chk, v)
        for i, gen in enumerate(_BECH32_GEN):
            chk = t.lop(lambda c, tp: c ^ (gen if (tp >> i) & 1 else 0), chk, top)
    chk = t.lop(lambda c: c ^ 1, chk)
    if chk is None or None in groups:
        return None
    data = groups + [(chk >> (5 * (5 - i))) & 31 for i in range(6)]
    return hrp.encode() + b"1" + bytes(_BECH32_CHARSET[v] for v in data)


def records_lane(t: Trace, k: list, hc: list, hu: list, p2pkh_version: int = 0x00,
                 wif_version: int = 0x80, hrp: str = "bc"):
    """E1 on one lane: the 8 BE key words, both digests as 5 LE words ->
    {column: bytes} and (bit length, Hamming weight, leading zero hex
    digits), as csrc/records.cu computes them; None where a lane word
    reaches it."""
    out = {}
    digits = _divide_out(t, k, 256, 10 ** 9, 9, 9, 10)
    out["private_key_decimal"] = None                # a digit's character: a table load
    if None not in digits:
        out["private_key_decimal"] = bytes(48 + d for d in digits).lstrip(b"0") or b"0"
    out["wif_uncompressed"] = _base58check_lane(t, k, wif_version, False)
    out["wif_compressed"] = _base58check_lane(t, k, wif_version, True)
    dc = [t.bswap(w) for w in hc]
    du = [t.bswap(w) for w in hu]
    out["address_p2pkh_compressed"] = _base58check_lane(t, dc, p2pkh_version, False)
    out["address_p2pkh_uncompressed"] = _base58check_lane(t, du, p2pkh_version, False)
    out["address_p2wpkh"] = _bech32_lane(t, dc, hrp)
    if None in k:
        # a count leading zeros, a population count, the prefix's select
        # and the sums a word
        _count(t, Ops(alu=3, add=2), 8)
        return out, None
    v = int.from_bytes(b"".join(w.to_bytes(4, "big") for w in k), "big")
    return out, (v.bit_length(), bin(v).count("1"), (256 - v.bit_length()) // 4)


def records() -> Ops:
    """E1 per lane, its words the lane's (mainnet's constants)."""
    t = Trace()
    records_lane(t, [None] * 8, [None] * 5, [None] * 5)
    return t.ops

# --- the reverse sweeps (cores/sweep.py): a lane's keystream and compare;
# a cascade's further keys only for the share of lanes that reach them,
# counted from the run's data ---

def _compare_ops(mode: str) -> Ops:
    """exact: 8 word compares; mask: key words 6 and 7 masked and or-ed (2
    LOP3) and compared (2)."""
    return Ops(alu=8 if mode == "exact" else 4)


def sweep_prng(family: str, mode: str, variant: int = 0, big_endian: bool = True,
               reach=(1.0,)) -> Ops:
    """S1 per lane (csrc/sweep_prng.cu): the seed's lattice (an add; the
    64-bit families also the carry's compare and add), then
    - exact: the stream's first output (which holds key word 0) and one
      compare for every lane, and for the share ``reach[1]`` (0 without it)
      of lanes whose word 0 passed, the rest of key 0 and its 7 compares;
      an LCG's output as the generator gives it, since a little-endian
      key's byteswap folds into the target word, known before the launch;
      glibc's, msvc's and borland's output 1 is an affine map of the seed
      mod 2^32 (glibc's doubled, which drops its mask), so a lane's is the
      lane T seeds before it plus a T, one add with the lattice in it;
    - mask and cascade: key 0 of the stream and its compare, then for each
      further key j of a cascade the share ``reach[j]`` of lanes that
      passed targets 0..j-1: the stream's next key (what the stream of
      j + 1 keys needs beyond that of j) and its compare.
    Shares are counted from the run's data."""
    from ..cores import lcg, xorshift

    def stream(n: int, n_out: int | None = None) -> Ops:
        t = Trace()
        if family == "milksad":
            mt19937_lane(t, None, n, n_out)
        elif family == "mt64":
            mt64_lane(t, None, None, n, n_out)
        elif family == "lcg":
            lcg_lane(t, None, lcg.ALL_VARIANTS[variant], big_endian, n_out or 8)
        else:
            xorshift_lane(t, xorshift.VARIANT_NAMES[variant], None, None, n, n_out)
        return t.ops

    lattice = Ops(add=1) if family in ("milksad", "lcg") else Ops(alu=1, add=2)
    if mode == "exact":
        if family == "lcg" and lcg.ALL_VARIANTS[variant].m != (1 << 31) - 1:
            first = Ops(add=1)
        elif family == "lcg":
            t = Trace()
            lcg_lane(t, None, lcg.ALL_VARIANTS[variant], True, 1)
            first = lattice + t.ops
        else:
            first = lattice + stream(1, 1)
        rest = lattice + stream(1) - first + Ops(alu=7)
        return first + Ops(alu=1) + (reach[1] if len(reach) > 1 else 0.0) * rest
    ops = lattice + stream(1) + _compare_ops(mode)
    for j in range(1, len(reach)):
        ops = ops + reach[j] * (stream(j + 1) - stream(j) + _compare_ops(mode))
    return ops


def sweep_chain(variant: str, mode: str, reach) -> Ops:
    """S2 per lane (csrc/sweep_chain.cu): the seed's add, then for each
    chain position d the share ``reach[d]`` of lanes that compute it (exact
    and mask: every lane not yet hit; cascade: those that passed targets
    0..d-1): one SHA-256 compression of its block and its compare."""
    t = Trace()
    ops = Ops(add=1)
    for d, share in enumerate(reach):
        t = Trace()
        sha256_block(t, SHA_IV, _seed4_block(variant, d))
        ops = ops + share * (t.ops + _compare_ops(mode))
    return ops


# --- the wallet kernels: SHA-512 on 64-bit words as (hi, lo) pairs, each
# word of a pair an int or None; the 64-bit logic, shifts and rotates are
# two 32-bit ones, an add of m terms two carry chains of IADD3s ---

def _rotr64(t: Trace, x, n: int):
    """Two funnel shifts (a swap alone for 32)."""
    hi, lo = x if n < 32 else (x[1], x[0])
    n %= 32
    if n == 0:
        return hi, lo
    return t.funnel(lo, hi, n), t.funnel(hi, lo, n)


def _shr64(t: Trace, x, n: int):
    """x >> n for n < 32: a shift and a funnel shift."""
    return t.shr(x[0], n), t.funnel(x[0], x[1], n)


def _lop64(t: Trace, fn, *xs):
    """A bitwise function of up to three 64-bit words: a LOP3 a half."""
    return (t.lop(fn, *(x[0] for x in xs)), t.lop(fn, *(x[1] for x in xs)))


def _add64(t: Trace, *xs):
    """A sum mod 2^64: the known terms fold into one; the low words' sum
    carries into the high words', each half one IADD3 for each two terms
    beyond the first."""
    known = sum((x[0] << 32 | x[1]) for x in xs if None not in x) & ((1 << 64) - 1)
    lanes = sum(None in x for x in xs)
    if not lanes:
        return known >> 32, known & M32
    t.add_ += 2 * ((lanes + (known != 0)) // 2)
    return None, None


def sha512_block(t: Trace, state, block):
    """One SHA-512 compression (cores/sha512.py::compress) of 16 (hi, lo)
    words into 8."""
    from ..cores.sha512 import K
    a, b, c, d, e, f, g, h = state
    w = list(block)
    for i in range(80):
        if i >= 16:
            x, y = w[i - 15], w[i - 2]
            s0 = _lop64(t, _xor3, _rotr64(t, x, 1), _rotr64(t, x, 8), _shr64(t, x, 7))
            s1 = _lop64(t, _xor3, _rotr64(t, y, 19), _rotr64(t, y, 61), _shr64(t, y, 6))
            w.append(_add64(t, w[i - 16], s0, w[i - 7], s1))
        s1e = _lop64(t, _xor3, _rotr64(t, e, 14), _rotr64(t, e, 18), _rotr64(t, e, 41))
        ch = _lop64(t, lambda e_, f_, g_: (e_ & f_) ^ (~e_ & g_), e, f, g)
        t1 = _add64(t, h, s1e, ch, (K[i] >> 32, K[i] & M32), w[i])
        s0a = _lop64(t, _xor3, _rotr64(t, a, 28), _rotr64(t, a, 34), _rotr64(t, a, 39))
        maj = _lop64(t, lambda a_, b_, c_: (a_ & b_) ^ (a_ & c_) ^ (b_ & c_), a, b, c)
        h, g, f, e = g, f, e, _add64(t, d, t1)
        d, c, b, a = c, b, a, _add64(t, t1, s0a, maj)
    return [_add64(t, x, s) for x, s in zip((a, b, c, d, e, f, g, h), state)]


def pbkdf2_sha512(iterations: int, salt_block=None) -> Ops:
    """W1 per lane (csrc/pbkdf2_sha512.cu): the key block XOR ipad and opad
    (32 LOP3s each), the inner and outer states from the IV, U_1 from the
    salt's known block and the outer state, then per further iteration two
    compressions of a 64-byte message (its words 8..15 known) and T ^= U
    (16 LOP3s)."""
    from ..cores.sha512 import IV
    iv = [(v >> 32, v & M32) for v in IV]
    lane = [(None, None)] * 8
    pad = [(0x80000000, 0)] + [(0, 0)] * 6 + [(0, 1536)]
    salt = [(0, 0)] * 16 if salt_block is None else salt_block
    setup, step = Trace(), Trace()
    setup.alu += 64
    sha512_block(setup, iv, [(None, None)] * 16)
    sha512_block(setup, iv, [(None, None)] * 16)
    sha512_block(setup, lane, salt)
    sha512_block(setup, lane, lane + pad)
    sha512_block(step, lane, lane + pad)
    sha512_block(step, lane, lane + pad)
    step.alu += 16
    return setup.ops + (iterations - 1) * step.ops


def electrum_stretch(length: int, rounds: int) -> Ops:
    """W2 per lane (csrc/electrum_stretch.cu): ``rounds`` SHA-256s of
    x || s, s ``length`` bytes: the seed's words (the terminator's byte
    among them unless the length is a multiple of 4) are the lane's, the
    padding known; a block of padding alone (length 32) is known whole."""
    nb = (32 + length + 9 + 63) // 64
    nw = (length + 3) // 4
    tail = []
    for j in range(16 * nb - 8):
        if j < nw:
            tail.append(None)
        elif j == length // 4:
            tail.append(0x80000000)
        else:
            tail.append((32 + length) * 8 if j == 16 * nb - 9 else 0)
    t = Trace()
    state = sha256_block(t, SHA_IV, [None] * 8 + tail[:8])
    for b in range(1, nb):
        state = sha256_block(t, state, tail[16 * b - 8:16 * b + 8])
    return rounds * t.ops
