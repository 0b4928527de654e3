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


def mt19937_lane(t: Trace, seed):
    """K1 on one seed (without the normalize epilogue): init_genrand to
    state index 404, then the first 8 outputs twisted, tempered and
    byteswapped into BE key words (csrc/mt19937.cu)."""
    state = [seed]
    for k in range(1, 405):
        s = state[-1]
        state.append(t.mad(1812433253, t.lop(lambda v, u: v ^ u, s, t.shr(s, 30)), k))
    key = []
    for k in range(8):
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
