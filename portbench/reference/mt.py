"""MT19937 and MT19937-64, written out from Matsumoto and Nishimura's
reference code (init_genrand, init_genrand64, genrand_int32,
genrand64_int64), and the key streams the weak wallets drew from them."""

from __future__ import annotations

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def mt19937(seed: int):
    """The tempered 32-bit outputs of MT19937 seeded with ``seed`` (u32)."""
    mt = [seed & M32]
    for i in range(1, 624):
        mt.append((1812433253 * (mt[-1] ^ (mt[-1] >> 30)) + i) & M32)
    while True:
        for i in range(624):
            y = (mt[i] & 0x80000000) | (mt[(i + 1) % 624] & 0x7FFFFFFF)
            mt[i] = mt[(i + 397) % 624] ^ (y >> 1) ^ (0x9908B0DF if y & 1 else 0)
        for i in range(624):
            y = mt[i]
            y ^= y >> 11
            y ^= (y << 7) & 0x9D2C5680
            y ^= (y << 15) & 0xEFC60000
            y ^= y >> 18
            yield y


def mt19937_64(seed: int):
    """The tempered 64-bit outputs of MT19937-64 seeded with ``seed`` (u64)."""
    mt = [seed & M64]
    for i in range(1, 312):
        mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i) & M64)
    while True:
        for i in range(312):
            x = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % 312] & 0x7FFFFFFF)
            mt[i] = mt[(i + 156) % 312] ^ (x >> 1) ^ (0xB5026F5AA96619E9 if x & 1 else 0)
        for i in range(312):
            x = mt[i]
            x ^= (x >> 29) & 0x5555555555555555
            x ^= (x << 17) & 0x71D67FFFEDA60000
            x ^= (x << 37) & 0xFFF7EEE000000000
            x ^= x >> 43
            yield x


def milksad_key(seed: int) -> bytes:
    """libbitcoin-explorer's ``bx seed`` key from a 32-bit seed: 32 bytes
    filled from MT19937, each output little-endian (vuke's
    ``Mt::new(seed).fill_bytes(32)``)."""
    g = mt19937(seed)
    return b"".join(next(g).to_bytes(4, "little") for _ in range(8))


def mt64_keys(seed: int, n: int) -> list[bytes]:
    """The first ``n`` 32-byte keys of MT19937-64 seeded with ``seed``: each
    four outputs, little-endian, the stream going on from key to key."""
    g = mt19937_64(seed)
    return [b"".join(next(g).to_bytes(8, "little") for _ in range(4)) for _ in range(n)]


def mask_target(key: bytes, bits: int) -> int:
    """A key as a cascade holds it: its low 64 bits under a ``bits`` mask,
    the top bit of the mask set (the puzzles' keys have exactly ``bits``
    bits)."""
    low = int.from_bytes(key, "big") & M64
    return (low & ((1 << bits) - 1)) | (1 << (bits - 1))
