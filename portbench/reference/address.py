"""Bitcoin addresses of a private key: hash160, Base58Check and bech32.

SHA-256 comes from ``hashlib``; RIPEMD-160 is written out here (from the
RIPEMD-160 paper), since OpenSSL builds may leave it out of ``hashlib``.
"""

from __future__ import annotations

import hashlib

from . import secp256k1

_RL = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_RR = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_SL = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_SR = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_KL = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_KR = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_M = 0xFFFFFFFF


def _f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return (x | ~y) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M


def ripemd160(data: bytes) -> bytes:
    msg = data + b"\x80" + b"\x00" * ((55 - len(data)) % 64) + (8 * len(data)).to_bytes(8, "little")
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    for off in range(0, len(msg), 64):
        x = [int.from_bytes(msg[off + 4 * i:off + 4 * i + 4], "little") for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            r = j // 16
            t = _rol((al + (_f(j, bl, cl, dl) & _M) + x[_RL[j]] + _KL[r]) & _M, _SL[j]) + el
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t & _M
            t = _rol((ar + (_f(79 - j, br, cr, dr) & _M) + x[_RR[j]] + _KR[r]) & _M, _SR[j]) + er
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t & _M
        h = [(h[1] + cl + dr) & _M, (h[2] + dl + er) & _M, (h[3] + el + ar) & _M,
             (h[4] + al + br) & _M, (h[0] + bl + cr) & _M]
    return b"".join(v.to_bytes(4, "little") for v in h)


def hash160(data: bytes) -> bytes:
    return ripemd160(hashlib.sha256(data).digest())


_B58 = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def base58check(payload: bytes) -> str:
    data = payload + hashlib.sha256(hashlib.sha256(payload).digest()).digest()[:4]
    v = int.from_bytes(data, "big")
    out = ""
    while v:
        v, r = divmod(v, 58)
        out = _B58[r] + out
    return "1" * (len(data) - len(data.lstrip(b"\x00"))) + out


_BECH32 = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"


def _polymod(values) -> int:
    gen = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            if (top >> i) & 1:
                chk ^= gen[i]
    return chk


def p2wpkh(h160: bytes, hrp: str = "bc") -> str:
    """BIP 173, witness version 0."""
    acc = bits = 0
    data = [0]
    for b in h160:
        acc = (acc << 8) | b
        bits += 8
        while bits >= 5:
            bits -= 5
            data.append((acc >> bits) & 31)
    if bits:
        data.append((acc << (5 - bits)) & 31)
    hrp_exp = [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]
    pm = _polymod(hrp_exp + data + [0] * 6) ^ 1
    return hrp + "1" + "".join(_BECH32[d] for d in data + [(pm >> 5 * (5 - i)) & 31
                                                            for i in range(6)])


def p2pkh(h160: bytes) -> str:
    return base58check(b"\x00" + h160)


def hash160s(key: bytes) -> tuple[bytes, bytes]:
    """(compressed, uncompressed) hash160 of the key as the tool derives it."""
    x, y = secp256k1.point_mul(secp256k1.normalize_key(key))
    xb = x.to_bytes(32, "big")
    return (hash160(bytes([2 + (y & 1)]) + xb),
            hash160(b"\x04" + xb + y.to_bytes(32, "big")))


FORMS = ("p2pkh_compressed", "p2pkh_uncompressed", "p2wpkh")


def addresses(key: bytes) -> dict:
    """{form: address} of a 32-byte key, and the hash160 each form holds."""
    hc, hu = hash160s(key)
    return {"p2pkh_compressed": (p2pkh(hc), hc), "p2pkh_uncompressed": (p2pkh(hu), hu),
            "p2wpkh": (p2wpkh(hc), hc)}
