"""Host-side pure-Python secp256k1: curve constants and the bignum oracle.

The port's copy of ``vuke_tpu/ecc/ref.py``.  Slow and integer-based, used
only off the hot path: the K3 window table, the sequential scan's base
points, the host confirm of a candidate, and the tests.
"""

from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


def point_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _jdouble(X, Y, Z):
    if Y == 0:
        return 0, 1, 0
    YY = Y * Y % P
    S = 4 * X * YY % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    return X3, (M * (S - X3) - 8 * YY * YY) % P, 2 * Y * Z % P


def _jadd_affine(X, Y, Z, x2, y2):
    """(X, Y, Z) + (x2, y2), Jacobian plus affine."""
    if Z == 0:
        return x2, y2, 1
    ZZ = Z * Z % P
    H = (x2 * ZZ - X) % P
    R = (y2 * ZZ * Z - Y) % P
    if H == 0:
        return _jdouble(X, Y, Z) if R == 0 else (0, 1, 0)
    HH = H * H % P
    HHH = H * HH % P
    V = X * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - Y * HHH) % P, Z * H % P


def point_mul(k: int, p=(GX, GY)):
    """k * p (affine, None for the point at infinity): double-and-add from
    the top bit in Jacobian coordinates, one inversion at the end."""
    k %= N
    X, Y, Z = 0, 1, 0
    for bit in bin(k)[2:] if k else "":
        X, Y, Z = _jdouble(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jadd_affine(X, Y, Z, *p)
    if Z == 0:
        return None
    zi = _inv(Z)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def pubkey_compressed(k: int) -> bytes:
    x, y = point_mul(k)
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def pubkey_uncompressed(k: int) -> bytes:
    x, y = point_mul(k)
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
