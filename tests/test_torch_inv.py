"""vuke_tpu_torch batch inversion + affine (K4's plain version) and its field
algebra, against the JAX package and the bignum oracle.

The JAX side is ``pallas_smul._mul_t`` and ``pallas_inv._normalize16`` run
eagerly under numpy, with each lane's inverse of ZZ*ZZZ taken by host
bignum arithmetic.  Canonical x, y must be bit-identical.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import vuke_tpu.ecc.pallas_inv as pinv
import vuke_tpu.ecc.pallas_smul as ps
from vuke_tpu.ecc import ref
from vuke_tpu_torch.ecc import field as F
from vuke_tpu_torch.ecc import inv

P = ref.P
EDGE = [0, 1, 2, 0xFFFF, 0x10000, P - 1, P, P + 1, (1 << 256) - 1,
        (1 << 255) + 977, (1 << 129) - 1, ref.N - 1, ref.GX, ref.GY]


def _rand(n, seed):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]


def _limbs16(vals):
    return torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vals] for i in range(16)],
                        dtype=torch.int64)


def _val16(t, j):
    return sum(int(t[i, j]) << (16 * i) for i in range(16))


def _le32(vals):
    return torch.from_numpy(np.array(
        [[(v >> (32 * i)) & 0xFFFFFFFF for v in vals] for i in range(8)], dtype=np.uint32))


def _be_int(words, j):
    return sum(int(words[i, j]) << (32 * (7 - i)) for i in range(8))


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg"])
def test_field_ops_match_bignum(op):
    a_vals = EDGE + _rand(50, 1)
    b_vals = list(reversed(a_vals))
    a, b = _limbs16(a_vals), _limbs16(b_vals)
    out = {"mul": lambda: F.mul(a, b), "sqr": lambda: F.sqr(a),
           "add": lambda: F.add(a, b), "sub": lambda: F.sub(a, b),
           "neg": lambda: F.neg(a)}[op]()
    want = {"mul": lambda x, y: x * y, "sqr": lambda x, y: x * x,
            "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
            "neg": lambda x, y: -x}[op]
    assert (out >= 0).all() and (out < 1 << 17).all()     # weak limbs
    for j, (x, y) in enumerate(zip(a_vals, b_vals)):
        assert _val16(out, j) % P == want(x, y) % P


def test_field_mul_at_the_weak_limb_bound():
    top = torch.full((16, 1), (1 << 17) - 1, dtype=torch.int64)
    v = _val16(top, 0)
    out = F.mul(top, top)
    assert (out < 1 << 17).all()
    assert _val16(out, 0) % P == v * v % P
    assert _val16(F.canonical(top), 0) == v % P


def test_field_canonical_and_inverse():
    vals = [v for v in EDGE + _rand(20, 2) if v % P]
    a = _limbs16(vals)
    c = F.canonical(a)
    assert [_val16(c, j) for j in range(len(vals))] == [v % P for v in vals]
    ia = F.canonical(F.inv(a))
    assert all(_val16(ia, j) * v % P == 1 for j, v in enumerate(vals))


def _jax_affine(Xv, Yv, ZZv, ZZZv):
    """x = X * inv(ZZ*ZZZ) * ZZZ, y = Y * inv(ZZ*ZZZ) * ZZ on numpy rows."""
    def rows(vals):
        return [np.array([(v >> (16 * i)) & 0xFFFF for v in vals], dtype=np.uint32)
                for i in range(16)]

    it = [pow(zz * zzz % P, -1, P) for zz, zzz in zip(ZZv, ZZZv)]
    x = pinv._normalize16(ps._mul_t(ps._mul_t(rows(Xv), rows(it)), rows(ZZZv)))
    y = pinv._normalize16(ps._mul_t(ps._mul_t(rows(Yv), rows(it)), rows(ZZv)))

    def val(r, j):
        return sum(int(r[i][j]) << (16 * i) for i in range(16))

    return ([val(x, j) for j in range(len(Xv))], [val(y, j) for j in range(len(Xv))])


def _points(n, seed):
    """(X, Y, ZZ, ZZZ) ints below 2^256 for random affine (x, y) and Z (K4's
    algebra does not need the points on the curve).  The first lanes hold
    unreduced representatives in [p, 2^256), which K3 may hand over."""
    rng = np.random.RandomState(seed)
    lanes = [[1 + P, 2 + P, 1 + P, 1 + P], [P - 1, 5 + P, 1, 1 + P],
             list(ref.point_mul(3)) + [1, 1]]
    while len(lanes) < n:
        x, y, z = (int.from_bytes(rng.bytes(32), "big") % P for _ in range(3))
        zz = z * z % P or 1
        zzz = zz * z % P or 1
        lanes.append([x * zz % P, y * zzz % P, zz, zzz])
    return [list(c) for c in zip(*lanes)]


@pytest.mark.parametrize("n,chunk", [(256, 16), (256, 1), (512, 32), (256, 8), (256, 4)])
def test_affine_plain_matches_jax_rows(monkeypatch, n, chunk):
    monkeypatch.setattr(ps, "jnp", np)
    monkeypatch.setattr(pinv, "jnp", np)
    Xv, Yv, ZZv, ZZZv = _points(n, seed=n + chunk)
    x, y = inv.affine_plain(_le32(Xv), _le32(Yv), _le32(ZZv), _le32(ZZZv), chunk=chunk)
    x, y = x.to(torch.int64), y.to(torch.int64)
    jx, jy = _jax_affine(Xv, Yv, ZZv, ZZZv)
    assert [_be_int(x, j) for j in range(n)] == jx
    assert [_be_int(y, j) for j in range(n)] == jy


def test_affine_wrapper_requires_chunk_multiple():
    n = inv.CHUNK + inv.CHUNK // 2
    assert n % inv.CHUNK
    z = torch.zeros((8, n), dtype=torch.uint32)
    with pytest.raises(ValueError):
        inv.affine(z, z, z, z)


def test_field_selftest_plain_matches_bignum():
    """``field.selftest`` on the CPU (its plain path) on the operands the
    card's self-test takes: every pair of the adversarial values, and
    random pairs."""
    a, b = chip_smoke.field_operands(64, seed=3)
    outs = F.selftest(chip_smoke.limbs_le(a), chip_smoke.limbs_le(b))
    assert set(outs) == set(F.SELFTEST_OPS)
    assert all(o.dtype == torch.uint32 and o.shape == (8, len(a)) for o in outs.values())
    assert chip_smoke.field_mismatches(a, b, outs) == []
