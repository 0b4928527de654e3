"""vuke_tpu_torch scalar multiplication (K3's plain version) against the JAX
package.

The JAX side runs ``pallas_smul13``'s limb helpers eagerly under numpy (as
tests/test_smul13_math.py does): the odd recoding, and the kernel's
per-window (ZZ, ZZZ) chain re-run with ``_madd13``.  Results are compared
as affine points (projective values equal mod p) and against the bignum
oracle.  Exact (tolerance 0).  The port runs 14-bit windows (``WBITS``);
the recoding, the table and the plain chain are also held at the TPU
kernel's 10 bits, where the JAX package has them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import vuke_tpu.ecc.pallas_smul13 as m13
from vuke_tpu.ecc import ref
from vuke_tpu_torch import params
from vuke_tpu_torch.ecc import smul

# the adversarial scalars of tests/test_smul13_math.py::test_chain_matches_oracle,
# and the edges of a 14-bit window
_KS = [1, 2, 3, 255, 256, 257, 0xDEADBEEF, 1 << 128, (1 << 255) + 12345,
       ref.N - 1, ref.N - 2, 0x100000000, 0x1000000000000,
       1 << 250, (1 << 256) - (1 << 230), 0x3FFF, 0x4000, 0x4001, (1 << 252) + 1,
       ref.N - (1 << 14)]
WIDTHS = [10, smul.WBITS]


def _scalars():
    rng = np.random.RandomState(5)
    rand = [int.from_bytes(rng.bytes(32), "big") % (ref.N - 1) + 1 for _ in range(9)]
    return [k % ref.N or 1 for k in _KS] + rand


def _words_np(ks):
    return np.array([[(k >> (32 * (7 - i))) & 0xFFFFFFFF for k in ks] for i in range(8)],
                    dtype=np.uint32)


@pytest.fixture
def numpy_m13(monkeypatch):
    monkeypatch.setattr(m13, "jnp", np)


def _table(wbits):
    return torch.from_numpy(smul.window_table(wbits))


def test_kernel_width_is_fourteen_bits():
    """The plain version's width is the kernel's (``kWbits`` in its source)."""
    src = (Path(smul.__file__).parents[1] / "csrc" / "smul.cu").read_text()
    assert re.findall(r"constexpr int kWbits = (\d+);", src) == [str(smul.WBITS)]
    assert (smul.WBITS, smul.WINDOWS, smul.TSIZE) == (14, 19, 8192)
    assert smul.window_table().shape == (19, 8192, 16)


@pytest.mark.parametrize("wbits", WIDTHS)
def test_odd_encode_matches_jax(numpy_m13, wbits):
    ks = _scalars() + [4, 0x3FF, 0x400, 0x401, (1 << 255) + 12346]
    w = _words_np(ks)
    want = np.stack(m13.odd_encode_rows([w[i] for i in range(8)], wbits), axis=0)
    got = smul.odd_encode(torch.from_numpy(w), wbits).to(torch.int64).numpy()
    assert got.shape == (smul.n_windows(wbits), len(ks))
    assert np.array_equal(got, want)


def _jax_chain_affine(ks):
    """The TPU kernel's odd-digit window loop, in numpy, -> affine points."""
    tab = m13._table13_f32(10, "odd")
    w = _words_np(ks)
    digs = m13.odd_encode_rows([w[i] for i in range(8)], 10)

    def lookup(win):
        d = digs[win]
        e = tab[win, d & np.uint32(0x7FFF), :].astype(np.int32).astype(np.uint32)
        x2 = [e[:, i] for i in range(m13.L13)]
        y2 = [e[:, m13.L13 + i] for i in range(m13.L13)]
        return x2, m13._select13((d >> np.uint32(15)) != 0, m13._neg13(y2), y2)

    one = [np.full(len(ks), np.uint32(1 if i == 0 else 0)) for i in range(m13.L13)]
    X, Y = lookup(0)
    ZZ, ZZZ = list(one), list(one)
    for win in range(1, m13._n_windows(10)):
        X, Y, ZZ, ZZZ = m13._madd13(X, Y, ZZ, ZZZ, *lookup(win))

    def val(rows, j):
        return sum(int(r[j]) << (13 * i) for i, r in enumerate(rows))

    return [(val(X, j) * pow(val(ZZ, j), -1, ref.P) % ref.P,
             val(Y, j) * pow(val(ZZZ, j), -1, ref.P) % ref.P) for j in range(len(ks))]


def _port_affine(ks, wbits):
    words = torch.from_numpy(_words_np(ks))
    outs = (smul.scalar_mul(words) if wbits == smul.WBITS
            else smul.scalar_mul_plain(words, _table(wbits), wbits))
    X, Y, ZZ, ZZZ = (t.to(torch.int64).numpy() for t in outs)

    def val(limbs, j):
        return sum(int(v) << (32 * i) for i, v in enumerate(limbs[:, j]))

    for t in (X, Y, ZZ, ZZZ):
        assert (t >= 0).all() and (t < 1 << 32).all()
    return [(val(X, j) * pow(val(ZZ, j), -1, ref.P) % ref.P,
             val(Y, j) * pow(val(ZZZ, j), -1, ref.P) % ref.P) for j in range(len(ks))]


@pytest.mark.parametrize("wbits", WIDTHS)
def test_plain_chain_matches_jax_chain_and_oracle(numpy_m13, wbits):
    """At 10 bits against the TPU kernel's chain and the oracle; at the
    kernel's 14 (which the JAX package has no table for) against the
    oracle."""
    ks = _scalars()
    got = _port_affine(ks, wbits)
    if wbits == 10:
        assert got == _jax_chain_affine(ks)
    assert got == [ref.point_mul(k) for k in ks]


def test_table_from_jax_equals_port_table():
    assert np.array_equal(params.table_from_jax(m13._table13_f32(10, "odd")),
                          smul.window_table(10))


# the first and last rows of the first, a middle and the last window, and a
# few others
_ROWS = [(10, w, j) for w, j in [(0, 0), (0, 511), (13, 255), (25, 1)]] + \
    [(14, w, j) for w in (0, 9, 18) for j in (0, 8191)] + \
    [(14, 3, 4321), (14, 12, 77), (14, 17, 6000)]


@pytest.mark.parametrize("wbits,w,j", _ROWS)
def test_table_rows_are_odd_multiples(wbits, w, j):
    e = smul.window_table(wbits)[w, j].astype(object)
    x = sum(int(v) << (32 * i) for i, v in enumerate(e[:8]))
    y = sum(int(v) << (32 * i) for i, v in enumerate(e[8:]))
    assert (x, y) == ref.point_mul(((2 * j + 1) << (wbits * w)) % ref.N)


def test_plain_rejects_a_table_of_another_width():
    words = torch.from_numpy(_words_np([5]))
    with pytest.raises(ValueError):
        smul.scalar_mul_plain(words, _table(10))
    with pytest.raises(ValueError):
        smul.odd_encode(words, 16)


def test_wrapper_rejects_non_contiguous():
    w = torch.zeros((32, 8), dtype=torch.uint32).T
    with pytest.raises(ValueError):
        smul.scalar_mul(w)
