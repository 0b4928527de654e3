"""vuke_tpu_torch byte-window scalar multiplication (K6's plain version)
against the JAX package.

The JAX side runs ``pallas_smul``'s 16-bit row helpers eagerly under numpy
(no jit, no interpret mode): ``_smul_kernel``'s window loop is restated
with ``_mul_t``, ``_sub_t``, ``_add_t`` and ``_select_t``, and its lookup
as the same one-hot float32 product over ``_table_f32()[w]``.  Results are
compared as affine points (projective values equal mod p) and against the
bignum oracle.  Exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vuke_tpu.ecc.pallas_smul as ps
import vuke_tpu.ecc.pallas_smul13 as m13
import vuke_tpu.ecc.pubkey as jpubkey
from vuke_tpu.ecc import ref
from vuke_tpu.ecc import tiled as jtiled
from vuke_tpu_torch import params
from vuke_tpu_torch.ecc import pubkey, smul_w8

N, P = ref.N, ref.P

# Before normalization.  Zero low windows below the only digit (256, 2^32,
# 2^248), one window only (1, 255), and the top window at its limits: n - 1
# (top byte 0xFF) and the largest k < n whose low 31 bytes are all 0xFF.
ADVERSARIAL = [0, 1, 2, 255, 256, 257, 1 << 32, 1 << 128, 1 << 248, 1 << 255,
               N - 1, N - 2, N, N + 1, (1 << 256) - 1, (0xFF << 248) - 1, 0xFF << 248]


def raw_scalars():
    rng = np.random.RandomState(8)
    return ADVERSARIAL + [int.from_bytes(rng.bytes(32), "big") for _ in range(11)]


def words_be(ks) -> np.ndarray:
    """Python ints -> (8, L) uint32 BE words."""
    return np.array([[(k >> (32 * (7 - i))) & 0xFFFFFFFF for k in ks] for i in range(8)],
                    dtype=np.uint32)


def jax_k6_chain(norm_be: np.ndarray):
    """``pallas_smul._smul_kernel``'s window loop on numpy rows: (8, L)
    normalized BE words -> X, Y, ZZ, ZZZ as lists of 16 (L,) uint32 rows."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ps, jtiled):
            mp.setattr(mod, "jnp", np)
        tab = ps._table_f32()
        digs = jtiled._digits_t(norm_be)                      # (32, L)
        lanes = norm_be.shape[1]
        zero = [np.zeros(lanes, np.uint32) for _ in range(16)]
        one = [np.full(lanes, np.uint32(1 if i == 0 else 0)) for i in range(16)]
        X, Y, ZZ, ZZZ = zero, zero, zero, zero
        acc_inf = np.ones(lanes, np.uint32)
        iota = np.arange(256, dtype=np.uint32)[:, None]
        for w in range(32):
            d = digs[w]
            onehot = (d[None, :] == iota).astype(np.float32)  # (256, L)
            e = (tab[w].T @ onehot).astype(np.int32).astype(np.uint32)
            x2, y2 = [e[i] for i in range(16)], [e[16 + i] for i in range(16)]
            H = ps._sub_t(ps._mul_t(x2, ZZ), X)
            R = ps._sub_t(ps._mul_t(y2, ZZZ), Y)
            HH = ps._mul_t(H, H)
            HHH = ps._mul_t(H, HH)
            V = ps._mul_t(X, HH)
            X3 = ps._sub_t(ps._sub_t(ps._mul_t(R, R), HHH), ps._add_t(V, V))
            Y3 = ps._sub_t(ps._mul_t(R, ps._sub_t(V, X3)), ps._mul_t(Y, HHH))
            ZZ3, ZZZ3 = ps._mul_t(ZZ, HH), ps._mul_t(ZZZ, HHH)
            inf_b, d_zero = acc_inf != 0, d == 0
            new = [ps._select_t(inf_b, s, a) for s, a in
                   ((x2, X3), (y2, Y3), (one, ZZ3), (one, ZZZ3))]
            X, Y, ZZ, ZZZ = [ps._select_t(d_zero, old, nw)
                             for old, nw in zip((X, Y, ZZ, ZZZ), new)]
            acc_inf = acc_inf * d_zero.astype(np.uint32)
    return X, Y, ZZ, ZZZ


def _affine(X, Y, ZZ, ZZZ, val, lanes):
    return [(val(X, j) * pow(val(ZZ, j), -1, P) % P, val(Y, j) * pow(val(ZZZ, j), -1, P) % P)
            for j in range(lanes)]


def _row_val(rows, j):
    return sum(int(r[j]) << (16 * i) for i, r in enumerate(rows))


def _le32_val(limbs, j):
    return sum(int(v) << (32 * i) for i, v in enumerate(limbs[:, j]))


@pytest.mark.parametrize("wbits,signed", [(8, False), (10, "odd")])
def test_scalar_digits_match_jax(monkeypatch, wbits, signed):
    """The port's lane-major ``pubkey.scalar_digits`` against the JAX one
    (numpy), and for bytes ``smul_w8.byte_digits`` against ``_digits_t``."""
    ks = [k % N or 1 for k in raw_scalars()]
    w = words_be(ks)
    if wbits == 8:
        want_t = np.asarray(jtiled._digits_t(jnp.asarray(w)))
        got_t = smul_w8.byte_digits(torch.from_numpy(w)).to(torch.int64).numpy()
        assert got_t.shape == (32, len(ks))
        assert np.array_equal(got_t, want_t)
    monkeypatch.setattr(jpubkey, "jnp", np)
    monkeypatch.setattr(m13, "jnp", np)
    want = jpubkey.scalar_digits(w.T.copy(), wbits, signed)
    got = pubkey.scalar_digits(torch.from_numpy(w.T.copy()), wbits, signed)
    assert np.array_equal(got.to(torch.int64).numpy(), want)


def test_byte_digits_window_order():
    """Window w is byte w % 4 of BE word 7 - w // 4, lowest byte first."""
    k = sum((w + 1) << (8 * w) for w in range(32))
    d = smul_w8.byte_digits(torch.from_numpy(words_be([k]))).to(torch.int64)
    assert d[:, 0].tolist() == list(range(1, 33))


def test_table_w8_from_jax_equals_port_table():
    assert np.array_equal(params.table_w8_from_jax(ps._table_f32()), smul_w8.window_table())


@pytest.mark.parametrize("w,d", [(0, 0), (0, 1), (0, 255), (9, 128), (31, 1), (31, 255)])
def test_table_rows_are_byte_multiples(w, d):
    e = smul_w8.window_table()[w, d].astype(object)
    x = sum(int(v) << (32 * i) for i, v in enumerate(e[:8]))
    y = sum(int(v) << (32 * i) for i, v in enumerate(e[8:]))
    assert (x, y) == ((0, 0) if d == 0 else ref.point_mul(d << (8 * w)))


def test_plain_chain_matches_jax_window_loop_and_oracle():
    ks = [k % N or 1 for k in raw_scalars()]
    w = words_be(ks)
    want = _affine(*jax_k6_chain(w), _row_val, len(ks))
    outs = [t.to(torch.int64).numpy() for t in smul_w8.scalar_mul(torch.from_numpy(w))]
    for t in outs:
        assert (t >= 0).all() and (t < 1 << 32).all()
    got = _affine(*outs, _le32_val, len(ks))
    assert got == want
    assert got == [ref.point_mul(k) for k in ks]


def test_wrapper_rejects_non_contiguous():
    with pytest.raises(ValueError):
        smul_w8.scalar_mul(torch.zeros((32, 8), dtype=torch.uint32).T)
