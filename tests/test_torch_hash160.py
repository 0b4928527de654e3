"""vuke_tpu_torch hash160 (K2's plain version) against the JAX package.

``_hash160_kernel``'s body runs eagerly under numpy, one (8, 128) tile per
call, and ``hashlib`` checks a sample of lanes.  The fragments K2 writes in
its epilogue against that body followed by ``byteswap32`` of digest words 0
and 1, as ``vuke_tpu/ecc/tiled.py:443-446`` takes them.  Lane-exact
(tolerance 0).
"""

import hashlib

import numpy as np
import pytest
import torch

import vuke_tpu.cores.pallas_kernels as pk
from vuke_tpu.cores.common import byteswap32
from vuke_tpu_torch.cores import hash160

N = 2048


def _xy(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (8, N), dtype=np.uint32)
    y = rng.integers(0, 1 << 32, (8, N), dtype=np.uint32)
    x[:, 0] = 0
    y[:, 0] = 0xFFFFFFFF                            # odd y, all-ones bytes
    x[:, 1] = 0xFFFFFFFF
    y[:, 1] = 0                                     # even y
    return x, y


def _port(x, y):
    hc, hu = hash160.hash160s(torch.from_numpy(x), torch.from_numpy(y))
    return hc.to(torch.int64).numpy(), hu.to(torch.int64).numpy()


def _jax_tiles(x, y):
    hc = np.zeros((5, N), dtype=np.uint32)
    hu = np.zeros((5, N), dtype=np.uint32)
    for t in range(N // 1024):
        sl = slice(1024 * t, 1024 * (t + 1))
        oc = np.zeros((5, 1, 8, 128), dtype=np.uint32)
        ou = np.zeros((5, 1, 8, 128), dtype=np.uint32)
        pk._hash160_kernel(x[:, sl].reshape(8, 1, 8, 128), y[:, sl].reshape(8, 1, 8, 128),
                           (y[7, sl] & np.uint32(1)).reshape(1, 8, 128), oc, ou)
        hc[:, sl] = oc.reshape(5, 1024)
        hu[:, sl] = ou.reshape(5, 1024)
    return hc, hu


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_body(monkeypatch, seed):
    monkeypatch.setattr(pk, "jnp", np)
    x, y = _xy(seed)
    hc, hu = _port(x, y)
    jc, ju = _jax_tiles(x, y)
    assert np.array_equal(hc, jc)
    assert np.array_equal(hu, ju)


def test_plain_matches_hashlib():
    x, y = _xy(2)
    hc, hu = _port(x, y)

    def h160(b):
        return hashlib.new("ripemd160", hashlib.sha256(b).digest()).digest()

    for j in [0, 1, 2, 777, N - 1]:
        xb = b"".join(int(v).to_bytes(4, "big") for v in x[:, j])
        yb = b"".join(int(v).to_bytes(4, "big") for v in y[:, j])
        assert b"".join(int(v).to_bytes(4, "little") for v in hc[:, j]) == \
            h160(bytes([2 + (yb[-1] & 1)]) + xb)
        assert b"".join(int(v).to_bytes(4, "little") for v in hu[:, j]) == \
            h160(b"\x04" + xb + yb)


@pytest.mark.parametrize("seed", [0, 1])
def test_fragments_match_pallas_kernel_body_then_byteswap(monkeypatch, seed):
    monkeypatch.setattr(pk, "jnp", np)
    x, y = _xy(seed)
    hc, hu, fc, fu = hash160.hash160s_and_fragments(torch.from_numpy(x), torch.from_numpy(y))
    jc, ju = _jax_tiles(x, y)
    assert np.array_equal(hc.to(torch.int64).numpy(), jc)
    assert np.array_equal(hu.to(torch.int64).numpy(), ju)
    want = [byteswap32(jc[0]), byteswap32(jc[1]), byteswap32(ju[0]), byteswap32(ju[1])]
    for g, w in zip((*fc, *fu), want):
        assert g.dtype == torch.uint32 and g.shape == (N,)
        assert np.array_equal(g.to(torch.int64).numpy(), w)


def test_fragments_are_the_first_eight_digest_bytes():
    x, y = _xy(3)
    hc, hu, fc, fu = hash160.hash160s_and_fragments(torch.from_numpy(x), torch.from_numpy(y))
    for h, (hi, lo) in ((hc, fc), (hu, fu)):
        h, hi, lo = (t.to(torch.int64).numpy() for t in (h, hi, lo))
        for j in [0, 1, 5, N - 1]:
            digest = b"".join(int(v).to_bytes(4, "little") for v in h[:, j])
            assert int(hi[j]).to_bytes(4, "big") + int(lo[j]).to_bytes(4, "big") == digest[:8]


def test_cpu_tensor_never_launches():
    x, y = (torch.from_numpy(a) for a in _xy(4))
    before = hash160.KERNEL.launches
    got = hash160.hash160s_and_fragments(x, y)
    want = hash160.hash160s_and_fragments_plain(x, y)
    assert hash160.KERNEL.launches == before
    flat = [got[0], got[1], *got[2], *got[3]]
    for g, w in zip(flat, [want[0], want[1], *want[2], *want[3]]):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))


def test_wrapper_rejects_mismatched_batch():
    with pytest.raises(ValueError):
        hash160.hash160s(torch.zeros((8, 32), dtype=torch.uint32),
                         torch.zeros((8, 64), dtype=torch.uint32))


def test_fragments_wrapper_rejects_mismatched_batch():
    with pytest.raises(ValueError):
        hash160.hash160s_and_fragments(torch.zeros((8, 32), dtype=torch.uint32),
                                       torch.zeros((8, 64), dtype=torch.uint32))
