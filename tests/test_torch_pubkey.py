"""vuke_tpu_torch's lane-major derive API (``ecc/pubkey.py``) against the
JAX package's ``vuke_tpu.ecc.pubkey``, the tile-layout path and the host.

``derive_hash160s`` runs under both scalar-multiplication kernels (K3 and
K6, their plain versions on the CPU) on 37 lanes, a count that is not a
multiple of the inversion chunk, so the pad to 48 lanes and its removal are
exercised.  Exact (tolerance 0).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vuke_tpu.ecc.pubkey as jpubkey
from vuke_tpu.ecc import ref
from vuke_tpu_torch.ecc import pubkey, tiled

from test_torch_smul_w8 import ADVERSARIAL, raw_scalars, words_be

LANES = 37


def _np(t):
    return t.to(torch.int64).numpy()


@pytest.mark.parametrize("shape", [(-1, 8), (2, -1, 8)])
def test_normalize_scalar_matches_jax(shape):
    w = words_be(ADVERSARIAL + [ref.N + 7, 5, 6]).T.copy().reshape(shape)
    want = np.asarray(jpubkey.normalize_scalar(jnp.asarray(w)))
    got = pubkey.normalize_scalar(torch.from_numpy(w))
    assert got.shape == w.shape
    assert np.array_equal(_np(got), want)


@pytest.fixture(scope="module")
def lanes():
    """37 normalized scalars (lane-major), padded to 48 for the tile path."""
    ks = [k % ref.N or 1 for k in raw_scalars()]
    ks += [int.from_bytes(np.random.RandomState(9).bytes(32), "big") % (ref.N - 1) + 1
           for _ in range(48 - len(ks))]
    return ks, torch.from_numpy(words_be(ks))


@pytest.fixture(scope="module")
def tile_path(lanes):
    return tiled.derive_tiled_from_words(lanes[1])


@pytest.fixture(scope="module")
def host_points(lanes):
    """``ref.point_mul`` of the first lanes: the adversarial and seeded
    random scalars of ``raw_scalars``."""
    return [ref.point_mul(k) for k in lanes[0][:len(raw_scalars())]]


@pytest.mark.parametrize("smul13", [True, False])
def test_derive_hash160s_matches_tile_path_and_host(lanes, tile_path, host_points, smul13):
    _, words48 = lanes
    words = words48.T[:LANES].contiguous()
    d = pubkey.derive_hash160s(words, smul13=smul13)
    assert d["h160c"].shape == d["h160u"].shape == (LANES, 5)
    assert d["x_words"].shape == d["y_words"].shape == (LANES, 8)
    assert d["y_odd"].shape == (LANES,) and d["y_odd"].dtype == torch.bool
    for key in ("h160c", "h160u"):
        assert np.array_equal(_np(d[key]), _np(tile_path[key])[:LANES])

    xs, ys, hc, hu = _np(d["x_words"]), _np(d["y_words"]), _np(d["h160c"]), _np(d["h160u"])
    for j, (ex, ey) in enumerate(host_points):
        assert sum(int(v) << (32 * (7 - i)) for i, v in enumerate(xs[j])) == ex
        assert sum(int(v) << (32 * (7 - i)) for i, v in enumerate(ys[j])) == ey
        assert bool(d["y_odd"][j]) == bool(ey & 1)
        xb = ex.to_bytes(32, "big")
        comp = bytes([2 + (ey & 1)]) + xb
        uncomp = b"\x04" + xb + ey.to_bytes(32, "big")
        for pub, h in ((comp, hc[j]), (uncomp, hu[j])):
            want = hashlib.new("ripemd160", hashlib.sha256(pub).digest()).digest()
            assert b"".join(int(v).to_bytes(4, "little") for v in h) == want

    px, py, podd = pubkey.derive_pubkey(words, smul13=smul13)
    assert torch.equal(px, d["x_words"]) and torch.equal(py, d["y_words"])
    assert torch.equal(podd, d["y_odd"])


def test_hash160_fragment_matches_jax(tile_path):
    h = _np(tile_path["h160c"]).astype(np.uint32)
    want = jpubkey.hash160_fragment(jnp.asarray(h))
    got = pubkey.hash160_fragment(torch.from_numpy(h))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    for g, w in zip(got, tile_path["frag_c"]):
        assert torch.equal(g, w)


def test_scalar_digits_refuses_unported_modes():
    with pytest.raises(ValueError, match="not ported"):
        pubkey.scalar_digits(torch.zeros((4, 8), dtype=torch.uint32), 10, True)
