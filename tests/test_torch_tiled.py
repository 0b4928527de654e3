"""The whole vuke_tpu_torch derive slice against the JAX package's pieces.

2048 milksad seeds (two (8, 128) tiles, seeds 0, 1 and 2^32-1 included).
The JAX side is composed from its own pieces without a jit:
``_mt_kernel`` (numpy) -> ``tiled._normalize_words_t`` (eager jax on the
CPU) -> ``odd_encode_rows`` + the ``_madd13`` window chain (numpy) ->
``_rows13_to16`` -> affine by ``_mul_t``/``_normalize16`` with host bignum
inverses -> ``tiled._limbs_to_words_t`` -> ``_hash160_kernel`` (numpy) ->
``byteswap32`` fragments.  h160c, h160u and both fragments must be equal.
With ``smul13=False`` the scalar multiplication is K6's instead: the
``_smul_kernel`` window loop over byte digits
(``test_torch_smul_w8.jax_k6_chain``).  The derive dicts are also held
against the stages composed as they were before K1 normalized and K2
wrote the fragments (normalize, then hash160, then ``fragments``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vuke_tpu.cores.pallas_kernels as pk
import vuke_tpu.ecc.pallas_inv as pinv
import vuke_tpu.ecc.pallas_smul as ps
import vuke_tpu.ecc.pallas_smul13 as m13
from vuke_tpu.cores.common import byteswap32
from vuke_tpu.ecc import ref
from vuke_tpu.ecc import tiled as jtiled
import chip_smoke
from vuke_tpu_torch.cores import hash160, mt19937
from vuke_tpu_torch.ecc import scalar, tiled

from test_torch_smul_w8 import jax_k6_chain

N = 2048
P = ref.P


def _seeds():
    s = np.random.default_rng(7).integers(0, 1 << 32, N, dtype=np.uint32)
    s[:4] = [0, 1, 0xFFFFFFFF, 5489]
    return s


def _jax_k3_chain(norm):
    """The odd-digit ``_madd13`` window chain -> 16-bit X, Y, ZZ, ZZZ rows."""
    tab = m13._table13_f32(10, "odd")
    digs = m13.odd_encode_rows([norm[i] for i in range(8)], 10)

    def lookup(win):
        d = digs[win]
        e = tab[win, d & np.uint32(0x7FFF), :].astype(np.int32).astype(np.uint32)
        x2 = [e[:, i] for i in range(m13.L13)]
        y2 = [e[:, m13.L13 + i] for i in range(m13.L13)]
        return x2, m13._select13((d >> np.uint32(15)) != 0, m13._neg13(y2), y2)

    one = [np.full(N, np.uint32(1 if i == 0 else 0)) for i in range(m13.L13)]
    X, Y = lookup(0)
    ZZ, ZZZ = list(one), list(one)
    for win in range(1, 26):
        X, Y, ZZ, ZZZ = m13._madd13(X, Y, ZZ, ZZZ, *lookup(win))
    return tuple(m13._rows13_to16(a) for a in (X, Y, ZZ, ZZZ))


def _jax_derive(seeds, monkeypatch, smul13=True):
    kw = np.zeros((8, N // 1024, 8, 128), dtype=np.uint32)
    with monkeypatch.context() as m:
        m.setattr(pk, "jnp", np)
        pk._mt_kernel(seeds.reshape(N // 1024, 8, 128), kw)
    norm = np.asarray(jtiled._normalize_words_t(jnp.asarray(kw.reshape(8, N))))
    for mod in (m13, ps, pinv, pk, jtiled):
        monkeypatch.setattr(mod, "jnp", np)

    X, Y, ZZ, ZZZ = (_jax_k3_chain if smul13 else jax_k6_chain)(norm)

    def val(rows, j):
        return sum(int(r[j]) << (16 * i) for i, r in enumerate(rows))

    it = [pow(val(ZZ, j) * val(ZZZ, j) % P, -1, P) for j in range(N)]
    it = [np.array([(v >> (16 * i)) & 0xFFFF for v in it], dtype=np.uint32) for i in range(16)]
    x = pinv._normalize16(ps._mul_t(ps._mul_t(X, it), ZZZ))
    y = pinv._normalize16(ps._mul_t(ps._mul_t(Y, it), ZZ))
    xw = jtiled._limbs_to_words_t(x)
    yw = jtiled._limbs_to_words_t(y)

    hc = np.zeros((5, N), dtype=np.uint32)
    hu = np.zeros((5, N), dtype=np.uint32)
    for t in range(N // 1024):
        sl = slice(1024 * t, 1024 * (t + 1))
        oc = np.zeros((5, 1, 8, 128), dtype=np.uint32)
        ou = np.zeros((5, 1, 8, 128), dtype=np.uint32)
        pk._hash160_kernel(xw[:, sl].reshape(8, 1, 8, 128), yw[:, sl].reshape(8, 1, 8, 128),
                           (y[0][sl] & np.uint32(1)).reshape(1, 8, 128), oc, ou)
        hc[:, sl] = oc.reshape(5, 1024)
        hu[:, sl] = ou.reshape(5, 1024)
    return {"norm": norm, "h160c": hc.T, "h160u": hu.T,
            "frag_c": (byteswap32(hc[0]), byteswap32(hc[1])),
            "frag_u": (byteswap32(hu[0]), byteswap32(hu[1]))}


def _np(t):
    return t.to(torch.int64).numpy()


def _port_and_jax(smul13):
    seeds = _seeds()
    mp = pytest.MonkeyPatch()
    try:
        want = _jax_derive(seeds, mp, smul13)
    finally:
        mp.undo()
    got = tiled.derive_hash160s_tiled(torch.from_numpy(seeds), smul13=smul13)
    return seeds, got, want


@pytest.fixture(scope="module")
def port_and_jax():
    return _port_and_jax(True)


@pytest.fixture(scope="module")
def port_and_jax_k6():
    return _port_and_jax(False)


@pytest.mark.parametrize("key", ["h160c", "h160u"])
def test_hash160s_match_jax(port_and_jax, key):
    _, got, want = port_and_jax
    assert got[key].shape == (N, 5)
    assert np.array_equal(_np(got[key]), want[key])


@pytest.mark.parametrize("key", ["frag_c", "frag_u"])
def test_fragments_match_jax(port_and_jax, key):
    _, got, want = port_and_jax
    for g, w in zip(got[key], want[key]):
        assert g.shape == (N,)
        assert np.array_equal(_np(g), w)


@pytest.mark.parametrize("key", ["h160c", "h160u", "frag_c", "frag_u"])
def test_k6_slice_matches_jax(port_and_jax_k6, key):
    """The slice with ``smul13=False`` (K6's plain version) against the JAX
    pieces composed with the K6 window loop."""
    _, got, want = port_and_jax_k6
    pairs = zip(got[key], want[key]) if key.startswith("frag") else [(got[key], want[key])]
    for g, w in pairs:
        assert np.array_equal(_np(g), w)


def test_derive_from_words_matches_seed_path(port_and_jax):
    seeds, got, want = port_and_jax
    words = mt19937.milksad_key_words(torch.from_numpy(seeds[:256]))
    d = tiled.derive_tiled_from_words(words)
    assert np.array_equal(_np(d["norm"]), want["norm"][:, :256].T)
    assert np.array_equal(_np(d["h160c"]), want["h160c"][:256])
    assert np.array_equal(_np(d["h160u"]), want["h160u"][:256])


@pytest.mark.parametrize("k", [0, 1, ref.N - 1, ref.N, ref.N + 5, (1 << 256) - 1])
def test_normalize_words_matches_jax(k):
    w = np.array([[(k >> (32 * (7 - i))) & 0xFFFFFFFF] for i in range(8)], dtype=np.uint32)
    got = _np(tiled.normalize_words(torch.from_numpy(w)))
    assert np.array_equal(got, np.asarray(jtiled._normalize_words_t(jnp.asarray(w))))
    assert sum(int(got[i, 0]) << (32 * (7 - i)) for i in range(8)) == (k % ref.N or 1)


def test_normalize_words_on_the_edge_set_matches_jax():
    """Every ``chip_smoke.scalar_edge`` word (0, 1, n-1, n, n+1, 2^256-1,
    n's top seven words with each edge low word, n with one word changed)
    in one batch: against ``_normalize_words_t`` and k mod n (0 -> 1)."""
    edge = chip_smoke.scalar_edge()
    w = chip_smoke.words_be(edge)
    got = _np(tiled.normalize_words(w))
    assert np.array_equal(got, np.asarray(jtiled._normalize_words_t(jnp.asarray(w.numpy()))))
    for j, k in enumerate(edge):
        assert sum(int(got[i, j]) << (32 * (7 - i)) for i in range(8)) == (k % ref.N or 1)
    assert np.array_equal(_np(scalar.normalize_words_plain(w)), got)


def _parent_core(norm):
    """The derive as composed before K1 normalized and K2 wrote the
    fragments: K3 -> K4 -> hash160 -> ``fragments`` (plain stages)."""
    hc, hu = hash160.hash160s_plain(*tiled.affine_points(norm, plain=True))
    return {"h160c": hc.T, "h160u": hu.T, "frag_c": hash160.fragments(hc),
            "frag_u": hash160.fragments(hu)}


def _assert_same_dict(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        pairs = zip(got[key], w) if key.startswith("frag") else [(got[key], w)]
        for g, ww in pairs:
            assert g.dtype == ww.dtype == torch.uint32 and g.shape == ww.shape
            assert torch.equal(g.to(torch.int64), ww.to(torch.int64))


@pytest.mark.parametrize("plain", [False, True])
def test_derive_dicts_unchanged_against_the_parent_composition(plain):
    seeds = torch.from_numpy(_seeds()[:64])
    words = mt19937.milksad_key_words_plain(seeds)
    norm = scalar.normalize_words_plain(words)
    want = _parent_core(norm)
    _assert_same_dict(tiled.derive_hash160s_tiled(seeds, plain=plain), want)
    got = tiled.derive_tiled_from_words(words, plain=plain)
    assert torch.equal(got.pop("norm").to(torch.int64), norm.T.to(torch.int64))
    _assert_same_dict(got, want)


def test_seed_derive_normalizes_in_keygen(monkeypatch):
    """The seed path takes normalized words from K1 (``normalize=True``)
    and never runs the standalone normalize between K1 and K3."""
    seeds = torch.from_numpy(_seeds()[:32])
    want = tiled.derive_hash160s_tiled(seeds)

    def refused(words):
        raise AssertionError("the seed derive ran normalize_words")

    monkeypatch.setattr(tiled, "normalize_words", refused)
    _assert_same_dict(tiled.derive_hash160s_tiled(seeds), want)
    with pytest.raises(AssertionError, match="ran normalize_words"):
        tiled.derive_tiled_from_words(mt19937.milksad_key_words(seeds))


def test_plain_flag_runs_the_same_stages():
    seeds = torch.from_numpy(_seeds()[:64])
    a = tiled.derive_hash160s_tiled(seeds)
    b = tiled.derive_hash160s_tiled(seeds, plain=True)
    assert np.array_equal(_np(a["h160u"]), _np(b["h160u"]))


@pytest.mark.parametrize("value", [None, "0", "false", "no", "1", "yes", ""])
def test_use_smul13_reads_the_switch_like_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("VUKE_TPU_SMUL13", raising=False)
    else:
        monkeypatch.setenv("VUKE_TPU_SMUL13", value)
    assert tiled.use_smul13() == jtiled.use_smul13()
    assert tiled.use_smul13(True) and not tiled.use_smul13(False)
