"""The frozen operation counts: run on known words they compute the real
outputs, and they count what the program's own table counts today."""

import hashlib

import pytest

from portbench import work
from portbench.reference import address, mt


def _words(b: bytes) -> list:
    return [int.from_bytes(b[i:i + 4], "big") for i in range(0, len(b), 4)]


def _ops(o) -> tuple:
    return (o.mul, o.alu, o.add)


def test_sha256_block_on_known_words():
    msg = b"abc" + b"\x80" + bytes(52) + (24).to_bytes(8, "big")
    t = work.Trace()
    out = work.sha256_block(t, work.SHA_IV, _words(msg))
    assert bytes.fromhex("".join(f"{w:08x}" for w in out)) == hashlib.sha256(b"abc").digest()
    assert _ops(t.ops) == (0, 0, 0)


def test_hash160_lane_on_a_known_point():
    from portbench.reference import secp256k1

    x, y = secp256k1.point_mul(12345)
    t = work.Trace()
    hc, hu, frags = work.hash160_lane(t, _words(x.to_bytes(32, "big")),
                                      _words(y.to_bytes(32, "big")))
    want_c, want_u = address.hash160s((12345).to_bytes(32, "big"))
    assert b"".join(w.to_bytes(4, "little") for w in hc) == want_c
    assert b"".join(w.to_bytes(4, "little") for w in hu) == want_u
    assert frags[0] == int.from_bytes(want_c[:4], "big")


@pytest.mark.parametrize("seed", [0, 5489, 0xFFFFFFFF])
def test_mt19937_lane_on_known_seeds(seed):
    t = work.Trace()
    key = work.mt19937_lane(t, seed)
    assert b"".join(w.to_bytes(4, "big") for w in key) == mt.milksad_key(seed)


@pytest.mark.parametrize("seed", [0, 5489, (1 << 64) - 1])
def test_mt64_lane_on_known_seeds(seed):
    t = work.Trace()
    key = work.mt64_lane(t, seed >> 32, seed & 0xFFFFFFFF, 2)
    got = b"".join(w.to_bytes(4, "big") for w in key)
    assert got == b"".join(mt.mt64_keys(seed, 2))


def test_counts_match_the_programs_table():
    from vuke_tpu_torch.kernels import work as prog

    assert _ops(work.smul()) == _ops(prog.smul())
    assert _ops(work.inv_affine(16)) == _ops(prog.inv_affine(16))
    assert _ops(work.hash160()) == _ops(prog.hash160())
    assert _ops(work.mt19937() + work.NORMALIZE) == _ops(prog.mt19937())
    assert _ops(work.keygen_hash("sha256", 10)) == _ops(prog.keygen_hash("sha256", 10))
    for fam, mode, reach in (("milksad", "exact", (1.0, 0.0)), ("mt64", "cascade", (1.0, 0.0)),
                             ("mt64", "cascade", (1.0, 0.5))):
        assert _ops(work.sweep_prng(fam, mode, reach)) == _ops(
            prog.sweep_prng(fam, mode, reach=reach))


def test_bounds_at_the_scan_and_sweep_sizes():
    # a superbatch of 2^19 milksad seeds, and a sweep batch of 2^24 seeds
    assert work.smul().seconds(1 << 19) == pytest.approx(1.0720e-3, rel=1e-3)
    assert work.derive_seconds(work.mt19937(), 1 << 19, 1) == pytest.approx(1.3096e-3, rel=1e-3)
    assert work.sweep_prng("milksad", "exact", (1.0, 0.0)).seconds(1 << 24) == pytest.approx(
        0.8084e-3, rel=1e-3)
