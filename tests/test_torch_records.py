"""E1's plain version and the host's columns against the JAX package.

``cores/records.records_plain`` (the rows E1 writes on the card) against the
JAX ``KeyDeriver.derive`` on the edge keys (1, 2, 9, 10^9 - 1, 10^9, 2^32,
2^255, n - 1, keys with 1 to 31 leading zero bytes) and 256 seeded keys,
for the four networks; ``host_columns`` (the key's hex and bits, both public
keys) against the same; ``RecordBlock``'s ``DerivedKey``s and its lines
through a console; E1's
operation count (``kernels/work.records``) against a counted run that,
on known words, computes the same strings.  Tolerance 0 everywhere.

The public points are the port's ``ecc/ref.point_mul`` (held against the
JAX package's in ``tests/test_torch_host.py``), handed to the JAX
``KeyDeriver`` in place of its own (an affine ladder, ~70 ms a key where
its native one is not built); every encoding compared is the JAX
package's.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import vuke_tpu.derive as jderive
from vuke_tpu import encode as jencode
from vuke_tpu_torch import encode
from vuke_tpu_torch.cores import records as rec
from vuke_tpu_torch.ecc import ref
from vuke_tpu_torch.kernels import work

NETWORKS = ["bitcoin", "testnet", "signet", "regtest"]


def _keys():
    rng = np.random.default_rng(2026)
    edge = chip_smoke.record_edge_keys(rng)
    return edge + [int.from_bytes(rng.bytes(32), "big") % (ref.N - 1) + 1 for _ in range(256)]


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * (7 - j))) & 0xFFFFFFFF for j in range(8)] for v in vals],
                    dtype=np.uint32)


def _t(a) -> torch.Tensor:
    """(M, R) uint32 rows -> (R, M) uint32 words."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32).T)
                            .view(np.int32)).view(torch.uint32)


@pytest.fixture(scope="module")
def lanes():
    """The keys, their points and digests: (keys, x, y, h160c, h160u)."""
    keys = _keys()
    pts = [ref.point_mul(k) for k in keys]
    hc, hu = [], []
    for x, y in pts:
        xb = x.to_bytes(32, "big")
        hc.append(np.frombuffer(jencode.hash160(bytes([2 + (y & 1)]) + xb), "<u4"))
        hu.append(np.frombuffer(jencode.hash160(b"\x04" + xb + y.to_bytes(32, "big")), "<u4"))
    return keys, pts, np.array(hc), np.array(hu)


@pytest.fixture(scope="module")
def jax_derived(lanes):
    """The JAX ``KeyDeriver.derive`` of every key on every network."""
    keys, pts, _, _ = lanes
    by_k = dict(zip(keys, pts))
    saved = jderive._pubkey_point
    jderive._pubkey_point = lambda k, key: by_k[k]
    try:
        return {net: [jderive.KeyDeriver(jencode.parse_network(net)).derive(k.to_bytes(32, "big"))
                      for k in keys] for net in NETWORKS}
    finally:
        jderive._pubkey_point = saved


@pytest.mark.parametrize("net", NETWORKS)
def test_records_plain_is_the_jax_derive(lanes, jax_derived, net):
    """Every field of every row: decimal, both WIFs, both P2PKH, P2WPKH,
    bit length, Hamming weight, leading zero hex digits."""
    keys, _, hc, hu = lanes
    rows = rec.records_plain(_t(_words(keys)), _t(hc), _t(hu), encode.NETWORKS[net]).numpy()
    assert rows.shape == (len(keys), rec.ROW)
    assert not rows[:, rec.STATS + 5:].any()
    for j, d in enumerate(jax_derived[net]):
        got = chip_smoke.record_row_strings(rows, j)
        assert got == {"private_key_decimal": d.private_key_decimal,
                       "wif_compressed": d.wif_compressed, "wif_uncompressed": d.wif_uncompressed,
                       "address_p2pkh_compressed": d.p2pkh_compressed,
                       "address_p2pkh_uncompressed": d.p2pkh_uncompressed,
                       "address_p2wpkh": d.p2wpkh,
                       "stats": (d.bit_length, d.hamming_weight, d.leading_zeros)}, j


def test_host_columns_are_the_jax_derive(lanes, jax_derived):
    keys, pts, _, _ = lanes
    cols = rec.host_columns(_words(keys), _words([p[0] for p in pts]),
                            _words([p[1] for p in pts]))
    text = lambda name, j: bytes(cols[name][j]).decode()  # noqa: E731
    for j, d in enumerate(jax_derived["bitcoin"]):
        assert bytes(cols["private_key_raw"][j]) == d.raw
        assert text("private_key_hex", j) == d.private_key_hex
        assert text("private_key_binary", j) == d.private_key_binary
        assert text("pubkey_compressed", j) == d.pubkey_compressed
        assert text("pubkey_uncompressed", j) == d.pubkey_uncompressed


@pytest.mark.parametrize("net", ["bitcoin", "regtest"])
def test_record_block_derives_and_lines(lanes, jax_derived, net):
    """A block's ``DerivedKey``s equal the JAX derive's, field for field;
    through ``emit_block`` a console writes the compact lines of
    ``pipeline.format_lines`` fed E1's P2PKH field, and in verbose mode the
    JAX console's block a record."""
    import functools
    import io

    from vuke_tpu.output.console import ConsoleOutput as JConsole
    from vuke_tpu_torch import pipeline
    from vuke_tpu_torch.output import ConsoleOutput

    keys, pts, hc, hu = lanes
    rows = rec.records_plain(_t(_words(keys)), _t(hc), _t(hu), encode.NETWORKS[net]).numpy()
    first, m = 10 ** 12, len(keys)
    off, width = rec.field_span("address_p2pkh_compressed")
    lines = functools.partial(pipeline.write_lines, first, [""], "md5", _words(keys)[None],
                              rows[None, :, off:off + width], np.ones((1, m), dtype=bool))
    block = rec.RecordBlock("md5", [str(first + j) for j in range(m)], _words(keys),
                            _words([p[0] for p in pts]), _words([p[1] for p in pts]), rows,
                            lines)
    got = block.derived()
    for g, d in zip(got, jax_derived[net]):
        assert vars(g) == vars(d)
    buf, vbuf, jbuf = io.StringIO(), io.StringIO(), io.StringIO()
    rec.emit_block(ConsoleOutput(buf), block)
    assert buf.getvalue() == "".join(f"{first + j},md5,{d.private_key_hex},{d.p2pkh_compressed}\n"
                                     for j, d in enumerate(jax_derived[net]))
    rec.emit_block(ConsoleOutput(vbuf, verbose=True), block)
    jconsole = JConsole(jbuf, verbose=True)
    for j, d in enumerate(jax_derived[net]):
        jconsole.key(str(first + j), "md5", d)
    assert vbuf.getvalue() == jbuf.getvalue()


def test_records_wrapper_checks_its_inputs():
    w, h = torch.zeros((8, 4), dtype=torch.uint32), torch.zeros((5, 4), dtype=torch.uint32)
    assert rec.encode_records(w[:, :0].contiguous(), h[:, :0].contiguous(),
                              h[:, :0].contiguous()).shape == (0, rec.ROW)
    with pytest.raises(ValueError, match="differ in N"):
        rec.encode_records(w, h[:, :3].contiguous(), h)
    with pytest.raises(TypeError):
        rec.encode_records(w.to(torch.int64), h, h)
    with pytest.raises(ValueError, match="hrp"):
        rec.network_params(encode.Network("x", 0, 0x80, "toolong"))
    assert rec.network_params(encode.REGTEST)[2:4] == (int.from_bytes(b"bcrt", "little"), 4)


@pytest.mark.parametrize("net", NETWORKS)
def test_counted_records_is_the_jax_derive(lanes, jax_derived, net):
    """E1's counted function on known words computes the JAX strings and
    statistics and counts nothing."""
    keys, _, hc, hu = lanes
    n = encode.NETWORKS[net]
    for j in list(range(39)) + [50, 150, 250]:
        t = work.Trace()
        out, stats = work.records_lane(t, [int(v) for v in _words([keys[j]])[0]],
                                       [int(v) for v in hc[j]], [int(v) for v in hu[j]],
                                       n.p2pkh_version, n.wif_version, n.hrp)
        d = jax_derived[net][j]
        assert t.ops == work.Ops()
        assert {k: v.decode() for k, v in out.items()} == {
            "private_key_decimal": d.private_key_decimal, "wif_compressed": d.wif_compressed,
            "wif_uncompressed": d.wif_uncompressed, "address_p2pkh_compressed": d.p2pkh_compressed,
            "address_p2pkh_uncompressed": d.p2pkh_uncompressed, "address_p2wpkh": d.p2wpkh}
        assert stats == (d.bit_length, d.hamming_weight, d.leading_zeros)


def test_records_bound():
    """E1's count a lane and its bound at 2^19 lanes on the H100 (132 SMs x
    64 a clock x 1.98 GHz a pipe; 72 bytes read and 304 written a lane):
    the ALU pipe sets it: four checksums (D2 has one), the WIF payloads
    longer; a character is a table load, on neither pipe."""
    ops = work.records()
    assert (ops.mul, ops.alu, ops.add) == (2788, 8689, 4064)
    n = 1 << 19
    ms, by, limit = chip_smoke.bound_of((72 + rec.ROW) * n, ops, n, 132 * 64 * 1.98e9)
    assert (by, limit) == ("operations", "ALU")
    assert ms == pytest.approx(0.2723, abs=5e-5)
    assert ops.alu > 4 * work.p2pkh().alu
