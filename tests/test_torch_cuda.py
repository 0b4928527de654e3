"""vuke_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Skipped without a CUDA device; on the H100:

    python -m pytest tests/test_torch_cuda.py -q

Imports torch and the port only (no jax).  Every comparison is exact: the
kernels compute integers.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vuke_tpu_torch.cores import hash160, mt19937
from vuke_tpu_torch.ecc import field as F
from vuke_tpu_torch.ecc import incremental as inc
from vuke_tpu_torch.ecc import inv, pubkey, ref, scalar, smul, smul_w8, tiled

pytestmark = [
    pytest.mark.cuda_only,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="cuda_only: needs an NVIDIA Hopper card"),
]

N = 4096


@pytest.fixture(scope="module")
def dev():
    return torch.device("cuda", 0)


def _eq(a, b):
    return torch.equal(a.to(torch.int64), b.to(torch.int64))


def _seeds(dev, n=N):
    s = np.random.default_rng(0).integers(0, 1 << 32, n, dtype=np.uint32)
    s[:4] = [0, 1, 5489, 0xFFFFFFFF]
    return torch.from_numpy(s).to(dev)


def _scalars(dev):
    ks = [1, 2, 3, ref.N - 1, ref.N - 2, ref.N, (1 << 256) - 1, 0,
          (1 << 255) + 12345, 0xDEADBEEF]
    rng = np.random.default_rng(1)
    ks += [int.from_bytes(rng.bytes(32), "big") for _ in range(N - len(ks))]
    w = np.array([[(k >> (32 * (7 - i))) & 0xFFFFFFFF for k in ks] for i in range(8)],
                 dtype=np.uint32)
    return tiled.normalize_words(torch.from_numpy(w).to(dev))


def test_mt19937_kernel_matches_plain(dev):
    s = _seeds(dev)
    before = mt19937.KERNEL.launches
    assert _eq(mt19937.milksad_key_words(s), mt19937.milksad_key_words_plain(s))
    assert mt19937.KERNEL.launches == before + 1


def test_mt19937_normalize_kernel_matches_plain(dev):
    """K1 with the reduction mod n in its epilogue: its plain version, and
    the raw kernel's words through the normalize kernel."""
    s = _seeds(dev)
    before = mt19937.KERNEL.launches
    got = mt19937.milksad_key_words(s, normalize=True)
    assert mt19937.KERNEL.launches == before + 1
    assert _eq(got, mt19937.milksad_key_words_plain(s, normalize=True))
    assert _eq(got, scalar.normalize_words(mt19937.milksad_key_words(s)))


def test_normalize_kernel_matches_plain(dev):
    """Every ``chip_smoke.scalar_edge`` word, then random words: one
    launch, lane-exact, and the edge words equal k mod n (0 -> 1)."""
    edge = chip_smoke.scalar_edge()
    w = np.random.default_rng(5).integers(0, 1 << 32, (8, N), dtype=np.uint32)
    w[:, :len(edge)] = chip_smoke.words_be(edge).numpy()
    words = torch.from_numpy(w).to(dev)
    before = scalar.KERNEL.launches
    got = scalar.normalize_words(words)
    assert scalar.KERNEL.launches == before + 1
    assert _eq(got, scalar.normalize_words_plain(words))
    got = got.to(torch.int64).cpu()
    for j, k in enumerate(edge):
        assert chip_smoke.lane_int_be(got, j) == (k % ref.N or 1)


@pytest.mark.parametrize("lanes", ["edges", "milksad"])
def test_smul_kernel_matches_plain_mod_p(dev, lanes):
    """K3 on the edge scalars and on the main path's lanes (K1's normalized
    keys): lane-exact mod p against its plain version, and 64 lanes against
    ``ref.point_mul``."""
    norm = (_scalars(dev) if lanes == "edges"
            else mt19937.milksad_key_words(_seeds(dev), normalize=True))
    before = smul.KERNEL.launches
    err, _ = chip_smoke.k3_against_plain(norm, list(range(10)) + list(range(N - 54, N)))
    assert err == 0 and smul.KERNEL.launches == before + 1


def test_smul_w8_kernel_matches_plain_mod_p(dev):
    """K6 on byte-window edge cases (zero windows below the only digit, the
    top window at n - 1 and at 0xFEFF..FF) and random scalars."""
    n = ref.N
    ks = [0, 1, 2, 255, 256, 257, 1 << 32, 1 << 128, 1 << 248, 1 << 255, n - 1, n - 2,
          n, n + 1, (1 << 256) - 1, (0xFF << 248) - 1, 0xFF << 248]
    rng = np.random.default_rng(4)
    ks += [int.from_bytes(rng.bytes(32), "big") for _ in range(N - len(ks))]
    w = np.array([[(k >> (32 * (7 - i))) & 0xFFFFFFFF for k in ks] for i in range(8)],
                 dtype=np.uint32)
    norm = tiled.normalize_words(torch.from_numpy(w).to(dev))
    before = smul_w8.KERNEL.launches
    got = smul_w8.scalar_mul(norm)
    assert smul_w8.KERNEL.launches == before + 1
    want = smul_w8.scalar_mul_plain(norm, smul_w8.table_on(str(dev)))
    for g, w in zip(got, want):
        assert _eq(F.canonical(F.from_u32_le(g)), F.canonical(F.from_u32_le(w)))


def test_field_selftest_matches_bignum(dev):
    """The field library's carry chains (fe_mul, fe_sqr, fe_inv, fe_canon,
    fe_add, fe_sub) on every pair of adversarial operands and 16384 random
    pairs, against Python integers."""
    a, b = chip_smoke.field_operands(16384, seed=9)
    before = F.SELFTEST_KERNEL.launches
    outs = F.selftest(chip_smoke.limbs_le(a).to(dev), chip_smoke.limbs_le(b).to(dev))
    assert F.SELFTEST_KERNEL.launches == before + 1
    assert chip_smoke.field_mismatches(a, b, outs) == []


def test_inv_affine_kernel_matches_plain(dev):
    outs = smul.scalar_mul(_scalars(dev))
    for g, w in zip(inv.affine(*outs), inv.affine_plain(*outs)):
        assert _eq(g, w)


def test_inv_affine_kernel_on_unreduced_inputs(dev):
    """Lanes of representatives in [p, 2^256) and random 256-bit values."""
    p, top = ref.P, (1 << 256) - 1
    lanes = [(p, p + 1, p + 1, p + 2), (top, p + 5, top, top - 1), (p - 1, 0, p + 3, 1),
             (1, top, 2, p + 1), (top - 1, p, (1 << 32) + 977, top), (0, 1, p + 1, p + 1)]
    rng = np.random.default_rng(3)
    while len(lanes) < 256:
        lane = tuple(int.from_bytes(rng.bytes(32), "big") for _ in range(4))
        if lane[2] % p and lane[3] % p:
            lanes.append(lane)
    cols = [torch.from_numpy(np.array(
        [[(v[c] >> (32 * j)) & 0xFFFFFFFF for v in lanes] for j in range(8)],
        dtype=np.uint32)).to(dev) for c in range(4)]
    x, y = inv.affine(*cols)
    xp, yp = inv.affine_plain(*cols)
    assert _eq(x, xp) and _eq(y, yp)
    xs, ys = x.to(torch.int64).cpu(), y.to(torch.int64).cpu()
    for j, (X, Y, ZZ, ZZZ) in enumerate(lanes):
        gx = sum(int(xs[i, j]) << (32 * (7 - i)) for i in range(8))
        gy = sum(int(ys[i, j]) << (32 * (7 - i)) for i in range(8))
        assert (gx, gy) == (X * pow(ZZ, -1, p) % p, Y * pow(ZZZ, -1, p) % p)


def test_hash160_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 1 << 32, (8, N), dtype=np.uint32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1 << 32, (8, N), dtype=np.uint32)).to(dev)
    for g, w in zip(hash160.hash160s(x, y), hash160.hash160s_plain(x, y)):
        assert _eq(g, w)


def test_hash160_fragments_kernel_matches_plain(dev):
    """K2 with its fragment epilogue: digests and the four fragment words."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 1 << 32, (8, N), dtype=np.uint32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1 << 32, (8, N), dtype=np.uint32)).to(dev)
    before = hash160.KERNEL.launches
    hc, hu, fc, fu = hash160.hash160s_and_fragments(x, y)
    assert hash160.KERNEL.launches == before + 1
    pc, pu, pfc, pfu = hash160.hash160s_and_fragments_plain(x, y)
    for g, w in zip((hc, hu, *fc, *fu), (pc, pu, *pfc, *pfu)):
        assert _eq(g, w)


def test_derive_kernels_match_plain_path(dev):
    s = _seeds(dev, 1 << 14)
    a = tiled.derive_hash160s_tiled(s)
    b = tiled.derive_hash160s_tiled(s, plain=True)
    for key in ("h160c", "h160u"):
        assert _eq(a[key], b[key])
    for key in ("frag_c", "frag_u"):
        assert all(_eq(g, w) for g, w in zip(a[key], b[key]))


def test_k6_derive_matches_k3_derive(dev):
    """The tile-layout derive with ``smul13=False`` launches K6, not K3,
    and equals the K3 derive lane for lane; so does the lane-major API on
    a batch that is not a multiple of the inversion chunk."""
    s = _seeds(dev, 1 << 14)
    k3, k6 = smul.KERNEL.launches, smul_w8.KERNEL.launches
    a = tiled.derive_hash160s_tiled(s, smul13=False)
    assert (smul.KERNEL.launches, smul_w8.KERNEL.launches) == (k3, k6 + 1)
    b = tiled.derive_hash160s_tiled(s, smul13=True)
    for key in ("h160c", "h160u"):
        assert _eq(a[key], b[key])
    for key in ("frag_c", "frag_u"):
        assert all(_eq(g, w) for g, w in zip(a[key], b[key]))
    words = _scalars(dev).T[:N - 3].contiguous()
    pa = pubkey.derive_hash160s(words, smul13=False)
    pb = pubkey.derive_hash160s(words, smul13=True)
    for key in pa:
        assert _eq(pa[key], pb[key])


@pytest.mark.parametrize("k", [(1 << 64) - 2, (1 << 32) + 1, 1026])
def test_seq_madd_kernel_matches_plain_mod_p(dev, k):
    """Offsets (i + 1) * G with adversarial first lanes (0, p - 1, 2^256 - 1
    coordinates), against the base point (k - 1) * G and bx = p - 1."""
    offx, offy = (a.clone() for a in inc.offset_table(N, dev))
    top = (1 << 256) - 1
    for j, (x, y) in enumerate([(0, 0), (ref.P - 1, 1), (top, ref.P), (1, top)]):
        offx[:, j] = torch.tensor([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                                  dtype=torch.int64).to(torch.uint32).to(dev)
        offy[:, j] = torch.tensor([(y >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                                  dtype=torch.int64).to(torch.uint32).to(dev)
    for bx, by in (ref.point_mul(k - 1), (ref.P - 1, ref.P - 2)):
        before = inc.KERNEL.launches
        got = inc.seq_madd(offx, offy, bx, by)
        assert inc.KERNEL.launches == before + 1
        want = inc.seq_madd_plain(offx, offy, bx, by)
        for g, w in zip(got, want):
            assert _eq(F.canonical(F.from_u32_le(g)), F.canonical(F.from_u32_le(w)))


def test_sequential_core_matches_k3_path(dev):
    """4096 contiguous keys across 2^63 (and a 2^32 carry): the sequential
    path through K5 equals the K3 path, lane for lane."""
    start = (1 << 63) - N // 2
    vals = np.uint64(start) + np.arange(N, dtype=np.uint64)
    words = np.zeros((8, N), dtype=np.uint32)
    words[7] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words[6] = (vals >> np.uint64(32)).astype(np.uint32)
    want = tiled.derive_tiled_from_words(torch.from_numpy(words).to(dev))
    offx, offy = inc.offset_table(N, dev)
    got = inc.sequential_core(*ref.point_mul(start - 1), offx, offy)
    for key in ("h160c", "h160u"):
        assert _eq(got[key], want[key])
    for key in ("frag_c", "frag_u"):
        assert all(_eq(g, w) for g, w in zip(got[key], want[key]))


@pytest.mark.parametrize("name,args", [(name, args) for name, _, args in chip_smoke.keygen_modes()],
                         ids=[label for _, label, _ in chip_smoke.keygen_modes()])
def test_keygen_kernels_match_plain(dev, name, args):
    """Every mode and variant of the three keygen kernels on the edge seeds
    (decimal strings of 1 to 20 bytes) and random ones: one launch, the
    plain version's words lane for lane."""
    from vuke_tpu_torch.cores import keygen

    hi, lo = chip_smoke.seed_words(chip_smoke.keygen_seeds(np.random.default_rng(2), N), dev)
    kern = chip_smoke.KEYGEN[name]
    before = kern.launches
    got = getattr(keygen, name)(hi, lo, *args)
    assert kern.launches == before + 1
    assert _eq(got, getattr(keygen, f"{name}_plain")(hi, lo, *args))


@pytest.mark.parametrize("mode", ["sha256", "double_sha256", "md5", "chain"])
def test_digest_kernel_matches_plain_and_hashlib(dev, mode):
    """D1 on strings of 0 to 300 bytes (the 55/56 and 119/120-byte edges,
    non-ASCII included), each mode one launch, against its plain version
    and hashlib; the chain mode at depth 10."""
    from vuke_tpu_torch.cores import digest

    datas = chip_smoke.digest_strings(np.random.default_rng(3), N)
    words, offsets = digest.pack(datas)
    before = digest.KERNEL.launches
    if mode == "chain":
        keys = digest.digest_plain(words, offsets, "sha256")
        got = digest.digest_chain(keys.to(dev), 10)
        assert _eq(got.cpu(), digest.digest_chain_plain(keys, 10))
    else:
        got = digest.digest(words.to(dev), offsets.to(dev), mode)
        assert _eq(got.cpu(), digest.digest_plain(words, offsets, mode))
        assert chip_smoke.digest_mismatches(datas, got, mode, range(0, N, 7)) == []
    assert digest.KERNEL.launches == before + 1


@pytest.mark.parametrize("mode", ["sha256", "double_sha256", "md5", "chain"])
def test_digest_kernel_edges(dev, mode):
    """D1 at its edges, one launch each, against its plain version and
    hashlib on every lane: a warp of strings of 1 to 6 blocks, empty
    strings, 55 to 120 bytes, a 10 KB string, blocks whose strings exceed
    the shared tile, every byte alignment (and the words off 16 bytes),
    M = 1, 255, 257 and 1869 (chip_smoke phase 7a)."""
    held = chip_smoke.digest_edges_against_plain(dev, np.random.default_rng(12), (mode,))
    assert len(held) == 11


@pytest.mark.parametrize("version", [0x00, 0x6F])
def test_p2pkh_kernel_matches_plain(dev, version):
    """D2 on random and edge hash160s (all zeros, all 0xff), one launch,
    byte for byte against its plain version."""
    from vuke_tpu_torch.cores import p2pkh

    h = chip_smoke.p2pkh_digests(np.random.default_rng(4), N)
    before = p2pkh.KERNEL.launches
    got = p2pkh.batch_p2pkh(h.to(dev), version)
    assert p2pkh.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), p2pkh.batch_p2pkh_plain(h, version))


@pytest.mark.parametrize("n", chip_smoke.TAILS + (1 << 19,))
@pytest.mark.parametrize("version", [0x00, 0x6F])
def test_p2pkh_kernel_tails(dev, version, n):
    """D2 at sizes below, around and off its 256-row tile and at the main
    path's 2^19 (the edge digests first), byte for byte; nothing is
    written past the last row."""
    from vuke_tpu_torch.cores import p2pkh

    h = chip_smoke.p2pkh_digests(np.random.default_rng(n), max(n, 3))[:, :n].contiguous()
    got = p2pkh.batch_p2pkh(h.to(dev), version)
    assert torch.equal(got.cpu(), p2pkh.batch_p2pkh_plain(h, version))
    pad = torch.full((n * p2pkh.ROW + 64,), 0xAA, dtype=torch.uint8, device=dev)
    p2pkh.KERNEL.launch(dev, h.to(dev).data_ptr(), version, pad.data_ptr(), n)
    assert torch.equal(pad[:n * p2pkh.ROW].view(n, p2pkh.ROW), got)
    assert bool((pad[n * p2pkh.ROW:] == 0xAA).all())


def test_p2pkh_launch_refuses_an_unaligned_output(dev):
    """D2 stores 16-byte vectors: an output off 16 bytes is refused."""
    from vuke_tpu_torch.cores import p2pkh

    h = torch.zeros((5, 32), dtype=torch.uint32, device=dev)
    rows = torch.empty(32 * p2pkh.ROW + 16, dtype=torch.uint8, device=dev)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        p2pkh.KERNEL.launch(dev, h.data_ptr(), 0, rows.data_ptr() + 1, 32)


def test_sweep_kernels_match_plain(dev):
    """S1 (every family, variant and mode) and S2 (every variant and mode at
    depth 10) against their plain versions on the card, 4096 lanes across
    the carry and the u32 wrap, hits planted (chip_smoke phase 8a)."""
    held = chip_smoke.sweep_against_plain(dev, np.random.default_rng(3), 4096, 4096)
    assert held == {"sweep_prng": (74, 0), "sweep_chain": (28, 0)}


@pytest.mark.parametrize("v", range(4))
@pytest.mark.parametrize("be", [True, False])
def test_sweep_lcg_grid_edges(dev, v, be):
    """S1's LCG grid (thread t takes lanes t, t + T, ...) in every variant
    and byte order: the least hit where a lower thread of the same warp
    hits in a later lane, with and without the tracked count; the first
    and last lanes of 5 T + 12,345; one lane; the u32 wrap; all 2^32 seeds
    against the planted one (chip_smoke phase 8a)."""
    assert len(chip_smoke.lcg_edges_against_plain(dev, v, be)) == 9


def test_sweep_launch_failure_raises(dev):
    """A launch the C entry refuses (family 9) raises; the record is left
    to the caller and nothing runs the plain version instead."""
    from vuke_tpu_torch.cores import sweep

    rec = torch.empty(2, dtype=torch.int64, device=dev)
    target0 = sweep.Compare("exact", words=(0,) * 8).target0
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sweep.PRNG_KERNEL.launch(dev, 0, 0, 1024, 9, 0, 1, 0, 1, 0, target0.ctypes.data, 0,
                                 rec.data_ptr())


def test_w1_matches_plain_and_hashlib(dev):
    """W1 against its plain version at 2 and 7 iterations (keys across the
    128-byte edge, salts to 107 bytes), one launch each, and at 2048
    against hashlib and the Trezor vector (chip_smoke phase 9a)."""
    errs = chip_smoke.w1_against_plain(dev, np.random.default_rng(5), 512)
    assert errs == {2: 0, 7: 0}
    chip_smoke.w1_full(dev, np.random.default_rng(5), 64, 16)


def test_w2_matches_plain_and_hashlib(dev):
    """W2 against its plain version at 1, 2 and 17 rounds at every length
    edge, one launch each, and at 99,999 rounds against hashlib and the
    Electrum vector through master_pubkeys_device (chip_smoke phase 9b)."""
    assert chip_smoke.w2_against_plain(dev, np.random.default_rng(6), 256) == 0
    chip_smoke.w2_full(dev, np.random.default_rng(6), 8)


@pytest.mark.parametrize("network", ["bitcoin", "testnet", "signet", "regtest"])
def test_records_kernel_matches_plain(dev, network):
    """E1 on the edge keys and digests with leading zero bytes (chip_smoke
    phase 10a's inputs) and random lanes, one launch, byte for byte
    against ``records_plain`` on the card."""
    from vuke_tpu_torch import encode
    from vuke_tpu_torch.cores import records

    k, hc, hu, _ = chip_smoke.record_inputs(np.random.default_rng(7), N)
    kd, hcd, hud = k.to(dev), hc.to(dev), hu.to(dev)
    net = encode.NETWORKS[network]
    before = records.KERNEL.launches
    got = records.encode_records(kd, hcd, hud, net)
    assert records.KERNEL.launches == before + 1
    assert torch.equal(got, records.records_plain(kd, hcd, hud, net))
    assert torch.equal(got.cpu(), records.records_plain(k, hc, hu, net))


@pytest.mark.parametrize("n", chip_smoke.TAILS + (1 << 19,))
@pytest.mark.parametrize("network", ["bitcoin", "testnet", "signet", "regtest"])
def test_records_kernel_tails(dev, network, n):
    """E1 at sizes below, around and off its 64-record tile and at the main
    path's 2^19 (the edge keys 1, n - 1, 2^256 - 1 - n, keys with leading
    zero bytes and digests with leading zero bytes first), byte for byte;
    nothing is written past the last row."""
    from vuke_tpu_torch import encode
    from vuke_tpu_torch.cores import records

    k, hc, hu, _ = chip_smoke.record_inputs(np.random.default_rng(n), max(n, 128))
    kd, hcd, hud = (t[:, :n].contiguous().to(dev) for t in (k, hc, hu))
    net = encode.NETWORKS[network]
    got = records.encode_records(kd, hcd, hud, net)
    assert torch.equal(got, records.records_plain(kd, hcd, hud, net))
    pad = torch.full((n * records.ROW + 64,), 0xAA, dtype=torch.uint8, device=dev)
    records.KERNEL.launch(dev, kd.data_ptr(), hcd.data_ptr(), hud.data_ptr(),
                          *records.network_params(net), pad.data_ptr(), n)
    assert torch.equal(pad[:n * records.ROW].view(n, records.ROW), got)
    assert bool((pad[n * records.ROW:] == 0xAA).all())


def test_derive_records_matches_the_host(dev):
    """The derive path with E1 (K3 -> K4 -> K2 -> E1) against the host
    ``KeyDeriver`` on 64 lanes, string for string."""
    from vuke_tpu_torch import encode, pipeline
    from vuke_tpu_torch.cores import records
    from vuke_tpu_torch.derive import KeyDeriver

    words = torch.from_numpy(np.random.default_rng(8).integers(0, 1 << 32, (8, 1024),
                                                              dtype=np.uint32)
                             .view(np.int32)).view(torch.uint32).to(dev)
    norm, x, y, rows = pipeline.derive_records(words, encode.REGTEST)
    host = lambda t: t.T.contiguous().view(torch.int32).cpu().numpy().view(np.uint32)  # noqa: E731
    block = records.RecordBlock("t", [str(j) for j in range(1024)], host(norm), host(x),
                                host(y), rows.cpu().numpy())
    deriver = KeyDeriver(encode.REGTEST)
    assert all(d == deriver.derive(d.raw) for d in block.derived()[:64])


def test_records_launch_refuses_a_long_hrp(dev):
    """A launch the C entry refuses (a 5-byte hrp) raises."""
    from vuke_tpu_torch.cores import records

    rows = torch.empty((32, records.ROW), dtype=torch.uint8, device=dev)
    w = torch.zeros((8, 32), dtype=torch.uint32, device=dev)
    h = torch.zeros((5, 32), dtype=torch.uint32, device=dev)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        records.KERNEL.launch(dev, w.data_ptr(), h.data_ptr(), h.data_ptr(), 0, 0x80, 0, 5, 1,
                              rows.data_ptr(), 32)


# --- runs across processes and cards (parallel/multihost.py) ---

def test_require_cuda_returns_the_card_it_checks():
    from vuke_tpu_torch._device import require_cuda

    n = torch.cuda.device_count()
    assert require_cuda(n - 1) == torch.device("cuda", n - 1)
    with pytest.raises(RuntimeError, match=f"no CUDA device {n} "):
        require_cuda(n)


def test_caches_are_keyed_by_the_indexed_card(dev):
    """"cuda" (the current card) and the indexed card are one entry."""
    from vuke_tpu_torch._device import device_key

    with torch.cuda.device(dev):
        assert device_key("cuda") == str(dev)
        assert smul.table_on(device_key("cuda")) is smul.table_on(device_key(dev))
        assert inc.offset_table(1024, "cuda") is inc.offset_table(1024, dev)


def test_two_ranks_share_the_card():
    """``analyze --analyzer milksad`` in two gloo ranks on card 0 over 2^24
    seeds at batch 2^20, the seed planted in rank 1's shard: both ranks
    print it."""
    import os
    import socket
    import subprocess
    import sys

    seed = (1 << 23) + 12345
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "vuke_tpu_torch", "analyze",
            "0x" + chip_smoke.host_milksad_key(seed).hex(), "--analyzer", "milksad",
            "--max-seeds", str(1 << 24), "--batch", str(1 << 20)]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(argv, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True,
                              env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank)))
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert f"milksad: CONFIRMED (seed = {seed})" in out
