"""vuke_tpu_torch's sequential (direct:be) scan against the JAX package.

- K5's plain version against the 16-bit row algebra of
  ``vuke_tpu/ecc/incremental.py:73-78`` (``pallas_smul._sub_t``/``_mul_t``
  run eagerly under numpy): equal mod p, and canonical x, y bit-identical
  after K4's plain version;
- ``sequential_safe`` and ``BaseStepper`` against the JAX helpers;
- the whole sequential path against the K3 path on contiguous keys;
- the offset table against the JAX layout carried over by
  ``params.offset_table_from_jax``;
- the ``scan`` command with ``--transform direct:be`` against
  ``vuke_tpu.pipeline.ForwardDriver``: the same HIT block, byte for byte.

Every comparison is exact (tolerance 0): the path computes integers.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vuke_tpu.ecc.pallas_smul as ps
from vuke_tpu.ecc import incremental as jinc
from vuke_tpu.ecc import ref as jref
from vuke_tpu_torch import cli, params
from vuke_tpu_torch.ecc import incremental as inc
from vuke_tpu_torch.ecc import inv, tiled
from vuke_tpu_torch.matcher import TargetPools
from vuke_tpu_torch.pipeline import scan_range

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jref.P
N = 1024


def _le32(vals):
    return torch.from_numpy(np.array(
        [[(v >> (32 * i)) & 0xFFFFFFFF for v in vals] for i in range(8)], dtype=np.uint32))


def _le_int(t, j):
    return sum(int(t[i, j]) << (32 * i) for i in range(8))


def _be_int(t, j):
    return sum(int(t[i, j]) << (32 * (7 - i)) for i in range(8))


def _rows(vals):
    return [np.array([(v >> (16 * i)) & 0xFFFF for v in vals], dtype=np.uint32)
            for i in range(16)]


def _row_val(rows, j):
    return sum(int(r[j]) << (16 * i) for i, r in enumerate(rows))


def _offsets_and_bases():
    """1024 random affine offsets, the first lanes adversarial (borrows:
    ox < bx and oy < by; 0, p - 1 and 2^256 - 1 coordinates), and base
    points of k = 2^64 - 2, 2^32 + 1, 1026 plus bx = p - 1."""
    rng = np.random.default_rng(5)
    ox = [int.from_bytes(rng.bytes(32), "big") % P for _ in range(N)]
    oy = [int.from_bytes(rng.bytes(32), "big") % P for _ in range(N)]
    ox[:6] = [0, 1, P - 1, (1 << 256) - 1, P, 5]
    oy[:6] = [0, P - 1, 1, P + 3, (1 << 256) - 1, 7]
    bases = [jref.point_mul(k) for k in ((1 << 64) - 2, (1 << 32) + 1, 1026)]
    bases.append((P - 1, P - 2))
    return ox, oy, bases


def _jax_seq_madd(ox, oy, bx, by):
    """incremental.sequential_core's XLA-branch formulas on numpy rows."""
    bxr, byr = _rows([bx] * len(ox)), _rows([by] * len(ox))
    oxr, oyr = _rows(ox), _rows(oy)
    dx = ps._sub_t(oxr, bxr)
    dy = ps._sub_t(oyr, byr)
    zz = ps._mul_t(dx, dx)
    zzz = ps._mul_t(zz, dx)
    x3 = ps._sub_t(ps._mul_t(dy, dy), ps._mul_t(ps._add_t(oxr, bxr), zz))
    y3 = ps._sub_t(ps._mul_t(dy, ps._sub_t(ps._mul_t(bxr, zz), x3)), ps._mul_t(byr, zzz))
    return x3, y3, zz, zzz


@pytest.fixture(scope="module")
def k5_cases():
    mp = pytest.MonkeyPatch()
    mp.setattr(ps, "jnp", np)
    try:
        ox, oy, bases = _offsets_and_bases()
        cases = []
        for bx, by in bases:
            got = inc.seq_madd_plain(_le32(ox), _le32(oy), bx, by)
            cases.append((bx, by, got, _jax_seq_madd(ox, oy, bx, by)))
    finally:
        mp.undo()
    return ox, oy, cases


@pytest.mark.parametrize("case", range(4))
def test_seq_madd_plain_matches_jax_rows_mod_p(k5_cases, case):
    _, _, cases = k5_cases
    bx, _, got, want = cases[case]
    for g, w in zip(got, want):
        g = g.to(torch.int64).numpy()
        assert all(0 <= _le_int(g, j) < 1 << 256 for j in range(0, N, 97))
        assert [_le_int(g, j) % P for j in range(N)] == [_row_val(w, j) % P for j in range(N)]


@pytest.mark.parametrize("case", range(3))
def test_seq_madd_then_affine_bit_identical_to_jax(k5_cases, case):
    """Canonical x, y after K4's plain version equal the JAX rows' affine
    point, and, on real curve points, B + O as the bignum oracle adds it."""
    ox, oy, cases = k5_cases
    bx, by, got, (x3, y3, zz, zzz) = cases[case]
    x, y = (a.to(torch.int64).numpy() for a in inv.affine_plain(*got))
    for j in range(N):
        izz = pow(_row_val(zz, j), -1, P)
        izzz = pow(_row_val(zzz, j), -1, P)
        assert _be_int(x, j) == _row_val(x3, j) * izz % P
        assert _be_int(y, j) == _row_val(y3, j) * izzz % P
    # lanes past the adversarial ones hold (x, y) not on the curve: the
    # oracle check uses a real point instead
    o = jref.point_mul(12345)
    gx, gy, gzz, gzzz = inc.seq_madd_plain(_le32([o[0]] * 16), _le32([o[1]] * 16), bx, by)
    ax, ay = inv.affine_plain(gx, gy, gzz, gzzz)
    want = jref.point_add((bx, by), o)
    assert (_be_int(ax.to(torch.int64), 3), _be_int(ay.to(torch.int64), 3)) == want


@pytest.mark.parametrize("batch", [32, 1024, 1 << 19])
def test_sequential_safe_matches_jax(batch):
    for start in [0, 1, 2, batch, batch + 1, batch + 2, batch + 3, 1 << 40,
                  (1 << 64) - batch - 1, (1 << 64) - batch, (1 << 64) - 1]:
        assert inc.sequential_safe(start, batch) == jinc.sequential_safe(start, batch)


def test_base_stepper_matches_jax():
    ours, theirs = inc.BaseStepper(1024), jinc.BaseStepper(1024)
    for start in [1 << 33, (1 << 33) + 1024, (1 << 33) + 2048, 5000, 6024,
                  (1 << 63) - 7, (1 << 63) + 1017]:
        assert ours.base_for(start) == theirs.base_for(start) == jref.point_mul(start - 1)


def test_offset_table_matches_jax_layout():
    """The JAX table layout, built from bignum points with
    ``incremental.limbs16`` (no jit), carried over by ``params``."""
    nb = N // 1024
    pts = [jref.point_mul(i + 1) for i in range(N)]
    jx = np.stack([jinc.limbs16(x) for x, _ in pts], axis=1).reshape(16, nb, 8, 128)
    jy = np.stack([jinc.limbs16(y) for _, y in pts], axis=1).reshape(16, nb, 8, 128)
    px, py = params.offset_table_from_jax(jx, jy)
    ox, oy = inc.offset_table(N, "cpu")
    assert torch.equal(px.to(torch.int64), ox.to(torch.int64))
    assert torch.equal(py.to(torch.int64), oy.to(torch.int64))


def test_sequential_core_matches_k3_path():
    """The JAX slow test's start (tests/test_sequential.py:111), 1024
    contiguous keys: lane-exact hash160s and fragments."""
    start = (1 << 33) + 777
    vals = np.uint64(start) + np.arange(N, dtype=np.uint64)
    words = np.zeros((8, N), dtype=np.uint32)
    words[7] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words[6] = (vals >> np.uint64(32)).astype(np.uint32)
    want = tiled.derive_tiled_from_words(torch.from_numpy(words), plain=True)
    offx, offy = inc.offset_table(N, "cpu")
    got = inc.sequential_core(*jref.point_mul(start - 1), offx, offy, plain=True)
    for key in ("h160c", "h160u"):
        assert torch.equal(got[key].to(torch.int64), want[key].to(torch.int64))
    for key in ("frag_c", "frag_u"):
        for g, w in zip(got[key], want[key]):
            assert torch.equal(g.to(torch.int64), w.to(torch.int64))


@pytest.mark.parametrize("plain", [False, True])
def test_sequential_core_dict_unchanged_against_the_parent_composition(plain):
    """K5 -> K4 -> hash160 -> ``fragments``, as composed before K2 wrote
    the fragments, on 64 keys from 2^40."""
    from vuke_tpu_torch.cores import hash160

    offx, offy = (a[:, :64].contiguous() for a in inc.offset_table(N, "cpu"))
    bx, by = jref.point_mul((1 << 40) - 1)
    hc, hu = hash160.hash160s_plain(*inv.affine_plain(*inc.seq_madd_plain(offx, offy, bx, by)))
    want = {"h160c": hc.T, "h160u": hu.T, "frag_c": hash160.fragments(hc),
            "frag_u": hash160.fragments(hu)}
    got = inc.sequential_core(bx, by, offx, offy, plain=plain)
    assert set(got) == set(want)
    for key in ("h160c", "h160u"):
        assert got[key].shape == (64, 5)
        assert torch.equal(got[key].to(torch.int64), want[key].to(torch.int64))
    for key in ("frag_c", "frag_u"):
        for g, w in zip(got[key], want[key]):
            assert g.dtype == torch.uint32 and g.shape == (64,)
            assert torch.equal(g.to(torch.int64), w.to(torch.int64))


def _hit_block(text):
    start = text.index("\n========== HIT ==========\n")
    end = text.index("=========================\n", start) + len("=========================\n")
    return text[start:end]


def test_direct_be_cli_scan_prints_the_jax_hit_block(tmp_path):
    """``python -m vuke_tpu_torch scan --transform direct:be`` over
    [2^21, 2^21 + 4095] (sequential from the first superbatch on) against
    the JAX ForwardDriver on the same range and targets."""
    from vuke_tpu.derive import KeyDeriver
    from vuke_tpu.matcher import Matcher
    from vuke_tpu.output import ConsoleOutput
    from vuke_tpu.pipeline import ForwardDriver
    from vuke_tpu.transforms import parse_transform

    seed = (1 << 21) + 2345
    addr = KeyDeriver().derive(seed.to_bytes(32, "big")).p2pkh_compressed
    decoy = KeyDeriver().derive((seed + 10_000).to_bytes(32, "big")).p2wpkh
    path = tmp_path / "targets.txt"
    path.write_text(f"{decoy}\n{addr}\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "vuke_tpu_torch", "scan", "--transform",
                        "direct:be", "--targets", str(path), "--device", "cpu",
                        "--batch", "1024", "range", "--start", "2097152", "--end", "2101247"],
                       capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stderr.strip().splitlines()[-1] == "Done. Inputs: 4096, Keys: 4096, Matches: 1"

    buf = io.StringIO()
    driver = ForwardDriver([parse_transform("direct:be")], Matcher.from_addresses([decoy, addr]),
                           ConsoleOutput(stream=buf), KeyDeriver(), batch=1024)
    stats = driver.run_range(1 << 21, (1 << 21) + 4095)
    assert stats.matches_found == 1
    assert _hit_block(r.stdout) == _hit_block(buf.getvalue())
    assert "Transform: direct\n" in _hit_block(r.stdout)


def test_direct_be_unsafe_start_takes_k3_and_still_hits():
    """[1, 2048] at batch 1024: both superbatches start below batch + 2,
    so both take the K3 path (tests/test_sequential.py:175-188)."""
    from vuke_tpu_torch.derive import KeyDeriver

    addr = KeyDeriver().derive((700).to_bytes(32, "big")).p2pkh_compressed
    res = scan_range(1, 2048, TargetPools.from_addresses([addr]), transform="direct:be",
                     batch=1024, device="cpu")
    assert res.keys_generated == 2048
    assert [(h.seed, h.transform, h.address) for h in res.hits] == [(700, "direct", addr)]


def test_cli_accepts_direct_be(tmp_path, capsys):
    from vuke_tpu_torch.derive import KeyDeriver

    d = KeyDeriver().derive((40).to_bytes(32, "big"))
    path = tmp_path / "t.txt"
    path.write_text(d.p2wpkh + "\n")
    rc = cli.main(["scan", "--transform", "direct:be", "--targets", str(path), "--batch", "32",
                   "--device", "cpu", "range", "--start", "33", "--end", "64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Source: 40\nTransform: direct\n" in out
    assert f"Matched: {d.p2wpkh} (p2wpkh)" in out
