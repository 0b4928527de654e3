"""``chip_smoke.bound``: each kernel's least time at the main path's shape,
from its bytes and the operations its function needs (``kernels/work.py``);
the counted functions against the real ones; the SASS reading printed
beside the bounds (``kernels/sass.py``); the ``-Xptxas -v`` reading behind
phase 2's registers and spills; and the timing helpers' guards.

The pipe rate is pinned at the H100's 132 SMs x 64 a clock x 1.98 GHz =
1.6727e13 32-bit operations per second on each pipe, N = 2^19.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from vuke_tpu_torch import benchmark, encode, kernels
from vuke_tpu_torch.ecc import ref
from vuke_tpu_torch.kernels import sass, work

RATE = 132 * 64 * 1.98e9
N = 1 << 19


# (multiply results, ALU-only, adds) a lane; bound ms, bound_by, the term
# that sets it.  K6 at 31 additions a lane.
BOUNDS = [
    ("mt19937", 412, 910, 24, 0.0285, "operations", "ALU"),
    ("normalize", 0, 14, 8, 0.0100, "bytes", "bytes"),
    ("smul", 24_624, 752, 10_440, 0.7718, "operations", "FMA"),
    ("smul_w8", 42_408, 932, 17_670, 1.3292, "operations", "FMA"),
    ("seq_madd", 926, 20, 434, 0.0300, "bytes", "bytes"),
    ("inv_affine", 2_761.25, 16, 1_111.875, 0.0865, "operations", "FMA"),
    ("hash160", 0, 3_912, 1_816, 0.1226, "operations", "ALU"),
]


@pytest.mark.parametrize("name,mul,alu,add,ms,by,limit", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_bound_counts_multiply_results(name, mul, alu, add, ms, by, limit):
    """The larger of bytes / HBM rate and the busier pipe's operations /
    rate; a field product is 148 multiply results with its reduction."""
    ops = chip_smoke.work_per_lane(name, 31)
    assert (ops.mul, ops.alu, ops.add) == pytest.approx((mul, alu, add))
    got_ms, got_by, got_limit = chip_smoke.bound(name, N, RATE, ops)
    assert (got_by, got_limit) == (by, limit)
    assert got_ms == pytest.approx(ms, abs=5e-5)


def test_field_counts():
    """Schoolbook product 64 x 2 results, squaring 36 x 2, each with the
    fold's 20; the mixed addition 8M + 2S + 7 subtractions; the pipes
    balance (all / 2) below the multiplies."""
    assert (work.FE_MUL.mul, work.FE_SQR.mul) == (148, 92)
    assert work.MADD == work.Ops(mul=1368, alu=28, add=570)
    assert work.MADD.cycles() == 1368 and work.MADD.pipe() == "FMA"
    assert work.Ops(mul=10, alu=10, add=30).pipe() == "both"


def test_counted_hash160_is_hash160():
    """The counted K2 on known words computes both digests and the
    fragments, and counts nothing; on the lane's words it counts."""
    k = 0xC0FFEE1234567890ABCDEF
    x, y = ref.point_mul(k)
    xw = [(x >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)]
    yw = [(y >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)]
    t = work.Trace()
    hc, hu, frags = work.hash160_lane(t, xw, yw)
    dc = b"".join(v.to_bytes(4, "little") for v in hc)
    du = b"".join(v.to_bytes(4, "little") for v in hu)
    assert dc == encode.hash160(bytes([2 + (y & 1)]) + x.to_bytes(32, "big"))
    assert du == encode.hash160(b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    assert b"".join(f.to_bytes(4, "big") for f in frags) == dc[:8] + du[:8]
    assert t.ops == work.Ops()


@pytest.mark.parametrize("seed", [0, 1, 5489, 0xFFFFFFFF])
def test_counted_mt19937_is_mt19937(seed):
    t = work.Trace()
    key = work.mt19937_lane(t, seed)
    assert b"".join(v.to_bytes(4, "big") for v in key) == np.random.RandomState(seed).bytes(32)
    assert t.ops == work.Ops()


@pytest.mark.parametrize("family,v,be", [("lcg", v, be) for v in range(4) for be in (True, False)]
                         + [("xorshift", v, True) for v in range(4)])
def test_counted_exact_sweep_is_output_one_and_a_compare(family, v, be):
    """S1's exact mode needs, for every lane, the stream's first output and
    one compare (key word 0 against target word 0), beside the seed's
    lattice; the rest of the key only for the lanes that pass.  The counted
    first output, run on a known seed, is the plain generator's; an LCG's
    is counted as the generator gives it (a little-endian key's byteswap
    folds into the target word).  glibc's (doubled), msvc's and borland's
    is affine mod 2^32, so the lane T seeds on is one add away: the count
    is that add and the compare."""
    from vuke_tpu_torch.cores import lcg, xorshift

    seed = (7 << 32) | 0x9E3779B9
    hi, lo = torch.tensor([seed >> 32]), torch.tensor([seed & 0xFFFFFFFF])
    t, n = work.Trace(), work.Trace()
    if family == "lcg":
        got = work.lcg_lane(t, seed & 0xFFFFFFFF, lcg.ALL_VARIANTS[v], be, 1)
        work.lcg_lane(n, None, lcg.ALL_VARIANTS[v], True, 1)
        want = lcg.lcg_key_words(lo, lcg.ALL_VARIANTS[v], be)[:1]
        lattice = work.Ops(add=1)
    else:
        name = xorshift.VARIANT_NAMES[v]
        got = work.xorshift_lane(t, name, seed >> 32, seed & 0xFFFFFFFF, n_out=1)
        work.xorshift_lane(n, name, None, None, n_out=1)
        want = xorshift.KEY_FNS[name](hi, lo, 1)[:len(got)]
        lattice = work.Ops(alu=1, add=2)
    assert got == [int(w) for w in want] and t.ops == work.Ops()
    if family == "lcg" and lcg.ALL_VARIANTS[v].m != (1 << 31) - 1:
        var, m = lcg.ALL_VARIANTS[v], 0xFFFFFFFF
        k = 1 if var.m == 1 << 31 else 0
        out = lambda s: (int(lcg.lcg_key_words(torch.tensor([s]), var)[0]) << k) & m
        for step in (1, 132 * 2 * 256, 1 << 31):
            assert out((seed + step) & m) == (out(seed & m) + (var.a << k) * step) & m
        assert work.sweep_prng(family, "exact", v, be) == work.Ops(add=1, alu=1)
    else:
        assert work.sweep_prng(family, "exact", v, be) == lattice + n.ops + work.Ops(alu=1)
    key = work.sweep_prng(family, "exact", v, be, reach=(1.0, 1.0))
    assert key == work.sweep_prng(family, "mask", v, be) + work.Ops(alu=4)
    if not be:
        assert work.sweep_prng(family, "exact", v, be) == work.sweep_prng(family, "exact", v)


@pytest.mark.parametrize("n", [0, 3, 111])
def test_counted_sha512_is_sha512(n):
    """The counted SHA-512 compression (W1's bound) on known words computes
    the digest and counts nothing; W1's count is its setup plus 2047 times
    one iteration, W2's a compression a block a round, the 32-byte seed's
    second block (padding alone) folding its schedule, where 33 bytes' does
    not."""
    import hashlib
    from vuke_tpu_torch.cores import sha512
    msg = bytes(range(n))
    blk = msg + b"\x80" + b"\x00" * (111 - n) + (8 * n).to_bytes(16, "big")
    words = [sha512.split(int.from_bytes(blk[8 * i:8 * i + 8], "big")) for i in range(16)]
    t = work.Trace()
    out = work.sha512_block(t, sha512.iv(), words)
    assert b"".join(((h << 32) | l).to_bytes(8, "big") for h, l in out) == (
        hashlib.sha512(msg).digest())
    assert t.ops == work.Ops()
    step = work.pbkdf2_sha512(3) - work.pbkdf2_sha512(2)
    assert work.pbkdf2_sha512(2048) == work.pbkdf2_sha512(2) + 2046 * step
    assert 2 * step.alu > work.pbkdf2_sha512(1).alu > step.alu
    one, two = work.electrum_stretch(23, 1), work.electrum_stretch(24, 1)
    assert work.electrum_stretch(10, 99_999) == 99_999 * work.electrum_stretch(10, 1)
    assert one.alu < two.alu < 2 * one.alu + 1
    assert work.electrum_stretch(32, 1).alu < work.electrum_stretch(33, 1).alu


def test_trace_folds_known_terms():
    t = work.Trace()
    assert t.add(1, 2, 3) == 6 and t.ops == work.Ops()
    t.add(None, 5, 7)            # lane + one folded constant: one add
    t.add(None, None, None)      # three terms: one IADD3
    t.add(None, None, None, 0)   # a zero term adds nothing
    t.add(None, None, None, 1)   # four terms: two
    assert t.ops.add == 5
    t.rotr(None, 3)
    t.lop(lambda a, b, c: a ^ b ^ c, None, 1, 2)
    t.mad(None, 3, 4)
    assert (t.ops.alu, t.ops.mul) == (2, 1)


def test_k6_additions_count_non_zero_bytes():
    words = chip_smoke.words_be([1, 0x0100_0001, (1 << 256) - 1, 0])
    assert chip_smoke.k6_additions(words) == pytest.approx((0 + 1 + 31 + 0) / 4)


def test_every_kernel_has_bytes_and_loop_trips():
    for name, k in chip_smoke.KERNELS.items():
        assert name in chip_smoke.BYTES_PER_LANE
        assert k.entry in chip_smoke.LOOP_TRIPS
        assert chip_smoke.work_per_lane(name, 31).cycles() > 0


SASS_TEXT = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_110toy_kernelEPKjPjx
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;          /* 0x0000000403027225 */
        /*0020*/                   LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT ;    /* 0x0000000605057212 */
        /*0030*/                   IMAD R5, R5, 0x3, RZ ;                  /* 0x0000000305057824 */
        /*0040*/                   SHF.R.U32.HI R7, RZ, 0x1e, R5 ;         /* 0x0000001eff077819 */
        /*0050*/               @P0 BRA 0x40 ;                              /* 0xfffffffc00f80947 */
        /*0060*/              @!P1 BRA 0x20 ;                              /* 0xfffffffc00e88947 */
        /*0070*/                   CALL.REL.NOINC 0xa0 ;                   /* 0x0000000000087944 */
        /*0080*/                   EXIT ;                                  /* 0x000000000000794d */
        /*0090*/                   BRA 0x90;                               /* 0xfffffffc00fc7947 */
        /*00a0*/                   IADD3 R1, R1, 0x1, RZ ;                 /* 0x0000000101017810 */
        /*00b0*/                   VIADD R2, R2, 0x1 ;                     /* 0x0000000102027836 */
        /*00c0*/               @P2 BRA 0xb0 ;                              /* 0xfffffffc00f82947 */
        /*00d0*/                   RET.REL.NODEC R20 0x0 ;                 /* 0xffffffff14c87950 */
\t\t.........................
"""


def test_sass_weights_loops_and_calls():
    """Loops weighted by their trip counts (inner 3 inside outer 5), the
    padding branch after EXIT not a loop, the called body once per call."""
    pipes = sass.kernel_pipes(SASS_TEXT, {"toy_kernel": [[3, 5], [7]]})
    p = pipes["toy_kernel"]
    assert p.alu == 5 + 15 + 1                  # LOP3 x5, SHF x15, IADD3 in the callee
    assert p.fma == 2 + 5 + 7                   # IMAD.WIDE, IMAD x5, VIADD x7
    assert p.issued == 50 + 16


def test_sass_refuses_wrong_trip_counts():
    with pytest.raises(ValueError, match="2 loops"):
        sass.kernel_pipes(SASS_TEXT, {"toy_kernel": [[3], [7]]})
    with pytest.raises(ValueError, match="2 regions"):
        sass.kernel_pipes(SASS_TEXT, {"toy_kernel": [[3, 5]]})
    with pytest.raises(ValueError, match="no SASS"):
        sass.kernel_pipes(SASS_TEXT, {"other_kernel": [[]]})


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__afa9b661_13_inv_affine_cu_eb25a56617inv_affine_kernelEPKjS2_S2_S2_PjS3_x' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__afa9b661_13_inv_affine_cu_eb25a56617inv_affine_kernelEPKjS2_S2_S2_PjS3_x
    64 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 88 registers, used 0 barriers, 64 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__aa6537bb_7_smul_cu_vk_smul11smul_kernelEPKjPK5uint4PjS5_S5_S5_x' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__aa6537bb_7_smul_cu_vk_smul11smul_kernelEPKjPK5uint4PjS5_S5_S5_x
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 16 bytes cumulative stack size
"""


def test_phase_build_reads_registers_and_spills():
    """Phase 2's summary: each entry function of the ``-Xptxas -v`` log with
    its registers, stack and spill bytes, under its name as the log has it
    (``entry_name`` shortens it)."""
    usage = kernels.ptxas_usage(PTXAS_LOG)
    assert [(kernels.entry_name(name), *rest) for name, *rest in usage] == [
        ("inv_affine_kernel", 88, 64, 0), ("smul_kernel", 96, 16, 32)]
    assert usage[1][0] == ("_ZN38_GLOBAL__N__aa6537bb_7_smul_cu_vk_smul11smul_kernel"
                           "EPKjPK5uint4PjS5_S5_S5_x")


def test_cold_ring_turns_inputs_and_holds_outputs():
    seen = []

    def fn(x):
        seen.append(x)
        return torch.full((1,), x)

    call = benchmark._cold(fn, [0, 1, 2, 3])
    for _ in range(6):
        call()
    assert seen == [0, 1, 2, 3, 0, 1]


class _Event:
    def __init__(self, key):
        self.key, self.count = key, 0


class _Profile:
    def key_averages(self):
        return [_Event("cudaDeviceSynchronize")]


def test_profiled_runs_again_when_a_kernel_is_missing(monkeypatch):
    """A window where one of the step's kernels is absent, or shows a
    fractional count, is taken again; three such windows raise."""
    windows = iter([{"a_kernel": (1.0, 1.0)},
                    {"a_kernel": (1.0, 1.0), "b_kernel": (0.5, 0.5)},
                    {"a_kernel": (1.0, 1.0), "b_kernel": (2.0, 1.0)}])
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **_: contextlib.nullcontext(_Profile()))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(benchmark, "_device_events", lambda prof, iters: next(windows))
    _, events, _ = benchmark._profiled(lambda: None, 2, {"a_kernel", "b_kernel"})
    assert events == {"a_kernel": (1.0, 1.0), "b_kernel": (2.0, 1.0)}
    windows = iter([{"a_kernel": (1.0, 1.0)}] * 3)
    with pytest.raises(RuntimeError, match="b_kernel"):
        benchmark._profiled(lambda: None, 2, {"a_kernel", "b_kernel"})
