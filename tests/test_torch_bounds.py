"""``chip_smoke.bound``: each kernel's least time at the main path's shape;
and the ``-Xptxas -v`` reading behind phase 2's registers and spills.

A field product is 8 x 8 32x32-bit products, each two 32-bit multiply
results (low and high word): 128; a squaring 28 cross products and 8
squares: 72.  Pinned at N = 2^19 and the H100's 132 SMs x 64 results per
clock x 1.98 GHz = 1.6727e13 32-bit multiply results per second.
"""

import pytest

import chip_smoke
from vuke_tpu_torch import kernels

RATE = 132 * 64 * 1.98e9
N = 1 << 19


@pytest.mark.parametrize("name,ops,ms,by", [
    ("smul", 29_200, 0.915, "operations"),
    ("smul_w8", 36_208, 1.135, "operations"),
    ("inv_affine", 1_024, 0.032, "operations"),
    ("seq_madd", 784, 0.030, "bytes"),
])
def test_bound_counts_multiply_results(name, ops, ms, by):
    assert chip_smoke.WORK_PER_LANE[name][1] == ops
    got_ms, got_by = chip_smoke.bound(name, N, RATE)
    assert got_by == by
    assert got_ms == pytest.approx(ms, abs=5e-4)


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
    its registers, stack and spill bytes, under a short name."""
    assert kernels.ptxas_usage(PTXAS_LOG) == [("inv_affine_kernel", 88, 64, 0),
                                              ("smul_kernel", 96, 16, 32)]
