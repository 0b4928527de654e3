"""vuke_tpu_torch MT19937 keygen (K1's plain version) against the JAX package.

The Pallas kernel body ``_mt_kernel`` is run eagerly under numpy (refs are
plain arrays), and ``mt19937.milksad_key_words`` under the package's numpy
backend: no jax compile.  With ``normalize``, against that body followed by
``tiled._normalize_words_t`` (eager jax on the CPU).  Lane-exact (tolerance
0: integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vuke_tpu.cores.pallas_kernels as pk
from vuke_tpu._lazy import numpy_backend
from vuke_tpu.cores import mt19937 as jmt
from vuke_tpu.ecc import tiled as jtiled
from vuke_tpu_torch.cores import mt19937
from vuke_tpu_torch.ecc import scalar

ADVERSARIAL = [0, 1, 5489, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]


def _seeds(n, seed=0):
    s = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint32)
    s[:len(ADVERSARIAL)] = ADVERSARIAL
    return s


def _port(seeds_np):
    return mt19937.milksad_key_words(torch.from_numpy(seeds_np)).to(torch.int64).numpy()


def test_plain_matches_pallas_kernel_body(monkeypatch):
    monkeypatch.setattr(pk, "jnp", np)
    seeds = _seeds(2048)                            # two (8, 128) tiles
    out = np.zeros((8, 2, 8, 128), dtype=np.uint32)
    pk._mt_kernel(seeds.reshape(2, 8, 128), out)
    assert np.array_equal(_port(seeds), out.reshape(8, 2048))


def test_normalize_plain_matches_pallas_kernel_body_then_normalize(monkeypatch):
    monkeypatch.setattr(pk, "jnp", np)
    seeds = _seeds(2048, seed=3)
    out = np.zeros((8, 2, 8, 128), dtype=np.uint32)
    pk._mt_kernel(seeds.reshape(2, 8, 128), out)
    want = np.asarray(jtiled._normalize_words_t(jnp.asarray(out.reshape(8, 2048))))
    got = mt19937.milksad_key_words(torch.from_numpy(seeds), normalize=True)
    assert np.array_equal(got.to(torch.int64).numpy(), want)


def test_normalize_is_the_raw_words_through_normalize_words():
    seeds = torch.from_numpy(_seeds(512, seed=4))
    raw = mt19937.milksad_key_words(seeds)
    got = mt19937.milksad_key_words(seeds, normalize=True)
    assert got.dtype == torch.uint32 and got.shape == (8, 512)
    assert torch.equal(got.to(torch.int64), scalar.normalize_words_plain(raw).to(torch.int64))


def test_plain_matches_milksad_key_words_numpy_backend():
    seeds = _seeds(1000, seed=1)
    with numpy_backend():
        ref = np.asarray(jmt.milksad_key_words(seeds))[:, 0, :]   # (N, 8)
    assert np.array_equal(_port(seeds), ref.T)


def test_golden_seed_one():
    kw = _port(np.array([1], dtype=np.uint32))[:, 0]
    assert "".join(f"{int(v):08x}" for v in kw) == (
        "25f4c16aeb8047ff8c2f67b84814bceeff7e070089c3cc20cbaa654d851ec1ff")


@pytest.mark.parametrize("bad", [torch.zeros(8, dtype=torch.int64),
                                 torch.zeros((2, 8), dtype=torch.uint32),
                                 torch.zeros(16, dtype=torch.uint32)[::2]])
def test_wrapper_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        mt19937.milksad_key_words(bad)


def test_cpu_tensor_never_launches():
    before = mt19937.KERNEL.launches
    mt19937.milksad_key_words(torch.zeros(32, dtype=torch.uint32))
    assert mt19937.KERNEL.launches == before


def test_cpu_tensor_never_launches_with_normalize():
    before = mt19937.KERNEL.launches
    kw = mt19937.milksad_key_words(torch.zeros(32, dtype=torch.uint32), normalize=True)
    assert mt19937.KERNEL.launches == before
    assert kw.dtype == torch.uint32 and kw.shape == (8, 32)
