"""Root test configuration, loaded before ``tests/conftest.py``.

``JAX_PLATFORMS=cpu`` (the tier-1 command in ROADMAP.md sets it) runs the
JAX package's programs under the XLA:CPU compile flags of
``vuke_tpu._cache.apply_cpu_compile_flags`` (the AVX2 pin and LLVM -O1)
and pads the string drivers to ``VUKE_STRING_PAD=512``, so that they
share the numeric drivers' compiles.  Without the flags, one ECC compile
can run for most of an hour at LLVM -O3.  Both are set in ``os.environ``,
so subprocesses started by tests inherit them.  The device count stays
one; ``VUKE_TEST_PLATFORM=cpu`` (``make test-fast``) still selects the 8
virtual devices of ``tests/conftest.py``.
"""

import os

if os.environ.get("JAX_PLATFORMS") == "cpu":
    from vuke_tpu._cache import apply_cpu_compile_flags

    apply_cpu_compile_flags()
    os.environ.setdefault("VUKE_STRING_PAD", "512")
