"""vuke_tpu_torch: the vuke-tpu derive paths on PyTorch and CUDA (Hopper).

A port of ``vuke_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference.  This package imports ``torch`` and never ``jax``, nor anything
of ``vuke_tpu``: it keeps its own copies of the host helpers it needs
(``ecc/ref.py``, ``encode.py``, ``derive.py``).  Ported so far: the scan
over a range source for the milksad and direct:be transforms, with the
five Pallas kernels on those paths (MT19937 keygen, fixed-base scalar
multiplication, the sequential scan's point addition, batch inversion +
affine, hash160) rewritten as CUDA C++ for sm_90a under ``csrc/``.  Each
kernel has a plain PyTorch version beside it, which a CPU tensor goes
through.
"""

__version__ = "0.2.0"
