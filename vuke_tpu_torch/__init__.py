"""vuke_tpu_torch: the vuke-tpu command line on PyTorch and CUDA (Hopper).

A port of ``vuke_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference.  This package imports ``torch`` and never ``jax``, nor anything
of ``vuke_tpu``: it keeps its own copies of the host modules it needs
(``ecc/ref.py``, ``encode.py``, ``derive.py``, ``output/``,
``progress.py``, ``parallel/checkpoint.py``, ``sources.py``,
``provider.py``, ``wallets/``, ``storage/``).  Ported so far: ``generate``,
``scan``, ``single``, ``warmup`` and ``query`` over every source for every
transform, the wallet ones included, with target files or ``boha:...``
provider references, Parquet storage, cloud upload and Iceberg
registration, and ``analyze`` with every analyzer; with the six Pallas
kernels on those paths (MT19937 keygen, the two fixed-base scalar
multiplications, the sequential scan's point addition, batch inversion +
affine, hash160) and the keygens, string digests, P2PKH encoding, the
reverse sweeps, PBKDF2-HMAC-SHA512, Electrum's key stretch and a storage
record's string columns rewritten as CUDA C++ for sm_90a under ``csrc/``.
Not yet ported: more than one card.  Each kernel has a plain PyTorch
version beside it, which a CPU tensor goes through.
"""

__version__ = "0.3.0"
