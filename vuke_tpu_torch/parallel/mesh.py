"""The seed lattice's one data-parallel axis over the visible cards.

The port of ``vuke_tpu/parallel/mesh.py``'s 1-D "seeds" mesh.  The work is
embarrassingly parallel over seeds, so the axis is a list of devices and a
global batch splits into one contiguous slice a device; each device runs
the whole derive on its slice with no collective until a result is reduced
on the host.  Its one user is ``benchmark.bench_derive``, as the mesh's is
in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .._device import require_cuda


def get_devices() -> List[torch.device]:
    """Every visible card, each checked (``_device.require_cuda``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("vuke_tpu_torch: no CUDA device is available")
    return [require_cuda(i) for i in range(torch.cuda.device_count())]


def split_seeds(batch: int, devices: Sequence) -> List[Tuple[object, int, int]]:
    """(device, first offset, count) of each device's contiguous slice of a
    global batch of ``batch`` seeds.  Several devices need a batch aligned
    to 1024 seeds a device, as ``vuke_tpu/benchmark.py``'s sharded path
    asserts; here a ValueError with its message."""
    n_dev = len(devices)
    if n_dev > 1 and batch % (n_dev * 1024) != 0:
        raise ValueError("global batch must be n_dev*1024-aligned")
    per = batch // n_dev
    return [(dev, i * per, per) for i, dev in enumerate(devices)]
