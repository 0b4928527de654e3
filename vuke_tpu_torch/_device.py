"""Device checks and u32-word helpers shared by the port.

u32 words are stored as ``torch.uint32``.  On the CPU that dtype has no
shifts, adds or compares, so the plain PyTorch versions compute in int64
with ``& MASK32`` and cast back at their boundaries; the CUDA kernels read
and write ``uint32_t*`` directly.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def require_cuda(index: int = 0) -> torch.device:
    """Card ``index``, an H100 the kernels are built for, or raise."""
    if not torch.cuda.is_available():
        raise RuntimeError("vuke_tpu_torch: no CUDA device is available")
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise RuntimeError(f"vuke_tpu_torch: no CUDA device {index} ({count} visible)")
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(
            f"vuke_tpu_torch: kernels target sm_90a (Hopper); device {index} "
            f"{torch.cuda.get_device_name(index)!r} has capability {cap}")
    return torch.device("cuda", index)


def rank_device() -> torch.device:
    """This process's card: rank r of a torch.distributed world runs on
    ``cuda:{r % device_count}`` (``parallel/multihost.py``), a process
    outside one on card 0; raise without a card."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise RuntimeError("vuke_tpu_torch: no CUDA device is available")
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return require_cuda(rank % torch.cuda.device_count())


def run_device(device) -> torch.device:
    """The device a command runs on (``--device``): a bare "cuda" is this
    process's card (``rank_device``), "cuda:i" card i (checked), "cpu" the
    plain versions."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return rank_device() if dev.index is None else require_cuda(dev.index)


def device_key(device) -> str:
    """The key of a per-device cache: the indexed device, so that "cuda"
    (the current card) and "cuda:0" are one entry when card 0 is current."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def i64(words: torch.Tensor) -> torch.Tensor:
    """uint32 (or int64) words -> int64 values in [0, 2^32)."""
    return words.to(torch.int64)


def u32(values: torch.Tensor) -> torch.Tensor:
    """int64 values -> uint32 words (low 32 bits)."""
    return (values & MASK32).to(torch.uint32)


def byteswap32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the byte order of int64-held u32 words."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def rotl32(x: torch.Tensor, n: int) -> torch.Tensor:
    n &= 31
    if n == 0:
        return x
    return ((x << n) | (x >> (32 - n))) & MASK32


def rotr32(x: torch.Tensor, n: int) -> torch.Tensor:
    return rotl32(x, 32 - n)


def check_words(t: torch.Tensor, rows: int, name: str) -> int:
    """Validate a word-major (rows, N) contiguous uint32 tensor; return N."""
    if t.dtype != torch.uint32:
        raise TypeError(f"{name}: expected torch.uint32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: expected shape ({rows}, N), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.shape[1]


def check_same_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
