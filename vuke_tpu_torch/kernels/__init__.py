"""Build-on-first-use loader for the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into ONE shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are
included, so a cold build takes seconds, not minutes.
The library is keyed by a hash of the sources and flags and lives under
``vuke_tpu_torch/_build/`` (git-ignored); a rebuild happens only when a
source changes.

Nothing here runs at import: the CPU tests import every module of the port
and never touch ``nvcc``.  A missing ``nvcc``, a failed build or a failed
launch raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR = ctypes.c_void_p
SIZE = ctypes.c_longlong
INT = ctypes.c_int
U32 = ctypes.c_uint32


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an up-to-date library was reused
    log: str                 # nvcc/ptxas output: registers and spills per kernel


def _build(nvcc: str, so: Path) -> str:
    """One ``nvcc -c`` per source, started together, then one link; returns
    the compilers' output.  Raises if any step fails."""
    tag = f"{so.stem}.{os.getpid()}"
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{logs[-1]}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (if needed) and load the kernel library."""
    so = BUILD_DIR / f"libvuke_kernels_{_digest()}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(nvcc, so)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
    cdll = ctypes.CDLL(str(so))
    cdll.vk_error_string.argtypes = [INT]
    cdll.vk_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return Library(cdll, so, seconds, log)


def entry_name(mangled: str) -> str:
    """The unqualified name of a mangled (Itanium C++ ABI) entry function,
    ``_ZN12_GLOBAL__N_111smul_kernelE...`` -> ``smul_kernel``; an unmangled
    name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    name, i = mangled, 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        i = j + int(mangled[i:j])
        name = mangled[j:i]
    return name


def ptxas_usage(log: str) -> list[tuple[str, int, int, int]]:
    """(entry function's name as the log has it, registers, stack bytes,
    spill store + load bytes) per entry of a ``-Xptxas -v`` log;
    ``entry_name`` gives the unqualified name."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads.*?Used (\d+) registers", chunk, flags=re.S)
        if m:
            stack, st, ld, regs = map(int, m.groups())
            out.append((chunk.split("'")[0], regs, stack, st + ld))
    return out


class Kernel:
    """One CUDA entry point of the library and its launch count.

    ``launches`` goes up by one each time the kernel is launched, and
    nowhere else, so a run can show that its main path went through it.
    ``entry`` is the name of the ``__global__`` function it launches;
    ``Kernel.registry`` holds every kernel by name."""

    route = "cuda"
    registry: dict[str, "Kernel"] = {}

    def __init__(self, name: str, symbol: str, argtypes, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source
        self.replaces = replaces
        self.entry = f"{name}_kernel"
        self.launches = 0
        Kernel.registry[name] = self

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point on ``device``'s current stream; raise on a
        non-zero launch status."""
        lib = library().cdll
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes + [PTR]
        fn.restype = INT
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            status = fn(*args, stream)
        if status != 0:
            msg = lib.vk_error_string(status).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: {msg} ({status})")
        self.launches += 1
