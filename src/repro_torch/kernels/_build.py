"""Build the CUDA kernels at first use and call them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own (one ``nvcc`` per source, all
started together) into ``build/kernels/<name>-<hash>.so`` at the repository
root, a directory ``.gitignore`` lists.  The hash covers the source, the
shared headers and the flags, so an edited source rebuilds.  The sources
have a plain C interface (no PyTorch headers), which keeps a build to
seconds; pointers and the stream go across as integers.

``launch`` is the one place a kernel is called: it raises on a CUDA error
and then adds one to the kernel's count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("verify_attention", "fused_verify", "fused_heads",
           "tree_verify_attention", "paged_verify_attention", "rwkv6_scan",
           "rwkv6_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes the C entry points take (csrc/common.cuh: kFloat32, kBFloat16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches per kernel since the last reset_launches(); read by chip_smoke.py
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# of LAUNCHES["rwkv6_scan"], those that wrote the training forward's
# checkpoints (kernels/rwkv6_scan.py); reset with LAUNCHES
CHECKPOINTED_SCANS = 0

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, object] = {}


def reset_launches() -> None:
    global CHECKPOINTED_SCANS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    CHECKPOINTED_SCANS = 0


def require(kernel: str, cond: bool, msg: str) -> None:
    """A wrapper's input check: raise, naming the kernel, before any launch."""
    if not cond:
        raise ValueError(f"{kernel} kernel: {msg}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the wrappers' plans size to them)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all at once.  Raises with nvcc's stderr."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu: nvcc exited {proc.returncode}\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.bpd_error_string.argtypes = [ctypes.c_int]
        lib.bpd_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, symbol: str, argtypes: Sequence, *args) -> None:
    """Call ``symbol`` of kernel library ``name`` (a C function returning a
    ``cudaError_t``), raise if it is not 0, and count the launch."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    err = fn(*args)
    if err != 0:
        msg = library(name).bpd_error_string(err).decode()
        raise RuntimeError(f"{symbol} kernel failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
