"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``_build/`` beside this
package (listed in ``.gitignore``). The library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing is built when a module is imported: the CPU tests
import every module, and the CPU has no nvcc.

`build` compiles several sources at once, one nvcc process each, started
together; `load_library` builds one source if needed and loads it. A file
lock in ``_build/`` makes processes that build at once (the ranks of a
data-parallel run) take turns: the first compiles, the others find its
library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")
MAX_SMEM_BYTES = 232448   # dynamic shared memory one H100 block may use (227 KB)

_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default home."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))) + [
            os.path.join(CSRC_DIR, f"{name}.cu")]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on ``_build/`` across processes and threads."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock, open(os.path.join(BUILD_DIR, ".lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named sources that have no current library, all at once.

    Returns {name: library path}. The compiler's report (registers, shared
    memory, spills) is kept in ``_build/<name>.log``. Raises on the first
    source that fails to compile, with nvcc's output."""
    with _build_lock():
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, str]:
    paths = {name: _library_path(name) for name in names}
    jobs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as fh:
            fh.write(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    path = build([name])[name]
    lib = ctypes.CDLL(path)
    lib.vml_error_string.argtypes = [ctypes.c_int]
    lib.vml_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err} "
                           f"({lib.vml_error_string(err).decode()})")


def resolve_device(device, who: str):
    """The device of an entry point, which runs on the card unless the CPU
    is asked for: raises when ``device`` is CUDA and there is none. On a CUDA
    device it turns TF32 off for the process
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``): the port is fp32 throughout, as the
    JAX fp32 kernels run their matmuls at HIGHEST precision."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def refuse_grad(fn: str, tensors) -> None:
    """Raise if a grad-free kernel wrapper is asked to record a graph: grad
    mode is on and an input or weight requires grad. Without this the
    wrapper would return a result cut off from the graph, silently."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn} has no backward kernel and got tensors that require grad with grad "
            f"mode on: call it under torch.no_grad() (serving, evaluation), or train "
            f"through models.smin.smin_forward")


def check_tensors(fn: str, device, want, dtype=None) -> None:
    """Raise unless every (name, tensor, shape) of ``want`` is a contiguous
    tensor of that shape on ``device``: float32, or with ``dtype`` bfloat16
    (a kernel's bf16 variant) bf16 but for the masks (names ending in
    "mask") and the biases (weights of one dimension), which stay float32. A
    1x1 convolution's weight (out, in, 1, 1) counts as (out, in)."""
    import torch

    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: the kernel takes float32 or bfloat16, got {dtype}")
    for name, t, shape in want:
        want_dtype, weight = _tensor_rule(name, len(shape), dtype)
        t_shape = t.shape
        if weight and len(t_shape) == 4:
            t_shape = t_shape[:2]
        if (t_shape != tuple(shape) or t.dtype != want_dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name}: want contiguous {want_dtype} {tuple(shape)} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


@functools.lru_cache(maxsize=None)
def _tensor_rule(name: str, rank: int, dtype):
    """`check_tensors`' rule for one name: (its dtype, whether it is a
    weight), worked out once per name, rank and kernel dtype."""
    import torch

    weight = name.startswith("weight")
    fp32 = (dtype in (None, torch.float32) or name.endswith("mask")
            or (weight and rank == 1))
    return (torch.float32 if fp32 else dtype), weight


def pointer_array(tensors):
    """A host array of the tensors' device addresses, for a ``void**``
    argument."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor, for a c_void_p argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
