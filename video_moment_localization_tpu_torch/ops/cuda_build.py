"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``_build/`` beside this
package (listed in ``.gitignore``). The library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing is built when a module is imported: the CPU tests
import every module, and the CPU has no nvcc.

`build` compiles several sources at once, one nvcc process each, started
together; `load_library` builds one source if needed and loads it.
"""

from __future__ import annotations

import ctypes
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


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named sources that have no current library, all at once.

    Returns {name: library path}. The compiler's report (registers, shared
    memory, spills) is kept in ``_build/<name>.log``. Raises on the first
    source that fails to compile, with nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
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
    with _lock:
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


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor, for a c_void_p argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
