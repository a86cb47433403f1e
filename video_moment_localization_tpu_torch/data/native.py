"""ctypes bindings for the native host-pipeline kernels (csrc/vml_native.cpp).

Counterpart of ``video_moment_localization_tpu/data/native.py``. The port
keeps its own copy of the C source, ``video_moment_localization_tpu_torch/
csrc/vml_native.cpp``, and builds it with g++ at first use into the
package's ``_build/`` (gitignored), under a name that carries a hash of the
source and flags; it never writes the JAX package's library, so both
packages can run side by side. Every entry point has a NumPy path with the
same results, taken when the library cannot be built or ``VML_NATIVE=0`` is
set. `backend` says which path the process took.

Native wins on the input pipeline's per-sample label generation, where
NumPy's per-op dispatch overhead dominates the tiny (L, L)/(L,) arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from video_moment_localization_tpu_torch.data import labels as np_labels

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "vml_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_FLAGS = ("-O3", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_why_numpy = ""

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _library_path() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libvml_native-{digest.hexdigest()[:16]}.so")


def _build() -> str:
    """Path of the built library, compiling it if absent. The library is
    written under a temporary name and renamed, so a process that loads it
    never sees a partial file."""
    so = _library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="libvml_native-", suffix=".tmp", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried, _why_numpy
    if os.environ.get("VML_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.SubprocessError) as e:
            _why_numpy = f"g++ build or load failed: {e}"
            return None
        lib.vml_generate_labels.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,
        ]
        lib.vml_generate_labels.restype = None
        lib.vml_build_masks.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _f32p, _f32p, _f32p,
        ]
        lib.vml_build_masks.restype = None
        lib.vml_sample_indices.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, _i32p, _i32p, _i32p,
        ]
        lib.vml_sample_indices.restype = ctypes.c_int32
        lib.vml_generate_labels_packed.argtypes = lib.vml_generate_labels.argtypes
        lib.vml_generate_labels_packed.restype = None
        lib.vml_build_masks_packed.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _f32p, _f32p,
        ]
        lib.vml_build_masks_packed.restype = None
        lib.vml_assemble_batch_packed.argtypes = [
            _f64p, _f64p, _f64p, _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ] + [_f32p] * 9
        lib.vml_assemble_batch_packed.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def backend() -> str:
    """Which path the label and sampler functions take in this process:
    ``native (<library>)`` or ``numpy (<reason>)``."""
    lib = get_lib()
    if lib is not None:
        return f"native ({os.path.basename(lib._name)})"
    if os.environ.get("VML_NATIVE", "1") == "0":
        return "numpy (VML_NATIVE=0)"
    return f"numpy ({_why_numpy})"


def _fp(a: np.ndarray) -> "_f32p":
    return a.ctypes.data_as(_f32p)


def _numpy_labels(spos: float, epos: float, duration: float, L: int, packed: bool):
    sm = np_labels.iou_target_map(spos, epos, duration, L)
    if packed:
        sm = np_labels.pack_triu(sm)
    ss, se = np_labels.boundary_penalties(spos, epos, duration, L)
    ya = np_labels.snippet_labels(spos, epos, duration, L)
    return (sm, (sm > 0.5).astype(np.float32), ss, (ss > 0.5).astype(np.float32), se,
            (se > 0.5).astype(np.float32), ya)


def generate_labels(spos: float, epos: float, duration: float, L: int):
    """All per-sample labels in one native call (NumPy-fallback compatible).

    Returns (sm, ym, ss, ys, se, ye, ya) float32 arrays.
    """
    lib = get_lib()
    if lib is None:
        return _numpy_labels(spos, epos, duration, L, packed=False)
    sm = np.empty((L, L), np.float32)
    ym = np.empty((L, L), np.float32)
    ss, ys, se, ye, ya = (np.empty(L, np.float32) for _ in range(5))
    lib.vml_generate_labels(spos, epos, duration, L, _fp(sm), _fp(ym),
                            _fp(ss), _fp(ys), _fp(se), _fp(ye), _fp(ya))
    return sm, ym, ss, ys, se, ye, ya


def generate_labels_packed(spos: float, epos: float, duration: float, L: int):
    """Packed-layout labels: sm/ym are (N = L(L+1)/2,) in triu row-major
    order (ops/packing.py); boundary/snippet labels unchanged."""
    lib = get_lib()
    if lib is None:
        return _numpy_labels(spos, epos, duration, L, packed=True)
    N = L * (L + 1) // 2
    sm = np.empty(N, np.float32)
    ym = np.empty(N, np.float32)
    ss, ys, se, ye, ya = (np.empty(L, np.float32) for _ in range(5))
    lib.vml_generate_labels_packed(spos, epos, duration, L, _fp(sm), _fp(ym),
                                   _fp(ss), _fp(ys), _fp(se), _fp(ye), _fp(ya))
    return sm, ym, ss, ys, se, ye, ya


def build_masks(nfeats: int, T: int, L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(video_mask (T,1), length_mask (L,), moment_mask (L,L)) float32."""
    lib = get_lib()
    if lib is None:
        return np_labels.build_masks(nfeats, T, L)
    video_mask = np.empty(T, np.float32)
    length_mask = np.empty(L, np.float32)
    moment_mask = np.empty((L, L), np.float32)
    lib.vml_build_masks(nfeats, T, L, _fp(video_mask), _fp(length_mask), _fp(moment_mask))
    return video_mask[:, None], length_mask, moment_mask


def build_masks_packed(nfeats: int, T: int, L: int) -> Tuple[np.ndarray, np.ndarray]:
    """(video_mask (T,1), length_mask (L,)): packed mode builds no dense
    moment mask (the device derives pair validity from length_mask)."""
    lib = get_lib()
    if lib is None:
        video_mask, length_mask, _ = np_labels.build_masks(nfeats, T, L)
        return video_mask, length_mask
    video_mask = np.empty(T, np.float32)
    length_mask = np.empty(L, np.float32)
    lib.vml_build_masks_packed(nfeats, T, L, _fp(video_mask), _fp(length_mask))
    return video_mask[:, None], length_mask


def assemble_batch_packed(spos, epos, duration, nfeats, T: int, L: int):
    """Whole-batch packed masks + labels in ONE native call.

    spos/epos/duration: float arrays (B,); nfeats: int array (B,), -1 for
    padded rows (zero-filled outputs). Returns a dict of batch arrays
    {video_mask (B,T,1), length_mask, sm, ym, ss, ys, se, ye, ya}, or None
    when the native library is unavailable (the caller then takes the
    per-sample path).
    """
    lib = get_lib()
    if lib is None:
        return None
    B = len(nfeats)
    N = L * (L + 1) // 2
    spos = np.ascontiguousarray(spos, np.float64)
    epos = np.ascontiguousarray(epos, np.float64)
    duration = np.ascontiguousarray(duration, np.float64)
    nfeats = np.ascontiguousarray(nfeats, np.int32)
    if not (len(spos) == len(epos) == len(duration) == B):
        raise ValueError("assemble_batch_packed: spos, epos, duration and nfeats differ in length")
    out = {
        "video_mask": np.empty((B, T), np.float32),
        "length_mask": np.empty((B, L), np.float32),
        "sm": np.empty((B, N), np.float32),
        "ym": np.empty((B, N), np.float32),
    }
    for k in ("ss", "ys", "se", "ye", "ya"):
        out[k] = np.empty((B, L), np.float32)
    lib.vml_assemble_batch_packed(
        spos.ctypes.data_as(_f64p), epos.ctypes.data_as(_f64p),
        duration.ctypes.data_as(_f64p), nfeats.ctypes.data_as(_i32p),
        B, T, L,
        _fp(out["video_mask"]), _fp(out["length_mask"]),
        _fp(out["sm"]), _fp(out["ym"]), _fp(out["ss"]), _fp(out["ys"]),
        _fp(out["se"]), _fp(out["ye"]), _fp(out["ya"]),
    )
    out["video_mask"] = out["video_mask"][..., None]
    return out


def sample_indices(nfeats: int, T: int, spos: int, start_pos_n: float, end_pos_n: float):
    """Native sampler index math; returns (frame_idx (n,), start_i, end_i)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    frame_idx = np.empty(T, np.int32)
    si = ctypes.c_int32()
    ei = ctypes.c_int32()
    n = lib.vml_sample_indices(
        nfeats, T, spos, start_pos_n, end_pos_n,
        frame_idx.ctypes.data_as(_i32p), ctypes.byref(si), ctypes.byref(ei),
    )
    return frame_idx[:n], int(si.value), int(ei.value)
