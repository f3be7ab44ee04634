"""ctypes binding for the native DTW core (`native/dtw_core.cpp`).

Counterpart of `vpd_tpu/ops/dtw_native.py`: the host DTW of one pair at a
time in C++, in float64, the same step patterns and normalization as the
numpy DP in `ops/dtw.py`. The source is the JAX package's, read in place
and unchanged; the port builds its own copy of the library with g++ into
`vpd_tpu_torch/_build/host/libvpddtw.so` at first use
(`ops._build.build_locked`) and never writes under `native/`, whose
library the JAX package builds and owns. Where g++ is missing or the
build fails, `available()` is False and `ops.dtw.build_dtw_distance_fn`
returns the numpy DP.
"""

import ctypes
import os
import subprocess

import numpy as np

from . import _build

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))
SRC = os.path.join(_REPO_ROOT, 'native', 'dtw_core.cpp')
LIB_PATH = os.path.join(str(_build.BUILD_DIR), 'host', 'libvpddtw.so')

_STEP_IDS = {'symmetric2': 0, 'symmetricP2': 1}

_lib = None
_lib_failed = False


def get_lib():
    """The native library, built if needed, or None where it cannot be
    built or loaded (no g++)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        _build.build_locked(SRC, LIB_PATH)
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        _lib_failed = True
        return None
    lib.vpd_dtw_from_costs.restype = ctypes.c_double
    lib.vpd_dtw_from_costs.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32]
    lib.vpd_dtw_from_seqs.restype = ctypes.c_double
    lib.vpd_dtw_from_seqs.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32]
    _lib = lib
    return _lib


def available():
    return get_lib() is not None


def _as_c(x):
    x = np.ascontiguousarray(x, dtype=np.float64)
    return x, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dtw_distance_native(d, step_pattern='symmetricP2', normalized=True):
    """DTW of a precomputed (N, M) cost matrix via the native core."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError('the native DTW core did not build')
    d, ptr = _as_c(d)
    if d.ndim != 2:
        raise ValueError('expected an (N, M) cost matrix, got shape {}'
                         .format(d.shape))
    return lib.vpd_dtw_from_costs(
        ptr, d.shape[0], d.shape[1], _STEP_IDS[step_pattern],
        int(normalized))


def dtw_seq_distance_native(a, b, step_pattern='symmetricP2',
                            normalized=True):
    """Fused pairwise-L2 + DTW of two (T, D) sequences."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError('the native DTW core did not build')
    a, pa = _as_c(a)
    b, pb = _as_c(b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError('expected (T, D) sequences of one D, got {} and {}'
                         .format(a.shape, b.shape))
    return lib.vpd_dtw_from_seqs(
        pa, a.shape[0], pb, b.shape[0], a.shape[1],
        _STEP_IDS[step_pattern], int(normalized))


def build_native_dtw_fn(step_pattern='symmetricP2'):
    """Drop-in for ops.dtw.build_dtw_distance_fn using the native core."""
    def fn(a, b):
        return dtw_seq_distance_native(a, b, step_pattern)
    return fn
