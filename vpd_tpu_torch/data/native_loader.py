"""ctypes binding for the native crop decoder (`native/crop_loader.cpp`).

Counterpart of `vpd_tpu/data/native_loader.py`: one ctypes call decodes a
whole uint8 batch of crop PNGs (rgb, optional flow, optional masks) in a
C++ thread pool over libpng, with the GIL released for the duration, so
decode overlaps the Python sampler and the device step. The source is the
JAX package's, read in place and unchanged; the port builds its own copy
of the library with g++ into `vpd_tpu_torch/_build/host/` at first use
(`ops._build.build_locked`) and never writes under `native/`, whose
library the JAX package builds and owns. Where g++ or libpng's headers
are missing, `available()` is False and `data/crops.decode_crop_batch`
takes the cv2/PIL path, which gives the same bytes.

Byte contract (the cv2 path's): rgb in RGB order, flow in raw (BGR)
order with consumers reading channels 0-1, masks as the single grey
channel. A missing or corrupt rgb or flow file raises; a missing mask
zero-fills. `yuv420_pack` and `luma_pack` bind the library's packers of
the upload codec (`data/upload_codec.py`), bit-equal to its numpy
encoders because the library is built with FMA contraction off.
"""

import ctypes
import os
import subprocess

import numpy as np

from ..ops import _build

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))
SRC = os.path.join(_REPO_ROOT, 'native', 'crop_loader.cpp')
LIB_PATH = os.path.join(str(_build.BUILD_DIR), 'host', 'libvpdloader.so')
# fp-contract=off: the library's yuv420 packer must match the numpy
# encoder bit for bit (FMA contraction under -march=native would move its
# float32 sums by one ulp)
BUILD_FLAGS = ('-lpng', '-lz', '-pthread', '-ffp-contract=off')

_lib = None
_lib_failed = False


def get_lib():
    """The native library, built if needed, or None where it cannot be
    built or loaded (no g++, no libpng)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        _build.build_locked(SRC, LIB_PATH, extra_flags=BUILD_FLAGS)
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        _lib_failed = True
        return None
    lib.vpd_decode_crops.restype = ctypes.c_int64
    lib.vpd_decode_crops.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]
    for pack_fn in (lib.vpd_yuv420_pack, lib.vpd_luma_pack):
        pack_fn.restype = ctypes.c_int64
        pack_fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return _lib


def available():
    return get_lib() is not None


def _paths_arg(paths):
    if paths is None:
        return None
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    return ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p))


def _buf_arg(arr, shape):
    if arr is None:
        return None
    if arr.dtype != np.uint8 or not arr.flags['C_CONTIGUOUS'] or \
            arr.shape != shape:
        raise ValueError('need a C-contiguous uint8 buffer of shape {}, got '
                         '{} {}'.format(shape, arr.dtype, arr.shape))
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_crops(rgb_paths, img_dim, *, flow_paths=None, mask_paths=None,
                 rgb_out=None, flow_out=None, mask_out=None,
                 n_threads=None):
    """Decode a batch of crop PNGs into uint8 arrays with the C++ pool.

    Returns (rgb, flow or None, mask or None): (n, S, S, 3), (n, S, S, 3),
    (n, S, S). `*_out` arrays, when given, must have exactly those shapes
    and are filled in place.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError('the native crop decoder is unavailable (no g++ '
                           'or libpng headers to build {})'.format(SRC))
    n = len(rgb_paths)
    for paths in (flow_paths, mask_paths):
        if paths is not None and len(paths) != n:
            raise ValueError('need one flow and mask path per rgb path')
    img = (n, img_dim, img_dim, 3)
    if rgb_out is None:
        rgb_out = np.empty(img, np.uint8)
    if flow_paths is not None and flow_out is None:
        flow_out = np.empty(img, np.uint8)
    if mask_paths is not None and mask_out is None:
        mask_out = np.empty(img[:3], np.uint8)
    if flow_paths is None:
        flow_out = None
    if mask_paths is None:
        mask_out = None
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    # the path arrays and buffers stay referenced here for the whole call
    paths = [_paths_arg(p) for p in (rgb_paths, flow_paths, mask_paths)]
    failures = lib.vpd_decode_crops(
        *paths, n, img_dim, n_threads, _buf_arg(rgb_out, img),
        _buf_arg(flow_out, img), _buf_arg(mask_out, img[:3]))
    if failures:
        raise IOError('{} crop/flow PNGs failed to decode'.format(failures))
    return rgb_out, flow_out, mask_out


def _pack(fn_name, rgb, out_cols, n_threads):
    lib = get_lib()
    if lib is None:
        raise RuntimeError('the native packers are unavailable (no g++ or '
                           'libpng headers to build {})'.format(SRC))
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError('need (B, H, W, 3) uint8 RGB, got {} {}'.format(
            rgb.dtype, rgb.shape))
    b, h, w, _ = rgb.shape
    out = np.empty((b, out_cols(h, w)), np.uint8)
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    rc = getattr(lib, fn_name)(_buf_arg(rgb, rgb.shape), b, h, w, n_threads,
                               _buf_arg(out, out.shape))
    if rc != 0:
        raise RuntimeError('{} failed: {}'.format(fn_name, rc))
    return out


def yuv420_pack(rgb, n_threads=None):
    """(B, H, W, 3) uint8 RGB -> (B, H*W*3//2) packed YUV 4:2:0 planes
    with the native single-pass packer (GIL released)."""
    from .upload_codec import packed_nbytes
    return _pack('vpd_yuv420_pack', rgb, packed_nbytes, n_threads)


def luma_pack(rgb, n_threads=None):
    """(B, H, W, 3) uint8 RGB -> (B, H*W) uint8 Y planes (the y8 codec;
    odd dims allowed)."""
    return _pack('vpd_luma_pack', rgb, lambda h, w: h * w, n_threads)
