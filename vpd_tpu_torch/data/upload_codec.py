"""Opt-in lossy upload codec for host->device crop transfer (YUV 4:2:0).

Counterpart of `vpd_tpu/data/upload_codec.py`. The host packs RGB into a
full-resolution luma plane and 2x2-pooled chroma planes (BT.601 full
range, 1.5 bytes a pixel against raw's 3), and the card rebuilds uint8
RGB before anything else runs on the batch. Chroma subsampling is lossy,
so the codec is opt-in (`--upload_codec yuv420`); `y8` ships the luma
plane alone, for the luminance-only Lucas-Kanade flow.

The encoders here are numpy copies of vpd_tpu's (the native C++ packers
of `native/crop_loader.cpp` when the library builds; the one that ran is
counted in `packer_calls`). `decode_yuv420` is the device decode on
tensors and equals `decode_yuv420_reference` bit for bit on the CPU and on
the card: every division is an IEEE division by a float32 tensor (a
divisor given as a Python float becomes a multiply by its reciprocal on
CUDA), and no multiply is fused with an add.
"""

import numpy as np
import torch

CODECS = ('raw', 'yuv420')
# flow-upload codecs (tools/compute_flow.py): y8 ships ONLY the luma
# plane (1/3 the bytes), valid for the luminance-only LK estimator
FLOW_CODECS = ('raw', 'yuv420', 'y8')

# BT.601 full-range analog coefficients (the standard JPEG/YCbCr pair).
_KR, _KG, _KB = 0.299, 0.587, 0.114
_U_SCALE = 0.564  # = 0.5 / (1 - KB)
_V_SCALE = 0.713  # = 0.5 / (1 - KR)

# host batches each packer packed, in this process
packer_calls = {'native': 0, 'numpy': 0}


def packed_nbytes(h, w):
    """Per-sample packed size: full-res Y + quarter-res U and V."""
    if h % 2 or w % 2:
        raise ValueError('yuv420 needs even dims, got {}x{}'.format(h, w))
    return h * w + 2 * (h // 2) * (w // 2)


def _native_packer(name):
    from . import native_loader
    lib = native_loader.get_lib()
    return lib is not None and hasattr(lib, name)


def encode_yuv420(rgb_u8, n_threads=None):
    """(B, H, W, 3) uint8 RGB -> (B, H*W*3//2) uint8 packed YUV 4:2:0,
    with the native packer when the library has it, else numpy (the same
    float32 spec, bit for bit)."""
    if _native_packer('vpd_yuv420_pack'):
        from . import native_loader
        packer_calls['native'] += 1
        return native_loader.yuv420_pack(rgb_u8, n_threads=n_threads)
    packer_calls['numpy'] += 1
    return encode_yuv420_numpy(rgb_u8)


def encode_yuv420_numpy(rgb_u8):
    """Pure-numpy encoder (the native packer's oracle).

    Spec (deterministic float32, fixed op order):
      Y   = rint(0.299 R + 0.587 G + 0.114 B)          per pixel
      R2,G2,B2 = 2x2 integer sums * 0.25               per chroma site
      Y2  = 0.299 R2 + 0.587 G2 + 0.114 B2
      U   = rint((B2 - Y2) * 0.564 + 128)
      V   = rint((R2 - Y2) * 0.713 + 128)
    """
    b, h, w, _ = rgb_u8.shape
    packed_nbytes(h, w)
    x = rgb_u8.astype(np.float32)
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    y = _KR * r + _KG * g + _KB * bl
    x16 = rgb_u8.astype(np.uint16)
    p = (x16[:, 0::2, 0::2] + x16[:, 0::2, 1::2]
         + x16[:, 1::2, 0::2] + x16[:, 1::2, 1::2]) \
        .astype(np.float32) * np.float32(0.25)
    r2, g2, b2 = p[..., 0], p[..., 1], p[..., 2]
    y2 = _KR * r2 + _KG * g2 + _KB * b2
    u = (b2 - y2) * _U_SCALE + 128.0
    v = (r2 - y2) * _V_SCALE + 128.0

    def q(z):
        return np.clip(np.rint(z), 0, 255).astype(np.uint8)

    return np.concatenate(
        [q(y).reshape(b, -1), q(u).reshape(b, -1), q(v).reshape(b, -1)],
        axis=1)


def encode_luma(rgb_u8, n_threads=None):
    """(B, H, W, 3) uint8 RGB -> (B, H*W) uint8 luma plane, bit-equal to
    the first H*W bytes of `encode_yuv420` (odd dims allowed)."""
    if _native_packer('vpd_luma_pack'):
        from . import native_loader
        packer_calls['native'] += 1
        return native_loader.luma_pack(rgb_u8, n_threads=n_threads)
    packer_calls['numpy'] += 1
    x = rgb_u8.astype(np.float32)
    y = _KR * x[..., 0] + _KG * x[..., 1] + _KB * x[..., 2]
    return np.clip(np.rint(y), 0, 255).astype(np.uint8) \
        .reshape(rgb_u8.shape[0], -1)


def _f32(value, like):
    """A float32 0-d tensor on `like`'s device: dividing by it is an IEEE
    division on the CPU and on CUDA alike."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def decode_yuv420(packed, h, w):
    """(B, H*W*3//2) uint8 tensor -> (B, H, W, 3) uint8 RGB on its device.

    Chroma is upsampled nearest; the inverse BT.601 transform runs in
    float32 and rounds back to uint8, bit-equal to
    `decode_yuv420_reference`.
    """
    b = packed.shape[0]
    n_y = h * w
    n_c = (h // 2) * (w // 2)
    y = packed[:, :n_y].to(torch.float32).reshape(b, h, w)
    u = packed[:, n_y:n_y + n_c].to(torch.float32) \
        .reshape(b, h // 2, w // 2) - 128.0
    v = packed[:, n_y + n_c:].to(torch.float32) \
        .reshape(b, h // 2, w // 2) - 128.0
    # nearest 2x upsample without gathers: insert axes and broadcast
    u = u[:, :, None, :, None].expand(b, h // 2, 2, w // 2, 2) \
        .reshape(b, h, w)
    v = v[:, :, None, :, None].expand(b, h // 2, 2, w // 2, 2) \
        .reshape(b, h, w)
    r = y + v / _f32(_V_SCALE, y)
    bl = y + u / _f32(_U_SCALE, y)
    g = (y - _KR * r - _KB * bl) / _f32(_KG, y)
    rgb = torch.stack([r, g, bl], dim=-1).clamp_(0.0, 255.0)
    # values are clipped first, so floor(x + .5) is np.rint here
    return torch.floor(rgb + 0.5).to(torch.uint8)


def decode_yuv420_reference(packed, h, w):
    """Numpy oracle for `decode_yuv420` (same math, host-side)."""
    b = packed.shape[0]
    n_y = h * w
    n_c = (h // 2) * (w // 2)
    y = packed[:, :n_y].astype(np.float32).reshape(b, h, w)
    u = packed[:, n_y:n_y + n_c].astype(np.float32) \
        .reshape(b, h // 2, w // 2) - 128.0
    v = packed[:, n_y + n_c:].astype(np.float32) \
        .reshape(b, h // 2, w // 2) - 128.0
    u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2)
    v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2)
    r = y + v / _V_SCALE
    bl = y + u / _U_SCALE
    g = (y - _KR * r - _KB * bl) / _KG
    rgb = np.stack([r, g, bl], axis=-1)
    rgb = np.clip(rgb, 0.0, 255.0)
    return np.floor(rgb + 0.5).astype(np.uint8)
