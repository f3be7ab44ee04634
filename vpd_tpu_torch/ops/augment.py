"""Fused train-time input stage: cache rows -> augmented student input.

The hand-written CUDA kernel `csrc/train_augment.cu` (sm_90a) computes
the train step's whole input stage in one launch: the cache gather, colour
jitter, normalize, mask noise, flow decode, flip and RandomResizedCrop of
`data/augment.train_augment_batch`, on the draws `sample_train_augment`
made. It replaces no Pallas kernel (vpd_tpu's augmentation is XLA); the
plain chain it replaces on the card is 60-100 PyTorch launches, each
reading and writing the whole batch. The stage is bound by bytes: at
B = 2048, 128 x 128, 5 channels in bf16 every correct kernel reads the
rgb (the contrast mean reads the whole image) and writes the output,
436.2 MB, 130 us at the H100's 3.35 TB/s.

On a CPU tensor `train_augment` runs the plain twin: the rows gathered by
`index_select`, then `train_augment_batch`. On a CUDA tensor it launches
the kernel or raises. The kernel's variant follows from the inputs alone:
3 or 5 channels (flow or none), mask or none, jitter or none, the in and
out sizes, the output's dtype (bf16 or float32, computed in float32;
float64, computed in float64), in which the noise comes too. `launches`
counts kernel launches (not twin calls).
"""

import functools

import torch

from ..data.augment import JITTER_ORDERS, train_augment_batch

launches = 0

# the kernel's dtype codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_CROP = ('top', 'left', 'crop_h', 'crop_w')
_JITTER = ('fb', 'fc', 'fs', 'fh')


def _bad(msg):
    raise ValueError('train_augment: ' + msg)


def _check_pixels(pixels, rows):
    """The uint8 streams and the row indices: (rgb, flow, mask, B)."""
    rgb, flow, mask = (pixels.get(k) for k in ('rgb', 'flow', 'mask'))
    if not isinstance(rgb, torch.Tensor) or rgb.dtype != torch.uint8:
        _bad('rgb must be a uint8 tensor, got {}'.format(
            getattr(rgb, 'dtype', type(rgb).__name__)))
    if rgb.ndim != 4 or rgb.shape[-1] != 3:
        _bad('rgb must be (N, H, W, 3), got {}'.format(tuple(rgb.shape)))
    for name, t, ndim in (('flow', flow, 4), ('mask', mask, 3)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
            _bad('{} must be a uint8 tensor'.format(name))
        if t.ndim != ndim or t.shape[:3] != rgb.shape[:3] or (
                name == 'flow' and t.shape[-1] < 2):
            _bad('{} must be (N, H, W{}) beside rgb {}, got {}'.format(
                name, ', >=2' if name == 'flow' else '', tuple(rgb.shape),
                tuple(t.shape)))
        if t.device != rgb.device:
            _bad('{} lies on {}, rgb on {}'.format(name, t.device,
                                                   rgb.device))
    if rows is None:
        return rgb, flow, mask, rgb.shape[0]
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32 or \
            rows.ndim != 1:
        _bad('rows must be a (B,) int32 tensor')
    if rows.device != rgb.device:
        _bad('rows lie on {}, rgb on {}'.format(rows.device, rgb.device))
    return rgb, flow, mask, rows.shape[0]


def _check_kernel_args(rgb, flow, mask, rows, b, draws, jitter, mean, std,
                       out_size, dtype):
    """What the kernel takes beyond the plain path: contiguous streams,
    bf16, float32 or float64 output, noise in the output's dtype, float32
    draws of the batch on rgb's device."""
    if dtype not in _DTYPE_CODES:
        _bad('the kernel writes bfloat16, float32 or float64, not {}'.format(
            dtype))
    for name, t in (('rgb', rgb), ('flow', flow), ('mask', mask),
                    ('rows', rows)):
        if t is not None and not t.is_contiguous():
            _bad('{} must be contiguous'.format(name))
    if len(mean) != 3 or len(std) != 3:
        _bad('mean and std need 3 values each')
    if not isinstance(out_size, int) or out_size <= 0:
        _bad('out_size must be a positive int, got {!r}'.format(out_size))
    h, w = rgb.shape[1:3]
    want = {k: ((b,), (torch.float32,)) for k in _CROP}
    want['flip'] = ((b,), (torch.bool,))
    if jitter:
        want.update({k: ((b,), (torch.float32,)) for k in _JITTER})
        if 'perms' in draws:
            want['perms'] = ((b, 4), (torch.int64,))
        elif not (isinstance(draws.get('order'), int)
                  and 0 <= draws['order'] < len(JITTER_ORDERS)):
            _bad('jitter needs draws["perms"] or an int draws["order"] '
                 'in [0, {})'.format(len(JITTER_ORDERS)))
    if mask is not None:
        want['noise'] = ((b, h, w, 3), (dtype,))
        want['apply_noise'] = ((b,), (torch.bool,))
    for k, (shape, dtypes) in want.items():
        t = draws.get(k)
        if not isinstance(t, torch.Tensor):
            _bad('draws["{}"] is missing'.format(k))
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            _bad('draws["{}"] must be {} of {}, got {} of {}'.format(
                k, shape, ' or '.join(map(str, dtypes)), tuple(t.shape),
                t.dtype))
        if t.device != rgb.device:
            _bad('draws["{}"] lies on {}, rgb on {}'.format(k, t.device,
                                                           rgb.device))
        if not t.is_contiguous():
            _bad('draws["{}"] must be contiguous'.format(k))


@functools.lru_cache(maxsize=None)
def _order_table(device):
    """JITTER_ORDERS as a (24, 4) int64 tensor on `device`, made once: a
    batch-wide order is one of its rows, read with row stride 0."""
    return torch.tensor(JITTER_ORDERS, dtype=torch.int64, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(rgb, flow, mask, rows, row_offset, b, draws, jitter, mean, std,
            out_size, dtype):
    global launches

    from ._build import load_kernels

    channels = 3 if flow is None else 5
    out = torch.empty((b, out_size, out_size, channels), dtype=dtype,
                      device=rgb.device)
    if b == 0:
        return out
    order, order_stride = None, 0
    if jitter:
        if 'perms' in draws:
            order, order_stride = draws['perms'], 4
        else:
            order = _order_table(rgb.device)[draws['order']]
    noise = draws.get('noise') if mask is not None else None
    n, h, w = rgb.shape[:3]
    lib = load_kernels()
    with torch.cuda.device(rgb.device):
        err = lib.vpd_train_augment(
            rgb.data_ptr(), _ptr(flow), 0 if flow is None else flow.shape[-1],
            _ptr(mask), _ptr(rows), n, int(row_offset),
            *(_ptr(draws[k]) if jitter else None for k in _JITTER),
            _ptr(order), order_stride, _ptr(noise),
            _ptr(draws['apply_noise']) if mask is not None else None,
            *(draws[k].data_ptr() for k in _CROP), draws['flip'].data_ptr(),
            out.data_ptr(), _DTYPE_CODES[dtype], b, h, w, out_size,
            *(float(m) for m in mean), *(1. / float(s) for s in std),
            torch.cuda.current_stream(rgb.device).cuda_stream)
    if err != 0:
        raise RuntimeError('train_augment kernel launch failed with CUDA '
                           'error {}'.format(err))
    launches += 1
    return out


def train_augment(pixels, draws, mean, std, rows=None, row_offset=0,
                  out_size=128, jitter=True, dtype=torch.float32):
    """The train-time augmentation of a batch of uint8 rows.

    pixels: {'rgb': (N, H, W, 3)[, 'flow': (N, H, W, >=2)][, 'mask': (N,
    H, W)]} uint8 (a missing or None stream is not used). rows: (B,) int32
    indices, the batch being rows `rows - row_offset` of the streams (the
    device crop cache's arrays, `data/hbm_cache.py`), or None: the streams
    are the batch. `draws` as `sample_train_augment` gives
    them for the B images, with their `flip` (B,) bool. mean, std: the 3
    channel statistics, as numbers. Returns (B, out_size, out_size, C) in
    `dtype`, C = 5 with flow and 3 without: `train_augment_batch` of the
    gathered rows.
    """
    rgb, flow, mask, b = _check_pixels(pixels, rows)
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        _bad('dtype must be a floating dtype, got {}'.format(dtype))
    if rgb.device.type == 'cpu':
        if rows is not None:
            idx = rows - row_offset if row_offset else rows
            rgb, flow, mask = (None if t is None else t.index_select(0, idx)
                               for t in (rgb, flow, mask))
        return train_augment_batch(rgb, draws, mean, std, flow_u8=flow,
                                   mask_u8=mask, out_size=out_size,
                                   jitter=jitter, dtype=dtype)
    _check_kernel_args(rgb, flow, mask, rows, b, draws, jitter, mean, std,
                       out_size, dtype)
    if rgb.device.type != 'cuda':
        _bad('no kernel for device {}'.format(rgb.device))
    return _launch(rgb, flow, mask, rows, row_offset, b, draws, jitter, mean,
                   std, out_size, dtype)
