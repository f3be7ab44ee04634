"""`ops/augment.train_augment`, the train step's input stage, on the CPU.

A CPU tensor takes the plain path (the rows gathered by `index_select`,
then `data/augment.train_augment_batch`) and launches nothing; inputs the
plain path or the kernel cannot take raise, the kernel's own conditions
checked on `meta` tensors (no kernel runs there either). The kernel
itself is held to this path on the card (`tests/test_torch_cuda.py`).
"""

import numpy as np
import pytest
import torch

from vpd_tpu_torch.data.augment import (RGB_MEAN_STD, sample_train_augment,
                                        train_augment_batch)
from vpd_tpu_torch.ops import augment as taug_op

torch.set_num_threads(2)

MEAN, STD = RGB_MEAN_STD['fs']
N, B, S = 9, 4, 16


def _streams(seed, n=N, s=S, flow_c=3):
    rng = np.random.default_rng(seed)
    return {'rgb': torch.from_numpy(rng.integers(0, 256, (n, s, s, 3),
                                                 dtype=np.uint8)),
            'flow': torch.from_numpy(rng.integers(0, 256, (n, s, s, flow_c),
                                                  dtype=np.uint8)),
            'mask': torch.from_numpy(((rng.random((n, s, s)) > 0.5) * 255)
                                     .astype(np.uint8))}


def _draws(b=B, s=S, mask=True, jitter=True, per_sample=False,
           noise_dtype=torch.float32, device='cpu'):
    gen = torch.Generator().manual_seed(3)
    d = sample_train_augment(gen, torch.Generator().manual_seed(3), b, s, s,
                             jitter=jitter, per_sample_order=per_sample,
                             mask=mask, flip=True, noise_dtype=noise_dtype)
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in d.items()}


@pytest.mark.parametrize('rows,row_offset', [
    (None, 0), ('int32', 0), ('int32', 5)])
@pytest.mark.parametrize('flow,mask,jitter,per_sample', [
    (True, True, True, False), (True, True, True, True),
    (False, False, True, False), (True, True, False, False)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_path(rows, row_offset, flow, mask, jitter,
                                  per_sample, dtype):
    """The gathered rows through `train_augment_batch`, bit for bit, and
    no kernel launch."""
    streams = _streams(0)
    draws = _draws(mask=mask, jitter=jitter, per_sample=per_sample,
                   noise_dtype=dtype)
    pixels = {'rgb': streams['rgb'],
              'flow': streams['flow'] if flow else None,
              'mask': streams['mask'] if mask else None}
    if rows is None:
        idx = torch.arange(B)
        pixels = {k: None if v is None else v[:B] for k, v in pixels.items()}
        idx_arg = None
    else:
        idx = torch.tensor([7, 2, 2, 0]) + row_offset
        idx_arg = idx.to(getattr(torch, rows))
        idx = idx - row_offset
    before = taug_op.launches
    got = taug_op.train_augment(pixels, draws, MEAN, STD, rows=idx_arg,
                                row_offset=row_offset, out_size=12,
                                jitter=jitter, dtype=dtype)
    src = pixels if rows is None else {
        k: None if v is None else v[idx] for k, v in pixels.items()}
    want = train_augment_batch(src['rgb'], draws, MEAN, STD,
                               flow_u8=src['flow'], mask_u8=src['mask'],
                               out_size=12, jitter=jitter, dtype=dtype)
    assert got.shape == (B, 12, 12, 5 if flow else 3) and got.dtype == dtype
    assert torch.equal(got, want)
    assert taug_op.launches == before


def _bad_pixels():
    s = _streams(1)
    yield 'uint8', {**s, 'rgb': s['rgb'].float()}, None
    yield r'\(N, H, W, 3\)', {**s, 'rgb': s['rgb'][..., :2]}, None
    yield 'flow must be a uint8', {**s, 'flow': s['flow'].short()}, None
    yield 'flow must be', {**s, 'flow': s['flow'][..., :1]}, None
    yield 'mask must be', {**s, 'mask': s['mask'][:, :8]}, None
    yield 'flow lies on', {**s, 'flow': torch.empty(
        s['flow'].shape, dtype=torch.uint8, device='meta')}, None
    yield 'rows must be', s, torch.zeros(B)
    yield 'rows must be', s, torch.zeros(B, dtype=torch.int64)
    yield 'rows must be', s, torch.zeros((B, 1), dtype=torch.int32)
    yield 'rows lie on', s, torch.zeros(B, dtype=torch.int32, device='meta')


@pytest.mark.parametrize('case', range(10))
def test_bad_streams_and_rows_raise(case):
    match, pixels, rows = list(_bad_pixels())[case]
    with pytest.raises(ValueError, match=match):
        taug_op.train_augment(pixels, _draws(), MEAN, STD, rows=rows)


def test_an_output_dtype_that_is_not_floating_raises():
    with pytest.raises(ValueError, match='floating'):
        taug_op.train_augment(_streams(1), _draws(), MEAN, STD,
                              rows=torch.arange(B, dtype=torch.int32),
                              dtype=torch.int32)


def _meta_case(**change):
    """Well-formed inputs on `meta`, one part changed: (pixels, draws,
    rows, keyword arguments)."""
    meta = torch.device('meta')
    pixels = {'rgb': torch.empty((N, S, S, 3), dtype=torch.uint8,
                                 device=meta),
              'flow': torch.empty((N, S, S, 3), dtype=torch.uint8,
                                  device=meta),
              'mask': torch.empty((N, S, S), dtype=torch.uint8, device=meta)}
    draws = {k: torch.empty(B, device=meta)
             for k in ('fb', 'fc', 'fs', 'fh', 'top', 'left', 'crop_h',
                       'crop_w')}
    draws.update(order=3, noise=torch.empty((B, S, S, 3),
                                            dtype=torch.bfloat16,
                                            device=meta),
                 apply_noise=torch.empty(B, dtype=torch.bool, device=meta),
                 flip=torch.empty(B, dtype=torch.bool, device=meta))
    rows = torch.empty(B, dtype=torch.int32, device=meta)
    kw = {'dtype': torch.bfloat16, 'out_size': 12}
    for key, value in change.items():
        if key in pixels:
            pixels[key] = value
        elif key in kw:
            kw[key] = value
        elif key == 'rows':
            rows = value
        elif value is None:
            del draws[key]
        else:
            draws[key] = value
    return pixels, draws, rows, kw


META = torch.device('meta')
KERNEL_CASES = [
    ('no kernel for device meta', {}),
    ('bfloat16, float32 or float64', {'dtype': torch.float16}),
    ('bfloat16, float32 or float64', {'dtype': torch.float8_e4m3fn}),
    ('out_size', {'out_size': 0}),
    ('rgb must be contiguous', {'rgb': torch.empty(
        (N, S, 2 * S, 3), dtype=torch.uint8, device=META)[:, :, ::2]}),
    (r'draws\["fb"\] must be', {'fb': torch.empty(B, dtype=torch.float64,
                                                    device=META)}),
    (r'draws\["top"\] must be', {'top': torch.empty(B + 1, device=META)}),
    (r'draws\["flip"\] must be', {'flip': torch.empty(B, device=META)}),
    (r'draws\["noise"\] must be', {'noise': torch.empty((B, S, S, 2),
                                                         device=META)}),
    (r'draws\["noise"\] must be', {'noise': torch.empty(
        (B, S, S, 3), dtype=torch.float16, device=META)}),
    (r'draws\["noise"\] must be', {'noise': torch.empty(
        (B, S, S, 3), dtype=torch.float32, device=META)}),
    (r'draws\["apply_noise"\] is missing', {'apply_noise': None}),
    (r'draws\["perms"\] or an int', {'order': None}),
    (r'draws\["perms"\] or an int', {'order': 24}),
    (r'draws\["perms"\] must be', {'perms': torch.empty((B, 4),
                                                         dtype=torch.int32,
                                                         device=META)}),
    (r'draws\["fh"\] lies on', {'fh': torch.zeros(B)}),
]


@pytest.mark.parametrize('match,change', KERNEL_CASES,
                         ids=[str(i) for i in range(len(KERNEL_CASES))])
def test_what_the_kernel_does_not_take_raises(match, change):
    """The kernel's conditions, checked before any launch; well-formed
    inputs on a device with no kernel raise for that alone."""
    pixels, draws, rows, kw = _meta_case(**change)
    with pytest.raises(ValueError, match=match):
        taug_op.train_augment(pixels, draws, MEAN, STD, rows=rows, **kw)
