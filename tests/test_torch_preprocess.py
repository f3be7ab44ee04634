"""Kernel B1 (fused crop preprocess): the port's twin and wrapper.

On the CPU the wrapper runs its plain twin, held here against vpd_tpu's
Pallas kernel (interpret mode) and against vpd_tpu's XLA transforms
(`eval_transform_batch` + `flip_batch`) at atol 0.02, the bf16-rounding
bar of `tests/test_pallas_preprocess.py`. The CUDA kernel itself is held
against the twin in `tests/test_torch_cuda.py`, which imports no JAX so
that it runs on the GPU host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpd_tpu.data.augment import eval_transform_batch, flip_batch
from vpd_tpu.ops.pallas.preprocess import preprocess_crops_pallas
from vpd_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(2)

MEAN = (0.45, 0.47, 0.46)
STD = (0.13, 0.12, 0.12)
S = 32


def _inputs(b, seed, flow_c=3):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    flow = rng.integers(0, 256, (b, S, S, flow_c), dtype=np.uint8)
    flip = (rng.random(b) < 0.5).astype(np.int32)
    return rgb, flow, flip


def _xla(rgb, flow, flip):
    x = np.asarray(eval_transform_batch(rgb, MEAN, STD, flow_u8=flow))
    xf = np.asarray(flip_batch(jnp.asarray(x), flow is not None))
    return np.where(flip.reshape(-1, 1, 1, 1).astype(bool), xf, x)


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize('b', [5, 13, 16])
@pytest.mark.parametrize('use_flow', [True, False])
def test_twin_matches_pallas_and_xla(b, use_flow):
    rgb, flow, flip = _inputs(b, seed=b)
    flow = flow if use_flow else None
    out = tpre.preprocess_crops(
        torch.from_numpy(rgb),
        None if flow is None else torch.from_numpy(flow),
        torch.from_numpy(flip), MEAN, STD)
    assert out.dtype == torch.bfloat16
    assert out.shape == (b, S, S, 5 if use_flow else 3)
    pallas = np.asarray(preprocess_crops_pallas(
        rgb, flow, jnp.asarray(flip), MEAN, STD, interpret=True)
    ).astype(np.float32)
    np.testing.assert_allclose(_f32(out), pallas, atol=0.02)
    np.testing.assert_allclose(_f32(out), _xla(rgb, flow, flip), atol=0.02)


def test_twin_reads_two_channels_of_a_wider_flow_buffer():
    rgb, flow4, flip = _inputs(6, seed=1, flow_c=4)
    out = tpre.preprocess_crops(torch.from_numpy(rgb),
                                torch.from_numpy(flow4),
                                torch.from_numpy(flip), MEAN, STD)
    np.testing.assert_allclose(_f32(out), _xla(rgb, flow4[..., :3], flip),
                               atol=0.02)


@pytest.mark.parametrize('use_flow', [True, False])
def test_pair_mode_matches_two_pallas_calls(use_flow):
    b = 7
    rgb, flow, _ = _inputs(b, seed=2)
    flow = flow if use_flow else None
    out = tpre.preprocess_orig_and_flip(
        torch.from_numpy(rgb),
        None if flow is None else torch.from_numpy(flow), MEAN, STD)
    assert out.shape == (2 * b, S, S, 5 if use_flow else 3)
    for half, flip_all in ((out[:b], 0), (out[b:], 1)):
        ref = np.asarray(preprocess_crops_pallas(
            rgb, flow, jnp.full((b,), flip_all, jnp.int32), MEAN, STD,
            interpret=True)).astype(np.float32)
        np.testing.assert_allclose(_f32(half), ref, atol=0.02)


def test_twin_output_dtype_follows_out_dtype():
    rgb, flow, flip = _inputs(3, seed=3)
    out = tpre.preprocess_crops(torch.from_numpy(rgb),
                                torch.from_numpy(flow),
                                torch.from_numpy(flip), MEAN, STD,
                                out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _xla(rgb, flow, flip),
                               atol=1e-6)


def test_cpu_calls_count_no_launches():
    rgb, flow, flip = _inputs(2, seed=4)
    before, variants = tpre.launches, dict(tpre.variant_launches)
    tpre.preprocess_orig_and_flip(torch.from_numpy(rgb),
                                  torch.from_numpy(flow), MEAN, STD)
    assert tpre.launches == before
    assert tpre.variant_launches == variants


def _shifted(x, offset):
    """x copied into a contiguous view `offset` bytes into its buffer."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype)
    return buf[offset:].view(x.shape).copy_(x)


@pytest.mark.parametrize('w,flow_c,view,want', [
    (128, 3, None, 'vector'),          # the extraction shape
    (128, 0, None, 'vector'),          # RGB only
    (128, 2, None, 'vector'),
    (128, 4, None, 'vector'),
    (32, 3, None, 'vector'),
    (1024, 3, None, 'vector'),         # VECTOR_MAX_WIDTH
    (1040, 3, None, 'general'),        # wider than a block's staging
    (20, 3, None, 'general'),          # W not a multiple of 16
    (7, 0, None, 'general'),
    (128, 5, None, 'general'),         # more than 4 flow channels
    (128, 3, 'rgb_offset8', 'general'),
    (128, 3, 'flow_offset8', 'general'),
    (128, 3, 'drop_first', 'vector'),  # x[1:]: offset 128*128*3 bytes
    (16, 3, 'drop_first', 'vector'),
    (7, 3, 'drop_first', 'general'),   # offset 147 bytes at an odd H*W
])
def test_kernel_variant_follows_shape_and_alignment(w, flow_c, view, want):
    """Which kernel variant a CUDA call of these inputs would launch: the
    16-byte vector one needs W % 16 == 0, W <= 1024, flow_c <= 4 and
    16-byte aligned rgb and flow."""
    b, h = 3, 8
    rgb = torch.zeros((b + 1, h, w, 3), dtype=torch.uint8)
    flow = (torch.zeros((b + 1, h, w, flow_c), dtype=torch.uint8)
            if flow_c else None)
    if view == 'drop_first':
        rgb, flow = rgb[1:], None if flow is None else flow[1:]
    elif view == 'rgb_offset8':
        rgb = _shifted(rgb, 8)
    elif view == 'flow_offset8':
        flow = _shifted(flow, 8)
    assert rgb.data_ptr() % 16 == 0 or view is not None
    assert tpre.kernel_variant(rgb, flow) == want


@pytest.mark.parametrize('bad', [
    'rgb_dtype', 'rgb_shape', 'rgb_channels', 'flow_shape', 'flow_dtype',
    'flow_channels', 'flip_shape', 'flip_float', 'noncontiguous',
    'mean_len'])
def test_wrapper_rejects_bad_inputs(bad):
    rgb, flow, flip = (torch.from_numpy(a) for a in _inputs(4, seed=5))
    mean = MEAN
    if bad == 'rgb_dtype':
        rgb = rgb.float()
    elif bad == 'rgb_shape':
        rgb = rgb[0]
    elif bad == 'rgb_channels':
        rgb = torch.cat([rgb, rgb[..., :1]], -1)
    elif bad == 'flow_shape':
        flow = flow[:3]
    elif bad == 'flow_dtype':
        flow = flow.to(torch.int16)
    elif bad == 'flow_channels':
        flow = flow[..., :1].contiguous()
    elif bad == 'flip_shape':
        flip = flip[:2]
    elif bad == 'flip_float':
        flip = flip.float()
    elif bad == 'noncontiguous':
        rgb = rgb.transpose(1, 2)
    elif bad == 'mean_len':
        mean = MEAN[:2]
    with pytest.raises(ValueError):
        tpre.preprocess_crops(rgb, flow, flip, mean, STD)
