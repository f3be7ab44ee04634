"""Tests of the port that need an sm_90 CUDA card; they skip elsewhere.

This file imports torch and the port only (the GPU host has no JAX, and
`tests/conftest.py` imports it), so on the card run it as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernel B1 (`ops/preprocess`) is held against its plain twin on the card
at atol 0.02 (bf16 rounding), and its launch counter is checked.
"""

import numpy as np
import pytest
import torch

from vpd_tpu_torch.ops import preprocess as tpre

MEAN = (0.45, 0.47, 0.46)
STD = (0.13, 0.12, 0.12)
S = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip('the kernels are built for sm_90a')
    return torch.device('cuda')


def _f32(t):
    return t.cpu().to(torch.float32).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize('flow_c', [0, 3, 4])
@pytest.mark.parametrize('b', [1, 13, 64])
def test_preprocess_kernel_matches_twin(cuda_device, b, flow_c):
    rng = np.random.default_rng(b * 10 + flow_c)
    rgb = torch.from_numpy(rng.integers(0, 256, (b, S, S, 3), np.uint8))
    flow = (torch.from_numpy(rng.integers(0, 256, (b, S, S, flow_c),
                                          np.uint8)) if flow_c else None)
    flip = torch.from_numpy((rng.random(b) < 0.5).astype(np.int32))
    dev = lambda t: None if t is None else t.to(cuda_device)  # noqa: E731

    before = tpre.launches
    out = tpre.preprocess_crops(dev(rgb), dev(flow), dev(flip), MEAN, STD)
    pair = tpre.preprocess_orig_and_flip(dev(rgb), dev(flow), MEAN, STD)
    torch.cuda.synchronize()
    assert tpre.launches == before + 2
    assert out.dtype == pair.dtype == torch.bfloat16
    assert pair.shape == (2 * b, S, S, 5 if flow_c else 3)
    np.testing.assert_allclose(
        _f32(out), _f32(tpre.preprocess_crops_reference(
            rgb, flow, flip, MEAN, STD)), atol=0.02)
    np.testing.assert_allclose(
        _f32(pair), _f32(tpre.preprocess_orig_and_flip_reference(
            rgb, flow, MEAN, STD)), atol=0.02)


@pytest.mark.cuda
def test_preprocess_kernel_rejects_other_output_types(cuda_device):
    rgb = torch.zeros((2, S, S, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match='bfloat16'):
        tpre.preprocess_orig_and_flip(rgb, None, MEAN, STD,
                                      out_dtype=torch.float32)
