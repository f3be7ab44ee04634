"""`ops/corr.corr_lookup`, RAFT's correlation lookup, on the CPU.

A CPU tensor takes the plain twin (vpd_tpu's separable hat-weight form,
`corr_lookup_reference`) and launches nothing, also through
`models/raft.corr_lookup` and a whole RAFT forward; arguments that
neither path takes raise, and the kernel's own conditions (float32,
contiguous levels, radius 3 or 4, at most 8 levels) are checked on
`meta` tensors, where no kernel runs either; the gradient the kernel's
output carries (`_Lookup`) is held to the twin's with the launch stood
in for by the twin. The kernel itself
is held to the twin on the card (`tests/test_torch_cuda.py`); the twin
is held to vpd_tpu's lookup in `tests/test_torch_raft.py`.
"""

import pytest
import torch

from vpd_tpu_torch.models import raft as traft
from vpd_tpu_torch.ops import corr as tcorr

torch.set_num_threads(2)


def _inputs(b=2, h=8, w=8, device='cpu', seed=0):
    gen = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn((b, h, w, 16), generator=gen) for _ in range(2))
    coords = traft.coords_grid(b, h, w) + 6 * (
        torch.rand((b, h, w, 2), generator=gen) - 0.5)
    pyramid = traft.corr_pyramid(f1, f2)
    return [p.to(device) for p in pyramid], coords.to(device)


@pytest.mark.parametrize('radius', [0, 3, 4])
def test_cpu_tensors_take_the_twin(radius):
    pyramid, coords = _inputs()
    before = tcorr.launches
    got = tcorr.corr_lookup(pyramid, coords, radius)
    assert torch.equal(got, tcorr.corr_lookup_reference(pyramid, coords,
                                                        radius))
    assert torch.equal(traft.corr_lookup(pyramid, coords, radius), got)
    assert got.shape == (2, 8, 8, 4 * (2 * radius + 1) ** 2)
    assert got.dtype == torch.float32
    assert tcorr.launches == before == 0


def test_a_cpu_forward_launches_nothing():
    model = traft.build_raft(small=True, seed=0)
    im = torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8)
    with torch.no_grad():
        flow = model(im, im.roll(2, dims=2), iters=2)
    assert flow.shape == (1, 64, 64, 2) and torch.isfinite(flow).all()
    assert tcorr.launches == 0


def test_the_twin_keeps_the_gradient():
    """On the CPU the lookup stays differentiable (RAFT's `train=True`)."""
    pyramid, coords = _inputs()
    pyramid = [p.requires_grad_() for p in pyramid]
    tcorr.corr_lookup(pyramid, coords, 4).square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in pyramid)


def _fault(case, pyramid, coords):
    """(pyramid, coords, radius) with one argument neither path takes."""
    radius = 4
    if case == 'coords_3d':
        coords = coords[0]
    elif case == 'coords_3_channels':
        coords = torch.cat([coords, coords[..., :1]], dim=-1)
    elif case == 'radius_negative':
        radius = -1
    elif case == 'radius_float':
        radius = 4.
    elif case == 'radius_bool':
        radius = True
    elif case == 'no_levels':
        pyramid = []
    elif case == 'level_2d':
        pyramid = pyramid[:1] + [pyramid[1][:, 0]] + pyramid[2:]
    elif case == 'level_other_n':
        pyramid = pyramid[:1] + [pyramid[1][1:]] + pyramid[2:]
    elif case == 'level_empty':
        pyramid = pyramid[:1] + [pyramid[1][:, :0]] + pyramid[2:]
    elif case == 'level_elsewhere':
        pyramid = pyramid[:1] + [pyramid[1].to('meta')] + pyramid[2:]
    return pyramid, coords, radius


FAULTS = {'coords_3d': 'coords must be', 'coords_3_channels': 'coords must be',
          'radius_negative': 'radius must be', 'radius_float': 'radius must be',
          'radius_bool': 'radius must be', 'no_levels': 'non-empty',
          'level_2d': 'level 1 must be', 'level_other_n': 'level 1 must be',
          'level_empty': 'level 1 must be', 'level_elsewhere': 'lies on'}


@pytest.mark.parametrize('case', sorted(FAULTS))
def test_arguments_neither_path_takes_raise(case):
    pyramid, coords, radius = _fault(case, *_inputs())
    with pytest.raises(ValueError, match=FAULTS[case]):
        tcorr.corr_lookup(pyramid, coords, radius)
    assert tcorr.launches == 0


KERNEL_FAULTS = {'float64': 'float32', 'bfloat16': 'float32',
                 'coords_float64': 'float32', 'strided_level': 'contiguous',
                 'radius_2': 'radius 3 or 4', 'radius_5': 'radius 3 or 4',
                 'nine_levels': 'at most 8 levels',
                 'pyramid_grad': 'no kernel for device meta',
                 'coords_grad': 'no kernel for device meta',
                 'fine': 'no kernel for device meta'}


@pytest.mark.parametrize('case', sorted(KERNEL_FAULTS))
def test_the_kernel_s_conditions_checked_on_meta_tensors(case):
    """What the kernel alone refuses, on `meta` tensors: each raises
    before the launch; inputs it takes, a pyramid or coordinates that
    require a gradient among them, reach the device check."""
    pyramid, coords = _inputs(device='meta')
    radius = 4
    if case in ('float64', 'bfloat16'):
        pyramid = [p.to(getattr(torch, case)) for p in pyramid]
    elif case == 'coords_float64':
        coords = coords.double()
    elif case == 'strided_level':
        pyramid[0] = pyramid[0].transpose(1, 2)
    elif case.startswith('radius_'):
        radius = int(case.split('_')[1])
    elif case == 'nine_levels':
        pyramid = pyramid + pyramid + pyramid[:1]
    elif case == 'pyramid_grad':
        pyramid = [p.requires_grad_() for p in pyramid]
    elif case == 'coords_grad':
        coords = coords.requires_grad_()
    with pytest.raises(ValueError, match=KERNEL_FAULTS[case]):
        tcorr.corr_lookup(pyramid, coords, radius)
    assert tcorr.launches == 0


def _twin_launch(pyramid, coords, radius):
    """`ops/corr._launch` stood in for by the twin, off autograd as the
    kernel is."""
    with torch.no_grad():
        return tcorr.corr_lookup_reference(pyramid, coords, radius)


@pytest.mark.parametrize('needs', ['pyramid', 'coords', 'both'])
def test_the_kernel_s_backward_is_the_twin_s(monkeypatch, needs):
    """`_Lookup`, which carries the kernel's output where autograd asks
    for a gradient on the card, with its launch stood in for by the
    twin: the gradients it returns are autograd's of the twin, and None
    for an input that asks for none."""
    monkeypatch.setattr(tcorr, '_launch', _twin_launch)
    outs = []
    for through_function in (True, False):
        pyramid, coords = _inputs(seed=1)
        if needs != 'coords':
            pyramid = [p.requires_grad_() for p in pyramid]
        if needs != 'pyramid':
            coords = coords.requires_grad_()
        if through_function:
            out = tcorr._Lookup.apply(4, coords, *pyramid)
            assert out.grad_fn is not None
        else:
            out = tcorr.corr_lookup_reference(pyramid, coords, 4)
        grad = torch.randn(out.shape, generator=torch.Generator(
        ).manual_seed(9))
        out.backward(grad)
        outs.append([coords.grad] + [p.grad for p in pyramid])
    for got, want in zip(*outs):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (outs[0][0] is None) == (needs == 'pyramid')
    assert (outs[0][1] is None) == (needs == 'coords')
