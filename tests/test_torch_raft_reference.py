"""The port's RAFT basic against the benchmark's plain reference
(`vpdbench/reference/raft.py`, written from the published princeton-vl
code), on the CPU in float32, with the benchmark's seeded weights.

- The reference's parameter and statistic names and shapes are the
  port's state_dict's.
- The whole forward at 64 x 64 on 2 pairs after 1, 3 and 20 iterations,
  to float32 rounding.
- Part by part: the separable hat-weight lookup against `grid_sample`
  (the official bilinear sampler, taps in meshgrid(dy, dx) order, a
  1-pixel level included) and the convex upsampling against `unfold`.
- The quantization: the same float flow gives the same bytes, and the
  whole chain's payloads agree.
- The spans: under a profiler, one chunk of `compute_flow`'s card half
  records `vpd.flow.encode`, `corr` and `upsample` once and `iters`
  lookup and update spans, ids 0 to iters - 1, under `vpd.flow.chunk`.
"""

import json
import os

import numpy as np
import pytest
import torch

from vpd_tpu_torch.core import profiling
from vpd_tpu_torch.models import raft
from vpd_tpu_torch.ops.flow import make_quantized_flow_fn, \
    quantize_flow_device
from vpd_tpu_torch.tools.compute_flow import make_flow_compute
from vpdbench.drivers.flow import SCALED, seeded_pairs
from vpdbench.reference import raft as ref
from vpdbench.reference.arith import Arith
from vpdbench.weights import load, make

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 20


def config():
    with open(os.path.join(REPO, 'vpdbench', 'configs',
                           'raft-basic-128.json')) as fp:
        return json.load(fp)


def weights(seed=SEED):
    c = config()
    params, stats = ref.shapes(c)
    p = make(params, seed, 'cpu')
    for k in SCALED:
        p[k] = p[k] * c['flow_head_scale']
    return p, make(stats, seed, 'cpu', tag='stats')


@pytest.fixture(scope='module')
def model():
    m = raft.build_raft()
    load(m, *weights())
    return m


def pairs(n=2, size=64, i=0):
    return seeded_pairs(SEED, i, n, size, 4, 'cpu')


def test_the_reference_names_the_port_s_state():
    params, stats = ref.shapes(config())
    m = raft.build_raft()
    assert params == {k: tuple(v.shape) for k, v in m.named_parameters()}
    assert stats == {k: tuple(v.shape) for k, v in m.named_buffers()}
    assert sum(np.prod(s) for s in params.values()) == 5257536


@pytest.mark.parametrize('iters', [1, 3, 20])
def test_the_port_computes_the_reference_s_flow(model, iters):
    a, b = pairs()
    p, s = weights()
    with torch.inference_mode():
        got = model(a, b, iters=iters)
    want = ref.forward(p, s, a, b, config(), Arith(), iters=iters)
    assert got.shape == want.shape == (2, 64, 64, 2)
    scale = float(want.abs().max())
    assert scale > 0.05 * iters
    assert float((got - want).abs().max()) <= 2e-6 * max(scale, 1.) * iters


@pytest.mark.parametrize('size', [64, 128])
def test_the_lookup_is_the_official_bilinear_sampler(size):
    """Random features, fractional coordinates reaching past the border:
    the port's two products a level against `grid_sample`; at 64 px the
    coarsest level is one pixel wide."""
    gen = torch.Generator().manual_seed(size)
    g = size // 8
    f1, f2 = (torch.randn((2, 256, g, g), generator=gen) for _ in range(2))
    coords = raft.coords_grid(2, g, g) + 12 * (
        torch.rand((2, g, g, 2), generator=gen) - 0.5)
    got = raft.corr_lookup(raft.corr_pyramid(
        f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1)), coords, 4)
    want = ref.lookup(ref.corr_pyramid(f1, f2, 4),
                      coords.permute(0, 3, 1, 2), 4)
    assert got.shape == (2, g, g, 4 * 81)
    assert torch.allclose(got, want.permute(0, 2, 3, 1), atol=2e-5,
                          rtol=1e-5)
    # the taps are x-offset-major, k = 9 (dx + 4) + (dy + 4): a peak one
    # pixel below the centre is tap 41 (y-major taps would put it at 49)
    level = torch.zeros((1, 9, 9))
    level[0, 5, 4] = 1.
    centre = torch.full((1, 1, 1, 2), 4.)
    assert int(raft.corr_lookup([level], centre, 4).argmax()) == 41
    assert int(ref.lookup([level[:, None]], centre.permute(0, 3, 1, 2),
                          4).argmax()) == 41


def test_the_convex_upsampling_is_the_official_unfold():
    gen = torch.Generator().manual_seed(3)
    flow = torch.randn((2, 2, 8, 6), generator=gen) * 3
    mask = torch.randn((2, 576, 8, 6), generator=gen)
    got = raft.upsample_flow_convex(flow.permute(0, 2, 3, 1),
                                    mask.permute(0, 2, 3, 1))
    want = ref.upsample(flow, mask).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 64, 48, 2)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-6)


def test_the_quantization_gives_the_reference_s_bytes():
    gen = torch.Generator().manual_seed(4)
    flow = torch.randn((3, 16, 16, 2), generator=gen) * 15
    flow[0, 0, 0] = torch.tensor([20., -20.])
    flow[0, 0, 1] = torch.tensor([40., -40.])
    assert torch.equal(quantize_flow_device(flow, clip=20),
                       ref.quantize(flow, 20))


def test_the_payloads_are_the_reference_s(model):
    """The program's payloads (`make_quantized_flow_fn` over the forward)
    against the reference's at 20 iterations: within a step everywhere
    and equal almost everywhere (a last-bit difference can cross a
    truncation boundary)."""
    a, b = pairs(n=2, i=1)
    p, s = weights()
    got = make_quantized_flow_fn(raft.raft_flow_fn(model, iters=20))(a, b)
    want = ref.quantize(ref.forward(p, s, a, b, config(), Arith()), 20)
    assert got.dtype == want.dtype == torch.uint8
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999


def test_a_chunk_records_its_spans(model):
    from torch.profiler import ProfilerActivity, profile

    iters = 3
    compute = make_flow_compute(make_quantized_flow_fn(
        raft.raft_flow_fn(model, iters=iters)), 'cpu')
    profiling.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            q, done = compute(list(pairs()))
        recs = profiling.span_records().records
    finally:
        profiling.clear_spans()
    assert q.shape == (2, 64, 64, 2) and done is None
    chunk, = [r for r in recs if r['name'] == 'vpd.flow.chunk']
    assert chunk['ids'] == {} and chunk['parent'] is None
    inside = [r for r in recs if r is not chunk]
    assert all(r['parent'] == chunk['id'] for r in inside)
    names = [r['name'] for r in inside]
    for name in ('vpd.flow.encode', 'vpd.flow.corr', 'vpd.flow.upsample'):
        assert names.count(name) == 1
    for name in ('vpd.flow.lookup', 'vpd.flow.update'):
        assert [r['ids']['iter'] for r in inside if r['name'] == name] == \
            list(range(iters))
    assert len(inside) == 3 + 2 * iters
    # off the profiler nothing is recorded
    compute(list(pairs()))
    assert profiling.span_records().records == []
