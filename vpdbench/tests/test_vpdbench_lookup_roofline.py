"""The reader of `lookup_roofline` on a synthetic trace summary: the
lookup kernel's byte bound over its mean time a launch, None where no
such kernel ran (the parent's batched products) or nothing else is there
to read."""

import pytest

from vpdbench import bench
from vpdbench.tests.tiny import REPO

PEAKS = {'hbm_bytes_per_s': 3.35e12}
CONFIG = {'img_dim': 128, 'corr_levels': 4, 'corr_radius': 4}
# 65,536 queries x (100 + 64 + 16 + 4 window cells + 2 coordinates + 324
# taps) x 4 B
BOUND_US = 65536 * 510 * 4 / 3.35e12 * 1e6
KERNEL = ('void (anonymous namespace)::corr_lookup_kernel<4>((anonymous '
          'namespace)::Params)')


def readings(kernels, kind='flow'):
    return {'kind': kind, 'peaks': PEAKS, 'config': CONFIG,
            'traffic': {'chunk': 256, 'trace_chunks': 8},
            'trace': {'kernels': kernels}}


def read(r):
    return bench.Spec(REPO).reader('lookup_roofline')(r)


def test_the_bound_over_the_mean_time_a_launch():
    # 8 traced chunks x 20 lookups, 80 us each
    r = readings({KERNEL: [160, 160 * 80.], 'sm90_xmma_fprop': [900, 4e4]})
    assert read(r) == pytest.approx(100. * BOUND_US / 80.)
    assert BOUND_US == pytest.approx(39.9, abs=0.05)


def test_the_bytes_of_a_lookup():
    least = bench.Spec(REPO).reader('lookup_roofline').__globals__[
        'least_bytes']
    assert least(256, 128, 4, 4) == 133693440
    # raft-small's 8 x 8 windows on the cell's maps: 64 + 64 + 16 + 4
    assert least(256, 128, 4, 3) == 4 * 65536 * (148 + 2 + 4 * 49)
    # a 64-px input, maps of 8, 4, 2 and 1 cells a side, inside the window
    assert least(2, 64, 4, 3) == 4 * 128 * (85 + 2 + 4 * 49)


@pytest.mark.parametrize('case', ['parent', 'extract', 'no_trace',
                                  'no_peaks'])
def test_nothing_to_read(case):
    r = readings({KERNEL: [160, 1.3e4]},
                 kind='extract' if case == 'extract' else 'flow')
    if case == 'parent':  # the batched products: no such kernel
        r['trace']['kernels'] = {
            'sm80_xmma_gemm_f32f32_f32f32_f32_tt_n': [640, 9.2e4],
            'void_gemmSN_TN_kernel': [640, 5.0e4]}
    elif case == 'no_trace':
        r['trace'] = None
    elif case == 'no_peaks':
        r['peaks'] = None
    assert read(r) is None
