"""The reader of `augment_roofline` on a synthetic trace summary: the
input kernel's byte bound over its mean time a traced step, None where
no such kernel ran (the parent's program) or nothing else is there to
read."""

import pytest

from vpdbench import bench
from vpdbench.tests.test_vpdbench_spans import Book, use
from vpdbench.tests.tiny import REPO

PEAKS = {'hbm_bytes_per_s': 3.35e12}
CONFIG = {'img_dim': 128, 'in_channels': 5, 'compute_dtype': 'bfloat16'}
# 2048 x 128 x 128 x (3 + 5 x 2) bytes at 3.35 TB/s
BOUND_US = 436207616 / 3.35e12 * 1e6


def readings(kernels, kind='train'):
    return {'kind': kind, 'peaks': PEAKS, 'config': CONFIG,
            'traffic': {'trace_epochs': 2, 'batch_size': 2048},
            'trace': {'kernels': kernels}}


def read(r):
    return bench.Spec(REPO).reader('augment_roofline')(r)


@pytest.fixture
def two_epochs(monkeypatch):
    book = Book()
    book.epoch(1, 5)  # older: not read
    book.epoch(2, 3, step0=5)
    book.epoch(3, 3, step0=8)
    use(monkeypatch, book)


def test_the_bound_over_the_mean_time_a_step(two_epochs):
    name = ('void (anonymous namespace)::train_augment_kernel<__nv_bfloat16,'
            ' __nv_bfloat16, 5>((anonymous namespace)::Params)')
    # 6 traced steps, one launch each, 1,000 us in all
    r = readings({name: [6, 1000.], 'sm90_xmma_fprop': [60, 5e4]})
    assert read(r) == pytest.approx(100. * BOUND_US / (1000. / 6))
    assert BOUND_US == pytest.approx(130.2, abs=0.05)


@pytest.mark.parametrize('case', ['parent', 'extract', 'no_trace',
                                  'no_peaks'])
def test_nothing_to_read(two_epochs, case):
    r = readings({'train_augment_kernel<float, float, 3>': [6, 900.]},
                 kind='extract' if case == 'extract' else 'train')
    if case == 'parent':  # the plain chain: no such kernel
        r['trace']['kernels'] = {'elementwise_kernel': [600, 1.5e4]}
    elif case == 'no_trace':
        r['trace'] = None
    elif case == 'no_peaks':
        r['peaks'] = None
    assert read(r) is None


def test_no_steps_to_read(monkeypatch):
    use(monkeypatch, Book())
    assert read(readings({'train_augment_kernel': [6, 900.]})) is None
