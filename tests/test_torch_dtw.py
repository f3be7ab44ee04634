"""The port's DTW against vpd_tpu's: host DP, the plain twin of kernel B2,
the kernel's wrapper on the CPU, and the all-pairs sweep.

Inputs are made with numpy from seeds and fed to both packages. Bars:
host DP rtol 1e-12 (the same f64 arithmetic); the twin against the JAX
row scan rtol 1e-4 / atol 1e-5 and against the Pallas kernel (interpret
mode) rtol 1e-4, with the same +inf pattern (both are f32 in the same
matmul form, summed in other orders); the twin against the f64 host DP
rtol 5e-3 (the JAX kernel's own bar); `batch_distances` equal to
`batch_distances_tpu` at rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from vpd_tpu.ops import dtw as jdtw
from vpd_tpu.ops.pallas.dtw_kernel import dtw_matrix_pallas
from vpd_tpu.tasks.neighbors import batch_distances_tpu
from vpd_tpu_torch.ops import dtw as tdtw
from vpd_tpu_torch.ops import dtw_kernel
from vpd_tpu_torch.tasks.neighbors import batch_distances

torch.set_num_threads(2)

PATTERNS = ['symmetricP2', 'symmetric2']


def padded(rng, n, L, D, lo=1):
    """n zero-padded sequences with lengths in [lo, L]; the first has
    length lo and the second L, so symmetricP2 cannot align them."""
    lens = rng.integers(lo, L + 1, n).astype(np.int32)
    lens[0], lens[1] = lo, L
    x = np.zeros((n, L, D), np.float32)
    for i, m in enumerate(lens):
        x[i, :m] = rng.normal(size=(m, D))
    return x, lens


def twin(q, ql, t, tl, sp):
    return tdtw.dtw_matrix_reference(
        torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(t),
        torch.from_numpy(tl), sp).numpy()


def assert_same(got, want, rtol, atol=0.):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


# --- host DP -----------------------------------------------------------------

HAND_CASES = [
    (np.array([[1., 2.], [3., 4.]]), 'symmetric2', 7 / 4),
    (np.array([[1., 2.], [3., 4.]]), 'symmetricP2', 9 / 4),
    (np.ones((2, 10)), 'symmetricP2', np.inf),
]


@pytest.mark.parametrize('d,sp,want', HAND_CASES)
def test_host_dp_hand_cases(d, sp, want):
    assert tdtw.dtw_distance(d, sp) == jdtw.dtw_distance(d, sp) == want
    assert tdtw.dtw_distance(d, sp, normalized=False) == \
        jdtw.dtw_distance(d, sp, normalized=False)


@pytest.mark.parametrize('sp', PATTERNS)
def test_host_dp_matches_vpd_tpu(sp):
    rng = np.random.default_rng(1)
    for _ in range(12):
        a = rng.normal(size=(int(rng.integers(1, 25)), 3))
        b = rng.normal(size=(int(rng.integers(1, 25)), 3))
        np.testing.assert_array_equal(tdtw.pairwise_l2(a, b),
                                      jdtw.pairwise_l2(a, b))
        got = tdtw.build_dtw_distance_fn(sp)(a, b)
        want = jdtw.build_dtw_distance_fn(sp, prefer_native=False)(a, b)
        if np.isinf(want):
            assert np.isinf(got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12)


# --- the twin-----------------------------------------------------------------

@pytest.mark.parametrize('sp', PATTERNS)
def test_twin_cell_by_cell_6x9(sp):
    """One 6 x 9 pair, every end cell (n', m') <= (6, 9) as its own pair,
    against the host DP's cost matrix: the boundaries of the recurrence."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(9, 4)).astype(np.float32)
    g = tdtw._PATTERNS[sp](tdtw.pairwise_l2(a, b))
    q = np.zeros((6, 9, 4), np.float32)
    t = np.zeros((9, 9, 4), np.float32)
    for n in range(1, 7):
        q[n - 1, :n] = a[:n]
    for m in range(1, 10):
        t[m - 1, :m] = b[:m]
    got = twin(q, np.arange(1, 7, dtype=np.int32), t,
               np.arange(1, 10, dtype=np.int32), sp)
    want = g / (np.arange(1, 7)[:, None] + np.arange(1, 10)[None, :])
    assert_same(got, want, rtol=1e-5)


@pytest.mark.parametrize('sp', PATTERNS)
@pytest.mark.parametrize('L', [32, 128])
def test_twin_matches_row_scan(sp, L):
    rng = np.random.default_rng(L)
    q, ql = padded(rng, 5, L, 6)
    t, tl = padded(rng, 7, L, 6)
    got = twin(q, ql, t, tl, sp)
    want = np.asarray(jdtw.dtw_distance_matrix_tpu(q, ql, t, tl, sp))
    if sp == 'symmetricP2':
        assert np.isinf(want[0, 1])
    assert_same(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('sp', PATTERNS)
def test_twin_matches_pallas_interpret(sp):
    rng = np.random.default_rng(11)
    q, ql = padded(rng, 3, 128, 8, lo=5)
    t, tl = padded(rng, 5, 128, 8, lo=5)
    want = dtw_matrix_pallas(q, ql, t, tl, sp, interpret=True)
    assert_same(twin(q, ql, t, tl, sp), want, rtol=1e-4)


@pytest.mark.parametrize('sp', PATTERNS)
def test_twin_matches_host_dp(sp):
    rng = np.random.default_rng(3)
    q, ql = padded(rng, 4, 48, 5)
    t, tl = padded(rng, 6, 48, 5)
    got = twin(q, ql, t, tl, sp)
    want = np.array([[jdtw.dtw_distance(jdtw.pairwise_l2(
        q[i, :ql[i]], t[j, :tl[j]]), sp) for j in range(6)]
        for i in range(4)])
    assert_same(got, want, rtol=5e-3)


# --- the kernel's wrapper on the CPU------------------------------------------

def test_wrapper_runs_the_twin_on_cpu():
    rng = np.random.default_rng(2)
    q, ql = padded(rng, 3, 16, 4)
    t, tl = padded(rng, 4, 16, 4)
    args = [torch.from_numpy(x) for x in (q, ql, t, tl)]
    before = dtw_kernel.launches
    got = dtw_kernel.dtw_matrix(*args, step_pattern='symmetric2')
    assert dtw_kernel.launches == before
    np.testing.assert_array_equal(got.numpy(), twin(q, ql, t, tl,
                                                    'symmetric2'))


@pytest.mark.parametrize('case,match', [
    ('f64', 'float32'), ('rank', r'\(N, L, D\)'), ('L', 'L = 513'),
    ('D', 'D = 129'), ('lens', 'q_lens'), ('pattern', 'step pattern'),
])
def test_wrapper_rejects(case, match):
    L, D = (513, 2) if case == 'L' else (8, 129 if case == 'D' else 2)
    q = torch.zeros((2, L, D))
    lens = torch.full((2,), L, dtype=torch.int32)
    q_lens = torch.full((2,), L + 1, dtype=torch.int32) \
        if case == 'lens' else lens
    sp = 'itakura' if case == 'pattern' else 'symmetricP2'
    if case == 'f64':
        q = q.double()
    if case == 'rank':
        q = q[0]
    with pytest.raises(ValueError, match=match):
        dtw_kernel.dtw_matrix(q, q_lens, torch.zeros((2, L, D)), lens, sp)


# --- the all-pairs sweep------------------------------------------------------

def _seqs(rng, n, lo, hi, D=5):
    return [rng.normal(size=(int(rng.integers(lo, hi)), D)).astype(
        np.float32) for _ in range(n)]


@pytest.mark.parametrize('sp', PATTERNS)
def test_batch_distances_matches_vpd_tpu(sp):
    rng = np.random.default_rng(4)
    qs, ts = _seqs(rng, 5, 3, 30), _seqs(rng, 9, 3, 30)
    got = batch_distances(qs, ts, max_len=32, step_pattern=sp,
                          device='cpu')
    want = batch_distances_tpu(qs, ts, max_len=32, step_pattern=sp)
    assert got.dtype == np.float32
    assert_same(got, want, rtol=1e-4, atol=1e-5)


def test_batch_distances_empty_and_zero_length():
    rng = np.random.default_rng(0)
    seqs = _seqs(rng, 3, 8, 9, D=3)
    for qs, ts in (([], seqs), (seqs, [])):
        got = batch_distances(qs, ts, device='cpu')
        assert got.shape == batch_distances_tpu(qs, ts).shape
    empty = np.zeros((0, 3), np.float32)
    got = batch_distances([seqs[0], empty], seqs + [empty], max_len=16,
                          device='cpu')
    want = batch_distances_tpu([seqs[0], empty], seqs + [empty],
                               max_len=16)
    assert np.isinf(got[1]).all() and np.isinf(got[:, 3]).all()
    assert_same(got, want, rtol=1e-4, atol=1e-5)


def test_batch_distances_truncates_and_logs():
    rng = np.random.default_rng(6)
    qs = _seqs(rng, 3, 10, 40)
    ts = _seqs(rng, 4, 10, 40)
    qs[1] = rng.normal(size=(45, 5)).astype(np.float32)
    messages = []
    got = batch_distances(qs, ts, max_len=20, device='cpu',
                          log=messages.append)
    want = batch_distances_tpu(qs, ts, max_len=20)
    assert_same(got, want, rtol=1e-4, atol=1e-5)
    n_cut = sum(len(s) > 20 for s in qs + ts)
    assert len(messages) == 1
    assert '{} of 7 sequences cut to max_len 20 (longest 45)'.format(
        n_cut) in messages[0]


def test_batch_distances_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: device=None means CUDA here')
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        batch_distances(_seqs(rng, 2, 3, 5), _seqs(rng, 2, 3, 5))
