"""The port's native host DTW core against the numpy DP and vpd_tpu's
core, on the CPU.

- `ops/dtw_native` builds the unchanged `native/dtw_core.cpp` with g++
  into `vpd_tpu_torch/_build/host/libvpddtw.so` and writes nothing under
  `native/`.
- Native equals the numpy DP for both step patterns: rtol 1e-12 from a
  cost matrix, 1e-9 from sequences (its fused L2 rounds apart from
  `pairwise_l2`), vpd_tpu's bars (`tests/test_dtw_native.py`); it equals
  vpd_tpu's own native core exactly; infeasible pairs and empty
  sequences give inf.
- `build_dtw_distance_fn` returns the native core by default and says
  so in `impl`; `prefer_native=False`, or a core that does not build,
  gives the numpy DP (`impl == 'numpy'`).
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from vpd_tpu.ops import dtw as jdtw
from vpd_tpu.ops import dtw_native as jnative
from vpd_tpu_torch.ops import _build
from vpd_tpu_torch.ops import dtw as tdtw
from vpd_tpu_torch.ops import dtw_native as tnative

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERNS = ('symmetric2', 'symmetricP2')


def _native_sources():
    """{name: (sha256, mtime)} of the C++ sources under native/ (the JAX
    package's; its own libraries there are built by vpd_tpu, perhaps by
    another test worker meanwhile, so only the sources are compared)."""
    state = {}
    for name in sorted(os.listdir(os.path.join(REPO, 'native'))):
        if name.endswith('.cpp'):
            path = os.path.join(REPO, 'native', name)
            with open(path, 'rb') as fp:
                state[name] = (hashlib.sha256(fp.read()).hexdigest(),
                               os.path.getmtime(path))
    return state


@pytest.fixture(scope='module')
def native():
    if not tnative.available():
        pytest.skip('g++ cannot build native/dtw_core.cpp on this host')
    return tnative


def test_builds_into_the_port_build_dir(native, tmp_path):
    before = _native_sources()
    assert 'dtw_core.cpp' in before
    lib = str(tmp_path / 'host' / 'libvpddtw.so')
    _build.build_locked(native.SRC, lib)
    assert os.path.getsize(lib) > 0
    assert sorted(os.listdir(tmp_path / 'host')) == ['libvpddtw.so',
                                                     'libvpddtw.so.lock']
    # everything the build writes sits beside LIB_PATH, never in native/
    assert native.LIB_PATH == os.path.join(str(_build.BUILD_DIR), 'host',
                                           'libvpddtw.so')
    assert os.path.isfile(native.LIB_PATH)
    assert native.SRC == os.path.join(REPO, 'native', 'dtw_core.cpp')
    assert _native_sources() == before


@pytest.mark.parametrize('sp', PATTERNS)
def test_native_matches_numpy_and_vpd_tpu(native, sp):
    rng = np.random.default_rng(0)
    infeasible = 0
    for _ in range(40):
        a = rng.normal(size=(int(rng.integers(1, 40)), 5))
        b = rng.normal(size=(int(rng.integers(1, 40)), 5))
        d = tdtw.pairwise_l2(a, b)
        want = tdtw.dtw_distance(d, sp)
        from_costs = native.dtw_distance_native(d, sp)
        from_seqs = native.dtw_seq_distance_native(a, b, sp)
        assert from_costs == jnative.dtw_distance_native(d, sp)
        assert from_seqs == jnative.dtw_seq_distance_native(a, b, sp)
        assert native.dtw_distance_native(d, sp, normalized=False) == \
            jnative.dtw_distance_native(d, sp, normalized=False)
        if np.isinf(want):
            infeasible += 1
            assert np.isinf(from_costs) and np.isinf(from_seqs)
        else:
            np.testing.assert_allclose(from_costs, want, rtol=1e-12)
            np.testing.assert_allclose(from_seqs, want, rtol=1e-9)
    assert infeasible > 0 if sp == 'symmetricP2' else infeasible == 0


def test_infeasible_and_empty(native):
    assert np.isinf(native.dtw_distance_native(np.ones((2, 10)),
                                               'symmetricP2'))
    assert np.isinf(tdtw.dtw_distance(np.ones((2, 10)), 'symmetricP2'))
    empty = np.zeros((0, 3))
    assert np.isinf(native.dtw_seq_distance_native(empty, np.ones((4, 3))))
    with pytest.raises(ValueError):
        native.dtw_seq_distance_native(np.ones((4, 3)), np.ones((4, 2)))
    with pytest.raises(ValueError):
        native.dtw_distance_native(np.ones(4))


@pytest.mark.parametrize('sp', PATTERNS)
def test_default_fn_is_native(native, sp):
    fn = tdtw.build_dtw_distance_fn(sp)
    assert fn.impl == 'native' and fn.fork_safe
    dp = tdtw.build_dtw_distance_fn(sp, prefer_native=False)
    assert dp.impl == 'numpy' and dp.fork_safe
    rng = np.random.default_rng(1)
    a = rng.normal(size=(10, 3))
    assert fn(a, a) < 1e-6
    for _ in range(10):
        a = rng.normal(size=(int(rng.integers(5, 30)), 4))
        b = rng.normal(size=(int(rng.integers(5, 30)), 4))
        want = dp(a, b)
        assert fn(a, b) == jdtw.build_dtw_distance_fn(sp)(a, b)
        if np.isinf(want):
            assert np.isinf(fn(a, b))
        else:
            np.testing.assert_allclose(fn(a, b), want, rtol=1e-9)


def test_numpy_where_the_core_does_not_build(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, '_lib', None)
    monkeypatch.setattr(tnative, '_lib_failed', False)
    monkeypatch.setattr(tnative, 'SRC', str(tmp_path / 'dtw_core.cpp'))
    (tmp_path / 'dtw_core.cpp').write_text('not C++\n')
    monkeypatch.setattr(tnative, 'LIB_PATH', str(tmp_path / 'libvpddtw.so'))
    assert not tnative.available()
    fn = tdtw.build_dtw_distance_fn('symmetric2')
    assert fn.impl == 'numpy'
    a = np.arange(12.).reshape(4, 3)
    assert fn(a, a) == 0.
    with pytest.raises(RuntimeError):
        tnative.dtw_distance_native(np.ones((2, 2)))
