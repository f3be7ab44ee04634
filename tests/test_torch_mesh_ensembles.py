"""The port's stacked-member trainers with their members split over two
gloo ranks, against vpd_tpu.

- The fused few-shot sweep (float64, from vpd_tpu's initial weights,
  dropout 0; 3 members padded to 4, two a rank): every member's trees on
  every rank within the bar of tests/test_fused_sweep.py (rtol 2e-4, atol
  2e-5) of vpd_tpu's trainers of the same members, the bar at which
  vpd_tpu's tests hold its sharded sweep to them (that sweep keeps a
  float32 carry under x64, so it cannot run in float64 itself).
- The KFold proposal ensemble (one member a rank): `run_localization`'s
  AP tables equal vpd_tpu's on its 2-device mesh, the port's members
  starting from vpd_tpu's initial weights at dropout 0.
"""

import jax
import numpy as np
import torch

import torch_mesh_workers as W
from test_torch_detect import _jax_init
from test_torch_heads import _F64Init, pool
from vpd_tpu.core import mesh as jmesh
from vpd_tpu.tasks import detect as jdet
from vpd_tpu.train import classifier as jc
from vpd_tpu_torch.tasks import detect as tdet

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


def _plain(tree):
    """A flax tree as nested dicts of numpy arrays (a spawned rank must
    unpickle it without flax)."""
    if hasattr(tree, 'items'):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax_sequential_f64(monkeypatch, X, y, rows, Xv, yv, kwargs):
    """vpd_tpu's sequential trainers of the members in float64 (its
    sharded sweep keeps a float32 carry under x64, and vpd_tpu's own tests
    hold that sweep to these trainers at RTOL, ATOL): the shared initial
    variables and each member's trees."""
    jmake = _F64Init(jc.make_model)
    monkeypatch.setattr(jc, 'make_model', jmake)
    pad = jc.pad_sequences
    monkeypatch.setattr(jc, 'pad_sequences', lambda X, max_len=None: (
        lambda a: (a[0].astype(np.float64), a[1]))(pad(X, max_len)))
    members = []
    with jax.enable_x64():
        for r in rows:
            t = jc.SeqModelTrainer('gru', [X[i] for i in r], y[np.asarray(r)],
                                   X_val=Xv, y_val=yv, **kwargs)
            members.append(jax.tree_util.tree_map(
                np.asarray, (t.params, t.batch_stats)))
    return _plain(jmake.variables), members


def _close(got, want, path=()):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], path + (k,))
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=str(path + (k,)))


def test_fused_sweep_members_split_over_ranks(monkeypatch, tmp_path):
    X, y = pool(n=4, lo=5, hi=12)
    Xv, yv = pool(n=2, seed=1, lo=5, hi=12)
    rows = [list(range(12)), [0, 1, 4, 5, 8, 9], [0, 2, 4, 6, 8, 10]]
    kwargs = dict(hidden_dim=8, batch_size=4, num_epochs=4, min_epochs=0,
                  wr_count=2, val_freq=2, learning_rate=0.01,
                  early_term_val_num_epochs=200, depth=1, dropout=0.,
                  input_dropout=0., bucket_floor=16)
    init, want = _jax_sequential_f64(monkeypatch, X, y, rows, Xv, yv,
                                     kwargs)
    ranks = W.run_ranks(W.fused_sweep_dp, 2, tmp_path, init, X, y, rows, Xv,
                        yv, dict(kwargs, device='cpu'))
    # 3 members padded to 4: two a rank
    assert [r['local'] for r in ranks] == [2, 2]
    for r in ranks:
        for got, (params, stats) in zip(r['members'], want):
            _close(got[0], params)
            _close(got[1], stats)
    assert (ranks[0]['best_epoch'] == ranks[1]['best_epoch']).all()


def test_localization_members_split_over_ranks(tmp_path):
    rng = np.random.default_rng(0)
    emb, labels = {}, []
    for v in range(5):
        x = rng.normal(0, 0.3, size=(160, 2, 6))
        for start in range(30, 130, 50):
            x[start:start + 15] += 2.0
            labels.append(('vid{}'.format(v), 'action', start, start + 15,
                           25.0))
        emb['vid{}'.format(v)] = (x.astype(np.float32), np.ones(160, bool))
    kw = dict(n_trials=1, k=2, hidden_dim=8, batch_size=8,
              samples_per_epoch=32, seq_len=32, num_epochs=2, min_epochs=1,
              dropout=0., input_dropout=0.)

    def split(make):
        ls = [make(*l) for l in labels]
        return ([l for l in ls if l.video != 'vid4'],
                [l for l in ls if l.video == 'vid4'])

    want, thresholds = jdet.run_localization(
        'fs_jump', emb, *split(jdet.Label), mesh=jmesh.get_mesh(jax.devices()[:2]),
        log=lambda *a: None, **kw)
    inits = {s: _plain(_jax_init(s)) for s in (0, 1)}  # the folds' seeds
    ranks = W.run_ranks(W.localization_dp, 2, tmp_path, inits, emb,
                        *split(tdet.Label), kw)
    assert want[0].max() > 0
    for got, t in ranks:
        np.testing.assert_array_equal(t, thresholds)
        np.testing.assert_array_equal(got[0], want[0])
