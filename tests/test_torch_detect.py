"""The port's temporal detection against vpd_tpu's, on the CPU.

- `get_proposals`, fuzzed against vpd_tpu's: the same proposals.
- `_WindowSampler` batches byte-equal to vpd_tpu's.
- `ProposalTrainer` in float64 against vpd_tpu's under `jax.enable_x64`
  (two epochs with validation, dropout 0): per-epoch train and val loss
  sums to rel 1e-9, parameters and batch statistics to 1e-7 of how far
  they moved. vpd_tpu's module is fed float64 weights and its sampler
  float64 windows (flax keeps Dense kernels in float32 otherwise); vpd_tpu
  itself is unchanged.
- The fused ensemble equals sequential members in the port (rtol 2e-4,
  atol 2e-5), also when members stop at different epochs.
- `run_localization`'s AP tables equal vpd_tpu's on a tiny synthetic
  corpus, the port's members starting from vpd_tpu's initial weights, at
  dropout 0 (the packages draw their masks from different generators).
- `tools/detect` end to end on the CPU on chip_smoke's synthetic corpus:
  `ap_table.npy`, fused and `--sequential_ensemble` alike.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_heads import PARAM_TOL, flat
from vpd_tpu.tasks import detect as jdet
from vpd_tpu.train import proposal as jprop
from vpd_tpu_torch.models.flax_weights import (load_proposal_from_flax,
                                               proposal_to_flax)
from vpd_tpu_torch.tasks import detect as tdet
from vpd_tpu_torch.tools import detect as tcli
from vpd_tpu_torch.tools import paths as tpaths
from vpd_tpu_torch.train import proposal as tprop

torch.set_num_threads(2)

DIM, H = 6, 8
RTOL, ATOL = 2e-4, 2e-5
KW = dict(hidden_dim=H, batch_size=8, num_epochs=3, min_epochs=1,
          seq_len=32, samples_per_epoch=32)


def videos(n=6, frames=120, dim=DIM, seed=11):
    """Sequences with action windows of +2 (labels 1 there)."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        x = rng.normal(0, 0.3, size=(frames, dim)).astype(np.float32)
        vy = np.zeros(frames, np.int32)
        for start in range(20, frames - 20, 50):
            x[start:start + 10] += 2.0
            vy[start:start + 10] = 1
        X.append(x)
        y.append(vy)
    return X, y


def test_get_proposals_matches_vpd_tpu():
    rng = np.random.default_rng(0)
    for trial in range(300):
        n = int(rng.integers(0, 60))
        scores = (rng.random(n) if trial % 2 else
                  np.repeat(rng.random(max(n // 4, 1)), 4)[:n])
        kw = dict(activation_thresh=float(rng.choice([0.1, 0.5, 0.9,
                                                      rng.random()])),
                  min_prop_len=int(rng.integers(0, 5)),
                  merge_thresh=int(rng.integers(0, 3)))
        assert tprop.get_proposals(scores, **kw) == \
            jprop.get_proposals(scores, **kw)


def test_window_sampler_matches_vpd_tpu():
    X, y = videos(n=4)
    y[1] = y[1][:20]   # shorter than the window: never drawn
    X[1] = X[1][:20]
    a = jprop._WindowSampler(X, y, 32, 64, seed=3)
    b = tprop._WindowSampler(X, y, 32, 64, seed=3)
    for size in (8, 1, 5):
        for u, v in zip(a.batch(size), b.batch(size)):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def _jax_init(seed, seq_len=32, dim=DIM, **kw):
    v = jprop.ProposalSeq('gru', H, **kw).init(
        {'params': jax.random.key(seed)}, jnp.zeros((1, seq_len, dim)),
        jnp.full((1,), seq_len))
    return jax.tree_util.tree_map(np.asarray, v)


def test_f64_proposal_trajectory_matches_vpd_tpu(monkeypatch):
    X, y = videos()
    Xv, yv = videos(n=3, seed=12)
    kw = dict(KW, num_epochs=2, dropout=0., input_dropout=0.)
    seed = 4
    init = _jax_init(seed, dropout=0., input_dropout=0.)

    class F64(jprop.ProposalSeq):
        def init(self, *a, **k):
            return jax.tree_util.tree_map(
                lambda z: jnp.asarray(z, jnp.float64), init)

    monkeypatch.setattr(jprop, 'ProposalSeq', F64)
    batch = jprop._WindowSampler.batch
    monkeypatch.setattr(jprop._WindowSampler, 'batch', lambda self, n: (
        lambda b: (b[0].astype(np.float64), b[1]))(batch(self, n)))
    sums = []
    import vpd_tpu.core.metrics as jmetrics

    def fetch(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        sums.append(sum(float(l) for l, _ in tree))
        return tree
    monkeypatch.setattr(jmetrics, 'fetch_metrics', fetch)
    with jax.enable_x64():
        jt = jprop.ProposalTrainer('gru', X, y, X_val=Xv, y_val=yv,
                                   seed=seed, **kw)
        want = flat({'params': jax.tree_util.tree_map(np.asarray, jt.params),
                     'batch_stats': jax.tree_util.tree_map(
                         np.asarray, jt.batch_stats)})

    monkeypatch.setattr(tprop, 'init_member', lambda model, m, s: (
        load_proposal_from_flax(model, init, member=m)))
    logs = []
    tt = tprop.ProposalTrainer('gru', X, y, X_val=Xv, y_val=yv, seed=seed,
                               device='cpu', dtype=torch.float64,
                               log=lambda e, m: logs.append(m), **kw)
    got = [v for m in logs for v in (m['loss'][0], m['val_loss'][0])]
    np.testing.assert_allclose(got, sums, rtol=1e-9)
    got = flat(proposal_to_flax(tt.model))
    init = flat(init)
    assert sorted(got) == sorted(want)
    for k in want:
        moved = np.linalg.norm(want[k] - init[k])
        assert np.linalg.norm(got[k] - want[k]) <= PARAM_TOL * moved + 1e-12,\
            k


@pytest.mark.parametrize('extra', [{}, dict(early_term_acc=0.8,
                                            num_epochs=6)])
def test_fused_ensemble_matches_sequential(extra):
    X, y = videos()
    kw = dict(KW, ensemble_size=3, splits=3, seed=5, device='cpu', **extra)
    seq = tprop.EnsembleProposal('gru', X, y, fused=False, **kw)
    fused = tprop.EnsembleProposal('gru', X, y, fused=True, **kw)
    a, b = fused.model.state_dict(), seq.model.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(fused.predict_n(X[0], X[1]),
                               seq.predict_n(X[0], X[1]), rtol=RTOL,
                               atol=ATOL)


def test_run_localization_matches_vpd_tpu(monkeypatch):
    rng = np.random.default_rng(0)
    emb, labels = {}, []
    for v in range(5):
        x = rng.normal(0, 0.3, size=(160, 2, DIM))
        for start in range(30, 130, 50):
            x[start:start + 15] += 2.0
            labels.append(jdet.Label('vid{}'.format(v), 'action', start,
                                     start + 15, 25.0))
        emb['vid{}'.format(v)] = (x.astype(np.float32), np.ones(160, bool))
    train = [l for l in labels if l.video != 'vid4']
    test = [l for l in labels if l.video == 'vid4']
    kw = dict(n_trials=1, k=2, hidden_dim=H, batch_size=8,
              samples_per_epoch=32, seq_len=32, num_epochs=2, min_epochs=1,
              dropout=0., input_dropout=0., log=lambda *a: None)
    want, thresholds = jdet.run_localization('fs_jump', emb, train, test,
                                             **kw)
    inits = {}
    monkeypatch.setattr(tprop, 'init_member', lambda model, m, s: (
        load_proposal_from_flax(model, inits.setdefault(
            s, _jax_init(s)), member=m)))
    got, t2 = tdet.run_localization('fs_jump', emb, train, test,
                                    device='cpu', **kw)
    assert sorted(inits) == [0, 1]   # two folds: seeds 0 and 1
    np.testing.assert_array_equal(thresholds, t2)
    assert want[0].max() > 0
    np.testing.assert_array_equal(got[0], want[0])


def test_detect_cli_on_cpu(tmp_path, monkeypatch):
    emb_dir, action_dir, sports, n_actions = \
        chip_smoke.write_detect_corpus(
            str(tmp_path), np.random.default_rng(0), num_train=4,
            num_test=2, frames=160, emb_dim=DIM)
    monkeypatch.setattr(tpaths, 'FS_VIDEO_DIR',
                        os.path.join(sports, 'fs', 'videos'))
    tables = {}
    for name, extra in (('fused', ['--fused_ensemble']),
                        ('sequential', ['--sequential_ensemble'])):
        out = str(tmp_path / name)
        monkeypatch.setattr(sys, 'argv', [
            'detect', 'fs_jump', '--emb_dir', emb_dir, '-o', out,
            '--action_dir', action_dir, '-k', '2', '--hidden_dim', '8',
            '--batch_size', '8', '--loc_epochs', '2',
            '--samples_per_epoch', '32', '--seq_len', '32', '--device',
            'cpu'] + extra)
        results, thresholds = tcli.main(**vars(tcli.get_args()))
        tables[name] = np.load(os.path.join(out, 'ap_table.npy'))
        assert tables[name].shape == (len(thresholds), 9)
        np.testing.assert_array_equal(tables[name], results[0])
    assert np.isfinite(tables['fused']).all() and n_actions > 0
    np.testing.assert_allclose(tables['fused'], tables['sequential'],
                               atol=1e-12)


def test_detect_cli_flags_match_vpd_tpu(monkeypatch):
    from vpd_tpu.tools import detect as jcli

    argv = ['detect', 'fs_jump', '--emb_dir', 'e', '-k', '3', '-nt', '2',
            '--loc_epochs', '4', '--samples_per_epoch', '64', '--seq_len',
            '32', '--sequential_ensemble', '--_all', '-o', 'out']
    monkeypatch.setattr(sys, 'argv', argv)
    want = vars(jcli.get_args())
    got = vars(tcli.get_args())
    assert got.pop('device') == 'cuda'
    assert got == want
