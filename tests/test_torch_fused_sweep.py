"""The port's fused few-shot sweep against its sequential trials, and the
recognition protocol and CLI with the sequence heads, on the CPU.

- `FusedSweepTrainer` == `SeqModelTrainer` member by member (rtol 2e-4,
  atol 2e-5, the bar of tests/test_fused_sweep.py), with dropout on, a
  partial last batch and a validation set; under early termination on
  train accuracy, under the val-stall break and without a validation set.
  A member that misses a class raises; a world-1 mesh trains the same
  members.
- `run_action_recognition` with `gru`, fused and sequential, writes the
  same `test_pred.csv` files.
- The recognize CLI with its default algorithm (gru, fused) on the fs
  corpus of tests/test_torch_recognize.py; a head it saves, loaded with
  `-w` by the port and by vpd_tpu's CLI, gives the same `test_pred.csv`,
  and so does vpd_tpu's own head loaded by the port.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_heads import pool
from test_torch_recognize import (CATS, QUIET, assert_same_csvs, cli_kwargs,
                                  corpus, fs_corpus)
from vpd_tpu.tools import recognize as jcli
from vpd_tpu_torch.core.mesh import get_mesh
from vpd_tpu_torch.tasks import recognize as trec
from vpd_tpu_torch.tools import recognize as tcli
from vpd_tpu_torch.train.classifier import SeqModelTrainer
from vpd_tpu_torch.train.fused_sweep import FusedSweepTrainer

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
COMMON = dict(hidden_dim=8, batch_size=4, num_epochs=8, min_epochs=0,
              wr_count=2, val_freq=2, learning_rate=0.01,
              early_term_val_num_epochs=200, depth=1, device='cpu')
MEMBERS = [list(range(18)),               # the full pool
           [0, 1, 6, 7, 12, 13],          # 2-shot
           [0, 1, 2, 6, 7, 8, 12, 13, 14]]  # 3-shot, partial last batch


def _run_pair(member_rows, X, y, Xv, yv, cell='gru', **kwargs):
    floor = max(max(map(len, X)), max(map(len, Xv or [[]])))
    fused = FusedSweepTrainer(cell, X, y, member_rows, X_val=Xv, y_val=yv,
                              bucket_floor=floor, **kwargs)
    seq = [SeqModelTrainer(cell, [X[r] for r in rows], y[np.asarray(rows)],
                           X_val=Xv, y_val=yv, bucket_floor=floor, **kwargs)
           for rows in member_rows]
    return fused, seq


def _assert_members_equal(fused, seq):
    for mi, trainer in enumerate(seq):
        params, stats = fused.member(mi)
        want = trainer.variables()
        for coll, got in (('params', params), ('batch_stats', stats)):
            _close(got, want[coll])


def _close(got, want, path=()):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], path + (k,))
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=str(path + (k,)))


@pytest.mark.parametrize('cell,kw', [
    ('gru', dict(use_attention=True)),
    ('lstm', dict(use_attention=False, input_batchnorm=True)),
    ('cnn', dict(depth=2))])
def test_fused_matches_sequential_members(cell, kw):
    X, y = pool(n=6, lo=5, hi=20)
    Xv, yv = pool(n=2, seed=1, lo=5, hi=20)
    common = dict(COMMON, **kw)
    if cell == 'cnn':
        del common['depth']
    fused, seq = _run_pair(MEMBERS, X, y, Xv, yv, cell=cell, **common)
    _assert_members_equal(fused, seq)
    assert fused.bucket_max_len == 32


def test_fused_early_termination_matches():
    """early_term_acc = 0.5 stops members at different epochs (the
    train-accuracy break); each stops where its sequential trainer does."""
    X, y = pool(n=6, lo=5, hi=20)
    Xv, yv = pool(n=2, seed=1, lo=5, hi=20)
    fused, seq = _run_pair(MEMBERS, X, y, Xv, yv,
                           **dict(COMMON, early_term_acc=0.5, num_epochs=12))
    assert fused.stopped.all()
    _assert_members_equal(fused, seq)


def test_fused_val_stall_termination_matches():
    X, y = pool(n=6, lo=5, hi=20)
    Xv, yv = pool(n=2, seed=1, lo=5, hi=20)
    fused, seq = _run_pair(MEMBERS, X, y, Xv, yv,
                           **dict(COMMON, early_term_val_num_epochs=1,
                                  val_freq=1, num_epochs=12))
    assert fused.stopped.any()
    _assert_members_equal(fused, seq)


def test_fused_no_validation_returns_final_params():
    X, y = pool(n=6, lo=5, hi=20)
    fused, seq = _run_pair(MEMBERS, X, y, None, None,
                           **dict(COMMON, num_epochs=4))
    assert not fused.stopped.any()
    _assert_members_equal(fused, seq)


def test_fused_rejects_member_missing_a_class_and_a_mesh():
    """A member that misses a class raises. The mesh is ported: at world
    1 it leaves the members on this process, as vpd_tpu's one-device mesh
    does, and trains the same members (two ranks:
    tests/test_torch_mesh_ensembles.py)."""
    X, y = pool(n=4)
    with pytest.raises(ValueError, match='every class'):
        FusedSweepTrainer('gru', X, y, [list(range(12)), [0, 1, 4, 5]],
                          **COMMON)
    rows = [list(range(12)), [0, 1, 4, 5, 8, 9]]
    kw = dict(COMMON, num_epochs=2)
    plain = FusedSweepTrainer('gru', X, y, rows, **kw)
    meshed = FusedSweepTrainer('gru', X, y, rows, mesh=get_mesh('cpu'), **kw)
    for mi in range(2):
        _close(meshed.member(mi)[0], plain.member(mi)[0])


def test_run_action_recognition_fused_equals_sequential(tmp_path):
    train_embs, train_labels, test_embs, test_labels, ids = corpus(8)
    args = (CATS, train_embs, train_labels, None, None, test_embs,
            test_labels)
    kw = dict(k=1, num_train_examples=[2, -1], few_shot_template='ids_{}_{}',
              hidden_dim=8, attn=True, num_epochs=3, val_freq=1, n_trials=2,
              no_test_flip=False, load_action_ids_fn=ids.get, device='cpu',
              **QUIET)
    runs = {}
    for fused in (True, False):
        stats = {}
        out = str(tmp_path / str(fused))
        runs[fused] = trec.run_action_recognition(
            *args, out, 'gru', fused_sweep=fused, stats=stats, **kw)
        assert stats['fused'] == {2: fused, -1: fused}
    assert runs[True] == runs[False]
    assert_same_csvs(str(tmp_path / 'True'), str(tmp_path / 'False'))
    ckpts = sorted(f for f in os.listdir(tmp_path / 'True')
                   if f.endswith('.model.ckpt'))
    assert ckpts == ['trial{}_{}_gru.model.ckpt'.format(t, ne)
                     for t in (0, 1) for ne in (2, 'full')]


def test_cli_default_gru_and_heads_across_packages(tmp_path, monkeypatch):
    emb_dir, action_dir = fs_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)  # no data/sports/fs/videos: cached meta
    port = str(tmp_path / 'port')
    monkeypatch.setattr(sys, 'argv', [
        'recognize', emb_dir, '-d', 'fs', '-ne', '2', '-1', '-nt', '2',
        '--num_epochs', '6', '-vf', '2', '--hidden_dim', '8', '--device',
        'cpu', '--action_dir', action_dir, '-o', port])
    args = tcli.get_args()
    assert (args.algorithm, args.sequential_sweep) == ('gru', False)
    stats = {}
    accs = tcli.main(**vars(args), stats=stats)
    assert stats['fused'] == {2: True, -1: True}
    assert set(accs) == {2, -1} and len(accs[2]) == 2
    assert np.isfinite(accs[2] + accs[-1]).all()
    head = os.path.join(port, 'trial0_full_gru.model.ckpt')
    assert os.path.exists(head)

    # the port's head with -w, in the port and in vpd_tpu
    runs = {}
    for name, main in (('port_w', tcli.main), ('jax_w', jcli.main)):
        kw = cli_kwargs(emb_dir, action_dir, str(tmp_path / name),
                        algorithm='gru', hidden_dim=8,
                        num_train_examples=[-1], n_trials=1,
                        load_weights=head)
        if main is tcli.main:
            kw['device'] = 'cpu'
        runs[name] = main(**kw)
    assert runs['port_w'] == {-1: accs[-1][:1]}
    assert_same_csvs(str(tmp_path / 'port_w'), str(tmp_path / 'jax_w'))
    with open(os.path.join(port, 'trial0_full_gru.test_pred.csv'),
              'rb') as a, open(os.path.join(
                  tmp_path, 'port_w', 'trial0_full_gru.test_pred.csv'),
                  'rb') as b:
        assert a.read() == b.read()

    # vpd_tpu's own head, loaded by the port
    jout = str(tmp_path / 'jax')
    jcli.main(**cli_kwargs(emb_dir, action_dir, jout, algorithm='gru',
                           hidden_dim=8, num_train_examples=[-1],
                           n_trials=1, num_epochs=2))
    jhead = os.path.join(jout, 'trial0_full_gru.model.ckpt')
    kw = cli_kwargs(emb_dir, action_dir, str(tmp_path / 'port_jw'),
                    algorithm='gru', hidden_dim=8, num_train_examples=[-1],
                    n_trials=1, load_weights=jhead, device='cpu')
    tcli.main(**kw)
    assert_same_csvs(str(tmp_path / 'port_jw'), jout)


def test_recognize_cli_flags_match_vpd_tpu(monkeypatch):
    argv = ['recognize', 'e', '-d', 'fs', '--algorithm', 'lstm', '--attn',
            '--hidden_dim', '16', '--num_epochs', '3', '-vf', '2', '-ne',
            '4', '16', '-nt', '3', '-w', 'h.ckpt', '--sequential_sweep',
            '--fused_sweep']
    monkeypatch.setattr(sys, 'argv', argv)
    want = vars(jcli.get_args())
    got = vars(tcli.get_args())
    assert got.pop('device') == 'cuda'
    assert got == want
