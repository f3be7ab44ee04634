"""The port's recognition path against vpd_tpu's, on the CPU.

Datasets (dense embedding matrices, the fs loader on the real fs layout
and cached metadata), the few-shot helpers, the kNN vote, the few-shot
protocol through the DTW sweep (plain twin on the CPU; vpd_tpu's row
scan), retrieval, and the CLI. Inputs are made with numpy from seeds and
fed to both packages. The bar is equality: the same splits and arrays,
the same per-trial accuracies, byte-equal `test_pred.csv` files and equal
hit@k / prec@k dicts (the corpora keep distances far from ties, so f32
rounding in the two sweeps cannot reorder neighbours).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from vpd_tpu.datasets import load as jload
from vpd_tpu.datasets import recognition_data as jrd
from vpd_tpu.datasets.metadata_cache import load_meta_cache
from vpd_tpu.tasks import neighbors as jnb
from vpd_tpu.tasks import recognize as jrec
from vpd_tpu.tools import recognize as jcli
from vpd_tpu_torch.core.mesh import get_mesh
from vpd_tpu_torch.datasets import load as tload
from vpd_tpu_torch.datasets import recognition_data as trd
from vpd_tpu_torch.datasets.eval_splits import FS_TEST_PREFIXES
from vpd_tpu_torch.datasets.metadata_cache import load_meta_cache as tcache
from vpd_tpu_torch.tasks import neighbors as tnb
from vpd_tpu_torch.tasks import recognize as trec
from vpd_tpu_torch.tools import recognize as tcli

torch.set_num_threads(2)

QUIET = dict(log=lambda *a: None)


def write_rows(path, rows):
    with open(path, 'wb') as fp:
        pickle.dump(rows, fp)


def sparse_rows(rng, n_frames, shape):
    """Rows on a random subset of frames, some frames twice."""
    frames = np.sort(rng.choice(n_frames, n_frames // 2, replace=False))
    rows = []
    for f in frames:
        for _ in range(1 + int(rng.integers(0, 2))):
            rows.append((int(f), rng.normal(size=shape).astype(np.float32),
                         {}))
    return rows


# --- datasets and helpers-----------------------------------------------------

@pytest.mark.parametrize('shape', [(6,), (2, 6)])
def test_group_by_frame_and_load_embs(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    for v in range(3):
        write_rows(str(tmp_path / 'v{}.emb.pkl'.format(v)),
                   sparse_rows(rng, 40, shape))
    rows = sparse_rows(rng, 30, shape)
    for got, want in zip(tload.group_by_frame(rows),
                         jload.group_by_frame(rows)):
        np.testing.assert_array_equal(got, want)
    for norm in (False, True):
        got = tload.load_embs(str(tmp_path), norm, **QUIET)
        want = jload.load_embs(str(tmp_path), norm, **QUIET)
        assert sorted(got) == sorted(want) == ['v0', 'v1', 'v2']
        for v in got:
            np.testing.assert_array_equal(got[v][0], want[v][0])
            np.testing.assert_array_equal(got[v][1], want[v][1])


def test_expand_flip_rows():
    rng = np.random.default_rng(0)
    embs = {'a': rng.normal(size=(5, 2, 3)), 'b': None,
            'c': rng.normal(size=(4, 3)), 'd': rng.normal(size=(6, 2, 3))}
    labels = {'a': 2, 'b': 0, 'c': 1, 'd': 2}
    for cidx in (None, [1, 2].index):
        got = trec._expand_flip_rows(embs, labels, cidx)
        want = jrec._expand_flip_rows(embs, labels, cidx)
        assert len(got[0]) == len(want[0]) == 5
        for x, y in zip(got[0], want[0]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize('keep_ratio', [False, True])
def test_sample_embeddings(keep_ratio):
    rng = np.random.default_rng(1)
    labels = {'s{}'.format(i): int(rng.integers(0, 3)) for i in range(40)}
    embs = {s: np.zeros((1, 1)) for s in labels}
    for seed in (0, 7):
        got = trec.sample_embeddings(embs, labels, 3, keep_ratio, seed)
        want = jrec.sample_embeddings(embs, labels, 3, keep_ratio, seed)
        assert list(got) == list(want)


def test_knn_vote_and_neighbors():
    rng = np.random.default_rng(2)
    X = [rng.normal(size=(int(rng.integers(3, 9)), 4)) for _ in range(20)]
    y = list(rng.integers(0, 3, 20))

    def dist(a, b):
        return float(np.abs(a.mean(0) - b.mean(0)).sum())

    for k in (1, 3, 5):
        got = tnb.KNearestNeighbors(X, y, dist, k=k)
        want = jnb.KNearestNeighbors(X, y, dist, k=k)
        for x in X[:6]:
            assert got.predict(x) == want.predict(x)
            assert got.predict_n(x, X[0]) == want.predict_n(x, X[0])
    for x in X[:4]:
        assert tnb.Neighbors(X, dist).find(x, 5, 4) == \
            jnb.Neighbors(X, dist).find(x, 5, 4)


# --- the few-shot protocol and retrieval--------------------------------------

class _Cat:
    def __init__(self, name):
        self.name = name


CATS = {i: _Cat('c{}'.format(i)) for i in range(3)}


def corpus(seed, n_train=12, n_test=9, short_test=False, D=5):
    """Flip-pair sequences, 3 classes 3 sigma apart on their own axis."""
    rng = np.random.default_rng(seed)

    def make(n, tag):
        embs, labels = {}, {}
        for i in range(n):
            name = '{}{:02d}'.format(tag, i)
            cls = i % 3
            base = rng.normal(size=(int(rng.integers(8, 24)), 1, D))
            base[:, 0, cls] += 3
            embs[name] = np.concatenate(
                [base, base + 0.1 * rng.normal(size=base.shape)],
                axis=1).astype(np.float32)
            labels[name] = cls
        return embs, labels

    train_embs, train_labels = make(n_train, 'tr')
    test_embs, test_labels = make(n_test, 'te')
    if short_test:  # symmetricP2 cannot align 2 frames with >= 8
        test_embs['te00'] = test_embs['te00'][:2]
    ids = {'ids_2_{}'.format(t): set(list(train_embs)[t:t + 6])
           for t in range(2)}
    return train_embs, train_labels, test_embs, test_labels, ids


def run_both(tmp_path, short_test=False):
    train_embs, train_labels, test_embs, test_labels, ids = corpus(
        3, short_test=short_test)
    args = (train_embs, train_labels, None, None, test_embs, test_labels)
    kw = dict(k=3, num_train_examples=[2, -1], few_shot_template='ids_{}_{}',
              hidden_dim=8, attn=False, num_epochs=1, val_freq=1,
              n_trials=2, no_test_flip=False, load_action_ids_fn=ids.get,
              device_knn=True, **QUIET)
    want = jrec.run_action_recognition(
        CATS, *args, out_dir=str(tmp_path / 'jax'), algorithm='dtw', **kw)
    stats = {}
    got = trec.run_action_recognition(
        CATS, *args, out_dir=str(tmp_path / 'port'), algorithm='dtw',
        device='cpu', stats=stats, **kw)
    return got, want, stats


def assert_same_csvs(dir_a, dir_b):
    csvs = sorted(f for f in os.listdir(dir_b) if f.endswith('.csv'))
    assert csvs and sorted(
        f for f in os.listdir(dir_a) if f.endswith('.csv')) == csvs
    for f in csvs:
        with open(os.path.join(dir_a, f), 'rb') as a, \
                open(os.path.join(dir_b, f), 'rb') as b:
            assert a.read() == b.read(), f


def test_run_action_recognition_matches_vpd_tpu(tmp_path):
    got, want, stats = run_both(tmp_path)
    assert got == want
    assert got[-1] == [1.0, 1.0]
    assert stats['index']._d2 is None  # no infeasible pair: one sweep
    assert set(stats['vote_seconds']) == {2, -1}
    assert_same_csvs(str(tmp_path / 'port'), str(tmp_path / 'jax'))


def test_symmetric2_fallback_matches_vpd_tpu(tmp_path):
    got, want, stats = run_both(tmp_path, short_test=True)
    assert got == want
    index = stats['index']
    assert index._d2 is not None  # the fallback sweep ran
    assert np.isinf(index.d1[index.test_rows['te00']]).all()
    assert_same_csvs(str(tmp_path / 'port'), str(tmp_path / 'jax'))


def test_run_action_retrieval_matches_vpd_tpu():
    train_embs, train_labels, test_embs, test_labels, _ = corpus(4)
    embs = {**train_embs, **test_embs, 'none': None}
    labels = {**train_labels, **test_labels, 'none': 0}
    for queryset in (None, set(test_embs)):
        want = jrec.run_action_retrieval(embs, labels, [1, 3, 5], queryset,
                                         device=True, **QUIET)
        got = trec.run_action_retrieval(embs, labels, [1, 3, 5], queryset,
                                        device='cpu', **QUIET)
        assert got == want


def test_sequence_heads_raise():
    """The sequence heads are ported; what they refuse: k != 1 and an
    unknown algorithm. The fused sweep changes nothing for DTW, as in
    vpd_tpu, and neither does the data mesh (vpd_tpu shards no DTW sweep):
    with a world-1 mesh the DTW protocol gives the run without it."""
    train_embs, train_labels, test_embs, test_labels, ids = corpus(4)
    accs = [trec.run_action_recognition(
        CATS, train_embs, train_labels, None, None, test_embs, test_labels,
        None, 'dtw', 1, [2, -1], 'ids_{}_{}', 8, False, 1, 1, 2, False,
        load_action_ids_fn=ids.get, device='cpu', **kw, **QUIET)
        for kw in ({}, {'mesh': get_mesh('cpu'), 'fused_sweep': True})]
    assert accs[0] == accs[1] and set(accs[0]) == {2, -1}
    with pytest.raises(ValueError, match='k = 3'):
        trec.run_action_recognition(CATS, {}, {}, None, None, {}, {}, None,
                                    'gru', 3, [-1], '', 8, False, 1, 1, 1,
                                    False, device='cpu')
    with pytest.raises(ValueError, match='unknown algorithm'):
        trec.run_action_recognition(CATS, {}, {}, None, None, {}, {}, None,
                                    'svm', 1, [-1], '', 8, False, 1, 1, 1,
                                    False, device='cpu')
    train_embs, train_labels, test_embs, test_labels, _ = corpus(6)
    args = (CATS, train_embs, train_labels, None, None, test_embs,
            test_labels, None, 'dtw', 1, [-1], '', 8, False, 1, 1, 1, False)
    assert trec.run_action_recognition(*args, fused_sweep=True,
                                       device='cpu', **QUIET) == \
        trec.run_action_recognition(*args, device='cpu', **QUIET)


def test_device_none_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: device=None means CUDA here')
    train_embs, train_labels, test_embs, test_labels, _ = corpus(5)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trec.run_action_recognition(
            CATS, train_embs, train_labels, None, None, test_embs,
            test_labels, None, 'dtw', 1, [-1], '', 8, False, 1, 1, 1, False,
            **QUIET)


# --- the fs dataset and the CLI-----------------------------------------------

D_FS = 6
FS_CLASSES = jrd.FS_CLASSES


def fs_corpus(root, seed=0):
    """A tiny fs corpus on real fs video names (fps from the cached
    metadata): all.txt, val ids, 2-shot split files and one .emb.pkl per
    video whose rows cover each dilated action window."""
    rng = np.random.default_rng(seed)
    meta = tcache('fs')
    names = sorted(meta)
    test_videos = [v for v in names if v.startswith(FS_TEST_PREFIXES)][:2]
    train_videos = [v for v in names
                    if not v.startswith(FS_TEST_PREFIXES)][:5]
    action_dir = os.path.join(root, 'action_dataset')
    emb_dir = os.path.join(root, 'embs')
    os.makedirs(os.path.join(action_dir, 'fs'))
    os.makedirs(emb_dir)
    actions = []
    for vi, video in enumerate(train_videos + test_videos):
        fps = meta[video].fps
        cursor, rows = int(3 * fps), {}
        for a in range(3):
            cls = (vi + a) % 3
            start = cursor + int(rng.integers(0, 10))
            end = start + int(rng.integers(15, 40))
            actions.append(('{}:{}:{}'.format(video, start, end),
                            FS_CLASSES[cls], video in train_videos))
            mid = (start + end) / 2
            for f in range(int(mid - 2.5 * fps) - 2,
                           int(mid + 0.5 * fps) + 3):
                e = rng.normal(0, 0.3, (1, D_FS))
                if start <= f < end:
                    e[0, cls] += 3.
                e = np.concatenate([e, e + rng.normal(0, 0.05, e.shape)])
                rows[f] = e.astype(np.float32)
            cursor = end + int(4 * fps)
        write_rows(os.path.join(emb_dir, video + '.emb.pkl'),
                   [(f, e, {}) for f, e in sorted(rows.items())])
    with open(os.path.join(action_dir, 'fs', 'all.txt'), 'w') as fp:
        fp.writelines('{} {}\n'.format(a, label) for a, label, _ in actions)
    train = [(a, label) for a, label, is_train in actions if is_train]
    with open(os.path.join(action_dir, 'fs', 'val.ids.txt'), 'w') as fp:
        fp.write(train[0][0] + '\n')
    for trial in range(2):
        picks = [a for c in FS_CLASSES[:3]
                 for a in [a for a, label in train[1:] if label == c]
                 [trial:trial + 2]]
        with open(os.path.join(action_dir, 'fs',
                               'train_2_{}.ids.txt'.format(trial)),
                  'w') as fp:
            fp.writelines(a + '\n' for a in picks)
    return emb_dir, action_dir


def test_load_fs_data_matches_vpd_tpu(tmp_path):
    emb_dir, action_dir = fs_corpus(str(tmp_path))
    got = trd.load_fs_data(emb_dir, True, tcache('fs'),
                           action_dir=action_dir, **QUIET)
    want = jrd.load_fs_data(emb_dir, True, load_meta_cache('fs'),
                            action_dir=action_dir, **QUIET)
    assert [c.name for c in got[0].values()] == \
        [c.name for c in want[0].values()]
    for g, w in zip(got[1:7], want[1:7]):
        assert list(g) == list(w) and g
        for key in g:
            if isinstance(w[key], np.ndarray):
                np.testing.assert_array_equal(g[key], w[key])
            else:
                assert g[key] == w[key]
    assert dict(got[7]) == dict(want[7])


def cli_kwargs(emb_dir, action_dir, out_dir, **kw):
    return dict(dict(
        emb_dir=emb_dir, dataset='fs', out_dir=out_dir, algorithm='dtw',
        num_train_examples=[2, -1], norm=False, k=1, hidden_dim=8,
        attn=False, target_fps=25, num_epochs=1, val_freq=1, n_trials=2,
        no_test_flip=False, retrieve=False, action_dir=action_dir), **kw)


def test_cli_matches_vpd_tpu(tmp_path, monkeypatch, capsys):
    emb_dir, action_dir = fs_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)  # no data/sports/fs/videos: cached meta
    jcli.main(**cli_kwargs(emb_dir, action_dir, str(tmp_path / 'jax'),
                           device_knn=True, sequential_sweep=True))
    monkeypatch.setattr(sys, 'argv', [
        'recognize', emb_dir, '-d', 'fs', '--algorithm', 'dtw', '-ne', '2',
        '-1', '-nt', '2', '--device', 'cpu', '--device_knn',
        '--action_dir', action_dir, '-o', str(tmp_path / 'port')])
    accs = tcli.main(**vars(tcli.get_args()))
    assert accs[-1] == [1.0, 1.0]
    assert_same_csvs(str(tmp_path / 'port'), str(tmp_path / 'jax'))

    capsys.readouterr()
    jcli.main(**cli_kwargs(emb_dir, action_dir, None, retrieve=True,
                           num_train_examples=[1, 3],
                           device_retrieval=True))
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith(('hit@', 'prec@'))]
    monkeypatch.setattr(sys, 'argv', [
        'recognize', emb_dir, '-d', 'fs', '--retrieve', '-ne', '1', '3',
        '--device', 'cpu', '--action_dir', action_dir])
    tcli.main(**vars(tcli.get_args()))
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith(('hit@', 'prec@'))]
    assert len(got) == 2 and got == want


def test_cli_sequence_head_raises(tmp_path):
    """A sequence head votes with k = 1: the CLI refuses another k before
    it loads any data."""
    with pytest.raises(ValueError, match='k = 2'):
        tcli.main(**cli_kwargs(str(tmp_path), None, None, algorithm='gru',
                               k=2, device='cpu'))
