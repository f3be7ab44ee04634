"""The port's pose and embedding tools against vpd_tpu's, on the CPU.

- `preprocess_3d_pose`: pickles byte-equal for nba2k, amass and 3dpeople
  layouts (as `tests/test_cli_integration.py` writes them) and for
  human36m through a stub `cdflib` in `sys.modules`; with `-v` headless
  the `.viz` previews carry the same names.
- `dummy_2d_features` (with and without `--no_flip`) and
  `stack_features`: `.emb.pkl` files byte-equal; `stack_video_embs`
  mutates the first input's meta in place in both.
- `view_2d_pose`: the overlaid video decodes to the same frames (and its
  bytes are equal) at scale 1 and 0.5; `_resolve_pose_file` and
  `draw_keypoints` agree.
- `plot_losses`: writes its PDF (bytes carry a date, so not compared);
  `collect_dataset_losses` and `smooth` equal vpd_tpu's.
"""

import gzip
import json
import os
import pickle
import sys
import types

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from vpd_tpu.tools import dummy_2d_features as jdummy
from vpd_tpu.tools import plot_losses as jplot
from vpd_tpu.tools import preprocess_3d_pose as jprep
from vpd_tpu.tools import stack_features as jstack
from vpd_tpu.tools import view_2d_pose as jview
from vpd_tpu_torch.tools import dummy_2d_features as tdummy
from vpd_tpu_torch.tools import plot_losses as tplot
from vpd_tpu_torch.tools import preprocess_3d_pose as tprep
from vpd_tpu_torch.tools import stack_features as tstack
from vpd_tpu_torch.tools import view_2d_pose as tview

torch.set_num_threads(2)


def _bytes(path):
    with open(path, 'rb') as fp:
        return fp.read()


def _write_mocap(root, dataset, rng):
    """A tiny raw layout of one dataset, as its processor walks it."""
    base = os.path.join(root, dataset)
    if dataset == 'nba2k':
        for person in ('alfred', 'curry'):
            d = os.path.join(base, person)
            os.makedirs(os.path.join(d, 'images', '2ku'))
            for f in range(3):
                open(os.path.join(d, 'images', '2ku',
                                  '{:04d}.png'.format(f)), 'w').close()
            with open(os.path.join(d, 'release_{}_2ku.pkl'.format(person)),
                      'wb') as fp:
                pickle.dump({'j3d': [rng.uniform(-1, 1, (35, 3))
                                     for _ in range(3)]}, fp)
    elif dataset == 'amass':
        for seq in ('CMU_run01', 'KIT_walk_02'):
            d = os.path.join(base, seq)
            os.makedirs(d)
            np.save(os.path.join(d, 'pose.npy'),
                    rng.uniform(-1, 1, (2, 52, 3)))
            for f in range(2):
                open(os.path.join(d, '{:04d}_img.jpg'.format(f)), 'w').close()
        os.makedirs(os.path.join(base, 'empty_seq'))  # no pose.npy: skipped
    elif dataset == '3dpeople':
        for person, action in (('man01', 'walk'), ('woman02', 'jump')):
            d = os.path.join(base, person, action, 'camera01')
            os.makedirs(d)
            for f in (2, 1, 3):
                np.savetxt(os.path.join(d, '{:04d}.txt'.format(f)),
                           rng.uniform(-1, 1, (67, 6)))
    else:  # human36m: each .cdf holds a (1, N, 96) 'Pose' (stub cdflib)
        for person in ('S1', 'S5'):
            d = os.path.join(base, person, 'MyPoseFeatures', 'D3_Positions')
            os.makedirs(d)
            for action in ('Walking', 'Eating 1'):
                with open(os.path.join(d, action + '.cdf'), 'wb') as fp:
                    np.save(fp, rng.uniform(-800, 800, (1, 3, 96)))
    return base


class _StubCDF:
    def __init__(self, path):
        self._pose = np.load(path)
        self.closed = False

    def varget(self, name):
        assert name == 'Pose'
        return self._pose

    def close(self):
        self.closed = True


@pytest.mark.parametrize('dataset', ['nba2k', 'amass', '3dpeople',
                                     'human36m'])
def test_preprocess_3d_pose_byte_equal(dataset, tmp_path, monkeypatch):
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.setitem(sys.modules, 'cdflib',
                        types.SimpleNamespace(CDF=_StubCDF))
    data_dir = _write_mocap(str(tmp_path / 'raw'), dataset,
                            np.random.default_rng(len(dataset)))
    outs = {}
    for name, tool in (('jax', jprep), ('port', tprep)):
        outs[name] = str(tmp_path / '{}.pkl'.format(name))
        tool.main(data_dir, dataset, outs[name], visualize=True,
                  visualize_frequency=2)
    assert _bytes(outs['port']) == _bytes(outs['jax'])
    with open(outs['port'], 'rb') as fp:
        data = pickle.load(fp)
    assert len(data) >= 2 and all(len(v) >= 2 for v in data.values())
    viz = {n: sorted(os.listdir(outs[n] + '.viz')) for n in outs}
    assert viz['port'] == viz['jax'] and viz['port']
    assert viz['port'][:2] == ['000000.front.png', '000000.side.png']
    assert tprep.SPECS.keys() == jprep.SPECS.keys() == set(tprep.DATASETS)


def _write_pose_dir(pose_dir, rng, num_videos=2, num_frames=5):
    """gz-JSON 2D poses, flat `<video>.json.gz` (one nested too)."""
    os.makedirs(pose_dir)
    for v in range(num_videos):
        data = []
        for f in range(num_frames):
            kp = rng.uniform(0, 100, (17, 3))
            kp[:, 2] = rng.uniform(0.2, 1, 17)
            data.append([f * 2, [[0.9, kp.tolist()]]])
        path = os.path.join(pose_dir, 'vid{}.json.gz'.format(v))
        if v == 1:
            os.makedirs(os.path.join(pose_dir, 'vid1'))
            path = os.path.join(pose_dir, 'vid1', 'coco_keypoints.json.gz')
        with gzip.open(path, 'wt', encoding='ascii') as fp:
            json.dump(data, fp)


@pytest.mark.parametrize('no_flip', [False, True])
def test_dummy_2d_and_stack_features_byte_equal(no_flip, tmp_path):
    pose_dir = str(tmp_path / 'poses')
    _write_pose_dir(pose_dir, np.random.default_rng(1))
    dirs = {}
    for name, dummy, stack in (('jax', jdummy, jstack),
                               ('port', tdummy, tstack)):
        emb = str(tmp_path / name / 'embs')
        dummy.main(pose_dir, emb, no_flip)
        stacked = str(tmp_path / name / 'stacked')
        stack.main(emb, emb, stacked)
        dirs[name] = (emb, stacked)
    for i in range(2):
        files = sorted(os.listdir(dirs['jax'][i]))
        assert files == ['vid0.emb.pkl', 'vid1.emb.pkl']
        assert sorted(os.listdir(dirs['port'][i])) == files
        for f in files:
            assert _bytes(os.path.join(dirs['port'][i], f)) == \
                _bytes(os.path.join(dirs['jax'][i], f))
    with open(os.path.join(dirs['port'][1], 'vid0.emb.pkl'), 'rb') as fp:
        rows = pickle.load(fp)
    assert rows[0][1].shape == ((52,) if no_flip else (2, 52))


def test_stack_video_embs_mutates_first_meta():
    rng = np.random.default_rng(2)
    results = []
    for tool in (jstack, tstack):
        r = np.random.default_rng(2)
        rows1 = [(f, r.normal(size=(2, 4)), {'kp_score': 0.9, 'x': f})
                 for f in range(3)]
        rows2 = [(f, r.normal(size=(2, 3)), {'kp_score': 0.4})
                 for f in range(3)]
        metas = [m for _, _, m in rows1]
        merged = tool.stack_video_embs(rows1, rows2, name='v')
        assert [m for _, _, m in merged] == metas
        assert all(a is b for (_, _, a), b in zip(merged, metas))
        results.append(merged)
    for (f1, v1, m1), (f2, v2, m2) in zip(*results):
        assert f1 == f2 and m1 == m2 and m1['kp_score'] == 0.4
        np.testing.assert_array_equal(v1, v2)
    with pytest.raises(AssertionError):
        tstack.stack_video_embs([(0, rng.normal(size=2), {})],
                                [(1, rng.normal(size=2), {})], name='v')


def test_view_2d_pose(tmp_path):
    rng = np.random.default_rng(3)
    w, h, n = 64, 48, 6
    video = str(tmp_path / 'clip.mp4')
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*'mp4v'), 10, (w, h))
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), np.uint8))
    vw.release()
    pose_root = tmp_path / 'poses'
    os.makedirs(pose_root / 'clip')
    poses = [[f, [[0.9, rng.uniform(0, 48, (17, 3)).tolist()]]]
             for f in range(n) if f != 2]
    pose_file = str(pose_root / 'clip' / 'coco_keypoints.json.gz')
    with gzip.open(pose_file, 'wt', encoding='ascii') as fp:
        json.dump(poses, fp)
    for tool in (tview, jview):
        assert tool._resolve_pose_file(video, str(pose_root)) == pose_file
        assert tool._resolve_pose_file(video, pose_file) == pose_file
    ims = [Image.new('RGB', (w, h)) for _ in range(2)]
    for im, tool in zip(ims, (tview, jview)):
        tool.draw_keypoints(im, poses[0][1])
    np.testing.assert_array_equal(np.array(ims[0]), np.array(ims[1]))
    assert np.array(ims[0]).any()
    for scale in (None, 0.5):
        outs = {}
        for name, tool in (('port', tview), ('jax', jview)):
            outs[name] = str(tmp_path / '{}_{}.mp4'.format(name, scale))
            tool.main(video, str(pose_root), outs[name], scale)
        frames = {}
        for name, path in outs.items():
            vc = cv2.VideoCapture(path)
            frames[name] = []
            while True:
                ok, frame = vc.read()
                if not ok:
                    break
                frames[name].append(frame)
            vc.release()
        assert len(frames['port']) == n
        assert frames['port'][0].shape == (
            (h, w, 3) if scale is None else (h // 2, w // 2, 3))
        for a, b in zip(frames['port'], frames['jax']):
            np.testing.assert_array_equal(a, b)
        assert _bytes(outs['port']) == _bytes(outs['jax'])


def test_plot_losses(tmp_path, monkeypatch):
    monkeypatch.delenv('DISPLAY', raising=False)
    losses = [{'epoch': i, 'train': 1. / (i + 1), 'val': 1.2 / (i + 1) +
               0.05 * (i % 3),
               'dataset_train': [('a', 1. / (i + 1)), ('b', 2. / (i + 2))],
               'dataset_val': [('a', 1.2 / (i + 1))]} for i in range(9)]
    for key in ('dataset_train', 'dataset_val', 'missing'):
        got = tplot.collect_dataset_losses(losses, key)
        assert got == jplot.collect_dataset_losses(losses, key)
    xs = [entry['val'] for entry in losses]
    for window in (0, 1, 3, 10):
        assert tplot.smooth(xs, window) == jplot.smooth(xs, window)
    model_dir = tmp_path / 'model'
    os.makedirs(model_dir)
    with open(model_dir / 'loss.json', 'w') as fp:
        json.dump(losses, fp)
    out = str(tmp_path / 'plot.pdf')
    tplot.main(str(model_dir), 6, out)
    assert _bytes(out).startswith(b'%PDF')
    tplot.main(str(model_dir), None, None)  # default: <model_dir>/losses.pdf
    assert os.path.getsize(model_dir / 'losses.pdf') > 0
