"""The port's Penn Action ablation against vpd_tpu's on the CPU.

A synthetic Penn dir (JPEG frames under `{seq}/{frame:06d}.jpg`,
`pose_embs.pkl` with a low-score frame and a gap, `boxes.json` with boxes
reaching past the frame's edge):

- `scan_penn_dir`, with and without `embed_time` (and a pose-score
  filter), gives vpd_tpu's samples;
- `make_penn_sources` splits them as vpd_tpu does (80/20, the validation
  share rounded up, each half sorted);
- `PennBatchSource` batches (crops, targets and flips) are vpd_tpu's byte
  for byte on the same seed, and `load_penn_crop` flips as it does;
- `train_vpd penn` runs end to end on the CPU and resumes;
- the options penn refuses raise vpd_tpu's AssertionError.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from vpd_tpu.data import penn as jpenn
from vpd_tpu.tools import train_vpd as jcli
from vpd_tpu_torch.data import penn as tpenn
from vpd_tpu_torch.models import efficientnet as teff
from vpd_tpu_torch.tools import train_vpd as tcli

torch.set_num_threads(2)

EMB = 4
IMG = 32


def write_penn_dir(root, num_seqs=2, num_frames=6, size=(80, 60)):
    """(penn_dir, frame_dir). Frame 2 of each sequence has no pose (a gap
    for `embed_time`), frame 4 a low score; the boxes wander past every
    edge."""
    rng = np.random.default_rng(0)
    penn_dir = os.path.join(root, 'penn')
    frame_dir = os.path.join(penn_dir, 'frames')
    emb_dict, box_dict = {}, {}
    w, h = size
    for s in range(num_seqs):
        seq = '{:04d}'.format(s)
        os.makedirs(os.path.join(frame_dir, seq))
        embs, boxes = [], []
        for f in range(num_frames):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                os.path.join(frame_dir, seq, '{:06d}.jpg'.format(f + 1)))
            boxes.append([int(rng.integers(-20, w - 10)),
                          int(rng.integers(-20, h - 10)),
                          int(rng.integers(10, 50)),
                          int(rng.integers(10, 50))])
            if f != 2:
                embs.append((f, 0.3 if f == 4 else 0.9,
                             rng.normal(size=(2, EMB)).astype(np.float32)))
        emb_dict[seq] = embs
        box_dict[seq] = boxes
    with open(os.path.join(penn_dir, 'pose_embs.pkl'), 'wb') as fp:
        pickle.dump(emb_dict, fp)
    with open(os.path.join(penn_dir, 'boxes.json'), 'w') as fp:
        json.dump(box_dict, fp)
    return penn_dir, frame_dir


@pytest.fixture(scope='module')
def penn(tmp_path_factory):
    return write_penn_dir(str(tmp_path_factory.mktemp('penn')))


def _same_samples(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a[:3] == b[:3] and a[4] == b[4]
        assert a[3].dtype == b[3].dtype
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize('kw', [{}, {'embed_time': True},
                                {'min_pose_score': 0.2}])
def test_scan_penn_dir_matches_vpd_tpu(penn, kw):
    penn_dir, _ = penn
    got, dim = tpenn.scan_penn_dir(penn_dir, **kw)
    want, jdim = jpenn.scan_penn_dir(penn_dir, **kw)
    assert dim == jdim == EMB
    _same_samples(got, want)


@pytest.mark.parametrize('motion', [False, True])
def test_penn_split_matches_vpd_tpu(penn, motion):
    penn_dir, frame_dir = penn
    for seed in (0, 3):
        tr, va, dim = tcli.make_penn_sources(penn_dir, frame_dir, IMG, 4,
                                             motion=motion, seed=seed)
        jtr, jva, jdim = jcli.make_penn_sources(penn_dir, frame_dir, IMG, 4,
                                                motion=motion, seed=seed)
        assert dim == jdim
        _same_samples(tr.samples, jtr.samples)
        _same_samples(va.samples, jva.samples)
        assert len(va.samples) == int(np.ceil(0.2 * (
            len(tr.samples) + len(va.samples))))
        assert (tr.target_len, va.target_len) == (
            jtr.target_len, jva.target_len)
        # each half draws its samples from vpd_tpu's seed
        assert tr.rng.bit_generator.state == jtr.rng.bit_generator.state
        assert va.rng.bit_generator.state == jva.rng.bit_generator.state


def test_penn_batches_are_vpd_tpu_bytes(penn):
    penn_dir, frame_dir = penn
    samples, _ = tpenn.scan_penn_dir(penn_dir)
    got = tpenn.PennBatchSource(samples, frame_dir, IMG, 8, target_len=16,
                                seed=5)
    want = jpenn.PennBatchSource(samples, frame_dir, IMG, 8, target_len=16,
                                 seed=5)
    assert got.num_batches == want.num_batches == 2
    for _ in range(3):
        a, b = got.next_batch(), want.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # the flipped crop is the mirror image of the unflipped one
    seq, frame, _, _, box = samples[0]
    crop = tpenn.load_penn_crop(frame_dir, seq, frame, box, IMG)
    assert np.array_equal(crop, jpenn.load_penn_crop(frame_dir, seq, frame,
                                                     box, IMG))
    assert np.array_equal(tpenn.load_penn_crop(frame_dir, seq, frame, box,
                                               IMG, flip=True), crop[:, ::-1])


def _cli_kwargs(penn, save_dir, **kw):
    penn_dir, frame_dir = penn
    args = dict(dataset='penn', save_dir=save_dir, checkpoint_frequency=1,
                num_epochs=1, batch_size=8, learning_rate=5e-4, img_dim=IMG,
                flow_img=None, motion=False, encoder_arch='resnet18',
                model_select_window=5, pretrained=False,
                no_test_video=False, min_pose_score=None, emb_dir=None,
                seed=0, penn_dir=penn_dir, penn_frame_dir=frame_dir,
                device='cpu')
    args.update(kw)
    return args


def test_penn_cli_trains_and_resumes_on_cpu(penn, tmp_path, monkeypatch):
    """`train_vpd penn` (vpd_tpu's tests/test_effnet_penn.py:119-175 for
    the port): one epoch, then --resume to two. The student is an effnet0
    cut to its first two stages: its checkpoints are small, and each
    write is fsynced."""
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 16)
    monkeypatch.setattr(tcli, 'VAL_LEN', 8)
    monkeypatch.setattr(teff, 'BASE_BLOCKS', teff.BASE_BLOCKS[:2])
    save = str(tmp_path / 'model')
    tcli.main(**_cli_kwargs(penn, save, encoder_arch='effnet0'))
    trainer = tcli.main(**_cli_kwargs(penn, save, num_epochs=2,
                                      resume=True, encoder_arch='effnet0'))
    assert trainer.state.step == 2 * 2
    with open(os.path.join(save, 'config.json')) as fp:
        config = json.load(fp)
    assert config['dataset'] == 'penn' and config['emb_dim'] == EMB
    assert config['rgb_mean_std'] == [list(x) for x in
                                      tcli.default_config('penn', EMB)[
                                          'rgb_mean_std']]
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    assert [r['epoch'] for r in losses] == [1, 2]
    assert all(np.isfinite([r['train'], r['val']]).all() for r in losses)


@pytest.mark.parametrize('kw', [
    {'penn_dir': None}, {'flow_img': 'flow'}, {'crop_shards': 's'},
    {'hbm_cache': True}, {'hbm_cache_sharded': True}, {'num_workers': 2},
    {'augment_val': True}])
def test_penn_refusals_match_vpd_tpu(penn, tmp_path, kw):
    args = _cli_kwargs(penn, str(tmp_path / 'x'), **kw)
    with pytest.raises(AssertionError) as want:
        jcli.main(**{k: v for k, v in args.items() if k != 'device'})
    with pytest.raises(AssertionError) as got:
        tcli.main(**args)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / 'x')
