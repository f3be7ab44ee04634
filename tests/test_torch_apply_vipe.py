"""The port's teacher checkpoints, `apply_vipe` and CLIs against vpd_tpu's.

- A teacher vpd_tpu trained for one tiny epoch serves in the port:
  `apply_vipe` writes `.emb.pkl` files with vpd_tpu's frames, metadata and
  row shapes, and embeddings within 1e-5 of vpd_tpu's `apply_vipe`, for
  flat and nested pose layouts, `--no_flip`, `--allow_many_per_frame`,
  `--invert`, `--min_score` and `--model_epoch`.
- The same in reverse: a teacher the port trained serves in vpd_tpu.
- Checkpoint files, the optimizer's included, round-trip byte-equal; the
  port resumes a vpd_tpu epoch checkpoint (AdamW's moments included) and
  writes vpd_tpu's `loss.json` keys; a dir without an optimizer file
  resumes with fresh moments.
- The CLIs on the CPU: `train_vipe --dataset 3d` on chip_smoke's synthetic
  mocap layout for two epochs, `--resume` to three, `apply_vipe` on its
  output; `--num_workers 2` over every dataset; the workers' streams; the
  flags are vpd_tpu's plus `--device`; no GPU means an error unless told
  `--device cpu`; `--tensor_parallel 2` outside torchrun refuses.
"""

import dataclasses
import gzip
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from synth import make_synth_family
from vpd_tpu.data import vipe_sampler as jvs
from vpd_tpu.infer import apply_vipe as japply
from vpd_tpu.tools import apply_vipe as jacli
from vpd_tpu.tools import train_vipe as jcli
from vpd_tpu.train import vipe_loop as jloop
from vpd_tpu_torch.core import checkpoint as tckpt
from vpd_tpu_torch.data import vipe_sampler as tvs
from vpd_tpu_torch.infer import apply_vipe as tapply
from vpd_tpu_torch.models.flax_weights import vipe_params_from_flax
from vpd_tpu_torch.tools import apply_vipe as tacli
from vpd_tpu_torch.tools import train_vipe as tcli
from vpd_tpu_torch.train import vipe_loop as tloop

torch.set_num_threads(2)

EMB = 8
FAMS = ('human36m', 'amass')
QUIET = dict(log=lambda *a: None)


def _batchers(pkg, train_len=48, val_len=16):
    train, val = [], []
    for i, fam in enumerate(FAMS):
        seqs, poses = make_synth_family(fam, seed=i)
        train.append(pkg.VIPESampler(pkg.FAMILIES[fam], seqs, poses,
                                     target_len=train_len, seed=i))
        val.append(pkg.VIPESampler(pkg.FAMILIES[fam], seqs, poses,
                                   target_len=val_len, seed=100 + i))
    return pkg.FusedBatcher(train, 16), pkg.FusedBatcher(val, 16)


def _config(num_epochs=1):
    train, _ = _batchers(tvs)
    return tloop.default_config(
        list(FAMS), [(20, 7), (21, 7)],
        [s.mean_kp_offset_norms for s in train.samplers],
        num_epochs=num_epochs, embedding_dim=EMB, encoder_arch=(2, 64),
        decoder_arch=(2, 32), checkpoint_frequency=1)


def _jax_trainer(save_dir, num_epochs=1):
    return jloop.VIPETrainer(*_batchers(jvs), _config(num_epochs),
                             save_dir=save_dir)


def _port_trainer(save_dir, num_epochs=1):
    return tloop.VIPETrainer(*_batchers(tvs), _config(num_epochs),
                             save_dir=save_dir, device='cpu')


def write_pose_json(path, num_frames=6, seed=0):
    """gz-JSON poses: 1 or 2 detections a frame, some below score 0.5."""
    rng = np.random.default_rng(seed)
    data = []
    for f in range(num_frames):
        dets = []
        for _ in range(rng.integers(1, 3)):
            kp = rng.uniform(0, 100, size=(17, 3))
            kp[:, 2] = rng.uniform(0.3, 1.0, size=17)
            dets.append([float(rng.choice([0.3, 0.9])), kp.tolist()])
        data.append([f, dets])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, 'wt', encoding='ascii') as fp:
        json.dump(data, fp)


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    """A vpd_tpu-trained teacher, a port-trained one, and a pose dir with a
    flat and a nested video."""
    root = tmp_path_factory.mktemp('vipe')
    out = {'jax': str(root / 'jax'), 'port': str(root / 'port'),
           'poses': str(root / 'poses')}
    jt = _jax_trainer(out['jax'])
    try:
        jt.save_config()
        jt.fit(**QUIET)
    finally:
        jt.close()
    tt = _port_trainer(out['port'])
    try:
        tt.save_config()
        tt.fit(**QUIET)
    finally:
        tt.close()
    write_pose_json(os.path.join(out['poses'], 'vidA.json.gz'), seed=1)
    write_pose_json(os.path.join(out['poses'], 'vidB',
                                 'coco_keypoints.json.gz'), seed=2)
    return out


def _read(out_dir):
    return {f[:-len('.emb.pkl')]: pickle.load(open(os.path.join(out_dir, f),
                                                   'rb'))
            for f in sorted(os.listdir(out_dir))}


def _assert_embs_match(got_dir, want_dir):
    got, want = _read(got_dir), _read(want_dir)
    assert sorted(got) == sorted(want) == ['vidA', 'vidB']
    for video in want:
        assert [r[0] for r in got[video]] == [r[0] for r in want[video]]
        for (_, g, gm), (_, w, wm) in zip(got[video], want[video]):
            assert gm == wm
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize('kw', [
    {}, {'no_flip': True}, {'allow_many_per_frame': True},
    {'invert': True}, {'min_score': 0.5}, {'model_epoch': 1}],
    ids=['default', 'no_flip', 'many', 'invert', 'min_score', 'epoch'])
def test_port_serves_a_vpd_tpu_teacher(dirs, tmp_path, kw):
    want, got = str(tmp_path / 'want'), str(tmp_path / 'got')
    japply.apply_vipe(dirs['poses'], dirs['jax'], want, **kw, **QUIET)
    tapply.apply_vipe(dirs['poses'], dirs['jax'], got, device='cpu', **kw,
                      **QUIET)
    _assert_embs_match(got, want)
    rows = _read(got)['vidA']
    if kw.get('allow_many_per_frame'):
        assert len(rows) > 6
    else:
        assert len(rows) <= 6 if kw.get('min_score') else len(rows) == 6
        assert rows[0][1].shape == ((EMB,) if kw.get('no_flip')
                                    else (2, EMB))


def test_vpd_tpu_serves_a_port_teacher(dirs, tmp_path):
    want, got = str(tmp_path / 'want'), str(tmp_path / 'got')
    japply.apply_vipe(dirs['poses'], dirs['port'], want, **QUIET)
    tapply.apply_vipe(dirs['poses'], dirs['port'], got, device='cpu',
                      **QUIET)
    _assert_embs_match(got, want)
    with open(os.path.join(dirs['port'], 'config.json')) as fp:
        assert json.load(fp) == _config()


def test_checkpoints_round_trip_byte_equal_and_resume(dirs, tmp_path):
    """The port resumes vpd_tpu's epoch checkpoint (weights, BN statistics
    and AdamW's moments) and writes it back byte for byte, then trains on;
    loss.json keeps vpd_tpu's keys."""
    trainer = _port_trainer(dirs['jax'], num_epochs=2)
    try:
        assert trainer.resume() == 2
        assert trainer.state.step == 6  # 2 x 48 rows at batch 16
        assert len(trainer.losses) == 1
        copy_dir = str(tmp_path / 'copy')
        trainer.save_dir = copy_dir
        trainer.save_model('epoch0001')
        for comp in ('encoder', 'decoder-3d', 'optimizer'):
            with open(tckpt.component_path(dirs['jax'], 'epoch0001', comp),
                      'rb') as a, \
                    open(tckpt.component_path(copy_dir, 'epoch0001', comp),
                         'rb') as b:
                assert a.read() == b.read(), comp
        opt = tckpt.load_component(dirs['jax'], 'epoch0001', 'optimizer')
        mu = vipe_params_from_flax(trainer.model, opt['0']['mu'])
        for name, p in trainer.model.named_parameters():
            assert torch.equal(trainer.state.optimizer.state[p]['exp_avg'],
                               mu[name]), name
        trainer.train_one_epoch(2)
    finally:
        trainer.close()
    assert trainer.state.step == 12
    with open(os.path.join(copy_dir, 'loss.json')) as fp:
        losses = json.load(fp)
    with open(os.path.join(dirs['jax'], 'loss.json')) as fp:
        jlosses = json.load(fp)
    assert [r['epoch'] for r in losses] == [1, 2]
    assert losses[0] == jlosses[0]
    assert set(losses[1]) == set(jlosses[0]) == {
        'epoch', 'train', 'val', 'dataset_train', 'dataset_val'}
    assert [k for k, _ in losses[1]['dataset_val']] == \
        [k for k, _ in jlosses[0]['dataset_val']] == ['contrast', *FAMS]
    assert os.path.exists(os.path.join(copy_dir, 'epoch0002.encoder.ckpt'))


def test_resume_without_optimizer_file(dirs, tmp_path, capsys):
    save = str(tmp_path / 'noopt')
    os.makedirs(save)
    for f in os.listdir(dirs['port']):
        if 'optimizer' not in f:
            with open(os.path.join(dirs['port'], f), 'rb') as a, \
                    open(os.path.join(save, f), 'wb') as b:
                b.write(a.read())
    trainer = _port_trainer(save, num_epochs=2)
    try:
        assert trainer.resume() == 2
        assert 'fresh optimizer state' in capsys.readouterr().out
        assert trainer.state.step == 0 and not trainer.state.optimizer.state
        train_m, _ = trainer.train_one_epoch(2)
    finally:
        trainer.close()
    assert np.isfinite(train_m['loss'])
    # and vpd_tpu resumes the port's epoch checkpoint
    jt = _jax_trainer(dirs['port'], num_epochs=2)
    try:
        assert jt.resume() == 2
        np.testing.assert_array_equal(
            np.asarray(jt.state.params['encoder']['Dense_0']['kernel']),
            tckpt.load_component(dirs['port'], 'epoch0001', 'encoder')[
                'params']['Dense_0']['kernel'])
        assert int(jax.tree_util.tree_leaves(jt.state.opt_state)[0]) == 6
    finally:
        jt.close()


def test_render_previews(tmp_path):
    """The preview MP4 of true against predicted skeletons, as vpd_tpu
    renders it (matplotlib and cv2, imported when called)."""
    trainer = _port_trainer(str(tmp_path / 'run'))
    try:
        trainer.save_config()
        samplers = _batchers(tvs)[0].samplers
        trainer.render_previews(samplers, [tvs.FAMILIES[f].spec
                                           for f in FAMS], epoch=1, count=1,
                                **QUIET)
    finally:
        trainer.close()
    out = tmp_path / 'run' / 'epoch0001.preview.mp4'
    assert out.exists() and out.stat().st_size > 0


# ----------------------------------------------------------------- CLIs

def _cli_kwargs(save_dir, **kw):
    args = dict(dataset=['3d'], save_dir=save_dir, checkpoint_frequency=1,
                num_epochs=2, learning_rate=1e-4, batch_size=32,
                embedding_dim=EMB, encoder_arch=(1, 32), decoder_arch=(1, 32),
                embed_bones=False, model_select_contrast=False,
                model_select_window=1, resume=False, no_camera_aug=False,
                seed=0, render_preview_frequency=0, device='cpu')
    args.update(kw)
    return args


@pytest.fixture
def mocap(tmp_path, monkeypatch):
    """chip_smoke's synthetic mocap corpus, the CLI's loaders pointed at
    it and every family's virtual epoch cut to 64 train and 32 val rows."""
    root = str(tmp_path / 'vipe')
    chip_smoke.write_mocap_corpus(root, np.random.default_rng(0), frames=8,
                                  cameras=2)
    for fam, (loader, _, _) in list(tcli.LOADERS.items()):
        base = os.path.join(root, chip_smoke.MOCAP_DIRS[fam])
        monkeypatch.setitem(tcli.LOADERS, fam, (
            loader, os.path.join(base, 'cocopose'),
            os.path.join(base, 'ground_truth_3d_pose.pkl')))
        monkeypatch.setitem(tvs.FAMILIES, fam, dataclasses.replace(
            tvs.FAMILIES[fam], train_target_len=64, val_target_len=32))
    monkeypatch.setattr(tcli.paths, 'PEOPLE_3D_KEYPOINT_DIR',
                        os.path.join(root, '3dpeople', 'cocopose'))
    return root


def test_cli_trains_resumes_and_serves_on_cpu(mocap, tmp_path):
    save = str(tmp_path / 'run')
    tcli.main(**_cli_kwargs(save))
    trainer = tcli.main(**_cli_kwargs(save, num_epochs=3, resume=True))
    assert trainer.train_batcher.num_batches == 8  # 4 x 64 rows, batch 32
    assert trainer.state.step == 3 * 8
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    assert [r['epoch'] for r in losses] == [1, 2, 3]
    assert all(np.isfinite([r['train'], r['val']]).all() for r in losses)
    assert [k for k, _ in losses[0]['dataset_train']] == [
        'contrast', '3dpeople', 'human36m', 'nba2k', 'amass']
    files = set(os.listdir(save))
    assert {'config.json', 'best_epoch.encoder.ckpt',
            'epoch0003.encoder.ckpt', 'epoch0003.decoder-3d.ckpt',
            'epoch0003.optimizer.ckpt'} <= files

    poses = str(tmp_path / 'poses')
    write_pose_json(os.path.join(poses, 'vidA.json.gz'), seed=3)
    write_pose_json(os.path.join(poses, 'vidB', 'coco_keypoints.json.gz'),
                    seed=4)
    out = str(tmp_path / 'embs')
    tacli.main(poses, save, out, None, False, 0, False, False,
               device='cpu')
    got = _read(out)
    assert len(got['vidA']) == 6 and got['vidA'][0][1].shape == (2, EMB)
    assert all(np.isfinite(r[1]).all() for rows in got.values()
               for r in rows)


def test_cli_with_workers_over_every_dataset(mocap, tmp_path):
    trainer = tcli.main(**_cli_kwargs(str(tmp_path / 'w'), dataset=['all'],
                                      num_workers=2, num_epochs=1))
    assert trainer.config['dataset_names'] == tcli.DATASETS
    # 4 x 64 rows + 40 pairs (20 an action) at batch 32
    assert trainer.state.step == trainer.train_batcher.num_batches == 10
    with open(os.path.join(str(tmp_path / 'w'), 'loss.json')) as fp:
        assert np.isfinite(json.load(fp)[0]['train'])


def test_worker_batchers_draw_vpd_tpu_worker_streams():
    """Worker w's samplers are seeded seed + salt + 7919 (w + 1) + i, as
    vpd_tpu's CLI seeds its forked workers."""
    seed, salt = 3, 104729
    for wid in (0, 1):
        got = tcli.worker_batcher(_batchers(tvs)[0].samplers, 16, seed,
                                  salt, wid)
        ref = _batchers(jvs)[0]
        for i, s in enumerate(ref.samplers):
            s.rng = np.random.default_rng(seed + salt + 7919 * (wid + 1) + i)
        ref = jvs.FusedBatcher(ref.samplers, 16)
        for _ in range(2):
            a, b = got.next_batch(), ref.next_batch()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('argv,ref_cli,port_cli', [
    (['train_vipe', '--dataset', '3d', '--save_dir', 'x', '--embed_bones',
      '--num_workers', '2', '--resume'], jcli, tcli),
    (['apply_vipe', 'poses', 'model', '-o', 'out', '--no_flip',
      '--min_score', '0.2'], jacli, tacli)], ids=['train', 'apply'])
def test_cli_flags_match_vpd_tpu(monkeypatch, argv, ref_cli, port_cli):
    monkeypatch.setattr(sys, 'argv', argv)
    ref = vars(ref_cli.get_args())
    got = vars(port_cli.get_args())
    assert got.pop('device') == 'cuda'
    assert got == ref


def test_clis_need_a_gpu_unless_told_cpu(dirs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(**_cli_kwargs(str(tmp_path / 'x'), device='cuda'))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapply.apply_vipe(dirs['poses'], dirs['jax'], str(tmp_path / 'y'),
                          **QUIET)
    assert not os.path.exists(tmp_path / 'x')
    assert not os.path.exists(tmp_path / 'y')
    # tensor parallelism splits the teacher over torchrun ranks: one
    # process cannot hold a model group of 2
    with pytest.raises(SystemExit, match='torchrun'):
        tcli.main(**_cli_kwargs(str(tmp_path / 'x'), tensor_parallel=2))
