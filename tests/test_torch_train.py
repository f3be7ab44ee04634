"""The port's student training against vpd_tpu's on the CPU.

- The step as a whole in float32 (vpd_tpu's jitted fused step against
  the port's augmentation on the same draws and its update), and the
  eval step.
- The train update: three AdamW steps of ResNet-18 + motion head on one
  pre-augmented batch in float64 (`jax.enable_x64`), from the same
  weights: losses agree to rel 1e-9; parameters to 1e-7 of how far they
  moved (plus 1e-9, as tests/test_reference_oracle.py holds them); BN
  running statistics and AdamW's moments to rel 1e-7.
- The host input: `CropBatchSource` gives vpd_tpu's bytes, targets and
  flips on the same seed, from PNG dirs and from raw shards with masks;
  `scan_emb_dir` and `train_val_split` give vpd_tpu's samples.
- Checkpoints in both directions, optimizer state included; the files
  round-trip byte-equal.
- The CLI on the CPU: two epochs, then --resume to three; every flag that
  is not ported (and pack_crops' yuv420 codec) raises NotImplementedError
  naming its ROADMAP item.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from synth import make_synth_emb_videos
from test_torch_augment import jax_draws
from vpd_tpu.core.io import store_pickle
from vpd_tpu.data import crops as jcrops
from vpd_tpu.data.shards import ShardReader as JShardReader
from vpd_tpu.data.shards import pack_crops
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu.tools import train_vpd as jcli
from vpd_tpu.train import vpd as jvpd
from vpd_tpu.train import vpd_loop as jloop
from vpd_tpu_torch.core import checkpoint as tckpt
from vpd_tpu_torch.data import crops as tcrops
from vpd_tpu_torch.data.augment import train_augment_batch
from vpd_tpu_torch.data.shards import write_raw_shards
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.models.flax_weights import (load_encoder_from_flax,
                                               load_motion_from_flax,
                                               student_params_from_flax)
from vpd_tpu_torch.models.resnet import FlaxBatchNorm2d
from vpd_tpu_torch.tools import pack_crops as tpack
from vpd_tpu_torch.tools import train_vpd as tcli
from vpd_tpu_torch.train import vpd as tvpd
from vpd_tpu_torch.train import vpd_loop as tloop

torch.set_num_threads(2)

IMG = 32
EMB = 6
LOSS_RTOL = 1e-9
PARAM_TOL = 1e-7


# ------------------------------------------------ the train update, f64

def _randomized(tree, rng):
    """f64 copy of a flax tree; BN statistics and affine terms random
    (init's 0/1 would hide a mapping error)."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _randomized(x, rng)
        elif k == 'mean':
            out[k] = rng.normal(0, 0.1, np.shape(x))
        elif k == 'var':
            out[k] = rng.uniform(0.5, 2., np.shape(x))
        elif k == 'scale':
            out[k] = rng.uniform(0.5, 1.5, np.shape(x))
        elif k == 'bias':
            out[k] = rng.normal(0, 0.1, np.shape(x))
        else:
            out[k] = np.asarray(x, np.float64)
    return out


def _port_student(cfg, params, stats, dtype=torch.float64):
    model = tloop.build_student(cfg, dtype=dtype).to(dtype)
    load_encoder_from_flax(model.encoder, {
        'params': params['encoder'], 'batch_stats': stats['encoder']})
    load_motion_from_flax(model.motion, {'params': params['motion'],
                                         'batch_stats': {}})
    return model


def test_f64_train_trajectory_matches_vpd_tpu():
    """Three steps of `apply_train_update` in both packages at B = 4.
    Running variances after a train step pin flax's biased variance:
    torch's own BatchNorm would fold in n/(n-1) = 4/3 at the 1x1 last
    stage. (At B = 2 that stage normalizes two values to about +-1, its
    backward nearly vanishes, and Adam's update of the stage before turns
    on gradients near its eps: rounding alone then moves the
    trajectory.)"""
    n_steps, lr = 3, 1e-3
    rng = np.random.default_rng(0)
    imgs = rng.normal(0, 1, (4, IMG, IMG, 5))
    emb = rng.normal(0, 1, (4, 2 * EMB))
    cfg = jloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch='resnet18')
    with jax.enable_x64():
        # vpd_tpu's build_student keeps the motion head in float32
        jmodel = jvpd.VPDStudent(
            encoder=jloop.build_encoder('resnet18', EMB, dtype=jnp.float64),
            motion=jvpd.MotionHead(EMB, dtype=jnp.float64))
        v = jmodel.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 5)),
                        train=False)
        params = _randomized(jax.tree_util.tree_map(np.asarray,
                                                    v['params']), rng)
        stats = _randomized(jax.tree_util.tree_map(
            np.asarray, v['batch_stats']), rng)
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        jstate = jvpd.VPDTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=stats, opt_state=tx.init(params), tx=tx)
        update = jax.jit(lambda s: jvpd.apply_train_update(
            jmodel, s, imgs, emb, jax.random.key(1)))
        jlosses = []
        for _ in range(n_steps):
            jstate, m = update(jstate)
            jlosses.append(float(m['emb_loss_sum']))
        jparams, jstats, jopt = jax.tree_util.tree_map(
            np.asarray, (jstate.params, jstate.batch_stats,
                         jstate.opt_state[0]))

    model = _port_student(cfg, params, stats)
    state = tvpd.create_state(model, lr)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    losses = [float(tvpd.apply_train_update(
        state, torch.from_numpy(imgs), torch.from_numpy(emb))['emb_loss_sum'])
        for _ in range(n_steps)]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert state.step == n_steps

    ref = _port_student(cfg, jparams, jstats).state_dict()
    for name, t in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        err = (t - ref[name]).norm().item()
        if name.endswith(('running_mean', 'running_var')):
            assert err <= PARAM_TOL * ref[name].norm().item(), name
        else:
            delta = (ref[name] - init[name]).norm().item()
            assert err <= PARAM_TOL * delta + 1e-9, (name, err, delta)
    opt = state.optimizer.state
    for key, torch_key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        want = student_params_from_flax(model, getattr(jopt, key))
        for name, p in model.named_parameters():
            got = opt[p][torch_key]
            assert (got - want[name]).norm().item() <= \
                PARAM_TOL * want[name].norm().item() + 1e-30, (key, name)
    assert int(jopt.count) == int(opt[next(model.parameters())]['step'])


def test_fused_step_and_eval_step_match_vpd_tpu():
    """The slice's step as a whole in float32: vpd_tpu's jitted
    augment + fwd/bwd + AdamW against the port's augmentation on the same
    draws followed by its update; then the eval step. Bars: the loss at
    rel 1e-5, BN running statistics at rel 1e-4, parameters within 2.5 x
    lr (Adam's first step is about lr x sign(g); near-zero gradients may
    round to either sign); then the eval step on vpd_tpu's updated
    weights, its loss at rel 1e-5."""
    lr, b = 1e-3, 4
    rng = np.random.default_rng(5)
    batch = {'rgb': rng.integers(0, 256, (b, IMG, IMG, 3), np.uint8),
             'flow': rng.integers(0, 256, (b, IMG, IMG, 3), np.uint8),
             'mask': ((rng.random((b, IMG, IMG)) > 0.5) * 255).astype(
                 np.uint8),
             'emb': rng.normal(size=(b, 2 * EMB)).astype(np.float32),
             'flip': rng.random(b) < 0.5}
    cfg = jloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch='resnet18')
    mean, std = cfg['rgb_mean_std']
    jmodel = jloop.build_student(cfg, dtype=jnp.float32)
    jstate = jvpd.create_state(jmodel, np.zeros((1, IMG, IMG, 5),
                                                np.float32), lr)
    params, stats = jax.tree_util.tree_map(
        np.asarray, (jstate.params, jstate.batch_stats))
    step = jvpd.make_train_step(jmodel, mean, std, img_dim=IMG,
                                use_flow=True, donate=False)
    key = jax.random.key(3)
    jnext, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                     key)
    jeval = jvpd.make_eval_step(jmodel, mean, std, use_flow=True)(
        jnext, batch)

    model = _port_student(cfg, params, stats, torch.float32)
    state = tvpd.create_state(model, lr)
    draws = jax_draws(jax.random.fold_in(key, 0), b, IMG, IMG)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws['flip'] = tb['flip']
    imgs = train_augment_batch(tb['rgb'], draws, mean, std,
                               flow_u8=tb['flow'], mask_u8=tb['mask'],
                               out_size=IMG)
    m = tvpd.apply_train_update(state, imgs, tb['emb'])
    np.testing.assert_allclose(float(m['emb_loss_sum']),
                               float(jm['emb_loss_sum']), rtol=1e-5)
    ref_model = _port_student(cfg, *jax.tree_util.tree_map(
        np.asarray, (jnext.params, jnext.batch_stats)), torch.float32)
    ref = ref_model.state_dict()
    for name, t in model.state_dict().items():
        if 'running' in name:
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        elif not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(t.detach().numpy(),
                                       ref[name].numpy(), atol=2.5 * lr,
                                       err_msg=name)
    # the eval step on vpd_tpu's updated weights
    ev = tvpd.make_eval_step(mean, std, use_flow=True)(
        tvpd.VPDTrainState(ref_model, None), tb)
    np.testing.assert_allclose(float(ev['emb_loss_sum']),
                               float(jeval['emb_loss_sum']), rtol=1e-5)
    assert ev['n'] == float(jeval['n']) == b


def test_bn_train_mode_follows_flax():
    """One train-mode forward at n = 2 values a channel: the biased batch
    variance normalizes and enters the running statistics with flax's
    momentum 0.9 (torch's BatchNorm2d would fold in twice the variance)."""
    x = torch.randn(2, 3, 1, 1, dtype=torch.float64)
    m = FlaxBatchNorm2d(3).double().train()
    y = m(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(
        y[:, :, 0, 0], (x[:, :, 0, 0] - x.mean(0)[:, 0, 0]) /
        torch.sqrt(var + 1e-5))
    torch.testing.assert_close(m.running_var, 0.9 + (1 - 0.9) * var)
    torch.testing.assert_close(m.running_mean,
                               (1 - 0.9) * x.mean(dim=(0, 2, 3)))


# ------------------------------------------------------- the host input

def write_corpus(root, n_videos=2, n_frames=8, missing_masks=(1, 5)):
    """emb dir + PNG crop tree with flow and masks (some masks missing)."""
    emb_dir, crop_dir = os.path.join(root, 'embs'), os.path.join(root,
                                                                 'crops')
    os.makedirs(emb_dir)
    videos = make_synth_emb_videos(num_videos=n_videos, num_frames=n_frames,
                                   emb_dim=EMB)
    rng = np.random.default_rng(1)
    for name, embs in videos.items():
        store_pickle(os.path.join(emb_dir, name + '.emb.pkl'), embs)
        vdir = os.path.join(crop_dir, name)
        os.makedirs(vdir)
        for f in range(n_frames):
            for suffix in ('', '.flow'):
                Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3),
                                             dtype=np.uint8)).save(
                    os.path.join(vdir, '{}{}.png'.format(f, suffix)))
            if f not in missing_masks:
                Image.fromarray(((rng.random((IMG, IMG)) > 0.5) * 255)
                                .astype(np.uint8)).save(
                    os.path.join(vdir, '{}.mask.png'.format(f)))
    return emb_dir, crop_dir


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp('corpus')))


@pytest.mark.parametrize('kw', [
    {}, {'embed_time': True}, {'normalize_target': True, 'embed_time': True},
    {'exclude_prefixes': ('video0',)}, {'min_pose_score': 0.95}])
def test_scan_and_split_match_vpd_tpu(corpus, kw):
    emb_dir, _ = corpus
    ref, ref_dim = jcrops.scan_emb_dir(emb_dir, log=lambda *a: None, **kw)
    got, dim = tcrops.scan_emb_dir(emb_dir, log=lambda *a: None, **kw)
    assert dim == ref_dim and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
    for seed in (0, 3):
        tr, va = tcrops.train_val_split(got, 0.2, seed=seed)
        jtr, jva = jcrops.train_val_split(ref, 0.2, seed=seed)
        assert [s[:3] for s in tr] == [s[:3] for s in jtr]
        assert [s[:3] for s in va] == [s[:3] for s in jva]


def _pack_port_shards(crop_dir, shard_dir):
    """Raw shards written by the port from a decode of the PNG tree."""
    prefixes = sorted('{}/{}'.format(v, f[:-4])
                      for v in os.listdir(crop_dir)
                      for f in os.listdir(os.path.join(crop_dir, v))
                      if f.endswith('.png') and f[:-4].isdigit())
    paths = [os.path.join(crop_dir, p) for p in prefixes]
    rgb, flow, mask = tcrops.decode_crop_batch(
        [p + '.png' for p in paths], IMG,
        flow_paths=[p + '.flow.png' for p in paths],
        mask_paths=[p + '.mask.png' for p in paths])
    write_raw_shards(shard_dir, prefixes, rgb, flow=flow,
                     flow_img_name='flow', mask=mask, rows_per_shard=5)


@pytest.mark.parametrize('store', ['png', 'jax_shards', 'port_shards'])
def test_crop_batch_source_matches_vpd_tpu(corpus, tmp_path, store):
    emb_dir, crop_dir = corpus
    shard_dir = None
    if store == 'jax_shards':
        shard_dir = str(tmp_path / 'shards')
        pack_crops(crop_dir, shard_dir, IMG, flow_img_name='flow',
                   use_mask=True, rows_per_shard=5, use_native=False,
                   log=lambda *a: None)
    elif store == 'port_shards':
        shard_dir = str(tmp_path / 'shards')
        _pack_port_shards(crop_dir, shard_dir)
        assert len(JShardReader(shard_dir)) == 16  # vpd_tpu reads them
    samples, _ = tcrops.scan_emb_dir(emb_dir, embed_time=True)
    for augment in (True, False):
        kw = dict(target_len=12, flow_img_name='flow', seed=3,
                  augment=augment, shard_dir=shard_dir)
        ref = jcrops.CropBatchSource(samples, crop_dir, IMG, 6,
                                     use_native=False, **kw)
        got = tcrops.CropBatchSource(samples, crop_dir, IMG, 6, **kw)
        assert got.num_batches == ref.num_batches == 2
        for _ in range(got.num_batches):
            a, b = got.next_batch(), ref.next_batch()
            assert sorted(a) == sorted(b) == ['emb', 'flip', 'flow', 'mask',
                                              'rgb']
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a['mask'].any() and not a['mask'].all()


def test_prefetched_source_stages_and_surfaces_errors(corpus):
    emb_dir, crop_dir = corpus
    samples, _ = tcrops.scan_emb_dir(emb_dir)
    src = tcrops.CropBatchSource(samples, crop_dir, IMG, 4, target_len=8,
                                 flow_img_name='flow', seed=1)
    ref = tcrops.CropBatchSource(samples, crop_dir, IMG, 4, target_len=8,
                                 flow_img_name='flow', seed=1)
    pre = tcrops.PrefetchedSource(src, device='cpu')
    try:
        assert pre.num_batches == 2
        for _ in range(2):
            got, want = pre.next_batch(), ref.next_batch()
            assert all(torch.is_tensor(v) for v in got.values())
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        pre.close()

    class Broken:
        num_batches = 1

        def next_batch(self):
            raise OSError('disk gone')

    pre = tcrops.PrefetchedSource(Broken())
    with pytest.raises(RuntimeError, match='disk gone'):
        pre.next_batch()
    pre.close()
    assert not pre._prefetcher.thread.is_alive()


# --------------------------------------------------------- checkpoints

def _sources(pkg_crops, samples, crop_dir, **kw):
    train, val = tcrops.train_val_split(samples)
    extra = {'use_native': False} if pkg_crops is jcrops else {}
    return (pkg_crops.CropBatchSource(train, crop_dir, IMG, 8, target_len=8,
                                      flow_img_name='flow', **extra, **kw),
            pkg_crops.CropBatchSource(val, crop_dir, IMG, 8, target_len=8,
                                      flow_img_name='flow', augment=False,
                                      seed=1, **extra, **kw))


def _config(emb_dim, **kw):
    return tloop.default_config('fs', emb_dim, num_epochs=1, batch_size=8,
                                img_dim=IMG, use_flow=True, motion=True,
                                encoder_arch='resnet18',
                                checkpoint_frequency=1, **kw)


def test_port_checkpoint_loads_and_resumes_in_vpd_tpu(corpus, tmp_path):
    emb_dir, crop_dir = corpus
    samples, emb_dim = tcrops.scan_emb_dir(emb_dir, embed_time=True)
    save = str(tmp_path / 'm')
    trainer = tloop.VPDTrainer(*_sources(tcrops, samples, crop_dir),
                               _config(emb_dim), save_dir=save,
                               device='cpu')
    trainer.save_config()
    trainer.fit(log=lambda *a: None)
    assert sorted(os.listdir(save)) == sorted(
        ['config.json', 'loss.json'] + [
            '{}.{}.ckpt'.format(n, c) for n in ('best_epoch', 'epoch0001')
            for c in ('encoder', 'decoder')] + ['epoch0001.optimizer.ckpt'])

    # the served student loads in vpd_tpu's extraction
    jmodel, jvars, jcfg = japply.load_student_dir(save, dtype=jnp.float32)
    assert jcfg == trainer.config

    # and vpd_tpu resumes the run, AdamW's moments included
    jtrainer = jloop.VPDTrainer(*_sources(jcrops, samples, crop_dir),
                                _config(emb_dim), save_dir=save,
                                dtype=jnp.float32)
    assert jtrainer.resume() == 2
    jopt = jax.tree_util.tree_map(np.asarray, jtrainer.state.opt_state[0])
    assert int(jopt.count) == trainer.state.step == 1
    opt = trainer.state.optimizer.state
    for key, torch_key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        want = student_params_from_flax(trainer.model, getattr(jopt, key))
        for name, p in trainer.model.named_parameters():
            np.testing.assert_array_equal(opt[p][torch_key].numpy(),
                                          want[name].numpy())
    back = _port_student(trainer.config, jax.tree_util.tree_map(
        np.asarray, jtrainer.state.params), jax.tree_util.tree_map(
            np.asarray, jtrainer.state.batch_stats), torch.float32)
    for name, t in trainer.model.state_dict().items():
        if not name.endswith('num_batches_tracked'):
            assert torch.equal(t, back.state_dict()[name]), name


def test_port_resumes_vpd_tpu_checkpoint_byte_equal(corpus, tmp_path):
    """A vpd_tpu run's epoch checkpoint (moments and step count not
    fresh) resumes in the port, whose bf16-compute trainer keeps float32
    master weights: written back, every file has the same bytes."""
    emb_dir, crop_dir = corpus
    samples, emb_dim = tcrops.scan_emb_dir(emb_dir, embed_time=True)
    jdir, tdir = str(tmp_path / 'j'), str(tmp_path / 't')
    jtrainer = jloop.VPDTrainer(*_sources(jcrops, samples, crop_dir),
                                _config(emb_dim), save_dir=jdir,
                                dtype=jnp.float32)
    rng = np.random.default_rng(4)
    st = jtrainer.state
    adam = st.opt_state[0]._replace(
        count=jnp.asarray(7, jnp.int32),
        mu=jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32),
            st.opt_state[0].mu),
        nu=jax.tree_util.tree_map(
            lambda x: rng.uniform(0, 1e-6, x.shape).astype(np.float32),
            st.opt_state[0].nu))
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 2, x.shape).astype(np.float32),
        st.batch_stats)
    jtrainer.state = st.replace(opt_state=(adam,) + st.opt_state[1:],
                                batch_stats=stats)
    jtrainer.save_config()
    jtrainer.save_model('epoch0003', with_optimizer=True)

    trainer = tloop.VPDTrainer(*_sources(tcrops, samples, crop_dir),
                               _config(emb_dim), save_dir=jdir, device='cpu')
    assert trainer.resume() == 4
    assert trainer.state.step == 7
    assert trainer.model.encoder.conv1.weight.dtype == torch.float32
    assert trainer.model.encoder.compute_dtype == torch.bfloat16
    trainer.save_dir = tdir
    trainer.save_model('epoch0003', with_optimizer=True)
    for comp in ('encoder', 'decoder', 'optimizer'):
        with open(tckpt.component_path(jdir, 'epoch0003', comp), 'rb') as a, \
                open(tckpt.component_path(tdir, 'epoch0003', comp),
                     'rb') as b:
            assert a.read() == b.read(), comp
    # and it trains on from there
    trainer.config['num_epochs'] = 4
    trainer.fit(start_epoch=4, log=lambda *a: None)
    assert trainer.state.step == 8
    assert [r['epoch'] for r in trainer.losses] == [4]


def test_augment_val_changes_val_loss_only(corpus):
    """`augment_val` (reference parity, vpd_dataset/single_frame.py:354):
    validation goes through the train augmentation, the student in eval
    mode; the train losses of the two runs are the same."""
    emb_dir, crop_dir = corpus
    samples, emb_dim = tcrops.scan_emb_dir(emb_dir, embed_time=True)
    runs = {}
    for augment_val in (False, True):
        torch.manual_seed(0)
        trainer = tloop.VPDTrainer(*_sources(tcrops, samples, crop_dir),
                                   _config(emb_dim, augment_val=augment_val),
                                   device='cpu', dtype=torch.float32)
        runs[augment_val] = trainer.train_one_epoch(1)
        assert (trainer.aug_eval_step is None) != augment_val
    assert runs[False][0] == runs[True][0]
    assert runs[False][1] != runs[True][1]
    assert np.isfinite(runs[True]).all()


def test_epoch_metrics_are_read_back_once(monkeypatch):
    from vpd_tpu_torch.core import metrics
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, 'cpu',
                        lambda self, *a, **k: calls.append(1) or real(
                            self, *a, **k))
    out = metrics.fetch_metrics([{'emb_loss_sum': torch.tensor(2.), 'n': 4.},
                                 {'emb_loss_sum': torch.tensor(3.), 'n': 4.}])
    assert out == [{'emb_loss_sum': 2., 'n': 4.},
                   {'emb_loss_sum': 3., 'n': 4.}]
    assert len(calls) == 1


# ----------------------------------------------------------------- CLI

def _cli_kwargs(emb_dir, save_dir, **kw):
    args = dict(dataset='fs', save_dir=save_dir, checkpoint_frequency=1,
                num_epochs=2, batch_size=8, learning_rate=5e-4, img_dim=IMG,
                flow_img='flow', motion=True, encoder_arch='resnet18',
                model_select_window=5, pretrained=False,
                no_test_video=False, min_pose_score=None, emb_dir=emb_dir,
                seed=0, device='cpu')
    args.update(kw)
    return args


def test_cli_trains_resumes_and_extracts_on_cpu(corpus, tmp_path,
                                                monkeypatch):
    emb_dir, crop_dir = corpus
    shard_dir = str(tmp_path / 'shards')
    _pack_port_shards(crop_dir, shard_dir)
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', crop_dir)
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 16)
    monkeypatch.setattr(tcli, 'VAL_LEN', 8)
    save = str(tmp_path / 'run')
    tcli.main(**_cli_kwargs(emb_dir, save, crop_shards=shard_dir))
    trainer = tcli.main(**_cli_kwargs(emb_dir, save, crop_shards=shard_dir,
                                      num_epochs=3, resume=True))
    assert trainer.state.step == 3 * 2
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    assert [r['epoch'] for r in losses] == [1, 2, 3]
    assert all(np.isfinite([r['train'], r['val']]).all() for r in losses)
    files = set(os.listdir(save))
    assert {'best_epoch.encoder.ckpt', 'epoch0003.encoder.ckpt',
            'epoch0003.decoder.ckpt', 'epoch0003.optimizer.ckpt'} <= files

    videos, tasks = tapply.scan_crop_dir(crop_dir)
    out = str(tmp_path / 'embs')
    tapply.apply_vpd(videos, tasks, save, out, flow_img_name='flow',
                     batch_size=8, device='cpu', log=lambda *a: None)
    with open(os.path.join(out, 'video0.emb.pkl'), 'rb') as fp:
        rows = pickle.load(fp)
    assert len(rows) == 8 and rows[0][1].shape == (2, EMB)
    assert all(np.isfinite(r[1]).all() for r in rows)


def test_cli_flags_match_vpd_tpu(monkeypatch):
    argv = ['train_vpd', 'fs', '--save_dir', 'x', '--motion',
            '--flow_img', 'flow', '--crop_shards', 's', '--resume']
    monkeypatch.setattr(sys, 'argv', argv)
    ref = vars(jcli.get_args())
    got = vars(tcli.get_args())
    assert got.pop('device') == 'cuda'
    assert got == ref


@pytest.mark.parametrize('kw,item', [
    ({'dataset': 'penn'}, 'A10'),
    ({'encoder_arch': 'effnet-b0'}, 'A10'),
    ({'codec': 'yuv420'}, 'A3')])
def test_cli_unported_flags_raise(corpus, tmp_path, kw, item):
    """train_vpd's flags of A10 raise. pack_crops --codec yuv420 (A3) is
    ported: its shards are byte-equal to vpd_tpu's."""
    emb_dir, crop_dir = corpus
    if 'codec' in kw:
        mine, ref = str(tmp_path / 's'), str(tmp_path / 'ref')
        assert tpack.main(crop_dir, mine, IMG, 'flow', False, 8, **kw) == 16
        pack_crops(crop_dir, ref, IMG, flow_img_name='flow',
                   rows_per_shard=8, use_native=False, log=lambda *a: None,
                   **kw)
        names = sorted(os.listdir(ref))
        assert sorted(os.listdir(mine)) == names and 's0001.mask' in names
        for name in names:
            with open(os.path.join(mine, name), 'rb') as a, \
                    open(os.path.join(ref, name), 'rb') as b:
                assert a.read() == b.read(), name
        return
    with pytest.raises(NotImplementedError, match='ROADMAP ' + item):
        tcli.main(**_cli_kwargs(emb_dir, str(tmp_path / 'x'), **kw))


def test_cli_needs_a_gpu_unless_told_cpu(corpus, tmp_path, monkeypatch):
    """--device cuda (the default) without a GPU raises; it never moves
    to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    emb_dir, _ = corpus
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(**_cli_kwargs(emb_dir, str(tmp_path / 'x'),
                                device='cuda'))
    assert not os.path.exists(tmp_path / 'x')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tloop.VPDTrainer(None, None, _config(EMB))
