"""The port's device crop cache and cached steps against vpd_tpu's, on the
CPU.

- `CacheIndexSource` draws vpd_tpu's (idx, emb, flip) stream on the same
  shards and seed, and the port's `CropBatchSource` sample and flip
  stream; `DeviceCropCache(device='cpu')` holds the shards' bytes, the
  same with `shard_rows=True` on one device.
- The cached train step against the streamed step on the same rows:
  bit-equal loss and parameters.
- Three steps of `make_cached_train_step` in float64 in both packages
  (the augmentation on vpd_tpu's JAX draws): losses to rel 1e-9;
  parameters to 1e-7 of how far they moved (plus 1e-9), BN running
  statistics and AdamW's moments to rel 1e-7, as
  `test_torch_train.py::test_f64_train_trajectory_matches_vpd_tpu`
  holds the update alone. The cached eval step in float32 at rel 1e-5.
- Every guard raises; the CLI with `--hbm_cache` (and
  `--hbm_cache_sharded`) writes the streamed CLI's `loss.json` exactly.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_augment import jax_draws
from test_torch_train import (EMB, IMG, _cli_kwargs, _config, _port_student,
                              _randomized, write_corpus)
from vpd_tpu.data import hbm_cache as jhbm
from vpd_tpu.data.shards import ShardReader as JShardReader
from vpd_tpu.data.shards import pack_crops as jpack_crops
from vpd_tpu.train import vpd as jvpd
from vpd_tpu.train import vpd_loop as jloop
from vpd_tpu_torch.data import crops as tcrops
from vpd_tpu_torch.data import hbm_cache as thbm
from vpd_tpu_torch.data.shards import ShardReader
from vpd_tpu_torch.models.flax_weights import student_params_from_flax
from vpd_tpu_torch.tools import train_vpd as tcli
from vpd_tpu_torch.train import vpd as tvpd
from vpd_tpu_torch.train import vpd_loop as tloop

torch.set_num_threads(2)

LOSS_RTOL = 1e-9
PARAM_TOL = 1e-7
ROWS_PER_SHARD = 5


def _quiet(*args):
    pass


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """emb dir, PNG crop tree, and vpd_tpu's raw shards of it (rgb, flow,
    masks; 16 rows in shards of 5), plus a copy packed without masks."""
    root = tmp_path_factory.mktemp('cache')
    emb_dir, crop_dir = write_corpus(str(root))
    shards = {}
    for use_mask in (True, False):
        shards[use_mask] = str(root / 'shards_{}'.format(use_mask))
        jpack_crops(crop_dir, shards[use_mask], IMG, flow_img_name='flow',
                    use_mask=use_mask, rows_per_shard=ROWS_PER_SHARD,
                    use_native=False, log=_quiet)
    samples, emb_dim = tcrops.scan_emb_dir(emb_dir, embed_time=True,
                                           log=_quiet)
    return emb_dir, crop_dir, shards, samples, emb_dim


def _caches(world, **kw):
    """(port cache on the CPU, vpd_tpu cache) of the masked shards."""
    _, crop_dir, shards, _, _ = world
    return (thbm.DeviceCropCache(ShardReader(shards[True], crop_root=crop_dir),
                                 device='cpu', log=_quiet, **kw),
            jhbm.DeviceCropCache(JShardReader(shards[True], crop_root=crop_dir),
                                 log=_quiet, **kw))


@pytest.mark.parametrize('augment', [True, False])
def test_cache_index_source_matches_vpd_tpu(world, augment):
    """Equal idx, emb and flip for 3 batches; the same rows, targets and
    flips as the port's streamed CropBatchSource on the same seed."""
    _, crop_dir, shards, samples, _ = world
    cache, jcache = _caches(world, use_flow=True)
    kw = dict(target_len=18, flow_img_name='flow', seed=5, augment=augment)
    got = thbm.CacheIndexSource(samples, crop_dir, IMG, 6, cache=cache,
                                shard_dir=shards[True], **kw)
    ref = jhbm.CacheIndexSource(samples, crop_dir, IMG, 6, cache=jcache,
                                **kw)
    streamed = tcrops.CropBatchSource(samples, crop_dir, IMG, 6,
                                      shard_dir=shards[True], **kw)
    assert got.num_batches == ref.num_batches == streamed.num_batches == 3
    assert got.decoder != 'native'  # index sources probe no decoder
    for _ in range(3):
        a, b, s = got.next_batch(), ref.next_batch(), streamed.next_batch()
        assert sorted(a) == sorted(b) == ['emb', 'flip', 'idx']
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a['emb'], s['emb'])
        np.testing.assert_array_equal(a['flip'], s['flip'])
        idx = torch.from_numpy(a['idx'])
        for k in ('rgb', 'flow', 'mask'):
            np.testing.assert_array_equal(
                cache.arrays[k].index_select(0, idx).numpy(), s[k],
                err_msg=k)
    assert augment == bool(a['flip'].any() or b['flip'].any())


@pytest.mark.parametrize('kw', [{'use_flow': True},
                                {'use_flow': True, 'shard_rows': True},
                                {'use_flow': False, 'use_mask': False}])
def test_device_cache_holds_the_shards(world, kw):
    _, crop_dir, shards, _, _ = world
    reader = ShardReader(shards[True], crop_root=crop_dir)
    cache = thbm.DeviceCropCache(reader, device='cpu', log=_quiet, **kw)
    want = ['rgb'] + (['flow'] if kw['use_flow'] else []) + (
        ['mask'] if kw.get('use_mask', True) else [])
    assert sorted(cache.arrays) == sorted(want)
    assert cache.device == torch.device('cpu')
    streams = {'rgb': reader._rgb, 'flow': reader._flow,
               'mask': reader._mask}
    for k, t in cache.arrays.items():
        assert t.dtype == torch.uint8 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(),
                                      np.concatenate(streams[k]), err_msg=k)
    assert cache.nbytes == sum(t.numel() for t in cache.arrays.values())
    assert len(reader._rgb) == 4 and len(reader) == 16
    # the replicated cache: what vpd_tpu stages without a mesh
    _, jcache = _caches(world, **kw)
    for k, t in cache.arrays.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jcache.arrays[k]))


def _two_sources(world, cache, b=8, seed=2):
    _, crop_dir, shards, samples, _ = world
    kw = dict(target_len=2 * b, flow_img_name='flow', seed=seed)
    return (tcrops.CropBatchSource(samples, crop_dir, IMG, b,
                                   shard_dir=shards[True], **kw),
            thbm.CacheIndexSource(samples, crop_dir, IMG, b, cache=cache,
                                  **kw))


def test_cached_step_equals_streamed_step(world):
    """Two steps each from the same weights, seed and rows (bf16 compute
    over float32 master weights, as the trainer runs): bit-equal losses,
    parameters, BN statistics and AdamW moments."""
    cache, _ = _caches(world, use_flow=True)
    streamed, indexed = _two_sources(world, cache)
    cfg = _config(EMB)
    torch.manual_seed(0)
    model = tloop.build_student(cfg, dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    twin = copy.deepcopy(model)
    states = tvpd.create_state(model, 1e-3), tvpd.create_state(twin, 1e-3)
    kw = dict(img_dim=IMG, use_flow=True, aug_dtype=torch.bfloat16)
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], **kw)
    cached = tvpd.make_cached_train_step(*cfg['rgb_mean_std'], **kw)
    for _ in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 streamed.next_batch().items()}
        ibatch = {k: torch.from_numpy(v) for k, v in
                  indexed.next_batch().items()}
        a = step(states[0], batch, 7)['emb_loss_sum']
        b = cached(states[1], ibatch, 7, cache.arrays)['emb_loss_sum']
        assert torch.equal(a, b), (a, b)
    for (name, x), y in zip(model.state_dict().items(),
                            twin.state_dict().values()):
        assert torch.equal(x, y), name
    for p, q in zip(model.parameters(), twin.parameters()):
        for key in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(states[0].optimizer.state[p][key],
                               states[1].optimizer.state[q][key])


def _jax_sampler(key):
    """A stand-in for the port's `sample_train_augment` that returns
    vpd_tpu's draws in float64 for the step the generator was seeded for
    (`fold_in(seed, step)` puts the step in the low 32 bits)."""
    def sample(gen, host_gen, b, h, w, **kw):
        step = gen.initial_seed() & 0xffffffff
        with jax.enable_x64():
            return jax_draws(jax.random.fold_in(key, step), b, h, w,
                             jnp.float64)
    return sample


def test_f64_cached_trajectory_matches_vpd_tpu(world, monkeypatch):
    n_steps, lr, b = 3, 1e-3, 4
    _, crop_dir, _, samples, _ = world
    cache, jcache = _caches(world, use_flow=True)
    kw = dict(target_len=n_steps * b, flow_img_name='flow', seed=4)
    src = jhbm.CacheIndexSource(samples, crop_dir, IMG, b, cache=jcache,
                                **kw)
    batches = [src.next_batch() for _ in range(n_steps)]
    src = thbm.CacheIndexSource(samples, crop_dir, IMG, b, cache=cache, **kw)
    for batch in batches:
        for k, v in src.next_batch().items():
            np.testing.assert_array_equal(v, batch[k])
    rng = np.random.default_rng(0)
    cfg = jloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch='resnet18')
    mean, std = cfg['rgb_mean_std']
    key = jax.random.key(9)
    with jax.enable_x64():
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
        jstep = jvpd.make_cached_train_step(
            jmodel, mean, std, img_dim=IMG, use_flow=True, use_mask=True,
            donate=False, aug_dtype=jnp.float64)
        jlosses = []
        for batch in batches:
            jstate, m = jstep(jstate, batch, key, jcache.arrays)
            jlosses.append(float(m['emb_loss_sum']))
        jparams, jstats, jopt = jax.tree_util.tree_map(
            np.asarray, (jstate.params, jstate.batch_stats,
                         jstate.opt_state[0]))

    monkeypatch.setattr(tvpd, 'sample_train_augment', _jax_sampler(key))
    model = _port_student(cfg, params, stats)
    state = tvpd.create_state(model, lr)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = tvpd.make_cached_train_step(mean, std, img_dim=IMG, use_flow=True,
                                       use_mask=True,
                                       aug_dtype=torch.float64)
    losses = [float(step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, 1,
                         cache.arrays)['emb_loss_sum'])
              for batch in batches]
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
    for key_, torch_key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        want = student_params_from_flax(model, getattr(jopt, key_))
        for name, p in model.named_parameters():
            got = opt[p][torch_key]
            assert (got - want[name]).norm().item() <= \
                PARAM_TOL * want[name].norm().item() + 1e-30, (key_, name)


def test_cached_eval_step_matches_vpd_tpu(world):
    _, crop_dir, _, samples, _ = world
    cache, jcache = _caches(world, use_flow=True)
    batch = jhbm.CacheIndexSource(samples, crop_dir, IMG, 6, cache=jcache,
                                  target_len=6, flow_img_name='flow',
                                  augment=False, seed=1).next_batch()
    cfg = jloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch='resnet18')
    mean, std = cfg['rgb_mean_std']
    jmodel = jloop.build_student(cfg, dtype=jnp.float32)
    jstate = jvpd.create_state(jmodel, np.zeros((1, IMG, IMG, 5),
                                                np.float32), 1e-3)
    ref = jvpd.make_cached_eval_step(jmodel, mean, std, use_flow=True)(
        jstate, batch, jcache.arrays)
    params, stats = jax.tree_util.tree_map(
        np.asarray, (jstate.params, jstate.batch_stats))
    model = _port_student(cfg, params, stats, torch.float32)
    got = tvpd.make_cached_eval_step(mean, std, use_flow=True)(
        tvpd.VPDTrainState(model, None),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cache.arrays)
    np.testing.assert_allclose(float(got['emb_loss_sum']),
                               float(ref['emb_loss_sum']), rtol=1e-5)
    assert got['n'] == float(ref['n']) == 6


# ------------------------------------------------------------- guards

def _guard_case(world, case, tmp_path):
    """Build what `case` names; each must raise ValueError."""
    _, crop_dir, shards, samples, emb_dim = world

    def cache(use_mask_shards=True, **kw):
        return thbm.DeviceCropCache(
            ShardReader(shards[use_mask_shards], crop_root=crop_dir),
            device='cpu', log=_quiet, **kw)

    def source(c, **kw):
        args = dict(target_len=8, flow_img_name='flow', cache=c)
        args.update(kw)
        return thbm.CacheIndexSource(samples, crop_dir, IMG, 4, **args)

    if case == 'augment_val':
        c = cache(use_flow=True)
        tloop.VPDTrainer(source(c), source(c), _config(emb_dim,
                                                       augment_val=True),
                         device='cpu')
    elif case == 'separate_caches':
        tloop.VPDTrainer(source(cache(use_flow=True)),
                         source(cache(use_flow=True)), _config(emb_dim),
                         device='cpu')
    elif case == 'img_dim':
        thbm.CacheIndexSource(samples, crop_dir, 2 * IMG, 4,
                              cache=cache(use_flow=True), target_len=8)
    elif case == 'flow_name':
        source(cache(use_flow=True), flow_img_name='farneback')
    elif case == 'flow_not_staged':
        source(cache(use_flow=False))
    elif case == 'flow_not_packed':
        reader = ShardReader(shards[True], crop_root=crop_dir)
        reader._flow = []
        thbm.DeviceCropCache(reader, use_flow=True, device='cpu', log=_quiet)
    elif case == 'mask_not_packed':
        source(cache(use_mask_shards=False, use_flow=True))
    elif case == 'mask_not_staged':
        source(cache(use_flow=True, use_mask=False))
    elif case == 'missing_rows':
        thbm.CacheIndexSource(
            samples + [('video9', None, 3, samples[0][3])], crop_dir, IMG, 4,
            cache=cache(use_flow=True), target_len=8, flow_img_name='flow')
    elif case == 'yuv420_reader':
        reader = ShardReader(shards[True], crop_root=crop_dir)
        reader.codec = 'yuv420'
        thbm.DeviceCropCache(reader, device='cpu', log=_quiet)
    elif case == 'cli_without_shards':
        tcli.main(**_cli_kwargs(world[0], str(tmp_path / 'x'),
                                hbm_cache=True))
    elif case == 'cli_with_workers':
        tcli.main(**_cli_kwargs(world[0], str(tmp_path / 'x'),
                                hbm_cache=True, crop_shards=shards[True],
                                num_workers=2))


GUARDS = ['augment_val', 'separate_caches', 'img_dim', 'flow_name',
          'flow_not_staged', 'flow_not_packed', 'mask_not_packed',
          'mask_not_staged', 'missing_rows', 'yuv420_reader',
          'cli_without_shards', 'cli_with_workers']


@pytest.mark.parametrize('case', GUARDS)
def test_cache_guards_raise(world, case, tmp_path, monkeypatch):
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', world[1])
    with pytest.raises(ValueError):
        _guard_case(world, case, tmp_path)
    assert not os.path.exists(tmp_path / 'x')


def test_yuv420_shards_are_refused(world, tmp_path):
    """vpd_tpu's yuv420 shards: the port's reader reads them (packed
    rows), and the device crop cache and the training source refuse them,
    as vpd_tpu's cache does."""
    _, crop_dir, _, samples, _ = world
    shard_dir = str(tmp_path / 'yuv')
    jpack_crops(crop_dir, shard_dir, IMG, use_mask=False, codec='yuv420',
                use_native=False, log=_quiet)
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    assert reader.codec == 'yuv420' and len(reader) == 16
    assert reader._rgb[0].shape == (16, IMG * IMG * 3 // 2)
    with pytest.raises(ValueError, match='extraction-only'):
        thbm.DeviceCropCache(reader, device='cpu', log=_quiet)
    with pytest.raises(AssertionError, match='extraction-only'):
        jhbm.DeviceCropCache(JShardReader(shard_dir, crop_root=crop_dir),
                             log=_quiet)
    with pytest.raises(ValueError, match='extraction-only'):
        tcrops.CropBatchSource(samples, crop_dir, IMG, 4, use_mask=False,
                               shard_dir=shard_dir)


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize('flag', ['hbm_cache', 'hbm_cache_sharded'])
def test_cli_cache_writes_the_streamed_loss_json(world, tmp_path,
                                                 monkeypatch, flag):
    """Two epochs then --resume to three, streamed from the shards and
    from the cache with the same seed: the same loss.json, to the bit
    (vpd_tpu's contract: batch-for-batch equality)."""
    emb_dir, crop_dir, shards, _, _ = world
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', crop_dir)
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 16)
    monkeypatch.setattr(tcli, 'VAL_LEN', 8)
    runs = {}
    for name, kw in (('streamed', {}), ('cached', {flag: True})):
        save = str(tmp_path / name)
        tcli.main(**_cli_kwargs(emb_dir, save, crop_shards=shards[True],
                                **kw))
        trainer = tcli.main(**_cli_kwargs(emb_dir, save, num_epochs=3,
                                          resume=True,
                                          crop_shards=shards[True], **kw))
        assert (trainer.cache is not None) == (name == 'cached')
        with open(os.path.join(save, 'loss.json')) as fp:
            runs[name] = json.load(fp)
        assert {'best_epoch.encoder.ckpt', 'epoch0003.optimizer.ckpt'} <= \
            set(os.listdir(save))
    assert [r['epoch'] for r in runs['cached']] == [1, 2, 3]
    assert runs['cached'] == runs['streamed']
