"""The port's data mesh (`vpd_tpu_torch/core/mesh.py`) against vpd_tpu's.

vpd_tpu runs one process over a `Mesh` of the conftest's CPU devices; the
port runs its ranks as spawned gloo processes (`torch_mesh_workers`).

- The helpers: vpd_tpu's shape rule for tensor parallelism, member
  padding, `pad_batch_to`, batch splitting; the epoch metrics' sums run
  on the mesh's device.
- The synced BatchNorm at world 2 gives the one-process module's output,
  input gradient, affine gradients and running statistics on the
  concatenated batch (float64, rtol 1e-9).
- The student's update (ResNet-18 + motion head, RGB + flow, float64) on
  two ranks against vpd_tpu's on a 2-device mesh: losses to rel 1e-9,
  the gradients before AdamW to 1e-7 of their norm, BN statistics and
  parameters as tests/test_torch_train.py holds them. The same update
  with DDP's default mean (gradients halved) fails the gradient bar while
  its parameters stay within 2.5 lr of the reference: the parameter bar
  alone cannot see it.
- The fused train step's draws: two ranks draw the global batch's
  augmentation and keep their rows, giving the one-process step (float64,
  both jitter orders).
- The row-sharded device cache: each rank stages its rows, zero-padded,
  and the sampler homes every batch block on its rank, as vpd_tpu's;
  `train_vpd --hbm_cache_sharded` on two ranks; the gloo dry run.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_workers as W
from test_torch_train import _randomized
from test_vpd import IMG, setup_dataset
from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.core import mesh as jmesh
from vpd_tpu.data.crops import train_val_split
from vpd_tpu.data.hbm_cache import CacheIndexSource as JCacheIndexSource
from vpd_tpu.data.hbm_cache import DeviceCropCache as JDeviceCropCache
from vpd_tpu.data.shards import ShardReader as JShardReader
from vpd_tpu.data.shards import pack_crops
from vpd_tpu.train import vpd as jvpd
from vpd_tpu.train import vpd_loop as jloop
from vpd_tpu_torch.core import checkpoint as tckpt
from vpd_tpu_torch.core import mesh as tmesh
from vpd_tpu_torch.data.hbm_cache import CacheIndexSource
from vpd_tpu_torch.tools import dryrun_multichip as tdry

torch.set_num_threads(2)

EMB = 6
LOSS_RTOL = 1e-9
GRAD_RTOL = 1e-7
PARAM_TOL = 1e-7


# ------------------------------------------------------------- helpers

def test_tensor_parallel_rule_matches_vpd_tpu():
    tree = {'wide_kernel': np.zeros((48, 64), np.float32),
            'bias': np.zeros(64, np.float32),
            'tiny': np.zeros(3, np.float32),
            'odd': np.zeros((8, 7), np.float32),
            'scalar': np.float32(0)}
    jm = jmesh.get_mesh_2d(2, devices=jax.devices()[:4])
    want = {k: tuple(v.spec) for k, v in
            jmesh.tensor_parallel_shardings(tree, jm).items()}
    grid = tmesh.Mesh(torch.device('cpu'), world=4, data_size=2,
                      model_size=2, axis_names=(tmesh.DATA_AXIS,
                                                tmesh.MODEL_AXIS))
    assert tmesh.tensor_parallel_shardings(tree, grid) == want
    assert grid.shape == {'data': 2, 'model': 2}
    assert tmesh.get_mesh('cpu').shape == {'data': 1}


def test_metric_sums_run_on_the_mesh_device(monkeypatch):
    """The epoch metrics' all-reduce gets a tensor on the mesh's device
    (NCCL refuses host tensors): 'meta' stands in for a card here."""

    class Reduced(Exception):
        pass

    class Dist:
        def all_reduce(self, t, group=None):
            raise Reduced(t.device, t.dtype, group)

    monkeypatch.setattr(tmesh, '_dist', Dist)
    group = object()
    mesh = tmesh.Mesh(torch.device('meta'), world=2, data_size=2,
                      data_group=group)
    with pytest.raises(Reduced) as seen:
        tmesh.all_reduce_sum([1., 2.], mesh)
    assert seen.value.args == (torch.device('meta'), torch.float64, group)


@pytest.mark.parametrize('n,members', [(2, 3), (4, 5), (2, 4)])
def test_member_axis_placement_pads_as_vpd_tpu(n, members):
    jm = jmesh.get_mesh(jax.devices()[:n])
    _, want, _, _ = jmesh.member_axis_placement(jm, list(range(members)))
    blocks = []
    for r in range(n):
        rank = tmesh.Mesh(torch.device('cpu'), world=n, rank=r,
                          data_size=n, data_rank=r)
        mesh, got, put_m, put_r = tmesh.member_axis_placement(
            rank, list(range(members)))
        assert mesh is rank and got == want
        blocks += put_m(got)
        assert put_r(got) is got
    assert blocks == want
    one = tmesh.Mesh(torch.device('cpu'))
    assert tmesh.member_axis_placement(one, [1, 2, 3])[:2] == (None,
                                                                [1, 2, 3])


def test_batch_helpers_match_vpd_tpu():
    batch = {'a': np.arange(6).reshape(3, 2), 'b': np.ones(3)}
    want = jmesh.pad_batch_to(batch, 5, pad_mask_key='real')
    got = tmesh.pad_batch_to(batch, 5, pad_mask_key='real')
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tmesh.local_batch_size(8, tmesh.Mesh(torch.device('cpu'),
                                                world=4, data_size=4)) == 2
    with pytest.raises(ValueError, match='not divisible'):
        tmesh.part_rows(6, (0, 4))
    rank1 = tmesh.Mesh(torch.device('cpu'), world=2, rank=1, data_size=2,
                       data_rank=1)
    local = tmesh.shard_batch({'x': np.arange(8), 'none': None}, rank1)
    assert local['x'].tolist() == [4, 5, 6, 7] and local['none'] is None


def test_data_parallel_refuses_several_gpus_outside_torchrun(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    with pytest.raises(SystemExit, match='torchrun'):
        tmesh.refuse_devices_without_torchrun('cuda')
    tmesh.refuse_devices_without_torchrun('cpu')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    tmesh.refuse_devices_without_torchrun('cuda')


# ----------------------------------------------------------- BatchNorm

def test_synced_batchnorm_matches_one_process(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(1., 2., (6, 3, 4, 5))
    gy = rng.normal(size=x.shape)
    w, b = rng.uniform(0.5, 1.5, 3), rng.normal(size=3)
    ranks = W.run_ranks(W.synced_bn, 2, tmp_path, x, w, b, gy)
    one = W.synced_bn(tmesh.get_mesh('cpu'), x, w, b, gy)
    for key in ('y', 'gx'):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]),
                                   one[key], rtol=1e-9, atol=1e-12)
    for key in ('gw', 'gb'):  # each rank's share of the summed loss
        np.testing.assert_allclose(sum(r[key] for r in ranks), one[key],
                                   rtol=1e-9)
    for r in ranks:
        for key in ('mean', 'var'):
            np.testing.assert_allclose(r[key], one[key], rtol=1e-9)


# ------------------------------------------------------------- student

def _jax_update_on_mesh(cfg, params, stats, imgs, emb, lr, n_steps):
    """vpd_tpu's `apply_train_update` jitted over a 2-device data mesh:
    losses, the first step's gradient (AdamW's first moment is 0.1 g)
    and the final trees."""
    mesh = jmesh.get_mesh(jax.devices()[:2])
    with jax.enable_x64():
        jmodel = jvpd.VPDStudent(
            encoder=jloop.build_encoder('resnet18', EMB, dtype=jnp.float64),
            motion=jvpd.MotionHead(EMB, dtype=jnp.float64))
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        state = jmesh.replicate(jvpd.VPDTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), tx=tx), mesh)
        x, e = jmesh.shard_batch((imgs, emb), mesh)
        update = jax.jit(lambda s, x, e: jvpd.apply_train_update(
            jmodel, s, x, e, jax.random.key(1)))
        losses, grads = [], None
        for _ in range(n_steps):
            state, m = update(state, x, e)
            losses.append(float(m['emb_loss_sum']))
            if grads is None:
                grads = jax.tree_util.tree_map(
                    lambda mu: np.asarray(mu) / 0.1, state.opt_state[0].mu)
        return losses, grads, jax.tree_util.tree_map(
            np.asarray, (state.params, state.batch_stats))


@pytest.fixture(scope='module')
def student_trees():
    """A student's config and float64 flax trees (random BN terms)."""
    rng = np.random.default_rng(0)
    cfg = jloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch='resnet18',
                               learning_rate=1e-3)
    with jax.enable_x64():
        jmodel = jvpd.VPDStudent(
            encoder=jloop.build_encoder('resnet18', EMB, dtype=jnp.float64),
            motion=jvpd.MotionHead(EMB, dtype=jnp.float64))
        v = jax.jit(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, IMG, IMG, 5)), train=False))()
    params = _randomized(jax.tree_util.tree_map(np.asarray, v['params']),
                         rng)
    stats = _randomized(jax.tree_util.tree_map(np.asarray,
                                               v['batch_stats']), rng)
    return cfg, params, stats


def _grads_close(got, want, rtol):
    """Each gradient within rtol of its own norm plus rtol of the whole
    gradient's norm."""
    total = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    return all(np.linalg.norm(got[k] - want[k])
               <= rtol * (np.linalg.norm(want[k]) + total) for k in want)


def test_student_update_on_two_ranks_matches_vpd_tpu_mesh(student_trees,
                                                         tmp_path):
    n_steps, lr = 1, 1e-3
    rng = np.random.default_rng(0)
    imgs = rng.normal(0, 1, (4, IMG, IMG, 5))
    emb = rng.normal(0, 1, (4, 2 * EMB))
    cfg, params, stats = student_trees
    jlosses, jgrads, (jparams, jstats) = _jax_update_on_mesh(
        cfg, params, stats, imgs, emb, lr, n_steps)

    runs = W.run_ranks(W.student_update, 2, tmp_path, cfg, params, stats,
                       imgs, emb, lr, n_steps, grad_scales=(1., 0.5))
    model = W.port_student(cfg, params, stats)
    init = W.numpy_state(model)
    ref = W.numpy_state(W.port_student(cfg, jparams, jstats))
    from vpd_tpu_torch.models.flax_weights import student_params_from_flax
    want_grads = {k: v.numpy() for k, v in student_params_from_flax(
        model, jgrads).items()}

    summed, mean = runs[0]
    np.testing.assert_allclose(
        np.add(summed['losses'], runs[1][0]['losses']), jlosses,
        rtol=LOSS_RTOL)
    for r in runs:  # both ranks hold the global gradient and state
        assert _grads_close(r[0]['grads'], want_grads, GRAD_RTOL)
        for name, t in r[0]['state'].items():
            if name.endswith('num_batches_tracked'):
                continue
            err = np.linalg.norm(t - ref[name])
            if name.endswith(('running_mean', 'running_var')):
                assert err <= PARAM_TOL * np.linalg.norm(ref[name]), name
            else:
                delta = np.linalg.norm(ref[name] - init[name])
                assert err <= PARAM_TOL * delta + 1e-9, (name, err, delta)
    # DDP's default hook averages over the world: the gradient bar
    # catches it, a bar on the parameters alone would not
    assert not _grads_close(mean['grads'], want_grads, 1e-3)
    for name, t in mean['state'].items():
        if not name.endswith(('running_mean', 'running_var',
                              'num_batches_tracked')):
            assert np.abs(t - ref[name]).max() <= 2.5 * lr, name


def test_train_step_draws_the_global_batch(student_trees, tmp_path):
    """Two ranks of `make_train_step` (jitter, mask noise, crops, flips
    drawn for the global batch and sliced) give the one-process step on
    the whole batch, float64, in both jitter orders."""
    rng = np.random.default_rng(1)
    cfg, params, stats = student_trees
    b = 4
    batch = {'rgb': rng.integers(0, 255, (b, IMG, IMG, 3), dtype=np.uint8),
             'flow': rng.integers(0, 255, (b, IMG, IMG, 3), dtype=np.uint8),
             'mask': rng.integers(0, 2, (b, IMG, IMG), dtype=np.uint8),
             'emb': rng.normal(size=(b, 2 * EMB)),
             'flip': rng.integers(0, 2, b).astype(bool)}
    orders = ('batch', 'per_sample')
    ranks = W.run_ranks(W.student_step, 2, tmp_path, cfg, params, stats,
                        batch, 7, 1, orders=orders)
    for i, order in enumerate(orders):
        one = W.student_step(tmesh.get_mesh('cpu'), cfg, params, stats,
                             batch, 7, 1, orders=(order,))[0]
        np.testing.assert_allclose(
            ranks[0][i]['losses'][0] + ranks[1][i]['losses'][0],
            one['losses'][0], rtol=LOSS_RTOL)
        for name, t in one['state'].items():
            np.testing.assert_allclose(ranks[1][i]['state'][name], t,
                                       rtol=1e-6, atol=1e-9, err_msg=name)


# ------------------------------------------------- the row-sharded cache

@pytest.fixture(scope='module')
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp('mesh_cache')
    samples, emb_dim, crop_dir = setup_dataset(root, mask=True)
    shard_dir = str(root / 'shards')
    pack_crops(crop_dir, shard_dir, IMG, rows_per_shard=6,
               log=lambda *a: None)
    return samples, emb_dim, crop_dir, shard_dir


def test_row_sharded_cache_matches_vpd_tpu(packed, tmp_path):
    samples, _, crop_dir, shard_dir = packed
    train, _ = train_val_split(samples)
    jm = jmesh.get_mesh(jax.devices()[:2])
    jcache = JDeviceCropCache(JShardReader(shard_dir, crop_root=crop_dir),
                              mesh=jm, shard_rows=True, log=lambda *a: None)
    jsrc = JCacheIndexSource(train, crop_dir, IMG, 8, target_len=16, seed=3,
                             cache=jcache)
    want = [jsrc.next_batch() for _ in range(2)]
    ranks = W.run_ranks(W.sharded_cache, 2, tmp_path, train, crop_dir,
                        shard_dir, IMG, 8, 2)
    per = ranks[0]['rows_per_device']
    assert per == jcache.rows_per_device
    for r, got in enumerate(ranks):
        for k, arr in got['arrays'].items():
            np.testing.assert_array_equal(
                arr, np.asarray(jcache.arrays[k])[r * per:(r + 1) * per],
                err_msg=k)
        for b, jb in zip(got['batches'], want):
            rows = slice(r * 4, (r + 1) * 4)
            for k in ('idx', 'emb', 'flip'):
                np.testing.assert_array_equal(b[k], jb[k][rows], err_msg=k)
            assert ((b['idx'] // per) == r).all()
            pixels = np.asarray(jcache.arrays['rgb'])[jb['idx'][rows]]
            np.testing.assert_array_equal(b['rgb'], pixels)


class _StubCache:
    def __init__(self, reader, n, rows_per_device):
        self.reader = reader
        self.arrays = {'rgb': None, 'mask': None}
        self.row_sharded = True
        self.rows_per_device = rows_per_device
        self.mesh = tmesh.Mesh(torch.device('cpu'), world=n, data_size=n)


def test_sharded_sampler_guards(packed):
    samples, _, crop_dir, shard_dir = packed
    from vpd_tpu_torch.data.shards import ShardReader
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    # 20 rows over 2 ranks, but every sample of video 0 comes first:
    # homes of 12 and 8 samples
    with pytest.warns(UserWarning, match='unbalanced'):
        CacheIndexSource(samples, crop_dir, IMG, 4, batch_part=(0, 2),
                         cache=_StubCache(reader, 2, 12))
    with pytest.raises(ValueError, match='no samples homed'):
        CacheIndexSource(samples, crop_dir, IMG, 4, batch_part=(0, 2),
                         cache=_StubCache(reader, 2, 20))
    with pytest.raises(ValueError, match='batch_part'):
        CacheIndexSource(samples, crop_dir, IMG, 4,
                         cache=_StubCache(reader, 2, 10))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        CacheIndexSource(samples, crop_dir, IMG, 4, batch_part=(1, 2),
                         cache=_StubCache(reader, 2, 10))


def test_train_vpd_cli_on_two_ranks(packed, tmp_path):
    """`train_vpd --hbm_cache_sharded` on two ranks for an epoch, then
    --resume to two: rank 0 alone writes, the losses are global (the same
    on both ranks) and the checkpoints load in vpd_tpu."""
    samples, _, crop_dir, shard_dir = packed
    emb_dir = os.path.join(os.path.dirname(crop_dir), 'embs')
    save = str(tmp_path / 'save')
    ranks = W.run_ranks(W.train_vpd_cli, 2, tmp_path, emb_dir, crop_dir,
                        shard_dir, save)
    assert ranks[0] == ranks[1]
    losses = json.load(open(os.path.join(save, 'loss.json')))
    assert [r['epoch'] for r in losses] == [1, 2]
    assert [(r['train'], r['val']) for r in losses] == ranks[0]
    assert np.isfinite(ranks[0]).all()
    assert json.load(open(os.path.join(save, 'config.json')))['dataset'] \
        == 'fs'
    for comp in ('encoder', 'optimizer'):  # vpd_tpu's reader takes them
        tree = tckpt.load_component(save, 'epoch0002', comp)
        jtree = jckpt.load_component(save, 'epoch0002', comp, tree)
        jax.tree_util.tree_map(np.testing.assert_array_equal, jtree, tree)


def test_dryrun_multichip_on_two_gloo_ranks():
    train, val = tdry.dryrun_multichip(2)
    assert np.isfinite(train) and np.isfinite(val)
