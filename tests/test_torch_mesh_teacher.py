"""The VIPE* teacher on the port's mesh against vpd_tpu's, on the CPU.

- Data parallel (the two-process twin of tests/test_cross_host.py): two
  gloo ranks, each stepping on its rows of the global batch, against
  vpd_tpu's step on a 2-device data mesh, float64 at dropout 0: loss
  sums to rel 1e-9, the gradients before AdamW to 1e-7 of their norm, BN
  statistics and parameters as tests/test_torch_vipe.py holds them. With
  dropout on, the ranks draw the global batch's masks and give the
  one-process step.
- Tensor parallel on a (1, 2) grid against vpd_tpu's (data, model) mesh:
  the port splits the parameters vpd_tpu's rule splits, and the step
  gives vpd_tpu's loss (rtol 1e-5; float64, so held at 1e-9),
  gradients and state. A `VIPETrainer` on the grid writes whole-array
  checkpoints that vpd_tpu reads and that equal, byte for byte, what a
  one-device trainer writes for the same arrays; a resumed grid trainer
  restores every block and moment.
- `train_vipe --tensor_parallel 2` on two ranks gives the one-process
  CLI's losses (rtol 1e-5, float32, dropout on: the grid draws the whole
  masks and slices them) and writes a teacher `apply_vipe` serves.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import torch_mesh_workers as W
from test_torch_apply_vipe import _cli_kwargs, mocap  # noqa: F401
from test_torch_vipe import (DEC, EMB, HID, IN_DIM, PARAM_TOL, PRE_BN_TOL,
                             _feeds_bn, init_variables, jax_model,
                             make_batcher, port_model)
from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.core import mesh as jmesh
from vpd_tpu.train import vipe as jvipe
from vpd_tpu_torch.core import checkpoint as tckpt
from vpd_tpu_torch.core import mesh as tmesh
from vpd_tpu_torch.models.flax_weights import (load_vipe_from_flax,
                                               vipe_params_from_flax,
                                               vipe_params_to_flax)
from vpd_tpu_torch.infer import apply_vipe as tapply
from vpd_tpu_torch.tools import train_vipe as tcli
from vpd_tpu_torch.train import vipe_loop as tloop

torch.set_num_threads(2)

LOSS_RTOL = 1e-9
GRAD_RTOL = 1e-7
SHAPES = dict(emb=EMB, hidden=HID, dec=DEC, in_dim=IN_DIM)


def _plain(tree):
    if hasattr(tree, 'items'):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax_steps(batcher, batches, lr, mesh, tensor_parallel=False):
    """vpd_tpu's float64 steps on `mesh`: loss sums, the first step's
    gradient (AdamW's first moment is 0.1 g), the final trees and the
    initial variables."""
    kp_mask = batcher.kp_mask()
    with jax.enable_x64():
        jmodel = jax_model(batcher.kp_dims, dtype=jnp.float64)
        params, stats = init_variables(jmodel, batches[0],
                                       np.random.default_rng(1), np.float64)
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        state = jvipe.VIPETrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), tx=tx)
        specs = None
        if tensor_parallel:
            specs = jmesh.tensor_parallel_shardings(params, mesh)
            state = jmesh.apply_tensor_parallel(state, mesh)
        else:
            state = jmesh.replicate(state, mesh)
        step = jvipe.make_train_step(jmodel, kp_mask.astype(np.float64))
        losses, grads = [], None
        for b in batches:
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in b.items()}
            state, m = step(state, jmesh.shard_batch(b, mesh),
                            jax.random.key(1))
            losses.append(float(m['loss_sum']))
            if grads is None:
                grads = jax.tree_util.tree_map(
                    lambda mu: np.asarray(mu) / 0.1, state.opt_state[0].mu)
        return (losses, grads, jax.tree_util.tree_map(
            np.asarray, (state.params, state.batch_stats)),
            {'params': params, 'batch_stats': stats}, specs)


def _check_against(run, batcher, jgrads, jtrees, variables, lr):
    model = port_model(batcher.kp_dims).double()
    load_vipe_from_flax(model, variables)
    init = {k: v.numpy() for k, v in model.state_dict().items()}
    want = {k: v.numpy() for k, v in vipe_params_from_flax(
        model, jgrads).items()}
    total = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    for k, g in run['grads'].items():
        assert np.linalg.norm(g - want[k]) <= GRAD_RTOL * (
            np.linalg.norm(want[k]) + total), k
    ref = port_model(batcher.kp_dims).double()
    load_vipe_from_flax(ref, {'params': jtrees[0], 'batch_stats': jtrees[1]})
    ref = {k: v.numpy() for k, v in ref.state_dict().items()}
    for name, t in run['state'].items():
        if name.endswith('num_batches_tracked'):
            continue
        err = np.linalg.norm(t - ref[name])
        if name.endswith(('running_mean', 'running_var')):
            assert err <= PARAM_TOL * np.linalg.norm(ref[name]), name
        elif _feeds_bn(name):
            assert err <= PRE_BN_TOL * lr, (name, err)
        else:
            delta = np.linalg.norm(ref[name] - init[name])
            assert err <= PARAM_TOL * delta + 1e-9, (name, err, delta)


def test_data_parallel_teacher_matches_vpd_tpu_mesh(tmp_path):
    lr = 1e-3
    batcher = make_batcher(8)
    batches = [batcher.next_batch() for _ in range(2)]
    jlosses, jgrads, jtrees, variables, _ = _jax_steps(
        batcher, batches, lr, jmesh.get_mesh(jax.devices()[:2]))
    shapes = dict(SHAPES, kp_dims=batcher.kp_dims)
    ranks = W.run_ranks(W.teacher_steps, 2, tmp_path, _plain(variables),
                        shapes, batcher.kp_mask(), batches, lr,
                        dropouts=(0., 0.2))
    np.testing.assert_allclose(
        np.add(ranks[0][0]['losses'], ranks[1][0]['losses']), jlosses,
        rtol=LOSS_RTOL)
    for r in ranks:
        _check_against(r[0], batcher, jgrads, jtrees, variables, lr)
    # dropout: the global batch's masks, as one process draws them
    one = W.teacher_steps(tmesh.get_mesh('cpu'), _plain(variables), shapes,
                          batcher.kp_mask(), batches, lr,
                          dropouts=(0.2,))[0]
    np.testing.assert_allclose(
        np.add(ranks[0][1]['losses'], ranks[1][1]['losses']),
        one['losses'], rtol=LOSS_RTOL)
    for name, t in one['state'].items():
        np.testing.assert_allclose(ranks[1][1]['state'][name], t,
                                   rtol=1e-7, atol=1e-9, err_msg=name)


def test_tensor_parallel_teacher_matches_vpd_tpu_grid(tmp_path):
    lr = 1e-3
    batcher = make_batcher(8)
    batches = [batcher.next_batch() for _ in range(2)]
    grid = jmesh.get_mesh_2d(2, devices=jax.devices()[:2])
    jlosses, jgrads, jtrees, variables, specs = _jax_steps(
        batcher, batches, lr, grid, tensor_parallel=True)
    shapes = dict(SHAPES, kp_dims=batcher.kp_dims)
    ranks = W.run_ranks(W.teacher_steps, 2, tmp_path, _plain(variables),
                        shapes, batcher.kp_mask(), batches, lr,
                        model_group=2)
    for r in ranks:
        run = r[0]
        # the model rank's loss is the whole batch's (rtol 1e-5 is the
        # JAX test's bar; float64 holds it to 1e-9)
        np.testing.assert_allclose(run['losses'], jlosses, rtol=LOSS_RTOL)
        _check_against(run, batcher, jgrads, jtrees, variables, lr)
    # the split parameters are the ones vpd_tpu's rule splits
    model = port_model(batcher.kp_dims)
    marks = {n: torch.full_like(p, float(n in ranks[0][0]['sharded']))
             for n, p in model.named_parameters()}
    got = jax.tree_util.tree_map(lambda a: bool(np.all(a == 1)),
                                 vipe_params_to_flax(model, marks))
    want = jax.tree_util.tree_map(lambda s: jmesh.MODEL_AXIS in tuple(s.spec),
                                  specs)
    assert _plain(got) == _plain(want)
    assert any(jax.tree_util.tree_leaves(got))


def test_tensor_parallel_trainer_checkpoints(tmp_path):
    batcher = make_batcher(8)
    batches = [batcher.next_batch() for _ in range(3)]
    config = tloop.default_config(
        ['human36m', 'amass', '3dpeople_pair'], [(20, 7), (20, 7), None],
        [np.ones(20), np.ones(20), None], num_epochs=1, embedding_dim=EMB,
        encoder_arch=(1, HID), decoder_arch=(2, DEC), checkpoint_frequency=1)
    save = str(tmp_path / 'tp')
    ranks = W.run_ranks(W.teacher_trainer_tp, 2, tmp_path / 'r', config,
                        batches, batcher.kp_dims, batcher.kp_mask(), save)
    assert ranks[0]['loss'] == ranks[1]['loss']
    assert all(r['same'] and r['step'] == 2 for r in ranks)
    comps = ('encoder', 'decoder-3d', 'optimizer')
    for comp in comps:  # vpd_tpu's reader takes the whole arrays
        tree = tckpt.load_component(save, 'epoch0001', comp)
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               jckpt.load_component(save, 'epoch0001', comp,
                                                    tree), tree)
    # a one-device trainer writes the same bytes for the same arrays
    one = tloop.VIPETrainer(W._Batches(batches, batcher.kp_dims,
                                       batcher.kp_mask()), None, config,
                            save_dir=save, device='cpu')
    one.load_model('epoch0001')
    one.save_model('again')
    one.close()
    for comp in comps:
        with open(os.path.join(save, 'epoch0001.{}.ckpt'.format(comp)),
                  'rb') as a, \
                open(os.path.join(save, 'again.{}.ckpt'.format(comp)),
                     'rb') as b:
            assert a.read() == b.read(), comp


def test_train_vipe_cli_tensor_parallel_on_two_ranks(mocap, tmp_path):
    kw = _cli_kwargs(None, num_epochs=1, encoder_arch=(1, 16),
                     decoder_arch=(2, 16))
    del kw['save_dir']
    one = tcli.main(save_dir=str(tmp_path / 'one'), **kw)
    want = [(r['train'], r['val']) for r in one.losses]
    save = str(tmp_path / 'tp')
    ranks = W.run_ranks(W.train_vipe_cli, 2, tmp_path / 'r', mocap, save,
                        dict(kw, tensor_parallel=2))
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0], want, rtol=1e-5)
    # the grid wrote whole arrays: the served encoder has every weight
    model, _ = tapply.load_model_dir(save, device='cpu')
    assert sum(p.numel() for p in model.parameters()) == sum(
        p.numel() for p in one.model.encoder.parameters())
