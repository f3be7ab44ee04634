"""The port's VIPE* teacher model and step against vpd_tpu's on the CPU.

- Encoder and decoder outputs in eval mode from the same weights (carried
  by `load_vipe_from_flax`), within 1e-5 in float32.
- The train step: three AdamW steps at dropout 0 and B = 8 in float64
  (`jax.enable_x64`): losses to rel 1e-9; parameters to 1e-7 of how far
  they moved (plus 1e-9); BN running statistics (chained over the three
  encoder passes) and AdamW's moments to rel 1e-7. The biases that feed a
  BatchNorm have a zero gradient up to rounding in both packages (their
  moments under 1e-10) and are held to 1e-5 of lr.
- Dropout: the train-mode forward on flax's own masks (read from its
  Dropout outputs and fed to the port) gives vpd_tpu's embeddings,
  predictions and running statistics within 1e-5; the seeded masks
  repeat for the same (seed, step).
- The eval step's metrics, per-dataset sums included, and `run_epoch`'s.
- The positive hinge at e1 == e2 has finite gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from synth import make_synth_family
from vpd_tpu.data.vipe_sampler import FAMILIES, FusedBatcher, \
    PairwiseSampler, VIPESampler
from vpd_tpu.models import FCPoseDecoder as JDecoder
from vpd_tpu.models import FCResNet as JResNet
from vpd_tpu.models.fc import FCResNetPoseDecoder as JResDecoder
from vpd_tpu.train import vipe as jvipe
from vpd_tpu.train import vipe_loop as jloop
from vpd_tpu_torch.models.fc import (FCPoseDecoder, FCResNet, FlaxDropout,
                                     FCResNetPoseDecoder, set_dropout_draw)
from vpd_tpu_torch.models.flax_weights import (load_vipe_from_flax,
                                               vipe_params_from_flax,
                                               vipe_params_to_flax,
                                               vipe_to_flax)
from vpd_tpu_torch.train import vipe as tvipe
from vpd_tpu_torch.train import vipe_loop as tloop
from vpd_tpu_torch.train.vpd import create_state

torch.set_num_threads(2)

EMB, HID, DEC = 8, 64, 32
IN_DIM = 39
LOSS_RTOL = 1e-9
PARAM_TOL = 1e-7
# A Dense bias right before a BatchNorm gets a gradient of zero up to
# rounding (BN takes the mean out), which AdamW scales by 1 / eps: such
# biases move by weight decay and by rounding, and are held to 1e-5 of lr.
PRE_BN_TOL = 1e-5


def _feeds_bn(name):
    """Whether parameter `name` is the bias of a Dense layer feeding a
    BatchNorm (the residual blocks' `dense.j`)."""
    return '.blocks.' in name and '.dense.' in name and name.endswith(
        '.bias')


def make_batcher(batch_size=8, seed=0):
    """human36m + amass + a pairwise family (has_3d 0 rows, zero negatives
    with neg_valid 0)."""
    samplers = []
    for i, fam in enumerate(['human36m', 'amass']):
        seqs, poses = make_synth_family(fam, seed=i)
        samplers.append(VIPESampler(FAMILIES[fam], seqs, poses,
                                    target_len=40, seed=seed + i))
    seqs, _ = make_synth_family('3dpeople', seed=5)
    samplers.append(PairwiseSampler(seqs, target_len=20, seed=seed + 2))
    return FusedBatcher(samplers, batch_size)


def _randomized(tree, rng, dtype):
    """Copy of a flax tree in `dtype`; BN statistics and affine terms
    random (init's 0/1 would hide a mapping error)."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _randomized(x, rng, dtype)
        elif k == 'mean':
            out[k] = rng.normal(0, 0.1, np.shape(x)).astype(dtype)
        elif k == 'var':
            out[k] = rng.uniform(0.5, 2., np.shape(x)).astype(dtype)
        elif k == 'scale':
            out[k] = rng.uniform(0.5, 1.5, np.shape(x)).astype(dtype)
        elif k == 'bias':
            out[k] = rng.normal(0, 0.1, np.shape(x)).astype(dtype)
        else:
            out[k] = np.asarray(x, dtype)
    return out


def jax_model(kp_dims, dropout=0., dtype=jnp.float32, resnet_decoder=False):
    targets = tuple(max(d, 1) for d in kp_dims)
    if resnet_decoder:
        dec = JResDecoder(num_blocks=1, hidden_dim=DEC, target_dims=targets,
                          dtype=dtype)
    else:
        dec = JDecoder(hidden_dims=(DEC, DEC), target_dims=targets,
                       dtype=dtype)
    return jvipe.VIPEModel(
        encoder=JResNet(out_dim=EMB, num_blocks=2, hidden_dim=HID,
                        dropout=dropout, dtype=dtype), decoder=dec)


def port_model(kp_dims, dropout=0., resnet_decoder=False):
    targets = tuple(max(d, 1) for d in kp_dims)
    dec = (FCResNetPoseDecoder(EMB, 1, DEC, targets) if resnet_decoder
           else FCPoseDecoder(EMB, (DEC, DEC), targets))
    return tvipe.VIPEModel(FCResNet(IN_DIM, EMB, 2, HID, dropout=dropout),
                           dec)


def init_variables(jmodel, batch, rng, dtype=np.float32):
    v = jmodel.init(jax.random.key(0), batch, train=False)
    return (_randomized(jax.tree_util.tree_map(np.asarray, v['params']), rng,
                        dtype),
            _randomized(jax.tree_util.tree_map(np.asarray,
                                               v['batch_stats']), rng, dtype))


def to_torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize('resnet_decoder', [False, True])
def test_eval_outputs_match_vpd_tpu(resnet_decoder):
    batcher = make_batcher(16)
    batch = batcher.next_batch()
    jmodel = jax_model(batcher.kp_dims, resnet_decoder=resnet_decoder)
    params, stats = init_variables(jmodel, batch, np.random.default_rng(0))
    variables = {'params': params, 'batch_stats': stats}
    want = jmodel.apply(variables, batch, train=False)

    model = port_model(batcher.kp_dims, resnet_decoder=resnet_decoder)
    load_vipe_from_flax(model, variables)
    with torch.no_grad():
        got = model.eval()(to_torch(batch))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the mapping round-trips, leaf for leaf
    back = vipe_to_flax(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)


def test_build_model_matches_vpd_tpu_shapes():
    """`build_model` makes vpd_tpu's parameter tree (its decoder padded
    to depth 2 for decoder_arch (1, h)) with the port's init."""
    batcher = make_batcher(16)
    for arch in ((1, DEC), (3, DEC)):
        cfg = jloop.default_config(['a', 'b', 'c'], [None] * 3, [None] * 3,
                                   embedding_dim=EMB, encoder_arch=(2, HID),
                                   decoder_arch=arch)
        v = jloop.build_model(cfg, batcher.kp_dims).init(
            jax.random.key(0), batcher.next_batch(), train=False)
        tree = vipe_to_flax(tloop.build_model(cfg, batcher.kp_dims))
        shapes = jax.tree_util.tree_map(np.shape, v)
        assert jax.tree_util.tree_map(np.shape, tree) == {
            'params': shapes['params'], 'batch_stats': shapes['batch_stats']}
    dropouts = [m.rate for m in tloop.build_model(cfg, batcher.kp_dims)
                .modules() if isinstance(m, FlaxDropout)]
    assert dropouts == [0.2, 0.2, 0.]  # the encoder's 2 blocks; decoder


def test_f64_train_trajectory_matches_vpd_tpu():
    """Three train steps at dropout 0, B = 8, float64 in both packages.
    Running statistics pin flax's biased variance and the chaining over
    the three encoder passes (the zero negatives of the pairwise rows
    enter the third pass's statistics)."""
    n_steps, lr = 3, 1e-3
    batcher = make_batcher(8)
    batches = [batcher.next_batch() for _ in range(n_steps)]
    assert (batches[0]['neg_valid'] == 0).any()
    kp_mask = batcher.kp_mask()
    with jax.enable_x64():
        jmodel = jax_model(batcher.kp_dims, dtype=jnp.float64)
        params, stats = init_variables(jmodel, batches[0],
                                       np.random.default_rng(1), np.float64)
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        jstate = jvipe.VIPETrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), tx=tx)
        step = jvipe.make_train_step(jmodel, kp_mask.astype(np.float64))
        jlosses = []
        for b in batches:
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in b.items()}
            jstate, m = step(jstate, b, jax.random.key(1))
            jlosses.append(float(m['loss_sum']))
        jparams, jstats, jopt = jax.tree_util.tree_map(
            np.asarray, (jstate.params, jstate.batch_stats,
                         jstate.opt_state[0]))

    model = port_model(batcher.kp_dims).double()
    load_vipe_from_flax(model, {'params': params, 'batch_stats': stats})
    state = create_state(model, lr)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    tstep = tvipe.make_train_step(kp_mask)
    losses = [float(tstep(state, to_torch(b, torch.float64), 0)['loss_sum'])
              for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert state.step == n_steps

    ref = port_model(batcher.kp_dims).double()
    load_vipe_from_flax(ref, {'params': jparams, 'batch_stats': jstats})
    ref = ref.state_dict()
    for name, t in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        err = (t - ref[name]).norm().item()
        if name.endswith(('running_mean', 'running_var')):
            assert err <= PARAM_TOL * ref[name].norm().item(), name
        elif _feeds_bn(name):
            assert err <= PRE_BN_TOL * lr, (name, err)
        else:
            delta = (ref[name] - init[name]).norm().item()
            assert err <= PARAM_TOL * delta + 1e-9, (name, err, delta)
    opt = state.optimizer.state
    for key, torch_key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        want = vipe_params_from_flax(model, getattr(jopt, key))
        got = {name: opt[p][torch_key]
               for name, p in model.named_parameters()}
        for name, t in got.items():
            if _feeds_bn(name):  # both zero up to rounding
                assert max(t.norm().item(),
                           want[name].norm().item()) <= 1e-10, (key, name)
            else:
                assert (t - want[name]).norm().item() <= \
                    PARAM_TOL * want[name].norm().item() + 1e-30, (key, name)
        # and through optax's layout and back, exactly
        back = vipe_params_from_flax(model, vipe_params_to_flax(model, got))
        assert all(torch.equal(back[n], got[n]) for n in got)
    assert int(jopt.count) == n_steps


def _dropout_masks(intermediates):
    """flax's keep masks, in the order the port draws them: per encoder
    pass (pose1, pose2, pose_neg), per block, per dropout."""
    enc = intermediates['encoder']
    return [np.asarray(enc['FcResidualBlock_{}'.format(b)][
        'Dropout_{}'.format(j)]['__call__'][call]) != 0
        for call in range(3) for b in range(2) for j in range(2)]


def test_dropout_on_flax_masks_matches_vpd_tpu():
    batcher = make_batcher(16)
    batch = batcher.next_batch()
    jmodel = jax_model(batcher.kp_dims, dropout=0.3)
    params, stats = init_variables(jmodel, batch, np.random.default_rng(2))
    out, mutated = jmodel.apply(
        {'params': params, 'batch_stats': stats}, batch, train=True,
        rngs={'dropout': jax.random.key(7)},
        mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    masks = _dropout_masks(mutated['intermediates'])
    # nonzero outputs: kept (0.7) and positive after the ReLU (about half)
    assert 0.25 < np.mean([m.mean() for m in masks]) < 0.45

    model = port_model(batcher.kp_dims, dropout=0.3)
    load_vipe_from_flax(model, {'params': params, 'batch_stats': stats})
    fed = iter(masks)
    drawn = []

    def draw(shape, keep, device):
        assert keep == pytest.approx(0.7)
        mask = torch.from_numpy(next(fed))
        assert tuple(mask.shape) == tuple(shape)
        drawn.append(mask)
        return mask

    set_dropout_draw(model, draw)
    with torch.no_grad():
        got = model.train()(to_torch(batch))
    assert len(drawn) == len(masks)
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    tree = vipe_to_flax(model)['batch_stats']
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6),
        tree, jax.tree_util.tree_map(np.asarray, mutated['batch_stats']))

    # eval mode and rate 0 draw nothing, train mode without a mask source
    # raises; the train step's seeded masks repeat for the same (seed, step)
    set_dropout_draw(model, None)
    x = torch.randn(4, HID)
    d = FlaxDropout(0.5)
    assert torch.equal(d.eval()(x), x) and torch.equal(
        FlaxDropout(0.).train()(x), x)
    with pytest.raises(RuntimeError, match='set_dropout_draw'):
        d.train()(x)
    runs = []
    for _ in range(2):
        m = port_model(batcher.kp_dims, dropout=0.3)
        load_vipe_from_flax(m, {'params': params, 'batch_stats': stats})
        state = create_state(m, 1e-3)
        state.step = 5
        tvipe.make_train_step(batcher.kp_mask())(state, to_torch(batch), 3)
        runs.append(torch.cat([p.detach().reshape(-1)
                               for p in m.parameters()]))
    assert torch.equal(runs[0], runs[1])


def test_eval_metrics_and_epoch_match_vpd_tpu():
    batcher = make_batcher(16)
    kp_mask = batcher.kp_mask()
    batches = [batcher.next_batch() for _ in range(2)]
    jmodel = jax_model(batcher.kp_dims)
    params, stats = init_variables(jmodel, batches[0],
                                   np.random.default_rng(3))
    jstate = jvipe.VIPETrainState(step=0, params=params, batch_stats=stats,
                                  opt_state=None, tx=None)
    jstep = jvipe.make_eval_step(jmodel, kp_mask)
    model = port_model(batcher.kp_dims)
    load_vipe_from_flax(model, {'params': params, 'batch_stats': stats})
    state = create_state(model, 1e-3)
    step = tvipe.make_eval_step(kp_mask)
    for b in batches:
        want = jax.tree_util.tree_map(np.asarray, jstep(jstate, b))
        got = step(state, to_torch(b))
        assert got['n'] == float(want['n']) == batcher.batch_size
        for k in ('loss_sum', 'contra_sum', 'ds_loss_sum', 'ds_count'):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                       err_msg=k)
        assert got['ds_count'].tolist() == batcher.rows

    class Replay:
        def __init__(self, items):
            self.items = iter(items)

        def next_batch(self):
            return next(self.items)

    _, jm = jvipe.run_epoch(Replay(batches), jstate, jstep, 2, train=False)
    tm = tvipe.run_epoch(Replay([to_torch(b) for b in batches]), state,
                         step, 2, train=False)
    assert set(tm['per_dataset']) == {0, 1, 2}
    for k in ('loss', 'contra'):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(tm['per_dataset'][i],
                                   jm['per_dataset'][i], rtol=1e-5)


def test_hinge_at_equal_embeddings_has_finite_gradients():
    """pose2 = pose_neg = pose1 at dropout 0: e1 == e2 == e_neg, so the
    positive hinge is sqrt(1e-12) a row and the negative one 1 - 1e-6;
    every gradient is finite (a plain norm would give nan)."""
    batcher = make_batcher(16)
    batch = batcher.next_batch()
    batch['pose2'] = batch['pose1'].copy()
    batch['pose_neg'] = batch['pose1'].copy()
    batch['neg_valid'] = np.ones_like(batch['neg_valid'])
    batch['has_3d'] = np.zeros_like(batch['has_3d'])
    model = port_model(batcher.kp_dims)
    state = create_state(model, 1e-3)
    m = tvipe.make_train_step(batcher.kp_mask())(state, to_torch(batch), 0)
    np.testing.assert_allclose(float(m['contra_sum']), batcher.batch_size,
                               rtol=1e-5)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    assert all(torch.isfinite(p).all() for p in model.parameters())
