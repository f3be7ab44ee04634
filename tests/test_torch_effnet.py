"""The port's EfficientNet student against vpd_tpu's on the CPU.

- Tables: `round_filters` / `round_repeats`, ARCH_PARAMS, BASE_BLOCKS and
  SE_RATIO equal vpd_tpu's; for every variant b0-b7 with 3 and 5 input
  channels the port's `encoder_to_flax` tree has the names and shapes of
  vpd_tpu's `init` (`jax.eval_shape`, no compile). flax's 'SAME' padding
  at stride 2 (k 3 and 5, odd and even sizes) against `nn.Conv`.
- Forward on moved weights, the block table cut to its first three stages
  in both packages (full b0 takes minutes to compile in JAX on one CPU),
  float32: eval mode at input sizes 32 and 33, and train mode with the
  same stochastic-depth and head-dropout masks fed to both (flax's through
  `flax.linen.intercept_methods` on `nn.Dropout`), within 1e-5; the BN
  running statistics after the train-mode call within 1e-6.
- Three `apply_train_update` steps in float64 with masks fed in (two
  stages): losses to rel 1e-9, parameters to 1e-7 of how far they moved
  (plus 1e-9), as tests/test_torch_train.py holds ResNet. vpd_tpu's head
  casts to float32 by name (`jnp.float32`), which the test maps to
  float64.
- bf16: the port's embedding error against its float32 is within twice
  vpd_tpu's.
- Checkpoints both ways (the port's trainer and vpd_tpu's), and
  `apply_vpd` in both packages within 1e-5 in float32; the train step's
  seeded masks repeat for the same (seed, step); the CLI trains and
  resumes an effnet0 student; `pretrained` warns as vpd_tpu does.
"""

import json
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from test_torch_apply_vpd import load_out, write_crop_tree
from test_torch_resnet import randomize_bn, torch_nchw
from test_torch_train import _randomized
from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.core.io import load_json as jload_json
from vpd_tpu.core.io import store_json as jstore_json
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu.models import efficientnet as jeff
from vpd_tpu.train import vpd as jvpd
from vpd_tpu.train import vpd_loop as jloop
from vpd_tpu_torch.core import checkpoint as tckpt
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.models import efficientnet as teff
from vpd_tpu_torch.models.fc import FlaxDropout, set_dropout_draw
from vpd_tpu_torch.models.flax_weights import (encoder_to_flax,
                                               load_encoder_from_flax,
                                               load_motion_from_flax)
from vpd_tpu_torch.tools import train_vpd as tcli
from vpd_tpu_torch.train import vpd as tvpd
from vpd_tpu_torch.train import vpd_loop as tloop

torch.set_num_threads(2)

EMB = 8
IMG = 32
SHORT = 3          # stages of the block table the parity tests keep
ATOL = 1e-5
LOSS_RTOL, PARAM_TOL = 1e-9, 1e-7
VARIANTS = ['b{}'.format(i) for i in range(8)]


@pytest.fixture
def short_blocks(monkeypatch):
    """Both packages' EfficientNet built on the first SHORT stages."""
    monkeypatch.setattr(jeff, 'BASE_BLOCKS', jeff.BASE_BLOCKS[:SHORT])
    monkeypatch.setattr(teff, 'BASE_BLOCKS', teff.BASE_BLOCKS[:SHORT])


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _port_effnet(variables, channels, dtype=torch.float32):
    model = teff.build_effnet('effnet0', EMB, in_channels=channels,
                              dtype=dtype)
    return load_encoder_from_flax(model, variables)


def _jax_effnet(channels, seed=0, dtype=jnp.float32):
    model = jeff.build_effnet('effnet0', EMB, dtype=dtype)
    v = jax.jit(model.init)(jax.random.key(seed),
                            jnp.zeros((1, IMG, IMG, channels)))
    return model, randomize_bn(v, seed)


# ------------------------------------------------------------- tables

def test_tables_and_rounding_match_vpd_tpu():
    assert teff.ARCH_PARAMS == jeff.ARCH_PARAMS
    assert teff.BASE_BLOCKS == jeff.BASE_BLOCKS
    assert teff.SE_RATIO == jeff.SE_RATIO
    for width, depth, _ in jeff.ARCH_PARAMS.values():
        for f in (8, 16, 24, 32, 40, 80, 112, 192, 320, 1280):
            assert teff.round_filters(f, width) == \
                jeff.round_filters(f, width)
        for r in range(1, 5):
            assert teff.round_repeats(r, depth) == \
                jeff.round_repeats(r, depth)
    # b0's residual blocks: the second and later of each stage
    model = teff.build_effnet('efficientnet-b0', EMB, dtype=torch.float32)
    assert [b.residual for b in model.blocks] == [
        False, False, True, False, True, False, True, True, False, True,
        True, False, True, True, True, False]
    drops = [m.rate for m in model.modules() if isinstance(m, FlaxDropout)]
    assert drops == [0.2] * 9 + [0.2]  # stochastic depth x 9, head
    with pytest.raises(ValueError):
        teff.build_effnet('effnet9', EMB)


@pytest.mark.parametrize('variant', VARIANTS)
def test_flax_tree_matches_vpd_tpu(variant):
    """Names and shapes of every leaf, from a model built on the meta
    device and given empty storage, with 5 and 3 input channels. vpd_tpu's
    tree is traced at 5; at 3 only the stem kernel's input axis differs."""
    jmodel = jeff.build_effnet('effnet' + variant[-1], EMB)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, IMG, IMG, 5))))
    want = {k: tuple(v.shape) for k, v in _flat(
        {'params': shapes['params'],
         'batch_stats': shapes['batch_stats']}).items()}
    stem = ('params', 'Conv_0', 'kernel')
    for channels in (5, 3):
        want[stem] = want[stem][:2] + (channels,) + want[stem][3:]
        with torch.device('meta'):
            model = teff.build_effnet('effnet' + variant[-1], EMB,
                                      in_channels=channels,
                                      param_dtype=torch.float32)
        got = encoder_to_flax(model.to_empty(device='cpu'))
        assert {k: tuple(v.shape) for k, v in _flat(got).items()} == want
    assert model.head.out_channels == jeff.round_filters(
        1280, jeff.ARCH_PARAMS[variant][0])


@pytest.mark.parametrize('size', [16, 17])
@pytest.mark.parametrize('kernel', [3, 5])
def test_same_padding_matches_flax_at_stride_2(kernel, size):
    rng = np.random.default_rng(kernel + size)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    conv = fnn.Conv(6, (kernel, kernel), strides=2, padding='SAME',
                    use_bias=False)
    v = conv.init(jax.random.key(0), x)
    want = np.asarray(conv.apply(v, x))
    port = teff.SameConv2d(4, 6, kernel, 2)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(
            v['params']['kernel']).transpose(3, 2, 0, 1)))
        got = port(torch_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize('size,channels', [(32, 5), (33, 3)])
def test_eval_forward_matches_vpd_tpu(short_blocks, size, channels):
    jmodel, v = _jax_effnet(channels)
    x = np.random.default_rng(size).normal(
        size=(3, size, size, channels)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(v, x))
    model = _port_effnet(v, channels).eval()
    with torch.no_grad():
        got = model(torch_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and the mapping round-trips leaf for leaf
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(encoder_to_flax(model)),
        jax.tree_util.tree_leaves(v)))


def fed_flax_dropout(masks):
    """Intercept flax's `nn.Dropout` in train mode: each call takes the
    next of `masks` (keep bits of the broadcast shape) instead of drawing
    one."""
    feed = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout)
                and context.method_name == '__call__'):
            return next_fun(*args, **kwargs)
        if fnn.merge_param('deterministic', mod.deterministic,
                           kwargs.get('deterministic')) or mod.rate == 0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = 1. - mod.rate
        return jax.lax.select(jnp.broadcast_to(next(feed), x.shape),
                              x / keep, jnp.zeros_like(x))

    return fnn.intercept_methods(interceptor)


def fed_port_dropout(masks):
    """A `set_dropout_draw` source giving `masks` in turn, each checked
    against the shape the port asks for."""
    feed = iter(masks)

    def draw(shape, keep, device):
        mask = torch.from_numpy(np.asarray(next(feed)))
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        return mask

    return draw


def _masks(rng, b, head_dim=1280, n_residual=2, keep=0.8):
    """Keep bits in the port's call order: the residual blocks'
    stochastic depth (B, 1, 1, 1), then the head's (B, C)."""
    return [rng.random((b, 1, 1, 1)) < keep for _ in range(n_residual)] + [
        rng.random((b, head_dim)) < keep]


def test_train_forward_matches_vpd_tpu(short_blocks):
    jmodel, v = _jax_effnet(5, seed=1)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, IMG, IMG, 5)).astype(np.float32)
    masks = _masks(rng, 4)
    assert 0 < np.mean([m.mean() for m in masks]) < 1
    with fed_flax_dropout(masks):
        want, mutated = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=['batch_stats']))(v, x)
    model = _port_effnet(v, 5).train()
    set_dropout_draw(model, fed_port_dropout(masks))
    with torch.no_grad():
        got = model(torch_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    stats = _flat(encoder_to_flax(model)['batch_stats'])
    for k, w in _flat(mutated['batch_stats']).items():
        np.testing.assert_allclose(stats[k], np.asarray(w), atol=1e-6,
                                   err_msg='/'.join(k))


class _X64Names:
    """`jax.numpy` with float32 read as float64: vpd_tpu's head casts to
    `jnp.float32` by name, which would round a float64 trajectory."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_f64_train_trajectory_matches_vpd_tpu(monkeypatch):
    """Three AdamW steps of the effnet0 student with a motion head at
    B = 4 on one pre-augmented batch, new masks each step. Two stages
    (one residual block) keep JAX's float64 gradient compile short; the
    eval and train-mode tests cover the third."""
    monkeypatch.setattr(jeff, 'jnp', _X64Names())
    monkeypatch.setattr(jeff, 'BASE_BLOCKS', jeff.BASE_BLOCKS[:2])
    monkeypatch.setattr(teff, 'BASE_BLOCKS', teff.BASE_BLOCKS[:2])
    n_steps, lr, b = 3, 1e-3, 4
    rng = np.random.default_rng(0)
    imgs = rng.normal(0, 1, (b, IMG, IMG, 5))
    emb = rng.normal(0, 1, (b, 2 * EMB))
    masks = [_masks(rng, b, n_residual=1) for _ in range(n_steps)]
    cfg = tloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch='effnet0')
    with jax.enable_x64():
        jmodel = jvpd.VPDStudent(
            encoder=jeff.build_effnet('effnet0', EMB, dtype=jnp.float64),
            motion=jvpd.MotionHead(EMB, dtype=jnp.float64))
        v = jax.jit(jmodel.init)(jax.random.key(0),
                                 jnp.zeros((1, IMG, IMG, 5)))
        params = _randomized(jax.tree_util.tree_map(np.asarray,
                                                      v['params']), rng)
        stats = _randomized(jax.tree_util.tree_map(
            np.asarray, v['batch_stats']), rng)
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        jstate = jvpd.VPDTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=stats, opt_state=tx.init(params), tx=tx)

        @jax.jit
        def update(s, step_masks):
            with fed_flax_dropout(step_masks):
                return jvpd.apply_train_update(jmodel, s, imgs, emb,
                                               jax.random.key(1))
        jlosses = []
        for m in masks:
            jstate, metrics = update(jstate, m)
            jlosses.append(float(metrics['emb_loss_sum']))
        jparams, jstats = jax.tree_util.tree_map(
            np.asarray, (jstate.params, jstate.batch_stats))

    def port(p, s):
        model = tloop.build_student(cfg, dtype=torch.float64).double()
        load_encoder_from_flax(model.encoder, {
            'params': p['encoder'], 'batch_stats': s['encoder']})
        load_motion_from_flax(model.motion, {'params': p['motion'],
                                             'batch_stats': {}})
        return model

    model = port(params, stats)
    state = tvpd.create_state(model, lr)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    losses = [float(tvpd.apply_train_update(
        state, torch.from_numpy(imgs), torch.from_numpy(emb),
        fed_port_dropout(m))['emb_loss_sum']) for m in masks]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    ref = port(jparams, jstats).state_dict()
    for name, t in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        err = (t - ref[name]).norm().item()
        if name.endswith(('running_mean', 'running_var')):
            assert err <= PARAM_TOL * ref[name].norm().item(), name
        else:
            delta = (ref[name] - init[name]).norm().item()
            assert err <= PARAM_TOL * delta + 1e-9, (name, err, delta)


def test_bf16_error_matches_vpd_tpu(short_blocks):
    """BN statistics calibrated on one batch (so the random encoder tells
    crops apart), then both packages embed the same crops in bf16 and in
    float32; the port's worst-row cosine loss is at most twice vpd_tpu's
    (the CPU conv libraries round differently)."""
    torch.manual_seed(0)
    model = teff.build_effnet('effnet0', 32, in_channels=5,
                              dtype=torch.float32).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.  # running stats = this batch's stats
    rng = np.random.default_rng(7)
    x_cal, x = (rng.uniform(-2, 2, (n, IMG, IMG, 5)).astype(np.float32)
                for n in (16, 16))
    set_dropout_draw(model, lambda shape, keep, dev: torch.ones(
        shape, dtype=torch.bool))
    with torch.no_grad():
        model(torch_nchw(x_cal))
    model.eval()
    v = encoder_to_flax(model)

    def cos_min(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                   * np.linalg.norm(b, axis=-1))).min()

    j32, j16 = (np.asarray(jax.jit(jeff.build_effnet(
        'effnet0', 32, dtype=dt).apply)(v, x)) for dt in (jnp.float32,
                                                          jnp.bfloat16))
    with torch.no_grad():
        t32 = model(torch_nchw(x)).numpy()
        t16 = model.set_compute_dtype(torch.bfloat16)(torch_nchw(x)).numpy()
    assert t16.dtype == np.float32
    np.testing.assert_allclose(t32, j32, rtol=1e-4, atol=1e-4)
    jax_loss, port_loss = 1 - cos_min(j16, j32), 1 - cos_min(t16, t32)
    print('bf16 min-cosine loss: vpd_tpu {:.2e}, port {:.2e}'.format(
        jax_loss, port_loss))
    assert 0 < port_loss <= 2 * jax_loss


# ------------------------------------------ training, checkpoints, CLI

class _Source:
    """Random uint8 batches with (2 * EMB)-d targets, rgb + flow."""
    num_batches = 2

    def __init__(self, seed=0, b=4):
        self.rng = np.random.default_rng(seed)
        self.b = b

    def next_batch(self):
        b = self.b
        return {'rgb': self.rng.integers(0, 255, (b, IMG, IMG, 3), np.uint8),
                'flow': self.rng.integers(0, 255, (b, IMG, IMG, 3), np.uint8),
                'emb': self.rng.normal(size=(b, 2 * EMB)).astype(np.float32),
                'flip': self.rng.random(b) < 0.5}


def _config(**kw):
    return tloop.default_config('fs', EMB, num_epochs=1, batch_size=4,
                                img_dim=IMG, use_flow=True, motion=True,
                                encoder_arch='effnet0',
                                checkpoint_frequency=1, **kw)


def _jax_student(model_dir, name='best_epoch'):
    """vpd_tpu's student of `model_dir` in float32, read as its
    `load_student_dir` reads it (build_student + load_component into the
    shapes of its init, traced rather than run eagerly, which takes
    seconds): (model, variables, config)."""
    cfg = jload_json(os.path.join(model_dir, 'config.json'))
    jmodel = jloop.build_student(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, IMG, IMG, 5)), train=False))
    variables = {'params': {}, 'batch_stats': {}}
    for comp, part in (('encoder', 'encoder'), ('decoder', 'motion')):
        tree = jckpt.load_component(model_dir, name, comp, {
            'params': shapes['params'][part],
            'batch_stats': shapes['batch_stats'].get(part, {})})
        variables['params'][part] = tree['params']
        if tree['batch_stats']:
            variables['batch_stats'][part] = tree['batch_stats']
    return jmodel, variables, cfg


def _extract_both(model_dir, crop_dir, out):
    """`apply_vpd` of both packages on the same dir and crops, float32:
    the same rows, embeddings within ATOL."""
    videos, tasks = japply.scan_crop_dir(crop_dir)
    japply.apply_vpd(videos, tasks, model_dir, out + '_jax',
                     flow_img_name='flow', batch_size=5,
                     prepared=_jax_student(model_dir), log=lambda *a: None)
    tapply.apply_vpd(videos, tasks, model_dir, out + '_port',
                     flow_img_name='flow', batch_size=5,
                     prepared=tapply.load_student_dir(
                         model_dir, dtype=torch.float32, device='cpu'),
                     log=lambda *a: None, device='cpu')
    got, want = load_out(out + '_port'), load_out(out + '_jax')
    assert list(got) == list(want) and got
    for name in want:
        assert [r[0] for r in got[name]] == [r[0] for r in want[name]]
        np.testing.assert_allclose(np.stack([r[1] for r in got[name]]),
                                   np.stack([r[1] for r in want[name]]),
                                   atol=ATOL)


def test_port_checkpoint_loads_and_serves_in_vpd_tpu(short_blocks,
                                                     tmp_path):
    """The port's trainer writes an effnet0 run; vpd_tpu's build_student
    + load_component read every component as the port wrote it, and both
    packages extract alike."""
    save, crops = str(tmp_path / 'm'), str(tmp_path / 'crops')
    write_crop_tree(crops)
    trainer = tloop.VPDTrainer(_Source(), _Source(1), _config(),
                               save_dir=save, device='cpu',
                               dtype=torch.float32)
    trainer.save_config()
    trainer.fit(log=lambda *a: None)
    assert trainer.state.step == 2
    _, variables, _ = _jax_student(save, 'epoch0001')
    for comp, part in (('encoder', 'encoder'), ('decoder', 'motion')):
        got = _flat(jax.tree_util.tree_map(np.asarray, {
            'params': variables['params'][part],
            'batch_stats': variables['batch_stats'].get(part, {})}))
        want = _flat(tckpt.load_component(save, 'epoch0001', comp))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want), comp
    _extract_both(save, crops, str(tmp_path / 'embs'))


def test_vpd_tpu_checkpoint_loads_and_serves_in_the_port(short_blocks,
                                                         tmp_path):
    """vpd_tpu's weights (random BN statistics) written by its checkpoint
    writer load in the port's build_student, write back byte for byte,
    and extract alike."""
    jdir, tdir = str(tmp_path / 'j'), str(tmp_path / 't')
    crops = str(tmp_path / 'crops')
    write_crop_tree(crops)
    cfg = _config()
    jmodel = jloop.build_student(cfg, dtype=jnp.float32)
    v = randomize_bn(jax.jit(jmodel.init)(
        jax.random.key(2), jnp.zeros((1, IMG, IMG, 5))), 2)
    os.makedirs(jdir)
    jstore_json(os.path.join(jdir, 'config.json'), cfg)
    jckpt.save_bundle(jdir, 'best_epoch', {
        'encoder': {'params': v['params']['encoder'],
                    'batch_stats': v['batch_stats']['encoder']},
        'decoder': {'params': v['params']['motion'], 'batch_stats': {}}})
    model, _ = tapply.load_student_dir(jdir, dtype=torch.float32,
                                       device='cpu')
    tloop.save_student(tdir, model, cfg)
    for comp in ('encoder', 'decoder'):
        with open(tckpt.component_path(jdir, 'best_epoch', comp), 'rb') as a, \
                open(tckpt.component_path(tdir, 'best_epoch', comp),
                     'rb') as b:
            assert a.read() == b.read(), comp
    _extract_both(jdir, crops, str(tmp_path / 'embs'))


def test_train_step_dropout_masks_follow_seed_and_step(short_blocks):
    """The train step gives the student a mask source seeded
    `dropout_seed(seed, step)`: the same weights, batch, seed and step
    count give the same update (so a resumed run draws what an
    uninterrupted one drew), the masks differ from step to step, and they
    are not the augmentation's stream."""
    cfg = _config()
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], img_dim=IMG,
                                use_flow=True)
    batch = {k: torch.as_tensor(v) for k, v in _Source().next_batch().items()}
    torch.manual_seed(0)
    ref = tloop.build_student(cfg, dtype=torch.float32)
    runs = []
    for _ in range(2):
        model = tloop.build_student(cfg, dtype=torch.float32)
        model.load_state_dict(ref.state_dict())
        state = tvpd.create_state(model, 1e-3)
        state.step = 7
        loss = float(step(state, batch, 5)['emb_loss_sum'])
        runs.append((loss, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(t, runs[1][1][k]) for k, t in runs[0][1].items())
    assert all(m.draw is None for m in model.modules()
               if isinstance(m, FlaxDropout))

    def masks(s):
        return step.dropout_draw('cpu', 5, s)((64,), .5, 'cpu')
    assert torch.equal(masks(7), masks(7))
    assert not torch.equal(masks(7), masks(8))
    aug = torch.Generator().manual_seed(tvpd.fold_in(5, 7))
    assert not torch.equal(masks(7), torch.rand(64, generator=aug) < .5)



@pytest.mark.parametrize('arch', ['resnet18', 'effnet0'])
def test_train_step_seeds_masks_only_for_a_student_that_draws(
        short_blocks, monkeypatch, arch):
    """The step seeds a mask source only for a student with a
    `FlaxDropout` that draws (an EfficientNet's): a ResNet student's step
    seeds none."""
    calls = []
    draw = tvpd._Constants.dropout_draw

    def counted(self, *args):
        calls.append(args)
        return draw(self, *args)
    monkeypatch.setattr(tvpd._Constants, 'dropout_draw', counted)
    cfg = tloop.default_config('fs', EMB, img_dim=IMG, use_flow=True,
                               motion=True, encoder_arch=arch)
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], img_dim=IMG,
                                use_flow=True)
    torch.manual_seed(0)
    state = tvpd.create_state(tloop.build_student(cfg, dtype=torch.float32),
                              1e-3)
    batch = {k: torch.as_tensor(v) for k, v in _Source().next_batch().items()}
    assert np.isfinite(float(step(state, batch, 5)['emb_loss_sum']))
    assert state.draws_dropout == (arch == 'effnet0')
    # (device, seed, step, this rank's part of the global batch)
    assert calls == ([(torch.device('cpu'), 5, 0, (0, 1))]
                     if arch == 'effnet0' else [])

def test_cli_trains_and_resumes_an_effnet_student(short_blocks, tmp_path,
                                                  monkeypatch):
    from test_torch_train import _cli_kwargs, _pack_port_shards, write_corpus
    emb_dir, crop_dir = write_corpus(str(tmp_path / 'corpus'))
    shard_dir = str(tmp_path / 'shards')
    _pack_port_shards(crop_dir, shard_dir)
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', crop_dir)
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 16)
    monkeypatch.setattr(tcli, 'VAL_LEN', 8)
    save = str(tmp_path / 'run')
    kw = dict(encoder_arch='effnet0', crop_shards=shard_dir)
    tcli.main(**_cli_kwargs(emb_dir, save, **kw))
    trainer = tcli.main(**_cli_kwargs(emb_dir, save, num_epochs=3,
                                      resume=True, **kw))
    assert trainer.state.step == 3 * 2
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    assert [r['epoch'] for r in losses] == [1, 2, 3]
    assert all(np.isfinite([r['train'], r['val']]).all() for r in losses)
    with open(os.path.join(save, 'config.json')) as fp:
        assert json.load(fp)['encoder_arch'] == 'effnet0'
    tree = tckpt.load_component(save, 'epoch0003', 'encoder')
    assert 'MBConv_4' in tree['params'] and 'MBConv_5' not in tree['params']


def test_pretrained_is_ignored_with_vpd_tpu_warning(short_blocks):
    """vpd_tpu's warning comes from its `_init_pretrained` (its trainer's
    eager init would take seconds); the port's from a whole trainer."""
    cfg = _config(pretrained=True)
    msgs = []
    for make in (lambda: jloop.VPDTrainer._init_pretrained(
            types.SimpleNamespace(config=cfg), None, 5),
            lambda: tloop.VPDTrainer(None, None, cfg, device='cpu')):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            make()
        msgs.append([str(x.message) for x in w
                     if 'pretrained' in str(x.message)])
    assert msgs[0] == msgs[1] and len(msgs[0]) == 1
