"""The port's student modules against vpd_tpu's, on the same weights.

Flax variables are made by vpd_tpu, given random non-trivial batch
statistics and BN affine terms (init's 0/1 values would hide a BN mapping
error), moved into the port with `models/flax_weights`, and both packages
embed the same numpy inputs in float32 on the CPU. Bar: row cosine
>= 1 - 1e-5 and allclose(rtol=1e-4, atol=1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.models import build_encoder as jbuild_encoder
from vpd_tpu.models.resnet import \
    expand_stem_to_channels as jexpand_stem_to_channels
from vpd_tpu.train.vpd import MotionHead as JMotionHead
from vpd_tpu.train.vpd_loop import build_student as jbuild_student
from vpd_tpu.train.vpd_loop import default_config
from vpd_tpu_torch.core import checkpoint as tckpt
from vpd_tpu_torch.models import build_encoder
from vpd_tpu_torch.models.flax_weights import (encoder_to_flax,
                                               load_encoder_from_flax,
                                               load_motion_from_flax)
from vpd_tpu_torch.models.resnet import expand_stem_to_channels
from vpd_tpu_torch.train.vpd import MotionHead
from vpd_tpu_torch.train.vpd_loop import build_student

torch.set_num_threads(2)

IMG = 32
EMB = 16


def randomize_bn(variables, seed):
    """BN stats mean ~ N(0, 0.1), var ~ U(0.5, 2); BN scale ~ U(0.5, 1.5)
    and every bias ~ N(0, 0.1). Returns a numpy tree."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = walk(x)
            elif k == 'mean':
                out[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            elif k == 'var':
                out[k] = rng.uniform(0.5, 2., x.shape).astype(np.float32)
            elif k == 'scale':
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k == 'bias':
                out[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            else:
                out[k] = x
        return out
    return walk(v)


def assert_embs_close(a, b, cos_bar=1 - 1e-5, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= cos_bar, cos.min()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def jax_encoder(arch, channels, seed=0):
    model = jbuild_encoder(arch, EMB, dtype=jnp.float32)
    v = model.init(jax.random.key(seed),
                   jnp.zeros((1, IMG, IMG, channels)), train=False)
    return model, randomize_bn(v, seed)


def torch_nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize('arch,channels', [
    ('resnet34', 3), ('resnet34', 5), ('resnet18', 3), ('resnet50', 3)])
def test_encoder_matches_vpd_tpu(arch, channels):
    jmodel, v = jax_encoder(arch, channels, seed=channels)
    x = np.random.default_rng(1).uniform(
        -2, 2, (4, IMG, IMG, channels)).astype(np.float32)
    ref = np.asarray(jmodel.apply(v, x, train=False))

    model = build_encoder(arch, EMB, in_channels=channels,
                          dtype=torch.float32)
    load_encoder_from_flax(model, v)
    with torch.no_grad():
        out = model.eval()(torch_nchw(x)).numpy()
    assert_embs_close(out, ref)


def test_encoder_round_trip_is_byte_equal(tmp_path):
    """vpd_tpu file -> port module -> port file: the same bytes."""
    _, v = jax_encoder('resnet18', 5, seed=2)
    jpath = jckpt.save_component(str(tmp_path), 'j', 'encoder', v)
    model = build_encoder('resnet18', EMB, in_channels=5,
                          dtype=torch.float32)
    load_encoder_from_flax(model, tckpt.load_component(str(tmp_path), 'j',
                                                       'encoder'))
    tpath = tckpt.save_component(str(tmp_path), 't', 'encoder',
                                 encoder_to_flax(model))
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()


def test_weight_mapping_rejects_mismatched_trees():
    _, v = jax_encoder('resnet18', 3)
    with pytest.raises(ValueError):  # other blocks, other shapes
        load_encoder_from_flax(build_encoder('resnet34', EMB), v)
    model = build_encoder('resnet18', EMB, dtype=torch.float32)
    stats = dict(v['batch_stats'])
    del stats['BatchNorm_0']
    with pytest.raises(KeyError):
        load_encoder_from_flax(model, {'params': v['params'],
                                       'batch_stats': stats})
    extra = {'params': dict(v['params'], Extra_0={'kernel': np.zeros(2)}),
             'batch_stats': v['batch_stats']}
    with pytest.raises(ValueError):
        load_encoder_from_flax(model, extra)


def test_expand_stem_to_channels_matches_vpd_tpu():
    jmodel, v = jax_encoder('resnet18', 3, seed=4)
    v5 = jax.tree_util.tree_map(
        np.asarray, jexpand_stem_to_channels(v, 5))
    x = np.random.default_rng(2).uniform(
        -2, 2, (3, IMG, IMG, 5)).astype(np.float32)
    ref = np.asarray(jmodel.apply(v5, x, train=False))

    model = build_encoder('resnet18', EMB, dtype=torch.float32)
    load_encoder_from_flax(model, v)
    expand_stem_to_channels(model, 5)
    assert model.conv1.weight.shape == (64, 5, 7, 7)
    with torch.no_grad():
        out = model.eval()(torch_nchw(x)).numpy()
    assert_embs_close(out, ref)


def test_motion_head_matches_vpd_tpu():
    head = JMotionHead(EMB)
    x = np.random.default_rng(3).standard_normal((6, EMB)).astype(
        np.float32)
    v = jax.tree_util.tree_map(
        np.asarray, head.init(jax.random.key(5), jnp.zeros((1, EMB))))
    ref = np.asarray(head.apply(v, x))
    port = MotionHead(EMB)
    load_motion_from_flax(port, {'params': v['params'], 'batch_stats': {}})
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (6, 2 * EMB)
    assert_embs_close(out, ref)


def test_build_student_with_motion_matches_vpd_tpu(tmp_path):
    cfg = default_config('fs', EMB, img_dim=IMG, use_flow=True, motion=True,
                         encoder_arch='resnet18')
    jmodel = jbuild_student(cfg, dtype=jnp.float32)
    v = jmodel.init(jax.random.key(6), jnp.zeros((1, IMG, IMG, 5)),
                    train=False)
    v = randomize_bn(v, 6)
    x = np.random.default_rng(4).uniform(
        -2, 2, (3, IMG, IMG, 5)).astype(np.float32)
    ref = np.asarray(jmodel.apply(v, x, train=False))

    model = build_student(cfg, dtype=torch.float32)
    load_encoder_from_flax(model.encoder, {
        'params': v['params']['encoder'],
        'batch_stats': v['batch_stats']['encoder']})
    load_motion_from_flax(model.motion, {
        'params': v['params']['motion'], 'batch_stats': {}})
    with torch.no_grad():
        out = model.eval()(torch_nchw(x)).numpy()
    assert out.shape == (3, 2 * EMB)
    assert_embs_close(out, ref)


def test_bf16_student_keeps_an_f32_head():
    model = build_encoder('resnet18', EMB, dtype=torch.bfloat16)
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.fc.weight.dtype == torch.float32
    with torch.no_grad():
        out = model.eval()(torch.zeros(2, 3, IMG, IMG))
    assert out.dtype == torch.float32 and out.shape == (2, EMB)


def test_bf16_error_matches_vpd_tpu():
    """The port's bf16 encoder loses no more to bf16 than vpd_tpu's does.

    BN statistics are calibrated on one batch, so the random encoder
    tells crops apart (unlike a fresh init, whose embeddings all point
    one way); both packages then embed the same crops in bf16 and in
    f32. The port's worst-row cosine loss may be up to twice JAX's: the
    two CPU conv libraries (oneDNN, Eigen) round differently.
    """
    torch.manual_seed(0)
    model = build_encoder('resnet34', 32, in_channels=5,
                          dtype=torch.float32).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.  # running stats = this batch's stats
    rng = np.random.default_rng(7)
    x_cal, x = (rng.uniform(-2, 2, (n, 64, 64, 5)).astype(np.float32)
                for n in (16, 16))
    with torch.no_grad():
        model(torch_nchw(x_cal))
    model.eval()
    v = encoder_to_flax(model)

    def cos_min(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                   * np.linalg.norm(b, axis=-1))).min()

    j32, j16 = (np.asarray(jbuild_encoder('resnet34', 32, dtype=dt).apply(
        v, x, train=False)) for dt in (jnp.float32, jnp.bfloat16))
    with torch.no_grad():
        t32 = model(torch_nchw(x)).numpy()
        t16 = model.set_compute_dtype(torch.bfloat16)(
            torch_nchw(x)).numpy()
    assert_embs_close(t32, j32, cos_bar=1 - 1e-5, tol=1e-3)
    jax_loss, port_loss = 1 - cos_min(j16, j32), 1 - cos_min(t16, t32)
    print('bf16 min-cosine loss: vpd_tpu {:.2e}, port {:.2e}'.format(
        jax_loss, port_loss))
    assert port_loss <= 2 * jax_loss
