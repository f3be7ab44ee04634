"""The port's flax-msgpack checkpoint codec against flax and msgpack.

vpd_tpu_torch reads and writes vpd_tpu's `{name}.{component}.ckpt` files
without flax or msgpack (the GPU host may lack both). These tests hold the
codec to the real libraries: byte-equal both ways on student
checkpoints, and byte-equal to msgpack on a tree that reaches every
encoding the codec emits.
"""

import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.train.vpd_loop import build_student as jbuild_student
from vpd_tpu.train.vpd_loop import default_config as jdefault_config
from vpd_tpu_torch.core import checkpoint as tckpt

torch.set_num_threads(2)


def _jax_student_tree(use_flow, motion, seed=0):
    cfg = jdefault_config('fs', 8, img_dim=32, use_flow=use_flow,
                          motion=motion, encoder_arch='resnet18')
    model = jbuild_student(cfg, dtype=jnp.float32)
    v = model.init(jax.random.key(seed),
                   jnp.zeros((1, 32, 32, 5 if use_flow else 3)), train=False)
    return {'params': v['params']['encoder'],
            'batch_stats': v['batch_stats']['encoder']}, \
        {'params': v['params'].get('motion', {}), 'batch_stats': {}}


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('component', ['encoder', 'decoder'])
def test_jax_checkpoint_loads_and_saves_back_byte_equal(tmp_path, component):
    enc, dec = _jax_student_tree(use_flow=True, motion=True)
    tree = enc if component == 'encoder' else dec
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    os.makedirs(jdir)
    os.makedirs(tdir)
    jpath = jckpt.save_component(jdir, 'best_epoch', component, tree)

    loaded = tckpt.load_component(jdir, 'best_epoch', component)
    _assert_trees_equal(loaded, jax.tree_util.tree_map(np.asarray, tree))
    tpath = tckpt.save_component(tdir, 'best_epoch', component, loaded)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()


def test_port_checkpoint_loads_in_vpd_tpu(tmp_path):
    enc, _ = _jax_student_tree(use_flow=False, motion=False, seed=3)
    rng = np.random.default_rng(0)
    # fresh arrays, inserted in reverse key order: the writer must sort
    def fresh(tree):
        if isinstance(tree, dict):
            return {k: fresh(tree[k]) for k in reversed(list(tree))}
        return rng.standard_normal(np.shape(tree)).astype(np.float32)

    tree = fresh(jax.tree_util.tree_map(np.asarray, enc))
    path = tckpt.save_component(str(tmp_path), 'epoch0007', 'encoder', tree)
    assert os.path.basename(path) == 'epoch0007.encoder.ckpt'
    back = jckpt.load_component(str(tmp_path), 'epoch0007', 'encoder', enc)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, back),
                           jax.tree_util.tree_map(np.asarray, tree))
    # and the bytes are exactly what vpd_tpu writes for those arrays
    jpath = jckpt.save_component(str(tmp_path), 'jax', 'encoder', tree)
    with open(jpath, 'rb') as a, open(path, 'rb') as b:
        assert a.read() == b.read()


def _mixed_tree():
    rng = np.random.default_rng(1)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    tree = {
        'ints': {str(i): v for i, v in enumerate(ints)},
        'floats': {'a': 0.0, 'b': -1.5, 'c': 1e300, 'd': float('inf')},
        'misc': {'none': None, 't': True, 'f': False, 'bytes': b'\x00\xff',
                 'bin16': bytes(300), 'bin32': bytes(70000)},
        'strs': {'s0': '', 's31': 'x' * 31, 's32': 'y' * 32,
                 's255': 'z' * 255, 's256': 'w' * 256, 's70k': 'v' * 70000,
                 'utf8': 'crops é中'},
        'arrays': {
            'f32': rng.standard_normal((3, 4)).astype(np.float32),
            'f64': rng.standard_normal(7),
            'i8': np.arange(-5, 5, dtype=np.int8),
            'u8': rng.integers(0, 255, (2, 3, 4), dtype=np.uint8),
            'i64': np.arange(3, dtype=np.int64),
            'bool': np.array([True, False]),
            'scalar0d': np.array(2.5, np.float32),
            'empty': np.zeros((0, 3), np.float32),
            'f16': np.ones(5, np.float16),
            'big': rng.standard_normal(20000).astype(np.float32),
        },
        'npscalars': {'f': np.float32(1.25), 'i': np.int64(-7),
                      'b': np.bool_(True), 'd': np.float64(3.0)},
        'wide_map': {'k{:02d}'.format(i): i for i in range(40)},
        'empty': {},
    }
    return tree


def test_codec_matches_msgpack_on_mixed_tree():
    tree = _mixed_tree()
    ours = tckpt.packb(tree)
    ref = msgpack.packb(tree, default=fser._msgpack_ext_pack,
                        strict_types=True)
    assert ours == ref
    # decode both ways and compare with what flax restores
    _assert_trees_equal(tckpt.unpackb(ref), fser.msgpack_restore(ref))
    assert tckpt.packb(tckpt.unpackb(ref)) == ref


def test_codec_rejects_malformed_input():
    with pytest.raises(ValueError):
        tckpt.unpackb(tckpt.packb({'a': 1})[:-1])  # truncated
    with pytest.raises(ValueError):
        tckpt.unpackb(tckpt.packb({'a': 1}) + b'\x00')  # trailing bytes
    with pytest.raises(TypeError):
        tckpt.packb({1: 2})  # non-str key
