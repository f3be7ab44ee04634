"""The port's training input against vpd_tpu's on the CPU: the native PNG
decoder, pack_crops, decode worker processes, and ImageNet init.

- `native_loader`: the same bytes as cv2 and as vpd_tpu's native loader
  (flow in raw BGR order, ROADMAP C1); a missing rgb file raises, a
  missing mask zero-fills; the library is built under
  `vpd_tpu_torch/_build/`, never under `native/`. The decoder that runs
  is recorded on the source and counted. Skips only where the decoder
  cannot be built (no g++ or libpng headers).
- `pack_crops`: the shard files, index and meta byte-equal to vpd_tpu's
  on the same PNG tree; each package's reader reads the other's shards.
- `MultiprocessBatcher` (spawned workers): vpd_tpu's batch stream for
  the same sources and seeds; inline mode; close is idempotent; worker
  exceptions and deaths surface; the CLI with `--num_workers 2`.
- ImageNet init: from a torchvision-layout state_dict, the port's
  encoder and vpd_tpu's `imagenet_init_variables` give outputs within
  1e-5 of their scale (float32) at 3 and 5 channels; the embedding head
  stays fresh; `--pretrained` needs `--init_weights`.
"""

import functools
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (EMB, IMG, _cli_kwargs, _randomized,
                              write_corpus)
from vpd_tpu.data import crops as jcrops
from vpd_tpu.data import native_loader as jnative
from vpd_tpu.data.parallel_batcher import \
    MultiprocessBatcher as JMultiprocessBatcher
from vpd_tpu.data.shards import ShardReader as JShardReader
from vpd_tpu.data.shards import pack_crops as jpack_crops
from vpd_tpu.data.shards import scan_png_tree as jscan_png_tree
from vpd_tpu.models import torch_compat as jcompat
from vpd_tpu.models.resnet import build_encoder as jbuild_encoder
from vpd_tpu_torch.data import crops as tcrops
from vpd_tpu_torch.data import native_loader as tnative
from vpd_tpu_torch.data import shards as tshards
from vpd_tpu_torch.data.parallel_batcher import MultiprocessBatcher
from vpd_tpu_torch.models.flax_weights import encoder_to_flax
from vpd_tpu_torch.models.torch_compat import convert_resnet_state_dict
from vpd_tpu_torch.tools import pack_crops as tpack
from vpd_tpu_torch.tools import train_vpd as tcli
from vpd_tpu_torch.train import vpd_loop as tloop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_TOL = 1e-5


def _quiet(*args):
    pass


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp('input')))


@pytest.fixture
def native():
    if not tnative.available():
        pytest.skip('the native decoder cannot be built here (no g++ or '
                    'no libpng headers)')
    return tnative


# ------------------------------------------------------- native decoder

def _png_batch(tmp_path, n=5, missing_mask=(2,)):
    """n crops written by cv2: rgb, flow and masks (some missing)."""
    rng = np.random.default_rng(3)
    paths = {'rgb': [], 'flow': [], 'mask': []}
    for i in range(n):
        base = str(tmp_path / str(i))
        cv2.imwrite(base + '.png', rng.integers(0, 256, (IMG, IMG, 3),
                                                np.uint8))
        cv2.imwrite(base + '.flow.png', rng.integers(0, 256, (IMG, IMG, 3),
                                                     np.uint8))
        if i not in missing_mask:
            cv2.imwrite(base + '.mask.png',
                        (rng.integers(0, 2, (IMG, IMG), np.uint8) * 255))
        for k, suffix in (('rgb', '.png'), ('flow', '.flow.png'),
                          ('mask', '.mask.png')):
            paths[k].append(base + suffix)
    return paths


def test_native_decoder_matches_cv2_and_vpd_tpu(native, tmp_path):
    paths = _png_batch(tmp_path)
    kw = dict(flow_paths=paths['flow'], mask_paths=paths['mask'])
    got = tcrops.decode_crop_batch(paths['rgb'], IMG, use_native=True, **kw)
    host = tcrops.decode_crop_batch(paths['rgb'], IMG, use_native=False,
                                    **kw)
    ref = jnative.decode_crops(paths['rgb'], IMG, **kw)
    jhost = jcrops.decode_crop_batch(paths['rgb'], IMG, use_native=False,
                                     **kw)
    for name, a, b, c, d in zip(('rgb', 'flow', 'mask'), got, host, ref,
                                jhost):
        for other in (b, c, d):
            np.testing.assert_array_equal(a, other, err_msg=name)
    rgb, flow, mask = got
    for i, p in enumerate(paths['rgb']):
        np.testing.assert_array_equal(rgb[i], cv2.imread(p)[..., ::-1])
        # flow in the file's raw (BGR) order, as cv2 reads it
        np.testing.assert_array_equal(flow[i], cv2.imread(paths['flow'][i]))
    assert not mask[2].any() and mask[0].any()


def test_native_decoder_raises_on_a_missing_rgb(native, tmp_path):
    paths = _png_batch(tmp_path, n=2)
    os.remove(paths['rgb'][1])
    with pytest.raises(IOError, match='1 crop/flow PNGs'):
        native.decode_crops(paths['rgb'], IMG, mask_paths=paths['mask'])


def test_native_library_is_the_ports_own(native):
    build = os.path.join(REPO, 'vpd_tpu_torch', '_build')
    assert os.path.commonpath([native.LIB_PATH, build]) == build
    assert os.path.exists(native.LIB_PATH)
    assert native.SRC == os.path.join(REPO, 'native', 'crop_loader.cpp')
    assert native.get_lib() is native.get_lib()


def test_decoder_is_recorded_and_counted(native, corpus):
    emb_dir, crop_dir = corpus
    samples, _ = tcrops.scan_emb_dir(emb_dir, log=_quiet)
    for use_native, want in ((None, 'native'), (True, 'native'),
                             (False, 'cv2')):
        src = tcrops.CropBatchSource(samples, crop_dir, IMG, 4, seed=1,
                                     flow_img_name='flow',
                                     use_native=use_native)
        assert src.decoder == want
        before = dict(tcrops.decoder_calls)
        src.next_batch()
        assert {k: tcrops.decoder_calls[k] - before[k]
                for k in before} == {k: int(k == want) for k in before}


# ----------------------------------------------------------- pack_crops

def test_scan_png_tree_matches_vpd_tpu(corpus, tmp_path):
    _, crop_dir = corpus
    assert tshards.scan_png_tree(crop_dir) == jscan_png_tree(crop_dir)
    # the tennis layout, hidden dirs and files that are not frames
    root = tmp_path / 'tree'
    for rel in ('v1/p0/3.png', 'v1/p0/10.png', 'v1/p1/2.png', 'v1/7.png',
                'v0/1.png', 'v0/1.flow.png', 'v0/.viz/5.png',
                '.hidden/1.png', 'v2/x.png'):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(b'')
    (root / 'notes.txt').write_bytes(b'')
    got = tshards.scan_png_tree(str(root))
    assert got == jscan_png_tree(str(root))
    assert [r for r, _ in got] == ['v0/1', 'v1/7', 'v1/p0/10', 'v1/p0/3',
                                   'v1/p1/2']


@pytest.mark.parametrize('use_native', [False, True])
def test_pack_crops_matches_vpd_tpu(corpus, tmp_path, use_native):
    """Through the port's CLI (the native decoder where asked) against
    vpd_tpu's function on its cv2 path: every file byte-equal; each
    package reads the other's shards."""
    if use_native and not tnative.available():
        pytest.skip('the native decoder cannot be built here')
    _, crop_dir = corpus
    mine, ref = str(tmp_path / 'port'), str(tmp_path / 'jax')
    if use_native:
        n = tpack.main(crop_dir, mine, IMG, 'flow', False, 5, 'raw')
    else:
        n = tshards.pack_crops(crop_dir, mine, IMG, flow_img_name='flow',
                               rows_per_shard=5, use_native=False,
                               log=_quiet)
    jpack_crops(crop_dir, ref, IMG, flow_img_name='flow', rows_per_shard=5,
                use_native=False, log=_quiet)
    assert n == 16
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names
    assert 's0003.mask' in names and 'shards_meta.json' in names
    for name in names:
        with open(os.path.join(mine, name), 'rb') as a, \
                open(os.path.join(ref, name), 'rb') as b:
            assert a.read() == b.read(), name
    prefixes = [os.path.join(crop_dir, rel)
                for rel, _ in tshards.scan_png_tree(crop_dir)]
    for reader_cls, shard_dir in ((tshards.ShardReader, ref),
                                  (JShardReader, mine)):
        reader = reader_cls(shard_dir, crop_root=crop_dir)
        rgb = np.zeros((16, IMG, IMG, 3), np.uint8)
        mask = np.zeros((16, IMG, IMG), np.uint8)
        assert reader.fill(prefixes, rgb, mask_out=mask) == []
        want, _, want_mask = tcrops.decode_crop_batch(
            [p + '.png' for p in prefixes], IMG,
            mask_paths=[p + '.mask.png' for p in prefixes], use_native=False)
        np.testing.assert_array_equal(rgb, want)
        np.testing.assert_array_equal(mask, want_mask)


def test_pack_crops_without_masks_and_flow(corpus, tmp_path):
    _, crop_dir = corpus
    out = str(tmp_path / 's')
    tshards.pack_crops(crop_dir, out, IMG, use_mask=False, use_native=False,
                       log=_quiet)
    with open(os.path.join(out, 'shards_meta.json')) as fp:
        meta = json.load(fp)
    assert meta == {'img_dim': IMG, 'codec': 'raw', 'flow_img_name': None,
                    'use_mask': False, 'rows_per_shard': 4096,
                    'shard_rows': [16], 'num_rows': 16}
    assert sorted(os.listdir(out)) == ['s0000.rgb', 'shards_index.pkl',
                                       'shards_meta.json']
    with pytest.raises(ValueError, match='no crops'):
        tshards.pack_crops(str(tmp_path / 's'), str(tmp_path / 't'), IMG,
                           log=_quiet)


# ------------------------------------------------------ decode workers

def _worker_args(corpus, seed=3, samples=None):
    emb_dir, crop_dir = corpus
    if samples is None:
        samples, _ = tcrops.scan_emb_dir(emb_dir, embed_time=True,
                                         log=_quiet)
    return samples, crop_dir, IMG, 4, 100, seed, True, {
        'flow_img_name': 'flow', 'shard_dir': None}


def test_batcher_stream_matches_vpd_tpu(corpus):
    """Two spawned workers, each a port CropBatchSource seeded as the CLI
    seeds them, against vpd_tpu's forked workers over its own sources:
    the same 4 batches, byte for byte."""
    args = _worker_args(corpus)
    samples, crop_dir, _, _, _, seed, _, _ = args

    def jsource(wid):
        return jcrops.CropBatchSource(
            samples, crop_dir, IMG, 4, target_len=100, flow_img_name='flow',
            seed=seed + 1000 * (wid + 1), use_native=False)

    with MultiprocessBatcher(functools.partial(tcli.worker_source, *args),
                             2, 25) as got, \
            JMultiprocessBatcher(jsource, 2, 25) as ref:
        assert got.num_batches == 25
        for _ in range(4):
            a, b = got.next_batch(), ref.next_batch()
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batcher_inline_mode_and_idempotent_close(corpus):
    args = _worker_args(corpus)
    ref = tcli.worker_source(*args, 0)
    mb = MultiprocessBatcher(functools.partial(tcli.worker_source, *args),
                             0, 25)
    assert not mb._procs and mb._inline is not None
    for _ in range(2):
        a, b = mb.next_batch(), ref.next_batch()
        np.testing.assert_array_equal(a['rgb'], b['rgb'])
    mb.close()
    mb.close()

    mb = MultiprocessBatcher(functools.partial(tcli.worker_source, *args),
                             2, 25)
    procs = list(mb._procs)
    mb.next_batch()
    mb.close()
    mb.close()
    assert not mb._procs and not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match='closed'):
        mb.next_batch()


def test_batcher_surfaces_worker_errors_and_deaths(corpus):
    # an empty sample list: CropBatchSource raises in the worker
    failing = functools.partial(tcli.worker_source,
                                *_worker_args(corpus, samples=[]))
    with MultiprocessBatcher(failing, 1, 1) as mb:
        with pytest.raises(RuntimeError, match='empty crop dataset'):
            mb.next_batch()
    # the worker exits at once, without a word: os._exit(worker_id)
    with MultiprocessBatcher(os._exit, 1, 1) as mb:
        with pytest.raises(RuntimeError, match=r'died \(exit code 0\)'):
            mb.next_batch()


def test_cli_with_decode_workers(corpus, tmp_path, monkeypatch):
    emb_dir, crop_dir = corpus
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', crop_dir)
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 16)
    monkeypatch.setattr(tcli, 'VAL_LEN', 8)
    save = str(tmp_path / 'run')
    trainer = tcli.main(**_cli_kwargs(emb_dir, save, num_epochs=1,
                                      num_workers=2))
    assert trainer.state.step == 2
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    assert [r['epoch'] for r in losses] == [1]
    assert np.isfinite([losses[0]['train'], losses[0]['val']]).all()
    assert isinstance(trainer.train_source.source, MultiprocessBatcher)
    assert not trainer.train_source.source._procs  # closed by the CLI


# -------------------------------------------------------- ImageNet init

@pytest.fixture(scope='module')
def imagenet_file(tmp_path_factory):
    """A torchvision-layout resnet18 state_dict (3 input channels, a
    10-way fc) from random flax variables, BN statistics random, written
    as a .pth; with the numpy dict it holds."""
    rng = np.random.default_rng(0)
    enc = jbuild_encoder('resnet18', 10, dtype=jnp.float32)
    v = enc.init(jax.random.key(1), jnp.zeros((1, IMG, IMG, 3)),
                 train=False)
    params, stats = (jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        _randomized(jax.tree_util.tree_map(np.asarray, v[k]), rng))
        for k in ('params', 'batch_stats'))
    sd = jcompat.export_resnet_state_dict(params, stats, 'resnet18',
                                          prefix='')
    path = str(tmp_path_factory.mktemp('imagenet') / 'resnet18.pth')
    jcompat.save_torch_state_dict(path, sd)
    return path, sd


def _trainer_config(channels, pretrained, **kw):
    return tloop.default_config('fs', EMB, img_dim=IMG,
                                use_flow=channels == 5, motion=True,
                                encoder_arch='resnet18',
                                pretrained=pretrained, **kw)


@pytest.mark.parametrize('channels', [3, 5])
def test_imagenet_init_matches_vpd_tpu(imagenet_file, channels):
    path, _ = imagenet_file
    trainer = tloop.VPDTrainer(None, None, _trainer_config(channels, True),
                               device='cpu', dtype=torch.float32,
                               pretrained_weights=path)
    fresh = tloop.VPDTrainer(None, None, _trainer_config(channels, False),
                             device='cpu', dtype=torch.float32)
    enc = trainer.model.encoder.eval()
    # the head stays as a fresh student's, the backbone does not
    assert torch.equal(enc.fc.weight, fresh.model.encoder.fc.weight)
    assert not torch.equal(enc.conv1.weight,
                           fresh.model.encoder.conv1.weight)
    assert enc.conv1.weight.shape[1] == channels

    pp, ps = jcompat.imagenet_init_variables(
        jcompat.load_torch_state_dict(path), 'resnet18', channels)
    head = encoder_to_flax(enc)['params']['Dense_0']
    jenc = jbuild_encoder('resnet18', EMB, dtype=jnp.float32)
    x = np.random.default_rng(2).normal(size=(3, IMG, IMG, channels)).astype(
        np.float32)
    ref = np.asarray(jenc.apply({'params': {**pp, 'Dense_0': head},
                                 'batch_stats': ps}, x, train=False))
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    err = np.abs(got - ref).max()
    assert err <= INIT_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_convert_checks_names_and_shapes(imagenet_file):
    _, sd = imagenet_file
    assert sorted(convert_resnet_state_dict(
        {'resnet.' + k: v for k, v in sd.items()}, 'resnet18')) == sorted(
            k for k in sd if not k.endswith('num_batches_tracked'))
    with pytest.raises(ValueError, match='missing'):
        convert_resnet_state_dict(sd, 'resnet34')
    bad = dict(sd)
    bad['layer1.0.conv1.weight'] = np.zeros((64, 64, 1, 1), np.float32)
    with pytest.raises(ValueError, match='shapes'):
        convert_resnet_state_dict(bad, 'resnet18')


def test_pretrained_cli_and_its_guards(corpus, imagenet_file, tmp_path,
                                       monkeypatch):
    emb_dir, crop_dir = corpus
    path, _ = imagenet_file
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', crop_dir)
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 16)
    monkeypatch.setattr(tcli, 'VAL_LEN', 8)
    with pytest.raises(ValueError, match='--init_weights'):
        tcli.main(**_cli_kwargs(emb_dir, str(tmp_path / 'x'), num_epochs=1,
                                pretrained=True))
    save = str(tmp_path / 'run')
    trainer = tcli.main(**_cli_kwargs(emb_dir, save, num_epochs=1,
                                      pretrained=True, init_weights=path))
    with open(os.path.join(save, 'config.json')) as fp:
        config = json.load(fp)
    assert config['pretrained'] is True
    assert config['rgb_mean_std'] == [list(x) for x in tcli.default_config(
        'fs', EMB, pretrained=True)['rgb_mean_std']]
    assert trainer.state.step == 2
    # effnet students ignore pretrained, as in the reference
    trainer.config['encoder_arch'] = 'effnet-b0'
    with pytest.warns(UserWarning, match='ignored for effnet-b0'):
        trainer._init_pretrained(path, 5)
