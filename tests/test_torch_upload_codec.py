"""The port's yuv420 upload codec against vpd_tpu's, on the CPU.

- The encoders (numpy and the native packers, yuv420 and y8 luma) give
  vpd_tpu's bytes; `decode_yuv420` on tensors equals vpd_tpu's device
  decode and `decode_yuv420_reference` bit for bit, on encoder output and
  on arbitrary packed bytes.
- yuv420 shards: `pack_crops(codec='yuv420')` writes vpd_tpu's files
  byte for byte; each package reads the other's; `fill_or_decode` gives
  packed rows, encodes the rows it decodes, and refuses a codec mismatch.
- `apply_vpd(upload_codec='yuv420')` from PNGs, raw shards and yuv420
  shards: the same `.emb.pkl` all three ways, within cos >= 1 - 1e-4
  (float32) of vpd_tpu's yuv420 run, its own bar
  (`__graft_entry__.py:196-198`). Mismatched shards and codec raise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_apply_vpd import (IMG, VIDEOS, assert_same_extraction,
                                  load_out, write_crop_tree,
                                  write_jax_student)
from vpd_tpu.data import upload_codec as jcodec
from vpd_tpu.data.shards import ShardReader as JShardReader
from vpd_tpu.data.shards import pack_crops as jpack_crops
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu_torch.data import native_loader as tnative
from vpd_tpu_torch.data import shards as tshards
from vpd_tpu_torch.data import upload_codec as tcodec
from vpd_tpu_torch.infer import apply_vpd as tapply

torch.set_num_threads(2)


def _quiet(*args):
    pass


def _rgb(seed, shape=(5, IMG, IMG, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture(params=['numpy', 'native'])
def packer(request, monkeypatch):
    """Run a test with the numpy encoders, then with the native packers."""
    if request.param == 'native':
        if not tnative.available():
            pytest.skip('the native packers cannot be built here')
    else:
        monkeypatch.setattr(tcodec, '_native_packer', lambda name: False)
    return request.param


@pytest.mark.parametrize('shape', [(5, IMG, IMG, 3), (3, 30, 46, 3)])
def test_encoders_match_vpd_tpu(packer, shape):
    rgb = _rgb(1, shape)
    before = dict(tcodec.packer_calls)
    packed = tcodec.encode_yuv420(rgb)
    assert tcodec.packer_calls[packer] == before[packer] + 1
    assert packed.shape == (shape[0], tcodec.packed_nbytes(*shape[1:3]))
    assert packed.nbytes * 2 == rgb.nbytes
    np.testing.assert_array_equal(packed, jcodec.encode_yuv420_numpy(rgb))
    np.testing.assert_array_equal(tcodec.encode_yuv420_numpy(rgb), packed)
    luma = tcodec.encode_luma(rgb)
    np.testing.assert_array_equal(luma, jcodec.encode_luma(rgb))
    np.testing.assert_array_equal(luma, packed[:, :shape[1] * shape[2]])
    # odd dims: luma only (yuv420 needs even ones)
    odd = _rgb(2, (2, 15, 17, 3))
    np.testing.assert_array_equal(tcodec.encode_luma(odd),
                                  jcodec.encode_luma(odd))
    with pytest.raises(ValueError, match='even'):
        tcodec.encode_yuv420(odd)


@pytest.mark.parametrize('source', ['encoded', 'arbitrary'])
def test_decode_bit_equal_to_vpd_tpu(source):
    """Encoder output, and arbitrary bytes in every plane (chroma far
    from any encoder's, so every clip and rounding edge is reached)."""
    if source == 'encoded':
        packed = jcodec.encode_yuv420_numpy(_rgb(3))
    else:
        packed = np.random.default_rng(5).integers(
            0, 256, (64, tcodec.packed_nbytes(IMG, IMG)), dtype=np.uint8)
    ref = jcodec.decode_yuv420_reference(packed, IMG, IMG)
    np.testing.assert_array_equal(
        np.asarray(jcodec.decode_yuv420(jnp.asarray(packed), IMG, IMG)), ref)
    np.testing.assert_array_equal(
        tcodec.decode_yuv420_reference(packed, IMG, IMG), ref)
    got = tcodec.decode_yuv420(torch.from_numpy(packed), IMG, IMG)
    assert got.dtype == torch.uint8 and got.shape == (len(packed), IMG,
                                                      IMG, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_codec_constants_match_vpd_tpu():
    assert tcodec.CODECS == jcodec.CODECS
    assert tcodec.FLOW_CODECS == jcodec.FLOW_CODECS
    assert tcodec.packed_nbytes(6, 10) == jcodec.packed_nbytes(6, 10)


# ------------------------------------------------------------- shards

@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """A PNG crop tree (2 videos x 6 frames, rgb + flow), vpd_tpu's raw
    and yuv420 shards of it, and a float32 flow student."""
    root = tmp_path_factory.mktemp('codec')
    crop_dir = str(root / 'crops')
    write_crop_tree(crop_dir, seed=7)
    shards = {}
    for codec in ('raw', 'yuv420'):
        shards[codec] = str(root / ('shards_' + codec))
        jpack_crops(crop_dir, shards[codec], IMG, flow_img_name='flow',
                    use_mask=False, rows_per_shard=5, use_native=False,
                    codec=codec, log=_quiet)
    student = str(root / 'student')
    write_jax_student(student, True, seed=3)
    return root, crop_dir, shards, student


def _read_dir(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), 'rb') as fp:
            out[name] = fp.read()
    return out


def test_yuv420_shards_byte_equal_to_vpd_tpu(world, tmp_path, packer):
    _, crop_dir, shards, _ = world
    mine = str(tmp_path / 'port')
    n = tshards.pack_crops(crop_dir, mine, IMG, flow_img_name='flow',
                           use_mask=False, rows_per_shard=5,
                           use_native=False, codec='yuv420', log=_quiet)
    assert n == len(VIDEOS) * 6
    assert _read_dir(mine) == _read_dir(shards['yuv420'])


def test_readers_read_each_others_yuv420_shards(world):
    _, crop_dir, shards, _ = world
    prefixes = [os.path.join(crop_dir, rel)
                for rel, _ in tshards.scan_png_tree(crop_dir)]
    raw, _, _ = tshards.decode_crop_batch([p + '.png' for p in prefixes],
                                          IMG, use_native=False)
    want = jcodec.encode_yuv420_numpy(raw)
    row = (tcodec.packed_nbytes(IMG, IMG),)
    for reader in (tshards.ShardReader(shards['yuv420'], crop_root=crop_dir),
                   JShardReader(shards['yuv420'], crop_root=crop_dir)):
        assert reader.codec == 'yuv420'
        got = np.zeros((len(prefixes),) + row, np.uint8)
        assert reader.fill(prefixes, got) == []
        np.testing.assert_array_equal(got, want)
    reader = tshards.ShardReader(shards['yuv420'], crop_root=crop_dir)
    # rows not in the shards are decoded and encoded to match
    extra = os.path.join(crop_dir, 'video0', '99')
    os.link(prefixes[0] + '.png', extra + '.png')
    os.link(prefixes[0] + '.flow.png', extra + '.flow.png')
    try:
        rgb, flow, _ = tshards.fill_or_decode(
            reader, [prefixes[3], extra], IMG, flow_img_name='flow',
            flow_out=np.zeros((2, IMG, IMG, 3), np.uint8), codec='yuv420')
    finally:
        for ext in ('.png', '.flow.png'):
            os.remove(extra + ext)
    np.testing.assert_array_equal(rgb, want[[3, 0]])
    assert flow.shape == (2, IMG, IMG, 3)
    with pytest.raises(ValueError, match='codec "yuv420", requested "raw"'):
        tshards.fill_or_decode(reader, prefixes[:2], IMG)
    raw_reader = tshards.ShardReader(shards['raw'], crop_root=crop_dir)
    with pytest.raises(ValueError, match='codec "raw", requested "yuv420"'):
        tshards.fill_or_decode(raw_reader, prefixes[:2], IMG,
                               codec='yuv420')


# --------------------------------------------------------- apply_vpd

def _port_yuv420(world, out, **kw):
    root, crop_dir, _, student = world
    videos, tasks = tapply.scan_crop_dir(crop_dir)
    tapply.apply_vpd(videos, tasks, student, str(root / out),
                     flow_img_name='flow', batch_size=5,
                     prepared=tapply.load_student_dir(
                         student, dtype=torch.float32, device='cpu'),
                     upload_codec='yuv420', log=_quiet, device='cpu', **kw)
    return load_out(str(root / out))


def test_apply_vpd_yuv420_all_sources_agree_with_vpd_tpu(world):
    """From PNGs, raw shards and yuv420 shards: the same rows to the bit;
    against vpd_tpu's yuv420 run from its yuv420 shards at cos >= 1-1e-4.
    The raw run differs (chroma is lossy), so the codec really ran."""
    root, crop_dir, shards, student = world
    readers = {c: tshards.ShardReader(shards[c], crop_root=crop_dir)
               for c in shards}
    runs = {'png': _port_yuv420(world, 'y_png'),
            'raw_shards': _port_yuv420(world, 'y_raw',
                                       shard_reader=readers['raw']),
            'yuv_shards': _port_yuv420(world, 'y_yuv',
                                       shard_reader=readers['yuv420'])}
    for name in ('raw_shards', 'yuv_shards'):
        for v in VIDEOS:
            for (fa, ea, _), (fb, eb, _) in zip(runs['png'][v],
                                                runs[name][v]):
                assert fa == fb
                np.testing.assert_array_equal(ea, eb)
    videos, tasks = japply.scan_crop_dir(crop_dir)
    jout = str(root / 'y_jax')
    japply.apply_vpd(videos, tasks, student, jout, flow_img_name='flow',
                     batch_size=5,
                     prepared=japply.load_student_dir(student,
                                                      dtype=jnp.float32),
                     shard_reader=JShardReader(shards['yuv420'],
                                               crop_root=crop_dir),
                     upload_codec='yuv420', log=_quiet)
    assert_same_extraction(runs['yuv_shards'], load_out(jout), 1 - 1e-4)

    raw = str(root / 'y_none')
    tapply.apply_vpd(videos, tasks, student, raw, flow_img_name='flow',
                     batch_size=5,
                     prepared=tapply.load_student_dir(
                         student, dtype=torch.float32, device='cpu'),
                     log=_quiet, device='cpu')
    raw_rows = load_out(raw)['video0']
    assert not all(np.array_equal(a[1], b[1])
                   for a, b in zip(raw_rows, runs['png']['video0']))


def test_yuv420_shards_need_the_yuv420_codec(world):
    root, crop_dir, shards, student = world
    videos, tasks = tapply.scan_crop_dir(crop_dir)
    reader = tshards.ShardReader(shards['yuv420'], crop_root=crop_dir)
    with pytest.raises(ValueError, match='upload_codec="yuv420"'):
        tapply.apply_vpd(videos, tasks, student, str(root / 'bad'),
                         flow_img_name='flow', shard_reader=reader,
                         log=_quiet, device='cpu')
    with pytest.raises(ValueError, match='unknown upload_codec'):
        tapply.apply_vpd(videos, tasks, student, str(root / 'bad'),
                         flow_img_name='flow', upload_codec='y8',
                         log=_quiet, device='cpu')
    assert not os.path.exists(root / 'bad')


def test_variant_embed_decodes_packed_planes(world):
    """make_variant_embed(upload_codec='yuv420') on packed planes equals
    the raw embed on the decoded pixels, with and without jitter."""
    _, _, _, student = world
    model, cfg = tapply.load_student_dir(student, dtype=torch.float32,
                                         device='cpu')
    rgb = _rgb(9, (3, IMG, IMG, 3))
    flow = torch.from_numpy(_rgb(10, (3, IMG, IMG, 3)))
    packed = torch.from_numpy(jcodec.encode_yuv420_numpy(rgb))
    pixels = tcodec.decode_yuv420(packed, IMG, IMG)
    for jitter in (0, 1):
        coded = tapply.make_variant_embed(model, cfg, jitter=jitter,
                                          upload_codec='yuv420',
                                          device='cpu')
        plain = tapply.make_variant_embed(model, cfg, jitter=jitter,
                                          device='cpu')
        np.testing.assert_array_equal(coded(packed, flow, 2).numpy(),
                                      plain(pixels, flow, 2).numpy())

