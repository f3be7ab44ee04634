"""The ported slice end to end: student dir + crops -> .emb.pkl, against
vpd_tpu's `apply_vpd` on the same weights and crops.

A resnet18 student is made and saved by vpd_tpu (random non-trivial BN
statistics), a PNG crop tree is written as `tests/test_vpd.py` writes it,
and both packages extract. Bars: the same videos, frame order, row shapes
and dtypes; row cosine >= 1 - 1e-4 with float32 models in both, > 0.999
with the default bf16 models.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vpd_tpu.core import checkpoint as jckpt
from vpd_tpu.core.io import store_json as jstore_json
from vpd_tpu.data import crops as jcrops
from vpd_tpu.data.shards import pack_crops
from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu.train.vpd_loop import build_student as jbuild_student
from vpd_tpu.train.vpd_loop import default_config
from vpd_tpu_torch.data import crops as tcrops
from vpd_tpu_torch.data.shards import ShardReader
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.train.vpd_loop import build_student, save_student

torch.set_num_threads(2)

IMG = 32
EMB = 8
VIDEOS = ('video0', 'video1')
FRAMES = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_crop_tree(root, seed=0):
    rng = np.random.default_rng(seed)
    for v in VIDEOS:
        vdir = os.path.join(root, v)
        os.makedirs(vdir, exist_ok=True)
        # frames written out of order and with a gap: outputs must sort
        for f in (5, 0, 3, 1, 4, 7):
            arr = rng.integers(0, 255, size=(IMG, IMG, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(vdir, f'{f}.png'))
            flow = rng.integers(0, 255, size=(IMG, IMG, 3), dtype=np.uint8)
            Image.fromarray(flow).save(os.path.join(vdir, f'{f}.flow.png'))


def randomize_stats(tree, rng):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = randomize_stats(x, rng)
        elif k == 'mean':
            out[k] = rng.normal(0, 0.1, np.shape(x)).astype(np.float32)
        elif k == 'var':
            out[k] = rng.uniform(0.5, 2., np.shape(x)).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


def write_jax_student(model_dir, use_flow, seed=0):
    cfg = default_config('fs', EMB, img_dim=IMG, use_flow=use_flow,
                         encoder_arch='resnet18')
    model = jbuild_student(cfg, dtype=jnp.float32)
    v = model.init(jax.random.key(seed),
                   jnp.zeros((1, IMG, IMG, 5 if use_flow else 3)),
                   train=False)
    stats = randomize_stats(v['batch_stats']['encoder'],
                            np.random.default_rng(seed))
    os.makedirs(model_dir)
    jstore_json(os.path.join(model_dir, 'config.json'), cfg)
    jckpt.save_bundle(model_dir, 'best_epoch', {'encoder': {
        'params': jax.tree_util.tree_map(np.asarray,
                                         v['params']['encoder']),
        'batch_stats': stats}})
    return cfg


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('vpd')
    crop_dir = str(root / 'crops')
    write_crop_tree(crop_dir)
    dirs = {}
    for use_flow in (True, False):
        d = str(root / 'student_{}'.format('flow' if use_flow else 'rgb'))
        write_jax_student(d, use_flow, seed=int(use_flow))
        dirs[use_flow] = d
    return root, crop_dir, dirs


def load_out(out_dir):
    out = {}
    for f in sorted(os.listdir(out_dir)):
        if f.endswith('.emb.pkl'):
            with open(os.path.join(out_dir, f), 'rb') as fp:
                out[f[:-len('.emb.pkl')]] = pickle.load(fp)
    return out


def assert_same_extraction(port, ref, cos_bar):
    assert list(port) == list(ref) == list(VIDEOS)
    for name in ref:
        assert [r[0] for r in port[name]] == [r[0] for r in ref[name]] \
            == [0, 1, 3, 4, 5, 7]
        a = np.stack([r[1] for r in port[name]])
        b = np.stack([r[1] for r in ref[name]])
        assert a.shape == b.shape == (FRAMES, 2, EMB)
        assert a.dtype == b.dtype == np.float32
        assert all(r[2] == {} for r in port[name])
        a, b = a.reshape(-1, EMB).astype(np.float64), b.reshape(-1, EMB)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        assert cos.min() >= cos_bar, cos.min()


def run_both(world, use_flow, out, jax_dtype, torch_dtype, **kw):
    root, crop_dir, dirs = world
    videos, tasks = japply.scan_crop_dir(crop_dir)
    flow_name = 'flow' if use_flow else None
    jout, tout = str(root / (out + '_jax')), str(root / (out + '_torch'))
    japply.apply_vpd(videos, tasks, dirs[use_flow], jout,
                     flow_img_name=flow_name, batch_size=5,
                     prepared=japply.load_student_dir(dirs[use_flow],
                                                      dtype=jax_dtype),
                     log=lambda *a: None, **kw)
    tvideos, ttasks = tapply.scan_crop_dir(crop_dir)
    assert (tvideos, ttasks) == (videos, tasks)
    tapply.apply_vpd(tvideos, ttasks, dirs[use_flow], tout,
                     flow_img_name=flow_name, batch_size=5,
                     prepared=tapply.load_student_dir(
                         dirs[use_flow], dtype=torch_dtype, device='cpu'),
                     log=lambda *a: None, device='cpu', **kw)
    return load_out(tout), load_out(jout)


@pytest.mark.parametrize('use_flow', [True, False])
def test_f32_extraction_matches_vpd_tpu(world, use_flow):
    port, ref = run_both(world, use_flow, 'f32_{}'.format(use_flow),
                         jnp.float32, torch.float32)
    assert_same_extraction(port, ref, 1 - 1e-4)


@pytest.mark.parametrize('use_flow', [True, False])
def test_bf16_extraction_matches_vpd_tpu(world, use_flow):
    port, ref = run_both(world, use_flow, 'bf16_{}'.format(use_flow),
                         None, None)
    assert_same_extraction(port, ref, 0.999)


def test_no_flip_rows_match_vpd_tpu(world):
    """--no_flip: one variant, so rows are 1-D (D,) in both packages."""
    root, crop_dir, dirs = world
    videos, tasks = japply.scan_crop_dir(crop_dir)
    outs = []
    for pkg, prepared, kw in (
            (japply, japply.load_student_dir(dirs[True], dtype=jnp.float32),
             {}),
            (tapply, tapply.load_student_dir(dirs[True], dtype=torch.float32,
                                             device='cpu'),
             {'device': 'cpu'})):
        out = str(root / 'noflip_{}'.format(pkg.__name__.split('.')[0]))
        pkg.apply_vpd(videos, tasks, dirs[True], out, flow_img_name='flow',
                      no_flip=True, batch_size=4, prepared=prepared,
                      log=lambda *a: None, **kw)
        outs.append(load_out(out))
    port, ref = outs
    for name in ref:
        a = np.stack([r[1] for r in port[name]])
        b = np.stack([r[1] for r in ref[name]])
        assert a.shape == b.shape == (FRAMES, EMB)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_jitter_variants_match_vpd_tpu(world, tmp_path):
    """--jitter 1: the variants [orig, jitter, flip, flip-jitter] of one
    chunk, the jitter drawn by vpd_tpu (its key for chunk 3, variant 0)
    and passed to the port; float32 bars. Then the CLI path writes
    (4, D) rows."""
    from test_torch_augment import jax_jitter_draws

    root, crop_dir, dirs = world
    prefixes = [os.path.join(crop_dir, v, str(f)) for v in VIDEOS
                for f in (0, 3, 5)]
    rgb, flow, _ = jcrops.decode_crop_batch(
        [p + '.png' for p in prefixes], IMG,
        flow_paths=[p + '.flow.png' for p in prefixes], use_native=False)
    jmodel, jvars, cfg = japply.load_student_dir(dirs[True],
                                                 dtype=jnp.float32)
    key, chunk_i = jax.random.key(5), 3
    ref = np.asarray(japply.make_variant_embed(jmodel, jvars, cfg, jitter=1)(
        rgb, flow, key, np.int32(chunk_i)))
    draws = jax_jitter_draws(jax.random.fold_in(
        jax.random.fold_in(key, chunk_i), 0), len(rgb))
    model, tcfg = tapply.load_student_dir(dirs[True], dtype=torch.float32,
                                          device='cpu')
    fn = tapply.make_variant_embed(model, tcfg, jitter=1, device='cpu')
    got = fn(torch.from_numpy(rgb), torch.from_numpy(flow),
             jitter_draws=[draws]).numpy()
    assert got.shape == ref.shape == (len(rgb), 4, EMB)
    a, b = got.reshape(-1, EMB).astype(np.float64), ref.reshape(-1, EMB)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 1 - 1e-5, cos.min()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    videos, tasks = tapply.scan_crop_dir(crop_dir)
    out = str(tmp_path / 'jitter')
    tapply.apply_vpd(videos, tasks, dirs[True], out, flow_img_name='flow',
                     jitter=1, batch_size=4, device='cpu',
                     log=lambda *a: None)
    rows = load_out(out)['video0']
    assert [r[0] for r in rows] == [0, 1, 3, 4, 5, 7]
    assert all(r[1].shape == (4, EMB) and np.isfinite(r[1]).all()
               for r in rows)


def test_port_written_student_loads_in_vpd_tpu(world, tmp_path):
    _, crop_dir, _ = world
    cfg = default_config('fs', EMB, img_dim=IMG, use_flow=True,
                         motion=True, encoder_arch='resnet18')
    torch.manual_seed(0)
    model = build_student(cfg, dtype=torch.float32)
    save_student(str(tmp_path / 's'), model, cfg)
    assert sorted(os.listdir(tmp_path / 's')) == [
        'best_epoch.decoder.ckpt', 'best_epoch.encoder.ckpt', 'config.json']
    jmodel, jvars, jcfg = japply.load_student_dir(str(tmp_path / 's'),
                                                  dtype=jnp.float32)
    assert jcfg == cfg
    x = np.random.default_rng(0).uniform(-1, 1, (2, IMG, IMG, 5)).astype(
        np.float32)
    ref = np.asarray(jmodel.encoder.apply(
        {'params': jvars['params']['encoder'],
         'batch_stats': jvars['batch_stats']['encoder']}, x, train=False))
    back, _ = tapply.load_student_dir(str(tmp_path / 's'),
                                      dtype=torch.float32, device='cpu')
    with torch.no_grad():
        out = back.encoder(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        direct = model.eval().encoder(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(out, direct)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # the decoder round-trips too
    for name, p in model.motion.state_dict().items():
        assert torch.equal(p, back.motion.state_dict()[name]), name


def test_raw_shards_feed_the_port(world):
    root, crop_dir, dirs = world
    shard_dir = str(root / 'shards')
    pack_crops(crop_dir, shard_dir, IMG, flow_img_name='flow',
               use_mask=False, rows_per_shard=5, log=lambda *a: None)
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    assert len(reader) == len(VIDEOS) * FRAMES
    videos, tasks = tapply.scan_crop_dir(crop_dir)
    prepared = tapply.load_student_dir(dirs[True], device='cpu')
    outs = []
    for i, kw in enumerate(({}, {'shard_reader': reader})):
        out = str(root / 'shard_out{}'.format(i))
        tapply.apply_vpd(videos, tasks, dirs[True], out,
                         flow_img_name='flow', batch_size=4,
                         prepared=prepared, log=lambda *a: None,
                         device='cpu', **kw)
        outs.append(load_out(out))
    for name in outs[0]:
        for (fa, ea, _), (fb, eb, _) in zip(outs[0][name], outs[1][name]):
            assert fa == fb
            np.testing.assert_array_equal(ea, eb)


def test_cli_runs_on_cpu(world, tmp_path):
    root, crop_dir, dirs = world
    sports = tmp_path / 'sports'
    os.makedirs(sports / 'fs')
    os.symlink(crop_dir, sports / 'fs' / 'crops')
    out = tmp_path / 'out'
    env = dict(os.environ, VPD_SPORTS_DIR=str(sports), OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-m', 'vpd_tpu_torch.tools.apply_vpd', dirs[True],
         '-d', 'fs', '-o', str(out), '--flow_img', 'flow', '--batch_size',
         '8', '--device', 'cpu'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'Done!' in proc.stdout
    embs = load_out(str(out))
    assert list(embs) == list(VIDEOS)
    assert embs['video0'][0][1].shape == (2, EMB)


def test_entry_points_need_a_gpu_unless_told_cpu(world):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the CUDA default is valid here')
    _, crop_dir, dirs = world
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapply.load_student_dir(dirs[False])
    videos, tasks = tapply.scan_crop_dir(crop_dir)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapply.apply_vpd(videos, tasks, dirs[False], '/nonexistent')


@pytest.mark.parametrize('kw', [{'upload_codec': 'yuv420'},
                                {'mesh': object()}])
def test_unported_options_raise(world, kw):
    """The multi-device fan-out (ROADMAP A11) still raises. The yuv420
    upload codec is ported: both packages extract with it from PNGs, at
    the float32 bar (tests/test_torch_upload_codec.py covers shards)."""
    _, crop_dir, dirs = world
    videos, tasks = tapply.scan_crop_dir(crop_dir)
    if 'mesh' in kw:
        with pytest.raises(NotImplementedError, match='ROADMAP A11'):
            tapply.apply_vpd(videos, tasks, dirs[False], '/nonexistent',
                             device='cpu', **kw)
        return
    port, ref = run_both(world, True, 'yuv420', jnp.float32, torch.float32,
                         **kw)
    assert_same_extraction(port, ref, 1 - 1e-4)


def test_decoders_agree_and_keep_raw_flow_order(world, monkeypatch):
    """cv2 and PIL decodes in the port give the same bytes as vpd_tpu's
    cv2 path: rgb in RGB order, flow in raw (BGR) order. vpd_tpu's own PIL
    branch returns flow in RGB order instead (ROADMAP "C. Faults")."""
    _, crop_dir, _ = world
    prefixes = [os.path.join(crop_dir, v, str(f)) for v in VIDEOS
                for f in (0, 5)]
    rgb_paths = [p + '.png' for p in prefixes]
    flow_paths = [p + '.flow.png' for p in prefixes]
    ref_rgb, ref_flow, _ = jcrops.decode_crop_batch(
        rgb_paths, IMG, flow_paths=flow_paths, use_native=False)
    png_flow = np.stack([np.asarray(Image.open(p)) for p in flow_paths])
    np.testing.assert_array_equal(ref_flow, png_flow[..., ::-1])

    cv_rgb, cv_flow, _ = tcrops.decode_crop_batch(
        rgb_paths, IMG, flow_paths=flow_paths, use_native=False)
    monkeypatch.setattr(tcrops, '_cv2', lambda: None)
    pil_rgb, pil_flow, _ = tcrops.decode_crop_batch(
        rgb_paths, IMG, flow_paths=flow_paths, use_native=False)
    for rgb, flow in ((cv_rgb, cv_flow), (pil_rgb, pil_flow)):
        np.testing.assert_array_equal(rgb, ref_rgb)
        np.testing.assert_array_equal(flow, ref_flow)

    # the reference's PIL branch: flow channels reversed against cv2
    monkeypatch.setattr(jcrops, '_HAS_CV2', False)
    monkeypatch.setattr(jcrops, 'Image', Image, raising=False)
    _, jpil_flow, _ = jcrops.decode_crop_batch(
        rgb_paths, IMG, flow_paths=flow_paths, use_native=False)
    np.testing.assert_array_equal(jpil_flow, ref_flow[..., ::-1])
