"""The port's flow ops and `tools/compute_flow` against vpd_tpu's, on the
CPU.

- Quantization: `quantize_flow_device` gives vpd_tpu's bytes (and
  `flow_to_img`'s) with and without median subtraction, on even and odd
  pixel counts: the same float flow, the same uint8 payload.
- The LK pyramid's pieces (`_gray`, pooling, warp, box blur, the 2x
  upsample against `jax.image.resize`) at 1e-6 or exactly, and
  `lucas_kanade_flow` / `lucas_kanade_flow_gray` at atol 1e-4 on textured
  pairs. Flat and near-flat regions are held to the same 1e-4: exactly
  flat windows give zero gradients in both packages (0 / det, no step),
  and on the near-flat inputs here (sigma-8 blur, 1-level dither, half
  of the image constant) no clamped step flips on the CPU.
- The CLI with `--model lk` under raw, yuv420 and y8 on the same tree as
  vpd_tpu's CLI: every PNG value within one quantization step of
  vpd_tpu's and equal on at least 99.9% (a last-bit difference in the
  float flow can move a truncated value one step); with `--model raft`
  the PNGs byte-equal to the in-process quantized RAFT's payloads; flags
  equal vpd_tpu's plus `--device`; guards.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from vpd_tpu.ops import flow as jflow
from vpd_tpu.tools import compute_flow as jcli
from vpd_tpu_torch.ops import flow as tflow
from vpd_tpu_torch.tools import compute_flow as tcli

torch.set_num_threads(2)

LK_ATOL = 1e-4


def _scene(b, size, dx, dy, sigma=2., seed=0, flat_left=False):
    """Textured uint8 (B, S, S, 3) pairs: smoothed noise moved by (dx, dy)
    (wrapping), optionally constant on the left half."""
    rng = np.random.default_rng(seed)
    one, two = [], []
    for _ in range(b):
        base = np.stack([ndi.gaussian_filter(
            rng.integers(0, 255, (size, size)).astype(float), sigma)
            for _ in range(3)], axis=-1)
        if flat_left:
            base[:, :size // 2] = 100.
        one.append(base)
        two.append(np.roll(np.roll(base, dy, axis=0), dx, axis=1))
    return np.stack(one).astype(np.uint8), np.stack(two).astype(np.uint8)


# ------------------------------------------------------ quantization

@pytest.mark.parametrize('shape', [(3, 16, 16), (2, 5, 7)])
@pytest.mark.parametrize('median', [False, True])
def test_quantized_payloads_byte_equal(shape, median):
    rng = np.random.default_rng(11)
    flow = rng.normal(scale=12., size=shape + (2,)).astype(np.float32)
    ref = np.asarray(jflow.quantize_flow_device(jnp.asarray(flow), clip=20,
                                                subtract_median=median))
    got = tflow.quantize_flow_device(torch.from_numpy(flow), clip=20,
                                     subtract_median=median)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    host = np.stack([tflow.flow_to_img(
        tflow.subtract_median(f) if median else f, clip=20)[..., :2]
        for f in flow])
    np.testing.assert_array_equal(host, ref)
    for f in flow:
        np.testing.assert_array_equal(tflow.flow_to_img(f),
                                      jflow.flow_to_img(f))
        np.testing.assert_array_equal(tflow.subtract_median(f),
                                      jflow.subtract_median(f))


def test_median_is_the_midpoint():
    """An even count: jnp.median's (lo + hi) * 0.5, not torch.median's
    lower middle value."""
    flow = np.random.default_rng(2).normal(size=(4, 6, 8, 2)).astype(
        np.float32)
    ref = np.asarray(jnp.median(jnp.asarray(flow), axis=(1, 2),
                                keepdims=True))
    got = tflow._median_hw(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got, ref)
    lower = torch.from_numpy(flow).reshape(4, 48, 2).median(dim=1).values
    assert not np.array_equal(lower.numpy(), ref[:, 0, 0])


def test_quantized_flow_fn_wraps_an_estimator():
    a, b = _scene(2, 32, 1, 0, seed=3)
    fn = tflow.make_quantized_flow_fn(tflow.lucas_kanade_flow,
                                      subtract_median=True)
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    want = tflow.quantize_flow_device(tflow.lucas_kanade_flow(
        torch.from_numpy(a), torch.from_numpy(b)), subtract_median=True)
    assert torch.equal(got, want) and got.shape == (2, 32, 32, 2)


# -------------------------------------------------------------- LK

def test_lk_pieces_match_vpd_tpu():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 24)).astype(np.float32)
    fl = rng.normal(scale=3., size=(2, 16, 24, 2)).astype(np.float32)
    img = rng.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        tflow._gray(tflow.div255(torch.from_numpy(img))).numpy(),
        np.asarray(jflow._gray(jnp.asarray(img, jnp.float32) / 255.)))
    np.testing.assert_allclose(tflow._avg_pool2(tx).numpy(),
                               np.asarray(jflow._avg_pool2(jx)), atol=1e-6)
    np.testing.assert_allclose(
        tflow._bilinear_warp(tx, torch.from_numpy(fl)).numpy(),
        np.asarray(jflow._bilinear_warp(jx, jnp.asarray(fl))), atol=1e-6)
    for radius in (1, 3):
        np.testing.assert_allclose(tflow._box_blur(tx, radius).numpy(),
                                   np.asarray(jflow._box_blur(jx, radius)),
                                   atol=1e-6)
    # the 2x bilinear upsample against jax.image.resize (half-pixel
    # centres, edges clamped): the same weights, summed in another order
    small = rng.normal(size=(2, 4, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tflow._upsample2(torch.from_numpy(small)).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(small), (2, 8, 12, 2),
                                    'bilinear')), atol=1e-6)


@pytest.mark.parametrize('case', ['textured', 'sigma8', 'half_flat',
                                  'dither'])
def test_lk_flow_matches_vpd_tpu(case):
    if case == 'dither':
        rng = np.random.default_rng(6)
        a = (100 + rng.integers(0, 2, (2, 32, 32, 3))).astype(np.uint8)
        b = np.roll(a, 1, axis=2)
    else:
        a, b = _scene(2, 32, 2, -1, sigma=8. if case == 'sigma8' else 2.,
                      seed=5, flat_left=case == 'half_flat')
    ref = np.asarray(jflow.lucas_kanade_flow(a, b))
    got = tflow.lucas_kanade_flow(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=LK_ATOL)
    y1, y2 = a[..., 1], b[..., 1]
    np.testing.assert_allclose(
        tflow.lucas_kanade_flow_gray(torch.from_numpy(y1),
                                     torch.from_numpy(y2)).numpy(),
        np.asarray(jflow.lucas_kanade_flow_gray(y1, y2)), atol=LK_ATOL)


def test_lk_recovers_translation():
    a, b = _scene(1, 64, 3, -2, seed=1)
    flow = tflow.lucas_kanade_flow(torch.from_numpy(a), torch.from_numpy(b),
                                   num_iters=5).numpy()
    inner = flow[0, 16:48, 16:48]
    assert abs(np.median(inner[..., 0]) - 3) < 1.0
    assert abs(np.median(inner[..., 1]) + 2) < 1.0


# --------------------------------------------------------------- CLI

def write_pair_tree(root, n_videos=2, frames=3, size=32, seed=9):
    """<root>/v<i>/<f>.prev.png and <f>.png (BGR on disk, as cv2
    writes)."""
    for v in range(n_videos):
        a, b = _scene(frames, size, 2, 1, seed=seed + v)
        vdir = os.path.join(root, 'v{}'.format(v))
        os.makedirs(vdir, exist_ok=True)
        for f in range(frames):
            cv2.imwrite(os.path.join(vdir, '{}.prev.png'.format(f)), a[f])
            cv2.imwrite(os.path.join(vdir, '{}.png'.format(f)), b[f])


def read_outputs(root, out_name):
    out = {}
    for prefix in tcli.get_pairs(root, '.nothing', True):
        img = cv2.imread('{}.{}.png'.format(prefix, out_name),
                         cv2.IMREAD_UNCHANGED)
        assert img is not None and img.dtype == np.uint8, prefix
        out[prefix] = img
    return out


@pytest.fixture(scope='module')
def pair_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('pairs'))
    write_pair_tree(root)
    return root


@pytest.mark.parametrize('codec,median', [('raw', False), ('raw', True),
                                          ('yuv420', False), ('y8', False)])
def test_cli_lk_pngs_match_vpd_tpu(pair_tree, codec, median):
    name = '{}_{}'.format(codec, int(median))
    kw = dict(clip=20, img_dim=32, batch_size=4, overwrite=False,
              subtract_median_flag=median, upload_codec=codec)
    jcli.main(pair_tree, 'j' + name, **kw)
    assert tcli.main(pair_tree, 't' + name, device='cpu', **kw) == 6
    ref, got = read_outputs(pair_tree, 'j' + name), \
        read_outputs(pair_tree, 't' + name)
    assert list(got) == list(ref) and len(got) == 6
    a = np.stack(list(got.values())).astype(int)
    b = np.stack(list(ref.values())).astype(int)
    assert a.shape == (6, 32, 32, 3) and (a[..., 2] == 128).all()
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.999, (a == b).mean()
    # a second run skips the written pairs
    assert tcli.main(pair_tree, 't' + name, device='cpu', **kw) == 0


def test_cli_raft_pngs_are_the_card_half_s_payloads(tmp_path):
    """`compute_flow --model raft --raft_iters 2` (random init, bf16
    convolutions by `--mixed_precision`'s default) writes, for each pair
    of a 64 x 64 tree, the payload of the in-process
    `make_quantized_flow_fn(raft_flow_fn(...))` on the decoded frames,
    byte for byte, beside the constant third channel."""
    from vpd_tpu_torch.data.crops import decode_crop_batch
    from vpd_tpu_torch.models.raft import build_raft, raft_flow_fn

    root = str(tmp_path)
    write_pair_tree(root, size=64)
    assert tcli.main(root, 'raft', clip=20, img_dim=64, batch_size=8,
                     overwrite=False, model='raft', raft_iters=2,
                     device='cpu') == 6
    got = read_outputs(root, 'raft')
    prefixes = list(got)
    frames = [torch.from_numpy(decode_crop_batch(
        [p + suffix for p in prefixes], 64)[0])
        for suffix in ('.prev.png', '.png')]
    want = tflow.make_quantized_flow_fn(raft_flow_fn(
        build_raft(), iters=2, dtype=torch.bfloat16), clip=20)(*frames)
    png = np.stack([got[p] for p in prefixes])
    assert png.shape == (6, 64, 64, 3) and (png[..., 2] == 128).all()
    assert np.array_equal(png[..., :2], want.numpy())


def test_cli_flags_match_vpd_tpu():
    argv = ['crops', '--out_name', 'flow', '--model', 'raft', '--small',
            '--upload_codec', 'yuv420', '--mixed_precision', '']
    ref = vars(jcli.get_args(argv))
    got = vars(tcli.get_args(argv))
    assert got.pop('device') == 'cuda'
    assert got == ref
    assert got['mixed_precision'] is False
    # the reference's type=bool quirk: any non-empty value parses as True
    assert tcli.get_args(['c', '--out_name', 'f', '--mixed_precision',
                          'False']).mixed_precision is True
    assert tcli.get_args(['c', '--out_name', 'f', '--device',
                          'cpu']).device == 'cpu'


def test_cli_guards(pair_tree, tmp_path, monkeypatch):
    kw = dict(clip=20, img_dim=32, batch_size=2, overwrite=False)
    with pytest.raises(SystemExit, match='y8'):
        tcli.main(pair_tree, 'g', model='raft', upload_codec='y8',
                  device='cpu', **kw)
    with pytest.raises(SystemExit, match='existing torch RAFT'):
        tcli.main(pair_tree, 'g', model='rfat', device='cpu', **kw)
    ckpt = tmp_path / 'raft.pth'
    ckpt.write_bytes(b'')
    with pytest.raises(SystemExit, match='pass one or the other'):
        tcli.main(pair_tree, 'g', model=str(ckpt), raft_weights=str(ckpt),
                  device='cpu', **kw)
    # --data_parallel outside torchrun on a host with several GPUs
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    with pytest.raises(SystemExit, match='torchrun'):
        tcli.main(pair_tree, 'g', data_parallel=True, **kw)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(pair_tree, 'g', **kw)
    assert not any(f.endswith('.g.png') for _, _, fs in os.walk(pair_tree)
                   for f in fs)
