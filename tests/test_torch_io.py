"""The port's host-side copies: `.emb.pkl` bytes, atomic writes, the
streaming pipeline and the crop-dir scanners, against vpd_tpu."""

import os
import threading

import numpy as np
import pytest

from vpd_tpu.infer import apply_vpd as japply
from vpd_tpu_torch import resolve_device
from vpd_tpu_torch.core import io as tio
from vpd_tpu_torch.core.pipeline import run_pipelined
from vpd_tpu_torch.infer import apply_vpd as tapply

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden',
                      'interchange.emb.pkl')


def _canonical_embs():
    # the content tests/golden/interchange.emb.pkl was written from
    rng = np.random.default_rng(1234)
    return [
        (0, rng.normal(size=(2, 8)).astype(np.float32),
         {'kp_score': 0.9, 'is_mean': False, 'is_flip': False}),
        (1, rng.normal(size=(2, 8)).astype(np.float32),
         {'kp_score': 0.75, 'is_mean': True}),
        (3, rng.normal(size=(8,)).astype(np.float32), {}),
    ]


def test_emb_pickle_keeps_the_golden_bytes(tmp_path):
    out = str(tmp_path / 'x.emb.pkl')
    tio.store_embs_pickle(out, _canonical_embs())
    with open(GOLDEN, 'rb') as a, open(out, 'rb') as b:
        assert a.read() == b.read()
    back = tio.load_embs_pickle(GOLDEN)
    assert [r[0] for r in back] == [0, 1, 3]
    np.testing.assert_array_equal(back[2][1], _canonical_embs()[2][1])


def test_emb_pickle_rejects_malformed_rows(tmp_path):
    with pytest.raises(TypeError):
        tio.store_embs_pickle(str(tmp_path / 'x.emb.pkl'),
                              [(0, [1., 2.], {})])
    assert not os.path.exists(tmp_path / 'x.emb.pkl')


def test_failed_write_keeps_the_old_file(tmp_path):
    path = str(tmp_path / 'x.pkl')
    tio.store_pickle(path, [1, 2, 3])

    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError('boom')

    with pytest.raises(RuntimeError):
        tio.store_pickle(path, [Unpicklable()])
    assert tio.load_pickle(path) == [1, 2, 3]
    assert os.listdir(tmp_path) == ['x.pkl']


def test_parse_time():
    assert tio.parse_time('1:02:03.5') == 3723.5
    assert tio.parse_time('7.25') == 7.25
    with pytest.raises(ValueError):
        tio.parse_time('1:2:3:4')


def test_run_pipelined_collects_every_chunk_once():
    seen, lock = [], threading.Lock()

    def collect(chunk, dev):
        with lock:
            seen.append((chunk, dev))

    run_pipelined(range(7), lambda c: c * 10, lambda h: h + 1, collect)
    assert sorted(seen) == [(c, c * 10 + 1) for c in range(7)]
    run_pipelined([], None, None, None)  # nothing to do, nothing called


def test_run_pipelined_raises_decode_errors():
    def decode(c):
        if c == 2:
            raise OSError('bad crop')
        return c

    with pytest.raises(OSError, match='bad crop'):
        run_pipelined(range(4), decode, lambda h: h, lambda c, d: None)


def test_scanners_match_vpd_tpu(tmp_path):
    crop_dir = tmp_path / 'crops'
    for v, frames in (('b', (3, 1, 12)), ('a', (0, 2))):
        os.makedirs(crop_dir / v)
        for f in frames:
            (crop_dir / v / '{}.png'.format(f)).write_bytes(b'')
            (crop_dir / v / '{}.flow.png'.format(f)).write_bytes(b'')
    (crop_dir / 'notes.txt').write_text('not a video')
    assert tapply.scan_crop_dir(str(crop_dir)) == \
        japply.scan_crop_dir(str(crop_dir))

    video_dir, tennis = tmp_path / 'videos', tmp_path / 'tennis'
    os.makedirs(video_dir)
    (video_dir / 'match1_10_14.mp4').write_bytes(b'')
    (video_dir / 'readme.txt').write_text('')
    for player, frames in (('front', (10, 11, 14)), ('back', (12,))):
        os.makedirs(tennis / 'match1' / player)
        for f in frames:
            (tennis / 'match1' / player / '{}.png'.format(f)).write_bytes(
                b'')
    ours = tapply.scan_tennis_crop_dir(str(video_dir), str(tennis))
    assert ours == japply.scan_tennis_crop_dir(str(video_dir), str(tennis))
    assert ours[0] == ['front__match1_10_14', 'back__match1_10_14']


def test_resolve_device():
    assert resolve_device('cpu').type == 'cpu'
    import torch
    if not torch.cuda.is_available():
        for dev in (None, 'cuda'):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                resolve_device(dev)
