"""The port's recut tools and segment cutters against vpd_tpu's, on the
CPU (no ffmpeg here: `check_call` is patched in both packages'
`utils/video` and records the argv).

- `recut_fs_video.main` on a synthetic `segments.csv` (through a patched
  `ACTION_DATA_DIR`) and `.mkv` sources, with and without `--padding`:
  the same ffmpeg argv in the same order. Its pool is replaced by a
  serial one in both packages; a missing source raises in both.
- `recut_finegym_video.main` on a synthetic annotation file (through a
  patched `ANNOTATION_FILE`): one video as `.mp4`, one absent (its `.mkv`
  fallback reads as no video), events of the wanted type and others, a
  clip already cut; the same argv. Two timestamps on one event fail in
  both.
- `cut_segment_cv2` writes the same frames (and bytes), `cut_frames` the
  same letterbox argv, `_coarse_seek_ts` the same unpadded strings
  (1.05 s renders as '1.5').
"""

import json
import os
import types

import cv2
import numpy as np
import pytest
import torch

from vpd_tpu.tools import recut_finegym_video as jgym
from vpd_tpu.tools import recut_fs_video as jfs
from vpd_tpu.utils import video as jvideo
from vpd_tpu_torch.tools import recut_finegym_video as tgym
from vpd_tpu_torch.tools import recut_fs_video as tfs
from vpd_tpu_torch.utils import video as tvideo

torch.set_num_threads(2)

PACKAGES = (('jax', jvideo, jfs, jgym), ('port', tvideo, tfs, tgym))


def _write_video(path, frames=30, fps=25., size=(64, 48), seed=0):
    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), fps, size)
    assert vw.isOpened()
    for _ in range(frames):
        vw.write(rng.integers(0, 256, size[::-1] + (3,), np.uint8))
    vw.release()


class _SerialPool:
    def __init__(self, processes):
        self.processes = processes

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def starmap(self, fn, args):
        return [fn(*a) for a in args]


_SERIAL_MP = types.SimpleNamespace(
    Pool=_SerialPool,
    get_context=lambda method: types.SimpleNamespace(Pool=_SerialPool))


@pytest.fixture
def argv_log(monkeypatch):
    """{package: [argv]} of every ffmpeg call, with serial pools."""
    log = {}
    for name, video, fs, _ in PACKAGES:
        calls = log.setdefault(name, [])
        monkeypatch.setattr(video, 'check_call',
                            lambda argv, calls=calls: calls.append(argv))
        monkeypatch.setattr(fs, 'multiprocessing', _SERIAL_MP)
    return log


@pytest.mark.parametrize('padding', [0, 2])
def test_recut_fs_video_argv(padding, tmp_path, monkeypatch, argv_log):
    action_dir = tmp_path / 'action_dataset'
    os.makedirs(action_dir / 'fs')
    with open(action_dir / 'fs' / 'segments.csv', 'w') as fp:
        fp.write('video,start,end\n'
                 'skate_a,00:00:03,00:00:09\n'
                 'skate_b,00:01:02,00:01:30\n'
                 'skate_a,01:00:00,01:00:07\n')
    video_dir = tmp_path / 'mkv'
    os.makedirs(video_dir)
    _write_video(str(video_dir / 'skate_a.mkv'), fps=25.)
    _write_video(str(video_dir / 'skate_b.mkv'), fps=29.97, seed=1)
    out_dir = str(tmp_path / 'clips')
    for name, _, fs, _ in PACKAGES:
        monkeypatch.setattr(fs, 'ACTION_DATA_DIR', str(action_dir))
        fs.main(str(video_dir), out_dir, padding)
    assert len(argv_log['port']) == 3
    assert argv_log['port'] == argv_log['jax']
    outs = sorted(os.path.basename(a[-1]) for a in argv_log['port'])
    assert outs[0].startswith('skate_a_01_') and outs[2].startswith(
        'skate_b_01_')
    os.remove(video_dir / 'skate_b.mkv')
    for _, _, fs, _ in PACKAGES:
        with pytest.raises(AssertionError, match='missing source video'):
            fs.main(str(video_dir), out_dir, padding)


def test_recut_fs_segments_parse(tmp_path):
    path = tmp_path / 'segments.csv'
    path.write_text('video,start,end\nv,00:00:01,00:02:03\nw,1:0:0,1:0:1\n'
                    'v,00:10:00,00:10:30\n')
    assert tfs.load_segments(str(path)) == jfs.load_segments(str(path))
    for s in ('00:00:00', '01:02:03', '10:59:59'):
        assert tfs.parse_duration(s) == jfs.parse_duration(s)


def _annotations(path):
    ann = {
        'gym_a': {'E_000001_000010': {'event': 2, 'timestamps': [[1.02,
                                                                   3.5]]},
                  'E_000020_000030': {'event': 1, 'timestamps': [[0.0,
                                                                   0.4]]},
                  'E_000040_000050': {'event': 2, 'timestamps': [[0.5,
                                                                   0.75]]}},
        'gym_missing': {'E_000001_000002': {'event': 2,
                                            'timestamps': [[2.0, 4.0]]}},
    }
    with open(path, 'w') as fp:
        json.dump(ann, fp)
    return ann


@pytest.mark.parametrize('event', ['female_FX', 'female_VT'])
def test_recut_finegym_video_argv(event, tmp_path, monkeypatch, argv_log):
    ann_file = str(tmp_path / 'ann.json')
    ann = _annotations(ann_file)
    video_dir = tmp_path / 'videos'
    os.makedirs(video_dir)
    _write_video(str(video_dir / 'gym_a.mp4'), fps=25.)
    out_dir = tmp_path / 'clips'
    os.makedirs(out_dir)
    (out_dir / 'gym_a_E_000040_000050.mp4').touch()  # already cut: skipped
    for _, _, _, gym in PACKAGES:
        monkeypatch.setattr(gym, 'ANNOTATION_FILE', ann_file)
        gym.main(str(video_dir), event, str(out_dir))
        gym.main(str(video_dir), event, None)  # no -o: nothing is cut
    assert argv_log['port'] == argv_log['jax']
    wanted = sum(e['event'] == tgym.EVENT_TYPES[event]
                 for events in ann.values() for e in events.values())
    assert len(argv_log['port']) == wanted - (event == 'female_FX')
    for a in argv_log['port']:
        assert a[0] == 'ffmpeg' and a[-1].startswith(str(out_dir))
    for tool in (tgym, jgym):
        assert tool._find_video(str(video_dir), 'gym_a').endswith('.mp4')
        assert tool._find_video(str(video_dir),
                                'gym_missing').endswith('.mkv')
    assert tvideo.get_metadata(str(video_dir / 'gym_missing.mkv')) == \
        jvideo.get_metadata(str(video_dir / 'gym_missing.mkv'))


def test_recut_finegym_two_timestamps_fail(tmp_path, monkeypatch, argv_log):
    ann_file = str(tmp_path / 'ann.json')
    with open(ann_file, 'w') as fp:
        json.dump({'v': {'E1': {'event': 2, 'timestamps': [[0, 1],
                                                           [2, 3]]}}}, fp)
    for _, _, _, gym in PACKAGES:
        monkeypatch.setattr(gym, 'ANNOTATION_FILE', ann_file)
        with pytest.raises(AssertionError, match='Too many timestamps'):
            gym.main(str(tmp_path), 'female_FX', None)
    for fps in (25., 29.97, 59.94):
        for ts in ([0.0, 1.0], [1.013, 7.51], [100.2, 101.999]):
            data = {'timestamps': [ts]}
            assert tgym._event_frame_window(data, fps) == \
                jgym._event_frame_window(data, fps)


def test_cut_segment_cv2_frames(tmp_path):
    src = str(tmp_path / 'src.mp4')
    _write_video(src, frames=20, seed=4)
    meta = tvideo.get_metadata(src)
    outs = {}
    for name, video, _, _ in PACKAGES:
        outs[name] = str(tmp_path / '{}.mp4'.format(name))
        video.cut_segment_cv2(src, meta, outs[name], 5, 12,
                              log=lambda *a: None)
    frames = {}
    for name, path in outs.items():
        vc = cv2.VideoCapture(path)
        frames[name] = [vc.read()[1] for _ in range(7)]
        assert not vc.read()[0]
        vc.release()
    for a, b in zip(frames['port'], frames['jax']):
        assert a is not None
        np.testing.assert_array_equal(a, b)
    with open(outs['port'], 'rb') as a, open(outs['jax'], 'rb') as b:
        assert a.read() == b.read()


def test_cut_segment_and_frames_argv(tmp_path, argv_log):
    meta = tvideo.VideoMetadata(29.97, 1000, 640, 360)
    for name, video, _, _ in PACKAGES:
        video.cut_segment('in.mp4', meta, 'out.mp4', 31, 90,
                          log=lambda *a: None)
        out_dir = str(tmp_path / 'frames' / name)
        assert video.cut_frames('in.mp4', meta, out_dir, 100, 160,
                                width=320, height=180,
                                log=lambda *a: None) == 0
        argv_log[name][-1][-1] = os.path.basename(argv_log[name][-1][-1])
    assert argv_log['port'] == argv_log['jax'] and len(argv_log['port']) == 2
    assert argv_log['port'][0][:3] == ['ffmpeg', '-ss', '1.3']


def test_coarse_seek_ts_unpadded():
    for fps in (25., 29.97, 30., 59.94):
        for start in range(0, 400, 7):
            assert tvideo._coarse_seek_ts(start, fps) == \
                jvideo._coarse_seek_ts(start, fps)
    assert tvideo._coarse_seek_ts(21, 20.) == '1.5'  # 1.05 s
    assert tvideo._coarse_seek_ts(0, 25.) == '0.0'
