"""The port's path from video to crops against vpd_tpu's, on the CPU.

- `tools/extract_square_crops`: PNG trees (crop, prev, mask, and the
  `.viz` strips) byte-equal to vpd_tpu's on cv2-written mp4s
  (`chip_smoke.write_prep_corpus` at a tiny size: boxes missing on some
  frames and reaching past the edge, masks on both sides of the 0.8
  threshold), for the defaults, `--no_smooth`, `--target_fps` with
  `--num_prev_frames 2`, crops already at `-d` (no resize) and
  `--visualize` headless; the pooled run equals the serial one.
- Its pieces: `DelayBuffer` wraparound and unwritten slots,
  `_smooth_union` with and without a previous box, `_best_mask_canvas`
  with tied scores.
- The tool and its spawned workers start without torch (the package
  imports it lazily).
- `utils/video`: `crop_frame` on fuzzed boxes inside, across and wholly
  outside the frame, `_square_span`, `decode_frame`, `pick_frame`,
  `frames_to_video`; `utils/box`; `utils/display` with and without a
  DISPLAY.
"""

import json
import os
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from vpd_tpu.core.io import encode_png as jencode_png
from vpd_tpu.tools import extract_square_crops as jesc
from vpd_tpu.utils import box as jbox
from vpd_tpu.utils import display as jdisplay
from vpd_tpu.utils import video as jvideo
from vpd_tpu_torch.data.shards import scan_png_tree
from vpd_tpu_torch.tools import extract_square_crops as tesc
from vpd_tpu_torch.utils import box as tbox
from vpd_tpu_torch.utils import display as tdisplay
from vpd_tpu_torch.utils import video as tvideo

torch.set_num_threads(2)

FRAMES, SIZE, FPS = 14, (96, 64), 10.
DIM = 32
AT_DIM_BOX = [30.7, 12.2, 28., 28.]  # square 28 + 2 x int(2.8) = DIM


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('prep'))
    pose_dir, video_dir, expected = chip_smoke.write_prep_corpus(
        root, np.random.default_rng(3), videos=2, frames=FRAMES, size=SIZE,
        fps=FPS)
    # the same videos and masks under one constant box, whose square
    # padded crop is DIM already
    at_dim = os.path.join(root, 'pose_at_dim')
    for video in expected:
        os.makedirs(os.path.join(at_dim, video))
        with open(os.path.join(at_dim, video, 'boxes.json'), 'w') as fp:
            json.dump([[f, AT_DIM_BOX] for f in range(FRAMES)], fp)
        os.link(os.path.join(pose_dir, video, 'mask.json.gz'),
                os.path.join(at_dim, video, 'mask.json.gz'))
    return root, pose_dir, video_dir, at_dim, expected


CASES = {
    'defaults': dict(target_fps=None, num_prev_frames=1, no_smooth=False),
    'no_smooth': dict(target_fps=None, num_prev_frames=1, no_smooth=True),
    'target_fps_2_prev': dict(target_fps=4, num_prev_frames=2,
                              no_smooth=False),
    'at_dim': dict(target_fps=None, num_prev_frames=1, no_smooth=False),
    'visualize_headless': dict(target_fps=None, num_prev_frames=1,
                               no_smooth=False, visualize=True),
}


@pytest.mark.parametrize('case', list(CASES))
def test_crop_trees_byte_equal(corpus, case, tmp_path, monkeypatch):
    root, pose_dir, video_dir, at_dim, expected = corpus
    monkeypatch.delenv('DISPLAY', raising=False)
    if case == 'at_dim':
        pose_dir = at_dim
        crop = tvideo.crop_frame(
            *(int(c) for c in tesc._smooth_union(AT_DIM_BOX, None)),
            np.zeros(SIZE[::-1] + (3,), np.uint8), make_square=True,
            pad_px=tesc.PAD_PX, pad_frac=tesc.PAD_FRAC)
        assert crop.shape == (DIM, DIM, 3)  # no resize on this path
    kw = CASES[case]
    trees = {}
    for name, tool, parallelism in (('jax', jesc, 1), ('port', tesc, 1),
                                    ('port_pooled', tesc, 2)):
        if name == 'port_pooled' and case != 'defaults':
            continue
        out = str(tmp_path / name)
        tool.main(pose_dir, video_dir, out, DIM, parallelism=parallelism,
                  **kw)
        trees[name] = chip_smoke._file_tree(out)
    want = trees.pop('jax')
    assert len(want) > 2 * FRAMES
    for name, got in trees.items():
        assert sorted(got) == sorted(want), name
        for rel in want:
            assert got[rel] == want[rel], (name, rel)
    names = set(want)
    assert any(n.endswith('.mask.png') for n in names)
    if case == 'target_fps_2_prev':
        assert any(n.endswith('.prev2.png') for n in names)
    if case == 'visualize_headless':
        viz = [n for n in names if '/.viz/' in n]
        assert viz and {n.split('/.viz/')[0] for n in viz} == set(expected)
        # the hidden .viz dirs stay out of the shard packer's scan
        prefixes = {rel for rel, _ in scan_png_tree(str(tmp_path / 'port'))}
        assert prefixes and not any('.viz' in p for p in prefixes)
    else:
        assert not any('.viz' in n for n in names)
    if case == 'defaults':
        boxed = {'{}/{}.png'.format(v, f) for v, b in expected.items()
                 for f in b}
        assert {n for n in names if n.count('.') == 1} == boxed


def test_extract_tool_starts_without_torch():
    probe = ('import sys; import vpd_tpu_torch.tools.extract_square_crops; '
             'print(sorted(m for m in ("torch", "cv2", "jax") '
             'if m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', probe], cwd=chip_smoke.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_delay_buffer_wraparound():
    bufs = [jesc.DelayBuffer(4), tesc.DelayBuffer(4)]
    for step in range(11):
        for b in bufs:
            b.push(step)
        got = [[b.get(i) for i in range(9)] for b in bufs]
        assert got[0] == got[1]
        if step == 1:
            assert got[1][:4] == [1, 0, None, None]
    assert got[1][:6] == [10, 9, 8, 7, 10, 9]  # lookbacks wrap modulo 4


def test_smooth_union_and_best_mask_canvas():
    rng = np.random.default_rng(4)
    for _ in range(20):
        box = list(rng.uniform(-20, 80, 4))
        prev = None if rng.random() < 0.3 else list(rng.uniform(-20, 80, 4))
        assert tesc._smooth_union(box, prev) == jesc._smooth_union(box, prev)
    # ties on the score fall through to the box, then to the PNG string
    masks = [rng.random((6, 5)) > 0.5 for _ in range(4)]
    rows = [[0.9, [3, 2, 5, 6], jencode_png(masks[0])],
            [0.9, [1, 2, 5, 6], jencode_png(masks[1])],
            [0.9, [3, 2, 5, 6], jencode_png(masks[2])],
            [0.7, [9, 9, 5, 6], jencode_png(masks[3])]]
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1]):
        r = [rows[i] for i in order]
        got = tesc._best_mask_canvas(r, (16, 20))
        np.testing.assert_array_equal(got, jesc._best_mask_canvas(r, (16,
                                                                       20)))
        assert got.shape == (16, 20, 1) and set(np.unique(got)) <= {0, 255}
    assert tesc._best_mask_canvas(rows[3:], (16, 20)) is None
    assert tesc._best_mask_canvas([], (16, 20)) is None


@pytest.mark.parametrize('channels', [(3,), (1,), ()])
def test_crop_frame_fuzzed(channels):
    rng = np.random.default_rng(len(channels) + 5)
    fh, fw = 40, 60
    frame = rng.integers(0, 256, (fh, fw) + channels, np.uint8)
    kinds = {'inside': 0, 'across': 0, 'outside': 0, 'refused': 0}
    for _ in range(400):
        x1, y1 = int(rng.integers(-50, 80)), int(rng.integers(-40, 55))
        x2, y2 = x1 + int(rng.integers(1, 40)), y1 + int(rng.integers(1, 30))
        kw = dict(make_square=bool(rng.integers(2)),
                  pad_px=[None, 0, 5, 25][rng.integers(4)],
                  pad_frac=[None, 0.1, 0.3][rng.integers(3)])
        outs = []
        for mod in (tvideo, jvideo):
            try:
                outs.append(mod.crop_frame(x1, y1, x2, y2, frame, **kw))
            except AssertionError:
                # a square crop of a box wholly outside comes out
                # oblong, and both packages refuse it
                outs.append(None)
        got, want = outs
        if want is None:
            assert got is None and kw['make_square']
            kinds['refused'] += 1
            continue
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if x2 <= 0 or y2 <= 0 or x1 >= fw or y1 >= fh:
            kinds['outside'] += 1
        elif x1 >= 0 and y1 >= 0 and x2 <= fw and y2 <= fh:
            kinds['inside'] += 1
        else:
            kinds['across'] += 1
    assert min(kinds.values()) >= 10, kinds
    for lo, hi, side in ((0, 5, 9), (3, 4, 8), (-7, 2, 12), (10, 10, 1)):
        assert tvideo._square_span(lo, hi, side) == \
            jvideo._square_span(lo, hi, side)


def test_box_helpers():
    rng = np.random.default_rng(6)
    for _ in range(50):
        a, b = (tuple(int(v) for v in rng.integers(-10, 30, 4))
                for _ in range(2))
        a = a[:2] + (abs(a[2]) + 1, abs(a[3]) + 1)
        b = b[:2] + (abs(b[2]) + 1, abs(b[3]) + 1)
        ta, tb, ja, jb = tbox.Box(*a), tbox.Box(*b), jbox.Box(*a), jbox.Box(*b)
        assert (ta.x2, ta.y2, ta.area) == (ja.x2, ja.y2, ja.area)
        assert tbox.calc_iou(ta, tb) == jbox.calc_iou(ja, jb)
        assert tuple(tbox.calc_union(ta, tb)) == tuple(jbox.calc_union(ja,
                                                                       jb))
        x, y = (int(v) for v in rng.integers(-12, 35, 2))
        assert tbox.calc_contains(ta, x, y) == jbox.calc_contains(ja, x, y)


def test_display_gate(tmp_path, monkeypatch):
    img = np.random.default_rng(7).integers(0, 256, (8, 12, 3), np.uint8)
    monkeypatch.delenv('DISPLAY', raising=False)
    for name, mod in (('port', tdisplay), ('jax', jdisplay)):
        path = str(tmp_path / name / '.viz' / '0.png')
        mod.imshow_or_save('w', img, path)
        np.testing.assert_array_equal(cv2.imread(path), img)
    shown = []
    monkeypatch.setenv('DISPLAY', ':99')
    monkeypatch.setattr(cv2, 'imshow', lambda w, i: shown.append((w, i)))
    monkeypatch.setattr(cv2, 'waitKey', lambda ms: shown.append(ms))
    for mod in (tdisplay, jdisplay):
        mod.imshow_or_save('w', img, str(tmp_path / 'never.png'), wait_ms=5)
    assert [s if isinstance(s, int) else s[0] for s in shown] == \
        ['w', 5, 'w', 5]
    assert not os.path.exists(tmp_path / 'never.png')


def test_decode_and_pick_frame(corpus):
    _, _, video_dir, _, _ = corpus
    path = os.path.join(video_dir, 'prep_video0.mp4')
    assert tvideo.get_metadata(path) == jvideo.get_metadata(path)
    for f in (0, 5, FRAMES - 1):
        got = tvideo.decode_frame(path, f)
        assert got.shape == SIZE[::-1] + (3,)
        np.testing.assert_array_equal(got, jvideo.decode_frame(path, f))
    random.seed(11)
    picks = [tvideo.pick_frame(path) for _ in range(5)]
    random.seed(11)
    assert picks == [jvideo.pick_frame(path) for _ in range(5)]
    assert all(0 <= p < FRAMES for p in picks)


def test_frames_to_video(tmp_path):
    rng = np.random.default_rng(8)
    files = []
    for i in range(4):
        files.append(str(tmp_path / '{}.png'.format(i)))
        cv2.imwrite(files[-1], rng.integers(0, 256, (32, 48, 3), np.uint8))
    outs = {}
    for name, mod in (('port', tvideo), ('jax', jvideo)):
        outs[name] = str(tmp_path / '{}.mp4'.format(name))
        mod.frames_to_video(outs[name], files, 10)
        mod.frames_to_video(str(tmp_path / '{}_none.mp4'.format(name)), [],
                            10)
        assert not os.path.exists(tmp_path / '{}_none.mp4'.format(name))
    # the avc1 encoder may be missing from this cv2 build: then neither
    # package writes a readable video
    metas = {n: tvideo.get_metadata(p) for n, p in outs.items()}
    assert metas['port'] == metas['jax']
    if metas['port'].num_frames:
        frames = {}
        for n, p in outs.items():
            vc = cv2.VideoCapture(p)
            frames[n] = [vc.read()[1] for _ in range(metas[n].num_frames)]
            vc.release()
        for a, b in zip(frames['port'], frames['jax']):
            np.testing.assert_array_equal(a, b)
