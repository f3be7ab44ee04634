"""Video I/O utilities (host side, the offline preprocessing path).

Counterpart of `vpd_tpu/utils/video.py` (a copy: this package imports
nothing of `vpd_tpu`): cv2 metadata and decoding, ffmpeg segment cutting,
the square crop-with-pad of crop extraction. These run on the host,
upstream of the device pipeline (crop extraction, recutting). cv2 is
imported when a video is opened, never at import.
"""

import os
import random
from collections import namedtuple
from contextlib import contextmanager
from subprocess import check_call

import numpy as np

VideoMetadata = namedtuple('VideoMetadata', [
    'fps', 'num_frames', 'width', 'height'])


@contextmanager
def open_capture(video_path):
    """cv2.VideoCapture with guaranteed release."""
    import cv2
    vc = cv2.VideoCapture(video_path)
    try:
        yield vc
    finally:
        vc.release()


def _get_metadata(vc):
    import cv2
    return VideoMetadata(
        vc.get(cv2.CAP_PROP_FPS),
        int(vc.get(cv2.CAP_PROP_FRAME_COUNT)),
        int(vc.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(vc.get(cv2.CAP_PROP_FRAME_HEIGHT)))


def get_metadata(video_path):
    with open_capture(video_path) as vc:
        return _get_metadata(vc)


def decode_frame(video_path, frame_num):
    import cv2
    with open_capture(video_path) as vc:
        assert frame_num < _get_metadata(vc).num_frames
        vc.set(cv2.CAP_PROP_POS_FRAMES, frame_num)
        is_ok, frame = vc.read()
        assert is_ok
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


def pick_frame(video_path):
    with open_capture(video_path) as vc:
        return random.randint(0, _get_metadata(vc).num_frames - 1)


def _coarse_seek_ts(start_frame, fps):
    """'<s>.<centis>' seek string, replicating the reference's rendering
    (`util/video.py:36-38`): the centisecond field is NOT zero-padded, so
    e.g. 1.05s renders as '1.5' and seeks to 1.5s. Kept for byte-level
    command parity (QUIRKS.md)."""
    seconds = start_frame / fps
    return '{}.{}'.format(int(seconds), int(seconds * 100) % 100)


def cut_segment(video_file, video_meta, out_file, start, end, log=print):
    log('Extracting: {}'.format(out_file))
    check_call([
        'ffmpeg', '-ss', _coarse_seek_ts(start, video_meta.fps),
        '-i', video_file,
        '-c:v', 'libx264', '-c:a', 'aac', '-frames:v', str(end - start),
        '-y', out_file])


def cut_segment_cv2(video_file, video_meta, out_file, start, end,
                    log=print):
    """ffmpeg-free segment cut (reference util/video.py:65-81)."""
    import cv2
    log('Extracting using cv2: {}'.format(out_file))
    with open_capture(video_file) as vc:
        meta = _get_metadata(vc)
        vo = cv2.VideoWriter(out_file, cv2.VideoWriter_fourcc(*'mp4v'),
                             meta.fps, (meta.width, meta.height))
        vc.set(cv2.CAP_PROP_POS_FRAMES, start)
        try:
            for _ in range(end - start):
                ret, frame = vc.read()
                assert ret
                vo.write(frame)
        finally:
            vo.release()


def cut_frames(video_file, video_meta, out_dir, start, end,
               width=640, height=360, log=print):
    """Dump a segment as aspect-preserving letterboxed JPEG frames."""
    log('Extracting: {}'.format(out_dir))
    os.makedirs(out_dir)
    letterbox = ('scale=w={w}:h={h}:force_original_aspect_ratio=1,'
                 'pad={w}:{h}:(ow-iw)/2:(oh-ih)/2').format(w=width, h=height)
    check_call([
        'ffmpeg', '-ss', _coarse_seek_ts(start, video_meta.fps),
        '-i', video_file,
        '-frames:v', str(end - start), '-qscale:v', '2', '-vf', letterbox,
        '-y', os.path.join(out_dir, '%05d.jpg')])
    return len(os.listdir(out_dir))


def _square_span(lo, hi, side):
    """Re-center [lo, hi) to length `side` (midpoint-preserving; when
    `side` is odd the extra pixel goes before lo, matching the
    reference's decrement at `util/video.py:117-129`)."""
    mid = (lo + hi) // 2
    return mid - side // 2 - side % 2, mid + side // 2


def crop_frame(x1, y1, x2, y2, frame, make_square=False,
               pad_px=None, pad_frac=None):
    """Crop with optional squaring + padding; out-of-bounds zero-filled.

    Instead of slice-then-np.pad, the final box is computed up front and
    the in-bounds region blitted into a zeroed canvas — one allocation,
    no intermediate copies.
    """
    if make_square:
        side = max(y2 - y1, x2 - x1)
        if side > x2 - x1:
            x1, x2 = _square_span(x1, x2, side)
        elif side > y2 - y1:
            y1, y2 = _square_span(y1, y2, side)
    h, w = y2 - y1, x2 - x1

    if pad_frac is not None:
        pad_x, pad_y = int(w * pad_frac), int(h * pad_frac)
    else:
        pad_x = pad_y = pad_px if pad_px is not None else 0
    x1, x2 = x1 - max(pad_x, 0), x2 + max(pad_x, 0)
    y1, y2 = y1 - max(pad_y, 0), y2 + max(pad_y, 0)

    # The canvas geometry replicates the reference's slice-then-np.pad
    # arithmetic exactly, including its behavior for boxes lying fully
    # outside the frame (where the output is NOT (y2-y1, x2-x1) because
    # the near-side overshoot isn't padded back — see the oracle test's
    # out-of-bounds fuzzing).
    fh, fw = frame.shape[:2]
    sub = frame[max(y1, 0):y2, max(x1, 0):x2]
    top, left = -min(y1, 0), -min(x1, 0)
    out = np.zeros((top + sub.shape[0] + max(0, y2 - fh),
                    left + sub.shape[1] + max(0, x2 - fw))
                   + frame.shape[2:], dtype=frame.dtype)
    out[top:top + sub.shape[0], left:left + sub.shape[1]] = sub
    if make_square:
        assert out.shape[0] == out.shape[1], out.shape
    return out


def frames_to_video(out_file, frame_files, fps):
    import cv2
    if not frame_files:
        return  # nothing decoded -> no writer, no output file
    frames = (cv2.imread(f) for f in frame_files)
    first = next(frames)
    vo = cv2.VideoWriter(out_file, cv2.VideoWriter_fourcc(*'avc1'),
                         fps, (first.shape[1], first.shape[0]))
    try:
        vo.write(first)
        for img in frames:
            vo.write(img)
    finally:
        vo.release()
