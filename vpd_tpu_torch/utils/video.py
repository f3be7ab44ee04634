"""Video metadata (counterpart of `vpd_tpu/utils/video.py:24-52`).

Only what the recognition path needs: the `VideoMetadata` namedtuple the
cached metadata pickles hold, and `get_metadata` for raw videos. cv2 is
imported when a video is opened, never at import.
"""

from collections import namedtuple
from contextlib import contextmanager

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
