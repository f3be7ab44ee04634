#!/usr/bin/env python3
"""Cut FineGym broadcasts into per-event clips '<video>_<event>.mp4'.

Counterpart of `vpd_tpu/tools/recut_finegym_video.py`, with its flags and
ffmpeg commands: video resolution and the frame-window math live in
helpers; every event's window is validated (exactly one timestamp pair)
before the event-type filter. Reads `datasets.finegym.ANNOTATION_FILE`
(not shipped in the repository) and needs ffmpeg on the PATH. Usage:

    python -m vpd_tpu_torch.tools.recut_finegym_video <video_dir>
        {female_VT,female_FX,female_BB,female_UB} -o <out_dir>
"""

import argparse
import math
import os

from ..core.io import load_json
from ..datasets.finegym import ANNOTATION_FILE
from ..utils.video import cut_segment, get_metadata

EVENT_TYPES = {
    'female_VT': 1,
    'female_FX': 2,
    'female_BB': 3,
    'female_UB': 4,
}


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('video_dir')
    parser.add_argument('event', choices=list(EVENT_TYPES))
    parser.add_argument('-o', '--out_dir')
    return parser.parse_args()


def _find_video(video_dir, video):
    """Prefer .mp4; fall back to the .mkv path (even if absent — the
    metadata probe then reports zeros, like the reference)."""
    mp4 = os.path.join(video_dir, video + '.mp4')
    return mp4 if os.path.exists(mp4) else os.path.join(
        video_dir, video + '.mkv')


def _event_frame_window(event_data, fps):
    timestamps = event_data['timestamps']
    assert len(timestamps) == 1, 'Too many timestamps for event'
    start, end = timestamps[0]
    return math.floor(start * fps), math.ceil(end * fps)


def main(video_dir, event, out_dir):
    annotations = load_json(ANNOTATION_FILE)
    wanted = EVENT_TYPES[event]

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    for video, events in annotations.items():
        video_path = _find_video(video_dir, video)
        video_meta = get_metadata(video_path)
        for event_id, event_data in events.items():
            window = _event_frame_window(event_data, video_meta.fps)
            if event_data['event'] != wanted or not out_dir:
                continue
            clip_out_path = os.path.join(
                out_dir, '{}_{}.mp4'.format(video, event_id))
            if not os.path.exists(clip_out_path):
                cut_segment(video_path, video_meta, clip_out_path,
                            *window)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
