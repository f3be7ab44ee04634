#!/usr/bin/env python3
"""Cut figure-skating broadcasts into routine clips named
'<video>_<nn>_<start>_<end>.mp4'.

Counterpart of `vpd_tpu/tools/recut_fs_video.py`, with its flags and
ffmpeg commands: the segments CSV (`datasets/data/action_dataset/fs/
segments.csv`) parses to flat rows then groups; per-video frame windows
compute up front; one job per source video in a pool of spawned
processes. Needs ffmpeg on the PATH. Usage:

    python -m vpd_tpu_torch.tools.recut_fs_video <mkv_dir> <out_dir>
        [--padding SECONDS]
"""

import argparse
import csv
import multiprocessing
import os

from ..datasets.recognition_data import ACTION_DATA_DIR
from ..utils.video import cut_segment, get_metadata


def get_args():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('video_dir', type=str,
                        help='directory holding the source .mkv broadcasts')
    parser.add_argument('out_dir', type=str,
                        help='output directory for the routine clips')
    parser.add_argument('--padding', type=int, default=0,
                        help='seconds added on both sides of each segment')
    return parser.parse_args()


def parse_duration(s):
    """'HH:MM:SS' -> seconds."""
    hh, mm, ss = (int(part) for part in s.split(':'))
    return hh * 3600 + mm * 60 + ss


def load_segments(segment_file):
    with open(segment_file) as fp:
        rows = [(r['video'], parse_duration(r['start']),
                 parse_duration(r['end']))
                for r in csv.DictReader(fp)]
    segment_dict = {}
    for video, start, end in rows:
        segment_dict.setdefault(video, []).append((start, end))
    return segment_dict


def _clip_name(stem, seq_num, start_frame, end_frame):
    return '{}_{:02d}_{:08d}_{:08d}.mp4'.format(
        stem, seq_num, start_frame, end_frame)


def recut_single(video_file, segments, out_dir):
    meta = get_metadata(video_file)
    stem = os.path.basename(video_file).rsplit('.')[0]
    windows = [(int(start * meta.fps), int((end + 1) * meta.fps))
               for start, end in segments]
    for seq_num, (sf, ef) in enumerate(windows, start=1):
        out_file = os.path.join(out_dir, _clip_name(stem, seq_num, sf, ef))
        cut_segment(video_file, meta, out_file, sf, ef)


def main(video_dir, out_dir, padding):
    segment_dict = load_segments(
        os.path.join(ACTION_DATA_DIR, 'fs', 'segments.csv'))

    worker_args = []
    for video_name, spans in segment_dict.items():
        video_file = os.path.join(video_dir, video_name + '.mkv')
        if not os.path.isfile(video_file):
            raise AssertionError('missing source video: ' + video_file)
        padded = [(start - padding, end + padding) for start, end in spans]
        worker_args.append((video_file, padded, out_dir))

    os.makedirs(out_dir, exist_ok=True)
    pool_size = min(8, len(worker_args))
    with multiprocessing.get_context('spawn').Pool(pool_size) as pool:
        pool.starmap(recut_single, worker_args)
    print('Done!')


if __name__ == '__main__':
    _a = get_args()
    main(_a.video_dir, _a.out_dir, _a.padding)
