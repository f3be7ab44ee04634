#!/usr/bin/env python3
"""Overlay COCO-17 pose skeletons on a video.

Counterpart of `vpd_tpu/tools/view_2d_pose.py`, with its flags: frames
stream through utils.video's capture helpers and bones are drawn with
PIL. The reference's cv2.imshow preview (fatal on headless hosts, see
utils/display.py) is deliberately absent: pass -v to render to an mp4v
file instead. Host only. Usage:

    python -m vpd_tpu_torch.tools.view_2d_pose <video.mp4> <pose_file_or_dir>
        -v <out.mp4> [-vs <scale>]
"""

import argparse
import os

import numpy as np
from PIL import Image, ImageDraw

from ..core.io import load_gz_json
from ..utils.video import _get_metadata, open_capture

# 1-indexed joint pairs, as in the public COCO skeleton definition
COCO_BONES = (
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13),
    (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (2, 3), (1, 2), (1, 3),
    (2, 4), (3, 5), (4, 6), (5, 7))
_BONE_IDX = np.array(COCO_BONES) - 1


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('video_file')
    parser.add_argument('pose_file')
    parser.add_argument('-v', dest='vout_file')
    parser.add_argument('-vs', dest='vout_scale', type=float)
    return parser.parse_args()


def draw_keypoints(im, kp_poses, w=3, fill='white'):
    draw = ImageDraw.Draw(im)
    for pose in kp_poses:
        xy = np.asarray(pose[-1], dtype=np.float64)[:, :2]
        for a, b in _BONE_IDX:
            draw.line((*xy[a], *xy[b]), fill=fill, width=w)


def _resolve_pose_file(video_file, pose_file):
    if not os.path.isdir(pose_file):
        return pose_file
    video_name = os.path.splitext(os.path.basename(video_file))[0]
    return os.path.join(pose_file, video_name, 'coco_keypoints.json.gz')


def main(video_file, pose_file, vout_file, vout_scale):
    import cv2

    kp_dict = dict(load_gz_json(_resolve_pose_file(video_file, pose_file)))

    with open_capture(video_file) as vc:
        meta = _get_metadata(vc)
        vo = None
        if vout_file is not None:
            scale = vout_scale if vout_scale and vout_scale != 1 else 1
            vo_size = (int(meta.width * scale), int(meta.height * scale))
            vo = cv2.VideoWriter(vout_file,
                                 cv2.VideoWriter_fourcc(*'mp4v'),
                                 meta.fps, vo_size)
        for frame_num in range(meta.num_frames):
            ret, frame = vc.read()
            if not ret:
                break
            poses = kp_dict.get(frame_num, [])
            if poses:
                im = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                draw_keypoints(im, poses)
                frame = cv2.cvtColor(np.array(im), cv2.COLOR_RGB2BGR)
            if vo is not None:
                if frame.shape[1] != vo_size[0]:
                    frame = cv2.resize(frame, vo_size)
                vo.write(frame)
    if vo is not None:
        vo.release()
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
