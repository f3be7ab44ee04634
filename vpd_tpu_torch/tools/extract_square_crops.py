#!/usr/bin/env python3
"""Extract square athlete crops (+ t-k crops and masks) from videos.

Counterpart of `vpd_tpu/tools/extract_square_crops.py`, with its flags
and byte-equal PNG trees (tests/test_torch_prep_tools.py): per frame, a
square padded crop around the (optionally union-smoothed) tracked box,
the same crop of frame t-k via a bounded history, and the best
(score > 0.8) instance mask decoded from base64 PNG into a frame-size
canvas. Host only (cv2, numpy, PIL). Usage:

    python -m vpd_tpu_torch.tools.extract_square_crops <pose_dir>
        <video_dir> -o <crop_dir> [-d 128] [--parallelism N]

`<pose_dir>/<video>/{boxes.json,mask.json.gz}` name the videos;
`<video_dir>/<video>.mp4` are read. The worker pool spawns its processes
(one a video at most), so nothing of the parent's state, CUDA or
threads, reaches a worker.
"""

import argparse
import multiprocessing
import os

import numpy as np

from ..core.io import decode_png, load_gz_json, load_json
from ..utils.video import crop_frame

PAD_PX = 25
PAD_FRAC = 0.1
MASK_THRESHOLD = 0.8


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('pose_dir', type=str)
    parser.add_argument('video_dir', type=str)
    parser.add_argument('-o', '--out_dir', type=str)
    parser.add_argument('-d', '--dim', type=int, default=128)
    parser.add_argument('--target_fps', type=int)
    parser.add_argument('--num_prev_frames', type=int, default=1)
    parser.add_argument('--no_smooth', action='store_true')
    parser.add_argument('--parallelism', type=int)
    parser.add_argument('-v', '--visualize', action='store_true',
                        help='show (or, headless, save under .viz/) the '
                             'crop strips while extracting')
    return parser.parse_args()


class DelayBuffer:
    """Bounded frame history: get(i) is the item pushed i steps ago.

    Slots never written are None; lookbacks past the capacity wrap
    modulo capacity (matching the reference ring buffer at
    `extract_square_crops.py:42-53`, whose callers rely on both).
    """

    def __init__(self, capacity):
        self._slots = [None] * capacity
        self._count = 0

    def push(self, item):
        self._slots[self._count % len(self._slots)] = item
        self._count += 1

    def get(self, steps_back):
        return self._slots[(self._count - 1 - steps_back)
                           % len(self._slots)]


def _smooth_union(box, prev_box):
    """Corner-union of this frame's (x, y, w, h) box with the last one."""
    x, y, w, h = box
    corners = [(x, y, x + w, y + h)]
    if prev_box is not None:
        px, py, pw, ph = prev_box
        corners.append((px, py, px + pw, py + ph))
    xs1, ys1, xs2, ys2 = zip(*corners)
    return min(xs1), min(ys1), max(xs2), max(ys2)


def _best_mask_canvas(mask_rows, frame_hw):
    """Paint the highest-scoring above-threshold mask into a frame-size
    single-channel canvas, or None if no mask qualifies."""
    candidates = [row for row in mask_rows if row[0] > MASK_THRESHOLD]
    if not candidates:
        return None
    candidates.sort()  # last entry wins, full-tuple order as reference
    _, (mx, my, mw, mh), raw = candidates[-1]
    mx, my, mw, mh = int(mx), int(my), int(mw), int(mh)
    canvas = np.zeros((*frame_hw, 1), np.uint8)
    window = canvas[my:my + mh, mx:mx + mw, :]
    window[decode_png(raw)] = 255
    return canvas


def extract_crops(video_path, box_dict, mask_dict, out_dir, dim, target_fps,
                  num_prev_frames, smooth_boxes, visualize=False):
    import cv2
    cv2.setNumThreads(0)
    png_opts = [cv2.IMWRITE_PNG_COMPRESSION, 9]

    vc = cv2.VideoCapture(video_path)
    num_frames = int(vc.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = vc.get(cv2.CAP_PROP_FPS)

    prev_gap = 1 if target_fps is None else round(fps / target_fps)
    history = DelayBuffer(num_prev_frames * (prev_gap + 1))
    prev_box = None
    for frame_num in range(num_frames):
        ok, frame = vc.read()
        assert ok
        history.push(frame)

        box = box_dict.get(frame_num)
        if box is not None:
            corners = (_smooth_union(box, prev_box) if smooth_boxes
                       else _smooth_union(box, None))
            crop_box = tuple(int(c) for c in corners)

            def snap(img):
                return crop_frame(*crop_box, img, make_square=True,
                                  pad_px=PAD_PX, pad_frac=PAD_FRAC)

            crop = snap(frame)
            outputs = {'{}.png'.format(frame_num): crop}

            mask_canvas = _best_mask_canvas(
                mask_dict.get(frame_num, []), frame.shape[:2])
            if mask_canvas is not None:
                outputs['{}.mask.png'.format(frame_num)] = snap(mask_canvas)

            prev_names = []
            for i in range(1, num_prev_frames + 1):
                name = '{}.prev{}.png'.format(frame_num, i if i > 1 else '')
                past = history.get(prev_gap * i)
                outputs[name] = snap(past) if past is not None else crop
                prev_names.append(name)

            if max(crop.shape[:2]) != dim:
                outputs = {name: cv2.resize(img, (dim, dim))
                           for name, img in outputs.items()}

            if visualize and (out_dir is not None
                              or os.environ.get('DISPLAY')):
                # reference extract_square_crops.py:118-120 shows the
                # crop strip in a window; headless hosts get a saved
                # strip under <out_dir>/.viz instead (see utils.display
                # for why the gate is on DISPLAY, not try/except)
                from ..utils.display import imshow_or_save
                strip = [outputs['{}.png'.format(frame_num)]]
                strip += [outputs[n] for n in prev_names]
                imshow_or_save(
                    'person', np.hstack(strip),
                    os.path.join(out_dir or '.', '.viz',
                                 '{}.png'.format(frame_num)))

            if out_dir is not None:
                for name, img in outputs.items():
                    cv2.imwrite(os.path.join(out_dir, name), img, png_opts)

        prev_box = box
    vc.release()


def extract_crops_for_video(video_name, boxes, video_dir, pose_dir, out_dir,
                            dim, target_fps, num_prev_frames, smooth,
                            visualize=False):
    video_path = os.path.join(video_dir, video_name + '.mp4')
    video_out_dir = None
    if out_dir is not None:
        video_out_dir = os.path.join(out_dir, video_name)
        os.makedirs(video_out_dir, exist_ok=True)
    mask_dict = dict(load_gz_json(
        os.path.join(pose_dir, video_name, 'mask.json.gz')))
    extract_crops(video_path, dict(boxes), mask_dict, video_out_dir, dim,
                  target_fps, num_prev_frames, smooth, visualize=visualize)
    return video_name


def _worker(args):
    return extract_crops_for_video(*args)


def main(pose_dir, video_dir, out_dir, dim, target_fps, num_prev_frames,
         no_smooth, parallelism, visualize=False):
    video_names = [x for x in os.listdir(pose_dir)
                   if os.path.isdir(os.path.join(pose_dir, x))]
    worker_args = [
        (v, load_json(os.path.join(pose_dir, v, 'boxes.json')),
         video_dir, pose_dir, out_dir, dim, target_fps,
         num_prev_frames, not no_smooth, visualize) for v in video_names]

    if visualize:  # one window/viz stream (reference :170-173)
        parallelism = 1
    parallelism = parallelism or max(1, (os.cpu_count() or 2) // 2)
    pool_size = max(1, min(parallelism, len(worker_args)))
    with multiprocessing.get_context('spawn').Pool(pool_size) as p:
        for video_name in p.imap_unordered(_worker, worker_args):
            print(video_name)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
