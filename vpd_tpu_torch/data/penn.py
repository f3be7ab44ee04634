"""Penn Action ablation dataset: crops cut on the fly from full frames.

Counterpart of `vpd_tpu/data/penn.py` (reference
`vpd_dataset/single_frame.py:276-358`, PennDataset/PennDatasetUtil):
samples are (seq, frame, is_flip, emb row, box); both teacher flip rows
become separate samples with pre-flipped crops; boxes are squared and
padded (25 px / 10%) before the resize. The host decodes JPEG frames with
cv2 into uint8 batches; the float math runs on the device. The same seed
draws the same samples, so the batches are vpd_tpu's byte for byte.
"""

import os

import numpy as np

from ..core.io import load_json, load_pickle
from ..utils.video import crop_frame

PAD_PX = 25
PAD_FRAC = 0.1


def scan_penn_dir(penn_dir, *, embed_time=False, min_pose_score=0.5):
    """The flat sample list from pose_embs.pkl + boxes.json: (samples,
    emb_dim) with samples (seq, frame_num, is_flip, emb (D,), box).
    `embed_time` targets are [e_t, e_t - e_{t-1}] on consecutive frames
    only."""
    emb_dict = load_pickle(os.path.join(penn_dir, 'pose_embs.pkl'))
    box_dict = load_json(os.path.join(penn_dir, 'boxes.json'))

    samples = []
    emb_dim = None
    for seq, embs in emb_dict.items():
        boxes = box_dict[seq]
        for i, (frame_num, score, emb_target) in enumerate(embs):
            if emb_dim is None:
                emb_dim = emb_target.shape[-1]
            if score < min_pose_score:
                continue
            if embed_time:
                if i == 0 or embs[i - 1][0] != frame_num - 1:
                    continue
                prev = embs[i - 1][2]
                emb_target = np.concatenate(
                    [emb_target, emb_target - prev],
                    axis=0 if len(emb_target.shape) == 1 else 1)
            for flip in (False, True):
                samples.append((seq, frame_num, flip, emb_target[int(flip)],
                                boxes[frame_num]))
    return samples, emb_dim


def load_penn_crop(frame_dir, seq, frame_num, box, img_dim, flip=False):
    """One Penn frame (`{seq}/{frame_num + 1:06d}.jpg`, RGB) cropped to its
    squared, padded box (zero-filled past the frame's edge), mirrored when
    `flip`, resized to `img_dim`."""
    import cv2

    frame = cv2.cvtColor(cv2.imread(os.path.join(
        frame_dir, seq, '{:06d}.jpg'.format(frame_num + 1))),
        cv2.COLOR_BGR2RGB)
    x, y, w, h = [int(z) for z in box]
    crop = crop_frame(x, y, x + w, y + h, frame, make_square=True,
                      pad_px=PAD_PX, pad_frac=PAD_FRAC)
    if flip:
        crop = crop[:, ::-1, :].copy()
    return cv2.resize(crop, (img_dim, img_dim))


class PennBatchSource:
    """uint8 batch producer over Penn full-frame crops.

    Flips happen here on the host (each crop is pre-flipped per the
    sampled teacher row), so the device augmentation runs with flip off.
    """

    def __init__(self, samples, frame_dir, img_dim, batch_size, *,
                 target_len=20000, seed=0, batch_part=(0, 1)):
        """`batch_part` (i, k): draw each global batch of `batch_size`
        and cut the crops of block i of k alone (a rank of a data
        mesh)."""
        if not samples:
            raise ValueError('no Penn samples')
        self.batch_part = batch_part
        self.samples = samples
        self.frame_dir = frame_dir
        self.img_dim = img_dim
        self.batch_size = batch_size
        self.target_len = target_len
        self.rng = np.random.default_rng(seed)

    @property
    def num_batches(self):
        return max(1, self.target_len // self.batch_size)

    def next_batch(self):
        from ..core.mesh import part_rows

        b, s = self.batch_size, self.img_dim
        drawn = [self.samples[self.rng.integers(len(self.samples))]
                 for _ in range(b)][part_rows(b, self.batch_part)]
        rgb = np.zeros((len(drawn), s, s, 3), np.uint8)
        embs = []
        for i, (seq, frame, is_flip, emb, box) in enumerate(drawn):
            rgb[i] = load_penn_crop(self.frame_dir, seq, frame, box, s,
                                    flip=is_flip)
            embs.append(emb)
        return {'rgb': rgb, 'emb': np.stack(embs).astype(np.float32),
                'flip': np.zeros(len(drawn), bool)}
