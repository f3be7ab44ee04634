"""Diving48 vocab/split and embedding loaders.

Behavioral parity with reference `diving48/util.py:22-74` (re-derived:
fps subsampling via the shared datasets/subsample.py mask primitive,
including the reference's +0.01 rate bias and zero starting credit;
differential-tested in test_reference_oracle.py). The reference's NaN
passthrough is fixed here with a nan_to_num guard (QUIRKS.md).

Copied from `vpd_tpu/datasets/diving48.py` (this package
imports nothing of `vpd_tpu`).
"""

import os
from typing import NamedTuple

import numpy as np

from ..core.io import load_json, load_pickle
from . import DATA_DIR as _DATA_DIR
from .load import normalize_rows
from .subsample import subsample_rows

DATA_DIR = os.path.join(_DATA_DIR, 'diving48')
DIVING48_CATEGORY_FILE = os.path.join(DATA_DIR, 'Diving48_vocab.json')
DIVING48_V1_TRAIN_FILE = os.path.join(DATA_DIR, 'Diving48_train.json')
DIVING48_V1_TEST_FILE = os.path.join(DATA_DIR, 'Diving48_test.json')
DIVING48_V2_TRAIN_FILE = os.path.join(DATA_DIR, 'Diving48_V2_train.json')
DIVING48_V2_TEST_FILE = os.path.join(DATA_DIR, 'Diving48_V2_test.json')


class Category(NamedTuple):
    name: str
    stages: list


def load_categories(path=DIVING48_CATEGORY_FILE):
    return {i: Category(' '.join(stages), stages)
            for i, stages in enumerate(load_json(path))}


def _load_window_embs(emb_path, lo, hi, rate):
    """Stack rows with lo <= frame < hi, then fps-subsample them."""
    rows = [emb for frame_num, emb, _ in load_pickle(emb_path)
            if lo <= frame_num < hi]
    if not rows:
        return None
    out = subsample_rows(np.stack(rows), rate, credit=0.0)
    return out if len(out) else None


def load_labels_and_embeddings(label_file, meta_dict=None, emb_dir=None,
                               norm=False, target_fps=None):
    """({video: label}, {video: ((start, end), embs or None)})."""
    labels, data = {}, {}
    for action in load_json(label_file):
        video_id = action['vid_name']
        window = (action['start_frame'], action['end_frame'])

        embs = None
        if emb_dir is not None:
            emb_path = os.path.join(emb_dir, video_id + '.emb.pkl')
            if os.path.isfile(emb_path):
                rate = 1.0
                if target_fps is not None:
                    rate = min(1, target_fps / meta_dict[video_id].fps) + 0.01
                embs = _load_window_embs(emb_path, *window, rate)
            if embs is not None:
                if np.isnan(embs).any():
                    embs = np.nan_to_num(embs, copy=False)
                if norm:
                    embs = normalize_rows(embs)
        labels[video_id] = action['label']
        data[video_id] = (window, embs)
    return labels, data
