"""FineGym (Gym99) annotation and embedding loaders.

Behavioral parity with reference `finegym/util.py:32-124` (re-derived:
window math as one clamp chain, fps subsampling via the shared
datasets/subsample.py mask primitive instead of an inline walker;
differential-tested in test_reference_oracle.py).

Copied from `vpd_tpu/datasets/finegym.py` (this package
imports nothing of `vpd_tpu`).
"""

import math
import os
from typing import NamedTuple

import numpy as np

from ..core.io import load_pickle
from . import DATA_DIR as _DATA_DIR
from .load import normalize_rows
from .subsample import subsample_rows

DATA_DIR = os.path.join(_DATA_DIR, 'finegym')
ANNOTATION_FILE = os.path.join(DATA_DIR, 'finegym_annotation_info_v1.1.json')
GYM99_CATEGORY_FILE = os.path.join(DATA_DIR, 'gym99_categories.txt')
GYM99_TRAIN_FILE = os.path.join(DATA_DIR, 'gym99_train_element_v1.1.txt')
GYM99_VAL_FILE = os.path.join(DATA_DIR, 'gym99_val_element.txt')


class Category(NamedTuple):
    class_id: int
    set_id: int
    g530_id: int
    event: str
    name: str


def load_categories(file_name=GYM99_CATEGORY_FILE):
    """Parse 'class: N; set: N; g530: N; (event) name' category lines."""
    result = {}
    with open(file_name) as fp:
        for line in fp:
            fields = line.split(';')
            cid, sid, gid = (int(f.split(':', 1)[1]) for f in fields[:3])
            event, name = fields[3].strip()[1:].split(')', 1)
            result[cid] = Category(cid, sid, gid, event, name.strip())
    return result


def load_labels(file_name):
    with open(file_name) as fp:
        rows = (line.split(' ') for line in fp)
        return {action_id: int(label) for action_id, label in rows}


def parse_full_action_id(s):
    """'<video>_E_<event>_A_<action>' -> (video, 'E_<event>', 'A_<action>')."""
    rest, action = s.split('_A_')
    video, event = rest.split('_E_')
    return video, 'E_' + event, 'A_' + action


def _action_window(timestamps, pre_seconds, min_seconds, max_seconds, fps):
    """Clamp the annotated [start, end] span and convert to frames."""
    start, end = timestamps
    span = end - start
    if span > max_seconds:
        end = start + max_seconds
    elif span < min_seconds:
        end = start + min_seconds
    start = max(start - pre_seconds, 0)
    return math.floor(start * fps), math.ceil(end * fps)


def _load_window_embs(emb_path, lo, hi, rate, interp_skipped):
    """Stack rows with lo <= frame <= hi, then fps-subsample them."""
    rows = [emb for frame_num, emb, _ in load_pickle(emb_path)
            if lo <= frame_num <= hi]
    if not rows:
        return None
    out = subsample_rows(np.stack(rows), rate, credit=1.0,
                         interp_skipped=interp_skipped)
    return out if len(out) else None


def _iter_labeled_actions(labels, meta_dict, annotations):
    """Resolve each labeled action id to its video-event key, metadata,
    and annotated timestamp pair; ids whose video-event has no metadata
    entry are silently dropped (reference behavior)."""
    for full_action_id in labels:
        video_id, event_id, action_id = parse_full_action_id(full_action_id)
        video_event_id = video_id + '_' + event_id
        video_meta = meta_dict.get(video_event_id)
        if video_meta is not None:
            segment = annotations[video_id][event_id]['segments'][action_id]
            yield (full_action_id, video_event_id, video_meta,
                   segment['timestamps'][0])


def load_actions(annotations, labels, meta_dict, emb_dir=None, norm=False,
                 pre_seconds=0, min_seconds=0, max_seconds=1000,
                 target_fps=None, interp_skipped=False):
    """{full_action_id: ((start_frame, end_frame), embs or None)}."""
    result = {}
    for (full_action_id, video_event_id, video_meta,
         timestamps) in _iter_labeled_actions(labels, meta_dict,
                                              annotations):
        start_frame, end_frame = _action_window(
            timestamps, pre_seconds, min_seconds, max_seconds,
            video_meta.fps)

        embs = None
        if emb_dir is not None:
            emb_path = os.path.join(emb_dir, video_event_id + '.emb.pkl')
            if os.path.isfile(emb_path):
                rate = (1.0 if target_fps is None
                        else min(1, target_fps / video_meta.fps))
                embs = _load_window_embs(emb_path, start_frame, end_frame,
                                         rate, interp_skipped)
                if embs is not None and norm:
                    embs = normalize_rows(embs)
        result[full_action_id] = ((start_frame, end_frame), embs)
    return result
