"""Dense per-frame embedding matrices and action label loading.

Behavioral parity with reference `action_dataset/load.py` (re-derived,
vectorized implementation — differential-tested in
tests/test_reference_oracle.py::test_group_by_frame_oracle).

NOTE: the gap interpolation deliberately reproduces the reference's
weighting (`action_dataset/load.py:34-42`), where the blend coefficient
`a = i/gap` is applied to the *previous* frame — i.e. reversed from
textbook lerp. Downstream models were trained with this convention;
keep it (QUIRKS.md).

Copied from `vpd_tpu/datasets/load.py` (this package
imports nothing of `vpd_tpu`).
"""

import os
from typing import NamedTuple

import numpy as np

from ..core.io import load_pickle


class Category(NamedTuple):
    name: str


def group_by_frame(embs):
    """Densify sparse per-frame rows into (num_frames, [k,] D).

    Multiple detections on one frame are averaged; frames between two
    detections are filled with the reference's reversed lerp; frames
    before the first / after the last detection stay zero. Returns
    (dense, has_detection_mask).
    """
    frame_idx = np.asarray([row[0] for row in embs], dtype=np.int64)
    values = np.stack([row[1] for row in embs])
    num_frames = int(frame_idx.max()) + 1

    # Accumulate detections per frame, then average where count > 0.
    inner = values.shape[1:] if values.ndim >= 3 else values.shape[-1:]
    dense = np.zeros((num_frames, *inner))
    np.add.at(dense, frame_idx, values)
    counts = np.zeros(num_frames)
    np.add.at(counts, frame_idx, 1.0)
    present = counts > 0
    dense[present] /= counts[present].reshape(
        (-1,) + (1,) * (dense.ndim - 1))

    # Fill interior gaps. For a gap of size g between present frames
    # p < q, offsets i = 1..g-1 get a = i/g applied to dense[p] (the
    # reference's reversed convention, see module docstring).
    hits = np.flatnonzero(present)
    gaps = np.diff(hits)
    wide = np.flatnonzero(gaps > 1)
    if wide.size:
        offs = np.concatenate([np.arange(1, gaps[w]) for w in wide])
        prev = np.repeat(hits[wide], gaps[wide] - 1)
        nxt = np.repeat(hits[wide + 1], gaps[wide] - 1)
        a = (offs / gaps[np.repeat(wide, gaps[wide] - 1)]).reshape(
            (-1,) + (1,) * (dense.ndim - 1))
        dense[prev + offs] = a * dense[prev] + (1. - a) * dense[nxt]

    return dense, present


def normalize_rows(x):
    """L2-normalize along the embedding axis; near-zero rows pass through."""
    d = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.where(d < 1e-12, 1.0, d)


def load_embs(emb_dir, norm, emb_ext='.emb.pkl', log=print):
    """{video: (dense (T, [k,] D), present mask)} over *.emb.pkl files."""
    log('Loading embs: {}'.format(emb_dir))
    result = {}
    for fname in os.listdir(emb_dir):
        if not fname.endswith(emb_ext):
            continue
        dense, mask = group_by_frame(
            load_pickle(os.path.join(emb_dir, fname)))
        if norm:
            dense = normalize_rows(dense)
        result[fname[:-len(emb_ext)]] = (dense, mask)
    return result


def load_actions(action_file):
    """'<action> <label>' lines -> {action: label}."""
    with open(action_file) as fp:
        rows = (line.split() for line in fp if line.strip())
        return {action: label for action, label in rows}


def load_action_ids(id_file):
    with open(id_file) as fp:
        return {line.strip() for line in fp if line.strip()}


def to_categories(classes):
    return dict(enumerate(Category(c) for c in classes))
