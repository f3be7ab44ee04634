"""Temporal action localization on frozen embeddings.

Counterpart of `vpd_tpu/tasks/detect.py` (parity with reference
`detect.py:114-435`): build binary frame labels from GT intervals per
train video (flip rows become ensemble members sharing a fold via
custom_split), train a KFold ensemble of proposal models
(`train/proposal.py`, on the device given as `device` in the model
kwargs; None means CUDA), sweep activation thresholds x tIoU in
{0.1..0.9}, clamp proposal lengths to [0.67, 1.33] x mean train length,
greedy first-hit matching against the de-overlapped GT intervals,
interpolated AP (`tasks/eval.py`, with the recall-1 fix of QUIRKS.md).
"""

import math
from collections import defaultdict
from typing import NamedTuple, Optional

import numpy as np

from ..train.proposal import EnsembleProposal, get_proposals
from .eval import calc_iou, compute_ap, compute_precision_recall_curve

LOC_TEMPORAL_IOUS = [0.1 * i for i in range(1, 10)]


class Label(NamedTuple):
    video: str
    value: str
    start_frame: int
    end_frame: int
    fps: float


class DataConfig(NamedTuple):
    video_name_prefix: Optional[str]
    classes: list
    window_before: float = 0.
    window_after: float = 0.


TENNIS_CLASSES = [
    'forehand_topspin', 'forehand_slice', 'backhand_topspin',
    'backhand_slice', 'forehand_volley', 'backhand_volley', 'overhead',
    'serve', 'unknown_swing']
TENNIS_WINDOW = 0.1

DATA_CONFIGS = {
    'tennis': DataConfig(None, TENNIS_CLASSES, TENNIS_WINDOW, TENNIS_WINDOW),
    'tennis_front': DataConfig('front__', TENNIS_CLASSES, TENNIS_WINDOW,
                               TENNIS_WINDOW),
    'tennis_back': DataConfig('back__', TENNIS_CLASSES, TENNIS_WINDOW,
                              TENNIS_WINDOW),
    'fs_jump': DataConfig(
        None, ['axel', 'lutz', 'flip', 'loop', 'salchow', 'toe_loop']),
    'fx': DataConfig(None, []),
}


def get_video_intervals(examples):
    """De-overlapped GT frame intervals per video.

    Behavioral parity with `detect.py:98-111`: spans sorted by (start,
    end); a span touching the previous merged span REPLACES its end
    (even when that shortens it — the reference takes the later span's
    end unconditionally, see QUIRKS.md).
    """
    by_video = defaultdict(list)
    for ex in examples:
        by_video[ex.video].append((ex.start_frame, ex.end_frame))

    out = {}
    for video, spans in by_video.items():
        merged = []
        for start, end in sorted(spans):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = end
            else:
                merged.append([start, end])
        out[video] = tuple(tuple(span) for span in merged)
    return out


def _frame_activity_labels(num_frames, spans):
    """Binary per-frame labels from a list of (start, end) GT spans."""
    vy = np.zeros(num_frames, dtype=np.int32)
    for start, end in spans:
        vy[start:end] = 1
    return vy


class ProposalModel:
    """Dense embs + GT intervals -> ensemble trainer.

    Behavioral parity with `detect.py:114-173` (re-derived): each train
    video contributes its dense (T, [k,] D) embedding matrix with binary
    frame labels; flip columns become separate training sequences that
    share their video's K-fold assignment via custom_split (custom_split
    entries exist only for flip-column videos, as in the reference).
    """

    # localization schedule overrides (`detect.py:116-117`): 200/25, NOT
    # the base proposal trainer's 25/10 (`util/proposal.py`)
    NUM_TRAIN_EPOCHS = 200
    MIN_TRAIN_EPOCHS = 25

    def __init__(self, arch_type, emb_dict, train_labels, hidden_dim,
                 ensemble_size, splits=5, **kwargs):
        self.embs = emb_dict
        spans_by_video = defaultdict(list)
        for l in train_labels:
            if l.video in emb_dict:
                spans_by_video[l.video].append((l.start_frame, l.end_frame))

        X, y, custom_split = [], [], None
        for i, video in enumerate(sorted(spans_by_video)):
            vx = emb_dict[video][0]
            vy = _frame_activity_labels(vx.shape[0], spans_by_video[video])
            if vx.ndim == 3:
                if custom_split is None:
                    custom_split = []
                for col in np.moveaxis(vx, 1, 0):
                    X.append(col)
                    y.append(vy)
                    custom_split.append(i)
            else:
                X.append(vx)
                y.append(vy)
        if custom_split is not None:
            # mixed 2D/3D embedding dicts would leave custom_split short
            # and mis-group folds downstream; fail here like the
            # reference (`detect.py:147-148`)
            assert len(custom_split) == len(X), \
                (len(custom_split), len(X))

        if len(X) < ensemble_size:
            ensemble_size = splits = len(X)

        kwargs.setdefault('num_epochs', self.NUM_TRAIN_EPOCHS)
        kwargs.setdefault('min_epochs', self.MIN_TRAIN_EPOCHS)
        self.model = EnsembleProposal(
            arch_type, X, y, hidden_dim, ensemble_size=ensemble_size,
            splits=splits, custom_split=custom_split, **kwargs)

    def predict(self, video):
        x = self.embs[video][0]
        if x.ndim == 3:
            return self.model.predict_n(*np.moveaxis(x, 1, 0))
        return self.model.predict(x)


def evaluate_proposals(results, test_video_ints, thresholds,
                       min_prop_len, max_prop_len,
                       t_ious=LOC_TEMPORAL_IOUS):
    """AP table over thresholds x tIoU (`detect.py:354-421`).

    results: [(video, per-frame scores)]. Returns (len(thresholds),
    len(t_ious)) array.
    """
    test_video_int_count = sum(len(v) for v in test_video_ints.values())

    def ap_at_threshold(act_thresh):
        all_props = []
        for video, scores in results:
            for p, score in get_proposals(scores, act_thresh):
                all_props.append((video, p, score))
        all_props.sort(key=lambda x: -x[-1])

        aps = []
        for t_iou in t_ious:
            remaining = {v: set(ints)
                         for v, ints in test_video_ints.items()}
            is_tp = []
            for video, p, _ in all_props:
                mid = (p[1] + p[0]) // 2
                if p[1] - p[0] < min_prop_len:
                    p = (max(0, mid - min_prop_len // 2),
                         mid + min_prop_len // 2)
                elif p[1] - p[0] > max_prop_len:
                    p = (max(0, mid - max_prop_len // 2),
                         mid + max_prop_len // 2)

                video_remaining = remaining.get(video)
                if video_remaining is None:
                    is_tp.append(False)
                else:
                    recalled = [gt for gt in video_remaining
                                if calc_iou(*p, *gt) >= t_iou]
                    for gt in recalled:
                        video_remaining.remove(gt)
                    if not video_remaining:
                        del remaining[video]
                    is_tp.append(len(recalled) > 0)

            if is_tp and any(is_tp):
                pc, rc = compute_precision_recall_curve(
                    is_tp, test_video_int_count)
                aps.append(compute_ap(pc, rc))
            else:
                aps.append(0)
        return aps

    return np.array([ap_at_threshold(t) for t in thresholds])


def run_localization(dataset_name, emb_dict, train_examples, test_examples,
                     n_trials=1, algorithm='gru', k=1, hidden_dim=128,
                     batch_size=None, few_shot_videos_fn=None,
                     n_examples=-1, out_dir=None, log=print, _all=False,
                     **model_kwargs):
    """Full protocol (`detect.py:291-435`). Returns list of AP tables."""
    test_video_ints = get_video_intervals(test_examples)

    mean_len = np.mean([t.end_frame - t.start_frame
                        for t in train_examples])
    min_prop_len = 0.67 * math.ceil(mean_len)
    max_prop_len = 1.33 * math.ceil(mean_len)

    thresholds = (np.linspace(0.05, 0.5, 10) if 'tennis' in dataset_name
                  else np.linspace(0.1, 0.9, 9))

    if batch_size is not None:
        model_kwargs['batch_size'] = batch_size

    trial_results = []
    for trial in range(n_trials):
        if n_examples < 0:
            exp_train = train_examples
        else:
            train_videos = few_shot_videos_fn(trial)[:n_examples]
            exp_train = [
                l for l in train_examples
                if (l.video in train_videos or
                    ('tennis' in dataset_name and
                     l.video.split('__', 1)[1] in train_videos))]

        model = ProposalModel(algorithm, emb_dict, exp_train, hidden_dim,
                              ensemble_size=k, **model_kwargs)
        # --_all scores every embedded video, not just the test split
        # (reference detect.py:91,336-338). NOTE: the AP eval below only
        # has ground-truth intervals for test videos, so proposals on
        # the extra videos score as false positives and LOWER the AP —
        # exactly like the reference (detect.py:381-383); --_all is for
        # exporting predictions (out_dir), not for evaluation
        results = [
            (video, model.predict(video))
            for video in sorted(
                set(emb_dict) if _all else
                {l.video for l in test_examples if l.video in emb_dict})]
        if out_dir:
            # per-frame prediction scores (detect.py:345-352 parity,
            # with the reference's NameError at :351 fixed)
            import json
            import os

            os.makedirs(out_dir, exist_ok=True)
            out_path = os.path.join(
                out_dir, 'train{}_trial{}_{}_pred.json'.format(
                    len(exp_train) if n_examples < 0 else n_examples,
                    trial, algorithm))
            with open(out_path, 'w') as fp:
                json.dump({v: np.asarray(s).tolist()
                           for v, s in results}, fp)
        aps = evaluate_proposals(results, test_video_ints, thresholds,
                                 min_prop_len, max_prop_len)
        log('Trial {}: max AP {:0.4f}'.format(trial, aps.max()))
        trial_results.append(aps)
    return trial_results, thresholds
