"""Evaluation math: temporal IoU, interpolated AP, confusion matrices.

Behavioral parity with reference `detect.py:179-236` and
`util/eval.py:5-23`, re-derived as vectorized numpy (cumulative-count PR
curve, suffix-max interpolation) and differential-tested in
test_reference_oracle.py::test_detect_ap_oracle. The reference's
interpolation is *not* the canonical VOC construction: points are kept
only where the raw precision strictly exceeds the previously kept
interpolated value, and a (recall=1, precision=0) anchor is added when
the curve never reaches full recall — both quirks are preserved.

Copied from `vpd_tpu/tasks/eval.py` (this package
imports nothing of `vpd_tpu`).
"""

import warnings

import numpy as np


def calc_iou(a1, a2, b1, b2):
    """Temporal IoU of [a1, a2] and [b1, b2] (`detect.py:179-182`)."""
    isect = min(a2, b2) - max(a1, b1)
    return isect / (max(a2, b2) - min(a1, b1)) if isect > 0 else 0


def compute_precision_recall_curve(is_tp, num_pos):
    """PR values after each successive proposal, highest-score first."""
    tp = np.cumsum(np.asarray(is_tp, dtype=np.int64))
    seen = np.arange(1, len(tp) + 1)
    return list(tp / seen), list(tp / num_pos)


def compute_interpolated_precision(precision, recall):
    """Monotone interpolated envelope, as (precision, recall) lists.

    Scanning from the highest-recall end: at every strict recall
    increase, a point (next recall level, max precision at-or-beyond it)
    is emitted — but only when the raw precision below the boundary
    exceeds the last emitted precision (the reference's dedup rule).
    The output is bracketed by (recall=0, precision=1) and, when the
    curve ends short of full recall, (recall=1, precision=0).
    """
    prec = np.asarray(precision, dtype=float)
    rec = np.asarray(recall, dtype=float)
    if len(rec) == 0:
        # no proposals at all: the bare bracketing envelope (AP 0) —
        # the in-repo caller guards this, but direct callers got this
        # graceful degenerate from the pre-rewrite implementation
        return [1.0, 0.0], [0.0, 1.0]
    # max precision over entries at index >= j
    suffmax = np.maximum.accumulate(prec[::-1])[::-1]

    pts = []  # (recall, precision), highest recall first
    if rec[-1] < 1:
        pts.append((1.0, 0.0))
    for m in np.flatnonzero(rec[:-1] < rec[1:])[::-1]:
        if not pts or prec[m] > pts[-1][1]:
            pts.append((float(rec[m + 1]), float(suffmax[m + 1])))
    if not pts:
        # Every proposal is already at full recall (e.g. a single GT
        # interval hit by the top-scored proposal). The reference
        # crashes on this input (`detect.py:225` assert); take the max
        # precision at recall 1 instead (QUIRKS.md).
        pts.append((min(1.0, float(rec[0])), float(suffmax[0])))
    pts.append((0.0, 1.0))

    interp_recall = [r for r, _ in reversed(pts)]
    interp_precision = [p for _, p in reversed(pts)]
    return interp_precision, interp_recall


def compute_ap(pc, rc):
    """Area under the interpolated PR envelope."""
    ipc, irc = (np.asarray(v) for v in compute_interpolated_precision(pc, rc))
    assert irc[0] == 0 and irc[-1] == 1
    dr = np.diff(irc)
    assert (dr > 0).all()
    area = float(np.sum(ipc[1:] * dr))
    assert 0 <= area <= 1, area
    return area


def save_confusion_matrix(truth, pred, out_file, norm=None):
    """Render a confusion-matrix PDF (`util/eval.py:5-23`). Where
    matplotlib or scikit-learn is not installed (a GPU host may have
    neither) it warns, naming the package, and writes no PDF; the CSVs
    beside it hold the same predictions."""
    try:
        import matplotlib
        from sklearn.metrics import ConfusionMatrixDisplay, confusion_matrix
    except ImportError as e:
        warnings.warn('{} is not installed: {} not written'.format(
            e.name, out_file))
        return
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    label_names = sorted(set(truth) | set(pred))
    index = {name: i for i, name in enumerate(label_names)}
    cm = confusion_matrix(
        [index[t] for t in truth], [index[p] for p in pred],
        labels=list(range(len(label_names))), normalize=norm)
    if norm is not None:
        cm = cm * 100
    fig = plt.figure(figsize=(20, 20))
    ax = fig.add_subplot(111)
    disp = ConfusionMatrixDisplay(
        confusion_matrix=cm, display_labels=label_names)
    disp.plot(ax=ax, xticks_rotation='vertical',
              values_format='.1f' if norm is not None else 'd')
    plt.tight_layout()
    plt.savefig(out_file)
    plt.close(fig)
