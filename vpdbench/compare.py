"""The numbers that decide `correct`, each against its limit.

Train cells compare the program's first steps with the reference's on
the same rows, draws and weights:

* `pred_gap`: the first step's predictions (the student's outputs in
  that step's forward), the largest relative L2 gap of a row;
* `loss_gap`: the largest relative gap of a step's loss;
* `grad_gap`: the first step's gradient as the optimizer got it, by the
  worst leaf: the gap between the two norms of a leaf, over the larger
  of the reference's norm of that leaf and of the median leaf;
* `update_gap`: the same of each leaf's change over the checked steps;
* `grad_gap_median`, `update_gap_median`: the median leaf's gaps;
* `pred_gap_median`, `loss1_gap`: the median row's, the first loss's;
* `aug_gap`, `aug_gap_median`: the first step's augmented input images,
  the largest and the median relative L2 gap of an image;
* `fwd_gap`, `fwd_gap_median`, `fwd_gap_mean`: the forward alone, the
  first step's predictions against the reference's forward over the
  program's own augmented input (the worst, the median and the mean
  row's gap), so that the augmentation's bf16 rounding does not hide the
  products';
* `loss_stage_gap`: the loss alone, the first step's loss as the program
  reported it against the reference's loss (the sum of squared
  differences) of that step's predictions and targets.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both. Extraction
cells compare every embedding the window read back:

* `emb_gap`: the largest relative L2 gap of an embedding row.

A number that is not finite fails.
"""

import math

import numpy as np
import torch

TINY_GRAD = 1e-3


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gaps(program, reference, keep):
    """{leaf: |norm(program) - norm(reference)| / max(norm of the
    reference leaf, median reference leaf norm)} over `keep`."""
    p, r = _norms(program), _norms(reference)
    median = float(np.median([r[k] for k in keep]))
    return {k: abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keep}


def moving_leaves(grad):
    """The leaves whose reference gradient is not round-off."""
    g = _norms(grad)
    median = float(np.median(list(g.values())))
    return sorted(k for k, v in g.items() if v >= TINY_GRAD * median)


def train_numbers(program, reference, start, fwd_reference):
    """program and reference: {'losses', 'preds', 'grad1', 'params',
    'inputs'}, the program's also 'targets' (the first step's); `start`
    the weights both began from; `fwd_reference` the reference's first
    forward over the program's augmented input."""
    keep = moving_leaves(reference['grad1'])
    gaps = [abs(a - b) / abs(b) for a, b in zip(program['losses'],
                                                 reference['losses'])]
    if len(program['losses']) != len(reference['losses']):
        gaps.append(math.inf)

    def change(params):
        return {k: params[k].double() - start[k].double() for k in keep}

    grad = leaf_gaps(program['grad1'], reference['grad1'], keep)
    update = leaf_gaps(change(program['params']),
                       change(reference['params']), keep)
    p = program['preds'][0]
    rows = _pred_gaps(p, reference['preds'][0])
    fwd = _pred_gaps(p, fwd_reference)
    images = image_gaps(program.get('inputs'), reference['inputs'])
    if p is not None and p.shape == program['targets'].shape:
        fit = float(torch.sum((p.double() - program['targets'].double())
                              ** 2))
        stage = abs(program['losses'][0] - fit) / max(fit, 1e-30)
    else:
        stage = math.inf
    return {
        'fwd_gap': float(fwd.max()),
        'fwd_gap_median': float(np.median(fwd)),
        'fwd_gap_mean': float(np.mean(fwd)),
        'loss_stage_gap': stage,
        'aug_gap': float(images.max()),
        'aug_gap_median': float(np.median(images)),
        'pred_gap': float(rows.max()),
        'pred_gap_median': float(np.median(rows)),
        'loss_gap': max(gaps), 'loss1_gap': gaps[0],
        'grad_gap': max(grad.values()),
        'grad_gap_median': float(np.median(list(grad.values()))),
        'update_gap': max(update.values()),
        'update_gap_median': float(np.median(list(update.values()))),
        'worst_grad_leaf': max(grad, key=grad.get),
        'worst_update_leaf': max(update, key=update.get)}


def _pred_gaps(program, reference):
    """row_gaps of two (N, D) predictions; inf where the program has none
    of that shape."""
    if program is None or reference is None or \
            program.shape != reference.shape:
        return np.array([math.inf])
    return row_gaps(program.cpu(), reference.cpu())


def image_gaps(program, reference):
    """Relative L2 gap of each image of two (N, ...) batches (on the
    device, in float32); inf where the program has none of that shape."""
    if program is None or program.shape != reference.shape:
        return np.array([math.inf])
    p, r = program.flatten(1).float(), reference.flatten(1).float()
    return (torch.linalg.vector_norm(p - r, dim=1)
            / torch.linalg.vector_norm(r, dim=1).clamp_min(1e-30)
            ).cpu().numpy().astype(np.float64)


def row_gaps(program, reference):
    """Relative L2 gap of each row: program and reference (..., D)."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    return (np.linalg.norm(p - r, axis=-1)
            / np.maximum(np.linalg.norm(r, axis=-1), 1e-30))


def embedding_gap(program, reference):
    """Largest relative L2 gap of a row."""
    return float(np.max(row_gaps(program, reference)))


def judge(numbers, limits):
    """(correct, {name: {'value', 'limit'}}) over the numbers that have a
    limit: each finite and at or under its limit; a missing one fails."""
    checks = {k: {'value': numbers.get(k, math.inf), 'limit': v}
              for k, v in limits.items()}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok and bool(checks), checks
