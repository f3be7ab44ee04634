"""VIPE* teacher training: the contrastive + 3D-lifting step.

Counterpart of `vpd_tpu/train/vipe.py` (loss parity with reference
`models/keypoint.py:38-126`):
  * positive hinge:  sum ||e1 - e2||                       (target +1)
  * negative hinge:  sum relu(margin - ||e1 - e_neg||) * neg_valid
  * lifting MSE:     weight_3d * sum (decoder(e) - feats)^2 for both views
  * total loss / batch_n (the student instead backprops the raw sum)

One fused fixed-shape batch carries rows from all mocap families with an
integer `dataset_id`; the decoder evaluates all per-family heads in one
einsum and the MSE is column-masked per family. The encoder runs three
passes (pose1, pose2, pose_neg), so each has its own BatchNorm batch
statistics, as the reference's three forward calls do, and the running
statistics chain over the three updates (the zero rows of invalid
negatives enter the third pass's statistics too).

A train step reads nothing back from the device: its metrics, per-dataset
sums by `index_add_` included, stay there until the epoch's one readback
(`core/metrics.fetch_metrics`). Dropout masks come from a generator
seeded `fold_in(seed, step)` (`train/vpd.fold_in`); the trainer passes
`seed + 1`, as vpd_tpu keys its dropout `fold_in(key(seed + 1), step)`.
The teacher computes in float32 (vpd_tpu's default dtype) with TF32 left
off.

On a data mesh (a state made with `mesh=`) each rank steps on its rows
of the global batch: the loss is divided by the global row count, the
dropout masks are drawn for the global batch and sliced
(`train/vpd.global_rows_draw`), the BatchNorm statistics are global, the
gradients are summed over the data group before AdamW, and the epoch's
metrics are summed over it.
"""

import torch
from torch import nn

from ..core.mesh import all_reduce_grads, all_reduce_sum
from ..core.metrics import fetch_metrics
from ..models.fc import set_dropout_draw
from .vpd import fold_in, global_rows_draw, optimizer_step

HINGE_MARGIN = 1.0


class VIPEModel(nn.Module):
    """Encoder + (optional) multi-head 3D decoder."""

    def __init__(self, encoder, decoder=None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder  # None for pairwise-only configs

    def embed(self, pose):
        return self.encoder(pose.reshape(pose.shape[0], -1))

    def decode(self, emb, dataset_id):
        return self.decoder(emb, dataset_id)

    def forward(self, batch):
        e1 = self.embed(batch['pose1'])
        e2 = self.embed(batch['pose2'])
        e_neg = self.embed(batch['pose_neg'])
        pred1 = pred2 = None
        if self.decoder is not None:
            pred1 = self.decode(e1, batch['dataset_id'])
            pred2 = self.decode(e2, batch['dataset_id'])
        return e1, e2, e_neg, pred1, pred2


def _safe_norm(x):
    """||x|| per row with a finite gradient at x = 0."""
    return torch.sqrt(torch.sum(torch.square(x), dim=1) + 1e-12)


def _losses(model, batch, kp_mask, weight_3d, ranks=1):
    """(loss to backprop, metrics on the device) of `model` in its current
    mode on one batch of tensors, rows of a global batch `ranks` times as
    large (whose row count divides the loss)."""
    e1, e2, e_neg, pred1, pred2 = model(batch)
    n = e1.shape[0]
    ds_id = batch['dataset_id'].to(torch.long)

    pos = _safe_norm(e1 - e2)
    neg = torch.relu(HINGE_MARGIN - _safe_norm(e1 - e_neg))
    contra_rows = pos + neg * batch['neg_valid']

    row_loss = contra_rows
    if pred1 is not None:
        col_mask = kp_mask.index_select(0, ds_id) * batch['has_3d'][:, None]
        target = batch['kp_features']
        mse_rows = (torch.sum(torch.square(pred1 - target) * col_mask, dim=1)
                    + torch.sum(torch.square(pred2 - target) * col_mask,
                                dim=1))
        row_loss = contra_rows + weight_3d * mse_rows
    loss_sum = torch.sum(row_loss)

    rows = row_loss.detach()
    zeros = rows.new_zeros(kp_mask.shape[0])
    metrics = {
        'loss_sum': loss_sum.detach(),
        'contra_sum': torch.sum(contra_rows.detach()),
        'n': float(n),
        'ds_loss_sum': zeros.index_add(0, ds_id, rows),
        'ds_count': zeros.index_add(0, ds_id, torch.ones_like(rows)),
    }
    return loss_sum / (n * ranks), metrics


class _StepConstants:
    """The column mask on each device and dtype, and a step's dropout
    generator on each device, made once so that a step copies nothing to
    the device."""

    def __init__(self, kp_mask):
        self.mask = torch.as_tensor(kp_mask)
        self._masks = {}
        self._gens = {}

    def kp_mask(self, device, dtype):
        key = (device, dtype)
        if key not in self._masks:
            self._masks[key] = self.mask.to(device, dtype)
        return self._masks[key]

    def generator(self, device, seed):
        if device not in self._gens:
            self._gens[device] = torch.Generator(device=device)
        return self._gens[device].manual_seed(seed)


def make_train_step(kp_mask, weight_3d=1.0):
    """step(state, batch, seed) -> metrics: fwd/bwd of the mean loss and
    AdamW on a batch of tensors on the model's device. `kp_mask` is the
    batcher's (num_datasets, max_kp_dim) column mask."""
    consts = _StepConstants(kp_mask)

    def step(state, batch, seed):
        model = state.model.train()
        device = batch['pose1'].device
        gen = consts.generator(device, fold_in(seed, state.step))
        set_dropout_draw(model, global_rows_draw(gen, state.part))
        try:
            loss, metrics = _losses(
                model, batch,
                consts.kp_mask(device, batch['kp_features'].dtype), weight_3d,
                state.part[1])
        finally:
            set_dropout_draw(model, None)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(model.parameters(), state.data_group)
        optimizer_step(state)
        return metrics

    return step


def make_eval_step(kp_mask, weight_3d=1.0):
    """step(state, batch) -> metrics, the model in eval mode."""
    consts = _StepConstants(kp_mask)

    def step(state, batch):
        model = state.model.eval()
        with torch.no_grad():
            _, metrics = _losses(
                model, batch,
                consts.kp_mask(batch['pose1'].device,
                               batch['kp_features'].dtype), weight_3d)
        return metrics

    return step


def run_epoch(batcher, state, step_fn, num_batches, seed=None, train=True):
    """Host loop over one virtual epoch; returns the epoch's metrics.
    `step_fn` is a train step (called with `seed`) or an eval step; the
    metrics stay on the device until one readback at the end."""
    step_metrics = []
    for _ in range(num_batches):
        batch = batcher.next_batch()
        step_metrics.append(step_fn(state, batch, seed) if train
                            else step_fn(state, batch))
    step_metrics = fetch_metrics(step_metrics)

    mesh = state.mesh  # a data mesh: the global batch's sums
    total = dict(zip(('loss_sum', 'contra_sum', 'n'), all_reduce_sum(
        [sum(m[k] for m in step_metrics)
         for k in ('loss_sum', 'contra_sum', 'n')], mesh)))
    ds_loss = all_reduce_sum(sum(m['ds_loss_sum'] for m in step_metrics),
                             mesh)
    ds_count = all_reduce_sum(sum(m['ds_count'] for m in step_metrics),
                              mesh)
    n = max(total['n'], 1)
    return {
        'loss': total['loss_sum'] / n,
        'contra': total['contra_sum'] / n,
        'per_dataset': {i: float(ds_loss[i] / max(ds_count[i], 1))
                        for i in range(len(ds_loss))},
    }
