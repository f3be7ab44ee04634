"""Fused few-shot sweep: train every trial of a few-shot size at once.

Counterpart of `vpd_tpu/train/fused_sweep.py`. The reference protocol
(`recognize.py:553-574`) trains one sequence head per (few-shot size,
trial): trials differ ONLY in which training sequences they see (every
trial uses the same seed, so initial weights and dropout streams are the
same; `util/classifier.py:185`). Here the trials are the M members of one
model (`models/gru.py`): the pool of training sequences goes to the
device once, each member addresses it through per-epoch index schedules
that it draws on the host from its own numpy stream, and every step
advances all members with one batched forward, backward and AdamW step
(`train/classifier.train_members`, the loop `SeqModelTrainer` runs with
one member). Each member keeps its own (lr, wd) schedule (members train on
subsets of different sizes), step count, dropout stream, validation-best
snapshot and early stop; a stopped member's weights, moments and
statistics stay frozen while the others train.

On a data mesh (`mesh`, `core.mesh.member_axis_placement`) the member
axis is split over the ranks: the members are padded to a multiple of the
rank count with copies of member 0, and each rank trains its block as
one model. Members are independent, so the epochs need no collective,
and each rank stops when its own members have stopped (a stopped member
is frozen). At the end every rank gathers every member's state from the
others (the one collective, which every rank reaches, one that holds
only pad members too), so `member(m)` answers on each rank.

BUCKETING CAVEAT: all members pad to one bucket derived from the POOL's
max length (`self.bucket_max_len`), while a standalone `SeqModelTrainer`
buckets to its own subset's max, and the unmasked attention-pooling quirk
(QUIRKS.md) makes trained weights depend on the padded length. Member for
member equality with sequential trainers therefore requires constructing
those with `bucket_floor=<this pool max>` (tasks/recognize.py does).
"""

import numpy as np
import torch

from .. import resolve_device
from ..core.mesh import all_gather_object, member_axis_placement
from ..models.flax_weights import seq_head_to_flax
from .classifier import (bucket_len, check_labels, make_model, to_pool,
                         train_members)


class FusedSweepTrainer:
    """Train M same-shape sequence heads as one batched model.

    Args mirror `SeqModelTrainer` with the member dimension factored out:
    X_pool / y_pool are the shared training sequences ((T, D) arrays) and
    integer labels; member_rows (length M) holds each member's rows of
    the pool in its local order; X_val / y_val are shared by every member.
    `mesh` splits the member axis over its ranks (on the mesh's device).
    `device` and `dtype` as in `SeqModelTrainer`.

    After construction, `member(m)` returns member m's (params,
    batch_stats) flax trees (its validation-best state when a validation
    set was given, else its final one): what `SeqModelTrainer.save` writes
    for the same weights.
    """

    def __init__(self, arch_type, X_pool, y_pool, member_rows, hidden_dim,
                 batch_size=50, num_epochs=500, min_epochs=10, wr_count=10,
                 early_term_acc=1, X_val=None, y_val=None, val_freq=1,
                 early_term_val_num_epochs=200, learning_rate=0.001,
                 seed=0, bucket_floor=None, mesh=None, log=None,
                 device=None, dtype=torch.float32, **kwargs):
        real_m = len(member_rows)
        mesh, member_rows, put_m, _ = member_axis_placement(mesh,
                                                            member_rows)
        self.device = device = resolve_device(
            device if mesh is None else mesh.device)
        y_pool = np.asarray(y_pool, np.int64)
        num_classes = check_labels(y_pool)
        for rows in member_rows:
            got = int(np.unique(y_pool[np.asarray(rows)]).shape[0])
            if got != num_classes:
                # a sequential trainer would build a smaller head for
                # this member (classes are re-derived per subset); the
                # stacked model cannot: callers fall back per size
                raise ValueError(
                    'member covers {} of {} classes; fused training '
                    'requires every member to see every class'.format(
                        got, num_classes))
        self.num_classes = num_classes
        self.num_members = real_m
        local_rows = put_m(member_rows)
        self.model = make_model(
            arch_type, X_pool[0].shape[-1], num_classes, hidden_dim,
            num_members=len(local_rows), seed=seed, **kwargs).to(
                device, dtype)
        self.bucket_max_len = bucket_len(max(
            max(len(x) for x in X_pool),
            max((len(x) for x in (X_val or [])), default=0),
            bucket_floor or 0))
        pool = to_pool(X_pool, y_pool, self.bucket_max_len, device, dtype)
        val = None
        if X_val is not None:
            xv, lv, _ = to_pool(X_val, y_val, self.bucket_max_len, device,
                                dtype)
            val = (xv, lv, np.asarray(y_val, np.int64))
        if log is not None:
            log('fused sweep: {} members on {}{}'.format(
                real_m, device, '' if mesh is None else
                ', {} a rank over {} ranks'.format(len(local_rows),
                                                   mesh.world)))
        best_epoch, stopped = train_members(
            self.model, device, pool, local_rows, batch_size=batch_size,
            num_epochs=num_epochs, min_epochs=min_epochs, wr_count=wr_count,
            early_term_acc=early_term_acc, val=val, val_freq=val_freq,
            early_term_val_num_epochs=early_term_val_num_epochs,
            learning_rate=learning_rate, seed=seed)
        trees = [seq_head_to_flax(self.model, mi)
                 for mi in range(len(local_rows))]
        if mesh is not None:  # every rank's members, in member order
            parts = all_gather_object(
                (trees, best_epoch, stopped), mesh.data_group)
            trees = [t for p in parts for t in p[0]]
            best_epoch = np.concatenate([p[1] for p in parts])
            stopped = np.concatenate([p[2] for p in parts])
        self._trees = trees[:real_m]
        self.best_epoch, self.stopped = best_epoch[:real_m], stopped[:real_m]

    def member(self, mi):
        """(params, batch_stats) flax trees of member `mi`."""
        tree = self._trees[mi]
        return tree['params'], tree['batch_stats']
