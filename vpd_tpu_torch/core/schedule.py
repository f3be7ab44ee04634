"""Cosine-annealing LR with warm restarts + normalized weight decay.

A copy of `vpd_tpu/core/schedule.py` (numpy only): the host-side
re-implementation of the vendored adamwr scheduler the reference uses for
sequence heads (`util/torch/cyclic_scheduler.py:50-216`, defaults: cosine
policy, t_mult=2, restart_period = num_epochs // 10). Emits one
(lr, weight_decay) pair per optimizer step; the trainers upload an
epoch's pairs with its index schedule, so a step reads no host value.
"""

import math

import numpy as np


class CyclicCosineRestarts:

    def __init__(self, base_lr, base_wd, batch_size, epoch_size,
                 restart_period, t_mult=2.0, min_lr=1e-7):
        self.base_lr = base_lr
        self.min_lr = min_lr
        self.base_wd = base_wd
        self.batch_size = batch_size
        self.epoch_size = epoch_size
        self.restart_period = math.ceil(restart_period)
        self.t_mult = t_mult

        self.t_epoch = -1
        self.iteration = 0
        self.batch_increments = []
        self._lr = base_lr
        self._wd = base_wd

    def _set_batch_increment(self):
        d, r = divmod(self.epoch_size, self.batch_size)
        batches_in_epoch = d + 2 if r > 0 else d + 1
        self.iteration = 0
        self.batch_increments = np.linspace(
            0, 1, batches_in_epoch).tolist()

    def _advance(self):
        t_cur = self.t_epoch + self.batch_increments[self.iteration]
        self.iteration += 1

        eta_t = 0.5 * (1. + math.cos(math.pi * t_cur / self.restart_period))
        wd_norm = math.sqrt(self.batch_size
                            / (self.epoch_size * self.restart_period))
        self._lr = self.min_lr + (self.base_lr - self.min_lr) * eta_t
        self._wd = self.base_wd * eta_t * wd_norm

        if self.t_epoch % self.restart_period < self.t_epoch:
            self.restart_period = math.ceil(
                self.restart_period * self.t_mult)
            self.t_epoch = 0

    def epoch_start(self):
        """Parity with scheduler.step(): advance epoch, set first lr."""
        self.t_epoch += 1
        self._set_batch_increment()
        self._advance()

    def batch_step(self):
        """Parity with scheduler.batch_step(): set lr for the next batch."""
        self._advance()

    @property
    def lr(self):
        return self._lr

    @property
    def weight_decay(self):
        return self._wd
