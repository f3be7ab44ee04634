#!/usr/bin/env python3
"""Dry run of the student's data-parallel train step on n CPU ranks.

Counterpart of `__graft_entry__.dryrun_multichip(n)`: n processes join
one gloo group on the CPU (`core.mesh.spawn_ranks`) and each runs one
`VPDTrainer` epoch of one train and one validation step of the full
student step (ResNet-18, RGB + flow + mask, motion head, float32) at
32x32, the global batch 2n split over the ranks. Every rank must report
the same finite losses. Usage:

    python -m vpd_tpu_torch.tools.dryrun_multichip [n]
"""

import sys

import numpy as np

IMG = 32


class _Source:
    """Random global batches of 2n rows; a rank keeps its own rows."""

    num_batches = 1

    def __init__(self, seed, batch, part):
        self.rng = np.random.default_rng(seed)
        self.batch = batch
        self.part = part

    def next_batch(self):
        from ..core.mesh import part_rows

        b, r = self.batch, self.rng
        full = {'rgb': r.integers(0, 255, (b, IMG, IMG, 3), dtype=np.uint8),
                'flow': r.integers(0, 255, (b, IMG, IMG, 3), dtype=np.uint8),
                'mask': r.integers(0, 2, (b, IMG, IMG), dtype=np.uint8),
                'emb': r.normal(size=(b, 32)).astype(np.float32),
                'flip': r.integers(0, 2, b).astype(bool)}
        return {k: v[part_rows(b, self.part)] for k, v in full.items()}


def _rank(mesh):
    import torch

    from ..train.vpd_loop import VPDTrainer, default_config

    batch = 2 * mesh.world
    config = default_config('tennis', emb_dim=16, num_epochs=1,
                            batch_size=batch, img_dim=IMG, use_flow=True,
                            motion=True, encoder_arch='resnet18')
    trainer = VPDTrainer(_Source(0, batch, mesh.batch_part),
                         _Source(1, batch, mesh.batch_part), config,
                         mesh=mesh, dtype=torch.float32)
    return trainer.train_one_epoch(1)


def dryrun_multichip(n_devices=2):
    """One train and one validation step on `n_devices` gloo ranks;
    returns the (train, val) losses, the same on every rank."""
    from ..core.mesh import spawn_ranks

    losses = spawn_ranks(_rank, n_devices)
    assert all(l == losses[0] for l in losses), losses
    assert np.all(np.isfinite(losses[0])), losses[0]
    print('dryrun_multichip OK (VPD student): {} ranks, train loss {:.3f}, '
          'val loss {:.3f}'.format(n_devices, *losses[0]))
    return losses[0]


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
