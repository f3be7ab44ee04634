"""Operations and bytes the benchmark charges, computed from shapes.

`forward_flops` runs the reference student on `meta` tensors (no data,
no arithmetic) and tallies 2 x the multiply-adds of every convolution
and dense layer: BatchNorm, activations, pooling and the loss are left
out, as a model-FLOP count leaves them out. A train step is charged 3 x
the forward (the backward computes two products for each of the
forward's), an extraction crop 2 x the encoder's forward (the original
and the flipped variant).

`b1_bytes` is kernel B1's least traffic: each uint8 input byte read once
and each bfloat16 output byte written once.
"""

import torch

from .reference import student
from .reference.arith import CountingArith


def forward_flops(config, with_motion=True):
    """Forward FLOPs of one sample through the student (its encoder
    alone without `with_motion`)."""
    cfg = dict(config, motion=config['motion'] and with_motion)
    params, stats = student.shapes(cfg)
    meta = {k: torch.empty(s, device='meta')
            for k, s in {**params, **stats}.items()}
    s = cfg['img_dim']
    arith = CountingArith()
    student.forward(meta, meta, torch.empty((1, cfg['in_channels'], s, s),
                                            device='meta'),
                    arith, False, cfg)
    return arith.flops


def train_flops_per_sample(config):
    return 3 * forward_flops(config)


def infer_flops_per_sample(config):
    return 2 * forward_flops(config, with_motion=False)


def student_costs(config):
    """What a sample of a student cell costs, as the student drivers'
    `Cell.costs` give it to the readers: the FLOPs of a trained sample
    and of an extracted crop."""
    return {'train_per_sample': train_flops_per_sample(config),
            'infer_per_sample': infer_flops_per_sample(config)}


def b1_bytes(batch, img_dim, flow_channels, pair=True, out_channels=5):
    """Bytes B1 must move for one launch: (B, S, S, 3) rgb and (B, S, S,
    flow_channels) flow in, (2B or B, S, S, out_channels) bf16 out."""
    pixels = batch * img_dim * img_dim
    return pixels * (3 + flow_channels) + (2 if pair else 1) * pixels * \
        out_channels * 2
