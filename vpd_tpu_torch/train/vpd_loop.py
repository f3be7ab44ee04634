"""The student's `config.json` manifest, construction and saving.

Counterpart of `vpd_tpu/train/vpd_loop.py:22-34,293-322`. A student dir
holds `config.json` plus `{name}.encoder.ckpt` (and `{name}.decoder.ckpt`
for the motion head) in vpd_tpu's flax-msgpack format, so a student
written by either package loads in the other. The epoch loop is not
ported yet (ROADMAP A4).
"""

import os

import torch

from ..core import checkpoint as ckpt
from ..core.io import store_json
from ..data.augment import RGB_MEAN_STD
from ..models import build_encoder
from ..models.flax_weights import encoder_to_flax, motion_to_flax
from .vpd import MotionHead, VPDStudent


def build_student(config, dtype=None):
    """Randomly initialised `VPDStudent` for a config.json manifest; the
    encoder body computes in `dtype` (bf16 by default), heads in f32."""
    dtype = dtype if dtype is not None else torch.bfloat16
    arch = config['encoder_arch']
    if 'resnet' in arch:
        encoder = build_encoder(arch, config['emb_dim'],
                                in_channels=5 if config['use_flow'] else 3,
                                dtype=dtype)
    elif 'effnet' in arch:
        raise NotImplementedError(
            'EfficientNet students are not ported yet (ROADMAP A10)')
    else:
        raise NotImplementedError(arch)
    motion = MotionHead(config['emb_dim']) if config['motion'] else None
    return VPDStudent(encoder, motion)


def save_student(save_dir, model, config, name='best_epoch'):
    """Write config.json and the encoder (+ decoder) checkpoints."""
    os.makedirs(save_dir, exist_ok=True)
    store_json(os.path.join(save_dir, 'config.json'), config)
    comps = {'encoder': encoder_to_flax(model.encoder)}
    if model.motion is not None:
        comps['decoder'] = motion_to_flax(model.motion)
    ckpt.save_bundle(save_dir, name, comps)


def default_config(dataset, emb_dim, num_epochs=1000, batch_size=100,
                   learning_rate=5e-4, img_dim=128, use_flow=False,
                   motion=False, encoder_arch='resnet34', pretrained=False,
                   model_select_window=5, checkpoint_frequency=None,
                   augment_val=False, jitter_order='batch'):
    """Manifest schema parity with `train_vpd_model.py:222-228`.

    `jitter_order` is recorded only when non-default ('per_sample') so
    the manifest stays schema-identical to reference-written configs.
    """
    extra = ({'jitter_order': jitter_order}
             if jitter_order != 'batch' else {})
    return {
        **extra,
        'augment_val': augment_val,
        'dataset': dataset,
        'num_epochs': num_epochs,
        'batch_size': batch_size,
        'learning_rate': learning_rate,
        'img_dim': img_dim,
        'use_flow': use_flow,
        'motion': motion,
        'emb_dim': emb_dim,
        'encoder_arch': encoder_arch,
        'pretrained': pretrained,
        'rgb_mean_std': [list(x) for x in
                         RGB_MEAN_STD['resnet' if pretrained else dataset]],
        'model_select_window': model_select_window,
        'checkpoint_frequency': checkpoint_frequency,
    }
