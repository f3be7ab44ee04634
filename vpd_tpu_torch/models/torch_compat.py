"""torchvision ResNet state_dicts for the port's student: ImageNet init.

Counterpart of `vpd_tpu/models/torch_compat.py:38-110, 191-196`. The
port's `ResNet` (`models/resnet.py`) keeps torchvision's module names
(conv1, bn1, layer{1-4}.{i}.conv1/bn1/conv2/bn2[/conv3/bn3]
[/downsample.0/1], fc) and its NCHW layouts, so where vpd_tpu transposes
each tensor into flax's tree, the port only drops the reference's
`resnet.` prefix and checks every name and shape against a `ResNet` of
the architecture. The tensors are then the port's, as they are.

`imagenet_init_variables` reproduces the reference's pretrained student
(`models/rgb.py:56-66`): for other than 3 input channels the stem kernel
is averaged over its input channels and repeated (`add_flow_to_model`,
`models/rgb.py:19-37`), and `fc` is left out, so the student keeps its
freshly initialised embedding head (`replace_last_layer`,
`models/rgb.py:40-43`).
"""

import torch

from .resnet import ENCODER_ARCH, ResNet

_COUNTER = 'num_batches_tracked'


def convert_resnet_state_dict(sd, arch):
    """torchvision-style ResNet state_dict ({name: tensor or array}, with
    or without the reference's 'resnet.' prefix) -> the port's `ResNet`
    state_dict of `arch` as {name: tensor}, in the module's order. BN's
    `num_batches_tracked` counters are dropped (flax keeps none). Raises
    ValueError on a missing or unexpected name or a shape mismatch."""
    sd = {(k[len('resnet.'):] if k.startswith('resnet.') else k):
          torch.as_tensor(v) for k, v in sd.items()
          if not k.endswith(_COUNTER)}
    cfg = ENCODER_ARCH[arch]
    with torch.device('meta'):
        ref = ResNet(cfg.layers, cfg.block, sd['fc.weight'].shape[0],
                     in_channels=sd['conv1.weight'].shape[1],
                     width_per_group=cfg.width_per_group).state_dict()
    ref = {k: v for k, v in ref.items() if not k.endswith(_COUNTER)}
    if sorted(sd) != sorted(ref):
        raise ValueError('not a torchvision {} state_dict: missing {}, '
                         'unexpected {}'.format(
                             arch, sorted(set(ref) - set(sd)),
                             sorted(set(sd) - set(ref))))
    bad = [k for k in ref if sd[k].shape != ref[k].shape]
    if bad:
        raise ValueError('shapes differ from a {} at {}'.format(arch, bad))
    return {k: sd[k] for k in ref}


def imagenet_init_variables(sd, arch, num_channels=3):
    """torchvision ImageNet state_dict -> the student encoder's initial
    state_dict: every backbone tensor, the stem kernel mean-expanded to
    `num_channels` input channels, and no `fc` (the caller keeps its
    fresh embedding head)."""
    sd = convert_resnet_state_dict(sd, arch)
    del sd['fc.weight'], sd['fc.bias']
    if num_channels != 3:
        k = sd['conv1.weight']  # (64, 3, kh, kw)
        sd['conv1.weight'] = k.mean(dim=1, keepdim=True).expand(
            -1, num_channels, -1, -1).clone()
    return sd


def load_torch_state_dict(path):
    """A .pt/.pth state_dict read on the CPU as {name: tensor}; tensors
    only (`weights_only`), so the file runs no code."""
    return torch.load(path, map_location='cpu', weights_only=True)
