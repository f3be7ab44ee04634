"""The reference's torch state_dicts <-> the port's modules.

Counterpart of `vpd_tpu/models/torch_compat.py`. Where vpd_tpu transposes
each reference tensor into flax's tree, the port maps reference names
onto its own modules, whose layouts are torch's: the flax side is
`models/flax_weights.py`'s. So a reference `{name}.encoder.pt` reaches a
vpd_tpu `.ckpt` as reference -> port module (here) -> flax tree
(`flax_weights`), and back the other way (`tools/import_torch_model`,
`tools/export_torch_model`).

* ResNet: the port's `ResNet` (`models/resnet.py`) keeps torchvision's
  module names (conv1, bn1, layer{1-4}.{i}.conv1/bn1/conv2/bn2[/conv3/
  bn3][/downsample.0/1], fc), so only the reference's `resnet.` prefix
  (`models/rgb.py:61`) comes and goes; every name and shape is checked
  against a `ResNet` of the architecture.
* FCResNet (the VIPE* encoder, reference `models/module.py:178-190`):
  `layers.0` <-> stem, `layers.{2+i}.block.{0,1,4,5}` <-> blocks.i.
  dense.0, bn.0, dense.1, bn.1, `layers.{2+n}` <-> out.
* FCPoseDecoder (reference `models/module.py:211-227`): the `fcn.layers.*`
  linears of the trunk (ReLU and dropout in between hold no tensors) <->
  trunk.layers.k, and one `fc_{dataset}` linear a 3D dataset <-> a slice
  of the padded (k, h, d) multi-head, zero for datasets without one.

Exports carry BatchNorm's `num_batches_tracked` counter at 0, as strict
`load_state_dict` in the reference needs; imports drop it (flax keeps
none).

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


def save_torch_state_dict(path, sd):
    """Save {name: tensor or array} as a .pt state_dict of contiguous
    tensors that own their storage (a view would save its whole base)."""
    torch.save({k: torch.as_tensor(v).contiguous().clone()
                for k, v in sd.items()}, path)


def load_converted(module, sd):
    """Load a converted state_dict (BN counters left out) into `module`,
    assigning its tensors, so `module` may be built on the meta device.
    Raises ValueError on a missing or unexpected name; torch raises on a
    shape mismatch."""
    missing, unexpected = module.load_state_dict(sd, strict=False,
                                                 assign=True)
    missing = [k for k in missing if not k.endswith(_COUNTER)]
    if missing or unexpected:
        raise ValueError('state_dict does not fit {}: missing {}, '
                         'unexpected {}'.format(type(module).__name__,
                                                missing, unexpected))
    return module


def torch_param_names(sd):
    """state_dict keys that are parameters (not buffers), in
    `module.parameters()` order: torch emits a module's parameters before
    its buffers and recurses in registration order, so filtering the
    ordered state_dict keeps an optimizer's parameter indexing."""
    return [k for k in sd
            if k.endswith(('.weight', '.bias')) and 'running' not in k]


def _fcresnet_modules(num_blocks):
    """(reference module, port module) of an FCResNet, in the reference's
    registration order."""
    pairs = [('layers.0', 'stem')]
    for i in range(num_blocks):
        t, b = 'layers.{}.block.'.format(2 + i), 'blocks.{}.'.format(i)
        pairs += [(t + '0', b + 'dense.0'), (t + '1', b + 'bn.0'),
                  (t + '4', b + 'dense.1'), (t + '5', b + 'bn.1')]
    return pairs + [('layers.{}'.format(2 + num_blocks), 'out')]


def _by_module(sd):
    out = {}
    for k, v in sd.items():
        mod, leaf = k.rsplit('.', 1)
        out.setdefault(mod, []).append((leaf, v))
    return out


def _renamed(sd, pairs, counters):
    """`sd` with module prefix a renamed b for each (a, b) of `pairs`, in
    their order. BN counters are dropped, or set to 0 with `counters`.
    Every module of `sd` must be renamed."""
    mods = _by_module(sd)
    out = {}
    for src, dst in pairs:
        for leaf, v in mods.pop(src, ()):
            if leaf != _COUNTER:
                out[dst + '.' + leaf] = torch.as_tensor(v)
            elif counters:
                out[dst + '.' + leaf] = torch.zeros((), dtype=torch.int64)
    if mods:
        raise ValueError('unexpected modules {}'.format(sorted(mods)))
    return out


def convert_fcresnet_state_dict(sd, num_blocks):
    """Reference FCResNet state_dict -> the port's `FCResNet` state_dict
    ({name: tensor}, BN counters dropped)."""
    return _renamed(sd, _fcresnet_modules(num_blocks), counters=False)


def export_fcresnet_state_dict(sd):
    """The port's `FCResNet` state_dict -> the reference's, in its order,
    with BN counters at 0."""
    num_blocks = sum(1 for k in sd if k.endswith('.dense.0.weight'))
    return _renamed(sd, [(b, a) for a, b in _fcresnet_modules(num_blocks)],
                    counters=True)


def convert_fcposedecoder_state_dict(sd, dataset_targets):
    """Reference FCPoseDecoder state_dict -> the port's `FCPoseDecoder`
    state_dict. The per-dataset heads stack into the padded multi-head in
    `dataset_targets` order ([(name, flattened 3D dim or 0)], the whole
    config['datasets']), zero where a dataset has no 3D head (the train
    step masks those columns), in the source's precision."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    trunk = sorted(int(k.split('.')[2]) for k in sd
                   if k.startswith('fcn.layers.') and k.endswith('.weight'))
    out = {'trunk.layers.{}.{}'.format(i, leaf):
           sd['fcn.layers.{}.{}'.format(j, leaf)]
           for i, j in enumerate(trunk) for leaf in ('weight', 'bias')}
    last = out['trunk.layers.{}.weight'.format(len(trunk) - 1)]
    head_dim = max(max(d for _, d in dataset_targets), 1)
    kernel = last.new_zeros((len(dataset_targets), last.shape[0], head_dim))
    bias = last.new_zeros((len(dataset_targets), head_dim))
    for i, (name, dim) in enumerate(dataset_targets):
        if dim:
            w = sd['fc_{}.weight'.format(name)]
            if tuple(w.shape) != (dim, last.shape[0]):
                raise ValueError('fc_{} is {}, not ({}, {})'.format(
                    name, tuple(w.shape), dim, last.shape[0]))
            kernel[i, :, :dim] = w.T
            bias[i, :dim] = sd['fc_{}.bias'.format(name)]
    out['head.kernel'], out['head.bias'] = kernel, bias
    return out


def export_fcposedecoder_state_dict(sd, dataset_targets):
    """The port's `FCPoseDecoder` state_dict -> the reference's: the trunk
    at the indices of the reference FCNet's Sequential (`models/module.py:
    133-153`, batch_norm off: Linear at 0, then ReLU, Linear[, Dropout]
    a hidden layer), then each 3D dataset's head cut out of the
    multi-head."""
    n_lin = sum(1 for k in sd if k.startswith('trunk.layers.')
                and k.endswith('.weight'))
    idxs, pos = [0], 1
    for i in range(n_lin - 1):
        pos += 1  # ReLU
        idxs.append(pos)
        pos += 1  # Linear
        if i + 1 < n_lin - 1:
            pos += 1  # Dropout
    out = {'fcn.layers.{}.{}'.format(j, leaf):
           torch.as_tensor(sd['trunk.layers.{}.{}'.format(i, leaf)])
           for i, j in enumerate(idxs) for leaf in ('weight', 'bias')}
    kernel, bias = (torch.as_tensor(sd['head.' + k])
                    for k in ('kernel', 'bias'))
    for i, (name, dim) in enumerate(dataset_targets):
        if dim:
            out['fc_{}.weight'.format(name)] = kernel[i, :, :dim].T
            out['fc_{}.bias'.format(name)] = bias[i, :dim]
    return out


def export_resnet_state_dict(sd, prefix='resnet.'):
    """The port's `ResNet` state_dict -> torchvision's names under
    `prefix` (the reference saves VPD encoders under 'resnet.',
    `models/rgb.py:61`; '' gives a bare torchvision ResNet), BN counters
    at 0."""
    return {prefix + k: (torch.zeros((), dtype=torch.int64)
                         if k.endswith(_COUNTER) else v)
            for k, v in sd.items()}
