"""Map weights between vpd_tpu's flax variables and the port's modules.

A flax tree is ``{'params': {...}, 'batch_stats': {...}}`` of numpy
arrays under flax's own module names (creation order):

  ResNet      Conv_0, BatchNorm_0, BasicBlock_i | Bottleneck_i, Dense_0
  BasicBlock  Conv_0, BatchNorm_0, Conv_1, bn_last[, Conv_2, BatchNorm_1]
  Bottleneck  Conv_0, BatchNorm_0, Conv_1, BatchNorm_1, Conv_2, bn_last
              [, Conv_3, BatchNorm_2]
  MotionHead  FCNet_0/Dense_k

Layouts: conv kernel (kh, kw, I, O) <-> weight (O, I, kh, kw); dense
kernel (I, O) <-> weight (O, I); BN scale/bias <-> weight/bias and
batch_stats mean/var <-> running_mean/running_var. Both directions check
that every flax leaf is used exactly once and every torch parameter and
buffer (bar BN's `num_batches_tracked` counter) is filled.

`student_params_to_flax` / `student_params_from_flax` map one tensor per
parameter of a student (AdamW's moments, say) the same way, to and from
flax's `{'encoder': ..., 'motion': ...}` params trees.
"""

import numpy as np
import torch

from .resnet import BasicBlock, Bottleneck

_BLOCK_NAMES = {
    BasicBlock: [('conv1', 'Conv_0', 'conv'), ('bn1', 'BatchNorm_0', 'bn'),
                 ('conv2', 'Conv_1', 'conv'), ('bn2', 'bn_last', 'bn'),
                 ('downsample.0', 'Conv_2', 'conv'),
                 ('downsample.1', 'BatchNorm_1', 'bn')],
    Bottleneck: [('conv1', 'Conv_0', 'conv'), ('bn1', 'BatchNorm_0', 'bn'),
                 ('conv2', 'Conv_1', 'conv'), ('bn2', 'BatchNorm_1', 'bn'),
                 ('conv3', 'Conv_2', 'conv'), ('bn3', 'bn_last', 'bn'),
                 ('downsample.0', 'Conv_3', 'conv'),
                 ('downsample.1', 'BatchNorm_2', 'bn')],
}

# (torch leaf, collection, flax leaf, torch <- flax, flax <- torch)
_LEAVES = {
    'conv': [('weight', 'params', 'kernel',
              lambda a: a.transpose(3, 2, 0, 1),
              lambda t: t.permute(2, 3, 1, 0))],
    'dense': [('weight', 'params', 'kernel', lambda a: a.T,
               lambda t: t.T),
              ('bias', 'params', 'bias', None, None)],
    'bn': [('weight', 'params', 'scale', None, None),
           ('bias', 'params', 'bias', None, None),
           ('running_mean', 'batch_stats', 'mean', None, None),
           ('running_var', 'batch_stats', 'var', None, None)],
}


def _encoder_entries(model):
    """(torch module path, flax path, kind) in flax creation order."""
    entries = [('conv1', ('Conv_0',), 'conv'), ('bn1', ('BatchNorm_0',), 'bn')]
    blocks = [('layer{}.{}.'.format(s, j), block)
              for s in range(1, 5)
              for j, block in enumerate(getattr(model, 'layer{}'.format(s)))]
    for i, (prefix, block) in enumerate(blocks):
        flax_block = '{}_{}'.format(type(block).__name__, i)
        for tname, fname, kind in _BLOCK_NAMES[type(block)]:
            if tname.startswith('downsample') and block.downsample is None:
                continue
            entries.append((prefix + tname, (flax_block, fname), kind))
    entries.append(('fc', ('Dense_0',), 'dense'))
    return entries


def _motion_entries(head):
    return [('net.layers.{}'.format(k), ('FCNet_0', 'Dense_{}'.format(k)),
             'dense') for k in range(len(head.net.layers))]


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@torch.no_grad()
def _load(module, entries, variables):
    leaves = {(coll,) + path: arr for coll in ('params', 'batch_stats')
              for path, arr in _flatten(variables.get(coll, {})).items()}
    state = {k: v for k, v in module.state_dict(keep_vars=True).items()
             if not k.endswith('num_batches_tracked')}
    for tpath, fpath, kind in entries:
        for tleaf, coll, fleaf, to_torch, _ in _LEAVES[kind]:
            key = (coll,) + fpath + (fleaf,)
            if key not in leaves:
                raise KeyError('flax leaf {} missing (for {}.{})'.format(
                    '/'.join(key), tpath, tleaf))
            arr = np.asarray(leaves.pop(key))
            if to_torch is not None:
                arr = to_torch(arr)
            dst = state.pop('{}.{}'.format(tpath, tleaf))
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError('{}: flax {} vs torch {}'.format(
                    '/'.join(key), arr.shape, tuple(dst.shape)))
            dst.copy_(torch.from_numpy(np.array(arr)))  # owning copy
    if leaves:
        raise ValueError('unused flax leaves: {}'.format(
            sorted('/'.join(k) for k in leaves)))
    if state:
        raise ValueError('torch tensors left unfilled: {}'.format(
            sorted(state)))
    return module


@torch.no_grad()
def _export(module, entries):
    state = {k: v for k, v in module.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    out = {'params': {}, 'batch_stats': {}}
    for tpath, fpath, kind in entries:
        for tleaf, coll, fleaf, _, to_flax in _LEAVES[kind]:
            t = state.pop('{}.{}'.format(tpath, tleaf))
            t = t if to_flax is None else to_flax(t)
            node = out[coll]
            for name in fpath:
                node = node.setdefault(name, {})
            node[fleaf] = np.ascontiguousarray(
                t.detach().to('cpu', torch.float32).numpy())
    if state:
        raise ValueError('torch tensors without a flax name: {}'.format(
            sorted(state)))
    return out


def load_encoder_from_flax(model, variables):
    """Fill a `ResNet` from flax `{'params', 'batch_stats'}` (in place)."""
    return _load(model, _encoder_entries(model), variables)


def encoder_to_flax(model):
    """`ResNet` -> flax `{'params', 'batch_stats'}` of float32 arrays."""
    return _export(model, _encoder_entries(model))


def load_motion_from_flax(head, variables):
    """Fill a `MotionHead` from flax `{'params', 'batch_stats'}`."""
    return _load(head, _motion_entries(head), variables)


def motion_to_flax(head):
    """`MotionHead` -> flax `{'params': ..., 'batch_stats': {}}`."""
    return _export(head, _motion_entries(head))


def _student_parts(student):
    parts = [('encoder', _encoder_entries(student.encoder))]
    if student.motion is not None:
        parts.append(('motion', _motion_entries(student.motion)))
    return parts


def _param_leaves(entries):
    """(torch leaf path, flax path, torch <- flax, flax <- torch) of each
    parameter (not the BN statistics)."""
    return [('{}.{}'.format(tpath, tleaf), fpath + (fleaf,), to_torch,
             to_flax)
            for tpath, fpath, kind in entries
            for tleaf, coll, fleaf, to_torch, to_flax in _LEAVES[kind]
            if coll == 'params']


@torch.no_grad()
def student_params_to_flax(student, values):
    """{'encoder.conv1.weight': tensor, ...}, one tensor per parameter of
    a `VPDStudent` -> {'encoder': tree, 'motion': tree} of numpy arrays in
    flax's layouts and the tensors' dtypes."""
    out = {}
    for prefix, entries in _student_parts(student):
        tree = out[prefix] = {}
        for tname, fpath, _, to_flax in _param_leaves(entries):
            t = values['{}.{}'.format(prefix, tname)].detach()
            t = t if to_flax is None else to_flax(t)
            node = tree
            for name in fpath[:-1]:
                node = node.setdefault(name, {})
            node[fpath[-1]] = np.ascontiguousarray(t.cpu().numpy())
    return out


def student_params_from_flax(student, tree):
    """Inverse of `student_params_to_flax`: {torch parameter name: tensor
    in torch's layout}. Every leaf of `tree` must be used."""
    out = {}
    for prefix, entries in _student_parts(student):
        leaves = _flatten(tree[prefix])
        for tname, fpath, to_torch, _ in _param_leaves(entries):
            if fpath not in leaves:
                raise KeyError('flax leaf {}/{} missing'.format(
                    prefix, '/'.join(fpath)))
            arr = np.asarray(leaves.pop(fpath))
            out['{}.{}'.format(prefix, tname)] = torch.from_numpy(
                np.array(arr if to_torch is None else to_torch(arr)))
        if leaves:
            raise ValueError('unused flax leaves: {}'.format(
                sorted('/'.join(k) for k in leaves)))
    if set(tree) != {p for p, _ in _student_parts(student)}:
        raise ValueError('flax components {} for a student of {}'.format(
            sorted(tree), [p for p, _ in _student_parts(student)]))
    return out
