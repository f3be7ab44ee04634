"""Map weights between vpd_tpu's flax variables and the port's modules.

A flax tree is ``{'params': {...}, 'batch_stats': {...}}`` of numpy
arrays under flax's own module names (creation order):

  ResNet      Conv_0, BatchNorm_0, BasicBlock_i | Bottleneck_i, Dense_0
  BasicBlock  Conv_0, BatchNorm_0, Conv_1, bn_last[, Conv_2, BatchNorm_1]
  Bottleneck  Conv_0, BatchNorm_0, Conv_1, BatchNorm_1, Conv_2, bn_last
              [, Conv_3, BatchNorm_2]
  EfficientNet  Conv_0, BatchNorm_0 (stem), MBConv_i (numbered across
              stages), Conv_1, BatchNorm_1 (head), Dense_0
  MBConv      [Conv_0 (expand),] depthwise, SE reduce, SE expand (with
              biases), project, then [BatchNorm_0 (expand),] depthwise and
              project BNs, each numbered from 0: Conv_0..4 and
              BatchNorm_0..2, or Conv_0..3 and BatchNorm_0..1 at expand 1
  MotionHead  FCNet_0/Dense_k
  VIPEModel   encoder: FCResNet; decoder: FCPoseDecoder | FCResNetPoseDecoder
  FCResNet    Dense_0 (stem), FcResidualBlock_i, Dense_1 (out)
  FcResidualBlock  Dense_0, BatchNorm_0, Dense_1, BatchNorm_1
  FCPoseDecoder    FCNet_0/Dense_k, _MultiHead_0
  FCResNetPoseDecoder  FCResNet_0, _MultiHead_0

Layouts: conv kernel (kh, kw, I, O) <-> weight (O, I, kh, kw) (a
depthwise kernel (kh, kw, 1, C) <-> (C, 1, kh, kw)); dense
kernel (I, O) <-> weight (O, I); BN scale/bias <-> weight/bias and
batch_stats mean/var <-> running_mean/running_var; the multi-head kernel
(k, h, d) and bias (k, d) keep their shapes. Both directions check that
every flax leaf is used exactly once and every torch parameter and buffer
(bar BN's `num_batches_tracked` counter) is filled.

The heads on frozen embeddings (`models/gru.py`, and the proposal model)
map one member of their stacked weights at a time:
`load_seq_head_from_flax` / `seq_head_to_flax` and the `proposal` pair.

RAFT (`models/raft.py`, official torch key names) maps through
`import_torch_raft` / `export_torch_raft`: `load_raft_from_flax` /
`raft_to_flax`.

`student_params_to_flax` / `student_params_from_flax` (and the `vipe_`
pair for the teacher) map one tensor per parameter (AdamW's moments, say)
the same way, to and from flax's params trees: `{'encoder': ...,
'motion': ...}` for a student, `{'encoder': ..., 'decoder': ...}` for the
teacher.
"""

import numpy as np
import torch

from .efficientnet import EfficientNet
from .fc import FCResNet
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
    'conv_bias': [('weight', 'params', 'kernel',
                   lambda a: a.transpose(3, 2, 0, 1),
                   lambda t: t.permute(2, 3, 1, 0)),
                  ('bias', 'params', 'bias', None, None)],
    'dense': [('weight', 'params', 'kernel', lambda a: a.T,
               lambda t: t.T),
              ('bias', 'params', 'bias', None, None)],
    'bn': [('weight', 'params', 'scale', None, None),
           ('bias', 'params', 'bias', None, None),
           ('running_mean', 'batch_stats', 'mean', None, None),
           ('running_var', 'batch_stats', 'var', None, None)],
    'multihead': [('kernel', 'params', 'kernel', None, None),
                  ('bias', 'params', 'bias', None, None)],
}


def _effnet_entries(model):
    entries = [('stem', ('Conv_0',), 'conv'),
               ('stem_bn', ('BatchNorm_0',), 'bn')]
    for i, block in enumerate(model.blocks):
        convs = [('depthwise', 'conv'), ('se_reduce', 'conv_bias'),
                 ('se_expand', 'conv_bias'), ('project', 'conv')]
        bns = ['depthwise_bn', 'project_bn']
        if block.expand is not None:
            convs.insert(0, ('expand', 'conv'))
            bns.insert(0, 'expand_bn')
        prefix, flax_block = 'blocks.{}.'.format(i), 'MBConv_{}'.format(i)
        entries += [(prefix + t, (flax_block, 'Conv_{}'.format(k)), kind)
                    for k, (t, kind) in enumerate(convs)]
        entries += [(prefix + t, (flax_block, 'BatchNorm_{}'.format(k)), 'bn')
                    for k, t in enumerate(bns)]
    return entries + [('head', ('Conv_1',), 'conv'),
                      ('head_bn', ('BatchNorm_1',), 'bn'),
                      ('fc', ('Dense_0',), 'dense')]


def _encoder_entries(model):
    """(torch module path, flax path, kind) in flax creation order."""
    if isinstance(model, EfficientNet):
        return _effnet_entries(model)
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


def _fcresnet_entries(net):
    entries = [('stem', ('Dense_0',), 'dense')]
    for i in range(len(net.blocks)):
        block = 'FcResidualBlock_{}'.format(i)
        for j in range(2):
            entries += [('blocks.{}.dense.{}'.format(i, j),
                         (block, 'Dense_{}'.format(j)), 'dense'),
                        ('blocks.{}.bn.{}'.format(i, j),
                         (block, 'BatchNorm_{}'.format(j)), 'bn')]
    if net.out is not None:
        entries.append(('out', ('Dense_1',), 'dense'))
    return entries


def _pose_decoder_entries(decoder):
    if isinstance(decoder.trunk, FCResNet):
        trunk = [('trunk.' + t, ('FCResNet_0',) + f, kind)
                 for t, f, kind in _fcresnet_entries(decoder.trunk)]
    else:
        trunk = [('trunk.layers.{}'.format(k),
                  ('FCNet_0', 'Dense_{}'.format(k)), 'dense')
                 for k in range(len(decoder.trunk.layers))]
    return trunk + [('head', ('_MultiHead_0',), 'multihead')]


def _vipe_parts(model):
    parts = [('encoder', _fcresnet_entries(model.encoder))]
    if model.decoder is not None:
        parts.append(('decoder', _pose_decoder_entries(model.decoder)))
    return parts


def _prefixed(parts):
    """One entry list over a model's parts, under the parts' names."""
    return [('{}.{}'.format(prefix, t), (prefix,) + f, kind)
            for prefix, entries in parts for t, f, kind in entries]


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
    """Fill a `ResNet` or `EfficientNet` from flax `{'params',
    'batch_stats'}` (in place)."""
    return _load(model, _encoder_entries(model), variables)


def encoder_to_flax(model):
    """`ResNet` or `EfficientNet` -> flax `{'params', 'batch_stats'}` of
    float32 arrays."""
    return _export(model, _encoder_entries(model))


def load_motion_from_flax(head, variables):
    """Fill a `MotionHead` from flax `{'params', 'batch_stats'}`."""
    return _load(head, _motion_entries(head), variables)


def motion_to_flax(head):
    """`MotionHead` -> flax `{'params': ..., 'batch_stats': {}}`."""
    return _export(head, _motion_entries(head))


def load_vipe_from_flax(model, variables):
    """Fill a `train.vipe.VIPEModel` from flax `{'params': {'encoder': ...,
    'decoder': ...}, 'batch_stats': {'encoder': ...}}` (in place)."""
    return _load(model, _prefixed(_vipe_parts(model)), variables)


def vipe_to_flax(model):
    """`VIPEModel` -> flax `{'params', 'batch_stats'}` of float32 arrays,
    under 'encoder' (and 'decoder')."""
    return _export(model, _prefixed(_vipe_parts(model)))


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
def _params_to_flax(parts, values):
    out = {}
    for prefix, entries in parts:
        tree = out[prefix] = {}
        for tname, fpath, _, to_flax in _param_leaves(entries):
            t = values['{}.{}'.format(prefix, tname)].detach()
            t = t if to_flax is None else to_flax(t)
            node = tree
            for name in fpath[:-1]:
                node = node.setdefault(name, {})
            node[fpath[-1]] = np.ascontiguousarray(t.cpu().numpy())
    return out


def _params_from_flax(parts, tree):
    out = {}
    for prefix, entries in parts:
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
    if set(tree) != {p for p, _ in parts}:
        raise ValueError('flax components {} for a model of {}'.format(
            sorted(tree), [p for p, _ in parts]))
    return out


def student_params_to_flax(student, values):
    """{'encoder.conv1.weight': tensor, ...}, one tensor per parameter of
    a `VPDStudent` -> {'encoder': tree, 'motion': tree} of numpy arrays in
    flax's layouts and the tensors' dtypes."""
    return _params_to_flax(_student_parts(student), values)


def student_params_from_flax(student, tree):
    """Inverse of `student_params_to_flax`: {torch parameter name: tensor
    in torch's layout}. Every leaf of `tree` must be used."""
    return _params_from_flax(_student_parts(student), tree)


def vipe_params_to_flax(model, values):
    """`student_params_to_flax` for a `VIPEModel`: {'encoder': tree[,
    'decoder': tree]}."""
    return _params_to_flax(_vipe_parts(model), values)


def vipe_params_from_flax(model, tree):
    """Inverse of `vipe_params_to_flax`."""
    return _params_from_flax(_vipe_parts(model), tree)


# ------------------------------------------- heads on frozen embeddings
#
# SeqClassifier  [MaskedBatchNorm_0], BiRNN_0/Torch{GRU,LSTM}Cell_{2l+d}/
#                {ir,iz,in,hr,hz,hn | ii,if,ig,io,hi,hf,hg,ho}, [Dense_0
#                (attention)], BatchNorm_0, Dense_*, BatchNorm_1, Dense_*
# CNNClassifier  Conv_i (kernel sizes in order, each followed by its
#                second conv at depth 2), Dense_0, Dense_1
# ProposalSeq    BiRNN_0, BatchNorm_0, Dense_0, BatchNorm_1, Dense_1
#
# The port's modules hold M members along a leading axis; each leaf below
# is a view of one member's tensor in flax's layout (a gate's column block
# of the fused projections, a conv weight (H, D, k) seen as (k, D, H)).

def _whole(t):
    return t


def _head_dense(tname, fname):
    return [('params', (fname, 'kernel'), tname + '.kernel', _whole),
            ('params', (fname, 'bias'), tname + '.bias', _whole)]


def _head_bn(tname, fname):
    return [('params', (fname, 'scale'), tname + '.weight', _whole),
            ('params', (fname, 'bias'), tname + '.bias', _whole),
            ('batch_stats', (fname, 'mean'), tname + '.running_mean', _whole),
            ('batch_stats', (fname, 'var'), tname + '.running_var', _whole)]


def _head_birnn(rnn, prefix):
    from .gru import GATES

    cell = {'gru': 'TorchGRUCell', 'lstm': 'TorchLSTMCell'}[rnn.cell_type]
    h = rnn.hidden_dim
    out = []
    for li in range(len(rnn.layers)):
        tname = '{}.layers.{}.'.format(prefix, li)
        for d in range(2):
            fcell = ('BiRNN_0', '{}_{}'.format(cell, 2 * li + d))
            for gi, names in enumerate(GATES[rnn.cell_type]):
                cols = slice(gi * h, (gi + 1) * h)
                for fname, src in zip(names, ('i', 'h')):
                    out += [('params', fcell + (fname, 'kernel'),
                             tname + 'w_' + src,
                             lambda t, d=d, c=cols: t[d, :, c]),
                            ('params', fcell + (fname, 'bias'),
                             tname + 'b_' + src,
                             lambda t, d=d, c=cols: t[d, c])]
    return out


def _head_leaves(model):
    """(collection, flax path, torch tensor name, member view -> flax
    view) of every leaf of a SeqClassifier, CNNClassifier or ProposalSeq."""
    from .gru import CNNClassifier, SeqClassifier

    if isinstance(model, CNNClassifier):
        leaves = []
        convs = [('convs.{}.{}'.format(i, j), conv)
                 for i, branch in enumerate(model.convs)
                 for j, conv in enumerate(branch)]
        for k, (tname, _) in enumerate(convs):
            fname = 'Conv_{}'.format(k)
            leaves += [('params', (fname, 'kernel'), tname + '.weight',
                        lambda t: t.permute(2, 1, 0)),
                       ('params', (fname, 'bias'), tname + '.bias', _whole)]
        return leaves + _head_dense('dense', 'Dense_0') + _head_dense(
            'out', 'Dense_1')
    leaves = _head_birnn(model.rnn, 'rnn')
    if isinstance(model, SeqClassifier):
        if model.input_bn is not None:
            leaves += _head_bn('input_bn', 'MaskedBatchNorm_0')
        dense = ['dense', 'out']
        if model.use_attention:
            dense.insert(0, 'attn')
    else:  # ProposalSeq
        dense = ['dense', 'out']
    leaves += _head_bn('bn0', 'BatchNorm_0') + _head_bn('bn1', 'BatchNorm_1')
    for i, tname in enumerate(dense):
        leaves += _head_dense(tname, 'Dense_{}'.format(i))
    return leaves


def _check_covered(model, leaves):
    names = {n for _, _, n, _ in leaves}
    tensors = {n for n, _ in model.state_dict().items()}
    if names != tensors:
        raise ValueError('torch tensors without a flax leaf: {}'.format(
            sorted(tensors - names)))


@torch.no_grad()
def load_seq_head_from_flax(model, variables, member=None):
    """Fill member `member` (None: every member) of a recognition head
    (`models.gru.SeqClassifier` / `CNNClassifier`) from the flax
    `{'params', 'batch_stats'}` that vpd_tpu's `SeqModelTrainer.save`
    writes. Every flax leaf must be used and every tensor filled."""
    leaves = _head_leaves(model)
    _check_covered(model, leaves)
    flat = {(coll,) + path: arr for coll in ('params', 'batch_stats')
            for path, arr in _flatten(variables.get(coll) or {}).items()}
    state = model.state_dict()
    members = (range(next(iter(state.values())).shape[0]) if member is None
               else [member])
    for coll, fpath, tname, view in leaves:
        key = (coll,) + fpath
        if key not in flat:
            raise KeyError('flax leaf {} missing (for {})'.format(
                '/'.join(key), tname))
        src = torch.from_numpy(np.array(flat.pop(key)))
        for m in members:
            dst = view(state[tname][m])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError('{}: flax {} vs torch {}'.format(
                    '/'.join(key), tuple(src.shape), tuple(dst.shape)))
            dst.copy_(src)
    if flat:
        raise ValueError('unused flax leaves: {}'.format(
            sorted('/'.join(k) for k in flat)))
    return model


@torch.no_grad()
def seq_head_to_flax(model, member=0):
    """Member `member` of a recognition head -> flax `{'params',
    'batch_stats'}` of arrays in the model's dtype (batch_stats empty for
    the CNN), the tree vpd_tpu's `SeqModelTrainer.save` writes."""
    leaves = _head_leaves(model)
    _check_covered(model, leaves)
    state = model.state_dict()
    out = {'params': {}, 'batch_stats': {}}
    for coll, fpath, tname, view in leaves:
        node = out[coll]
        for name in fpath[:-1]:
            node = node.setdefault(name, {})
        node[fpath[-1]] = np.ascontiguousarray(
            view(state[tname][member]).cpu().numpy())
    return out


# the proposal model (`train/proposal.ProposalSeq`, what vpd_tpu's
# proposal trainers hold) maps the same way
load_proposal_from_flax = load_seq_head_from_flax
proposal_to_flax = seq_head_to_flax


# ---------------------------------------------------------------------------
# RAFT (`models/raft.py`). Its state_dict keys are the official princeton-vl
# names, so the flax tree maps through the torch layout: the port's own
# copies of vpd_tpu's `import_torch_raft` / `export_torch_raft`
# (`vpd_tpu/models/raft.py:494-611`).

def _torch_conv_to_flax(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _torch_bn_to_flax(prefix, sd):
    params = {'scale': np.asarray(sd[prefix + '.weight']),
              'bias': np.asarray(sd[prefix + '.bias'])}
    stats = {'mean': np.asarray(sd[prefix + '.running_mean']),
             'var': np.asarray(sd[prefix + '.running_var'])}
    return params, stats


def import_torch_raft(sd):
    """Torch RAFT state_dict ({key: array}, either official layout, with
    or without DataParallel's `module.`) -> flax `{'params',
    'batch_stats'}`."""
    from .raft import is_small_state_dict

    sd = {(k[len('module.'):] if k.startswith('module.') else k): v
          for k, v in sd.items()}
    small = is_small_state_dict(sd)

    def conv(prefix):
        out = {'kernel': _torch_conv_to_flax(sd[prefix + '.weight'])}
        if prefix + '.bias' in sd:
            out['bias'] = np.asarray(sd[prefix + '.bias'])
        return out

    block_convs = ('conv1', 'conv2', 'conv3') if small else (
        'conv1', 'conv2')
    params, stats = {}, {}
    for enc, norm in (('fnet', 'instance'),
                      ('cnet', 'none' if small else 'batch')):
        p, s = {'conv1': conv(enc + '.conv1')}, {}
        if norm == 'batch':
            p['norm1'], s['norm1'] = _torch_bn_to_flax(enc + '.norm1', sd)
        for li, stride in ((1, 1), (2, 2), (3, 2)):
            for bi in range(2):
                name = 'layer{}_{}'.format(li, bi)
                tp = '{}.layer{}.{}'.format(enc, li, bi)
                bp = {c: conv('{}.{}'.format(tp, c)) for c in block_convs}
                bs = {}
                if norm == 'batch':
                    bp['norm1'], bs['norm1'] = _torch_bn_to_flax(
                        tp + '.norm1', sd)
                    bp['norm2'], bs['norm2'] = _torch_bn_to_flax(
                        tp + '.norm2', sd)
                if bi == 0 and stride != 1:
                    bp['downsample_conv'] = conv(tp + '.downsample.0')
                    if norm == 'batch':
                        bp['norm3'], bs['norm3'] = _torch_bn_to_flax(
                            tp + '.downsample.1', sd)
                p[name] = bp
                if bs:
                    s[name] = bs
        p['conv2'] = conv(enc + '.conv2')
        params[enc] = p
        if s:
            stats[enc] = s

    ub = 'update_block.'
    enc_convs = (('convc1', 'convf1', 'convf2', 'conv') if small
                 else ('convc1', 'convc2', 'convf1', 'convf2', 'conv'))
    gru_convs = (('convz', 'convr', 'convq') if small
                 else ('convz1', 'convr1', 'convq1',
                       'convz2', 'convr2', 'convq2'))
    params['update_block'] = {
        'encoder': {k: conv(ub + 'encoder.' + k) for k in enc_convs},
        'gru': {k: conv(ub + 'gru.' + k) for k in gru_convs},
        'flow_head_conv1': conv(ub + 'flow_head.conv1'),
        'flow_head_conv2': conv(ub + 'flow_head.conv2'),
    }
    if not small:
        params['update_block']['mask_conv1'] = conv(ub + 'mask.0')
        params['update_block']['mask_conv2'] = conv(ub + 'mask.2')
    return {'params': params, 'batch_stats': stats}


def export_torch_raft(variables):
    """Flax RAFT `{'params', 'batch_stats'}` -> torch state_dict
    {official key: ndarray}; the inverse of `import_torch_raft`."""
    out = {}

    def put_conv(prefix, p):
        out[prefix + '.weight'] = np.transpose(
            np.asarray(p['kernel']), (3, 2, 0, 1))
        if 'bias' in p:
            out[prefix + '.bias'] = np.asarray(p['bias'])

    def put_bn(prefix, p, s):
        out[prefix + '.weight'] = np.asarray(p['scale'])
        out[prefix + '.bias'] = np.asarray(p['bias'])
        out[prefix + '.running_mean'] = np.asarray(s['mean'])
        out[prefix + '.running_var'] = np.asarray(s['var'])

    params = variables['params']
    stats = variables.get('batch_stats', {})
    for enc in ('fnet', 'cnet'):
        p = params[enc]
        s = stats.get(enc, {})
        put_conv(enc + '.conv1', p['conv1'])
        if 'norm1' in p:
            put_bn(enc + '.norm1', p['norm1'], s['norm1'])
        for li in (1, 2, 3):
            for bi in range(2):
                name = 'layer{}_{}'.format(li, bi)
                tp = '{}.layer{}.{}'.format(enc, li, bi)
                bp, bs = p[name], s.get(name, {})
                for c in ('conv1', 'conv2', 'conv3'):
                    if c in bp:
                        put_conv('{}.{}'.format(tp, c), bp[c])
                for norm_name, torch_name in (
                        ('norm1', tp + '.norm1'), ('norm2', tp + '.norm2'),
                        ('norm3', tp + '.downsample.1')):
                    if norm_name in bp:
                        put_bn(torch_name, bp[norm_name], bs[norm_name])
                if 'downsample_conv' in bp:
                    put_conv(tp + '.downsample.0', bp['downsample_conv'])
        put_conv(enc + '.conv2', p['conv2'])

    ub = params['update_block']
    for k, v in ub['encoder'].items():
        put_conv('update_block.encoder.' + k, v)
    for k, v in ub['gru'].items():
        put_conv('update_block.gru.' + k, v)
    put_conv('update_block.flow_head.conv1', ub['flow_head_conv1'])
    put_conv('update_block.flow_head.conv2', ub['flow_head_conv2'])
    if 'mask_conv1' in ub:
        put_conv('update_block.mask.0', ub['mask_conv1'])
        put_conv('update_block.mask.2', ub['mask_conv2'])
    return out


@torch.no_grad()
def load_raft_from_flax(model, variables):
    """Fill a `models.raft.RAFT` from vpd_tpu's RAFT variables (numpy);
    every key must match."""
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           export_torch_raft(variables).items()})
    return model


@torch.no_grad()
def raft_to_flax(model):
    """A `models.raft.RAFT` -> flax `{'params', 'batch_stats'}` of numpy
    arrays, the variables vpd_tpu's RAFT applies."""
    return import_torch_raft({k: v.detach().cpu().numpy()
                              for k, v in model.state_dict().items()})
