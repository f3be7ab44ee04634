"""Plain float32 EfficientNet-b0 (Tan and Le 2019, "EfficientNet: Rethinking
Model Scaling for Convolutional Neural Networks") as the VPD student's
encoder.

Written from the paper's b0 table: a 3x3 stride-2 stem of 32 channels,
seven stages of MBConv blocks (kernel, repeats, in, out, expansion,
stride below), each block an optional 1x1 expansion, a depthwise
convolution, squeeze-and-excitation at a quarter of the block's input
width, and a 1x1 projection, with a residual where stride and width
allow; a 1x1 head of 1,280 channels, global average pool, dropout 0.2
and a dense layer to the embedding. Swish (x * sigmoid(x)) throughout.
Parameters are a flat {name: tensor} dict under the names the benchmark
hands to both sides (`encoder.stem`, `encoder.blocks.<i>.expand`, ...).

Departures from the paper, as the VPD reference trains it
(github.com/jhong93/vpd, `models/rgb.py:62-66`, random init) at the
port's conventions, which this file follows so that the two compute one
function: 5 input channels at 128 x 128 and a 32-d embedding;
TensorFlow's 'SAME' padding (at stride 2 the low side gets the smaller
half); BatchNorm with epsilon 1e-3 and the batch's biased variance in
train mode; stochastic depth at one rate of 0.2 on every residual block
(the paper's implementation raises the rate with depth), one keep bit a
sample, kept activations scaled by 1 / 0.8. The masks are given to
`forward` in the order the blocks use them (`dropout_shapes`).
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .resnet import batch_norm

PREFIX = 'encoder.'
BN_EPS = 1e-3
SE_RATIO = 0.25
DROP_PATH = 0.2
HEAD_DROPOUT = 0.2
HEAD = 1280
STEM = 32
# (kernel, repeats, in, out, expansion, stride), the paper's Table 1
B0 = [(3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2),
      (3, 3, 40, 80, 6, 2), (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
      (3, 1, 192, 320, 6, 1)]


def _blocks():
    """(index, kernel, in, out, expansion, stride) of every block."""
    out = []
    for k, repeats, cin, cout, expand, stride in B0:
        for i in range(repeats):
            out.append((len(out), k, cin if i == 0 else cout, cout, expand,
                        stride if i == 0 else 1))
    return out


def _residual(cin, cout, stride):
    return stride == 1 and cin == cout


def shapes(config):
    params, stats = {}, {}

    def conv(name, cin, cout, k, groups=1, bias=False):
        params[PREFIX + name + '.weight'] = (cout, cin // groups, k, k)
        if bias:
            params[PREFIX + name + '.bias'] = (cout,)

    def bn(name, c):
        params[PREFIX + name + '.weight'] = (c,)
        params[PREFIX + name + '.bias'] = (c,)
        stats[PREFIX + name + '.running_mean'] = (c,)
        stats[PREFIX + name + '.running_var'] = (c,)

    conv('stem', config['in_channels'], STEM, 3)
    bn('stem_bn', STEM)
    for i, k, cin, cout, expand, _ in _blocks():
        name = 'blocks.{}.'.format(i)
        mid = cin * expand
        if expand != 1:
            conv(name + 'expand', cin, mid, 1)
            bn(name + 'expand_bn', mid)
        conv(name + 'depthwise', mid, mid, k, groups=mid)
        bn(name + 'depthwise_bn', mid)
        se = max(1, int(cin * SE_RATIO))
        conv(name + 'se_reduce', mid, se, 1, bias=True)
        conv(name + 'se_expand', se, mid, 1, bias=True)
        conv(name + 'project', mid, cout, 1)
        bn(name + 'project_bn', cout)
    conv('head', B0[-1][3], HEAD, 1)
    bn('head_bn', HEAD)
    params[PREFIX + 'fc.weight'] = (config['emb_dim'], HEAD)
    params[PREFIX + 'fc.bias'] = (config['emb_dim'],)
    return params, stats


def dropout_shapes(config, batch):
    """Shapes of the keep masks one train forward draws, in its order:
    (batch, 1, 1, 1) for each residual block, then (batch, 1280) for the
    head; and each mask's keep probability."""
    out = [((batch, 1, 1, 1), 1 - DROP_PATH) for _, _, cin, cout, _, s
           in _blocks() if _residual(cin, cout, s)]
    return out + [((batch, HEAD), 1 - HEAD_DROPOUT)]


def _same(x, k, stride):
    """Pad (N, C, H, W) as 'SAME' for a k x k window at `stride`; returns
    (padded x, the padding left to the convolution)."""
    if stride == 1:
        return x, k // 2
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads), 0


def forward(p, stats, x, arith, train, config, drops=None, remat=False):
    """(N, C, H, W) float32 -> (N, emb_dim). In train mode `drops` holds
    the keep masks of `dropout_shapes`, in that order."""
    drops = list(drops or [])

    def bn(y, name):
        return batch_norm(y, p, stats, PREFIX + name, train, BN_EPS)

    def conv(y, name, k=1, stride=1, groups=1):
        y, pad = _same(y, k, stride)
        return arith.conv(y, p[PREFIX + name + '.weight'],
                          p.get(PREFIX + name + '.bias'), stride, pad,
                          groups)

    def block(y, i, k, cin, cout, expand, stride, keep):
        name = 'blocks.{}.'.format(i)
        inputs = y
        mid = cin * expand
        if expand != 1:
            y = F.silu(bn(conv(y, name + 'expand'), name + 'expand_bn'))
        y = F.silu(bn(conv(y, name + 'depthwise', k, stride, mid),
                      name + 'depthwise_bn'))
        se = y.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(conv(F.silu(conv(se, name + 'se_reduce')),
                                name + 'se_expand'))
        y = bn(conv(y * se, name + 'project'), name + 'project_bn')
        if _residual(cin, cout, stride):
            if keep is not None:
                y = torch.where(keep, y / (1 - DROP_PATH), 0.)
            y = y + inputs
        return y

    x = F.silu(bn(conv(x, 'stem', 3, 2), 'stem_bn'))
    for i, k, cin, cout, expand, stride in _blocks():
        keep = (drops.pop(0) if train and _residual(cin, cout, stride)
                else None)
        args = (x, i, k, cin, cout, expand, stride, keep)
        x = (checkpoint(block, *args, use_reentrant=False) if remat
             else block(*args))
    x = F.silu(bn(conv(x, 'head'), 'head_bn'))
    x = x.mean(dim=(2, 3))
    if train:
        x = torch.where(drops.pop(0), x / (1 - HEAD_DROPOUT), 0.)
    return arith.linear(x, p[PREFIX + 'fc.weight'], p[PREFIX + 'fc.bias'])
