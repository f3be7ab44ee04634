"""EfficientNet-b{0..7} student backbone.

Counterpart of `vpd_tpu/models/efficientnet.py` (reference
`models/rgb.py:62-66`, `efficientnet_pytorch.EfficientNet.from_name`):
MBConv blocks with squeeze-and-excitation under width/depth compound
scaling, swish activations, on NCHW inputs of 3 or 5 channels. The
callers see the interface of `models/resnet.ResNet`: the body computes in
`compute_dtype` over parameters stored in `param_dtype`
(`set_compute_dtype`), and the embedding head runs in float32 (float64
for a float64 body) on the pooled features.

What follows vpd_tpu's flax module, not efficientnet_pytorch:

* convolutions pad as flax's `padding='SAME'`: at stride 2 the low side
  gets `total // 2` of the total padding (k = 3 on an even input pads
  (0, 1)), so the strided convolutions pad explicitly first;
* BatchNorm is flax's, momentum 0.99 and epsilon 1e-3
  (`resnet.FlaxBatchNorm2d`);
* the SE width is `max(1, int(in_filters * 0.25))` of the block's input
  width, and both SE convolutions have biases;
* stochastic depth is a constant rate of 0.2 on every stride-1 block of
  equal widths (flax's `Dropout(broadcast_dims=(1, 2, 3))`: one keep bit
  a sample), and the head's dropout takes the variant's rate;
* the global mean pool rounds to the compute dtype before the head, as
  `jnp.mean` of bf16 activations does;
* weights start as flax's: conv and dense kernels lecun-normal (a normal
  truncated at two standard deviations, rescaled), biases 0, BN scale 1
  and bias 0.

Dropout masks come from the train step (`fc.set_dropout_draw`).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .fc import FlaxDropout
from .resnet import CastConv2d, FlaxBatchNorm2d

# (width_mult, depth_mult, dropout)
ARCH_PARAMS = {
    'b0': (1.0, 1.0, 0.2), 'b1': (1.0, 1.1, 0.2), 'b2': (1.1, 1.2, 0.3),
    'b3': (1.2, 1.4, 0.3), 'b4': (1.4, 1.8, 0.4), 'b5': (1.6, 2.2, 0.4),
    'b6': (1.8, 2.6, 0.5), 'b7': (2.0, 3.1, 0.5),
}

# (kernel, repeats, in_filters, out_filters, expand, stride)
BASE_BLOCKS = [
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
]

SE_RATIO = 0.25
DROP_PATH_RATE = 0.2
BN_MOMENTUM, BN_EPS = 0.99, 1e-3
# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = .87962566103423978


def round_filters(filters, width_mult, divisor=8):
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats, depth_mult):
    return int(math.ceil(depth_mult * repeats))


def _same_pads(size, kernel, stride):
    """(low, high) padding of one axis under flax's 'SAME'."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(CastConv2d):
    """`CastConv2d` padded as flax's `padding='SAME'`: symmetric at stride
    1 (odd kernels), explicit and low-side short at stride 2."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1, bias=False):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if stride == 1 else 0,
                         groups=groups, bias=bias)

    def forward(self, x):
        if self.stride[0] != 1:
            k, s = self.kernel_size[0], self.stride[0]
            ph, pw = (_same_pads(n, k, s) for n in x.shape[2:])
            x = F.pad(x, (*pw, *ph))
        return super().forward(x)


def _bn(channels):
    return FlaxBatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class MBConv(nn.Module):

    def __init__(self, in_filters, out_filters, kernel, stride, expand,
                 drop_rate=DROP_PATH_RATE):
        super().__init__()
        mid = in_filters * expand
        self.expand = self.expand_bn = None
        if expand != 1:
            self.expand = SameConv2d(in_filters, mid, 1)
            self.expand_bn = _bn(mid)
        self.depthwise = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.depthwise_bn = _bn(mid)
        se_dim = max(1, int(in_filters * SE_RATIO))
        self.se_reduce = SameConv2d(mid, se_dim, 1, bias=True)
        self.se_expand = SameConv2d(se_dim, mid, 1, bias=True)
        self.project = SameConv2d(mid, out_filters, 1)
        self.project_bn = _bn(out_filters)
        self.residual = stride == 1 and in_filters == out_filters
        self.drop_path = (FlaxDropout(drop_rate, broadcast_dims=(1, 2, 3))
                          if self.residual else None)

    def forward(self, x):
        inputs = x
        if self.expand is not None:
            x = F.silu(self.expand_bn(self.expand(x)))
        x = F.silu(self.depthwise_bn(self.depthwise(x)))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(se))))
        x = self.project_bn(self.project(x * se))
        if self.residual:
            x = self.drop_path(x) + inputs
        return x


class EfficientNet(nn.Module):
    """(N, C, H, W) -> (N, output_dim) float32 embeddings."""

    def __init__(self, variant, output_dim, in_channels=3):
        super().__init__()
        width, depth, dropout = ARCH_PARAMS[variant]
        stem = round_filters(32, width)
        self.stem = SameConv2d(in_channels, stem, 3, 2)
        self.stem_bn = _bn(stem)
        layers = []
        for kernel, repeats, fin, fout, expand, stride in BASE_BLOCKS:
            fin, fout = round_filters(fin, width), round_filters(fout, width)
            for i in range(round_repeats(repeats, depth)):
                layers.append(MBConv(fin if i == 0 else fout, fout, kernel,
                                     stride if i == 0 else 1, expand))
        self.blocks = nn.ModuleList(layers)
        head = round_filters(1280, width)
        self.head = SameConv2d(fout, head, 1)
        self.head_bn = _bn(head)
        self.dropout = FlaxDropout(dropout)
        self.fc = nn.Linear(head, output_dim)
        self.compute_dtype = torch.float32
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = 1. / math.sqrt(m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def set_compute_dtype(self, dtype, param_dtype=None):
        """Compute the body in `dtype`, storing its parameters and BN
        statistics in `param_dtype` (default `dtype`); the head's are
        stored and computed in the wider of that and float32."""
        param_dtype = dtype if param_dtype is None else param_dtype
        head_dtype = torch.promote_types(param_dtype, torch.float32)
        for name, child in self.named_children():
            child.to(head_dtype if name == 'fc' else param_dtype)
        self.compute_dtype = dtype
        return self

    def forward(self, x):
        x = F.silu(self.stem_bn(self.stem(x.to(self.compute_dtype))))
        for block in self.blocks:
            x = block(x)
        x = F.silu(self.head_bn(self.head(x)))
        x = self.dropout(x.mean(dim=(2, 3)))
        return self.fc(x.to(self.fc.weight.dtype))


def build_effnet(model_arch, emb_dim, in_channels=3, dtype=torch.bfloat16,
                 param_dtype=None):
    """'effnet0'.. or 'efficientnet-b0'.. -> EfficientNet (parameters in
    `param_dtype`, by default `dtype`)."""
    variant = 'b' + model_arch[-1]
    if variant not in ARCH_PARAMS:
        raise ValueError('unknown EfficientNet {!r}'.format(model_arch))
    model = EfficientNet(variant, emb_dim, in_channels=in_channels)
    return model.set_compute_dtype(dtype, param_dtype)
