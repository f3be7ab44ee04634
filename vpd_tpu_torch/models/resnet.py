"""ResNet backbone for the VPD student.

Counterpart of `vpd_tpu/models/resnet.py`: a torchvision-style ResNet with
configurable input channels and output embedding dim. Modules take NCHW
tensors; extraction feeds channels_last views of NHWC buffers, which
cuDNN runs without a copy. The body computes in `dtype` (bf16 by default,
as the JAX package computes in bf16) while the embedding head runs in
float32 (float64 for a float64 body) on the pooled features, like JAX's
`head_dt`.

Parameters are stored in `param_dtype`, the compute dtype by default
(extraction casts the body to bf16 once). The trainer keeps float32
master parameters and BN statistics and computes in bf16, as flax's
`dtype=bfloat16` with float32 `param_dtype` does: each conv casts its
input and kernel to the compute dtype, and BatchNorm computes its
statistics and affine in float32 and returns the compute dtype.

BatchNorm follows flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` (the
defaults of `FlaxBatchNorm2d`; EfficientNet passes 0.99 and 1e-3), not
torch's: in train mode it normalizes with the biased batch variance and
updates `running = 0.9 * running + (1 - 0.9) * stat` with the biased
variance too (torch would fold in the unbiased one). Eval uses the stored
running statistics as they are. On a data mesh (`set_bn_sync`) the train
mode's statistics are those of the global batch, as jit over vpd_tpu's
mesh gives them (`bn_axis_name`): the per-channel sums travel over the
data group.

`expand_stem_to_channels` reproduces the reference's 5-channel first-conv
surgery (`models/rgb.py:8-37`) on a module: the stem kernel is averaged
over its input channels and broadcast to the new count.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

FLAX_BN_MOMENTUM = 0.9


class _FlaxBatchNorm:
    """Mixin giving a torch BatchNorm class (same state-dict names) flax's
    train mode.

    Train mode normalizes with the batch mean and biased variance, which
    F.batch_norm computes in float32 or wider for any input dtype, and
    updates the running statistics with that same biased variance, as
    `running = m * running + (1 - m) * stat` with flax's momentum
    m = 1 - `self.momentum` (so `self.momentum = 1` keeps this batch). An
    input of another dtype than the parameters (bf16 activations, float32
    master parameters) comes back in its own dtype.
    """

    def __init__(self, channels, eps=1e-5, momentum=FLAX_BN_MOMENTUM):
        """`momentum` is flax's (the share of the running statistics
        kept), not torch's."""
        super().__init__(channels, eps=eps, momentum=1 - momentum)
        self.sync_group = _Group(None)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync_group.group is not None:
            return self._synced_forward(x)
        # momentum 1 writes this batch's mean and unbiased variance into
        # the temporaries, which is how F.batch_norm hands them out
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.,
                         self.eps)
        n = x.numel() // x.shape[1]
        m = 1 - self.momentum  # flax's momentum, 0.9 unless changed
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * (var * ((n - 1) / n)))
        return y

    def _synced_forward(self, x):
        """Train mode over the global batch: the per-channel sum, sum of
        squares and count are summed over the data group in float32 (or
        wider) by a differentiable all-reduce, whose backward sums the
        statistics' gradients (the loss is a sum over ranks). The
        variance is flax's fast one, max(0, E[x^2] - E[x]^2)."""
        from ..core.mesh import differentiable_all_reduce

        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        stats = differentiable_all_reduce(torch.cat([
            xf.sum(dims), (xf * xf).sum(dims),
            xf.new_full((1,), x.numel() // c)]), self.sync_group.group)
        mean = stats[:c] / stats[2 * c]
        var = torch.clamp(stats[c:2 * c] / stats[2 * c] - mean * mean, min=0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        scale = self.weight.to(xf.dtype) * torch.rsqrt(var + self.eps)
        y = ((xf - mean.view(shape)) * scale.view(shape)
             + self.bias.to(xf.dtype).view(shape))
        m = 1 - self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.detach())
        return y.to(x.dtype)


class _Group:
    """A process group held by a module: copies of the module share it
    (a process group cannot be copied)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def set_bn_sync(model, group):
    """Make every flax BatchNorm of `model` take its train statistics over
    `group` (a data group; None: this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.sync_group = _Group(group)


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """`nn.BatchNorm2d` with flax's train mode (the ResNet student)."""


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """`nn.BatchNorm1d` with flax's train mode, over (N, C) features (the
    FC teacher)."""


class CastConv2d(nn.Conv2d):
    """`nn.Conv2d` whose kernel (and bias) are cast to the input's dtype at
    each call (float32 master weights, bf16 compute)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _bn(channels):
    return FlaxBatchNorm2d(channels)


def _conv(cin, cout, kernel, stride=1):
    return CastConv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                      bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride),
                                         _bn(planes))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.))
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = _bn(out)
        self.downsample = (nn.Sequential(_conv(inplanes, out, 1, stride),
                                         _bn(out))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """(N, C, H, W) -> (N, output_dim) float32 embeddings."""

    def __init__(self, layers, block, output_dim, in_channels=3,
                 width_per_group=64):
        super().__init__()
        self.conv1 = CastConv2d(in_channels, 64, 7, stride=2, padding=3,
                                bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        stages = []
        for stage, num_blocks in enumerate(layers):
            planes = 64 * (2 ** stage)
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                needs_down = i == 0 and (
                    stride != 1 or inplanes != planes * block.expansion)
                kw = ({'base_width': width_per_group}
                      if block is Bottleneck else {})
                blocks.append(block(inplanes, planes, stride, needs_down,
                                    **kw))
                inplanes = planes * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.fc = nn.Linear(inplanes, output_dim)
        self.compute_dtype = torch.float32
        self._init_weights()

    def _init_weights(self):
        # as flax inits them: KAIMING_OUT for convs, lecun-normal kernel +
        # zero bias for the head, BN scale 1 and bias 0
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu')
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.fc.weight, std=1. / math.sqrt(
            self.fc.in_features))
        nn.init.zeros_(self.fc.bias)

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
        x = x.to(self.compute_dtype)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # global average pool, accumulated in the head's dtype
        x = x.mean(dim=(2, 3), dtype=self.fc.weight.dtype)
        return self.fc(x)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: tuple
    block: type
    width_per_group: int = 64


# Reference registry `models/module.py:17-32`.
ENCODER_ARCH = {
    'resnet18': ResNetConfig((2, 2, 2, 2), BasicBlock),
    'resnet34': ResNetConfig((3, 4, 6, 3), BasicBlock),
    'resnet50': ResNetConfig((3, 4, 6, 3), Bottleneck),
    'resnet101': ResNetConfig((3, 4, 23, 3), Bottleneck),
    'wide_resnet50_2': ResNetConfig((3, 4, 6, 3), Bottleneck,
                                    width_per_group=128),
    'wide_resnet101_2': ResNetConfig((3, 4, 23, 3), Bottleneck,
                                     width_per_group=128),
}


def build_encoder(arch, emb_dim, in_channels=3, dtype=torch.bfloat16,
                  param_dtype=None):
    """Build the VPD student backbone by registry name (parameters in
    `param_dtype`, by default `dtype`)."""
    cfg = ENCODER_ARCH[arch]
    model = ResNet(cfg.layers, cfg.block, emb_dim, in_channels=in_channels,
                   width_per_group=cfg.width_per_group)
    return model.set_compute_dtype(dtype, param_dtype)


@torch.no_grad()
def expand_stem_to_channels(model, num_channels):
    """Rebuild the stem conv for `num_channels` inputs by mean-expanding
    its kernel over the input channels (reference `add_flow_to_model`).
    Modifies `model` in place and returns it."""
    old = model.conv1
    mean = old.weight.mean(dim=1, keepdim=True)
    new = CastConv2d(num_channels, old.out_channels, old.kernel_size,
                     stride=old.stride, padding=old.padding, bias=False,
                     device=old.weight.device, dtype=old.weight.dtype)
    new.weight.copy_(mean.expand(-1, num_channels, -1, -1))
    model.conv1 = new
    return model
