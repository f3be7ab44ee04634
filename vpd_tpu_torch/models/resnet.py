"""ResNet backbone for the VPD student.

Counterpart of `vpd_tpu/models/resnet.py`: a torchvision-style ResNet with
configurable input channels and output embedding dim. Modules take NCHW
tensors; extraction feeds channels_last views of NHWC buffers, which
cuDNN runs without a copy. The body computes in `dtype` (bf16 by default,
as the JAX package computes in bf16) while the embedding head runs in
float32 on the float32-cast pooled features, like JAX's `head_dt`.

BatchNorm: flax momentum 0.9 is torch momentum 0.1, epsilon 1e-5 in both;
eval uses the stored running statistics as they are.

`expand_stem_to_channels` reproduces the reference's 5-channel first-conv
surgery (`models/rgb.py:8-37`) on a module: the stem kernel is averaged
over its input channels and broadcast to the new count.
"""

import dataclasses
import math

import torch
from torch import nn


def _bn(channels):
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _conv(cin, cout, kernel, stride=1):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
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
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
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

    @property
    def compute_dtype(self):
        return self.conv1.weight.dtype

    def set_compute_dtype(self, dtype):
        """Cast the body to `dtype`; the head stays float32."""
        for name, child in self.named_children():
            child.to(torch.float32 if name == 'fc' else dtype)
        return self

    def forward(self, x):
        x = x.to(self.compute_dtype)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = x.mean(dim=(2, 3), dtype=torch.float32)  # global average pool
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


def build_encoder(arch, emb_dim, in_channels=3, dtype=torch.bfloat16):
    """Build the VPD student backbone by registry name."""
    cfg = ENCODER_ARCH[arch]
    model = ResNet(cfg.layers, cfg.block, emb_dim, in_channels=in_channels,
                   width_per_group=cfg.width_per_group)
    return model.set_compute_dtype(dtype)


@torch.no_grad()
def expand_stem_to_channels(model, num_channels):
    """Rebuild the stem conv for `num_channels` inputs by mean-expanding
    its kernel over the input channels (reference `add_flow_to_model`).
    Modifies `model` in place and returns it."""
    old = model.conv1
    mean = old.weight.mean(dim=1, keepdim=True)
    new = nn.Conv2d(num_channels, old.out_channels, old.kernel_size,
                    stride=old.stride, padding=old.padding, bias=False,
                    device=old.weight.device, dtype=old.weight.dtype)
    new.weight.copy_(mean.expand(-1, num_channels, -1, -1))
    model.conv1 = new
    return model
