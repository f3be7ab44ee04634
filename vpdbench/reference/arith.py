"""The arithmetic of the plain reference's products (convolutions and
dense layers), in the precision it is asked for.

`Arith` is plain float32: every product reads its operands as they are,
and `tf32_off` keeps cuBLAS and cuDNN from rounding them to TF32 on the
card. `Fp8Arith` is the control, float8 where the configurations state
bfloat16, in the products alone (what a float8 convolution would
change): each product's operands are rounded to float8 e4m3 with one
scale a tensor (its largest magnitude maps to 448, e4m3's largest
finite value), and the gradient that reaches each product's output is
rounded to float8 e5m2 the same way (57,344) before the product's
backward uses it. The input's preparation stays float32.
`CountingArith` computes nothing on `meta` tensors and tallies the
products' floating-point operations (2 a multiply-add).
"""

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.
E5M2_MAX = 57344.


def _round(x, dtype, largest):
    """x rounded to the float8 `dtype` under one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradToE5M2(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


@contextlib.contextmanager
def tf32_off():
    """Full float32 products on the card for the block, flags restored."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class Arith:
    """float32 products."""

    name = 'float32'

    def cast(self, x):
        return x

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.cast(x), self.cast(w), b, stride, padding, 1,
                        groups)

    def linear(self, x, w, b=None):
        return F.linear(self.cast(x), self.cast(w), b)


class Fp8Arith(Arith):
    """Products on operands rounded to float8 e4m3, their backward on
    gradients rounded to e5m2 (a scale a tensor each)."""

    name = 'float8'

    def cast(self, x):
        q = _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
        return x + (q - x).detach()

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return _GradToE5M2.apply(super().conv(x, w, b, stride, padding,
                                              groups))

    def linear(self, x, w, b=None):
        return _GradToE5M2.apply(super().linear(x, w, b))


class CountingArith(Arith):
    """Tallies 2 x the multiply-adds of each product into `flops`."""

    name = 'count'

    def __init__(self):
        self.flops = 0

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        out = super().conv(x, w, b, stride, padding, groups)
        self.flops += 2 * out.numel() * w[0].numel()
        return out

    def linear(self, x, w, b=None):
        out = super().linear(x, w, b)
        self.flops += 2 * out.numel() * w.shape[1]
        return out
