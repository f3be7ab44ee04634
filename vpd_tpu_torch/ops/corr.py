"""RAFT's correlation lookup: (2r+1)^2 bilinear taps at every pyramid level.

The hand-written CUDA kernel `csrc/corr_lookup.cu` (sm_90a) computes a
whole lookup in one launch: every level, every tap and every query,
written straight into the (B, H, W, levels * (2r+1)^2) float32 output. It
replaces no Pallas kernel (vpd_tpu's lookup is XLA); the plain form it
replaces on the card, `corr_lookup_reference` (vpd_tpu's separable
hat-weight form, written for the TPU's matrix unit), is about 65
launches a lookup: six elementwise launches for each of two weight
tensors a level, two small float32 batched products a level, and a cat.
The lookup is bound by bytes: at the flow cell's shapes (256 pairs, a
16 x 16 grid, 4 levels, radius 4) a correct kernel writes the 84.9 MB
output and reads the coordinates and, of each query's maps, at most each
level's (2r+2)^2 window inside the map (100 + 64 + 16 + 4 of its 340
cells, 48.2 MB): 133.7 MB, 39.9 us at the H100's 3.35 TB/s.

On CPU tensors `corr_lookup` runs the plain twin; on CUDA tensors it
launches the kernel or raises. The kernel takes float32 levels, each a
contiguous (N, h_l, w_l) map a query, 1 to 8 levels and radius 3 or 4
(raft-small's and RAFT basic's);
it follows the radius, the number of levels and each level's size (down
to the 1 x 1 level a 64-px input makes) from its inputs. Where autograd
asks for a gradient of a CUDA pyramid or coordinates, the kernel's
output carries the twin's backward (`_Lookup`): the twin is recomputed
from the saved inputs and differentiated, so RAFT's `train=True` runs on
the card with no backward kernel. `launches` counts kernel launches (not
twin calls).
"""

import ctypes

import torch

launches = 0

MAX_LEVELS = 8
RADII = (3, 4)


def _bad(msg):
    raise ValueError('corr_lookup: ' + msg)


def _tap_weights(centers, d, size):
    """(N,) centers + (K,) offsets -> (N, K, size) bilinear hat weights.

    The hat max(0, 1 - |pos - u|) over integer source positions u is
    grid_sample(align_corners=True, padding_mode='zeros'): out-of-range
    taps fade to zero contribution.
    """
    pos = centers[:, None, None] + d[None, :, None]
    idx = torch.arange(size, dtype=torch.float32,
                       device=centers.device)[None, None, :]
    return (1. - (pos - idx).abs()).clamp_min(0.)


def corr_lookup_reference(pyramid, coords, radius=4):
    """The plain twin: vpd_tpu's separable hat-weight form.

    coords (B, H, W, 2) at 1/8 resolution -> (B, H, W, levels*(2r+1)^2),
    each level's taps x-offset-major (k = i*(2r+1) + j for x offset i and
    y offset j): the separable weights make two batched products a level,
    x-interpolation then y-interpolation.
    """
    b, h, w, _ = coords.shape
    flat = coords.reshape(b * h * w, 2)
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[1], corr.shape[2]
        wx = _tap_weights(flat[:, 0] / (2. ** lvl), d, wl)  # (N, K, wl)
        wy = _tap_weights(flat[:, 1] / (2. ** lvl), d, hl)  # (N, K, hl)
        tmp = torch.bmm(corr, wx.transpose(1, 2))  # (N, hl, K): v, i
        vals = torch.bmm(tmp.transpose(1, 2), wy.transpose(1, 2))  # i, j
        out.append(vals.reshape(b, h, w, -1))
    return torch.cat(out, dim=-1)


def _check(pyramid, coords, radius):
    """What either path takes: (B, H, W, 2) coordinates, an int radius
    >= 0, and a non-empty list of (B*H*W, h_l, w_l) levels, h_l and w_l
    >= 1, on the coordinates' device."""
    if not isinstance(coords, torch.Tensor) or coords.ndim != 4 or \
            coords.shape[-1] != 2:
        _bad('coords must be a (B, H, W, 2) tensor, got {}'.format(
            tuple(coords.shape) if isinstance(coords, torch.Tensor)
            else type(coords).__name__))
    if isinstance(radius, bool) or not isinstance(radius, int) or \
            radius < 0:
        _bad('radius must be an int >= 0, got {!r}'.format(radius))
    if not isinstance(pyramid, (list, tuple)) or not pyramid:
        _bad('pyramid must be a non-empty list of levels')
    n = coords.shape[0] * coords.shape[1] * coords.shape[2]
    for lvl, t in enumerate(pyramid):
        if not isinstance(t, torch.Tensor) or t.ndim != 3 or \
                t.shape[0] != n or t.shape[1] < 1 or t.shape[2] < 1:
            _bad('level {} must be a ({}, h, w) tensor with h, w >= 1 '
                 '(one map a query of coords {}), got {}'.format(
                     lvl, n, tuple(coords.shape),
                     tuple(t.shape) if isinstance(t, torch.Tensor)
                     else type(t).__name__))
        if t.device != coords.device:
            _bad('level {} lies on {}, coords on {}'.format(
                lvl, t.device, coords.device))


def _check_kernel_args(pyramid, coords, radius):
    """What the kernel takes beyond the plain path: float32 throughout,
    contiguous levels, radius 3 or 4, 1-8 levels."""
    if radius not in RADII:
        _bad('the kernel takes radius 3 or 4, got {}'.format(radius))
    if len(pyramid) > MAX_LEVELS:
        _bad('the kernel takes at most {} levels, got {}'.format(
            MAX_LEVELS, len(pyramid)))
    for name, t in [('coords', coords)] + [
            ('level {}'.format(lvl), t) for lvl, t in enumerate(pyramid)]:
        if t.dtype != torch.float32:
            _bad('the kernel takes float32, {} is {}'.format(name, t.dtype))
    for lvl, t in enumerate(pyramid):
        if not t.is_contiguous():
            _bad('level {} must be contiguous'.format(lvl))


def _launch(pyramid, coords, radius):
    global launches

    from ._build import load_kernels

    b, h, w, _ = coords.shape
    levels = len(pyramid)
    out = torch.empty((b, h, w, levels * (2 * radius + 1) ** 2),
                      dtype=torch.float32, device=coords.device)
    n = b * h * w
    if n == 0:
        return out
    coords = coords.contiguous()
    maps = (ctypes.c_void_p * levels)(*(t.data_ptr() for t in pyramid))
    heights = (ctypes.c_int * levels)(*(t.shape[1] for t in pyramid))
    widths = (ctypes.c_int * levels)(*(t.shape[2] for t in pyramid))
    lib = load_kernels()
    with torch.cuda.device(coords.device):
        err = lib.vpd_corr_lookup(
            maps, heights, widths, levels, coords.data_ptr(),
            out.data_ptr(), n, radius,
            torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        raise RuntimeError('corr_lookup kernel launch failed with CUDA '
                           'error {}'.format(err))
    launches += 1
    return out


class _Lookup(torch.autograd.Function):
    """The kernel's lookup with the twin's gradient: the backward
    recomputes `corr_lookup_reference` from the saved inputs and returns
    autograd's gradients of it (there is no backward kernel)."""

    @staticmethod
    def forward(ctx, radius, coords, *pyramid):
        ctx.radius = radius
        ctx.save_for_backward(coords, *pyramid)
        return _launch(pyramid, coords, radius)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(
            ctx.saved_tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            out = corr_lookup_reference(inputs[1:], inputs[0], ctx.radius)
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], grad))
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in inputs)


def corr_lookup(pyramid, coords, radius=4):
    """Sample (2r+1)^2 neighbourhoods around coords at every level.

    pyramid: [levels x (B*H*W, h_l, w_l)] float32, as `models/raft.
    corr_pyramid` returns it; coords (B, H, W, 2) as (x, y) at 1/8
    resolution; level l is sampled at coords / 2^l. Returns (B, H, W,
    levels*(2r+1)^2) float32, each level's taps x-offset-major (k =
    i*(2r+1) + j for x offset i and y offset j), bilinear with zeros
    outside the map (`grid_sample(align_corners=True)`).
    """
    _check(pyramid, coords, radius)
    if coords.device.type == 'cpu':
        return corr_lookup_reference(pyramid, coords, radius)
    _check_kernel_args(pyramid, coords, radius)
    if coords.device.type != 'cuda':
        _bad('no kernel for device {}'.format(coords.device))
    if torch.is_grad_enabled() and (
            coords.requires_grad or any(t.requires_grad for t in pyramid)):
        return _Lookup.apply(radius, coords, *pyramid)
    return _launch(pyramid, coords, radius)
