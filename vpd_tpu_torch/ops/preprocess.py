"""Fused crop preprocess: uint8 crops (+ flow) -> normalized bf16 input.

Kernel B1 of the port. It replaces the TPU kernel `_kernel` in
`vpd_tpu/ops/pallas/preprocess.py` (launched by `preprocess_crops_pallas`)
with the hand-written CUDA kernel `csrc/preprocess.cu` for sm_90a. The
work is bound by bytes: at the extraction batch (B=512, 128x128, orig and
flip variants) it reads 50.3 MB of uint8 and writes 167.8 MB of bf16, at
least 65 us at the H100's 3.35 TB/s. The kernel reads each input byte
once and writes both variants from that one read (pair mode), straight
into the channels_last layout the encoder takes.

The kernel has two variants. The vector variant moves 16 bytes a thread
and stages whole rows in shared memory; it takes W a multiple of 16 up
to 1024, at most 4 flow channels and 16-byte aligned inputs. The general
variant (one thread per pixel) takes everything else. `kernel_variant`
decides from the shapes and the pointers before the launch.

On a CPU tensor the wrappers run the plain twin built from
`data/augment.py`; on a CUDA tensor they launch a variant of the kernel
or raise. `launches` counts kernel launches (not twin calls), and
`variant_launches` counts them by variant.
"""

import torch

from ..data.augment import eval_transform_batch, flip_batch

VECTOR_MAX_WIDTH = 1024
VECTOR_MAX_FLOW_C = 4

launches = 0
variant_launches = {'vector': 0, 'general': 0}


def preprocess_crops_reference(rgb_u8, flow_u8, flip, mean, std,
                               out_dtype=torch.bfloat16):
    """Plain PyTorch twin of the kernel's per-sample-flip mode."""
    x = eval_transform_batch(rgb_u8, mean, std, flow_u8=flow_u8)
    flipped = flip_batch(x, flow_u8 is not None)
    x = torch.where(flip.reshape(-1, 1, 1, 1) != 0, flipped, x)
    return x.to(out_dtype)


def preprocess_orig_and_flip_reference(rgb_u8, flow_u8, mean, std,
                                       out_dtype=torch.bfloat16):
    """Plain PyTorch twin of the kernel's pair mode: [orig; flipped]."""
    x = eval_transform_batch(rgb_u8, mean, std, flow_u8=flow_u8)
    return torch.cat([x, flip_batch(x, flow_u8 is not None)]).to(out_dtype)


def _check(rgb_u8, flow_u8, mean, std):
    def bad(msg):
        raise ValueError('preprocess: ' + msg)

    if not isinstance(rgb_u8, torch.Tensor) or rgb_u8.dtype != torch.uint8:
        bad('rgb must be a uint8 tensor, got {}'.format(
            getattr(rgb_u8, 'dtype', type(rgb_u8).__name__)))
    if rgb_u8.ndim != 4 or rgb_u8.shape[-1] != 3:
        bad('rgb must be (B, H, W, 3), got {}'.format(tuple(rgb_u8.shape)))
    if not rgb_u8.is_contiguous():
        bad('rgb must be contiguous')
    if flow_u8 is not None:
        if not isinstance(flow_u8, torch.Tensor) or \
                flow_u8.dtype != torch.uint8:
            bad('flow must be a uint8 tensor')
        if flow_u8.ndim != 4 or flow_u8.shape[:3] != rgb_u8.shape[:3] \
                or flow_u8.shape[-1] < 2:
            bad('flow must be (B, H, W, >=2) beside rgb {}, got {}'.format(
                tuple(rgb_u8.shape), tuple(flow_u8.shape)))
        if not flow_u8.is_contiguous():
            bad('flow must be contiguous')
        if flow_u8.device != rgb_u8.device:
            bad('rgb and flow lie on different devices')
    if len(mean) != 3 or len(std) != 3:
        bad('mean and std need 3 values each')


def kernel_variant(rgb_u8, flow_u8):
    """'vector' where the kernel's vector variant takes these (checked)
    inputs, else 'general': W a multiple of 16 and at most
    VECTOR_MAX_WIDTH, at most VECTOR_MAX_FLOW_C flow channels, and rgb
    and flow starting on a 16-byte boundary. The output, a fresh tensor,
    always does."""
    w = rgb_u8.shape[2]
    ok = w % 16 == 0 and w <= VECTOR_MAX_WIDTH and rgb_u8.data_ptr() % 16 == 0
    if flow_u8 is not None:
        ok = ok and flow_u8.shape[-1] <= VECTOR_MAX_FLOW_C \
            and flow_u8.data_ptr() % 16 == 0
    return 'vector' if ok else 'general'


def _launch(rgb_u8, flow_u8, flip, mean, std, mode, out_dtype):
    global launches

    if rgb_u8.device.type != 'cuda':
        raise ValueError('preprocess: no kernel for device {}'.format(
            rgb_u8.device))
    if out_dtype != torch.bfloat16:
        raise ValueError('preprocess: the CUDA kernel writes bfloat16 only, '
                         'not {}'.format(out_dtype))
    from ._build import load_kernels

    b, h, w, _ = rgb_u8.shape
    channels = 3 if flow_u8 is None else 5
    out = torch.empty(((2 if mode == 1 else 1) * b, h, w, channels),
                      dtype=torch.bfloat16, device=rgb_u8.device)
    if b == 0:
        return out
    variant = kernel_variant(rgb_u8, flow_u8)
    lib = load_kernels()
    with torch.cuda.device(rgb_u8.device):
        err = lib.vpd_preprocess_crops(
            rgb_u8.data_ptr(),
            None if flow_u8 is None else flow_u8.data_ptr(),
            0 if flow_u8 is None else flow_u8.shape[-1],
            None if flip is None else flip.data_ptr(),
            out.data_ptr(), b, h, w,
            *(float(m) for m in mean), *(1. / float(s) for s in std),
            mode, int(variant == 'vector'),
            torch.cuda.current_stream(rgb_u8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            'preprocess kernel ({} variant) launch failed with CUDA error {}'
            .format(variant, err))
    launches += 1
    variant_launches[variant] += 1
    return out


def preprocess_crops(rgb_u8, flow_u8, flip, mean, std,
                     out_dtype=torch.bfloat16):
    """(B, H, W, 3) u8 [+ (B, H, W, >=2) u8 flow] -> (B, H, W, C) bf16.

    flip: (B,) int/bool; rows with flip != 0 are mirrored along W with the
    x-flow channel negated. Pass flow_u8=None for RGB-only (C = 3). Any B.
    Same contract as `vpd_tpu.ops.pallas.preprocess.preprocess_crops_pallas`.
    """
    _check(rgb_u8, flow_u8, mean, std)
    if not isinstance(flip, torch.Tensor) or flip.shape != rgb_u8.shape[:1]:
        raise ValueError('preprocess: flip must be a ({},) tensor'.format(
            rgb_u8.shape[0]))
    if flip.dtype.is_floating_point or flip.dtype.is_complex:
        raise ValueError('preprocess: flip must be int or bool, got {}'
                         .format(flip.dtype))
    if flip.device != rgb_u8.device:
        raise ValueError('preprocess: flip lies on {}, rgb on {}'.format(
            flip.device, rgb_u8.device))
    if rgb_u8.device.type == 'cpu':
        return preprocess_crops_reference(rgb_u8, flow_u8, flip, mean, std,
                                          out_dtype)
    flip = flip.to(torch.int32).contiguous()
    return _launch(rgb_u8, flow_u8, flip, mean, std, 0, out_dtype)


def preprocess_orig_and_flip(rgb_u8, flow_u8, mean, std,
                             out_dtype=torch.bfloat16):
    """Pair mode: (2B, H, W, C) with out[:B] the originals and out[B:] the
    flipped variants (x-flow negated), from one read of the input."""
    _check(rgb_u8, flow_u8, mean, std)
    if rgb_u8.device.type == 'cpu':
        return preprocess_orig_and_flip_reference(rgb_u8, flow_u8, mean, std,
                                                  out_dtype)
    return _launch(rgb_u8, flow_u8, None, mean, std, 1, out_dtype)
