"""All-pairs DTW: (Q, L, D) queries x (T, L, D) targets -> (Q, T) distances.

Kernel B2 of the port. It replaces the TPU kernel `_dtw_kernel` in
`vpd_tpu/ops/pallas/dtw_kernel.py` (launched by `dtw_matrix_pallas`) with
the hand-written CUDA kernel `csrc/dtw.cu` for sm_90a. The work is bound
by operations, in two parts, for each DP cell inside the lengths: the
local cost is a product of 2D flops, which the kernel runs on the tensor
cores in 3xTF32, and the recurrence about 8 float32 operations on the
CUDA cores; inputs and outputs are a few MB. The kernel's design is
described in its source.

On a CPU tensor `dtw_matrix` runs the plain twin `ops.dtw.
dtw_matrix_reference`; on a CUDA tensor it launches the kernel or raises.
`launches` counts kernel launches (not twin calls).
"""

import torch

from .dtw import STEP_PATTERNS, dtw_matrix_reference

MAX_LEN = 512   # the JAX row scan's default max_len: one kernel serves both
MAX_DIM = 128   # retrieval with a motion student flattens 2 x 64
STEP_IDS = {'symmetric2': 0, 'symmetricP2': 1}  # as ops/dtw_native in JAX

launches = 0


def _check(q, q_lens, t, t_lens, step_pattern):
    def bad(msg):
        raise ValueError('dtw_matrix: ' + msg)

    if step_pattern not in STEP_PATTERNS:
        bad('unknown step pattern {!r}'.format(step_pattern))
    for name, x in (('q', q), ('t', t)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            bad('{} must be a float32 tensor, got {}'.format(
                name, getattr(x, 'dtype', type(x).__name__)))
        if x.ndim != 3:
            bad('{} must be (N, L, D), got {}'.format(name, tuple(x.shape)))
        if not x.is_contiguous():
            bad('{} must be contiguous'.format(name))
    if q.shape[1:] != t.shape[1:]:
        bad('q {} and t {} differ in (L, D)'.format(tuple(q.shape),
                                                    tuple(t.shape)))
    _, L, D = q.shape
    if not 1 <= L <= MAX_LEN:
        bad('L = {} is outside [1, {}]'.format(L, MAX_LEN))
    if not 1 <= D <= MAX_DIM:
        bad('D = {} is outside [1, {}]'.format(D, MAX_DIM))
    for name, lens, x in (('q_lens', q_lens, q), ('t_lens', t_lens, t)):
        if not isinstance(lens, torch.Tensor) or lens.dtype != torch.int32:
            bad('{} must be an int32 tensor'.format(name))
        if lens.shape != x.shape[:1]:
            bad('{} must be ({},), got {}'.format(name, x.shape[0],
                                                  tuple(lens.shape)))
        if not lens.is_contiguous():
            bad('{} must be contiguous'.format(name))
        if lens.device != q.device or x.device != q.device:
            bad('every input must lie on {}'.format(q.device))
        if lens.numel():
            lo, hi = (int(v) for v in torch.aminmax(lens))
            if lo < 1 or hi > L:
                bad('{} must lie in [1, {}], got [{}, {}]'.format(
                    name, L, lo, hi))


def dtw_matrix(q, q_lens, t, t_lens, step_pattern='symmetricP2'):
    """(Q, T) float32 normalized DTW of every (query, target) pair.

    q: (Q, L, D) f32, t: (T, L, D) f32, each sequence zero-padded past its
    length; q_lens, t_lens: int32 in [1, L]. L <= 512 and D <= 128, else
    ValueError. +inf where the step pattern cannot reach the end cell.
    Same contract as `vpd_tpu.ops.pallas.dtw_kernel.dtw_matrix_pallas`.
    """
    global launches

    _check(q, q_lens, t, t_lens, step_pattern)
    if q.device.type == 'cpu':
        return dtw_matrix_reference(q, q_lens, t, t_lens, step_pattern)
    if q.device.type != 'cuda':
        raise ValueError('dtw_matrix: no kernel for device {}'.format(
            q.device))
    from ._build import load_kernels

    n_q, L, D = q.shape
    n_t = t.shape[0]
    out = torch.empty((n_q, n_t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = load_kernels()
    with torch.cuda.device(q.device):
        err = lib.vpd_dtw_matrix(
            q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(),
            out.data_ptr(), n_q, n_t, L, D, STEP_IDS[step_pattern],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            'dtw kernel launch failed with CUDA error {}'.format(err))
    launches += 1
    return out


def kernel_info(L, D, step_pattern='symmetricP2'):
    """What the kernel's launch for (L, D, step_pattern) uses on the
    current card: registers and local (spill) bytes per thread, shared
    memory bytes and warps per block, and warps resident per SM."""
    import ctypes

    from ._build import load_kernels

    info = (ctypes.c_int * 5)()
    err = load_kernels().vpd_dtw_kernel_info(L, D, STEP_IDS[step_pattern],
                                             info)
    if err != 0:
        raise RuntimeError('dtw kernel info failed with CUDA error {}'.format(
            err))
    return dict(zip(('registers', 'local_bytes', 'smem_bytes',
                     'warps_per_block', 'resident_warps_per_sm'), info))
