"""Tests of the port that need an sm_90 CUDA card; they skip elsewhere.

This file imports torch and the port only (the GPU host has no JAX, and
`tests/conftest.py` imports it), so on the card run it as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernel B1 (`ops/preprocess`) is held against its plain twin on the card
at atol 0.02 (bf16 rounding), with its rgb channels bit for bit and its
flow channels at most one bf16 step off, in both of its variants (the
vector one at W = 32 and 128, the general one at W = 20 and on views
that are not 16-byte aligned), which agree bit for bit. Kernel B2
(`ops/dtw_kernel`) is held against its twin at rtol = atol = 1e-3 with
the same +inf pattern (both use the matmul form of the cost, the kernel
in 3xTF32 on the tensor cores), at lengths on its tile edges and at D
off a multiple of 8, and
against the f64 host DP at rtol 5e-3 (identical sequences at 1e-5
absolute). Launch counters, the range checks, the launch's resources
and ptxas's report (no build of either kernel spills) are tested too.

The train step's input stage (`ops/augment`, kernel `csrc/train_augment
.cu`) is held against its plain twin (the gathered rows through
`train_augment_batch` on the CPU) on the same draws: in float32 at max abs
1e-5; in bf16 within 2 bf16 steps of the float32 twin on 99.9% of the
elements, with a mean abs error from it no larger than the bf16 twin's
(the bars of `tests/test_torch_augment.py`), in float64 at 1e-12 of the
float64 twin, at 128 x 128 with 5 and 3 channels, without jitter, with
per-sample orders, at 16 -> 12 and with a row offset, in each output
dtype (the noise drawn in it); its output is the same bit for bit from
cache rows and from the gathered batch, and from run to run.

The student's train step (the input kernel, cuDNN and fused AdamW) is
held against the CPU float32 path from the same weights and draws with
TF32 off: augmented images at atol 1e-5, the loss and the BN
running statistics at rtol 1e-4, parameters within 2.5 x lr (Adam's first
step is about lr x sign(g), and near-zero gradients may round to another
sign). The bf16 step keeps float32 master weights, makes no host sync and
lowers the loss on one batch.

The device crop cache holds the shards' bytes on the card, its staging
peaks at the corpus plus at most one shard, and the cached step gathers
without a host sync; with cuDNN deterministic, the cached and streamed
steps on the same rows give the same loss (rel 1e-6) and parameters (max
rel 1e-5); the CLI trains one epoch from the cache on the card. Under
the profiler the step's spans read positive device times that fit inside
the step's.

The VIPE* teacher (no hand kernel: cuBLAS linears and plain torch): its
train step at dropout 0 on cuda against the same step on the CPU with TF32
off (loss and BN running statistics at rtol 1e-5, parameters within 2.5 x
lr), `normalize_2d_batch_torch` on cuda against the numpy normalizer
(atol 1e-6), and no host sync inside a train step (dropout on, seeded).

The heads on frozen embeddings (no hand kernel: batched cuBLAS products in
an explicit time loop): a fused step of three recognition heads (input
batch norm, attention, a partial batch, dropout 0, one member not live) on
cuda against the CPU with TF32 off (losses and running statistics at rtol
1e-5, parameters within 2.5 x lr, the member that is not live unchanged),
no host sync inside a training epoch of the fused sweep (dropout on)
nor inside a proposal step, and the RNN's CUDA graphs training the
fused sweep to the same weights as eager launches.

Optical flow and the upload codec (cuDNN convolutions, batched products,
plain torch and the lookup kernel `csrc/corr_lookup.cu`): RAFT basic and
small in float32 on the card against the CPU with TF32 off (atol 1e-3,
the CPU parity bar, after 3 iterations), the yuv420 decode bit for bit
against the numpy reference, the flow quantization with median
subtraction against the numpy `flow_to_img`, and no host sync inside one
RAFT batch (bf16, the quantization included). The lookup kernel
(`ops/corr`) against its plain twin on the CPU at a relative L2 gap of at
most 1e-6 a query: at the flow cell's shapes (256 pairs, 16 x 16, radius
4), at radius 3, on a 64-px input's grid (levels down to 1 x 1),
on a 12 x 20 grid, and at coordinates on cells, on the edge and with
whole windows off the map (zeros); one launch a lookup, `iters` in a
RAFT forward; float64, bf16 and strided levels refused; the gradients
of the pyramid and the coordinates through the kernel's output against
the twin's, and RAFT small trained one step on the card (`train=True`,
`sequence_loss`) through the kernel against through the twin.

The EfficientNet student (no hand kernel: cuDNN depthwise and pointwise
convolutions): eval forward and one train step in float32 on cuda against
the CPU with TF32 off, on the same dropout masks (the train-step bars
above), and the bf16 step without a host sync.

The device mesh (`core/mesh.py`) as one card can run it, two gloo ranks
sharing the card (NCCL refuses two ranks on one GPU): the synced
BatchNorm against one process on the concatenated batch (float32, rtol
1e-5), and the student's step against one process on the same batch and
draws, TF32 off: in float32 the loss (rel 1e-5) and BN statistics (rtol
1e-4), in float64 each gradient before AdamW (within 1e-3 of its norm
plus 1e-6 of the whole's; in float32 any change in how BatchNorm's
statistics are summed, its code or the batch's split, moves a deep
ResNet's early conv gradients past that bar at random init). The epoch
metrics' sums over a one-rank NCCL group (NCCL takes no host tensor).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from vpd_tpu_torch.core.io import store_embs_pickle
from vpd_tpu_torch.data.augment import (sample_train_augment,
                                        train_augment_batch)
from vpd_tpu_torch.data import vipe_sampler as tvs
from vpd_tpu_torch.data import upload_codec as tcodec
from vpd_tpu_torch.data.crops import CropBatchSource
from vpd_tpu_torch.data.hbm_cache import CacheIndexSource, DeviceCropCache
from vpd_tpu_torch.data.shards import ShardReader, write_raw_shards
from vpd_tpu_torch.ops import _build
from vpd_tpu_torch.ops import augment as taug_op
from vpd_tpu_torch.ops import corr as tcorr
from vpd_tpu_torch.ops import dtw_kernel as tdtw
from vpd_tpu_torch.ops import preprocess as tpre
from vpd_tpu_torch.geometry import coco as tcoco
from vpd_tpu_torch.geometry.camera import random_project_offsets
from vpd_tpu_torch.models.fc import FlaxDropout, set_dropout_draw
from vpd_tpu_torch.ops.dtw import dtw_distance, pairwise_l2
from vpd_tpu_torch.models import gru as tgru
from vpd_tpu_torch.models import raft as traft
from vpd_tpu_torch.ops import flow as tflow
from vpd_tpu_torch.train import classifier as tcls
from vpd_tpu_torch.train import proposal as tprop
from vpd_tpu_torch.train import vipe as tvipe
from vpd_tpu_torch.train import vipe_loop as tvloop
from vpd_tpu_torch.train import vpd as tvpd
from vpd_tpu_torch.tools import train_vpd as tcli
from vpd_tpu_torch.train.vpd_loop import build_student, default_config

MEAN = (0.45, 0.47, 0.46)
STD = (0.13, 0.12, 0.12)
S = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip('the kernels are built for sm_90a')
    return torch.device('cuda')


def _f32(t):
    return t.cpu().to(torch.float32).numpy()


def _hold_to_twin(out, ref):
    """B1's bf16 output against its twin's: atol 0.02; the rgb channels
    bit for bit (so 3-channel outputs are equal); a differing element only
    in a flow channel and one bf16 step off (the twin divides by 255 where
    the kernel multiplies by 1/255), at most 0.2% of the elements from
    2^20 elements on (0.15% at the extraction shape; which byte values
    differ is fixed, so small shapes scatter around that share)."""
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=0.02)
    diff = out != ref
    assert not diff[..., :3].any()
    steps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    assert int(steps.max()) <= 1
    if out.numel() >= 1 << 20:
        assert int(diff.sum()) <= 0.002 * out.numel()


def _b1_inputs(rng, b, s, flow_c):
    rgb = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8))
    flow = (torch.from_numpy(rng.integers(0, 256, (b, s, s, flow_c),
                                          np.uint8)) if flow_c else None)
    flip = torch.from_numpy((rng.random(b) < 0.5).astype(np.int32))
    return rgb, flow, flip


def _on(device, *tensors):
    return [None if t is None else t.to(device) for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize('s,variant', [(32, 'vector'), (128, 'vector'),
                                       (20, 'general')])
@pytest.mark.parametrize('flow_c', [0, 2, 3, 4])
@pytest.mark.parametrize('b', [1, 13, 64])
def test_preprocess_kernel_matches_twin(cuda_device, b, flow_c, s, variant):
    """Both modes against the twin; W = 32 and 128 take the vector
    variant, W = 20 the general one."""
    rng = np.random.default_rng(b * 10 + flow_c + s)
    rgb, flow, flip = _b1_inputs(rng, b, s, flow_c)
    dev = _on(cuda_device, rgb, flow, flip)
    assert tpre.kernel_variant(dev[0], dev[1]) == variant

    before, ran = tpre.launches, dict(tpre.variant_launches)
    out = tpre.preprocess_crops(*dev, MEAN, STD)
    pair = tpre.preprocess_orig_and_flip(*dev[:2], MEAN, STD)
    torch.cuda.synchronize()
    assert tpre.launches == before + 2
    assert tpre.variant_launches[variant] == ran[variant] + 2
    assert out.dtype == pair.dtype == torch.bfloat16
    assert pair.shape == (2 * b, s, s, 5 if flow_c else 3)
    _hold_to_twin(out.cpu(), tpre.preprocess_crops_reference(
        rgb, flow, flip, MEAN, STD))
    _hold_to_twin(pair.cpu(), tpre.preprocess_orig_and_flip_reference(
        rgb, flow, MEAN, STD))


@pytest.mark.cuda
@pytest.mark.parametrize('view,s,variant', [
    ('drop_first', 7, 'general'), ('drop_first', 128, 'vector'),
    ('offset8', 128, 'general')])
def test_preprocess_kernel_offset_views(cuda_device, view, s, variant):
    """Contiguous views that start inside their buffer: x[1:] (at an odd
    H*W its data is not 16-byte aligned) and a view 8 bytes in. Held to
    the twin, and at S = 128 bit for bit to a fresh copy of the input,
    which takes the vector variant."""
    rng = np.random.default_rng(s)
    rgb, flow, flip = _on(cuda_device, *_b1_inputs(rng, 5, s, 3))
    if view == 'drop_first':
        rgb, flow, flip = rgb[1:], flow[1:], flip[1:]
    else:
        def shifted(x):
            buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
            return buf[8:].view(x.shape).copy_(x)
        rgb, flow = shifted(rgb), shifted(flow)
    assert rgb.is_contiguous() and tpre.kernel_variant(rgb, flow) == variant

    ran = dict(tpre.variant_launches)
    out = tpre.preprocess_crops(rgb, flow, flip, MEAN, STD)
    pair = tpre.preprocess_orig_and_flip(rgb, flow, MEAN, STD)
    torch.cuda.synchronize()
    assert tpre.variant_launches[variant] == ran[variant] + 2
    _hold_to_twin(out, tpre.preprocess_crops_reference(rgb, flow, flip,
                                                       MEAN, STD))
    _hold_to_twin(pair, tpre.preprocess_orig_and_flip_reference(
        rgb, flow, MEAN, STD))
    if s == 128:
        other = tpre.preprocess_orig_and_flip(rgb.clone(), flow.clone(),
                                              MEAN, STD)
        assert tpre.kernel_variant(rgb.clone(), flow.clone()) == 'vector'
        assert torch.equal(pair, other)


@pytest.mark.cuda
@pytest.mark.parametrize('source,builds', [('preprocess.cu', 6),
                                           ('dtw.cu', 12),
                                           ('train_augment.cu', 6),
                                           ('corr_lookup.cu', 2)])
def test_kernel_builds_do_not_spill(cuda_device, source, builds):
    """ptxas's report (`python -m vpd_tpu_torch.ops._build`): every build
    of B1 (4 vector, 2 general), B2, the input kernel (bf16, float32 or
    float64 output, 3 or 5 channels) and the lookup kernel (radius 3, 4)
    uses no local memory."""
    kernels = _build.ptxas_resources(_build.ptxas_report([source]))
    assert len(kernels) == builds, kernels
    for k in kernels:
        assert k['stack_bytes'] == k['spill_store_bytes'] == \
            k['spill_load_bytes'] == 0, k


@pytest.mark.cuda
def test_preprocess_kernel_rejects_other_output_types(cuda_device):
    rgb = torch.zeros((2, S, S, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match='bfloat16'):
        tpre.preprocess_orig_and_flip(rgb, None, MEAN, STD,
                                      out_dtype=torch.float32)


# --- the train step's input kernel -----------------------------------------

# name: (size, out size, flow, mask, jitter, per-sample order, int32 rows,
# row offset); rows index a cache of twice the batch
AUG_CASES = {
    'main': (128, 128, True, True, True, False, True, 0),
    'rgb_only': (128, 128, False, False, True, False, False, 0),
    'no_jitter': (128, 128, True, True, False, False, True, 0),
    'per_sample': (128, 128, True, True, True, True, True, 0),
    'smaller_out': (16, 12, True, True, True, False, False, 0),
    'row_offset': (32, 32, True, True, True, True, True, 1000),
}
AUG_B = 8


def bf16_steps(a, b):
    """Distance in bf16 steps between two bf16 tensors (ordered bits)."""
    def ordered(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)
    return (ordered(a) - ordered(b)).abs()


def _augment_case(case, noise_dtype, seed=0):
    """(streams, rows, row_offset, draws) on the CPU."""
    size, _, flow, mask, jitter, per_sample, with_rows, offset = \
        AUG_CASES[case]
    rng = np.random.default_rng(seed)
    n = 2 * AUG_B if with_rows else AUG_B
    streams = {'rgb': torch.from_numpy(rng.integers(0, 256, (n, size, size,
                                                             3), np.uint8)),
               'flow': torch.from_numpy(rng.integers(
                   0, 256, (n, size, size, 3), np.uint8)) if flow else None,
               'mask': torch.from_numpy(
                   ((rng.random((n, size, size)) > 0.5) * 255)
                   .astype(np.uint8)) if mask else None}
    rows = torch.from_numpy(rng.permutation(n)[:AUG_B] + offset).to(
        torch.int32) if with_rows else None
    gen = torch.Generator().manual_seed(seed + 1)
    draws = sample_train_augment(gen, torch.Generator().manual_seed(seed),
                                 AUG_B, size, size, jitter=jitter,
                                 per_sample_order=per_sample, mask=mask,
                                 flip=True, noise_dtype=noise_dtype)
    return streams, rows, offset, draws


def _gathered(streams, rows, offset):
    if rows is None:
        return streams
    idx = rows.long() - offset
    return {k: None if v is None else v[idx] for k, v in streams.items()}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize('case', sorted(AUG_CASES))
def test_train_augment_kernel_matches_twin(cuda_device, case, dtype):
    """The kernel against the CPU twin on the same rows and draws: float32
    at max abs 1e-5 (float64, computed in float64, at 1e-12); bf16 within 2
    bf16 steps of the float32 twin on 99.9% of the elements and no farther
    from it on the mean than the bf16 twin. The same inputs give the same
    bits twice, and from the cache's rows as from the gathered batch."""
    _, out_size, _, _, jitter, _, _, _ = AUG_CASES[case]
    streams, rows, offset, draws = _augment_case(case, dtype)
    mean, std = default_config('fs', 8)['rgb_mean_std']
    gpu = {k: None if v is None else v.to(cuda_device)
           for k, v in streams.items()}
    gdraws = {k: v.to(cuda_device) if torch.is_tensor(v) else v
              for k, v in draws.items()}
    grows = None if rows is None else rows.to(cuda_device)
    kw = dict(row_offset=offset, out_size=out_size, jitter=jitter,
              dtype=dtype)
    before = taug_op.launches
    out = taug_op.train_augment(gpu, gdraws, mean, std, rows=grows, **kw)
    again = taug_op.train_augment(gpu, gdraws, mean, std, rows=grows, **kw)
    torch.cuda.synchronize()
    assert taug_op.launches == before + 2
    assert out.dtype == dtype and out.shape == (
        AUG_B, out_size, out_size, 3 if streams['flow'] is None else 5)
    assert torch.equal(out, again)
    if rows is not None:
        gathered = taug_op.train_augment(
            {k: None if v is None else v.to(cuda_device) for k, v in
             _gathered(streams, rows, offset).items()}, gdraws, mean, std,
            **dict(kw, row_offset=0))
        assert torch.equal(out, gathered)

    src = _gathered(streams, rows, offset)

    def twin(dt):
        return train_augment_batch(src['rgb'], draws, mean, std,
                                   flow_u8=src['flow'], mask_u8=src['mask'],
                                   out_size=out_size, jitter=jitter,
                                   dtype=dt)

    ref = twin(torch.float32)
    out = out.cpu()
    if dtype == torch.float64:
        err = (out - twin(torch.float64)).abs().max().item()
        assert err <= 1e-12, err
    elif dtype == torch.float32:
        err = (out - ref).abs().max().item()
        assert err <= 1e-5, err
    else:
        steps = bf16_steps(out, ref.to(torch.bfloat16))
        share = (steps <= 2).float().mean().item()
        assert share >= 0.999, (share, steps.max().item())
        ours = (out.float() - ref).abs().mean().item()
        theirs = (twin(torch.bfloat16).float() - ref).abs().mean().item()
        assert ours <= theirs, (ours, theirs)


# --- kernel B2: all-pairs DTW ----------------------------------------------

def _dtw_inputs(rng, n_q, n_t, L, D, lo=5):
    """Zero-padded sequences with random lengths in [lo, L]; the first
    query is short against a long first target (slope-infeasible under
    symmetricP2)."""
    ql = rng.integers(lo, L + 1, n_q).astype(np.int32)
    tl = rng.integers(lo, L + 1, n_t).astype(np.int32)
    ql[0], tl[0] = min(lo, L), L
    q = np.zeros((n_q, L, D), np.float32)
    t = np.zeros((n_t, L, D), np.float32)
    for i, n in enumerate(ql):
        q[i, :n] = rng.normal(size=(n, D))
    for i, n in enumerate(tl):
        t[i, :n] = rng.normal(size=(n, D))
    return [torch.from_numpy(x) for x in (q, ql, t, tl)]


# lengths on the kernel's tile edges: 8 query rows and 16 target columns
# per tensor-core tile, 32 lanes, 128-row target chunks
EDGE_LENS = (1, 2, 3, 15, 16, 17, 127, 128, 129, 255, 256, 257, 511, 512)


def _edge_inputs(rng, L, D):
    """Every pair of lengths from EDGE_LENS up to L, random rows."""
    lens = np.array([n for n in EDGE_LENS if n <= L], np.int32)
    x = np.zeros((len(lens), L, D), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, D))
    y = np.zeros_like(x)
    for i, n in enumerate(lens):
        y[i, :n] = rng.normal(size=(n, D))
    return [torch.from_numpy(a) for a in (x, lens, y, lens.copy())]


@pytest.mark.cuda
@pytest.mark.parametrize('step_pattern', ['symmetricP2', 'symmetric2'])
@pytest.mark.parametrize('L,D,edge', [
    (32, 32, False), (128, 32, False), (128, 128, False), (512, 32, False),
    (512, 128, False), (128, 1, True), (128, 7, True), (128, 20, True),
    (128, 32, True), (128, 64, True), (128, 128, True), (512, 20, True)])
def test_dtw_kernel_matches_twin(cuda_device, step_pattern, L, D, edge):
    rng = np.random.default_rng(L + D)
    args = (_edge_inputs(rng, L, D) if edge
            else _dtw_inputs(rng, 11, 13, L, D))
    dev = [a.to(cuda_device) for a in args]
    before = tdtw.launches
    out = tdtw.dtw_matrix(*dev, step_pattern=step_pattern)
    torch.cuda.synchronize()
    assert tdtw.launches == before + 1
    ref = tdtw.dtw_matrix_reference(*dev, step_pattern=step_pattern)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert out.shape == (len(args[1]), len(args[3]))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    if step_pattern == 'symmetricP2' and not edge:
        assert np.isinf(out[0, 0])
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('step_pattern', ['symmetricP2', 'symmetric2'])
def test_dtw_kernel_matches_host_dp(cuda_device, step_pattern):
    """Against the f64 host DP, from a 6 x 9 pair up, at the bar of the
    JAX kernel's own test (rtol 5e-3)."""
    rng = np.random.default_rng(7)
    lens = [(6, 9), (9, 6), (2, 2), (1, 1), (3, 7), (40, 33), (150, 97)]
    L, D = 160, 16
    q = np.zeros((len(lens), L, D), np.float32)
    t = np.zeros((len(lens), L, D), np.float32)
    seqs = []
    for i, (n, m) in enumerate(lens):
        a, b = rng.normal(size=(n, D)), rng.normal(size=(m, D))
        q[i, :n], t[i, :m] = a, b
        seqs.append((q[i, :n], t[i, :m]))
    out = tdtw.dtw_matrix(
        torch.from_numpy(q).to(cuda_device),
        torch.tensor([n for n, _ in lens], dtype=torch.int32,
                     device=cuda_device),
        torch.from_numpy(t).to(cuda_device),
        torch.tensor([m for _, m in lens], dtype=torch.int32,
                     device=cuda_device), step_pattern).cpu().numpy()
    for i, (a, _) in enumerate(seqs):
        for j, (_, b) in enumerate(seqs):
            want = dtw_distance(pairwise_l2(a, b), step_pattern)
            if np.isinf(want):
                assert np.isinf(out[i, j]), (i, j)
            else:
                np.testing.assert_allclose(out[i, j], want, rtol=5e-3)


@pytest.mark.cuda
def test_dtw_kernel_rejects_out_of_range(cuda_device):
    def call(L, D, lens=None):
        x = torch.zeros((2, L, D), device=cuda_device)
        n = torch.full((2,), L if lens is None else lens, dtype=torch.int32,
                       device=cuda_device)
        return tdtw.dtw_matrix(x, n, x, n)

    with pytest.raises(ValueError, match='L = 513'):
        call(513, 4)
    with pytest.raises(ValueError, match='D = 129'):
        call(16, 129)
    with pytest.raises(ValueError, match='q_lens'):
        call(16, 4, lens=17)
    with pytest.raises(ValueError, match='float32'):
        x = torch.zeros((2, 8, 4), device=cuda_device, dtype=torch.float64)
        n = torch.full((2,), 8, dtype=torch.int32, device=cuda_device)
        tdtw.dtw_matrix(x, n, x, n)


@pytest.mark.cuda
@pytest.mark.parametrize('step_pattern', ['symmetricP2', 'symmetric2'])
def test_dtw_kernel_identical_sequences(cuda_device, step_pattern):
    """q = t, as on the retrieval sweep's diagonal: lengths 75-100, D = 64,
    against the f64 host DP, whose diagonal is 0. In float32 the matmul
    form of the cost cancels there and would leave about
    sqrt(eps32 (|q|^2 + |t|^2)) ~ 5e-3 a cell; the kernel sums such cells
    as (q - t)^2, so the diagonal is held at 1e-5 absolute (the f64 DP's
    own residual is below 1e-6). Off the diagonal, rtol 5e-3."""
    rng = np.random.default_rng(3)
    L, D = 100, 64
    lens = rng.integers(75, L + 1, 10).astype(np.int32)
    x = np.zeros((len(lens), L, D), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, D))
    xd = torch.from_numpy(x).to(cuda_device)
    ld = torch.from_numpy(lens).to(cuda_device)
    out = tdtw.dtw_matrix(xd, ld, xd, ld, step_pattern).cpu().numpy()
    for i, n in enumerate(lens):
        for j, m in enumerate(lens):
            want = dtw_distance(pairwise_l2(x[i, :n], x[j, :m]),
                                step_pattern)
            if i == j:
                assert abs(out[i, j] - want) <= 1e-5, (i, out[i, j], want)
            elif np.isinf(want):
                assert np.isinf(out[i, j]), (i, j)
            else:
                np.testing.assert_allclose(out[i, j], want, rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('step_pattern', ['symmetricP2', 'symmetric2'])
@pytest.mark.parametrize('L,D,warps', [(128, 32, 20), (128, 64, 16),
                                       (512, 128, 1)])
def test_dtw_kernel_info(cuda_device, step_pattern, L, D, warps):
    """The launch's resources: no register spills, and at the main path's
    shapes (L <= 128) more warps resident per SM than the 16 of the
    shared-memory recurrence at D = 32."""
    info = tdtw.kernel_info(L, D, step_pattern)
    assert info['local_bytes'] == 0, info
    assert info['resident_warps_per_sm'] >= warps, info


def _train_batch(rng, b, s, emb):
    return {'rgb': torch.from_numpy(rng.integers(0, 256, (b, s, s, 3),
                                                 np.uint8)),
            'flow': torch.from_numpy(rng.integers(0, 256, (b, s, s, 3),
                                                  np.uint8)),
            'mask': torch.from_numpy(((rng.random((b, s, s)) > 0.5) * 255)
                                     .astype(np.uint8)),
            'emb': torch.from_numpy(rng.normal(size=(b, 2 * emb))
                                    .astype(np.float32)),
            'flip': torch.from_numpy(rng.random(b) < 0.5)}


@pytest.mark.cuda
def test_train_step_matches_cpu(cuda_device):
    lr, emb = 1e-3, 8
    cfg = default_config('fs', emb, img_dim=S, use_flow=True, motion=True,
                         encoder_arch='resnet18')
    torch.manual_seed(0)
    cpu_model = build_student(cfg, dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    batch = _train_batch(np.random.default_rng(0), 8, S, emb)
    draws = sample_train_augment(torch.Generator().manual_seed(1),
                                 torch.Generator().manual_seed(1), 8, S, S)
    draws['flip'] = batch['flip']
    mean, std = cfg['rgb_mean_std']

    def augment(b, d):
        return train_augment_batch(b['rgb'], d, mean, std, flow_u8=b['flow'],
                                   mask_u8=b['mask'], out_size=S)

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        imgs = augment(batch, draws)
        gbatch = {k: v.to(cuda_device) for k, v in batch.items()}
        before = taug_op.launches
        gimgs = taug_op.train_augment(
            gbatch, {k: v.to(cuda_device) if torch.is_tensor(v) else v
                     for k, v in draws.items()}, mean, std, out_size=S)
        assert taug_op.launches == before + 1
        np.testing.assert_allclose(gimgs.cpu().numpy(), imgs.numpy(),
                                   atol=1e-5)
        cpu_state = tvpd.create_state(cpu_model, lr)
        gpu_state = tvpd.create_state(gpu_model, lr)
        m_cpu = tvpd.apply_train_update(cpu_state, imgs, batch['emb'])
        m_gpu = tvpd.apply_train_update(gpu_state, gimgs, gbatch['emb'])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    np.testing.assert_allclose(float(m_gpu['emb_loss_sum']),
                               float(m_cpu['emb_loss_sum']), rtol=1e-4)
    gpu_sd = gpu_model.state_dict()
    for name, t in cpu_model.state_dict().items():
        got = gpu_sd[name].cpu()
        if 'running' in name:
            np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        elif not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(got.numpy(), t.numpy(),
                                       atol=2.5 * lr, err_msg=name)


@pytest.mark.cuda
def test_bf16_train_step_on_card(cuda_device):
    """bf16 compute over float32 master weights, channels_last, fused
    AdamW: no host sync inside a step (after the first, which makes the
    step's constants), and the loss falls over 8 steps on one batch."""
    emb = 8
    cfg = default_config('fs', emb, img_dim=S, use_flow=True, motion=True,
                         encoder_arch='resnet18')
    torch.manual_seed(0)
    model = build_student(cfg, dtype=torch.bfloat16,
                          param_dtype=torch.float32).to(cuda_device)
    model.to(memory_format=torch.channels_last)
    state = tvpd.create_state(model, 1e-3)
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], img_dim=S,
                                use_flow=True, aug_dtype=torch.bfloat16)
    batch = {k: v.to(cuda_device) for k, v in _train_batch(
        np.random.default_rng(1), 16, S, emb).items()}
    losses = [step(state, batch, 0)['emb_loss_sum']]
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(7):
            losses.append(step(state, batch, 0)['emb_loss_sum'])
    finally:
        torch.cuda.set_sync_debug_mode('default')
    losses = torch.stack(losses).tolist()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.encoder.compute_dtype == torch.bfloat16
    assert state.step == 8

    # AdamW's state through the checkpoint layout and back: the moments
    # take the channels_last parameters' strides, as the fused step needs
    tree = tvpd.optimizer_to_flax(state)
    fresh = tvpd.create_state(model, 1e-3)
    tvpd.load_optimizer_from_flax(fresh, tree)
    assert fresh.step == 8
    for p in model.parameters():
        for key in ('exp_avg', 'exp_avg_sq'):
            got = fresh.optimizer.state[p][key]
            assert got.stride() == p.stride(), key
            assert torch.equal(got, state.optimizer.state[p][key])
    step(fresh, batch, 0)
    assert fresh.step == 9


def _cache_corpus(root, n_videos=2, n_frames=24, emb=8, rows_per_shard=10):
    """Teacher .emb.pkl files ((2, emb) rows) and raw shards with rgb,
    flow and masks of their crops: (emb_dir, shard_dir, crop_dir)."""
    rng = np.random.default_rng(0)
    emb_dir = os.path.join(root, 'embs')
    os.makedirs(emb_dir)
    keys = []
    for v in range(n_videos):
        store_embs_pickle(
            os.path.join(emb_dir, 'video{}.emb.pkl'.format(v)),
            [(f, rng.normal(size=(2, emb)).astype(np.float32),
              {'dp_score': 0.9}) for f in range(n_frames)])
        keys += ['video{}/{}'.format(v, f) for f in range(n_frames)]
    n = len(keys)
    shard_dir = os.path.join(root, 'shards')
    write_raw_shards(
        shard_dir, keys, rng.integers(0, 256, (n, S, S, 3), np.uint8),
        flow=rng.integers(0, 256, (n, S, S, 3), np.uint8),
        flow_img_name='flow',
        mask=((rng.random((n, S, S)) > 0.5) * 255).astype(np.uint8),
        rows_per_shard=rows_per_shard)
    return emb_dir, shard_dir, os.path.join(root, 'crops')


def _samples(emb=8):
    """(video, None, frame, (2, 2 emb) targets) of `_cache_corpus`'s
    crops."""
    rng = np.random.default_rng(1)
    return [('video{}'.format(v), None, f,
             rng.normal(size=(2, 2 * emb)).astype(np.float32))
            for v in range(2) for f in range(24)]


@pytest.mark.cuda
def test_device_cache_on_card_holds_the_shards(cuda_device, tmp_path):
    _, shard_dir, crop_dir = _cache_corpus(str(tmp_path))
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cache = DeviceCropCache(reader, use_flow=True, device=cuda_device,
                            log=lambda *a: None)
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= cache.nbytes + max(s.nbytes for s in reader._rgb), peak
    streams = {'rgb': reader._rgb, 'flow': reader._flow,
               'mask': reader._mask}
    assert sorted(cache.arrays) == ['flow', 'mask', 'rgb']
    for k, t in cache.arrays.items():
        assert t.is_cuda and t.dtype == torch.uint8
        np.testing.assert_array_equal(t.cpu().numpy(),
                                      np.concatenate(streams[k]), err_msg=k)


def _cached_and_streamed(cuda_device, tmp_path, b=16):
    """A cache on the card, and the streamed and index sources over the
    same shards with the same seed."""
    _, shard_dir, crop_dir = _cache_corpus(str(tmp_path))
    cache = DeviceCropCache(ShardReader(shard_dir, crop_root=crop_dir),
                            use_flow=True, device=cuda_device,
                            log=lambda *a: None)
    samples = _samples()
    kw = dict(target_len=4 * b, flow_img_name='flow', seed=3)
    return (cache,
            CropBatchSource(samples, crop_dir, S, b, shard_dir=shard_dir,
                            use_native=False, **kw),
            CacheIndexSource(samples, crop_dir, S, b, cache=cache, **kw))


def _student(cuda_device, emb=8):
    cfg = default_config('fs', emb, img_dim=S, use_flow=True, motion=True,
                         encoder_arch='resnet18')
    torch.manual_seed(0)
    model = build_student(cfg, dtype=torch.bfloat16,
                          param_dtype=torch.float32).to(cuda_device)
    model.to(memory_format=torch.channels_last)
    return cfg, model


@pytest.mark.cuda
def test_cached_step_equals_streamed_step_on_card(cuda_device, tmp_path):
    cache, streamed, indexed = _cached_and_streamed(cuda_device, tmp_path)
    cfg, model = _student(cuda_device)
    twin = copy.deepcopy(model)
    kw = dict(img_dim=S, use_flow=True, aug_dtype=torch.bfloat16)
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], **kw)
    cached = tvpd.make_cached_train_step(*cfg['rgb_mean_std'], **kw)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        states = (tvpd.create_state(model, 1e-3),
                  tvpd.create_state(twin, 1e-3))
        batch = {k: torch.from_numpy(v).to(cuda_device)
                 for k, v in streamed.next_batch().items()}
        ibatch = {k: torch.from_numpy(v).to(cuda_device)
                  for k, v in indexed.next_batch().items()}
        a = float(step(states[0], batch, 5)['emb_loss_sum'])
        b = float(cached(states[1], ibatch, 5, cache.arrays)['emb_loss_sum'])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    assert abs(a - b) <= 1e-6 * abs(a), (a, b)
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        rel = ((p - q).abs().max() / p.abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-5, (name, rel)


@pytest.mark.cuda
def test_cached_and_streamed_steps_augment_alike_in_one_launch(cuda_device,
                                                                tmp_path):
    """The cached step's input (cache rows read in place) and the streamed
    step's (the gathered batch) are the same bits; each step launches the
    input kernel once."""
    cache, streamed, indexed = _cached_and_streamed(cuda_device, tmp_path)
    cfg, model = _student(cuda_device)
    mean, std = cfg['rgb_mean_std']
    augment = tvpd._make_augment(tvpd._Constants(mean, std), S, True, True,
                                 torch.bfloat16, 'batch')
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in streamed.next_batch().items()}
    ibatch = {k: torch.from_numpy(v).to(cuda_device)
              for k, v in indexed.next_batch().items()}
    a = augment(batch, 5, 0)
    b = augment({**cache.arrays, 'flip': ibatch['flip']}, 5, 0,
                rows=ibatch['idx'])
    assert torch.equal(a, b)

    kw = dict(img_dim=S, use_flow=True, aug_dtype=torch.bfloat16)
    state = tvpd.create_state(model, 1e-3)
    before = taug_op.launches
    tvpd.make_train_step(mean, std, **kw)(state, batch, 5)
    assert taug_op.launches == before + 1
    tvpd.make_cached_train_step(mean, std, **kw)(state, ibatch, 5,
                                                 cache.arrays)
    assert taug_op.launches == before + 2


@pytest.mark.cuda
def test_cached_step_makes_no_host_sync(cuda_device, tmp_path):
    cache, _, indexed = _cached_and_streamed(cuda_device, tmp_path)
    cfg, model = _student(cuda_device)
    state = tvpd.create_state(model, 1e-3)
    step = tvpd.make_cached_train_step(*cfg['rgb_mean_std'], img_dim=S,
                                       use_flow=True,
                                       aug_dtype=torch.bfloat16)
    batches = [{k: torch.from_numpy(v).to(cuda_device)
                for k, v in indexed.next_batch().items()} for _ in range(4)]
    losses = [step(state, batches[0], 0, cache.arrays)['emb_loss_sum']]
    torch.cuda.set_sync_debug_mode('error')
    try:
        for batch in batches[1:]:
            losses.append(step(state, batch, 0, cache.arrays)['emb_loss_sum'])
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert np.isfinite(torch.stack(losses).tolist()).all()
    assert state.step == 4


@pytest.mark.cuda
def test_step_spans_time_the_stages_on_card(cuda_device, tmp_path):
    """Under the profiler the cached step's input, fwd_bwd and adamw spans
    read positive device ms that together fit inside the step's own."""
    from torch.profiler import ProfilerActivity, profile

    from vpd_tpu_torch.core import profiling

    cache, _, indexed = _cached_and_streamed(cuda_device, tmp_path)
    cfg, model = _student(cuda_device)
    state = tvpd.create_state(model, 1e-3)
    step = tvpd.make_cached_train_step(*cfg['rgb_mean_std'], img_dim=S,
                                       use_flow=True,
                                       aug_dtype=torch.bfloat16)
    batches = [{k: torch.from_numpy(v).to(cuda_device)
                for k, v in indexed.next_batch().items()} for _ in range(4)]
    step(state, batches[0], 0, cache.arrays)
    torch.cuda.synchronize()
    profiling.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for batch in batches[1:]:
                with profiling.span('test.step', cuda_device):
                    step(state, batch, 0, cache.arrays)
            torch.cuda.synchronize()
        records, dropped = profiling.span_records()
    finally:
        profiling.clear_spans()
    steps = [r for r in records if r['name'] == 'test.step']
    assert len(steps) == 3 and dropped == 0
    for s, want in zip(steps, (1, 2, 3)):
        inner = [r for r in records if r['parent'] == s['id']]
        assert [(r['name'], r['ids']) for r in inner] == [
            (name, {'step': want}) for name in (
                'vpd.train.input', 'vpd.train.fwd_bwd', 'vpd.train.adamw')]
        assert all(r['device_ms'] > 0 for r in inner), inner
        assert sum(r['device_ms'] for r in inner) <= s['device_ms'] + 1e-3


@pytest.mark.cuda
def test_cli_trains_from_the_cache_on_card(cuda_device, tmp_path,
                                           monkeypatch):
    emb_dir, shard_dir, crop_dir = _cache_corpus(str(tmp_path))
    monkeypatch.setitem(tcli.CROP_DIRS, 'fs', crop_dir)
    monkeypatch.setattr(tcli, 'TRAIN_LEN', 32)
    monkeypatch.setattr(tcli, 'VAL_LEN', 16)
    save = str(tmp_path / 'run')
    trainer = tcli.main(
        dataset='fs', save_dir=save, checkpoint_frequency=1, num_epochs=1,
        batch_size=8, learning_rate=5e-4, img_dim=S, flow_img='flow',
        motion=True, encoder_arch='resnet18', model_select_window=5,
        pretrained=False, no_test_video=False, min_pose_score=None,
        emb_dir=emb_dir, seed=0, crop_shards=shard_dir, hbm_cache=True)
    assert trainer.cache is not None and trainer.cache['rgb'].is_cuda
    assert trainer.state.step == 4
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    assert np.isfinite([losses[0]['train'], losses[0]['val']]).all()
    assert os.path.exists(os.path.join(save, 'epoch0001.optimizer.ckpt'))


# ------------------------------------------------------ the VIPE* teacher

def _teacher_batcher(batch_size, seed=0):
    """A FusedBatcher over three synthetic mocap families (3 sequences x 8
    frames x 2 cameras of random bones and synthetic projections)."""
    rng = np.random.default_rng(seed)
    samplers = []
    for i, fam in enumerate(('human36m', 'nba2k', 'amass')):
        spec = tvs.FAMILIES[fam].spec
        seqs, poses = [], {}
        for p in range(3):
            key = ('p{}'.format(p), 'a')
            dirs = rng.normal(size=(8, spec.num_edges, 3))
            offsets = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) \
                * rng.uniform(0.1, 0.3, (8, spec.num_edges, 1))
            poses[key] = [(np.zeros(3), 0., o.astype(np.float32))
                          for o in offsets]
            nums = [25 * f if fam == 'amass' else f for f in range(8)]
            seqs.append((key, [(n, [('c{}'.format(c), random_project_offsets(
                spec, offsets[f], rng)) for c in range(2)])
                for f, n in enumerate(nums)]))
        samplers.append(tvs.VIPESampler(tvs.FAMILIES[fam], seqs, poses,
                                        target_len=64, seed=seed + i))
    return tvs.FusedBatcher(samplers, batch_size)


def _teacher(batcher):
    cfg = tvloop.default_config(['a', 'b', 'c'], [None] * 3, [None] * 3,
                                embedding_dim=8, encoder_arch=(2, 64),
                                decoder_arch=(2, 32))
    torch.manual_seed(0)
    return tvloop.build_model(cfg, batcher.kp_dims)


@pytest.mark.cuda
def test_teacher_train_step_matches_cpu(cuda_device):
    lr = 1e-3
    batcher = _teacher_batcher(32)
    cpu_model = _teacher(batcher)
    for m in cpu_model.modules():
        if isinstance(m, FlaxDropout):
            m.rate = 0.
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    batch = {k: torch.from_numpy(v) for k, v in batcher.next_batch().items()}
    step = tvipe.make_train_step(batcher.kp_mask())
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m_cpu = step(tvpd.create_state(cpu_model, lr), batch, 1)
        m_gpu = step(tvpd.create_state(gpu_model, lr),
                     {k: v.to(cuda_device) for k, v in batch.items()}, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for k in ('loss_sum', 'contra_sum', 'ds_loss_sum'):
        np.testing.assert_allclose(m_gpu[k].cpu().numpy(),
                                   m_cpu[k].numpy(), rtol=1e-5, err_msg=k)
    assert torch.equal(m_gpu['ds_count'].cpu(), m_cpu['ds_count'])
    gpu_sd = gpu_model.state_dict()
    for name, t in cpu_model.state_dict().items():
        got = gpu_sd[name].cpu()
        if 'running' in name:
            np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        elif not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(got.numpy(), t.numpy(),
                                       atol=2.5 * lr, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('zero_confs,bones', [(False, False), (True, True)])
def test_pose_normalizer_on_card(cuda_device, zero_confs, bones):
    rng = np.random.default_rng(3)
    kps = rng.uniform(0, 200, (1000, 17, 3)).astype(np.float32)
    kps[5, [5, 6, 11, 12], :2] = 4.  # zero torso distance
    flips = rng.random(1000) < 0.5
    got = tcoco.normalize_2d_batch_torch(
        torch.from_numpy(kps).to(cuda_device),
        torch.from_numpy(flips).to(cuda_device), zero_confs, bones)
    assert got.is_cuda
    np.testing.assert_allclose(
        got.cpu().numpy(), tcoco.normalize_2d_skeleton_batch(
            kps, flips, zero_confs, bones), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_teacher_step_makes_no_host_sync(cuda_device):
    """Dropout on (seeded masks), fused AdamW: after the first step, which
    makes the step's constants, no step syncs; the loss falls on one
    batch."""
    batcher = _teacher_batcher(64)
    model = _teacher(batcher).to(cuda_device)
    state = tvpd.create_state(model, 1e-3)
    step = tvipe.make_train_step(batcher.kp_mask())
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in batcher.next_batch().items()}
    metrics = [step(state, batch, 1)]
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(7):
            metrics.append(step(state, batch, 1))
    finally:
        torch.cuda.set_sync_debug_mode('default')
    losses = torch.stack([m['loss_sum'] for m in metrics]).tolist()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert state.step == 8


# ------------------------------------------- the heads on frozen embeddings

def _head_batch(m, b=16, t=32, d=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, t + 1, (m, b), generator=gen)
    x = torch.randn(m, b, t, d, generator=gen) * (
        torch.arange(t)[None, None, :, None] < lens[..., None, None])
    y = torch.randint(0, 3, (m, b), generator=gen)
    valid = torch.arange(b)[None].expand(m, -1) < b - 5
    return x, lens, y, valid


@pytest.mark.cuda
def test_head_train_step_matches_cpu(cuda_device):
    lr = 1e-3
    cpu = tcls.make_model('gru', 8, 3, 16, num_members=3, use_attention=True,
                          input_batchnorm=True, dropout=0., input_dropout=0.)
    card = copy.deepcopy(cpu).to(cuda_device)
    batch = _head_batch(3)
    scalars = torch.tensor([[lr] * 3, [0.01] * 3, [0.1] * 3, [1e-3] * 3,
                            [1., 0., 1.]])
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for name, model in (('cpu', cpu), ('cuda', card)):
            dev = next(model.parameters()).device
            out[name] = tcls.train_step(
                model, tcls.StackedAdamW(model.parameters()),
                *[t.to(dev) for t in batch], scalars.to(dev))[0].cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_allclose(out['cuda'].numpy(), out['cpu'].numpy(),
                               rtol=1e-5)
    gpu_sd = card.state_dict()
    for name, t in cpu.state_dict().items():
        got = gpu_sd[name].cpu()
        assert torch.equal(got[1], before[name][1]), name  # not live
        if 'running' in name:
            np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        else:
            # AdamW's first step moves a parameter by about lr
            np.testing.assert_allclose(got.numpy(), t.numpy(),
                                       atol=0.2 * lr, err_msg=name)


@pytest.mark.cuda
def test_head_epoch_makes_no_host_sync(cuda_device):
    """The fused sweep's epoch (3 members, dropout on): after a first
    epoch, which makes the step's tensors, an epoch reads nothing back
    until its metrics; so does a proposal step."""
    x, lens, y, _ = _head_batch(1, b=64)
    pool = (x[0].to(cuda_device), lens[0].to(cuda_device),
            y[0].to(cuda_device))
    model = tcls.make_model('gru', 8, 3, 16, num_members=3).to(cuda_device)
    ep = tcls._Epochs(model, cuda_device, pool,
                      [np.arange(64), np.arange(40), np.arange(20, 64)], 16,
                      10, 2, 1e-3, 0)
    ep.run_epoch()
    torch.cuda.set_sync_debug_mode('error')
    try:
        sums = ep.device_epoch()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert np.isfinite(sums.cpu().numpy()).all()
    assert list(ep.count) == [8, 6, 6]

    prop = tprop.ProposalSeq('gru', 8, 16, num_members=2).to(cuda_device)
    opt = tcls.StackedAdamW(prop.parameters())
    gens = [torch.Generator(device=cuda_device).manual_seed(i)
            for i in range(2)]
    set_dropout_draw(prop.train(), tgru.member_dropout_draw(gens))
    xb = torch.randn(2, 8, 32, 8, device=cuda_device)
    yb = (torch.rand(2, 8, 32, device=cuda_device) < 0.3).long()
    lengths = torch.full((2, 8), 32, device=cuda_device)
    one = torch.ones(2, device=cuda_device)
    step = lambda: tprop.proposal_step(  # noqa: E731
        prop, opt, xb, lengths, yb, 1e-3 * one, 0.01 * one,
        torch.stack([0.1 * one, 1e-3 * one]), one > 0)
    step()
    torch.cuda.set_sync_debug_mode('error')
    try:
        losses = [step()[0] for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert np.isfinite(torch.stack(losses).cpu().numpy()).all()


@pytest.mark.cuda
def test_head_cuda_graphs_train_as_eager(cuda_device):
    """Two epochs of a 3-member sweep (input batch norm, dropout on):
    `train_members`, whose RNN runs in CUDA graphs, against the same
    epochs run eager, from the same weights: the same arithmetic, so the
    same weights up to float32 rounding. The model leaves training with
    its RNN's own forward."""
    x, lens, y, _ = _head_batch(1, b=64)
    pool = (x[0].to(cuda_device), lens[0].to(cuda_device),
            y[0].to(cuda_device))
    rows = [np.arange(64), np.arange(40), np.arange(20, 64)]
    base = tcls.make_model('gru', 8, 3, 16, num_members=3,
                           input_batchnorm=True).to(cuda_device)
    graphed, eager = copy.deepcopy(base), copy.deepcopy(base)
    tcls.train_members(graphed, cuda_device, pool, rows, batch_size=16,
                       num_epochs=2, min_epochs=0, wr_count=1)
    assert 'forward' not in vars(graphed.rnn)
    # train_members' two epochs without validation, as it runs them
    ep = tcls._Epochs(eager, cuda_device, pool, rows, 16, 2, 1, 1e-3, 0)
    ep.run_epoch()
    ep.run_epoch()
    states = [{k: v.cpu() for k, v in model.state_dict().items()}
              for model in (graphed, eager)]
    for k, v in states[1].items():
        np.testing.assert_allclose(states[0][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.cuda
def test_sequential_ensemble_matches_fused_on_card(cuda_device):
    """`--sequential_ensemble -k 3` on the card: its three KFold members,
    each trained alone with its RNN in CUDA graphs, stacked into one
    model, give the fused ensemble's weights and scores (float64, TF32
    off; tests/test_fused_sweep.py's bar)."""
    rng = np.random.default_rng(11)
    X, y = [], []
    for _ in range(6):
        x = rng.normal(0, 0.3, (120, 6)).astype(np.float32)
        vy = np.zeros(120, np.int32)
        for start in range(20, 100, 50):
            x[start:start + 10] += 2.0
            vy[start:start + 10] = 1
        X.append(x)
        y.append(vy)
    kw = dict(hidden_dim=8, ensemble_size=3, splits=3, seed=5,
              batch_size=8, num_epochs=3, min_epochs=1, seq_len=32,
              samples_per_epoch=32, device=cuda_device, dtype=torch.float64)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        seq = tprop.EnsembleProposal('gru', X, y, fused=False, **kw)
        fused = tprop.EnsembleProposal('gru', X, y, fused=True, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    a, b = fused.model.state_dict(), seq.model.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k].cpu().numpy(), b[k].cpu().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(fused.predict_n(X[0], X[1]),
                               seq.predict_n(X[0], X[1]), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.cuda
def test_proposal_ensembles_capture_again_and_again(cuda_device):
    """bench_ensemble_train's sequence in one process: fused, sequential,
    fused, sequential ensembles of 3 members (12 graph captures). With
    the cyclic collector free to run during a capture, the warm round's
    first sequential capture failed on the H100 every time at one epoch
    (ROADMAP C6); `graphed_rnn` now pauses it."""
    from vpd_tpu_torch.tools.bench_ensemble_train import _synth_videos

    X, y = _synth_videos(np.random.default_rng(0))
    kw = dict(hidden_dim=128, ensemble_size=3, splits=5, num_epochs=1,
              min_epochs=1, early_term_no_val_improvement=1,
              samples_per_epoch=1000, batch_size=100, seq_len=250,
              device=cuda_device)
    for seed, fused in ((0, True), (0, False), (1, True), (1, False)):
        ens = tprop.EnsembleProposal('gru', X, y, fused=fused, seed=seed,
                                     **kw)
        assert np.isfinite(np.asarray(ens.predict(X[0]))).all()


# ----------------------------------------------- optical flow and codec

def _flow_pairs(b, size, seed=0):
    rng = np.random.default_rng(seed)
    im1 = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    im2 = np.roll(im1, 2, axis=2)
    return torch.from_numpy(im1), torch.from_numpy(im2)


@pytest.mark.cuda
@pytest.mark.parametrize('small', [False, True])
def test_raft_f32_on_card_matches_cpu(cuda_device, small):
    model = traft.build_raft(small=small, seed=1)
    im1, im2 = _flow_pairs(2, 128)
    with torch.no_grad():
        ref = model(im1, im2, iters=3).numpy()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = model.to(cuda_device)(im1.to(cuda_device),
                                        im2.to(cuda_device), iters=3)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.is_cuda and got.shape == (2, 128, 128, 2)
    np.testing.assert_allclose(got.cpu().numpy(), ref, atol=1e-3)


@pytest.mark.cuda
def test_yuv420_decode_bit_equal_on_card(cuda_device):
    rng = np.random.default_rng(3)
    encoded = tcodec.encode_yuv420_numpy(
        rng.integers(0, 256, (32, 128, 128, 3), np.uint8))
    arbitrary = rng.integers(0, 256, encoded.shape, np.uint8)
    for packed in (encoded, arbitrary):
        got = tcodec.decode_yuv420(torch.from_numpy(packed).to(cuda_device),
                                   128, 128)
        assert got.is_cuda and got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            tcodec.decode_yuv420_reference(packed, 128, 128))


@pytest.mark.cuda
def test_flow_quantization_on_card_matches_numpy(cuda_device):
    flow = np.random.default_rng(4).normal(
        scale=12., size=(8, 128, 128, 2)).astype(np.float32)
    for median in (False, True):
        got = tflow.quantize_flow_device(
            torch.from_numpy(flow).to(cuda_device), subtract_median=median)
        want = np.stack([tflow.flow_to_img(
            tflow.subtract_median(f) if median else f)[..., :2]
            for f in flow])
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_raft_batch_makes_no_host_sync(cuda_device):
    model = traft.build_raft().to(cuda_device)
    qfn = tflow.make_quantized_flow_fn(
        traft.raft_flow_fn(model, iters=4, dtype=torch.bfloat16),
        subtract_median=True)
    im1, im2 = (t.to(cuda_device) for t in _flow_pairs(4, 128))
    qfn(im1, im2)  # first call: cuDNN plans, allocator
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = qfn(im1, im2)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert out.dtype == torch.uint8 and out.shape == (4, 128, 128, 2)


# --- RAFT's correlation lookup kernel --------------------------------------

# name: (pairs, grid H, grid W, radius); the cell's chunk is 256 pairs on a
# 16 x 16 grid
CORR_CASES = {'cell': (256, 16, 16, 4), 'small': (256, 16, 16, 3),
              '64px': (3, 8, 8, 4), 'non_square': (3, 12, 20, 4),
              'non_square_small': (2, 12, 20, 3)}


def _corr_inputs(b, h, w, seed, spread=12.):
    """A float32 pyramid of random 256-channel features and coordinates
    up to spread / 2 cells around the grid, past every border."""
    gen = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn((b, h, w, 256), generator=gen) for _ in range(2))
    coords = traft.coords_grid(b, h, w) + spread * (
        torch.rand((b, h, w, 2), generator=gen) - 0.5)
    return traft.corr_pyramid(f1, f2), coords


def _corr_gap(out, ref):
    """Each query's relative L2 gap (a zero row against a zero row is
    0)."""
    d = (out.cpu() - ref).flatten(0, 2).norm(dim=1)
    return d / ref.flatten(0, 2).norm(dim=1).clamp_min(1e-30)


def _corr_on_card(pyramid, coords, radius, device):
    before = tcorr.launches
    out = tcorr.corr_lookup([p.to(device) for p in pyramid],
                            coords.to(device), radius)
    torch.cuda.synchronize()
    assert tcorr.launches == before + 1
    assert out.is_cuda and out.dtype == torch.float32
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(CORR_CASES))
def test_corr_lookup_kernel_matches_twin(cuda_device, case):
    """The kernel against the plain twin on the CPU, each query's row at
    a relative L2 gap of at most 1e-6: the cell's shapes, raft-small's
    radius, a 64-px input (levels down to 1 x 1), a non-square grid at
    radius 4 and 3 (coordinates there a strided view)."""
    b, h, w, r = CORR_CASES[case]
    pyramid, coords = _corr_inputs(b, h, w, seed=len(case))
    if case.startswith('non_square'):
        coords = coords.transpose(1, 2).contiguous().transpose(1, 2)
        assert not coords.is_contiguous()
    out = _corr_on_card(pyramid, coords, r, cuda_device)
    ref = tcorr.corr_lookup_reference(pyramid, coords, r)
    assert out.shape == ref.shape == (b, h, w, 4 * (2 * r + 1) ** 2)
    assert float(_corr_gap(out, ref).max()) <= 1e-6


@pytest.mark.cuda
def test_corr_lookup_kernel_at_special_coordinates(cuda_device):
    """Coordinates on whole cells, half cells, the map's last cell and
    its negatives, and whole windows off every level's map (zeros,
    exactly)."""
    pyramid, _ = _corr_inputs(6, 16, 16, seed=7)
    grid = traft.coords_grid(6, 16, 16)
    coords = torch.stack([grid, grid + 0.5, grid.clamp(max=0.) + 15.,
                          -grid, grid + 100., grid - 100.])[
        torch.arange(6), torch.arange(6)]
    out = _corr_on_card(pyramid, coords, 4, cuda_device).cpu()
    ref = tcorr.corr_lookup_reference(pyramid, coords, 4)
    assert float(_corr_gap(out, ref)[:4 * 256].max()) <= 1e-6
    assert not out[4:].any() and not ref[4:].any()
    assert out[:4].abs().amax(dim=(1, 2, 3)).min() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('small', [False, True])
def test_raft_forward_launches_one_lookup_an_iteration(cuda_device, small):
    model = traft.build_raft(small=small, seed=1).to(cuda_device)
    im1, im2 = (t.to(cuda_device) for t in _flow_pairs(2, 64))
    before = tcorr.launches
    with torch.inference_mode():
        flow = model(im1, im2, iters=5, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tcorr.launches == before + 5
    assert torch.isfinite(flow).all()


@pytest.mark.cuda
@pytest.mark.parametrize('fault', ['float64', 'bfloat16', 'strided'])
def test_corr_lookup_kernel_refuses(cuda_device, fault):
    """What the kernel does not take raises before a launch: float64 and
    bf16 levels, a level that is not contiguous."""
    pyramid, coords = _corr_inputs(2, 8, 8, seed=5)
    pyramid = [p.to(cuda_device) for p in pyramid]
    coords = coords.to(cuda_device)
    if fault in ('float64', 'bfloat16'):
        pyramid = [p.to(getattr(torch, fault)) for p in pyramid]
    else:
        pyramid[1] = pyramid[1].transpose(1, 2)
    before = tcorr.launches
    with pytest.raises(ValueError, match={
            'float64': 'float32', 'bfloat16': 'float32',
            'strided': 'contiguous'}[fault]):
        tcorr.corr_lookup(pyramid, coords, 4)
    assert tcorr.launches == before


def _rel_gap(got, want):
    return float((got.cpu() - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['64px', 'non_square_small'])
def test_corr_lookup_kernel_backward_matches_twin(cuda_device, case):
    """A pyramid and coordinates that require a gradient: one launch,
    and the gradients of both against the twin's on the CPU for the
    same output gradient, at a relative L2 gap of at most 1e-5 each."""
    b, h, w, r = CORR_CASES[case]
    grads = []
    for device in ('cpu', cuda_device):
        pyramid, coords = _corr_inputs(b, h, w, seed=11)
        pyramid = [p.to(device).requires_grad_() for p in pyramid]
        coords = coords.to(device).requires_grad_()
        before = tcorr.launches
        out = tcorr.corr_lookup(pyramid, coords, r)
        assert tcorr.launches == before + (device != 'cpu')
        out.backward(torch.randn(out.shape, generator=torch.Generator(
        ).manual_seed(12)).to(device))
        grads.append([coords.grad] + [p.grad for p in pyramid])
    for want, got in zip(*grads):
        assert got.is_cuda and _rel_gap(got, want) <= 1e-5


@pytest.mark.cuda
def test_raft_trains_on_card_through_the_lookup_kernel(cuda_device,
                                                       monkeypatch):
    """RAFT small with `train=True` and `sequence_loss` on the card, with
    autograd on: the parameters' gradients through the kernel against
    those through the twin on the card (TF32 off), at a relative L2 gap
    of at most 1e-4 over all parameters, one launch an iteration."""
    model = traft.build_raft(small=True, seed=2).to(cuda_device)
    im1, im2 = (t.to(cuda_device) for t in _flow_pairs(2, 64))
    target = torch.randn((2, 64, 64, 2), generator=torch.Generator(
    ).manual_seed(13)).to(cuda_device)
    grads = []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for twin in (False, True):
            if twin:
                monkeypatch.setattr(traft, 'corr_lookup',
                                    tcorr.corr_lookup_reference)
            model.zero_grad()
            before = tcorr.launches
            loss = traft.sequence_loss(
                model(im1, im2, iters=3, train=True), target)
            loss.backward()
            assert tcorr.launches == before + (0 if twin else 3)
            grads.append(torch.cat([p.grad.flatten()
                                    for p in model.parameters()
                                    if p.grad is not None]))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.isfinite(grads[0]).all() and grads[1].norm() > 0
    assert _rel_gap(grads[0], grads[1].cpu()) <= 1e-4


def _fed_masks(rng, b, model):
    """One keep-bit tensor a `FlaxDropout` of `model` (the shape it asks
    for at batch b: (b, 1, 1, 1) for stochastic depth, (b, C) at the
    head), as a `set_dropout_draw` source that hands them out in turn."""
    shapes = [(b, 1, 1, 1) if m.broadcast_dims else (b, 1280)
              for m in model.modules()
              if isinstance(m, FlaxDropout) and m.rate > 0]
    masks = [torch.from_numpy(rng.random(s) < 0.8) for s in shapes]

    def source():
        feed = iter(masks)
        return lambda shape, keep, device: next(feed).to(device)
    return source


@pytest.mark.cuda
def test_effnet_step_and_eval_on_card_match_cpu(cuda_device):
    """An effnet0 student (RGB + flow, motion head) in float32 with TF32
    off: eval forward at atol 1e-4, one train step on the same batch and
    dropout masks at the train-step bars above; then the bf16 step over
    float32 masters, channels_last, makes no host sync after its first
    and lowers the loss on one batch."""
    lr, emb = 1e-3, 8
    cfg = default_config('fs', emb, img_dim=S, use_flow=True, motion=True,
                         encoder_arch='effnet0')
    torch.manual_seed(0)
    cpu_model = build_student(cfg, dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 5, S, S)).astype(np.float32))
    emb_t = torch.from_numpy(rng.normal(size=(4, 2 * emb))
                             .astype(np.float32))
    masks = _fed_masks(rng, 4, cpu_model)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = cpu_model.eval().encoder(x)
            got = gpu_model.eval().encoder(x.to(cuda_device)).cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
        imgs = x.permute(0, 2, 3, 1)
        losses, grads = [], []
        for model, dev in ((cpu_model, 'cpu'), (gpu_model, cuda_device)):
            state = tvpd.create_state(model, lr)
            losses.append(float(tvpd.forward_backward(
                state, imgs.to(dev), emb_t.to(dev), masks())))
            grads.append({n: p.grad.cpu().clone()
                          for n, p in model.named_parameters()})
            tvpd.optimizer_step(state)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    # Adam's first step moves a parameter by about lr whatever its
    # gradient: the gradients before it are what the backward is held to.
    # A project BN's bias has a gradient of 0 but for rounding where its
    # shift reaches only train-mode BNs downstream (no stochastic depth
    # drops its branch for some samples): the bar has a floor at a share
    # of the whole gradient's norm.
    whole = torch.stack([g.norm() for g in grads[0].values()]).norm()
    for name, want in grads[0].items():
        got = grads[1][name]
        assert torch.isfinite(got).all(), name
        assert (got - want).norm() <= 1e-3 * want.norm() + 1e-6 * whole, name
    gpu_sd = gpu_model.state_dict()
    for name, t in cpu_model.state_dict().items():
        got = gpu_sd[name].cpu()
        if 'running' in name:
            np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        elif not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(got.numpy(), t.numpy(),
                                       atol=2.5 * lr, err_msg=name)

    model = build_student(cfg, dtype=torch.bfloat16,
                          param_dtype=torch.float32).to(cuda_device)
    model.to(memory_format=torch.channels_last)
    state = tvpd.create_state(model, lr)
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], img_dim=S,
                                use_flow=True, aug_dtype=torch.bfloat16)
    batch = {k: v.to(cuda_device) for k, v in _train_batch(
        np.random.default_rng(1), 16, S, emb).items()}
    losses = [step(state, batch, 0)['emb_loss_sum']]
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(7):
            losses.append(step(state, batch, 0)['emb_loss_sum'])
    finally:
        torch.cuda.set_sync_debug_mode('default')
    losses = torch.stack(losses).tolist()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------- mesh

def _two_ranks(fn, *args):
    from vpd_tpu_torch.core.mesh import spawn_ranks
    return spawn_ranks(fn, 2, *args, device='cuda:0', backend='gloo',
                       timeout=300)


@pytest.mark.cuda
def test_epoch_sums_run_on_an_nccl_group(cuda_device):
    import torch_mesh_workers as W
    from vpd_tpu_torch.core.mesh import spawn_ranks

    (got,) = spawn_ranks(W.epoch_sums_over_world, 1, device='cuda:0',
                         backend='nccl', timeout=300)
    assert got['backend'] == 'nccl'
    assert got['scalar'] == 5. and got['array'] == [1., 2.]
    assert got['epoch'] == {'loss': 1.5, 'contra': 0.5,
                            'per_dataset': {0: 1., 1: 0.5}}


@pytest.mark.cuda
def test_synced_batchnorm_on_two_ranks_of_one_card(cuda_device):
    import torch_mesh_workers as W
    from vpd_tpu_torch.core.mesh import get_mesh

    rng = np.random.default_rng(0)
    x = rng.normal(1., 2., (8, 16, 6, 6)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    ranks = _two_ranks(W.synced_bn, x, w, b, gy)
    one = W.synced_bn(get_mesh(cuda_device), x, w, b, gy)
    for key in ('y', 'gx'):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]),
                                   one[key], rtol=1e-5, atol=1e-5)
    for key in ('gw', 'gb'):
        np.testing.assert_allclose(sum(r[key] for r in ranks), one[key],
                                   rtol=1e-5, atol=1e-5)
    for key in ('mean', 'var'):
        np.testing.assert_allclose(ranks[1][key], one[key], rtol=1e-5)


@pytest.mark.cuda
def test_student_step_on_two_ranks_of_one_card(cuda_device):
    import torch_mesh_workers as W
    from vpd_tpu_torch.core.mesh import get_mesh

    rng = np.random.default_rng(1)
    b = 16
    batch = {'rgb': rng.integers(0, 256, (b, 32, 32, 3), np.uint8),
             'flow': rng.integers(0, 256, (b, 32, 32, 3), np.uint8),
             'mask': ((rng.random((b, 32, 32)) > .5) * 255).astype(np.uint8),
             'emb': rng.normal(size=(b, 8)).astype(np.float32),
             'flip': rng.random(b) < 0.5}
    ranks = _two_ranks(W.card_student_step, batch)
    one = W.card_student_step(get_mesh(cuda_device), batch)
    loss = ranks[0]['loss'] + ranks[1]['loss']
    assert abs(loss - one['loss']) <= 1e-5 * abs(one['loss'])
    for k, t in one['stats'].items():
        np.testing.assert_allclose(ranks[0]['stats'][k], t, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    ranks = _two_ranks(W.card_student_step, batch, torch.float64)
    one = W.card_student_step(get_mesh(cuda_device), batch, torch.float64)
    whole = np.sqrt(sum(np.sum(g ** 2) for g in one['grads'].values()))
    for k, g in one['grads'].items():
        assert np.linalg.norm(ranks[0]['grads'][k] - g) <= \
            1e-3 * np.linalg.norm(g) + 1e-6 * whole, k
