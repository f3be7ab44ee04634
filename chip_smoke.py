#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vpd_tpu_torch) on one sm_90 GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one H100. Phases, one JSON
line each; any failure raises and exits non-zero:

  env        card name and power limit (nvidia-smi), torch/CUDA versions;
             requires compute capability 9.0
  build      compiles every kernel in vpd_tpu_torch/csrc with nvcc
  kernels    each kernel against its plain PyTorch twin on the card:
             B1 (preprocess) at the extraction shapes and at shapes of
             its general variant (W off a multiple of 16, offset views),
             with the variant that ran, the differing elements and
             ptxas's registers and spills, timed beside its bounds (pair
             mode with 5 and 3 channels, mode 0) with its general
             variant and a plain copy of as many bytes as yardsticks;
             B2 (all-pairs DTW) for both step patterns at L in
             {128, 512}, D in {32, 64}, at lengths on its tile edges with
             D in {1, 7, 20, 32, 64, 128}, a subset and identical
             sequences against the f64 host DP, and its launch's
             registers, spills and resident warps
  recognize  DTW few-shot recognition and retrieval end to end at the
             full fs protocol (the real all.txt, val ids, few-shot split
             files and cached fps; 1446 actions; synthetic (2, 32)
             embeddings with a class signal): the recognize CLI on cuda
             for -ne 4 16 64 x 10 trials, -ne -1, and --retrieve, with
             B2's launch count checked, the full-data accuracy held at
             >= 0.9, the d1 sweep held against the twin on the card and a
             twin-backed run of the whole protocol; B2 timed at the kNN
             and retrieval sweeps' real shapes beside their bounds (the
             tensor-core product or the recurrence, and the earlier
             one-term float32 form)
  slice      the student extraction path end to end at full width
             (ResNet-34, 32-d, 128x128, batch 512, orig + flip): random-init
             students written with the port's checkpoint writer, raw shards
             (and PNGs when cv2 or PIL is present), `apply_vpd` on cuda with
             the kernel launch counts (and B1's vector variant) checked,
             outputs held against the same weights in float32 with the
             plain preprocess and TF32 off
  train      the student's train step at bench.py's train rung (B = 2048,
             ResNet-34 + motion head, bf16 compute over float32 master
             weights, RGB + flow + mask, bf16 augmentation) on batches
             made on the card: crops/s, ms per step split by CUDA events
             into augment (and its stages), fwd + bwd and AdamW, peak
             memory, fwd + bwd TFLOP/s against the bf16 peak, and the
             loss falling on one batch; then `python -m vpd_tpu_torch.tools.train_vpd` end to
             end on a synthetic fs corpus in raw shards (2 epochs at the
             default batch of 100, --resume to 3), its checkpoints read
             back, and `best_epoch` extracted through `apply_vpd`
  cache      the student's training input: a raw-shard corpus of 24,000
             crops with flow and masks (2.75 GB, one virtual epoch)
             staged in the device crop cache (seconds, GB/s, peak memory
             held to the corpus plus one shard, rows read back byte for
             byte); the cached step at B = 2048 (ms, gather ms beside its
             byte bound, crops/s) beside the train phase's streamed
             step, and one step of each path on the same rows with cuDNN
             deterministic (loss rel 1e-6, parameters max rel 1e-5); the
             CLI with --hbm_cache (3 epochs, --resume to 4) beside the
             streamed CLI's epochs, and one epoch with --num_workers 2;
             `best_epoch` extracted through `apply_vpd` (B1 launches)
             against f32 weights (ROADMAP C2: min row cosine, mean
             pairwise cosines); 600 PNG crops decoded by the native
             decoder (where it builds) and cv2, and packed by
             `tools/pack_crops`, read back equal

The last three lines are the card line as nvidia-smi prints it, the
kernels summary and `{"ok": true, "device": {...}}`. Scratch files go to
`.smoke/` in the checkout and are removed at the end.
"""

import contextlib
import copy
import io
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from vpd_tpu_torch.core.io import store_embs_pickle
from vpd_tpu_torch.data import augment as aug
from vpd_tpu_torch.data import crops as crops_mod
from vpd_tpu_torch.data import native_loader
from vpd_tpu_torch.data.crops import CropBatchSource
from vpd_tpu_torch.data.hbm_cache import CacheIndexSource, DeviceCropCache
from vpd_tpu_torch.data.shards import ShardReader, write_raw_shards
from vpd_tpu_torch.datasets.eval_splits import FS_TEST_PREFIXES
from vpd_tpu_torch.datasets.metadata_cache import load_meta_cache
from vpd_tpu_torch.datasets.recognition_data import (ACTION_DATA_DIR,
                                                     FS_CLASSES)
from vpd_tpu_torch.infer import apply_vpd as ap
from vpd_tpu_torch.ops import _build
from vpd_tpu_torch.ops import dtw_kernel as dtwk
from vpd_tpu_torch.ops import preprocess as pre
from vpd_tpu_torch.ops.dtw import dtw_distance, pairwise_l2
from vpd_tpu_torch.tasks import neighbors as nb
from vpd_tpu_torch.tools import pack_crops as pack_cli
from vpd_tpu_torch.tools import recognize as recognize_cli
from vpd_tpu_torch.train.vpd import (cache_gather, create_state,
                                     forward_backward,
                                     make_cached_train_step,
                                     make_train_step, optimizer_step)
from vpd_tpu_torch.train.vpd_loop import (build_student, default_config,
                                          save_student)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, '.smoke')
SEED = 0
IMG = 128
EMB = 32
BATCH = 512                # EXTRACT_BATCH, the CLI default
VIDEOS, FRAMES = 2, 600
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12    # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores
TOL = 0.02                 # bf16 rounding of values in [-4.2, 4.4]
B1_MAX_DIFF_5CH = 0.002    # share of B1's 5-channel outputs one ulp off
B1_REPS = 20               # B1 launches a timing sample
COS_BAR = 0.999
# B2 against its twin: both take the matmul form of the cost (the kernel
# in 3xTF32), whose float32 rounding differs in order
DTW_TOL = 1e-3
DTW_HOST_RTOL = 5e-3       # against the f64 host DP: the JAX kernel's bar
# identical sequences: the f64 DP gives 0; the matmul form alone would
# leave ~sqrt(eps32 (|q|^2 + |t|^2)) ~ 5e-3 a cell in float32
DTW_SAME_ATOL = 1e-5
# lengths on B2's tile edges: 8 query rows and 16 target columns a tile,
# 32 lanes, 128-row target chunks
DTW_EDGE_LENS = (1, 2, 3, 15, 16, 17, 127, 128, 129, 255, 256, 257, 511,
                 512)
FS_EMB = 32                # the student's width: (2, 32) rows, orig + flip
FS_SHOTS, FS_TRIALS = [4, 16, 64], 10
FS_HITS = [1, 10, 25, 50]
FS_ACC_BAR = 0.9           # full-data accuracy; chance is 1/6
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
TRAIN_B = 2048             # bench.py's train rung (bench.py:96-117)
TRAIN_RING = 4             # distinct batches the timed steps cycle over
TRAIN_WARMUP, TRAIN_STEPS, FIT_STEPS = 3, 10, 10
CLI_VIDEOS, CLI_FRAMES = 4, 300
CLI_EPOCHS = 2
CACHE_VIDEOS, CACHE_FRAMES = 40, 600  # 24,000 crops: one virtual epoch
CACHE_CHECK_ROWS = 512
CACHE_LOSS_RTOL, CACHE_PARAM_RTOL = 1e-6, 1e-5
CLI_CACHE_EPOCHS = 3
PNG_VIDEOS, PNG_FRAMES = 2, 300


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3, reps=1):
    """Median milliseconds of one call of `fn` over `iters` samples (CUDA
    events), each sample `reps` calls back to back. reps > 1 keeps the
    card's queue full, so a kernel shorter than its host-side launch is
    timed without the host's gaps."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _encoder_flops(enc, x):
    """Multiply-add flops of one encoder call on `x`, from the shapes."""
    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * \
                mod.kernel_size[1]
        else:
            k = mod.in_features
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in enc.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            enc(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    cap = torch.cuda.get_device_capability(0)
    emit({'phase': 'env', 'card': card_line(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'capability': list(cap),
          'device_count': torch.cuda.device_count()})
    if cap != (9, 0):
        raise SystemExit('chip_smoke: needs an sm_90 card, got {}'.format(
            cap))


def phase_build():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_kernels()
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'library': os.path.relpath(lib, ROOT)})


def _crops(gen, b, flow_c, size=IMG):
    dev = torch.device('cuda')
    rgb = torch.randint(0, 256, (b, size, size, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    flow = (torch.randint(0, 256, (b, size, size, flow_c), generator=gen,
                          device=dev, dtype=torch.uint8) if flow_c else None)
    return rgb, flow


def _offset_copy(x):
    """x copied into a contiguous view 8 bytes into its buffer: the
    general variant's input."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    return buf[8:].view(x.shape).copy_(x)


def _b1_bound(b, channels, pair, flow_c):
    """B1's least time in ms: the larger of the bytes (uint8 in once, bf16
    out once) and its 3 float32 operations an output value (sub, mul,
    convert). Its record."""
    out_elems = (2 if pair else 1) * b * IMG * IMG * channels
    moved = b * IMG * IMG * (3 + flow_c) + 2 * out_elems
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * out_elems / F32_FLOPS_PER_S * 1e3
    return {'bytes': moved, 'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations'}


def _b1_case(gen, b, flow_c, size=IMG, view=None):
    """Inputs of one B1 check. view 'offset8': every input starts 8 bytes
    into its buffer; 'drop_first': rgb and flow are x[1:] of a batch one
    larger (a contiguous view with an offset of one sample)."""
    rgb, flow = _crops(gen, b + (view == 'drop_first'), flow_c, size)
    if view is not None:
        cut = (lambda x: x[1:]) if view == 'drop_first' else _offset_copy
        rgb, flow = cut(rgb), None if flow is None else cut(flow)
    flip = torch.randint(0, 2, (b,), generator=gen, device='cuda',
                         dtype=torch.int32)
    return rgb, flow, flip


def _b1_vs_twin(out, ref):
    """B1's output against its twin's: within TOL; the rgb channels bit
    for bit; a differing element only in a flow channel and one bf16 step
    off (the twin divides by 255 where the kernel multiplies by 1/255);
    at most B1_MAX_DIFF_5CH of the elements at shapes of 2^20 elements
    and more (which byte values differ is fixed, so small shapes scatter
    around that share). The check's record."""
    diff = out != ref
    n_diff = int(diff.sum())
    steps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    rec = {'channels': out.shape[-1],
           'max_abs_err': (out.float() - ref.float()).abs().max().item(),
           'elements_differing': n_diff, 'elements': out.numel(),
           'max_bf16_steps': int(steps.max())}
    if not (rec['max_abs_err'] <= TOL and not diff[..., :3].any()
            and rec['max_bf16_steps'] <= 1
            and (out.numel() < 1 << 20
                 or n_diff <= B1_MAX_DIFF_5CH * out.numel())):
        raise AssertionError('preprocess kernel disagrees with its twin: '
                             '{}'.format(rec))
    return rec


def phase_kernels():
    """B1 against its twin at the extraction shapes (B in {13, 512}, 3 and
    5 channels, both modes) and at shapes that reach the general variant
    (W off a multiple of 16, offset views) or other flow widths; which
    variant ran at each; B1's ptxas resources; timings beside bounds."""
    mean, std = default_config('fs', EMB)['rgb_mean_std']
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    # (b, flow_c, size, view, the variant it must take); B = BATCH at
    # 128x128 with 0 or 3 flow channels is the main path's shape
    cases = [(13, 0, IMG, None, 'vector'), (13, 3, IMG, None, 'vector'),
             (BATCH, 0, IMG, None, 'vector'),
             (BATCH, 3, IMG, None, 'vector'),
             (1, 3, IMG, None, 'vector'), (4, 2, IMG, None, 'vector'),
             (4, 4, IMG, None, 'vector'), (5, 3, 20, None, 'general'),
             (3, 4, 7, None, 'general'), (4, 3, 7, 'drop_first', 'general'),
             (4, 3, IMG, 'drop_first', 'vector'),
             (6, 3, IMG, 'offset8', 'general'),
             (6, 0, IMG, 'offset8', 'general')]
    checks, max_err = [], 0.
    for b, flow_c, size, view, want in cases:
        rgb, flow, flip = _b1_case(gen, b, flow_c, size, view)
        for mode in (0, 1):
            before = dict(pre.variant_launches)
            if mode == 0:
                out = pre.preprocess_crops(rgb, flow, flip, mean, std)
                ref = pre.preprocess_crops_reference(rgb, flow, flip,
                                                     mean, std)
            else:
                out = pre.preprocess_orig_and_flip(rgb, flow, mean, std)
                ref = pre.preprocess_orig_and_flip_reference(
                    rgb, flow, mean, std)
            torch.cuda.synchronize()
            ran = [v for v in before
                   if pre.variant_launches[v] == before[v] + 1]
            checks.append({'b': b, 'size': size, 'flow_c': flow_c,
                           'view': view, 'mode': mode, 'variant': ran,
                           **_b1_vs_twin(out, ref)})
            max_err = max(max_err, checks[-1]['max_abs_err'])
            if ran != [want]:
                raise AssertionError('preprocess ran the {} variant, not '
                                     '{}, at {}'.format(ran, want,
                                                        checks[-1]))

    # ptxas's resources of every B1 build: no build may spill
    ptxas = _build.ptxas_resources(_build.ptxas_report(['preprocess.cu']))
    if not ptxas or any(k['spill_store_bytes'] or k['spill_load_bytes']
                        for k in ptxas):
        raise AssertionError('a B1 build spills: {}'.format(ptxas))

    # timing at the main path's shapes, the vector variant, B1_REPS
    # launches back to back a sample (one launch is shorter than the
    # wrapper's host time)
    rgb, flow = _crops(gen, BATCH, 3)
    rgb3, _ = _crops(gen, BATCH, 0)
    flip = torch.randint(0, 2, (BATCH,), generator=gen, device='cuda',
                         dtype=torch.int32)
    ms = cuda_ms(lambda: pre.preprocess_orig_and_flip(rgb, flow, mean, std),
                 reps=B1_REPS)
    plain_ms = cuda_ms(lambda: pre.preprocess_orig_and_flip_reference(
        rgb, flow, mean, std))
    ms_rgb = cuda_ms(lambda: pre.preprocess_orig_and_flip(rgb3, None, mean,
                                                          std), reps=B1_REPS)
    mode0_ms = cuda_ms(lambda: pre.preprocess_crops(rgb, flow, flip, mean,
                                                    std), reps=B1_REPS)
    # the general variant (the first port's design) on the same crops,
    # reached through 8-byte offset views
    rgb_o, flow_o = _offset_copy(rgb), _offset_copy(flow)
    general_ms = cuda_ms(lambda: pre.preprocess_orig_and_flip(
        rgb_o, flow_o, mean, std), reps=B1_REPS)
    for args in ((rgb, flow), (rgb3, None)):  # the same arithmetic
        vec = pre.preprocess_orig_and_flip(*args, mean, std)
        gen_out = pre.preprocess_orig_and_flip(
            *(None if a is None else _offset_copy(a) for a in args), mean,
            std)
        if not torch.equal(vec, gen_out):
            raise AssertionError('B1\'s variants differ at {}'.format(
                tuple(vec.shape)))
    # the card's plain copy: one device-to-device copy_ of as many bytes
    # as B1 moves at the main shape (read + write = twice that)
    pair5 = _b1_bound(BATCH, 5, True, 3)
    src = torch.empty(pair5['bytes'], dtype=torch.uint8, device='cuda')
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), reps=B1_REPS)
    del src, dst
    pair3 = _b1_bound(BATCH, 3, True, 0)
    mode0 = _b1_bound(BATCH, 5, False, 3)
    emit({'phase': 'kernels', 'kernel': 'preprocess', 'checks': checks,
          'ptxas': ptxas, 'pair_5ch_ms': ms, 'pair_5ch_plain_ms': plain_ms,
          'pair_5ch_bytes': pair5['bytes'],
          'pair_5ch_bound_ms': pair5['bound_ms'],
          'pair_5ch_GBps': pair5['bytes'] / ms / 1e6,
          'pair_5ch_general_variant_ms': general_ms,
          'pair_3ch_ms': ms_rgb, 'pair_3ch_bytes': pair3['bytes'],
          'pair_3ch_bound_ms': pair3['bound_ms'],
          'mode0_5ch_ms': mode0_ms, 'mode0_5ch_bytes': mode0['bytes'],
          'mode0_5ch_bound_ms': mode0['bound_ms'],
          'copy_bytes': pair5['bytes'], 'copy_ms': copy_ms,
          'copy_GBps': 2 * pair5['bytes'] / copy_ms / 1e6})
    return {'name': 'preprocess', 'route': 'cuda',
            'source': 'vpd_tpu_torch/csrc/preprocess.cu',
            'replaces': 'vpd_tpu/ops/pallas/preprocess.py:37',
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': pair5['bound_ms'], 'bound_by': pair5['bound_by'],
            'library_ms': None, 'pair_3ch_ms': ms_rgb,
            'mode0_5ch_ms': mode0_ms, 'copy_ms': copy_ms}


def _dtw_inputs(gen, n_q, n_t, L, D):
    """Zero-padded sequences on the card, lengths in [5, L]; query 0 has
    length 5 and target 0 length L (symmetricP2 cannot align them)."""
    lens = [torch.randint(5, L + 1, (n,), generator=gen, device='cuda',
                          dtype=torch.int32) for n in (n_q, n_t)]
    lens[0][0], lens[1][0] = 5, L
    seqs = []
    for n, ln in zip((n_q, n_t), lens):
        x = torch.randn((n, L, D), generator=gen, device='cuda')
        x *= (torch.arange(L, device='cuda')[None, :, None]
              < ln[:, None, None])
        seqs.append(x)
    return seqs[0], lens[0], seqs[1], lens[1]


def _edge_inputs(gen, L, D):
    """Every pair of lengths from DTW_EDGE_LENS up to L, random rows."""
    lens = torch.tensor([n for n in DTW_EDGE_LENS if n <= L],
                        dtype=torch.int32, device='cuda')
    seqs = []
    for _ in range(2):
        x = torch.randn((len(lens), L, D), generator=gen, device='cuda')
        x *= (torch.arange(L, device='cuda')[None, :, None]
              < lens[:, None, None])
        seqs.append(x)
    return seqs[0], lens, seqs[1], lens.clone()


def _dtw_vs_twin(q, ql, t, tl, sp, case):
    """B2 against its twin on the card: the same +inf pattern and
    rtol = atol = DTW_TOL. The check's record."""
    out = dtwk.dtw_matrix(q, ql, t, tl, sp)
    ref = dtwk.dtw_matrix_reference(q, ql, t, tl, sp)
    torch.cuda.synchronize()
    same_inf = bool((out.isinf() == ref.isinf()).all())
    fin = ref.isfinite()
    err = (out[fin] - ref[fin]).abs()
    check = {**case, 'step_pattern': sp, 'pairs': out.numel(),
             'infeasible': int((~fin).sum()), 'same_inf': same_inf,
             'max_abs_err': err.max().item(),
             'max_rel_err': (err / ref[fin].abs()).max().item()}
    if not (same_inf and torch.allclose(out[fin], ref[fin], rtol=DTW_TOL,
                                        atol=DTW_TOL)):
        raise AssertionError('dtw kernel disagrees with its twin at '
                             '{}'.format(check))
    return out, check


def phase_dtw_kernel():
    """B2 against its twin on the card, for both step patterns: L in
    {128, 512} and D in {32, 64} with Q and T off any multiple, lengths on
    the tile edges at D in {1, 7, 20, 32, 64, 128}; a 16 x 16 subset and
    identical sequences against the f64 host DP."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    checks = []
    cases = [(L, D, False) for L in (128, 512) for D in (32, 64)]
    cases += [(128, D, True) for D in (1, 7, 20, 32, 64, 128)]
    cases += [(512, 20, True)]
    for L, D, edge in cases:
        q, ql, t, tl = (_edge_inputs(gen, L, D) if edge
                        else _dtw_inputs(gen, 37, 53, L, D))
        for sp in ('symmetricP2', 'symmetric2'):
            out, check = _dtw_vs_twin(q, ql, t, tl, sp,
                                      {'L': L, 'D': D, 'edge_lens': edge})
            checks.append(check)
            if L == 128 and D == 32 and not edge:  # host DP: slow, 16 x 16
                host = _host_dtw(q[:16], ql[:16], t[:16], tl[:16], sp)
                got = out[:16, :16].cpu().numpy()
                fin_h = np.isfinite(host)
                if not (np.array_equal(np.isinf(got), ~fin_h)
                        and np.allclose(got[fin_h], host[fin_h],
                                        rtol=DTW_HOST_RTOL, atol=0)):
                    raise AssertionError('dtw kernel disagrees with the '
                                         'f64 host DP ({})'.format(sp))
                check['host_dp_max_rel_err'] = float(np.max(
                    np.abs(got[fin_h] - host[fin_h]) / host[fin_h]))

    # identical sequences (the retrieval diagonal): q = t, lengths 75-100
    L, D = 100, 64
    lens = torch.randint(75, L + 1, (10,), generator=gen, device='cuda',
                         dtype=torch.int32)
    x = torch.randn((10, L, D), generator=gen, device='cuda')
    x *= torch.arange(L, device='cuda')[None, :, None] < lens[:, None, None]
    for sp in ('symmetricP2', 'symmetric2'):
        got = dtwk.dtw_matrix(x, lens, x, lens, sp).cpu().numpy()
        host = _host_dtw(x, lens, x, lens, sp)
        diag = float(np.abs(np.diag(got) - np.diag(host)).max())
        off = ~np.eye(len(host), dtype=bool) & np.isfinite(host)
        if not (diag <= DTW_SAME_ATOL
                and np.array_equal(np.isinf(got), np.isinf(host))
                and np.allclose(got[off], host[off], rtol=DTW_HOST_RTOL,
                                atol=0)):
            raise AssertionError('dtw kernel on identical sequences: '
                                 'diagonal off by {} ({})'.format(diag, sp))
        checks.append({'L': L, 'D': D, 'identical': True,
                       'step_pattern': sp, 'pairs': got.size,
                       'diagonal_max_abs_err_vs_host_dp': diag,
                       'host_dp_max_rel_err': float(np.max(
                           np.abs(got[off] - host[off]) / host[off]))})
    info = {'L{}_D{}_{}'.format(L, D, sp): dtwk.kernel_info(L, D, sp)
            for L, D in ((128, 32), (128, 64), (512, 64))
            for sp in ('symmetricP2', 'symmetric2')}
    max_abs = max(c['max_abs_err'] for c in checks if 'max_abs_err' in c)
    max_rel = max(c['max_rel_err'] for c in checks if 'max_rel_err' in c)
    emit({'phase': 'kernels', 'kernel': 'dtw', 'checks': checks,
          'max_abs_err': max_abs, 'max_rel_err': max_rel,
          'kernel_info': info})
    return max_abs, max_rel


def _host_dtw(q, ql, t, tl, sp):
    q, t = q.cpu().double().numpy(), t.cpu().double().numpy()
    ql, tl = ql.tolist(), tl.tolist()
    return np.array([[dtw_distance(pairwise_l2(q[i, :ql[i]], t[j, :tl[j]]),
                                   sp) for j in range(len(tl))]
                     for i in range(len(ql))])


def _write_fs_corpus(emb_dir, rng):
    """One `.emb.pkl` per fs video of the real protocol: rows
    (frame, (2, 32) f32, {}) over each action's dilated window, noise
    N(0, 0.3) with +3 on the class's axis inside the annotated jump (the
    signal of bench_pipeline_e2e.make_corpus). Returns the counts."""
    meta = load_meta_cache('fs')
    by_video = {}
    with open(os.path.join(ACTION_DATA_DIR, 'fs', 'all.txt')) as fp:
        for line in fp:
            if line.strip():
                action, label = line.split()
                video, start, end = action.split(':')
                by_video.setdefault(video, []).append(
                    (int(start), int(end), FS_CLASSES.index(label)))
    n_rows = 0
    for video, acts in by_video.items():
        fps = meta[video].fps
        cls_of = {}
        for start, end, cls in acts:
            mid = (start + end) / 2
            for f in range(max(0, min(start, int(mid - fps * 2.5))),
                           max(end, int(mid + fps * 0.5))):
                cls_of.setdefault(f, -1)
            for f in range(start, end):
                cls_of[f] = cls
        frames = np.array(sorted(cls_of))
        cls = np.array([cls_of[f] for f in frames])
        emb = rng.normal(0, 0.3, (len(frames), 2, FS_EMB)).astype(np.float32)
        hit = np.flatnonzero(cls >= 0)
        emb[hit, :, cls[hit]] += 3.
        store_embs_pickle(os.path.join(emb_dir, video + '.emb.pkl'),
                          [(int(f), e, {}) for f, e in zip(frames, emb)])
        n_rows += len(frames)
    n_actions = sum(map(len, by_video.values()))
    n_test = sum(len(a) for v, a in by_video.items()
                 if v.startswith(FS_TEST_PREFIXES))
    return {'videos': len(by_video), 'actions': n_actions,
            'test_actions': n_test, 'rows': n_rows}


def _fs_protocol(emb_dir):
    """The recognize CLI on cuda, as a user runs it: few-shot, full data,
    retrieval. {run: (result, stats, seconds)}; its printing is kept
    out of this script's output."""
    common = dict(emb_dir=emb_dir, dataset='fs', out_dir=None,
                  algorithm='dtw', norm=False, k=1, hidden_dim=128,
                  attn=False, target_fps=25, num_epochs=None, val_freq=10,
                  no_test_flip=False, device='cuda')
    runs = {}
    for name, kw in (
            ('few_shot', dict(num_train_examples=FS_SHOTS,
                              n_trials=FS_TRIALS, retrieve=False)),
            ('full', dict(num_train_examples=[-1], n_trials=1,
                          retrieve=False)),
            ('retrieval', dict(num_train_examples=FS_HITS, n_trials=1,
                               retrieve=True))):
        stats = {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = recognize_cli.main(**common, **kw, stats=stats)
        runs[name] = (result, stats, time.perf_counter() - t0)
    return runs


def _sweep_inputs(queries, targets, max_len=128):
    """What `batch_distances` hands the kernel at the CLI's max_len: host
    arrays and their copies on the card."""
    L = min(max_len, max(len(a) for a in list(queries) + list(targets)))
    host = (*nb.pad_sequences(queries, L), *nb.pad_sequences(targets, L))
    return host, [torch.from_numpy(x).cuda() for x in host]


def _dtw_bound(host):
    """B2's least time for one sweep, from the inputs' true lengths: the
    larger of the bytes (inputs read once, the (Q, T) output written once)
    and the operations, themselves the larger of the cost product (2D
    flops a cell, x 3 for 3xTF32, at the TF32 tensor-core rate) and the
    recurrence (8 float32 operations a cell). `f32_bound_ms` is the one-term
    form used before the tensor-core kernel, (2D + 8) operations a cell at
    the float32 rate, kept so that the rows stay comparable."""
    cells = int(host[1].astype(np.int64).sum()) * int(
        host[3].astype(np.int64).sum())
    D = host[0].shape[-1]
    moved = sum(x.nbytes for x in host) + 4 * len(host[1]) * len(host[3])
    product_ms = cells * 2 * D * 3 / TF32_FLOPS_PER_S * 1e3
    recurrence_ms = cells * 8 / F32_FLOPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(product_ms, recurrence_ms)
    return {'cells': cells, 'D': D, 'bytes_ms': bytes_ms,
            'product_ms': product_ms, 'recurrence_ms': recurrence_ms,
            'bound_ms': max(ops_ms, bytes_ms),
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
            'f32_bound_ms': cells * (2 * D + 8) / F32_FLOPS_PER_S * 1e3}


def phase_recognize(card):
    emb_dir = os.path.join(WORK, 'fs_embs')
    os.makedirs(emb_dir)
    t0 = time.perf_counter()
    counts = _write_fs_corpus(emb_dir, np.random.default_rng(SEED))
    corpus_s = time.perf_counter() - t0

    # the main path: counts from 0 just before, read just after
    dtwk.launches = 0
    t0 = time.perf_counter()
    runs = _fs_protocol(emb_dir)
    protocol_s = time.perf_counter() - t0
    launches = dtwk.launches
    indexes = [runs[r][1]['index'] for r in ('few_shot', 'full')]
    sweeps = sum(1 + (ix._d2 is not None) for ix in indexes) + 1
    if launches != sweeps:
        raise AssertionError('dtw kernel launched {} times, expected {} '
                             '(one per sweep)'.format(launches, sweeps))
    for ix in indexes:
        if ix._d2 is not None and not np.isinf(ix.d1).any():
            raise AssertionError('symmetric2 swept without an infeasible '
                                 'symmetricP2 pair')
    accs = {ne: a for r in ('few_shot', 'full') for ne, a in
            runs[r][0].items()}
    hits, precs = runs['retrieval'][0]
    n_queries = runs['retrieval'][1]['dist'].shape[0]
    if accs[-1][0] < FS_ACC_BAR:
        raise AssertionError('full-data accuracy {} < {}'.format(
            accs[-1][0], FS_ACC_BAR))
    for v in (*[a for t in accs.values() for a in t], *hits.values(),
              *precs.values()):
        if not np.isfinite(v):
            raise AssertionError('non-finite result {}'.format(v))

    # B2 at the d1 sweep's real shape (D = 32, symmetricP2), and its twin
    index = indexes[1]
    host, (q, ql, t, tl) = _sweep_inputs(index.test_arrays,
                                         index.train_arrays)
    L = host[0].shape[1]
    ms = cuda_ms(lambda: dtwk.dtw_matrix(q, ql, t, tl), iters=10)
    retrieval_host, retrieval_dev = _sweep_inputs(
        *runs['retrieval'][1]['sweep_inputs'])
    retrieval_ms = cuda_ms(lambda: dtwk.dtw_matrix(*retrieval_dev),
                           iters=10)
    plain_ms = cuda_ms(lambda: dtwk.dtw_matrix_reference(q, ql, t, tl),
                       iters=10, warmup=1)
    ref = dtwk.dtw_matrix_reference(q, ql, t, tl).cpu().numpy()
    fin = np.isfinite(ref)
    if not (np.array_equal(np.isinf(index.d1), ~fin) and np.allclose(
            index.d1[fin], ref[fin], rtol=DTW_TOL, atol=DTW_TOL)):
        raise AssertionError('the main path\'s d1 disagrees with the twin')
    d1_err = float(np.abs(index.d1[fin] - ref[fin]).max())
    knn_bound = _dtw_bound(host)
    retrieval_bound = _dtw_bound(retrieval_host)
    cells = knn_bound['cells']

    # the whole protocol again with the twin in the sweep (on the card)
    nb.dtw_matrix = dtwk.dtw_matrix_reference
    try:
        twin = _fs_protocol(emb_dir)
    finally:
        nb.dtw_matrix = dtwk.dtw_matrix
    twin_accs = {ne: a for r in ('few_shot', 'full') for ne, a in
                 twin[r][0].items()}
    acc_diff = max(abs(a - b) for ne in accs
                   for a, b in zip(accs[ne], twin_accs[ne]))
    hit_diff = max(abs(a[h] - b[h]) for a, b in zip(
        runs['retrieval'][0], twin['retrieval'][0]) for h in FS_HITS)
    if acc_diff > 1 / counts['test_actions'] + 1e-9 or \
            hit_diff > 100 / n_queries + 1e-9:
        raise AssertionError('the twin-backed protocol differs by more '
                             'than one action: accuracy {}, hit/prec {}'
                             .format(acc_diff, hit_diff))

    stats = {r: runs[r][1] for r in runs}
    emit({'phase': 'recognize', 'card': card, **counts,
          'corpus_seconds': corpus_s,
          'test_variants': len(index.test_arrays),
          'train_variants': len(index.train_arrays), 'padded_len': L,
          'mean_accuracy': {ne: float(np.mean(a)) for ne, a in accs.items()},
          'hit_at': hits, 'prec_at': precs,
          'dtw_launches': launches, 'sweeps': sweeps,
          'knn_sweep_device_ms': ms, 'knn_sweep_plain_ms': plain_ms,
          'knn_sweep_pairs': ref.size, 'knn_sweep_cells': cells,
          'dtw_pairs_per_s': ref.size / ms * 1e3,
          'dtw_cells_per_s': cells / ms * 1e3,
          'knn_sweep_bound': knn_bound,
          'retrieval_sweep_device_ms': retrieval_ms,
          'retrieval_sweep_pairs': len(retrieval_host[1]) * len(
              retrieval_host[3]),
          'retrieval_padded_len': retrieval_host[0].shape[1],
          'retrieval_sweep_bound': retrieval_bound,
          'dtw_kernel_info': {
              'knn': dtwk.kernel_info(L, knn_bound['D']),
              'retrieval': dtwk.kernel_info(retrieval_host[0].shape[1],
                                            retrieval_bound['D'])},
          'd1_max_abs_err_vs_twin': d1_err,
          'index_seconds': {r: stats[r]['index_seconds']
                            for r in ('few_shot', 'full')},
          'vote_seconds': {**stats['few_shot']['vote_seconds'],
                           **stats['full']['vote_seconds']},
          'retrieval_sweep_seconds': stats['retrieval']['sweep_seconds'],
          'seconds': {r: runs[r][2] for r in runs},
          'protocol_seconds': protocol_s,
          'twin_protocol_seconds': sum(twin[r][2] for r in twin),
          'twin_max_accuracy_diff': acc_diff,
          'twin_max_hit_prec_diff': hit_diff})
    return {'ms': ms, 'plain_ms': plain_ms, 'launches': launches,
            'bound_ms': knn_bound['bound_ms'],
            'bound_by': knn_bound['bound_by'],
            'f32_bound_ms': knn_bound['f32_bound_ms'],
            'retrieval_ms': retrieval_ms,
            'retrieval_bound_ms': retrieval_bound['bound_ms']}


def _write_inputs(rng):
    """Raw shards for VIDEOS x FRAMES crops (+ PNGs when a codec exists)."""
    n = VIDEOS * FRAMES
    rgb = rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    flow = rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    keys = [(v, f) for v in range(VIDEOS) for f in range(FRAMES)]
    crop_dir = os.path.join(WORK, 'crops')
    write_raw_shards(os.path.join(WORK, 'shards'),
                     ['video{}/{}'.format(v, f) for v, f in keys], rgb,
                     flow=flow, flow_img_name='flow')
    png = None  # (codec, write(path, array) so that RGB decode == array)
    try:
        import cv2
        png = ('cv2', lambda p, a: cv2.imwrite(
            p, np.ascontiguousarray(a[..., ::-1])))
    except ImportError:
        try:
            from PIL import Image
            png = ('PIL', lambda p, a: Image.fromarray(a).save(p))
        except ImportError:
            pass
    if png is not None:  # video 0 only: a host-decode-bound path
        for i, (v, f) in enumerate(keys[:FRAMES]):
            d = os.path.join(crop_dir, 'video{}'.format(v))
            os.makedirs(d, exist_ok=True)
            png[1](os.path.join(d, '{}.png'.format(f)), rgb[i])
            # flow is read raw (BGR, the reverse of an RGB decode), and the
            # shards hold it in that raw order
            png[1](os.path.join(d, '{}.flow.png'.format(f)),
                   np.ascontiguousarray(flow[i][..., ::-1]))
    return rgb, flow, keys, crop_dir, png and png[0]


def _load_embs(out_dir):
    out = {}
    for f in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, f), 'rb') as fp:
            out[f[:-len('.emb.pkl')]] = pickle.load(fp)
    return out


def _check_rows(embs, frames):
    for name, rows in embs.items():
        if [r[0] for r in rows] != list(frames):
            raise AssertionError('{}: frames not sorted and complete'.format(
                name))
        for _, e, meta in rows:
            if e.shape != (2, EMB) or e.dtype != np.float32 or meta != {} \
                    or not np.isfinite(e).all():
                raise AssertionError('{}: bad row {} {}'.format(
                    name, e.shape, e.dtype))


@torch.no_grad()
def _reference(model_dir, rgb, flow, use_flow, mean, std):
    """f32 weights, plain preprocess, TF32 off: (N, 2, D) on the host."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model, _ = ap.load_student_dir(model_dir, dtype=torch.float32)
        outs = []
        for i in range(0, len(rgb), BATCH):
            r = torch.from_numpy(rgb[i:i + BATCH]).cuda()
            fl = (torch.from_numpy(flow[i:i + BATCH]).cuda()
                  if use_flow else None)
            x = pre.preprocess_orig_and_flip_reference(
                r, fl, mean, std, out_dtype=torch.float32)
            e = model.encoder(x.permute(0, 3, 1, 2))
            outs.append(e.reshape(2, len(r), EMB).transpose(0, 1).cpu())
        return torch.cat(outs).numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _cosines(a, b):
    """Row cosines of a against b, and whether each row of a is closest
    to its own row of b (a check on row order that a high cosine alone
    cannot give: a random-init encoder maps all crops near one
    direction)."""
    a = torch.from_numpy(a.reshape(-1, EMB)).cuda().double()
    b = torch.from_numpy(b.reshape(-1, EMB)).cuda().double()
    a = a / a.norm(dim=1, keepdim=True)
    b = b / b.norm(dim=1, keepdim=True)
    own = (a * b).sum(1)
    nearest = (a @ b.T).argmax(1)
    matched = bool((nearest == torch.arange(len(a), device='cuda')).all())
    return float(own.min()), matched


def _stack(embs, keys):
    by = {(int(n[len('video'):]), f): e for n, rows in embs.items()
          for f, e, _ in rows}
    return np.stack([by[k] for k in keys])


def phase_slice(card):
    rng = np.random.default_rng(SEED)
    rgb, flow, keys, crop_dir, png = _write_inputs(rng)
    reader = ShardReader(os.path.join(WORK, 'shards'), crop_root=crop_dir)
    tasks = [(v, f, os.path.join(crop_dir, 'video{}'.format(v), str(f)))
             for v, f in keys]
    order = rng.permutation(len(tasks))  # outputs must come back sorted
    tasks = [tasks[i] for i in order]
    videos = ['video{}'.format(v) for v in range(VIDEOS)]
    n_chunks = -(-len(tasks) // BATCH)

    students = {}
    for use_flow in (True, False):
        cfg = default_config('fs', EMB, img_dim=IMG, use_flow=use_flow,
                             encoder_arch='resnet34')
        torch.manual_seed(SEED + use_flow)
        model = build_student(cfg, dtype=torch.float32)
        d = os.path.join(WORK, 'student_{}'.format(
            'flow' if use_flow else 'rgb'))
        save_student(d, model, cfg)
        students[use_flow] = (d, ap.load_student_dir(d))

    def run(use_flow, out, ts, **kw):
        d, prepared = students[use_flow]
        t0 = time.perf_counter()
        ap.apply_vpd(videos, ts, d, out,
                     flow_img_name='flow' if use_flow else None,
                     batch_size=BATCH, prepared=prepared,
                     log=lambda *a: None, **kw)
        return time.perf_counter() - t0

    for use_flow in (True, False):  # warm-up: cuDNN plans, allocator
        run(use_flow, os.path.join(WORK, 'warm'), tasks[:BATCH + 7],
            shard_reader=reader)

    # the main path: counts from 0 just before, read just after
    pre.launches = 0
    pre.variant_launches = {'vector': 0, 'general': 0}
    secs = {}
    for use_flow in (True, False):
        secs[use_flow] = run(use_flow, os.path.join(
            WORK, 'out_{}'.format(use_flow)), tasks, shard_reader=reader)
    launches = pre.launches
    variants = dict(pre.variant_launches)
    if launches != 2 * n_chunks:
        raise AssertionError('preprocess launched {} times, expected {} '
                             '(one per chunk)'.format(launches,
                                                      2 * n_chunks))
    if variants['vector'] != launches:
        raise AssertionError('the main path ran B1\'s variants {}, not the '
                             'vector one alone'.format(variants))

    result = {'phase': 'slice', 'card': card, 'crops': len(tasks),
              'batch': BATCH, 'chunks_per_run': n_chunks,
              'preprocess_launches': launches,
              'preprocess_variant_launches': variants}
    for use_flow in (True, False):
        tag = 'flow' if use_flow else 'rgb'
        embs = _load_embs(os.path.join(WORK, 'out_{}'.format(use_flow)))
        if sorted(embs) != videos:
            raise AssertionError('videos written: {}'.format(sorted(embs)))
        _check_rows(embs, range(FRAMES))
        cfg = default_config('fs', EMB, use_flow=use_flow)
        ref = _reference(students[use_flow][0], rgb, flow, use_flow,
                         *cfg['rgb_mean_std'])
        cos, matched = _cosines(_stack(embs, keys), ref)
        result['min_cosine_vs_f32_' + tag] = cos
        result['rows_nearest_own_reference_' + tag] = matched
        result['apply_vpd_crops_per_s_' + tag] = len(tasks) / secs[use_flow]
        if not (cos >= COS_BAR and matched):
            raise AssertionError('{}: min cosine {} (bar {}), rows matched '
                                 '{}'.format(tag, cos, COS_BAR, matched))

    # device-staged batches: kernel + encoder on resident uint8 crops
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    for use_flow in (True, False):
        tag = 'flow' if use_flow else 'rgb'
        model, cfg = students[use_flow][1]
        embed = ap.make_variant_embed(model, cfg)
        r, fl = _crops(gen, BATCH, 3 if use_flow else 0)
        ms = cuda_ms(lambda: embed(r, fl), iters=10)
        x = pre.preprocess_orig_and_flip(r, fl, *cfg['rgb_mean_std'])
        enc = model.encoder
        with torch.inference_mode():
            enc_ms = cuda_ms(lambda: enc(x.permute(0, 3, 1, 2)), iters=10)
            stem_ms = cuda_ms(lambda: enc.conv1(x.permute(0, 3, 1, 2)),
                              iters=10)
        flops = _encoder_flops(enc, x.permute(0, 3, 1, 2))
        result['encoder_gflop_per_image_' + tag] = flops / x.shape[0] / 1e9
        result['encoder_tflops_per_s_' + tag] = flops / enc_ms / 1e9
        result['device_crops_per_s_' + tag] = BATCH / ms * 1e3
        result['embed_ms_' + tag] = ms
        result['encoder_ms_' + tag] = enc_ms
        result['stem_conv_ms_' + tag] = stem_ms

    # stem conv at 8 input channels, for the C % 8 != 0 question
    with torch.inference_mode():
        conv8 = torch.nn.Conv2d(8, 64, 7, 2, 3, bias=False).cuda().to(
            torch.bfloat16).to(memory_format=torch.channels_last)
        x8 = torch.zeros((2 * BATCH, 8, IMG, IMG), device='cuda',
                         dtype=torch.bfloat16).to(
                             memory_format=torch.channels_last)
        result['stem_conv_ms_8ch'] = cuda_ms(lambda: conv8(x8), iters=10)

    if png is not None:  # the host-decode path over video 0's PNGs
        png_tasks = [t for t in tasks if t[0] == 0]
        out = os.path.join(WORK, 'out_png')
        secs_png = run(True, out, png_tasks)
        embs = _load_embs(out)
        _check_rows(embs, range(FRAMES))
        shard = _load_embs(os.path.join(WORK, 'out_True'))['video0']
        cos, matched = _cosines(np.stack([e for _, e, _ in embs['video0']]),
                                np.stack([e for _, e, _ in shard]))
        result.update({'png_codec': png, 'png_min_cosine_vs_shards': cos,
                       'apply_vpd_png_crops_per_s_flow':
                           len(png_tasks) / secs_png})
        if not (cos >= COS_BAR and matched):
            raise AssertionError('PNG path disagrees with shards: {} {}'
                                 .format(cos, matched))
    else:
        result['png_codec'] = 'none (no cv2, no PIL): PNG path not run'
    emit(result)
    return launches


def _train_ring(gen):
    """TRAIN_RING uint8 batches on the card, as the train source gives
    them: rgb, 3-channel flow (the PNG layout), 0/255 person masks, the
    motion head's 64-d targets and the flips."""
    dev = torch.device('cuda')
    ring = []
    for _ in range(TRAIN_RING):
        rgb, flow = _crops(gen, TRAIN_B, 3)
        mask = (torch.rand((TRAIN_B, IMG, IMG), generator=gen, device=dev)
                > 0.5).to(torch.uint8) * 255
        ring.append({'rgb': rgb, 'flow': flow, 'mask': mask,
                     'emb': torch.randn((TRAIN_B, 2 * EMB), generator=gen,
                                        device=dev),
                     'flip': torch.rand(TRAIN_B, generator=gen,
                                        device=dev) < 0.5})
    return ring


def _augment_parts(batch, mean_std):
    """CUDA-event ms of the augmentation's stages on one TRAIN_B batch,
    each timed alone on its own input (so they need not sum to the
    whole): the uint8 -> bf16 cast, colour jitter, normalize + mask
    noise + flow concat, the flip, the resample."""
    dt = torch.bfloat16
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    draws = aug.sample_train_augment(gen, torch.Generator().manual_seed(SEED),
                                     TRAIN_B, IMG, IMG, noise_dtype=dt)
    draws['flip'] = batch['flip']
    mean, std = (torch.tensor(v, dtype=dt, device='cuda') for v in mean_std)
    x01 = batch['rgb'].to(dt) / 255.

    def normalize_noise_flow():
        x = aug.add_mask_noise(aug.normalize_rgb(x01, mean, std),
                               batch['mask'], draws['noise'],
                               draws['apply_noise'])
        return torch.cat([x, aug.decode_flow(batch['flow'], dt)], dim=-1)

    x5 = normalize_noise_flow()
    stages = {
        'cast': lambda: batch['rgb'].to(dt) / 255.,
        'jitter': lambda: aug.batch_color_jitter(x01, draws),
        'normalize_noise_flow': normalize_noise_flow,
        'flip': lambda: aug.flip_samples(x5, draws['flip'], True),
        'resample': lambda: aug.bilinear_resample(
            x5, draws['top'], draws['left'], draws['crop_h'],
            draws['crop_w'], IMG, IMG)}
    return {name: cuda_ms(fn, iters=5, warmup=1)
            for name, fn in stages.items()}


def _train_step_on_card(card):
    """The train step at TRAIN_B: timings, memory, FLOP rate, and the
    loss over FIT_STEPS steps on one batch."""
    cfg = default_config('fs', EMB, img_dim=IMG, use_flow=True, motion=True,
                         encoder_arch='resnet34')
    torch.manual_seed(SEED)
    model = build_student(cfg, dtype=torch.bfloat16,
                          param_dtype=torch.float32).cuda()
    model.to(memory_format=torch.channels_last)
    state = create_state(model, cfg['learning_rate'])
    step = make_train_step(*cfg['rgb_mean_std'], img_dim=IMG, use_flow=True,
                           use_mask=True, aug_dtype=torch.bfloat16)
    ring = _train_ring(torch.Generator(device='cuda').manual_seed(SEED))
    seed = SEED + 1
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        step(state, ring[i % TRAIN_RING], seed)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    marks = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        batch = ring[i % TRAIN_RING]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        imgs = step.augment(batch, seed, state.step)
        ev[1].record()
        forward_backward(state, imgs, batch['emb'])
        ev[2].record()
        optimizer_step(state)
        ev[3].record()
        marks.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    split = {name: statistics.median(ev[k].elapsed_time(ev[k + 1])
                                     for ev in marks)
             for k, name in enumerate(('augment_ms', 'fwd_bwd_ms',
                                       'optimizer_ms'))}
    step_ms = statistics.median(ev[0].elapsed_time(ev[3]) for ev in marks)

    augment_parts = _augment_parts(ring[0], cfg['rgb_mean_std'])
    imgs = step.augment(ring[0], seed, 0)
    fwd_flops = _encoder_flops(model.eval(), imgs.permute(0, 3, 1, 2))
    train_flops = 3 * fwd_flops
    tflops = train_flops / split['fwd_bwd_ms'] / 1e9

    losses = []
    for _ in range(FIT_STEPS):  # one fixed batch, fresh draws each step
        losses.append(step(state, ring[0], seed)['emb_loss_sum'])
    losses = torch.stack(losses).tolist()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError('the loss does not fall on one batch: {}'
                             .format(losses))
    return {'batch': TRAIN_B, 'arch': 'resnet34', 'channels': 5,
            'motion': True, 'compute': 'bf16, float32 master weights',
            'augment_dtype': 'bf16', 'warmup_steps': TRAIN_WARMUP,
            'warmup_seconds': warmup_s, 'timed_steps': TRAIN_STEPS,
            'crops_per_s': TRAIN_B * TRAIN_STEPS / wall,
            'host_ms_per_step': wall / TRAIN_STEPS * 1e3,
            'device_ms_per_step': step_ms, **split,
            'augment_parts_ms': augment_parts,
            'peak_memory_GiB': peak / 2 ** 30,
            'fwd_gflop_per_crop': fwd_flops / TRAIN_B / 1e9,
            'fwd_bwd_tflops_per_s': tflops,
            'bf16_peak_share': tflops * 1e12 / BF16_FLOPS_PER_S,
            'bf16_peak_TFLOPs': BF16_FLOPS_PER_S / 1e12, 'card': card,
            'fixed_batch_losses': losses}


def _write_train_corpus(root, rng):
    """Teacher `.emb.pkl` files ((2, 32) rows, a dp_score each) and raw
    shards with rgb, flow and masks for CLI_VIDEOS x CLI_FRAMES crops."""
    emb_dir = os.path.join(root, 'embs')
    os.makedirs(emb_dir)
    n = CLI_VIDEOS * CLI_FRAMES
    keys = ['video{}/{}'.format(v, f) for v in range(CLI_VIDEOS)
            for f in range(CLI_FRAMES)]
    for v in range(CLI_VIDEOS):
        rows = [(f, rng.normal(0, 1, (2, EMB)).astype(np.float32),
                 {'dp_score': 0.9}) for f in range(CLI_FRAMES)]
        store_embs_pickle(os.path.join(emb_dir, 'video{}.emb.pkl'.format(v)),
                          rows)
    shard_dir = os.path.join(root, 'shards')
    write_raw_shards(
        shard_dir, keys, rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8),
        flow=rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8),
        flow_img_name='flow',
        mask=((rng.random((n, IMG, IMG)) > 0.5) * 255).astype(np.uint8))
    return emb_dir, shard_dir, keys


def _train_cli(args, env):
    """One `python -m vpd_tpu_torch.tools.train_vpd` run: (seconds, the
    seconds of each epoch it printed)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'vpd_tpu_torch.tools.train_vpd', *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError('train_vpd failed ({}): {}'.format(
            proc.returncode, proc.stderr[-3000:]))
    epochs = [float(line.rsplit('(', 1)[1].split()[0])
              for line in proc.stdout.splitlines()
              if line.startswith('Epoch ')]
    return secs, epochs


def phase_train(card):
    result = {'phase': 'train', 'card': card,
              'step': _train_step_on_card(card)}

    root = os.path.join(WORK, 'train')
    emb_dir, shard_dir, keys = _write_train_corpus(
        root, np.random.default_rng(SEED))
    sports = os.path.join(root, 'sports')
    save = os.path.join(root, 'run')
    env = dict(os.environ, VPD_SPORTS_DIR=sports)
    common = ['fs', '--save_dir', save, '--emb_dir', emb_dir,
              '--crop_shards', shard_dir, '--flow_img', 'flow', '--motion',
              '--checkpoint_frequency', '1']
    first = _train_cli(common + ['--num_epochs', str(CLI_EPOCHS)], env)
    resumed = _train_cli(common + ['--num_epochs', str(CLI_EPOCHS + 1),
                                   '--resume'], env)
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    if [r['epoch'] for r in losses] != [1, 2, 3] or not np.isfinite(
            [[r['train'], r['val']] for r in losses]).all():
        raise AssertionError('loss.json: {}'.format(losses))
    want = ['best_epoch.encoder.ckpt'] + ['epoch0003.{}.ckpt'.format(c) for c
                                          in ('encoder', 'decoder',
                                              'optimizer')]
    missing = [f for f in want if not os.path.exists(os.path.join(save, f))]
    if missing:
        raise AssertionError('train_vpd wrote no {}'.format(missing))

    # the served student through extraction on the card
    crop_dir = os.path.join(sports, 'fs', 'crops')
    tasks = [(0, f, os.path.join(crop_dir, 'video0', str(f)))
             for f in range(CLI_FRAMES)]
    out = os.path.join(root, 'embs_out')
    pre.launches = 0
    ap.apply_vpd(['video0'], tasks, save, out, flow_img_name='flow',
                 shard_reader=ShardReader(shard_dir, crop_root=crop_dir),
                 log=lambda *a: None)
    embs = _load_embs(out)
    _check_rows(embs, range(CLI_FRAMES))
    if pre.launches < 1:
        raise AssertionError('extraction did not launch the preprocess '
                             'kernel')
    per_epoch = 100 * (200 + 40)  # the CLI's virtual epoch at batch 100
    epoch_s = first[1] + resumed[1]
    result['cli'] = {
        'crops': len(keys), 'batch': 100, 'epochs': len(epoch_s),
        'run_seconds': [first[0], resumed[0]], 'epoch_seconds': epoch_s,
        'crops_per_s_per_epoch': [per_epoch / s for s in epoch_s],
        'losses': [[r['train'], r['val']] for r in losses],
        'extracted_rows': len(embs['video0'])}
    emit(result)
    return {'step': result['step'], 'cli_epoch_seconds': epoch_s,
            'root': root, 'emb_dir': emb_dir, 'shard_dir': shard_dir,
            'sports': sports}


def _write_cache_corpus(root, gen, rng):
    """Raw shards (rgb, flow, masks) of CACHE_VIDEOS x CACHE_FRAMES random
    crops, made on the card, and the (video, None, frame, (2, 64) target)
    samples over them: (shard_dir, crop_dir, keys, samples)."""
    n = CACHE_VIDEOS * CACHE_FRAMES
    dev = torch.device('cuda')
    keys = ['video{}/{}'.format(v, f) for v in range(CACHE_VIDEOS)
            for f in range(CACHE_FRAMES)]
    shard_dir = os.path.join(root, 'shards')
    write_raw_shards(
        shard_dir, keys,
        torch.randint(0, 256, (n, IMG, IMG, 3), generator=gen, device=dev,
                      dtype=torch.uint8).cpu().numpy(),
        flow=torch.randint(0, 256, (n, IMG, IMG, 3), generator=gen,
                           device=dev, dtype=torch.uint8).cpu().numpy(),
        flow_img_name='flow',
        mask=((torch.rand((n, IMG, IMG), generator=gen, device=dev) > 0.5)
              .to(torch.uint8) * 255).cpu().numpy())
    targets = rng.normal(0, 1, (n, 2, 2 * EMB)).astype(np.float32)
    samples = [('video{}'.format(v), None, f,
                targets[v * CACHE_FRAMES + f])
               for v in range(CACHE_VIDEOS) for f in range(CACHE_FRAMES)]
    return shard_dir, os.path.join(root, 'crops'), keys, samples


def _stage_cache(shard_dir, crop_dir, keys, rng):
    """The staging run: the cache, its seconds, bytes and peak memory over
    what was allocated before, each held to the corpus plus one shard,
    and CACHE_CHECK_ROWS random rows read back against the shards."""
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = DeviceCropCache(reader, use_flow=True, device='cuda',
                            log=lambda *a: None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    shard = max(sum(s[i].nbytes for s in (reader._rgb, reader._flow,
                                          reader._mask))
                for i in range(len(reader._rgb)))
    if peak > cache.nbytes + shard:
        raise AssertionError('staging peaked at {} B, over the corpus {} B '
                             'plus one shard {} B'.format(peak, cache.nbytes,
                                                          shard))
    rows = np.sort(rng.choice(len(keys), CACHE_CHECK_ROWS, replace=False))
    want = {'rgb': np.zeros((len(rows), IMG, IMG, 3), np.uint8),
            'flow': np.zeros((len(rows), IMG, IMG, 3), np.uint8),
            'mask': np.zeros((len(rows), IMG, IMG), np.uint8)}
    if reader.fill([keys[i] for i in rows], want['rgb'], want['flow'],
                   want['mask']):
        raise AssertionError('rows missing from the shards')
    idx = torch.from_numpy(rows).cuda()
    for k, v in want.items():
        if not np.array_equal(cache.arrays[k].index_select(0, idx).cpu()
                              .numpy(), v):
            raise AssertionError('cache rows differ from the shards ({})'
                                 .format(k))
    return cache, {'crops': len(keys), 'bytes': cache.nbytes,
                   'bytes_per_crop': cache.nbytes // len(keys),
                   'shards': len(reader._rgb), 'seconds': secs,
                   'GBps': cache.nbytes / secs / 1e9, 'peak_bytes': peak,
                   'peak_limit_bytes': cache.nbytes + shard,
                   'rows_checked': len(rows)}


def _cached_vs_streamed(model, cfg, cache, samples, shard_dir, crop_dir):
    """One step of each path from copies of `model`, on the same rows and
    seed, cuDNN deterministic: (loss rel diff, max param rel diff)."""
    kw = dict(target_len=TRAIN_B, flow_img_name='flow', seed=SEED + 7)
    batch = CropBatchSource(samples, crop_dir, IMG, TRAIN_B,
                            shard_dir=shard_dir, use_native=False,
                            **kw).next_batch()
    ibatch = CacheIndexSource(samples, crop_dir, IMG, TRAIN_B, cache=cache,
                              **kw).next_batch()
    step_kw = dict(img_dim=IMG, use_flow=True, aug_dtype=torch.bfloat16)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        out = []
        for make, b, extra in (
                (make_train_step, batch, ()),
                (make_cached_train_step, ibatch, (cache.arrays,))):
            twin = copy.deepcopy(model)
            state = create_state(twin, cfg['learning_rate'])
            step = make(*cfg['rgb_mean_std'], **step_kw)
            m = step(state, {k: torch.from_numpy(v).cuda()
                             for k, v in b.items()}, SEED + 1, *extra)
            out.append((float(m['emb_loss_sum']), twin))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    (loss_s, a), (loss_c, b) = out
    param_rel = max(((p - q).abs().max() / p.abs().max().clamp_min(1e-30))
                    .item() for p, q in zip(a.parameters(), b.parameters()))
    return abs(loss_c - loss_s) / abs(loss_s), param_rel


def _cached_step_on_card(cache, samples, shard_dir, crop_dir):
    """The cached step at TRAIN_B: ms per step (CUDA events) and crops/s,
    the gather alone, and the cached-vs-streamed equality check."""
    cfg = default_config('fs', EMB, img_dim=IMG, use_flow=True, motion=True,
                         encoder_arch='resnet34')
    torch.manual_seed(SEED)
    model = build_student(cfg, dtype=torch.bfloat16,
                          param_dtype=torch.float32).cuda()
    model.to(memory_format=torch.channels_last)
    loss_rel, param_rel = _cached_vs_streamed(model, cfg, cache, samples,
                                              shard_dir, crop_dir)
    if not (loss_rel <= CACHE_LOSS_RTOL and param_rel <= CACHE_PARAM_RTOL):
        raise AssertionError('cached and streamed steps differ: loss rel {}, '
                             'params max rel {}'.format(loss_rel, param_rel))

    state = create_state(model, cfg['learning_rate'])
    step = make_cached_train_step(*cfg['rgb_mean_std'], img_dim=IMG,
                                  use_flow=True, use_mask=True,
                                  aug_dtype=torch.bfloat16)
    src = CacheIndexSource(samples, crop_dir, IMG, TRAIN_B,
                           target_len=TRAIN_B * TRAIN_RING,
                           flow_img_name='flow', seed=SEED, cache=cache)
    ring = [{k: torch.from_numpy(v).cuda() for k, v in
             src.next_batch().items()} for _ in range(TRAIN_RING)]
    for i in range(TRAIN_WARMUP):
        step(state, ring[i % TRAIN_RING], SEED + 1, cache.arrays)
    torch.cuda.synchronize()
    marks = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = step(state, ring[i % TRAIN_RING], SEED + 1, cache.arrays)
        ev[1].record()
        marks.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(float(m['emb_loss_sum'])):
        raise AssertionError('cached step loss is not finite')
    step_ms = statistics.median(a.elapsed_time(b) for a, b in marks)
    idx = ring[0]['idx']
    gather_ms = cuda_ms(lambda: cache_gather(cache.arrays, idx,
                                             ('rgb', 'flow', 'mask')))
    gather_bytes = 2 * TRAIN_B * (cache.nbytes // len(samples))
    return {'batch': TRAIN_B, 'device_ms_per_step': step_ms,
            'host_ms_per_step': wall / TRAIN_STEPS * 1e3,
            'crops_per_s': TRAIN_B * TRAIN_STEPS / wall,
            'gather_ms': gather_ms, 'gather_bytes': gather_bytes,
            'gather_bound_ms': gather_bytes / HBM_BYTES_PER_S * 1e3,
            'vs_streamed_loss_rel_diff': loss_rel,
            'vs_streamed_param_max_rel_diff': param_rel}


def _embedding_spread(save, shard_dir, crop_dir, out):
    """ROADMAP C2 on a trained student: `best_epoch` extracted through
    `apply_vpd` (bf16, B1) against the same weights in f32 over video0's
    crops: min row cosine, and the mean pairwise cosine of each."""
    tasks = [(0, f, os.path.join(crop_dir, 'video0', str(f)))
             for f in range(CLI_FRAMES)]
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    pre.launches = 0
    ap.apply_vpd(['video0'], tasks, save, out, flow_img_name='flow',
                 shard_reader=reader, log=lambda *a: None)
    launches = pre.launches
    if launches < 1:
        raise AssertionError('extraction did not launch the preprocess '
                             'kernel')
    embs = _load_embs(out)
    _check_rows(embs, range(CLI_FRAMES))
    rgb = np.zeros((CLI_FRAMES, IMG, IMG, 3), np.uint8)
    flow = np.zeros_like(rgb)
    reader.fill([t[2] for t in tasks], rgb, flow)
    mean, std = default_config('fs', EMB)['rgb_mean_std']
    ref = _reference(save, rgb, flow, True, mean, std)
    got = np.stack([e for _, e, _ in embs['video0']])
    cos, matched = _cosines(got, ref)

    def mean_pairwise(x):
        x = torch.from_numpy(x[:, 0]).cuda().double()
        x = x / x.norm(dim=1, keepdim=True)
        c = x @ x.T
        n = len(x)
        return float((c.sum() - c.diagonal().sum()) / (n * (n - 1)))

    return {'preprocess_launches': launches, 'min_row_cosine_bf16_vs_f32':
            cos, 'rows_nearest_own_reference': matched,
            'mean_pairwise_cosine_f32': mean_pairwise(ref),
            'mean_pairwise_cosine_bf16': mean_pairwise(got),
            'bar': COS_BAR, 'bar_holds': cos >= COS_BAR}


def _cached_cli(train, env):
    """The CLI from the cache (CLI_CACHE_EPOCHS, then --resume one more)
    and with 2 decode workers (one epoch) on the train phase's corpus."""
    common = ['fs', '--emb_dir', train['emb_dir'], '--crop_shards',
              train['shard_dir'], '--flow_img', 'flow', '--motion',
              '--checkpoint_frequency', '1']
    save = os.path.join(train['root'], 'run_cache')
    first = _train_cli(common + ['--save_dir', save, '--hbm_cache',
                                 '--num_epochs', str(CLI_CACHE_EPOCHS)], env)
    resumed = _train_cli(common + ['--save_dir', save, '--hbm_cache',
                                   '--num_epochs', str(CLI_CACHE_EPOCHS + 1),
                                   '--resume'], env)
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    if [r['epoch'] for r in losses] != list(range(1, CLI_CACHE_EPOCHS + 2)) \
            or not np.isfinite([[r['train'], r['val']]
                                for r in losses]).all():
        raise AssertionError('loss.json: {}'.format(losses))
    last = 'epoch{:04d}'.format(CLI_CACHE_EPOCHS + 1)
    want = ['best_epoch.encoder.ckpt'] + ['{}.{}.ckpt'.format(last, c) for c
                                          in ('encoder', 'decoder',
                                              'optimizer')]
    missing = [f for f in want if not os.path.exists(os.path.join(save, f))]
    if missing:
        raise AssertionError('train_vpd --hbm_cache wrote no {}'.format(
            missing))
    workers = _train_cli(common + ['--save_dir', os.path.join(
        train['root'], 'run_workers'), '--num_workers', '2',
        '--num_epochs', '1'], env)
    epoch_s = first[1] + resumed[1]
    per_epoch = 100 * (200 + 40)
    return save, {
        'batch': 100, 'epochs': len(epoch_s),
        'run_seconds': [first[0], resumed[0]], 'epoch_seconds': epoch_s,
        'crops_per_s_per_epoch': [per_epoch / s for s in epoch_s],
        'streamed_epoch_seconds': train['cli_epoch_seconds'],
        'losses': [[r['train'], r['val']] for r in losses],
        'workers_2': {'run_seconds': workers[0],
                      'epoch_seconds': workers[1]}}


def _png_input(root, rng):
    """PNG_VIDEOS x PNG_FRAMES crops written as PNGs (rgb, flow, masks):
    both decoders timed over the tree, and pack_crops run on it, its
    shards read back against the arrays written."""
    import cv2

    crop_dir = os.path.join(root, 'crops')
    n = PNG_VIDEOS * PNG_FRAMES
    rgb = rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8)
    flow = rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8)
    mask = ((rng.random((n, IMG, IMG)) > 0.5) * 255).astype(np.uint8)
    prefixes = []
    for i in range(n):
        d = os.path.join(crop_dir, 'video{}'.format(i // PNG_FRAMES))
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, str(i % PNG_FRAMES))
        cv2.imwrite(p + '.png', np.ascontiguousarray(rgb[i][..., ::-1]))
        cv2.imwrite(p + '.flow.png', flow[i])  # raw order, as read back
        cv2.imwrite(p + '.mask.png', mask[i])
        prefixes.append(p)

    native = native_loader.available()
    rates, decoded = {}, {}
    for name in (['native'] if native else []) + ['cv2']:
        t0 = time.perf_counter()
        decoded[name] = crops_mod.decode_crop_batch(
            [p + '.png' for p in prefixes], IMG,
            flow_paths=[p + '.flow.png' for p in prefixes],
            mask_paths=[p + '.mask.png' for p in prefixes],
            use_native=name == 'native')
        rates[name] = n / (time.perf_counter() - t0)
        for got, want in zip(decoded[name], (rgb, flow, mask)):
            if not np.array_equal(got, want):
                raise AssertionError('the {} decoder disagrees with the '
                                     'PNGs written'.format(name))

    shard_dir = os.path.join(root, 'shards')
    before = dict(crops_mod.decoder_calls)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        packed = pack_cli.main(crop_dir, shard_dir, IMG, 'flow', False,
                               4096, 'raw')
    pack_s = time.perf_counter() - t0
    ran = [k for k in before if crops_mod.decoder_calls[k] > before[k]]
    reader = ShardReader(shard_dir, crop_root=crop_dir)
    back = (np.zeros_like(rgb), np.zeros_like(flow), np.zeros_like(mask))
    if packed != n or reader.fill(prefixes, *back) or not all(
            np.array_equal(a, b) for a, b in zip(back, (rgb, flow, mask))):
        raise AssertionError('pack_crops shards differ from the PNGs')
    return {'crops': n, 'native_decoder_built': native,
            'decode_crops_per_s': rates, 'pack_decoder': ran,
            'pack_seconds': pack_s, 'pack_crops_per_s': n / pack_s}


def phase_cache(card, train):
    """The student's training input: staging the device crop cache, the
    cached step, the CLI from the cache and with decode workers, ROADMAP
    C2 on the student it trained, and the PNG decoders and pack_crops."""
    rng = np.random.default_rng(SEED + 3)
    root = os.path.join(WORK, 'cache')
    os.makedirs(root)
    t0 = time.perf_counter()
    shard_dir, crop_dir, keys, samples = _write_cache_corpus(
        root, torch.Generator(device='cuda').manual_seed(SEED + 3), rng)
    corpus_s = time.perf_counter() - t0
    cache, staging = _stage_cache(shard_dir, crop_dir, keys, rng)
    staging['corpus_seconds'] = corpus_s
    step = _cached_step_on_card(cache, samples, shard_dir, crop_dir)
    step['streamed_device_ms_per_step'] = train['step']['device_ms_per_step']
    step['streamed_crops_per_s'] = train['step']['crops_per_s']
    del cache
    shutil.rmtree(shard_dir)

    env = dict(os.environ, VPD_SPORTS_DIR=train['sports'])
    save, cli = _cached_cli(train, env)
    crop_dir = os.path.join(train['sports'], 'fs', 'crops')
    c2 = _embedding_spread(save, train['shard_dir'], crop_dir,
                           os.path.join(train['root'], 'embs_cache'))
    png = _png_input(os.path.join(root, 'png'), rng)
    emit({'phase': 'cache', 'card': card, 'staging': staging,
          'step': step, 'cli': cli, 'c2': c2, 'png': png})


def main():
    phase_env()
    card = card_line()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_build()
        preprocess = phase_kernels()
        dtw_abs, dtw_rel = phase_dtw_kernel()
        dtw = {'name': 'dtw', 'route': 'cuda',
               'source': 'vpd_tpu_torch/csrc/dtw.cu',
               'replaces': 'vpd_tpu/ops/pallas/dtw_kernel.py:53',
               'max_abs_err': dtw_abs, 'max_rel_err': dtw_rel,
               **phase_recognize(card), 'library_ms': None}
        preprocess['launches'] = phase_slice(card)
        phase_cache(card, phase_train(card))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card)
    emit({'kernels': [preprocess, dtw]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    sys.exit(main())
