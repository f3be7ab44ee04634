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
  teacher    the VIPE* teacher (no hand kernel: float32 linears on cuBLAS
             with TF32 off): four synthetic mocap families written in
             tools/paths' layout (`write_mocap_corpus`), `python -m
             vpd_tpu_torch.tools.train_vipe --dataset 3d` at vpd_tpu's
             defaults (FCResNet 2 x 1024, 32-d, batch 100) for 2 epochs
             and `--resume` to 3 in subprocesses with VPD_VIPE_DATA_DIR
             set, its loss.json, best_epoch and checkpoints checked; the
             step alone at B = 100 and 4096 on a ring of batches on the
             card (ms, rows/s, peak memory, TFLOP/s beside the float32
             bound); the sampler's host ms per batch; `apply_vipe` on the
             card over gz-JSON poses of the train corpus' videos (rows/s,
             rows checked, every row against the CPU at atol 1e-4); one
             `train_vpd` epoch on the teacher's embeddings, its student
             extracted and ROADMAP C2 read on it
  heads      the learned heads on frozen embeddings (no hand kernel: an
             explicit GRU/LSTM cell in a time loop of batched cuBLAS
             products, its train steps in CUDA graphs), at full width
             (hidden 128, depth-2 BiGRU, the recognize phase's (2, 32)
             fs rows, batch 50; proposals at batch 100 on 250-frame
             windows), depth cut to 12 epochs (3 for lstm and cnn; the
             CLI's default is 500) and the detect CLI's to 2 (200): the
             recognize CLI with gru + attention fused at -ne 4 16 64 x 10
             trials and at -ne -1 (accuracy held at >= 0.9), `-w` on its
             saved head giving the same test_pred.csv, one lstm and one
             cnn run; 3 members of the fused sweep against sequential
             trainers on the card (float64 held to rtol 2e-4 / atol 2e-5,
             float32 to atol 2e-4); the detect CLI's sequential ensemble
             (3 KFold members) against its fused one on the card, the
             same bars; one step on cuda against the CPU;
             an epoch of the sweep under set_sync_debug_mode('error');
             ms per fused (M = 10) and sequential step, with and without
             CUDA graphs, and TFLOP/s against the float32 peak; BiRNN
             fwd and fwd + bwd at B = 50, T = 128 beside cuDNN's nn.GRU on
             the same weights (held to each other); the proposal step at
             B = 100, T = 250; the ensemble's predict per video; `python
             -m vpd_tpu_torch.tools.detect fs_jump` on a synthetic
             whole-video corpus (`write_detect_corpus`, 3 members, 2
             epochs), its AP table above that of random scores
  flow       optical flow (no hand kernel: cuDNN convolutions, batched
             products and plain torch) at compute_flow's defaults: basic
             RAFT at the official widths (random init, seeded) on 128x128
             pairs, batch 256, 20 iterations, bf16. f32 on the card (TF32
             off) against the CPU on 2 pairs (atol 1e-3 after 3
             iterations; the difference after 20 printed); bf16 against
             f32 (endpoint error); pairs/s, peak memory and TFLOP/s of
             RAFT bf16, RAFT f32 (cuDNN's TF32 default), raft-small and
             LK, and RAFT's parts (encoders, correlation pyramid, one
             lookup, one update block, upsampling); the yuv420 decode bit
             for bit against the numpy reference; `python -m
             vpd_tpu_torch.tools.compute_flow` on 512 synthetic pairs with
             --model lk under raw, yuv420 and y8 and with --model raft,
             its PNGs read back against the same flow in this process,
             pairs/s and the upload packer that ran; `apply_vpd
             --upload_codec yuv420` at the slice phase's width from raw
             and from yuv420 shards (equal embeddings, B1's launches)
             beside the raw codec, crops/s

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

from vpd_tpu_torch.core.io import (store_embs_pickle, store_gz_json,
                                   store_pickle)
from vpd_tpu_torch.core.metrics import fetch_metrics
from vpd_tpu_torch.data import augment as aug
from vpd_tpu_torch.data import crops as crops_mod
from vpd_tpu_torch.data import native_loader
from vpd_tpu_torch.data import upload_codec as ucodec
from vpd_tpu_torch.data import vipe_sampler
from vpd_tpu_torch.data.crops import CropBatchSource
from vpd_tpu_torch.data.hbm_cache import CacheIndexSource, DeviceCropCache
from vpd_tpu_torch.data.shards import ShardReader, write_raw_shards
from vpd_tpu_torch.datasets.eval_splits import FS_TEST_PREFIXES
from vpd_tpu_torch.datasets.metadata_cache import load_meta_cache
from vpd_tpu_torch.datasets.recognition_data import (ACTION_DATA_DIR,
                                                     FS_CLASSES)
from vpd_tpu_torch.geometry.camera import random_project_offsets
from vpd_tpu_torch.infer import apply_vipe as av
from vpd_tpu_torch.infer import apply_vpd as ap
from vpd_tpu_torch.ops import _build
from vpd_tpu_torch.ops import dtw_kernel as dtwk
from vpd_tpu_torch.ops import flow as tflow
from vpd_tpu_torch.ops import preprocess as pre
from vpd_tpu_torch.ops.dtw import dtw_distance, pairwise_l2
from vpd_tpu_torch.tasks import neighbors as nb
from vpd_tpu_torch.tools import pack_crops as pack_cli
from vpd_tpu_torch.tools import recognize as recognize_cli
from vpd_tpu_torch.tools import train_vipe as vipe_cli
from vpd_tpu_torch.models import gru as tgru
from vpd_tpu_torch.models import raft as traft
from vpd_tpu_torch.models.fc import set_dropout_draw
from vpd_tpu_torch.tasks import detect as tdet
from vpd_tpu_torch.train import classifier as tcls
from vpd_tpu_torch.train import proposal as tprop
from vpd_tpu_torch.train import vipe as tvipe
from vpd_tpu_torch.train import vipe_loop as tvloop
from vpd_tpu_torch.train.fused_sweep import FusedSweepTrainer
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
TEACHER_EPOCHS = 2
TEACHER_BATCHES = (100, 4096)
TEACHER_STEPS = 20
TEACHER_SAMPLER_BATCHES = 50
TEACHER_CPU_ATOL = 1e-4    # float32 on the card (TF32 off) against the CPU
# the heads on frozen embeddings (no hand kernel): full width (hidden 128,
# depth-2 BiGRU, 32-d rows with flips, batch 50 / 100, 250-frame windows),
# depth in epochs cut from the CLIs' 500 (recognize) and 200 (detect)
HEADS_H, HEADS_B, HEADS_T = 128, 50, 128
HEADS_EPOCHS, HEADS_VAL_FREQ = 12, 4
HEADS_SHORT_EPOCHS = 3     # the lstm and cnn runs
HEADS_FUSED_M = 10         # the few-shot sweep's trials
HEADS_ROWS = 768           # a 64-shot trial: 6 classes x 64 x 2 flips
HEADS_CHECK = dict(members=3, epochs=3)  # fused against sequential
HEADS_RTOL, HEADS_ATOL = 2e-4, 2e-5      # tests/test_fused_sweep.py's bar
HEADS_F32_ATOL = 2e-4      # the same in float32: 3x its drift, 5.9e-5
HEADS_CPU_RTOL = 1e-5      # one step, float32 on the card against the CPU
HEADS_CPU_PARAM_ATOL = 2e-4  # its parameters: lr / 5, 4x the 4.6e-5 drift
PROPOSAL_B, PROPOSAL_T = 100, 250
DETECT_MEMBERS, DETECT_EPOCHS, DETECT_FRAMES = 3, 2, 1500
# optical flow (no hand kernel): compute_flow's defaults (batch 256, 20
# RAFT iterations, bf16) at the official basic widths on 128x128 pairs
FLOW_B, FLOW_ITERS = 256, 20
FLOW_TIMED = 5             # timed batches a model (CUDA events, median)
FLOW_CPU_PAIRS = 2
FLOW_CPU_ATOL = 1e-3       # f32 on the card (TF32 off) against the CPU
FLOW_CLI_PAIRS = 512
FLOW_PNG_EQUAL = 0.999     # PNG values equal to the in-process flow's


# the teacher's synthetic mocap corpus, in tools/paths' layout; the people
# of vpd_tpu's validation split (VAL_PEOPLE) come last: two for 3dpeople,
# whose pairwise sampler draws two people, one for the others
MOCAP_DIRS = {'human36m': 'human3.6m', '3dpeople': '3dpeople',
              'nba2k': 'nba2k', 'amass': 'amass'}
MOCAP_PEOPLE = {'human36m': ('S1', 'S5', 'S6', 'S9'),
                '3dpeople': ('man05', 'woman05', 'man01', 'woman01'),
                'nba2k': ('curry', 'james', 'durant', 'alfred'),
                'amass': ('CMU', 'KIT', 'BMLmovi', 'EyesJapanDataset')}
MOCAP_ACTIONS = ('walk', 'jump')  # nba2k keys by person alone
MOCAP_FRAMES, MOCAP_CAMERAS = 60, 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def _write_video_stub(path, fps=25., num_frames=3, dim=32):
    """A tiny real mp4, so that video metadata gives the corpus fps."""
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                         (dim, dim))
    if not vw.isOpened():
        raise RuntimeError('cv2 VideoWriter failed for ' + path)
    for _ in range(num_frames):
        vw.write(np.zeros((dim, dim, 3), np.uint8))
    vw.release()


def write_detect_corpus(root, rng, num_train=8, num_test=3, frames=1500,
                        emb_dim=EMB):
    """A synthetic fs corpus of whole videos for temporal detection, laid
    out as vpd_tpu's bench_pipeline_e2e.make_corpus lays one out (teacher
    embeddings only): action windows of 20-31 frames 24-39 frames apart,
    a class per window, rows (frame, (2, emb_dim) orig + flip, {}) of
    N(0, 0.3) noise with +3 on the class's axis inside a window; mp4 stubs
    at 25 fps under `<root>/sports/fs/videos`; all.txt, val.ids.txt and
    train.localize.{0,1}.txt under `<root>/action_dataset/fs`. Returns
    (emb_dir, action_dir, sports_dir, number of actions)."""
    test_prefix = 'men_olympic_short_program_2018'
    sports = os.path.join(root, 'sports')
    video_dir = os.path.join(sports, 'fs', 'videos')
    emb_dir = os.path.join(root, 'embs')
    label_dir = os.path.join(root, 'action_dataset', 'fs')
    for d in (video_dir, emb_dir, label_dir):
        os.makedirs(d, exist_ok=True)
    names = ['fs_train_video_{:02d}'.format(i) for i in range(num_train)]
    names += ['{}_v{:02d}'.format(test_prefix, i) for i in range(num_test)]
    actions = []
    for video in names:
        _write_video_stub(os.path.join(video_dir, video + '.mp4'))
        frame_cls = np.full(frames, -1, np.int64)
        cursor = int(25 * 2.5) + 12
        while cursor + 40 < frames:
            length = int(rng.integers(20, 32))
            cls = int(rng.integers(len(FS_CLASSES)))
            actions.append((video, cursor, cursor + length, cls))
            frame_cls[cursor:cursor + length] = cls
            cursor += length + int(rng.integers(24, 40))
        emb = rng.normal(0, 0.3, (frames, emb_dim))
        hit = np.flatnonzero(frame_cls >= 0)
        emb[hit, frame_cls[hit]] += 3.
        emb = np.stack([emb, emb + rng.normal(0, 0.05, emb.shape)], 1)
        store_embs_pickle(os.path.join(emb_dir, video + '.emb.pkl'),
                          [(f, e, {}) for f, e in enumerate(
                              emb.astype(np.float32))])
    ids = ['{}:{}:{}'.format(v, s, e) for v, s, e, _ in actions]
    with open(os.path.join(label_dir, 'all.txt'), 'w') as fp:
        fp.writelines('{} {}\n'.format(a, FS_CLASSES[c])
                      for a, (_, _, _, c) in zip(ids, actions))
    train = [a for a, (v, _, _, _) in zip(ids, actions)
             if not v.startswith(test_prefix)]
    with open(os.path.join(label_dir, 'val.ids.txt'), 'w') as fp:
        fp.writelines(a + '\n' for i, a in enumerate(train) if i % 5 == 4)
    for trial in range(2):
        order = list(rng.permutation(names[:num_train]))
        with open(os.path.join(label_dir, 'train.localize.{}.txt'.format(
                trial)), 'w') as fp:
            fp.writelines(v + '\n' for v in order)
    return emb_dir, os.path.dirname(label_dir), sports, len(actions)


def _mocap_frame_nums(family, n):
    """2D frame numbers whose 3D pose index (`FAMILIES[family].
    pose3d_index`) is 0..n-1."""
    if family == '3dpeople':
        return [i + 1 for i in range(n)]
    if family == 'amass':
        return [25 * i for i in range(n)]
    return list(range(n))


def write_mocap_corpus(root, rng, frames=MOCAP_FRAMES,
                       cameras=MOCAP_CAMERAS):
    """The four mocap families under `root` as the loaders read them:
    `<dir>/ground_truth_3d_pose.pkl` ({key: [(root, theta, (E, 3)
    offsets)] a frame}) and `<dir>/cocopose/*.json.gz`, one file a
    (person, action, camera) for human3.6m and one a sequence, every
    camera in it, for the others. Offsets are random bones (unit
    directions, lengths 0.1-0.3); each camera's 2D pose is a random
    synthetic projection of its frame. Returns the number of 2D poses."""
    n_poses = 0
    for family, dirname in MOCAP_DIRS.items():
        spec = vipe_sampler.FAMILIES[family].spec
        base = os.path.join(root, dirname)
        pose_dir = os.path.join(base, 'cocopose')
        os.makedirs(pose_dir)
        poses_3d = {}
        for person in MOCAP_PEOPLE[family]:
            for action in (MOCAP_ACTIONS if family != 'nba2k' else (None,)):
                key = (person,) if action is None else (person, action)
                shape = (frames, spec.num_edges)
                dirs = rng.normal(size=shape + (3,))
                dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
                offsets = (dirs * rng.uniform(0.1, 0.3, shape + (1,))).astype(
                    np.float32)
                poses_3d[key] = [(np.zeros(3, np.float32),
                                  float(rng.uniform(-180, 180)), offsets[i])
                                 for i in range(frames)]
                views = [[random_project_offsets(spec, offsets[i], rng)
                          .tolist() for _ in range(cameras)]
                         for i in range(frames)]
                n_poses += frames * cameras
                nums = _mocap_frame_nums(family, frames)
                if family == 'human36m':
                    for c in range(cameras):
                        store_gz_json(os.path.join(
                            pose_dir, '{}.{}.cam{}.json.gz'.format(
                                person, action, c)),
                            [[f, [[0.9, views[i][c]]]]
                             for i, f in enumerate(nums)])
                    continue
                name = {'3dpeople': '{}__{}', 'amass': '{}_{}'}.get(
                    family, '{}').format(person, action)
                store_gz_json(os.path.join(pose_dir, name + '.json.gz'),
                              [[f, [['cam{}'.format(c), [0.9, views[i][c]]]
                                    for c in range(cameras)]]
                               for i, f in enumerate(nums)])
        store_pickle(os.path.join(base, 'ground_truth_3d_pose.pkl'),
                     poses_3d)
    return n_poses


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


def _flops(module, fn):
    """Multiply-add flops of the convolutions and linears of `module`
    that `fn()` runs, from their output shapes."""
    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * \
                mod.kernel_size[1]
        else:
            k = mod.in_features
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def _encoder_flops(enc, x):
    """Multiply-add flops of one encoder call on `x`, from the shapes."""
    return _flops(enc, lambda: enc(x))


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


def _train_cli(args, env, tool='train_vpd'):
    """One `python -m vpd_tpu_torch.tools.<tool>` run: (seconds, the
    seconds of each epoch it printed)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'vpd_tpu_torch.tools.' + tool, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError('{} failed ({}): {}'.format(
            tool, proc.returncode, proc.stderr[-3000:]))
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


def _teacher_flops(model, batch):
    """Multiply-add flops of one train step of the teacher on `batch`
    (forward: three encoder passes, two decoder passes; backward twice
    the forward), from the shapes."""
    n = batch['pose1'].shape[0]
    enc = sum(2 * n * m.in_features * m.out_features
              for m in model.encoder.modules()
              if isinstance(m, torch.nn.Linear))
    head = model.decoder.head.kernel
    dec = sum(2 * n * m.in_features * m.out_features
              for m in model.decoder.modules()
              if isinstance(m, torch.nn.Linear)) + 2 * n * head.numel()
    return 3 * (3 * enc + 2 * dec)


def _teacher_step_on_card(mocap):
    """The teacher's train step at full width (vpd_tpu's defaults, the four
    3D families) on a ring of batches on the card, for each of
    TEACHER_BATCHES: median ms (CUDA events), rows/s on the host clock,
    peak memory, TFLOP/s against the float32 peak; and the sampler's host
    ms per batch of 100."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('the teacher runs in float32: TF32 must be off')
    samplers, shapes, norms = [], [], []
    for i, fam in enumerate(vipe_cli.DATASETS_3D):
        base = os.path.join(mocap, MOCAP_DIRS[fam])
        (seqs, _), poses = vipe_cli.LOADERS[fam][0](
            os.path.join(base, 'cocopose'),
            os.path.join(base, 'ground_truth_3d_pose.pkl'))
        family = vipe_sampler.FAMILIES[fam]
        samplers.append(vipe_sampler.VIPESampler(
            family, seqs, poses, target_len=family.train_target_len,
            seed=SEED + i))
        shapes.append((family.spec.num_edges, 7))
        norms.append(samplers[-1].mean_kp_offset_norms)
    batcher = vipe_sampler.FusedBatcher(samplers, 100)
    t0 = time.perf_counter()
    for _ in range(TEACHER_SAMPLER_BATCHES):
        batcher.next_batch()
    sampler_ms = (time.perf_counter() - t0) / TEACHER_SAMPLER_BATCHES * 1e3

    cfg = tvloop.default_config(vipe_cli.DATASETS_3D, shapes, norms)
    out = {'sampler_host_ms_per_batch_100': sampler_ms,
           'sampler_batches_timed': TEACHER_SAMPLER_BATCHES}
    for b in TEACHER_BATCHES:
        batcher = vipe_sampler.FusedBatcher(samplers, b)
        torch.manual_seed(SEED)
        model = tvloop.build_model(cfg, batcher.kp_dims).cuda()
        state = create_state(model, cfg['learning_rate'])
        step = tvipe.make_train_step(batcher.kp_mask())
        ring = [{k: torch.from_numpy(v).cuda() for k, v in
                 batcher.next_batch().items()} for _ in range(TRAIN_RING)]
        for i in range(TRAIN_WARMUP):
            step(state, ring[i % TRAIN_RING], SEED + 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks, metrics = [], []
        t0 = time.perf_counter()
        for i in range(TEACHER_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            metrics.append(step(state, ring[i % TRAIN_RING], SEED + 1))
            ev[1].record()
            marks.append(ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [m['loss_sum'] / m['n'] for m in fetch_metrics(metrics)]
        if not np.isfinite(losses).all():
            raise AssertionError('teacher step losses: {}'.format(losses))
        ms = statistics.median(a.elapsed_time(e) for a, e in marks)
        flops = _teacher_flops(model, ring[0])
        out['batch_{}'.format(batcher.batch_size)] = {
            'device_ms_per_step': ms,
            'host_ms_per_step': wall / TEACHER_STEPS * 1e3,
            'rows_per_s': batcher.batch_size * TEACHER_STEPS / wall,
            'peak_memory_GiB': torch.cuda.max_memory_allocated() / 2 ** 30,
            'gflop_per_step': flops / 1e9,
            'bound_ms': flops / F32_FLOPS_PER_S * 1e3,
            'tflops_per_s': flops / ms / 1e9,
            'losses': losses}
        del model, state, ring
    return out


def _write_teacher_poses(pose_dir, rng):
    """gz-JSON detections named after the train phase's corpus (video0..3,
    CLI_FRAMES frames), two on every third frame: (detections, frames)."""
    os.makedirs(pose_dir)
    dets = 0
    for v in range(CLI_VIDEOS):
        data = []
        for f in range(CLI_FRAMES):
            people = []
            for _ in range(2 if f % 3 == 0 else 1):
                kp = np.concatenate([rng.uniform(0, 200, (17, 2)),
                                     rng.uniform(0.3, 1, (17, 1))], axis=1)
                people.append([0.9, kp.tolist()])
            dets += len(people)
            data.append([f, people])
        store_gz_json(os.path.join(pose_dir, 'video{}.json.gz'.format(v)),
                      data)
    return dets


def _teacher_apply(save, root, rng):
    """`apply_vipe` on the card over the teacher's corpus of poses: rows/s,
    rows checked, and every row against the same teacher on the CPU."""
    pose_dir = os.path.join(root, 'poses')
    dets = _write_teacher_poses(pose_dir, rng)
    out = os.path.join(root, 'embs')
    t0 = time.perf_counter()
    av.apply_vipe(pose_dir, save, out, log=lambda *a: None)
    secs = time.perf_counter() - t0
    embs = _load_embs(out)
    for name, rows in embs.items():
        if [r[0] for r in rows] != list(range(CLI_FRAMES)) or any(
                e.shape != (2, EMB) or e.dtype != np.float32
                or not np.isfinite(e).all() for _, e, _ in rows):
            raise AssertionError('apply_vipe rows of {}'.format(name))
        if sum(m.get('is_mean', False) for _, _, m in rows) != \
                len(range(0, CLI_FRAMES, 3)):
            raise AssertionError('{}: frames with two detections not '
                                 'averaged'.format(name))
    av.apply_vipe(pose_dir, save, os.path.join(root, 'embs_cpu'),
                  device='cpu', log=lambda *a: None)
    ref = _load_embs(os.path.join(root, 'embs_cpu'))
    err = max(float(np.abs(a[1] - b[1]).max())
              for name in embs for a, b in zip(embs[name], ref[name]))
    if err > TEACHER_CPU_ATOL:
        raise AssertionError('apply_vipe on the card differs from the CPU '
                             'by {}'.format(err))
    x = np.stack([e[0] for _, e, _ in embs['video0']]).astype(np.float64)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x @ x.T
    return out, {'videos': len(embs), 'detections': dets,
                 'embedded_rows': 2 * dets, 'seconds': secs,
                 'rows_per_s': 2 * dets / secs,
                 'max_abs_diff_vs_cpu': err, 'atol': TEACHER_CPU_ATOL,
                 'mean_pairwise_cosine': float(
                     (c.sum() - np.trace(c)) / (len(x) * (len(x) - 1)))}


def phase_teacher(card, train):
    """The VIPE* teacher: train_vipe at full width on synthetic mocap (2
    epochs, --resume to 3), the step at B = 100 and 4096, the sampler,
    apply_vipe on the train corpus' videos, and one train_vpd epoch on the
    teacher's embeddings (ROADMAP C2 read on that student)."""
    rng = np.random.default_rng(SEED + 4)
    root = os.path.join(WORK, 'teacher')
    mocap = os.path.join(root, 'vipe')
    t0 = time.perf_counter()
    poses_2d = write_mocap_corpus(mocap, rng)
    corpus_s = time.perf_counter() - t0
    env = dict(os.environ, VPD_VIPE_DATA_DIR=mocap)
    save = os.path.join(root, 'run')
    common = ['--dataset', '3d', '--save_dir', save,
              '--checkpoint_frequency', '1', '--render_preview_frequency',
              '0']
    first = _train_cli(common + ['--num_epochs', str(TEACHER_EPOCHS)], env,
                       'train_vipe')
    resumed = _train_cli(common + ['--num_epochs', str(TEACHER_EPOCHS + 1),
                                   '--resume'], env, 'train_vipe')
    with open(os.path.join(save, 'loss.json')) as fp:
        losses = json.load(fp)
    if [r['epoch'] for r in losses] != list(range(1, TEACHER_EPOCHS + 2)) \
            or not np.isfinite([[r['train'], r['val']]
                                for r in losses]).all():
        raise AssertionError('train_vipe loss.json: {}'.format(losses))
    last = 'epoch{:04d}'.format(TEACHER_EPOCHS + 1)
    want = ['config.json', 'best_epoch.encoder.ckpt'] + [
        '{}.{}.ckpt'.format(last, c) for c in ('encoder', 'decoder-3d',
                                               'optimizer')]
    missing = [f for f in want if not os.path.exists(os.path.join(save, f))]
    if missing:
        raise AssertionError('train_vipe wrote no {}'.format(missing))
    with open(os.path.join(save, 'config.json')) as fp:
        cfg = json.load(fp)
    if (cfg['encoder_arch'], cfg['decoder_arch'], cfg['embedding_dim'],
            cfg['batch_size']) != ([2, 1024], [2, 512], EMB, 100):
        raise AssertionError('train_vipe config: {}'.format(cfg))

    step = _teacher_step_on_card(mocap)
    emb_dir, apply = _teacher_apply(save, root, rng)

    # the whole chain: a student epoch on the teacher's embeddings
    sports_env = dict(os.environ, VPD_SPORTS_DIR=train['sports'])
    student = os.path.join(root, 'student')
    student_run = _train_cli(
        ['fs', '--save_dir', student, '--emb_dir', emb_dir, '--crop_shards',
         train['shard_dir'], '--flow_img', 'flow', '--motion',
         '--checkpoint_frequency', '1', '--num_epochs', '1'], sports_env)
    with open(os.path.join(student, 'loss.json')) as fp:
        student_losses = json.load(fp)
    if not np.isfinite([student_losses[0]['train'],
                        student_losses[0]['val']]).all():
        raise AssertionError('train_vpd on the teacher: {}'.format(
            student_losses))
    c2 = _embedding_spread(student, train['shard_dir'],
                           os.path.join(train['sports'], 'fs', 'crops'),
                           os.path.join(root, 'student_embs'))
    per_epoch = 500 + 50  # batches of 100: 50,000 train + 5,000 val rows
    epoch_s = first[1] + resumed[1]
    emit({'phase': 'teacher', 'card': card,
          'mocap': {'families': len(MOCAP_DIRS), 'poses_2d': poses_2d,
                    'write_seconds': corpus_s},
          'cli': {'batch': 100, 'epochs': len(epoch_s),
                  'run_seconds': [first[0], resumed[0]],
                  'epoch_seconds': epoch_s,
                  'rows_per_s_per_epoch': [100 * per_epoch / s
                                           for s in epoch_s],
                  'losses': [[r['train'], r['val']] for r in losses]},
          'step': step, 'apply_vipe': apply,
          'student_on_teacher': {
              'run_seconds': student_run[0],
              'epoch_seconds': student_run[1],
              'losses': [student_losses[0]['train'],
                         student_losses[0]['val']],
              'c2': c2}})


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # also governs Conv1d
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _heads_cli(emb_dir, algorithm, shots, trials, epochs, out_dir=None,
               **kw):
    """The recognize CLI on cuda with a sequence head, as a user runs it
    (fused sweep by default): (accuracies, stats, seconds)."""
    stats = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        accs = recognize_cli.main(
            emb_dir=emb_dir, dataset='fs', out_dir=out_dir,
            algorithm=algorithm, num_train_examples=shots, norm=False, k=1,
            hidden_dim=HEADS_H, attn=True, target_fps=25, num_epochs=epochs,
            val_freq=HEADS_VAL_FREQ, n_trials=trials, no_test_flip=False,
            retrieve=False, device='cuda', stats=stats, **kw)
    for v in (a for t in accs.values() for a in t):
        if not np.isfinite(v):
            raise AssertionError('{}: non-finite accuracy'.format(algorithm))
    return accs, stats, time.perf_counter() - t0


def _head_flops(model, b, t, d):
    """Multiply-add flops of one forward of a SeqClassifier's members on
    (B, T, D) inputs: the RNN's projections and the dense layers."""
    m = model.out.kernel.shape[0]
    flops = 0
    for layer in model.rnn.layers:
        _, _, din, gh = layer.w_i.shape
        flops += 2 * 2 * b * t * (din + layer.hidden_dim) * gh
    flops += sum(2 * b * mod.kernel.shape[1] * mod.kernel.shape[2]
                 for mod in model.modules()
                 if isinstance(mod, tgru.MemberDense))
    return m * flops


def _step_timing(gen, members, rows, graphs=True):
    """The train epoch of `members` heads (SeqClassifier gru + attention at
    full width) on a pool of HEADS_T-bucket sequences on the card, each
    member on `rows` rows, its RNN in CUDA graphs (as the trainers run it)
    or eager: ms per step (CUDA events over an epoch), host ms per step,
    TFLOP/s of fwd + bwd; then the same epoch under
    set_sync_debug_mode('error')."""
    n = 2 * HEADS_ROWS
    lens = torch.randint(HEADS_T // 4, HEADS_T + 1, (n,), generator=gen)
    x = torch.randn(n, HEADS_T, FS_EMB, generator=gen) * (
        torch.arange(HEADS_T)[None, :, None] < lens[:, None, None])
    y = torch.arange(n) % 6
    pool = (x.cuda(), lens.cuda(), y.cuda())
    member_rows = [torch.randperm(n, generator=gen)[:rows].numpy()
                   for _ in range(members)]
    model = tcls.make_model('gru', FS_EMB, 6, HEADS_H, num_members=members,
                            use_attention=True).cuda()
    ep = tcls._Epochs(model, torch.device('cuda'), pool, member_rows,
                      HEADS_B, 500, 10, 1e-3, SEED)
    steps = -(-rows // HEADS_B)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with (tgru.graphed_rnn(model, (members, HEADS_B, HEADS_T, FS_EMB))
          if graphs else contextlib.nullcontext()):
        ep.run_epoch()                    # first epoch: allocations
        t0 = time.perf_counter()
        ev[0].record()
        sums = ep.device_epoch()
        ev[1].record()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / steps
        torch.cuda.set_sync_debug_mode('error')
        try:
            sums2 = ep.device_epoch()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    losses = torch.cat([sums[0], sums2[0]]).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('head step losses {}'.format(losses))
    flops = 3 * _head_flops(model, HEADS_B, HEADS_T, FS_EMB)
    return {'members': members, 'rows': rows, 'cuda_graphs': graphs,
            'steps_per_epoch': steps,
            'device_ms_per_step': ms, 'host_ms_per_step': host_ms,
            'gflop_per_step': flops / 1e9,
            'f32_bound_ms': flops / F32_FLOPS_PER_S * 1e3,
            'tflops_per_s': flops / ms / 1e9, 'no_host_sync_epoch': True}


def _birnn_vs_cudnn(gen):
    """BiRNN (depth 2, gru) forward and forward + backward at B = 50,
    T = 128, H = 128 beside cuDNN's nn.GRU over pack_padded_sequence with
    the same weights (the yardstick), and the two held to each other."""
    model = tcls.make_model('gru', FS_EMB, 6, HEADS_H).cuda()
    rnn = model.rnn
    gru = torch.nn.GRU(FS_EMB, HEADS_H, num_layers=2, bidirectional=True,
                       batch_first=True).cuda()
    with torch.no_grad():
        for li, layer in enumerate(rnn.layers):
            for d, sfx in enumerate(('', '_reverse')):
                for name, t in (('weight_ih', layer.w_i[0, d].T),
                                ('weight_hh', layer.w_h[0, d].T),
                                ('bias_ih', layer.b_i[0, d]),
                                ('bias_hh', layer.b_h[0, d])):
                    getattr(gru, '{}_l{}{}'.format(name, li, sfx)).copy_(t)
    lens = torch.randint(HEADS_T // 4, HEADS_T + 1, (HEADS_B,),
                         generator=gen)
    lens[0] = HEADS_T
    x = (torch.randn(HEADS_B, HEADS_T, FS_EMB, generator=gen)
         * (torch.arange(HEADS_T)[None, :, None] < lens[:, None, None]))
    xd, ld = x.cuda()[None], lens.cuda()[None]

    def ours():
        out, last = rnn(xd, ld)
        return out[0], last[0]

    def cudnn():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            xd[0], lens, batch_first=True, enforce_sorted=False)
        out, h = gru(packed)
        out = torch.nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=HEADS_T)[0]
        return out, h

    with _no_tf32(), torch.no_grad():
        a, b = ours(), cudnn()
        err = max(float((a[0] - b[0]).abs().max()),
                  float((a[1] - b[1]).abs().max()))
    if err > 1e-4:
        raise AssertionError('BiRNN and cuDNN GRU differ by {}'.format(err))

    def fwd_bwd(fn):
        def run():
            out, last = fn()
            (out.sum() + last.sum()).backward()
        return run

    with _no_tf32():  # float32 both: cuDNN would take TF32 otherwise
        with torch.no_grad():
            times = {'ours_fwd_ms': cuda_ms(ours, iters=10),
                     'cudnn_fwd_ms': cuda_ms(cudnn, iters=10)}
        times['ours_fwd_bwd_ms'] = cuda_ms(fwd_bwd(ours), iters=10)
        times['cudnn_fwd_bwd_ms'] = cuda_ms(fwd_bwd(cudnn), iters=10)
    flops = 2 * 2 * HEADS_B * HEADS_T * 3 * HEADS_H * (
        FS_EMB + HEADS_H + 2 * HEADS_H + HEADS_H)
    times.update(max_abs_diff=err, gflop_fwd=flops / 1e9,
                 f32_bound_fwd_ms=flops / F32_FLOPS_PER_S * 1e3,
                 tflops_per_s_fwd_bwd=3 * flops / times['ours_fwd_bwd_ms']
                 / 1e9)
    return times


def _pool(rng, n, d=FS_EMB, classes=6):
    protos = rng.normal(0, 1, (classes, d))
    X = [(protos[i % classes] + rng.normal(0, .5, (int(rng.integers(
        20, 61)), d))).astype(np.float32) for i in range(n)]
    return X, np.arange(n) % classes


def _fused_vs_sequential(rng):
    """HEADS_CHECK members of the fused sweep on the card against
    sequential trainers on the card, in float64 (held to HEADS_RTOL /
    HEADS_ATOL) and in float32 with TF32 off, the CLI's dtype (held to
    HEADS_RTOL / HEADS_F32_ATOL: cuBLAS sums a batch of M products in
    another order than one, and AdamW turns a gradient's last bits into a
    step's, so float32 runs drift apart by a few ulps a step)."""
    X, y = _pool(rng, 96)
    Xv, yv = _pool(rng, 24)
    rows = [np.arange(96), np.arange(60), np.arange(24, 96)]
    kw = dict(hidden_dim=HEADS_H, batch_size=HEADS_B,
              num_epochs=HEADS_CHECK['epochs'], min_epochs=0, val_freq=1,
              X_val=Xv, y_val=yv, use_attention=True, device='cuda',
              bucket_floor=max(map(len, X + Xv)))
    out = {'members': len(rows), 'epochs': HEADS_CHECK['epochs'],
           'rtol': HEADS_RTOL, 'atol': HEADS_ATOL}
    with _no_tf32():
        for dtype in (torch.float64, torch.float32):
            fused = FusedSweepTrainer('gru', X, y, rows, dtype=dtype, **kw)
            err = 0.
            for m, r in enumerate(rows):
                seq = _flat(tcls.SeqModelTrainer(
                    'gru', [X[i] for i in r], y[r], dtype=dtype,
                    **kw).variables())
                got = _flat(dict(zip(('params', 'batch_stats'),
                                     fused.member(m))))
                atol = HEADS_ATOL if dtype == torch.float64 else \
                    HEADS_F32_ATOL
                for k, want in seq.items():
                    np.testing.assert_allclose(got[k], want, rtol=HEADS_RTOL,
                                               atol=atol, err_msg=str(k))
                    err = max(err, float(np.abs(got[k] - want).max()))
            out['max_abs_diff_' + str(dtype).split('.')[1]] = err
    out['f32_atol'] = HEADS_F32_ATOL
    return out


def _ensemble_fused_vs_sequential(rng):
    """The detect CLI's `--sequential_ensemble` against its fused
    default on the card (TF32 off): DETECT_MEMBERS KFold members of
    EnsembleProposal at full width (hidden HEADS_H, FS_EMB-d frames),
    trained one by one and as one batch, each RNN in CUDA graphs as the
    trainers run it; weights and per-frame scores held in float64 to
    HEADS_RTOL / HEADS_ATOL, scores in float32 to HEADS_RTOL /
    HEADS_F32_ATOL."""
    X, y = [], []
    for _ in range(8):
        x = rng.normal(0, 0.3, (300, FS_EMB)).astype(np.float32)
        vy = np.zeros(300, np.int32)
        for start in range(30, 260, 70):
            x[start:start + 20] += 1.0
            vy[start:start + 20] = 1
        X.append(x)
        y.append(vy)
    kw = dict(hidden_dim=HEADS_H, ensemble_size=DETECT_MEMBERS, seed=3,
              batch_size=16, num_epochs=3, min_epochs=1, seq_len=64,
              samples_per_epoch=64, device='cuda')
    out = {'members': DETECT_MEMBERS, 'f32_atol': HEADS_F32_ATOL}
    with _no_tf32():
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split('.')[1]
            fused = tprop.EnsembleProposal('gru', X, y, fused=True,
                                           dtype=dtype, **kw)
            seq = tprop.EnsembleProposal('gru', X, y, fused=False,
                                         dtype=dtype, **kw)
            a, b = fused.model.state_dict(), seq.model.state_dict()
            if sorted(a) != sorted(b):
                raise AssertionError('ensemble state keys differ')
            atol = HEADS_ATOL if dtype == torch.float64 else HEADS_F32_ATOL
            if dtype == torch.float64:
                for k in a:
                    np.testing.assert_allclose(
                        a[k].cpu().numpy(), b[k].cpu().numpy(),
                        rtol=HEADS_RTOL, atol=HEADS_ATOL, err_msg=k)
            out['param_max_abs_diff_' + name] = max(
                float((a[k] - b[k]).abs().max()) for k in a)
            got, want = (e.predict_n(X[0], X[0][:, ::-1].copy())
                         for e in (fused, seq))
            np.testing.assert_allclose(got, want, rtol=HEADS_RTOL,
                                       atol=atol)
            out['score_max_abs_diff_' + name] = float(
                np.abs(got - want).max())
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _step_cuda_vs_cpu(gen):
    """One train step (dropout 0, input batch norm on, a partial batch) on
    the card against the same step on the CPU, TF32 off."""
    cpu = tcls.make_model('gru', FS_EMB, 6, HEADS_H, use_attention=True,
                          input_batchnorm=True, dropout=0.,
                          input_dropout=0.)
    card = copy.deepcopy(cpu).cuda()
    lens = torch.randint(10, HEADS_T + 1, (1, HEADS_B), generator=gen)
    x = torch.randn(1, HEADS_B, HEADS_T, FS_EMB, generator=gen) * (
        torch.arange(HEADS_T)[None, None, :, None] < lens[..., None, None])
    y = torch.arange(HEADS_B)[None] % 6
    valid = torch.arange(HEADS_B)[None] < HEADS_B - 7
    scalars = torch.tensor([[1e-3], [0.01], [1 - 0.9], [1 - 0.999], [1.]])
    out = {}
    with _no_tf32():
        for name, model in (('cpu', cpu), ('cuda', card)):
            dev = next(model.parameters()).device
            loss, _ = tcls.train_step(
                model, tcls.StackedAdamW(model.parameters()), x.to(dev),
                lens.to(dev), y.to(dev), valid.to(dev), scalars.to(dev))
            out[name] = (float(loss[0]), {k: v.cpu() for k, v in
                                          model.state_dict().items()})
    loss_rel = abs(out['cuda'][0] - out['cpu'][0]) / abs(out['cpu'][0])
    param_err, stat_err = 0., 0.
    for k, v in out['cpu'][1].items():
        d = float((out['cuda'][1][k] - v).abs().max())
        if 'running' in k:
            stat_err = max(stat_err, d / max(float(v.abs().max()), 1e-6))
        else:
            param_err = max(param_err, d)
    if loss_rel > HEADS_CPU_RTOL or stat_err > HEADS_CPU_RTOL or \
            param_err > HEADS_CPU_PARAM_ATOL:
        raise AssertionError('head step cuda vs cpu: loss {} stats {} '
                             'params {}'.format(loss_rel, stat_err,
                                                param_err))
    return {'loss_rel_diff': loss_rel, 'stats_rel_diff': stat_err,
            'param_max_abs_diff': param_err,
            'param_atol': HEADS_CPU_PARAM_ATOL, 'lr': 1e-3}


def _proposal_timing(gen):
    """The proposal step at B = 100, T = 250 (1 and DETECT_MEMBERS
    members; the RNN in CUDA graphs, as the trainer runs it, and the
    ensemble's without) and the ensemble's per-video predict
    (DETECT_FRAMES frames, orig + flip)."""
    out = {}
    for m, graphs in ((1, True), (DETECT_MEMBERS, True),
                      (DETECT_MEMBERS, False)):
        model = tprop.ProposalSeq('gru', FS_EMB, HEADS_H,
                                  num_members=m).cuda()
        opt = tcls.StackedAdamW(model.parameters())
        x = torch.randn(m, PROPOSAL_B, PROPOSAL_T, FS_EMB,
                        generator=gen).cuda()
        y = (torch.rand(m, PROPOSAL_B, PROPOSAL_T, generator=gen)
             < 0.3).long().cuda()
        lengths = torch.full((m, PROPOSAL_B), PROPOSAL_T,
                             device='cuda')
        one = torch.ones(m, device='cuda')
        live = one > 0
        gens = [torch.Generator(device='cuda').manual_seed(i)
                for i in range(m)]
        set_dropout_draw(model.train(), tgru.member_dropout_draw(gens))
        with (tgru.graphed_rnn(model, (m, PROPOSAL_B, PROPOSAL_T, FS_EMB))
              if graphs else contextlib.nullcontext()):
            ms = cuda_ms(lambda: tprop.proposal_step(
                model, opt, x, lengths, y, 1e-3 * one, 0.01 * one,
                torch.stack([0.1 * one, 1e-3 * one]), live), iters=5,
                warmup=2)
        set_dropout_draw(model, None)
        flops = 3 * m * (
            sum(2 * 2 * PROPOSAL_B * PROPOSAL_T * (
                layer.w_i.shape[2] + layer.hidden_dim) * layer.w_i.shape[3]
                for layer in model.rnn.layers)
            + 2 * PROPOSAL_B * PROPOSAL_T * 2 * HEADS_H * (2 * HEADS_H + 2))
        out['members_{}{}'.format(m, '' if graphs else '_eager')] = {
            'device_ms_per_step': ms, 'gflop_per_step': flops / 1e9,
            'f32_bound_ms': flops / F32_FLOPS_PER_S * 1e3,
            'tflops_per_s': flops / ms / 1e9}
    video = np.random.default_rng(SEED).normal(
        size=(DETECT_FRAMES, FS_EMB)).astype(np.float32)
    variants = [video, video[:, ::-1].copy()]
    tprop.ensemble_scores(model, variants)
    t0 = time.perf_counter()
    scores = tprop.ensemble_scores(model, variants)
    out['ensemble_predict_s_per_video'] = time.perf_counter() - t0
    out['ensemble_predict_frames'] = DETECT_FRAMES
    if scores.shape != (DETECT_MEMBERS, 2, DETECT_FRAMES) or \
            not np.isfinite(scores).all():
        raise AssertionError('ensemble scores {}'.format(scores.shape))
    return out


def _detect_cli(root, rng):
    """tools/detect on fs_jump over a synthetic whole-video corpus (fused
    ensemble of DETECT_MEMBERS, DETECT_EPOCHS epochs) in a subprocess with
    VPD_SPORTS_DIR set; its AP table against random scores' table."""
    emb_dir, action_dir, sports, n_actions = write_detect_corpus(
        root, rng, frames=DETECT_FRAMES)
    out = os.path.join(root, 'detect')
    secs, _ = _train_cli(
        ['fs_jump', '--emb_dir', emb_dir, '-o', out, '--action_dir',
         action_dir, '-k', str(DETECT_MEMBERS), '--loc_epochs',
         str(DETECT_EPOCHS)], dict(os.environ, VPD_SPORTS_DIR=sports),
        'detect')
    ap = np.load(os.path.join(out, 'ap_table.npy'))
    # chance: the same evaluation over uniform random scores
    labels = []
    with open(os.path.join(action_dir, 'fs', 'all.txt')) as fp:
        for line in fp:
            video, start, end = line.split()[0].split(':')
            labels.append(tdet.Label(video, 'action', int(start), int(end),
                                     25.))
    test = [l for l in labels if l.video.startswith(FS_TEST_PREFIXES)]
    train = [l for l in labels if l not in test]
    mean_len = np.mean([l.end_frame - l.start_frame for l in train])
    thresholds = np.linspace(0.1, 0.9, 9)
    chance = tdet.evaluate_proposals(
        [(v, rng.random(DETECT_FRAMES)) for v in sorted({
            l.video for l in test})],
        tdet.get_video_intervals(test), thresholds,
        0.67 * np.ceil(mean_len), 1.33 * np.ceil(mean_len))
    if ap.shape != (9, 9) or not np.isfinite(ap).all() or \
            ap.max() <= chance.max():
        raise AssertionError('detect AP table max {} vs chance {}'.format(
            ap.max(), chance.max()))
    return {'actions': n_actions, 'frames_per_video': DETECT_FRAMES,
            'members': DETECT_MEMBERS, 'epochs': DETECT_EPOCHS,
            'seconds': secs, 'ap_max': float(ap.max()),
            'ap_at_tiou_0.5_max': float(ap[:, 4].max()),
            'chance_ap_max': float(chance.max())}


def phase_heads(card):
    """The learned heads on frozen embeddings (no hand kernel): the
    recognize CLI with sequence heads on the recognize phase's fs corpus,
    fused against sequential on the card (the sweep and the proposal
    ensemble), a step on cuda against the CPU, no host sync inside an
    epoch, timings, and the detect CLI."""
    emb_dir = os.path.join(WORK, 'fs_embs')
    if not os.path.isdir(emb_dir):
        os.makedirs(emb_dir)
        _write_fs_corpus(emb_dir, np.random.default_rng(SEED))
    t0 = time.perf_counter()
    runs = {}
    runs['few_shot'] = _heads_cli(emb_dir, 'gru', FS_SHOTS, FS_TRIALS,
                                  HEADS_EPOCHS)
    out = os.path.join(WORK, 'heads_full')
    runs['full'] = _heads_cli(emb_dir, 'gru', [-1], 1, HEADS_EPOCHS,
                              out_dir=out)
    full_acc = runs['full'][0][-1][0]
    if full_acc < FS_ACC_BAR:
        raise AssertionError('gru full-data accuracy {} < {}'.format(
            full_acc, FS_ACC_BAR))
    if not all(runs['few_shot'][1]['fused'].values()):
        raise AssertionError('few-shot sizes not fused: {}'.format(
            runs['few_shot'][1]['fused']))
    csv_name = 'trial0_full_gru.test_pred.csv'
    out_w = os.path.join(WORK, 'heads_w')
    runs['load_weights'] = _heads_cli(
        emb_dir, 'gru', [-1], 1, HEADS_EPOCHS, out_dir=out_w,
        load_weights=os.path.join(out, 'trial0_full_gru.model.ckpt'))
    with open(os.path.join(out, csv_name), 'rb') as a, \
            open(os.path.join(out_w, csv_name), 'rb') as b:
        if a.read() != b.read():
            raise AssertionError('-w gives another test_pred.csv')
    for alg in ('lstm', 'cnn'):
        runs[alg] = _heads_cli(emb_dir, alg, [16], FS_TRIALS,
                               HEADS_SHORT_EPOCHS)
    cli_s = time.perf_counter() - t0

    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED + 5)
    fused_check = _fused_vs_sequential(rng)
    ensemble_check = _ensemble_fused_vs_sequential(rng)
    cpu_check = _step_cuda_vs_cpu(gen)
    steps = {'fused': _step_timing(gen, HEADS_FUSED_M, HEADS_ROWS),
             'sequential': _step_timing(gen, 1, HEADS_ROWS),
             'fused_eager': _step_timing(gen, HEADS_FUSED_M, HEADS_ROWS,
                                         graphs=False)}
    birnn = _birnn_vs_cudnn(gen)
    proposal = _proposal_timing(gen)
    detect = _detect_cli(os.path.join(WORK, 'detect'), rng)
    emit({'phase': 'heads', 'card': card,
          'recognize_cli': {
              name: {'mean_accuracy': {ne: float(np.mean(a))
                                       for ne, a in r[0].items()},
                     'seconds': r[2],
                     'train_seconds': r[1].get('train_seconds'),
                     'predict_seconds': r[1].get('predict_seconds'),
                     'fused': r[1].get('fused')}
              for name, r in runs.items()},
          'epochs': {'gru': HEADS_EPOCHS, 'lstm_cnn': HEADS_SHORT_EPOCHS,
                     'val_freq': HEADS_VAL_FREQ},
          'cli_seconds': cli_s, 'full_accuracy': full_acc,
          'load_weights_same_csv': True,
          'fused_vs_sequential': fused_check,
          'ensemble_fused_vs_sequential': ensemble_check,
          'step_cuda_vs_cpu': cpu_check,
          'step': steps, 'birnn_vs_cudnn': birnn, 'proposal': proposal,
          'detect_cli': detect})


# ------------------------------------------------------------------- flow

def _flow_scene(rng, b, size=IMG):
    """Textured uint8 RGB pairs (B, S, S, 3): bilinear-upsampled 16x16
    noise, the second frame moved by a random shift of up to 4 px."""
    import cv2
    one, two = [], []
    for _ in range(b):
        img = cv2.resize(rng.integers(0, 256, (size // 8, size // 8, 3),
                                      np.uint8), (size, size),
                         interpolation=cv2.INTER_CUBIC)
        dy, dx = rng.integers(-4, 5, 2)
        one.append(img)
        two.append(np.roll(np.roll(img, dy, axis=0), dx, axis=1))
    return np.stack(one), np.stack(two)


def _raft_parts_ms(model, im1, im2, dt):
    """CUDA-event ms of one forward's parts at its real shapes: the three
    encoder passes, the correlation pyramid, one lookup, one update block
    and the upsampling."""
    b = im1.shape[0]
    out = {}
    with torch.inference_mode():
        def prep(img):
            return (2. * (img.float() / 255.) - 1.).permute(
                0, 3, 1, 2).to(dt)
        x1, x2 = prep(im1), prep(im2)
        both = torch.cat([x1, x2])
        out['encoders'] = cuda_ms(lambda: (model.fnet(both), model.cnet(x1)),
                                  iters=5)
        fmaps, cnet = model.fnet(both), model.cnet(x1)
        f1, f2 = (f.permute(0, 2, 3, 1) for f in (fmaps[:b], fmaps[b:]))
        out['corr_pyramid'] = cuda_ms(lambda: traft.corr_pyramid(f1, f2),
                                      iters=5)
        pyramid = traft.corr_pyramid(f1, f2)
        net = torch.tanh(cnet[:, :model.hidden_dim])
        inp = torch.relu(cnet[:, model.hidden_dim:])
        coords = traft.coords_grid(b, f1.shape[1], f1.shape[2],
                                   device=im1.device)
        coords = coords + torch.randn_like(coords)
        out['lookup'] = cuda_ms(
            lambda: traft.corr_lookup(pyramid, coords, model.corr_radius),
            iters=5)
        corr = traft.corr_lookup(pyramid, coords, model.corr_radius)
        corr = corr.permute(0, 3, 1, 2).to(dt)
        flow = torch.zeros((b, 2) + corr.shape[2:], device=im1.device,
                           dtype=dt)
        out['update'] = cuda_ms(
            lambda: model.update_block(net, inp, corr, flow), iters=5)
        _, mask, _ = model.update_block(net, inp, corr, flow)
        flow = flow.permute(0, 2, 3, 1).float()
        out['upsample'] = cuda_ms(lambda: traft.upsample_flow_convex(
            flow, mask.permute(0, 2, 3, 1)), iters=5)
    return out


def _raft_on_card(rng):
    """RAFT at full width: f32 against the CPU, bf16 against f32, the
    timed forwards at batch 256 and their parts, peak memory."""
    model = traft.build_raft(seed=SEED).cuda()
    small = traft.build_raft(small=True, seed=SEED).cuda()
    a, b = _flow_scene(rng, FLOW_B)
    im1, im2 = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    out = {}

    # f32 on the card (TF32 off) against the CPU on a few pairs
    cpu_model = traft.build_raft(seed=SEED)
    c1, c2 = (torch.from_numpy(x[:FLOW_CPU_PAIRS]) for x in (a, b))
    with _no_tf32(), torch.inference_mode():
        for iters in (3, FLOW_ITERS):
            ref = cpu_model(c1, c2, iters=iters)
            got = model(c1.cuda(), c2.cuda(), iters=iters).cpu()
            out['f32_vs_cpu_max_abs_{}_iters'.format(iters)] = float(
                (got - ref).abs().max())
    if not out['f32_vs_cpu_max_abs_3_iters'] <= FLOW_CPU_ATOL:
        raise AssertionError('RAFT f32 on the card against the CPU: {} '
                             '(bar {})'.format(
                                 out['f32_vs_cpu_max_abs_3_iters'],
                                 FLOW_CPU_ATOL))

    fns = {'raft_bf16': traft.raft_flow_fn(model, FLOW_ITERS,
                                           torch.bfloat16),
           'raft_f32': traft.raft_flow_fn(model, FLOW_ITERS),
           'raft_small_bf16': traft.raft_flow_fn(small, FLOW_ITERS,
                                                 torch.bfloat16),
           'lk': tflow.lucas_kanade_flow}
    flows = {name: fn(im1, im2) for name, fn in fns.items()}
    for name, f in flows.items():
        if f.shape != (FLOW_B, IMG, IMG, 2) or not torch.isfinite(f).all():
            raise AssertionError('{}: bad flow {}'.format(name, f.shape))
    epe = (flows['raft_bf16'] - flows['raft_f32']).norm(dim=-1)
    out['bf16_vs_f32_epe_mean'] = float(epe.mean())
    out['bf16_vs_f32_epe_max'] = float(epe.max())
    out['flow_magnitude_mean_f32'] = float(
        flows['raft_f32'].norm(dim=-1).mean())
    # LK: the card against the CPU (no parity bar on the card; textured)
    with torch.inference_mode():
        lk_cpu = tflow.lucas_kanade_flow(c1, c2)
    out['lk_vs_cpu_max_abs'] = float(
        (flows['lk'][:FLOW_CPU_PAIRS].cpu() - lk_cpu).abs().max())
    del flows, epe

    for name, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fn(im1, im2), iters=FLOW_TIMED, warmup=1)
        out[name] = {'ms_per_batch': ms,
                     'pairs_per_s': FLOW_B / ms * 1e3,
                     'peak_memory_gib':
                         torch.cuda.max_memory_allocated() / 2**30}
    for name, net in (('raft_bf16', model), ('raft_small_bf16', small)):
        flops = _flops(net, lambda: fns[name](im1, im2))
        f = FLOW_B * (IMG // 8) ** 4 * (256 if net is model else 128) * 2
        out[name]['gflop_per_pair'] = (flops + f) / FLOW_B / 1e9
        out[name]['tflops_per_s'] = (flops + f) / out[name][
            'ms_per_batch'] / 1e9
        out[name]['share_of_bf16_peak'] = out[name]['tflops_per_s'] * 1e12 \
            / BF16_FLOPS_PER_S
    parts = _raft_parts_ms(model, im1, im2, torch.bfloat16)
    loop = FLOW_ITERS * (parts['lookup'] + parts['update'])
    out['raft_bf16']['parts_ms'] = parts
    out['raft_bf16']['update_loop_ms'] = loop
    out['raft_bf16']['update_loop_share'] = loop / (
        loop + parts['encoders'] + parts['corr_pyramid'] + parts['upsample'])
    return out


def _flow_cli(root, name, *args):
    """`python -m vpd_tpu_torch.tools.compute_flow` on the pair tree:
    (pairs/s over its pipeline as it printed, seconds with process start,
    the packer line it printed)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'vpd_tpu_torch.tools.compute_flow', root,
         '--out_name', name, *args], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError('compute_flow {} failed ({}): {}'.format(
            args, proc.returncode, proc.stderr[-3000:]))
    lines = proc.stdout.splitlines()
    timing = [ln for ln in lines if ln.endswith(' s') and 'pairs in' in ln]
    n, pipe_s = timing[0].split(' pairs in ')
    packer = [ln.split(': ', 1)[1] for ln in lines
              if ln.startswith('upload packer batches')]
    return {'pairs': int(n), 'pipeline_s': float(pipe_s[:-2]),
            'pairs_per_s': int(n) / float(pipe_s[:-2]),
            'seconds_with_start': secs,
            'packer_batches': packer[0] if packer else None}


def _cli_on_card(rng):
    """The compute_flow CLI over a tree of FLOW_CLI_PAIRS pairs (4 videos),
    with `--model lk` under raw, yuv420 and y8 and with `--model raft`;
    every PNG read back against the same flow computed in this process."""
    import cv2
    root = os.path.join(WORK, 'flow_pairs')
    a, b = _flow_scene(rng, FLOW_CLI_PAIRS)
    prefixes = []
    for i in range(FLOW_CLI_PAIRS):
        d = os.path.join(root, 'video{}'.format(i % 4))
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, str(i // 4))
        cv2.imwrite(p + '.prev.png', np.ascontiguousarray(a[i][..., ::-1]))
        cv2.imwrite(p + '.png', np.ascontiguousarray(b[i][..., ::-1]))
        prefixes.append(p)
    order = sorted(range(FLOW_CLI_PAIRS), key=lambda i: prefixes[i])
    raft = traft.raft_flow_fn(traft.build_raft(seed=SEED).cuda(),
                              FLOW_ITERS, torch.bfloat16)
    runs = {'lk_raw': ([], tflow.lucas_kanade_flow, None),
            'lk_yuv420': (['--upload_codec', 'yuv420'],
                          tflow.lucas_kanade_flow, 'yuv420'),
            'lk_y8': (['--upload_codec', 'y8'], tflow.lucas_kanade_flow_gray,
                      'y8'),
            'raft': (['--model', 'raft', '--raft_iters', str(FLOW_ITERS)],
                     raft, None)}
    out = {}
    for name, (args, fn, codec) in runs.items():
        res = _flow_cli(root, name, *args)
        qfn = tflow.make_quantized_flow_fn(fn)
        diff_max, equal = 0, 0
        for s in range(0, FLOW_CLI_PAIRS, FLOW_B):
            idx = order[s:s + FLOW_B]
            x1, x2 = a[idx], b[idx]
            if codec == 'yuv420':
                x1, x2 = (ucodec.decode_yuv420(torch.from_numpy(
                    ucodec.encode_yuv420_numpy(x)).cuda(), IMG, IMG)
                    for x in (x1, x2))
            elif codec == 'y8':
                x1, x2 = (torch.from_numpy(ucodec.encode_luma(x).reshape(
                    -1, IMG, IMG)).cuda() for x in (x1, x2))
            else:
                x1, x2 = torch.from_numpy(x1).cuda(), torch.from_numpy(
                    x2).cuda()
            want = qfn(x1, x2).cpu().numpy().astype(int)
            got = np.stack([cv2.imread('{}.{}.png'.format(
                prefixes[i], name), cv2.IMREAD_UNCHANGED) for i in idx])
            if not (got[..., 2] == 128).all():
                raise AssertionError('{}: third channel not 128'.format(name))
            d = np.abs(got[..., :2].astype(int) - want)
            diff_max = max(diff_max, int(d.max()))
            equal += int((d == 0).sum())
        res['png_max_step_vs_in_process'] = diff_max
        res['png_equal_share'] = equal / (FLOW_CLI_PAIRS * IMG * IMG * 2)
        if diff_max > 1 or res['png_equal_share'] < FLOW_PNG_EQUAL:
            raise AssertionError('{}: PNGs against the in-process flow: max '
                                 'step {}, equal {}'.format(
                                     name, diff_max, res['png_equal_share']))
        out[name] = res
    out['packer_here'] = ('native' if ucodec._native_packer(
        'vpd_yuv420_pack') else 'numpy (the native library does not build '
        'on this host)')
    # the host's share: one thread's PNG decode of a frame and level-9
    # encode of an LK payload (the CLI encodes in 8 threads)
    paths = [prefixes[i] + '.png' for i in order[:64]]
    t0 = time.perf_counter()
    crops_mod.decode_crop_batch(paths, IMG)
    out['png_decode_ms_per_frame'] = (time.perf_counter() - t0) / len(
        paths) * 1e3
    payloads = [cv2.imread(p[:-len('.png')] + '.lk_raw.png',
                           cv2.IMREAD_UNCHANGED) for p in paths]
    t0 = time.perf_counter()
    for img in payloads:
        cv2.imencode('.png', img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    out['png_encode_ms_per_lk_payload_level9'] = \
        (time.perf_counter() - t0) / len(paths) * 1e3
    shutil.rmtree(root)
    return out


def _yuv420_shards(raw_dir, out_dir):
    """The yuv420 shards `pack_crops --codec yuv420` writes for the crops
    of the raw shards in `raw_dir`: each rgb stream through
    `encode_yuv420`, flow and index as they are."""
    reader = ShardReader(raw_dir)
    os.makedirs(out_dir)
    for sid, rgb in enumerate(reader._rgb):
        base = 's{:04d}'.format(sid)
        ucodec.encode_yuv420_numpy(np.asarray(rgb)).tofile(
            os.path.join(out_dir, base + '.rgb'))
        shutil.copyfile(os.path.join(raw_dir, base + '.flow'),
                        os.path.join(out_dir, base + '.flow'))
    shutil.copyfile(os.path.join(raw_dir, 'shards_index.pkl'),
                    os.path.join(out_dir, 'shards_index.pkl'))
    meta = dict(reader.meta, codec='yuv420')
    with open(os.path.join(out_dir, 'shards_meta.json'), 'w') as fp:
        json.dump(meta, fp, indent=2)


def _yuv420_extraction():
    """`apply_vpd --upload_codec yuv420` at the slice phase's width (the
    flow student, 1,200 crops, batch 512) from raw shards (the host packs)
    and from yuv420 shards, beside the raw codec; B1's launches counted
    over the two yuv420 runs."""
    crop_dir = os.path.join(WORK, 'crops')
    student = os.path.join(WORK, 'student_flow')
    prepared = ap.load_student_dir(student)
    raw_dir, yuv_dir = (os.path.join(WORK, d) for d in ('shards',
                                                        'shards_yuv420'))
    _yuv420_shards(raw_dir, yuv_dir)
    readers = {d: ShardReader(d, crop_root=crop_dir)
               for d in (raw_dir, yuv_dir)}
    keys = [(v, f) for v in range(VIDEOS) for f in range(FRAMES)]
    tasks = [(v, f, os.path.join(crop_dir, 'video{}'.format(v), str(f)))
             for v, f in keys]
    videos = ['video{}'.format(v) for v in range(VIDEOS)]

    def run(name, reader, codec):
        out = os.path.join(WORK, 'yuv_' + name)
        t0 = time.perf_counter()
        ap.apply_vpd(videos, tasks, student, out, flow_img_name='flow',
                     batch_size=BATCH, prepared=prepared,
                     shard_reader=readers[reader], upload_codec=codec,
                     log=lambda *a: None)
        secs = time.perf_counter() - t0
        embs = _load_embs(out)
        _check_rows(embs, range(FRAMES))
        return len(tasks) / secs, _stack(embs, keys)

    run('warm', yuv_dir, 'yuv420')  # cuDNN plans for the decoded batches
    rates, embs = {}, {}
    rates['raw'], embs['raw'] = run('raw', raw_dir, None)
    packed_before = dict(ucodec.packer_calls)
    pre.launches = 0
    for name, reader in (('yuv420_from_raw_shards', raw_dir),
                         ('yuv420_from_yuv420_shards', yuv_dir)):
        rates[name], embs[name] = run(name, reader, 'yuv420')
    launches = pre.launches
    n_chunks = -(-len(tasks) // BATCH)
    if launches != 2 * n_chunks:
        raise AssertionError('B1 launched {} times on the yuv420 path, '
                             'expected {}'.format(launches, 2 * n_chunks))
    same = np.array_equal(embs['yuv420_from_raw_shards'],
                          embs['yuv420_from_yuv420_shards'])
    if not same:
        raise AssertionError('yuv420 from raw shards and from yuv420 shards '
                             'differ: max {}'.format(np.abs(
                                 embs['yuv420_from_raw_shards']
                                 - embs['yuv420_from_yuv420_shards']).max()))
    cos, _ = _cosines(embs['yuv420_from_yuv420_shards'], embs['raw'])
    return {'crops': len(tasks), 'batch': BATCH,
            'crops_per_s': rates, 'b1_launches': launches,
            'raw_and_yuv420_shards_equal': same,
            'min_cosine_yuv420_vs_raw_codec': cos,
            'host_packer_batches': {
                k: ucodec.packer_calls[k] - packed_before[k]
                for k in packed_before}}, launches


def phase_flow(card):
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    result = {'phase': 'flow', 'card': card, 'batch': FLOW_B,
              'img': IMG, 'iters': FLOW_ITERS}
    result['models'] = _raft_on_card(rng)
    # the yuv420 decode on the card, bit for bit
    packed = ucodec.encode_yuv420_numpy(rng.integers(
        0, 256, (FLOW_B, IMG, IMG, 3), np.uint8))
    arbitrary = rng.integers(0, 256, packed.shape, np.uint8)
    for name, p in (('encoded', packed), ('arbitrary', arbitrary)):
        got = ucodec.decode_yuv420(torch.from_numpy(p).cuda(), IMG, IMG)
        if not np.array_equal(got.cpu().numpy(),
                              ucodec.decode_yuv420_reference(p, IMG, IMG)):
            raise AssertionError('yuv420 decode on the card differs from '
                                 'the reference ({})'.format(name))
    dev = torch.from_numpy(packed).cuda()
    result['yuv420_decode'] = {
        'bit_equal': True, 'ms_per_batch': cuda_ms(
            lambda: ucodec.decode_yuv420(dev, IMG, IMG), iters=10),
        'bound_ms': (packed.nbytes + FLOW_B * IMG * IMG * 3)
        / HBM_BYTES_PER_S * 1e3}
    result['cli'] = _cli_on_card(rng)
    result['yuv420_extraction'], launches = _yuv420_extraction()
    result['seconds'] = time.perf_counter() - t0
    emit(result)
    return launches


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
        slice_launches = phase_slice(card)
        train = phase_train(card)
        phase_cache(card, train)
        phase_teacher(card, train)
        phase_heads(card)
        yuv420_launches = phase_flow(card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # B1's launches on its two paths, each counted from 0 around its runs
    preprocess['launches'] = slice_launches + yuv420_launches
    preprocess['launches_by_path'] = {'slice': slice_launches,
                                      'yuv420_extraction': yuv420_launches}
    print(card)
    emit({'kernels': [preprocess, dtw]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    sys.exit(main())
