#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vpd_tpu_torch) on one sm_90 GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one H100. Phases, one JSON
line each; any failure raises and exits non-zero:

  env      card name and power limit (nvidia-smi), torch/CUDA versions;
           requires compute capability 9.0
  build    compiles every kernel in vpd_tpu_torch/csrc with nvcc
  kernels  each kernel against its plain PyTorch twin on the card at the
           extraction shapes, and its time beside its bound
  slice    the student extraction path end to end at full width
           (ResNet-34, 32-d, 128x128, batch 512, orig + flip): random-init
           students written with the port's checkpoint writer, raw shards
           (and PNGs when cv2 or PIL is present), `apply_vpd` on cuda with
           the kernel launch counts checked, outputs held against the same
           weights in float32 with the plain preprocess and TF32 off

The last three lines are the card line as nvidia-smi prints it, the
kernels summary and `{"ok": true, "device": {...}}`. Scratch files go to
`.smoke/` in the checkout and are removed at the end.
"""

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

from vpd_tpu_torch.data.shards import ShardReader, write_raw_shards
from vpd_tpu_torch.infer import apply_vpd as ap
from vpd_tpu_torch.ops import _build
from vpd_tpu_torch.ops import preprocess as pre
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
TOL = 0.02                 # bf16 rounding of values in [-4.2, 4.4]
COS_BAR = 0.999


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of `fn` over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def _crops(gen, b, flow_c):
    dev = torch.device('cuda')
    rgb = torch.randint(0, 256, (b, IMG, IMG, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    flow = (torch.randint(0, 256, (b, IMG, IMG, flow_c), generator=gen,
                          device=dev, dtype=torch.uint8) if flow_c else None)
    return rgb, flow


def phase_kernels():
    """B1 against its twin: B in {13, 512}, 3 and 5 channels, both modes."""
    mean, std = default_config('fs', EMB)['rgb_mean_std']
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    checks, max_err = [], 0.
    for b in (13, BATCH):
        for flow_c in (0, 3):
            rgb, flow = _crops(gen, b, flow_c)
            flip = torch.randint(0, 2, (b,), generator=gen, device='cuda',
                                 dtype=torch.int32)
            for mode in (0, 1):
                if mode == 0:
                    out = pre.preprocess_crops(rgb, flow, flip, mean, std)
                    ref = pre.preprocess_crops_reference(rgb, flow, flip,
                                                         mean, std)
                else:
                    out = pre.preprocess_orig_and_flip(rgb, flow, mean, std)
                    ref = pre.preprocess_orig_and_flip_reference(
                        rgb, flow, mean, std)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                n_diff = int((out != ref).sum().item())
                checks.append({'b': b, 'channels': 5 if flow_c else 3,
                               'mode': mode, 'max_abs_err': err,
                               'elements_differing': n_diff,
                               'elements': out.numel()})
                max_err = max(max_err, err)
                if not err <= TOL:
                    raise AssertionError('preprocess kernel off by {} '
                                         '(> {}) at {}'.format(
                                             err, TOL, checks[-1]))

    # timing at the main path's shape: B=512 pair mode, 5 channels
    rgb, flow = _crops(gen, BATCH, 3)
    ms = cuda_ms(lambda: pre.preprocess_orig_and_flip(rgb, flow, mean, std))
    plain_ms = cuda_ms(lambda: pre.preprocess_orig_and_flip_reference(
        rgb, flow, mean, std))
    rgb3, _ = _crops(gen, BATCH, 0)
    ms_rgb = cuda_ms(lambda: pre.preprocess_orig_and_flip(rgb3, None, mean,
                                                          std))
    out_elems = 2 * BATCH * IMG * IMG * 5
    moved = rgb.numel() + flow.numel() + 2 * out_elems  # u8 in, bf16 out
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * out_elems / F32_FLOPS_PER_S * 1e3  # sub, mul, convert
    bound_ms = max(bytes_ms, ops_ms)
    rgb_moved = rgb3.numel() + 2 * (2 * BATCH * IMG * IMG * 3)
    emit({'phase': 'kernels', 'kernel': 'preprocess', 'checks': checks,
          'pair_5ch_ms': ms, 'pair_5ch_plain_ms': plain_ms,
          'pair_5ch_bytes': moved, 'pair_5ch_bound_ms': bound_ms,
          'pair_5ch_GBps': moved / ms / 1e6, 'pair_3ch_ms': ms_rgb,
          'pair_3ch_bound_ms': rgb_moved / HBM_BYTES_PER_S * 1e3})
    return {'name': 'preprocess', 'route': 'cuda',
            'source': 'vpd_tpu_torch/csrc/preprocess.cu',
            'replaces': 'vpd_tpu/ops/pallas/preprocess.py:37',
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms,
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None}


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
    secs = {}
    for use_flow in (True, False):
        secs[use_flow] = run(use_flow, os.path.join(
            WORK, 'out_{}'.format(use_flow)), tasks, shard_reader=reader)
    launches = pre.launches
    if launches != 2 * n_chunks:
        raise AssertionError('preprocess launched {} times, expected {} '
                             '(one per chunk)'.format(launches,
                                                      2 * n_chunks))

    result = {'phase': 'slice', 'card': card, 'crops': len(tasks),
              'batch': BATCH, 'chunks_per_run': n_chunks,
              'preprocess_launches': launches}
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


def main():
    phase_env()
    card = card_line()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_build()
        kernel = phase_kernels()
        kernel['launches'] = phase_slice(card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card)
    emit({'kernels': [kernel]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    sys.exit(main())
