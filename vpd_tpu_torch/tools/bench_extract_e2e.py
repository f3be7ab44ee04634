"""Honest end-to-end student extraction benchmark.

Counterpart of `vpd_tpu/tools/bench_extract_e2e.py`. Measures the REAL
`apply_vpd` path — PNG decode (native C++ loader, or cv2 / PIL where it
does not build) -> pinned upload -> preprocess kernel + encoder on the
card -> readback -> per-video .emb.pkl — on a generated crop corpus.

Reports crops/sec/chip for (a) decode-only (or, with --shards, the memmap
gather that replaces it), (b) the full pipeline, and (c) the card-only
roof at the same batch size (crops staged on the card, `reps` launches of
the orig + flip embed, then one readback), plus the implied busy
fraction (b)/(c). The embed is built and run once before (b), so cuDNN
has chosen its algorithms at these shapes before anything is timed.
Usage:

    python -m vpd_tpu_torch.tools.bench_extract_e2e --num_crops 4096
    python -m vpd_tpu_torch.tools.bench_extract_e2e --shards --device cpu
"""

import argparse
import collections
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
import shutil
import tempfile
import time

import numpy as np

PNGS_A_WORKER = 512   # files a PNG writer process is worth starting for
PNG_BATCH = 16        # files a writer task


def get_args():
    p = argparse.ArgumentParser()
    p.add_argument('--corpus_dir', default=None,
                   help='reuse/keep the PNG corpus here (default: tmp)')
    p.add_argument('--num_videos', type=int, default=8)
    p.add_argument('--num_crops', type=int, default=4096)
    p.add_argument('--img_dim', type=int, default=128)
    p.add_argument('--batch_size', type=int, default=1024)
    p.add_argument('--threads', type=int, default=None,
                   help='native decoder threads (default: min(16, ncpu))')
    p.add_argument('--flow', action='store_true',
                   help='5-channel student (decodes a flow PNG per crop)')
    p.add_argument('--arch', default='resnet34')
    p.add_argument('--emb_dim', type=int, default=32)
    p.add_argument('--shards', action='store_true',
                   help='pack the corpus into crop shards first and feed '
                        'extraction from the memmap gather (no decode)')
    p.add_argument('--upload_codec', default='raw',
                   choices=('raw', 'yuv420'),
                   help='yuv420: halve host->device bytes via the lossy '
                        'upload codec (data/upload_codec.py)')
    p.add_argument('--shard_codec', default='raw',
                   choices=('raw', 'yuv420'),
                   help='with --shards: pack the rgb stream pre-encoded '
                        '(yuv420 requires --upload_codec yuv420; removes '
                        'the per-batch host encode from the path)')
    p.add_argument('--device', default=None,
                   help='torch device (default: cuda; cpu runs the plain '
                        'PyTorch path)')
    return p.parse_args()


def _save_pngs(items):
    from PIL import Image

    for path, arr in items:
        Image.fromarray(arr).save(path)


class PngWriter:
    """Saves (path, uint8 array) pairs as PNGs with PIL, so the files are
    the bytes a serial `Image.save` writes. PIL's PNG encoder holds the
    interpreter lock, so for `n_files` of at least 2 x PNGS_A_WORKER the
    files go to spawned processes (at most 8, two tasks each in flight; a
    worker that dies raises `BrokenProcessPool`); fewer are written here.
    Use as a context manager: on exit every file is written."""

    def __init__(self, n_files):
        procs = min(8, os.cpu_count() or 1, n_files // PNGS_A_WORKER)
        self.pool = (ProcessPoolExecutor(
            procs, mp_context=multiprocessing.get_context('spawn'))
            if procs > 1 else None)
        self.limit = 2 * procs
        self.batch, self.pending = [], collections.deque()

    def save(self, path, arr):
        self.batch.append((path, arr))
        if len(self.batch) == PNG_BATCH:
            self._flush()

    def _flush(self):
        if self.pool is None:
            _save_pngs(self.batch)
        else:
            self.pending.append(self.pool.submit(_save_pngs, self.batch))
            while len(self.pending) > self.limit:
                self.pending.popleft().result()
        self.batch = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                self._flush()
                while self.pending:
                    self.pending.popleft().result()
        finally:
            if self.pool is not None:
                self.pool.shutdown(cancel_futures=True)


def make_corpus(corpus_dir, num_videos, num_crops, img_dim, flow, log):
    """Synthesizes crop PNGs with natural-ish content (smooth gradients +
    noise), so PNG entropy is between best and worst case. Byte-equal to
    vpd_tpu's corpus under the same arguments (the random draws in its
    order; the files written by `PngWriter`)."""
    rng = np.random.default_rng(0)
    per_video = num_crops // num_videos
    t0 = time.perf_counter()
    yy, xx = np.mgrid[0:img_dim, 0:img_dim].astype(np.float32)
    n_files = num_videos * per_video * (2 if flow else 1)
    with PngWriter(n_files) as writer:
        for v in range(num_videos):
            vdir = os.path.join(corpus_dir, 'video{:03d}'.format(v))
            os.makedirs(vdir, exist_ok=True)
            for f in range(per_video):
                base = (128 + 60 * np.sin(xx / 17 + v) *
                        np.cos(yy / 23 + f / 7))[..., None]
                img = np.clip(
                    base + rng.normal(0, 18, (img_dim, img_dim, 3)),
                    0, 255).astype(np.uint8)
                writer.save(os.path.join(vdir, f'{f}.png'), img)
                if flow:
                    fl = np.clip(
                        128 + rng.normal(0, 6, (img_dim, img_dim, 3)),
                        0, 255).astype(np.uint8)
                    writer.save(os.path.join(vdir, f'{f}.flow.png'), fl)
    log('corpus: {} crops in {:.1f}s'.format(
        num_videos * per_video, time.perf_counter() - t0))


def make_model_dir(model_dir, arch, emb_dim, img_dim, flow):
    """A random-init student dir (config.json + best_epoch) that either
    package loads. The weights are made on the CPU: they are only
    written."""
    import torch

    from ..train.vpd_loop import VPDTrainer, default_config

    config = default_config('tennis', emb_dim, img_dim=img_dim,
                            use_flow=flow, encoder_arch=arch)

    class _Null:
        num_batches = 0

        def next_batch(self):
            raise StopIteration

    trainer = VPDTrainer(_Null(), None, config, save_dir=model_dir,
                         dtype=torch.bfloat16, device='cpu')
    trainer.save_config()
    trainer.save_model('best_epoch')


def main():
    args = get_args()
    log = print

    import torch

    from .. import resolve_device
    from ..core.profiling import device_name

    device = resolve_device(args.device)
    tmp = None
    corpus_dir = args.corpus_dir
    if corpus_dir is None:
        tmp = tempfile.mkdtemp(prefix='vpd_bench_e2e_')
        corpus_dir = os.path.join(tmp, 'crops')
    sentinel = os.path.join(
        corpus_dir, 'video{:03d}'.format(args.num_videos - 1),
        '{}.png'.format(args.num_crops // args.num_videos - 1))
    if not os.path.exists(sentinel):
        make_corpus(corpus_dir, args.num_videos, args.num_crops,
                    args.img_dim, args.flow, log)

    work = tmp or tempfile.mkdtemp(prefix='vpd_bench_e2e_')
    model_dir = os.path.join(work, 'model')
    out_dir = os.path.join(work, 'out')
    make_model_dir(model_dir, args.arch, args.emb_dim, args.img_dim,
                   args.flow)

    from ..data import crops as crops_mod
    from ..infer.apply_vpd import apply_vpd, scan_crop_dir

    videos, tasks = scan_crop_dir(corpus_dir)
    n = len(tasks)

    # (a) host-side roof: PNG decode (native loader, else cv2 or PIL) or,
    # with --shards, the memmap gather that replaces it.
    from ..data import native_loader
    rgb_paths = [prefix + '.png' for _, _, prefix in tasks]
    flow_paths = ([p[:-4] + '.flow.png' for p in rgb_paths]
                  if args.flow else None)
    use_native = native_loader.available()
    shard_reader = None
    pack_rate = None
    if args.shard_codec != 'raw':
        # validated up front so a run without --shards cannot silently
        # measure the PNG path while its JSON row claims packed shards
        if not args.shards:
            raise SystemExit('--shard_codec requires --shards')
        if args.upload_codec != args.shard_codec:
            raise SystemExit('--shard_codec {} requires --upload_codec {}'
                             .format(args.shard_codec, args.shard_codec))
    if args.shards:
        from ..data.shards import ShardReader, pack_crops
        shard_dir = os.path.join(work, 'shards')
        t0 = time.perf_counter()
        pack_crops(corpus_dir, shard_dir, args.img_dim,
                   flow_img_name='flow' if args.flow else None,
                   use_mask=False, codec=args.shard_codec,
                   log=lambda *a: None)
        pack_rate = n / (time.perf_counter() - t0)
        shard_reader = ShardReader(shard_dir, crop_root=corpus_dir)
        prefixes = [prefix for _, _, prefix in tasks]
        rgb_buf = np.zeros((n,) + shard_reader._rgb[0].shape[1:], np.uint8)
        flow_buf = (np.zeros((n, args.img_dim, args.img_dim, 3), np.uint8)
                    if args.flow else None)
        t0 = time.perf_counter()
        missing = shard_reader.fill(prefixes, rgb_buf, flow_buf)
        decode_rate = n / (time.perf_counter() - t0)
        if missing:
            raise RuntimeError('{} crops missing from the shards'.format(
                len(missing)))
        del rgb_buf, flow_buf
    else:
        t0 = time.perf_counter()
        if use_native:
            native_loader.decode_crops(rgb_paths, args.img_dim,
                                       flow_paths=flow_paths,
                                       n_threads=args.threads)
        else:
            crops_mod.decode_crop_batch(rgb_paths, args.img_dim,
                                        flow_paths=flow_paths,
                                        use_native=False)
        decode_rate = n / (time.perf_counter() - t0)

    # Load weights and run the embed once at the timed shapes (steady-
    # state extraction amortizes cuDNN's algorithm choice and the kernel
    # build over the whole corpus; timing them would not measure the
    # pipeline).
    from ..infer.apply_vpd import load_student_dir, make_variant_embed
    model, config = load_student_dir(model_dir, device=device)
    codec = None if args.upload_codec == 'raw' else args.upload_codec
    embed = make_variant_embed(model, config, upload_codec=codec,
                               device=device)
    u8 = np.random.default_rng(1)
    host_rgb = u8.integers(
        0, 255, (args.batch_size, args.img_dim, args.img_dim, 3),
        dtype=np.uint8)
    if codec == 'yuv420':
        from ..data.upload_codec import encode_yuv420
        host_rgb = encode_yuv420(host_rgb)
    dev_rgb = torch.from_numpy(host_rgb).to(device)
    dev_flow = torch.from_numpy(u8.integers(
        0, 255, (args.batch_size, args.img_dim, args.img_dim, 3),
        dtype=np.uint8)).to(device) if args.flow else None
    embed(dev_rgb, dev_flow, 0).cpu()

    # (b) full extraction pipeline, including .emb.pkl writes, with the
    # warmed embed injected (what a long extraction run looks like).
    t0 = time.perf_counter()
    apply_vpd(videos, tasks, model_dir, out_dir,
              flow_img_name='flow' if args.flow else None,
              batch_size=args.batch_size, log=lambda *a: None,
              prepared=(model, config), embed_fn=embed,
              shard_reader=shard_reader, upload_codec=codec, device=device)
    e2e_rate = n / (time.perf_counter() - t0)
    written = len(os.listdir(out_dir))
    if written != args.num_videos:
        raise RuntimeError('apply_vpd wrote {} of {} videos'.format(
            written, args.num_videos))

    # (c) card-only roof at the same batch size / variant count (orig +
    # flip): `reps` launches, then the readbacks wait for them all
    reps = max(1, n // args.batch_size)
    t0 = time.perf_counter()
    outs = [embed(dev_rgb, dev_flow, i) for i in range(reps)]
    _ = [o.cpu() for o in outs]
    chip_rate = args.batch_size * reps / (time.perf_counter() - t0)

    result = {
        'metric': 'extract_e2e_crops_per_sec_per_chip',
        'value': round(e2e_rate, 1),
        'unit': 'crops/sec/chip',
        'decode_only_rate': round(decode_rate, 1),
        'chip_only_rate': round(chip_rate, 1),
        'chip_busy_fraction': round(e2e_rate / chip_rate, 3),
        'batch_size': args.batch_size,
        'num_crops': n,
        'flow': args.flow,
        'native_loader': use_native,
        'host_cores': os.cpu_count(),
        'shards': args.shards,
        'upload_codec': args.upload_codec,
        'shard_codec': args.shard_codec,
        'device': device_name(device),
    }
    if pack_rate is not None:
        result['pack_rate'] = round(pack_rate, 1)
    print(json.dumps(result))
    if tmp and not args.corpus_dir:
        shutil.rmtree(tmp, ignore_errors=True)
    elif args.corpus_dir:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == '__main__':
    main()
