"""Device-resident crop cache: stage packed shards on the card once, gather
training batches there.

Counterpart of `vpd_tpu/data/hbm_cache.py`. Student training re-reads the
same crops for up to 1000 virtual epochs (reference `train_vpd_model.py:
32,183`); the streamed path gathers, pins and uploads the uint8 pixels of
every batch on the host. Here the raw shards' rgb, flow and mask streams
are uploaded to device memory once, when the cache is built; afterwards a
batch is only (B,) row indices plus the (B, D) teacher targets, a few KB,
and the cached train and eval steps (`train/vpd.py`) gather the pixel
rows on the device. An H100's 80 GB hold about 6 x 10^5 crops of 128 x
128 with flow and mask (114,688 B each).

On a data mesh of n ranks (`mesh=`) the cache is either replicated, the
one-device cache on every rank (the corpus must fit one card), or, with
`shard_rows=True`, row-sharded as vpd_tpu's: rank r holds rows [r*per,
min((r+1)*per, total)) zero-padded to per = ceil(total / n) rows, so the
cards' pooled memory bounds the corpus. The sampler then draws block r of
every global batch from the samples homed on rank r (`CacheIndexSource`),
so each rank gathers its rows locally, with no collective on the pixels:
uniform within a partition, and a sample of a smaller partition drawn
more often globally (by the max/min partition-size ratio; a warning above
10%).
"""

import warnings

import numpy as np
import torch

from .. import resolve_device
from ..core.mesh import part_rows
from .crops import CropBatchSource


def _stage(shards, device, lo=0, hi=None, pad_to=None):
    """Rows [lo, hi) of one stream's shard memmaps (all of them by
    default) as one uint8 tensor on `device`, zero-padded to `pad_to`
    rows: the tensor is allocated once and each shard's part copied into
    its slice, so device memory peaks at the partition itself (vpd_tpu's
    donated updates peak at it plus one shard) and host memory at one
    shard, pinned on CUDA."""
    total = sum(len(s) for s in shards)
    hi = total if hi is None else hi
    rows = pad_to if pad_to is not None else hi - lo
    out = torch.zeros((rows,) + shards[0].shape[1:], dtype=torch.uint8,
                      device=device)
    pinned = None
    if device.type == 'cuda':
        pinned = torch.empty((max(len(s) for s in shards),)
                             + shards[0].shape[1:], dtype=torch.uint8,
                             pin_memory=True)
    pos = base = 0
    for s in shards:
        part = s[max(lo - base, 0):max(min(hi - base, len(s)), 0)]
        base += len(s)
        n = len(part)
        if not n:
            continue
        if pinned is None:
            out[pos:pos + n].copy_(torch.from_numpy(np.array(part)))
        else:
            np.copyto(pinned[:n].numpy(), part)
            out[pos:pos + n].copy_(pinned[:n], non_blocking=True)
            # the pinned buffer is refilled next: wait for this copy
            torch.cuda.current_stream(device).synchronize()
        pos += n
    return out


class DeviceCropCache:
    """Upload a `ShardReader`'s streams to `device` (CUDA by default);
    `.arrays` is the dict of (N, ...) uint8 tensors the cached train and
    eval steps index into, `.nbytes` the corpus' size. On a data `mesh`
    of n > 1 ranks, `shard_rows` row-shards it: `row_sharded` is set,
    this rank holds `rows_per_device` rows from global row
    `row_offset`. Otherwise every rank holds the whole corpus
    (`rows_per_device` None, `row_offset` 0)."""

    def __init__(self, reader, use_flow=False, use_mask=True, mesh=None,
                 shard_rows=False, device=None, log=print):
        self.reader = reader
        if reader.codec != 'raw':
            raise ValueError(
                'the device crop cache stages raw pixels; "{}" shards are '
                'extraction-only (pack without --codec)'.format(reader.codec))
        streams = {'rgb': reader._rgb}
        if use_flow:
            if not reader._flow:
                raise ValueError('shards packed without flow')
            streams['flow'] = reader._flow
        if use_mask and reader._mask:
            streams['mask'] = reader._mask

        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self.mesh = mesh
        self.nbytes = sum(sum(s.nbytes for s in shards)
                          for shards in streams.values())
        n = 1 if mesh is None else mesh.data_size
        # `shard_rows` on one device: the replicated cache, as vpd_tpu
        self.row_sharded = bool(shard_rows) and n > 1
        self.rows_per_device, self.row_offset = None, 0
        total = len(reader)
        span = {}
        if self.row_sharded:
            per = -(-total // n)  # ceil; the last partition zero-pads
            r = mesh.data_rank
            self.rows_per_device, self.row_offset = per, r * per
            span = dict(lo=min(r * per, total),
                        hi=min((r + 1) * per, total), pad_to=per)
        log('DeviceCropCache: staging {:.2f} GB ({} rows) on {}{}'.format(
            self.nbytes / 2**30, total, self.device,
            ', rows {}-{} of a cache sharded over {} ranks'.format(
                span['lo'], span['hi'], n) if span
            else ' on each of {} ranks'.format(n) if n > 1 else ''))
        self.arrays = {name: _stage(shards, self.device, **span)
                       for name, shards in streams.items()}


class CacheIndexSource(CropBatchSource):
    """`CropBatchSource` that emits cache row indices instead of pixels:
    {'idx': (B,) int32, 'emb': (B, D) float32, 'flip': (B,) bool}. Over a
    replicated cache it draws the same (sample, flip) stream as
    `CropBatchSource` with the same seed (the pixel fetch is the only
    difference), so cached training is batch-for-batch identical to the
    shard and PNG paths. Over a row-sharded cache block d of every global
    batch is drawn uniformly from the samples homed on rank d, and this
    rank (`batch_part`) keeps its own block."""

    def __init__(self, samples, img_dir, img_dim, batch_size, *,
                 cache, **kwargs):
        kwargs.pop('shard_dir', None)
        # index batches decode nothing: no probe (or g++ build) of the
        # native PNG decoder
        kwargs.setdefault('use_native', False)
        super().__init__(samples, img_dir, img_dim, batch_size, **kwargs)
        self.device_cache = cache
        # the streamed path's shard-meta checks, which the pixel fetch
        # from the cache bypasses
        meta = cache.reader.meta
        if img_dim != meta['img_dim']:
            raise ValueError('shards packed at img_dim={}, requested {}'
                             .format(meta['img_dim'], img_dim))
        if self.flow_img_name:
            if meta['flow_img_name'] != self.flow_img_name:
                raise ValueError(
                    'shards packed with flow "{}", model needs "{}"'.format(
                        meta['flow_img_name'], self.flow_img_name))
            if 'flow' not in cache.arrays:
                raise ValueError('DeviceCropCache staged without flow '
                                 '(use_flow=False) but the source needs it')
        if self.use_mask:
            if not meta['use_mask']:
                raise ValueError('shards packed without masks but '
                                 'use_mask=True')
            if 'mask' not in cache.arrays:
                raise ValueError('DeviceCropCache staged without masks '
                                 '(use_mask=False) but the source needs '
                                 'them')
        rows = cache.reader.rows(
            [self._prefix(v, p, f) for v, p, f, _ in samples])
        missing = int((rows < 0).sum())
        if missing:
            raise ValueError(
                '{} of {} samples are not in the packed shards; repack with '
                'tools/pack_crops before using the device cache'.format(
                    missing, len(samples)))
        self._rows = rows.astype(np.int32)
        self._by_device = None
        if cache.row_sharded:
            n = cache.mesh.data_size
            if self.batch_part[1] != n:
                raise ValueError('a row-sharded cache over {} ranks needs '
                                 'sources of batch_part (i, {})'.format(
                                     n, n))
            homes = self._rows // cache.rows_per_device
            self._by_device = [np.nonzero(homes == d)[0] for d in range(n)]
            empty = [d for d, g in enumerate(self._by_device) if len(g) == 0]
            if empty:
                raise ValueError(
                    'no samples homed on rank(s) {}: the corpus is too '
                    'small to row-shard over {} ranks; use the replicated '
                    'cache'.format(empty, n))
            sizes = [len(g) for g in self._by_device]
            if max(sizes) > 1.1 * min(sizes):
                warnings.warn(
                    'row-sharded cache partitions are unbalanced ({}-{} '
                    'samples a rank): per-rank-uniform sampling oversamples '
                    'small partitions by up to {:.2f}x'.format(
                        min(sizes), max(sizes), max(sizes) / min(sizes)))

    def _draw(self):
        if self._by_device is None:
            # draw order as CropBatchSource (sample, flip interleaved):
            # the equality contract
            return super()._draw()
        b = self.batch_size
        block = b // len(self._by_device)
        out = []
        for i in range(b):  # block d of the batch lands on rank d
            g = self._by_device[i // block]
            s = int(g[self.rng.integers(len(g))])
            out.append((s, bool(self.augment and self.rng.integers(2))))
        return out

    def next_batch(self):
        drawn = self._draw()[part_rows(self.batch_size, self.batch_part)]
        idx = np.zeros(len(drawn), np.int32)
        embs = []
        flips = np.zeros(len(drawn), bool)
        for i, (s, flip) in enumerate(drawn):
            emb, flips[i] = self._target(s, flip)
            idx[i] = self._rows[s]
            embs.append(emb)
        return {'idx': idx, 'emb': np.stack(embs).astype(np.float32),
                'flip': flips}
