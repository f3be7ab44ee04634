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

One device: `shard_rows=True` gives the same replicated cache, as vpd_tpu
does on a one-device mesh. The row-sharded multi-GPU cache is ROADMAP
A11.
"""

import numpy as np
import torch

from .. import resolve_device
from .crops import CropBatchSource


def _stage(shards, device):
    """One stream's shard memmaps as one uint8 tensor on `device`: the
    tensor is allocated once and each shard copied into its slice, so
    device memory peaks at the stream itself (vpd_tpu's donated updates
    peak at it plus one shard) and host memory at one shard, pinned on
    CUDA."""
    out = torch.empty((sum(len(s) for s in shards),) + shards[0].shape[1:],
                      dtype=torch.uint8, device=device)
    pinned = None
    if device.type == 'cuda':
        pinned = torch.empty((max(len(s) for s in shards),)
                             + shards[0].shape[1:], dtype=torch.uint8,
                             pin_memory=True)
    pos = 0
    for s in shards:
        n = len(s)
        if pinned is None:
            out[pos:pos + n].copy_(torch.from_numpy(np.array(s)))
        else:
            np.copyto(pinned[:n].numpy(), s)
            out[pos:pos + n].copy_(pinned[:n], non_blocking=True)
            # the pinned buffer is refilled next: wait for this copy
            torch.cuda.current_stream(device).synchronize()
        pos += n
    return out


class DeviceCropCache:
    """Upload a `ShardReader`'s streams to `device` (CUDA by default);
    `.arrays` is the dict of (N, ...) uint8 tensors the cached train and
    eval steps index into, `.nbytes` their size."""

    def __init__(self, reader, use_flow=False, use_mask=True,
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

        self.device = resolve_device(device)
        self.nbytes = sum(sum(s.nbytes for s in shards)
                          for shards in streams.values())
        # `shard_rows` on one device: the replicated cache, as vpd_tpu
        log('DeviceCropCache: staging {:.2f} GB ({} rows) on {}'.format(
            self.nbytes / 2**30, len(reader), self.device))
        self.arrays = {name: _stage(shards, self.device)
                       for name, shards in streams.items()}


class CacheIndexSource(CropBatchSource):
    """`CropBatchSource` that emits cache row indices instead of pixels:
    {'idx': (B,) int32, 'emb': (B, D) float32, 'flip': (B,) bool}. It
    draws the same (sample, flip) stream as `CropBatchSource` with the same
    seed (the pixel fetch is the only difference), so cached training is
    batch-for-batch identical to the shard and PNG paths."""

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

    def next_batch(self):
        b = self.batch_size
        idx = np.zeros(b, np.int32)
        embs = []
        flips = np.zeros(b, np.uint8)
        for i in range(b):
            # draw order as CropBatchSource.next_batch (sample, flip
            # interleaved): the equality contract
            s = int(self.rng.integers(len(self.samples)))
            emb = self.samples[s][3]
            flip = bool(self.augment and self.rng.integers(2))
            if emb.ndim == 2:
                emb = emb[int(flip)]
            elif flip:
                flip = False
            flips[i] = flip
            idx[i] = self._rows[s]
            embs.append(emb)
        return {'idx': idx, 'emb': np.stack(embs).astype(np.float32),
                'flip': flips.astype(bool)}
