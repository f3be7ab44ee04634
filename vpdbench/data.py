"""Crops and teacher targets made from the run's seed.

`SeededCrops` makes uint8 crops on the device, shard by shard, each shard
from a generator of its own, so any shard can be made again after the
window for the reference. The streams are those of the port's raw
shards: RGB (S, S, 3), flow as a 3-channel PNG's bytes (S, S, 3) and a
person mask (S, S) of 0 and 255. Crops differ as photographs do, not
only pixel by pixel: each has a contrast and a level of its own a
channel, and its own share of person pixels, so that their embeddings,
pooled over the crop, differ. `SeededReader` hands them to the
program's `DeviceCropCache` as a shard reader does, with nothing on
disk.
"""

import os

import numpy as np
import torch

from .weights import derive

STREAMS = ('rgb', 'flow', 'mask')


class SeededCrops:

    def __init__(self, seed, num, img_dim, rows_per_shard, device):
        self.seed, self.num, self.img_dim = seed, num, img_dim
        self.rows_per_shard, self.device = rows_per_shard, device

    @property
    def num_shards(self):
        return -(-self.num // self.rows_per_shard)

    def rows_in(self, sid):
        return min(self.rows_per_shard, self.num - sid * self.rows_per_shard)

    def row_shape(self, stream):
        s = self.img_dim
        return (s, s) if stream == 'mask' else (s, s, 3)

    def shard(self, stream, sid):
        """Shard `sid` of `stream` on the device, uint8."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive(self.seed, 'crops:{}:{}'.format(stream, sid)))
        n = self.rows_in(sid)
        x = torch.rand((n,) + self.row_shape(stream), generator=gen,
                       device=self.device)
        if stream == 'mask':
            share = torch.rand((n, 1, 1), generator=gen, device=self.device)
            return (x < share).to(torch.uint8) * 255
        # a contrast in [0.2, 1] and a level a crop and channel
        contrast = 0.2 + 0.8 * torch.rand((n, 1, 1, 3), generator=gen,
                                          device=self.device)
        level = (1 - contrast) * torch.rand((n, 1, 1, 3), generator=gen,
                                            device=self.device)
        return (255 * (level + contrast * x)).to(torch.uint8)

    def stream(self, name):
        """All rows of one stream on the device."""
        return torch.cat([self.shard(name, i)
                          for i in range(self.num_shards)])


class _Shard:
    """One shard of one stream as the cache's staging reads a memmap: its
    length, shape and size, and slices as host arrays."""

    def __init__(self, crops, stream, sid):
        self.crops, self.stream, self.sid = crops, stream, sid
        self.shape = (crops.rows_in(sid),) + crops.row_shape(stream)
        self.nbytes = int(np.prod(self.shape))

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, index):
        return self.crops.shard(self.stream, self.sid)[index].cpu().numpy()


class SeededReader:
    """A raw-shard reader over `SeededCrops`: the streams, `meta`, and the
    row of each crop's path prefix `<img_dir>/<video>/<frame>`."""

    codec = 'raw'

    def __init__(self, crops, img_dir, flow_img_name):
        shards = range(crops.num_shards)
        self._rgb, self._flow, self._mask = (
            [_Shard(crops, name, i) for i in shards] for name in STREAMS)
        self.meta = {'img_dim': crops.img_dim, 'flow_img_name': flow_img_name,
                     'use_mask': True, 'codec': 'raw'}
        self.keys = [sample_key(r) for r in range(crops.num)]
        self._index = {os.path.join(img_dir, v, str(f)): r
                       for r, (v, f) in enumerate(self.keys)}

    def __len__(self):
        return len(self.keys)

    def rows(self, prefixes):
        return np.array([self._index.get(p, -1) for p in prefixes], np.int64)


def sample_key(row):
    """(video, frame) of the crop in row `row`: videos of 1,000 frames."""
    return 'video{:04d}'.format(row // 1000), row % 1000


def targets(seed, num, dim):
    """(num, 2, dim) float32 teacher targets, the original's and the
    flipped crop's, standard normal."""
    rng = np.random.default_rng(derive(seed, 'targets'))
    return rng.standard_normal((num, 2, dim), dtype=np.float32)
