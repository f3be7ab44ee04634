"""Packed crop shards: a decode-free cache of crop PNG directories.

Counterpart of `vpd_tpu/data/shards.py:176-320` for `codec='raw'` shards:
fetching a batch is a numpy memmap gather (memcpy, no codec). Layout
under <shard_dir>, as `vpd_tpu.data.shards.pack_crops` writes it:

  shards_meta.json          img_dim, codec, rows_per_shard, shard rows
  shards_index.pkl          {rel_prefix: global_row}
  s<NNNN>.rgb               (rows, S, S, 3) uint8, C-contiguous
  s<NNNN>.flow              (rows, S, S, 3) uint8         [if flow packed]
  s<NNNN>.mask              (rows, S, S) uint8            [if masks packed]

`rel_prefix` is the crop path relative to the image root, '/'-separated,
without extension: 'video/frame' or 'video/player/frame'. Extraction
reads rgb and flow, training rgb, flow and masks. `yuv420` shards are not
ported yet (ROADMAP A3, the upload codec).
"""

import json
import os

import numpy as np

from .crops import decode_crop_batch
from ..core.io import load_pickle, store_json, store_pickle

META_FILE = 'shards_meta.json'
INDEX_FILE = 'shards_index.pkl'
DEFAULT_ROWS_PER_SHARD = 4096


def _no_yuv420(codec):
    if codec != 'raw':
        raise NotImplementedError(
            '"{}" shards are not ported yet (ROADMAP A3: the yuv420 upload '
            'codec and its shards); repack with codec "raw"'.format(codec))


def write_raw_shards(shard_dir, rel_prefixes, rgb, flow=None,
                     flow_img_name=None, mask=None,
                     rows_per_shard=DEFAULT_ROWS_PER_SHARD):
    """Write already-decoded uint8 crops as raw shards (the layout above).
    rgb: (N, S, S, 3); flow: (N, S, S, 3) with its PNG name, or None;
    mask: (N, S, S) person masks, or None. Returns the row count.
    """
    n, s = rgb.shape[0], rgb.shape[1]
    if len(rel_prefixes) != n or (flow is None) != (flow_img_name is None):
        raise ValueError('need one prefix per row, and flow together with '
                         'its flow_img_name')
    os.makedirs(shard_dir, exist_ok=True)
    shard_rows = []
    for start in range(0, n, rows_per_shard):
        sid = len(shard_rows)
        rows = slice(start, min(start + rows_per_shard, n))
        base = os.path.join(shard_dir, 's{:04d}'.format(sid))
        np.ascontiguousarray(rgb[rows], np.uint8).tofile(base + '.rgb')
        if flow is not None:
            np.ascontiguousarray(flow[rows], np.uint8).tofile(base + '.flow')
        if mask is not None:
            np.ascontiguousarray(mask[rows], np.uint8).tofile(base + '.mask')
        shard_rows.append(rows.stop - rows.start)
    store_pickle(os.path.join(shard_dir, INDEX_FILE),
                 {rel: i for i, rel in enumerate(rel_prefixes)})
    store_json(os.path.join(shard_dir, META_FILE), {
        'img_dim': s,
        'codec': 'raw',
        'flow_img_name': flow_img_name,
        'use_mask': mask is not None,
        'rows_per_shard': rows_per_shard,
        'shard_rows': shard_rows,
        'num_rows': n,
    }, indent=2)
    return n


class ShardReader:
    """Memmap-backed random access to packed raw crop shards.

    `crop_root`: when given, `fill()` also accepts ABSOLUTE path prefixes
    (as produced by `scan_crop_dir`) and relativizes them against it.
    """

    def __init__(self, shard_dir, crop_root=None):
        with open(os.path.join(shard_dir, META_FILE)) as fp:
            self.meta = json.load(fp)
        self.codec = self.meta.get('codec', 'raw')
        _no_yuv420(self.codec)
        self.index = load_pickle(os.path.join(shard_dir, INDEX_FILE))
        self.crop_root = (os.path.abspath(crop_root)
                          if crop_root is not None else None)
        s = self.meta['img_dim']
        self.rows_per_shard = self.meta['rows_per_shard']
        self._rgb = []
        self._flow = []
        self._mask = []
        for sid, rows in enumerate(self.meta['shard_rows']):
            base = os.path.join(shard_dir, 's{:04d}'.format(sid))
            self._rgb.append(np.memmap(
                base + '.rgb', np.uint8, 'r', shape=(rows, s, s, 3)))
            if self.meta['flow_img_name']:
                self._flow.append(np.memmap(
                    base + '.flow', np.uint8, 'r', shape=(rows, s, s, 3)))
            if self.meta['use_mask']:
                self._mask.append(np.memmap(
                    base + '.mask', np.uint8, 'r', shape=(rows, s, s)))

    def __len__(self):
        return self.meta['num_rows']

    def _rel(self, prefix):
        if self.crop_root is not None:
            ap = os.path.abspath(prefix)
            if ap == self.crop_root or \
                    ap.startswith(self.crop_root + os.sep):
                prefix = os.path.relpath(ap, self.crop_root)
        elif os.path.isabs(prefix):
            raise ValueError('absolute prefix {} but the ShardReader has no '
                             'crop_root'.format(prefix))
        return prefix.replace(os.sep, '/')

    def rows(self, prefixes):
        """Global row per prefix; -1 where not packed."""
        return np.array([self.index.get(self._rel(p), -1)
                         for p in prefixes], np.int64)

    def fill(self, prefixes, rgb_out, flow_out=None, mask_out=None):
        """Gather packed rows into out arrays; returns the list of batch
        positions NOT found (caller falls back to PNG decode for those)."""
        rows = self.rows(prefixes)
        hit = rows >= 0
        if flow_out is not None and not self._flow:
            raise ValueError('shards packed without flow')
        if mask_out is not None and not self._mask:
            raise ValueError('shards packed without masks')
        if hit.any():
            sids = rows[hit] // self.rows_per_shard
            locals_ = rows[hit] % self.rows_per_shard
            pos = np.nonzero(hit)[0]
            for sid in np.unique(sids):
                sel = sids == sid
                p, l = pos[sel], locals_[sel]
                rgb_out[p] = self._rgb[sid][l]
                if flow_out is not None:
                    flow_out[p] = self._flow[sid][l]
                if mask_out is not None:
                    mask_out[p] = self._mask[sid][l]
        return np.nonzero(~hit)[0].tolist()


def fill_or_decode(reader, prefixes, img_dim, *, flow_img_name=None,
                   rgb_out=None, flow_out=None, mask_out=None, codec='raw'):
    """Shard gather with per-row PNG-decode fallback for unpacked crops.

    Drop-in alternative to `decode_crop_batch` over path prefixes; output
    bytes are identical. The request is checked against the shard meta so
    a flow-variant, size or mask mismatch fails loudly instead of
    gathering the wrong packed stream. Returns (rgb, flow, mask).
    """
    _no_yuv420(codec)
    if img_dim != reader.meta['img_dim']:
        raise ValueError('shards packed at img_dim={}, requested {}'.format(
            reader.meta['img_dim'], img_dim))
    if flow_out is not None and reader.meta['flow_img_name'] != flow_img_name:
        raise ValueError('shards packed with flow "{}", requested "{}"'
                         .format(reader.meta['flow_img_name'], flow_img_name))
    if mask_out is not None and not reader.meta['use_mask']:
        raise ValueError('shards packed without masks but a mask buffer '
                         'was requested')

    n = len(prefixes)
    if rgb_out is None:
        rgb_out = np.zeros((n, img_dim, img_dim, 3), np.uint8)
    missing = reader.fill(prefixes, rgb_out[:n],
                          flow_out[:n] if flow_out is not None else None,
                          mask_out[:n] if mask_out is not None else None)
    if missing:
        rgb_t, flow_t, mask_t = decode_crop_batch(
            [prefixes[i] + '.png' for i in missing], img_dim,
            flow_paths=(['{}.{}.png'.format(prefixes[i], flow_img_name)
                         for i in missing]
                        if flow_out is not None else None),
            mask_paths=([prefixes[i] + '.mask.png' for i in missing]
                        if mask_out is not None else None))
        rgb_out[missing] = rgb_t
        if flow_out is not None:
            flow_out[missing] = flow_t
        if mask_out is not None:
            mask_out[missing] = mask_t
    return rgb_out, flow_out, mask_out
