"""Checkpoints in vpd_tpu's flax-msgpack format, without flax or msgpack.

Counterpart of `vpd_tpu/core/checkpoint.py`: per-component files in a
save dir, named ``{name}.{component}.ckpt`` with name in {'best_epoch',
'epoch%04d'}, beside the ``config.json`` manifest, and the moving-average
best-epoch selection. A file holds flax's msgpack serialization of a
nested dict of numpy arrays (`flax.serialization.to_bytes`).

The codec below covers the subset flax writes — maps with str keys, str,
bin, arrays, nil, bools, ints, float64, ext type 1 (ndarray as a packed
``(shape, dtype_name, C-bytes)`` tuple) and ext type 3 (numpy scalar) —
and encodes each value exactly as msgpack-python does, so a file written
by `vpd_tpu` reads back and writes back byte-equal. Dict keys are written
sorted at every level, as JAX's pytree flattening orders them before flax
serializes, so a tree the port builds in any order lands on the same bytes
as vpd_tpu's `save_component` of the same arrays.
"""

import os
import re
import struct

import numpy as np

from .io import _replace_into

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------- encode

def _pack_uint_len(out, n, small, codes):
    """Length/size header: `small` is the fix-format base (or None)."""
    for code, fmt, limit in codes:
        if n < limit:
            if code is None:
                out.append(small | n)
            else:
                out.append(code)
                out += struct.pack(fmt, n)
            return
    raise ValueError('msgpack object too large: {}'.format(n))


def _pack_int(out, x):
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack('b', x)
    elif x >= 0:
        for code, fmt, limit in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                                 (0xce, '>I', 1 << 32),
                                 (0xcf, '>Q', 1 << 64)):
            if x < limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError('int too large for msgpack: {}'.format(x))
    else:
        for code, fmt, limit in ((0xd0, '>b', 1 << 7), (0xd1, '>h', 1 << 15),
                                 (0xd2, '>i', 1 << 31),
                                 (0xd3, '>q', 1 << 63)):
            if x >= -limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError('int too small for msgpack: {}'.format(x))


def _pack_str(out, s):
    data = s.encode('utf-8')
    _pack_uint_len(out, len(data), 0xa0,
                   ((None, None, 32), (0xd9, '>B', 1 << 8),
                    (0xda, '>H', 1 << 16), (0xdb, '>I', 1 << 32)))
    out += data


def _pack_bin(out, data):
    _pack_uint_len(out, len(data), None,
                   ((0xc4, '>B', 1 << 8), (0xc5, '>H', 1 << 16),
                    (0xc6, '>I', 1 << 32)))
    out += data


def _pack_ext(out, code, data):
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_uint_len(out, n, None,
                       ((0xc7, '>B', 1 << 8), (0xc8, '>H', 1 << 16),
                        (0xc9, '>I', 1 << 32)))
    out += struct.pack('b', code)
    out += data


def _ndarray_payload(arr):
    """flax `_ndarray_to_bytes`: packb((shape, dtype name, C bytes))."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError('object and structured dtypes are not supported')
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes('C')))


def _pack(out, obj):
    # exact-type dispatch, like msgpack-python's strict_types=True
    t = type(obj)
    if obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(0xcb)
        out += struct.pack('>d', obj)
    elif t is str:
        _pack_str(out, obj)
    elif t is bytes:
        _pack_bin(out, obj)
    elif t is dict:
        _pack_uint_len(out, len(obj), 0x80,
                       ((None, None, 16), (0xde, '>H', 1 << 16),
                        (0xdf, '>I', 1 << 32)))
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError('checkpoint keys must be str, got {!r}'
                                .format(k))
            _pack_str(out, k)
            _pack(out, v)
    elif t in (list, tuple):
        _pack_uint_len(out, len(obj), 0x90,
                       ((None, None, 16), (0xdc, '>H', 1 << 16),
                        (0xdd, '>I', 1 << 32)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError('cannot serialize {} in a checkpoint'.format(
            t.__name__))


def packb(obj):
    """msgpack bytes of `obj`, equal to flax's `msgpack_serialize`."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ---------------------------------------------------------------- decode

class _Reader:

    def __init__(self, data, raw):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str values as bytes (flax reads arrays raw=True)

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n):
        data = bytes(self.take(n))
        return data if self.raw else data.decode('utf-8')

    def map_(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n):
        code = self.unpack('b')
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError('unsupported msgpack ext type {}'.format(code))

    def obj(self):
        b = self.unpack('B')
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b < 0x90:
            return self.map_(b & 0x0f)
        if b < 0xa0:
            return [self.obj() for _ in range(b & 0x0f)]
        if b < 0xc0:
            return self.str_(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in ints:
            return self.unpack(ints[b])
        if b == 0xca:
            return self.unpack('>f')
        if b == 0xcb:
            return self.unpack('>d')
        sizes = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xd9: '>B',
                 0xda: '>H', 0xdb: '>I', 0xdc: '>H', 0xdd: '>I',
                 0xde: '>H', 0xdf: '>I', 0xc7: '>B', 0xc8: '>H',
                 0xc9: '>I'}
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in sizes:
            raise ValueError('unsupported msgpack marker 0x{:02x}'.format(b))
        n = self.unpack(sizes[b])
        if b <= 0xc6:
            return bytes(self.take(n))
        if b <= 0xc9:
            return self.ext(n)
        if b <= 0xdb:
            return self.str_(n)
        if b <= 0xdd:
            return [self.obj() for _ in range(n)]
        return self.map_(n)


def _ndarray_from_payload(data):
    shape, dtype_name, buf = _unpack(data, raw=True)
    if dtype_name == b'bfloat16':
        raise ValueError('bfloat16 checkpoint leaves are not supported '
                         '(vpd_tpu stores parameters in float32)')
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape).copy()  # writable and owning


def _unpack(data, raw):
    reader = _Reader(data, raw)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after msgpack object')
    return obj


def unpackb(data):
    """Inverse of `packb`: nested dicts of numpy arrays, in file order."""
    return _unpack(data, raw=False)


# ---------------------------------------------------------------- files

def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def variables_to_bytes(variables):
    """A flax `{'params', 'batch_stats'}` tree as vpd_tpu's head trainers
    save it (`flax.serialization.to_bytes` of a dict built in that
    order): 'params' first, the keys below sorted, as JAX's tree
    flattening leaves them."""
    return packb({'params': _sorted_tree(variables['params']),
                  'batch_stats': _sorted_tree(
                      variables.get('batch_stats') or {})})


def component_path(save_dir, name, component):
    return os.path.join(save_dir, '{}.{}.ckpt'.format(name, component))


def save_component(save_dir, name, component, tree):
    """Atomic write of one component (temp file + os.replace, fsynced), so
    a crash mid-write never leaves a truncated checkpoint in place."""
    path = component_path(save_dir, name, component)
    data = packb(_sorted_tree(tree))
    _replace_into(path, lambda fp: fp.write(data), 'wb', fsync=True)
    return path


def load_component(save_dir, name, component):
    """The component's nested dict of numpy arrays."""
    with open(component_path(save_dir, name, component), 'rb') as fp:
        return unpackb(fp.read())


def save_bundle(save_dir, name, components):
    """Save {component_name: tree} under one checkpoint name."""
    os.makedirs(save_dir, exist_ok=True)
    for comp, tree in components.items():
        save_component(save_dir, name, comp, tree)


def last_checkpoint_epoch(save_dir, component='encoder'):
    """Largest epoch N with an epoch%04d.{component}.ckpt present, or -1
    (a leftover 'epochNNNN.*.ckpt.tmp' of an interrupted write does not
    count)."""
    pattern = re.compile(r'epoch(\d+)\.' + re.escape(component) + r'\.ckpt')
    last = -1
    for fname in os.listdir(save_dir):
        m = pattern.fullmatch(fname)
        if m:
            last = max(last, int(m.group(1)))
    return last


class MovingAvgSelector:
    """Moving-average validation-loss model selection (reference
    `train_vipe_model.py:228-229,388-423`)."""

    def __init__(self, window=1):
        self.window = window
        self.history = []
        self.best = float('inf')

    def update(self, val_loss):
        """Record a val loss; returns True if this epoch is a new best."""
        self.history.append(val_loss)
        mv_avg = float(np.mean(self.history[-self.window:]))
        is_best = mv_avg < self.best
        self.best = min(self.best, mv_avg)
        return is_best
