"""File I/O helpers and the `.emb.pkl` interchange format.

Counterpart of `vpd_tpu/core/io.py` (a copy: this package imports nothing
of `vpd_tpu`). The per-video embedding pickle format is the framework's
interchange contract: a list of ``(frame_num, ndarray, metadata_dict)``
tuples, written with plain ``pickle`` so files are byte-compatible with
the JAX package and the reference pipeline. PIL is imported only by the
PNG helpers that need it.
"""

import base64
import functools
import gzip
import json
import os
import pickle
from io import BytesIO

import numpy as np

EMB_FILE_SUFFIX = '.emb.pkl'


def _read(fpath, opener, mode, parse, **open_kwargs):
    with opener(fpath, mode, **open_kwargs) as fp:
        return parse(fp)


def load_json(fpath):
    return _read(fpath, open, 'r', json.load)


def load_gz_json(fpath):
    return _read(fpath, gzip.open, 'rt', json.load, encoding='ascii')


def _replace_into(fpath, write_fn, mode, fsync=False):
    """Write via a same-directory temp file + os.replace: a crash or
    preemption mid-write never leaves a truncated file where a complete
    one belongs. Bytes are identical to a direct write."""
    tmp = fpath + '.tmp'
    try:
        with open(tmp, mode) as fp:
            write_fn(fp)
            if fsync:
                fp.flush()
                os.fsync(fp.fileno())
    except BaseException:
        try:
            os.unlink(tmp)  # drop the partial temp; keep the old file
        except OSError:
            pass
        raise
    os.replace(tmp, fpath)


def store_json(fpath, obj, **kwargs):
    _replace_into(fpath, lambda fp: json.dump(obj, fp, **kwargs), 'w')


def store_gz_json(fpath, obj):
    def write(fp):
        # an explicit filename= keeps the '.tmp' temp name out of the
        # gzip FNAME header (identical to a direct gzip.open(fpath) write)
        import io as _stdio
        with gzip.GzipFile(filename=fpath, fileobj=fp, mode='wb') as gz:
            with _stdio.TextIOWrapper(gz, encoding='ascii') as txt:
                json.dump(obj, txt)
    _replace_into(fpath, write, 'wb')


def load_pickle(fpath):
    return _read(fpath, open, 'rb', pickle.load)


def store_pickle(fpath, obj):
    _replace_into(fpath, lambda fp: pickle.dump(obj, fp), 'wb')


def load_text(fpath):
    """Non-empty stripped lines of a text file."""
    raw = _read(fpath, open, 'r', lambda fp: fp.read())
    return [line for line in map(str.strip, raw.splitlines()) if line]


def store_text(fpath, s):
    _replace_into(fpath, lambda fp: fp.write(s), 'w')


def decode_png(data):
    """Decode a PNG from bytes or a base64 string into an ndarray."""
    from PIL import Image

    if isinstance(data, str):
        data = base64.decodebytes(data.encode())
    elif not isinstance(data, bytes):
        raise TypeError('expected bytes or a base64 str, got {}'.format(
            type(data).__name__))
    return np.array(Image.open(BytesIO(data)))


def encode_png(data, optimize=True):
    """Encode an ndarray as a base64 PNG string."""
    from PIL import Image

    stream = BytesIO()
    Image.fromarray(data).save(stream, format='png', optimize=optimize)
    return base64.encodebytes(stream.getvalue()).decode()


def parse_time(time_str):
    """Parse '[[hh:]mm:]ss.fff' into seconds.

    Whole-unit prefix tokens must parse as ints; only the final token may
    carry a fractional part.
    """
    *whole, last = time_str.split(':')
    if len(whole) > 2:
        raise ValueError('not a [[hh:]mm:]ss time: {!r}'.format(time_str))
    return functools.reduce(
        lambda acc, tok: (acc + int(tok)) * 60, whole, 0) + float(last)


def load_embs_pickle(fpath):
    """Load one video's embeddings: [(frame_num, ndarray, meta), ...]."""
    embs = load_pickle(fpath)
    if not isinstance(embs, list):
        raise ValueError('{} holds a {}, not a list of rows'.format(
            fpath, type(embs).__name__))
    return embs


def store_embs_pickle(fpath, embs):
    """Store one video's embeddings in the interchange format.

    Each element must be ``(frame_num: int, emb: np.ndarray, meta: dict)``;
    ``emb`` is 1-D ``(D,)`` or 2-D ``(num_variants, D)`` (e.g. orig + flip).
    """
    for frame_num, emb, meta in embs:
        if not (isinstance(frame_num, (int, np.integer))
                and isinstance(emb, np.ndarray) and isinstance(meta, dict)):
            raise TypeError('bad .emb.pkl row: ({}, {}, {})'.format(
                type(frame_num).__name__, type(emb).__name__,
                type(meta).__name__))
    store_pickle(fpath, embs)
