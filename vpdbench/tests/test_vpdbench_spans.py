"""The readers of the program's spans (`vpdbench/spans.py` and the six
metrics that use it) on synthetic records, None where there is nothing to
read, and a traced tiny cell on the CPU."""

import builtins

import pytest
import torch

from vpd_tpu_torch.core import profiling
from vpdbench import bench
from vpdbench.tests.tiny import REPO, run

torch.set_num_threads(2)

TRAIN = ('input_ms.train', 'fwd_bwd_ms.train', 'adamw_ms.train',
         'epoch_self_ms.train', 'sampler_host_ms.train')


def reader(name):
    return bench.Spec(REPO).reader(name)


class Book:
    """Records as `span_records` gives them."""

    def __init__(self):
        self.records = []

    def add(self, name, parent=None, device_ms=None, host_ms=0., **ids):
        rid = len(self.records)
        start = 1000 * rid
        self.records.append({
            'id': rid, 'name': name, 'parent': parent, 'thread': 1,
            'ids': ids, 'start_ns': start,
            'end_ns': start + int(host_ms * 1e6), 'device_ms': device_ms})
        return rid

    def epoch(self, epoch, steps, step0=0, epoch_ms=100., sampler_ms=2.):
        e = self.add('vpd.train.epoch', device_ms=epoch_ms, epoch=epoch)
        for i in range(steps):
            self.add('vpd.train.sampler', e, host_ms=sampler_ms,
                     epoch=epoch, batch=i)
            for name, ms in (('input', 3.), ('fwd_bwd', 10.),
                             ('adamw', .5)):
                self.add('vpd.train.' + name, e, ms, step=step0 + i)
        return e


def use(monkeypatch, book, dropped=0):
    monkeypatch.setattr(profiling, 'span_records',
                        lambda: profiling.Spans(list(book.records), dropped))


def train_readings(epochs=2):
    return {'kind': 'train', 'traffic': {'trace_epochs': epochs}}


def test_train_readers_on_synthetic_records(monkeypatch):
    book = Book()
    book.epoch(1, 4, epoch_ms=500., sampler_ms=50.)  # older: not read
    book.epoch(2, 3, step0=4, epoch_ms=60.)
    book.epoch(3, 3, step0=7, epoch_ms=70., sampler_ms=4.)
    use(monkeypatch, book)
    r = train_readings()
    assert reader('input_ms.train')(r) == pytest.approx(3.)
    assert reader('fwd_bwd_ms.train')(r) == pytest.approx(10.)
    assert reader('adamw_ms.train')(r) == pytest.approx(.5)
    # 60 - 3 x 13.5 and 70 - 3 x 13.5
    assert reader('epoch_self_ms.train')(r) == pytest.approx(24.5)
    assert reader('sampler_host_ms.train')(r) == pytest.approx(3.)
    assert reader('encode_ms.infer')(r) is None


def test_encode_reader_on_synthetic_records(monkeypatch):
    book = Book()
    book.add('vpd.extract.encode', device_ms=99., chunk=0)  # warm-up
    for i in range(3):
        book.add('vpd.extract.encode', device_ms=12. + i, chunk=i + 1)
    use(monkeypatch, book)
    r = {'kind': 'extract', 'traffic': {'trace_chunks': 3}}
    assert reader('encode_ms.infer')(r) == pytest.approx(13.)
    assert reader('input_ms.train')(r) is None
    r['traffic']['trace_chunks'] = 5
    assert reader('encode_ms.infer')(r) is None


@pytest.mark.parametrize('case', ['no_records', 'dropped', 'no_device_ms',
                                  'too_few_epochs', 'no_recorder'])
def test_readers_find_nothing_to_read(monkeypatch, case):
    book = Book()
    if case != 'no_records':
        book.epoch(1, 2)
        book.epoch(2, 2, step0=2)
    if case == 'no_device_ms':
        for rec in book.records:
            rec['device_ms'] = None
    use(monkeypatch, book, dropped=int(case == 'dropped'))
    if case == 'no_recorder':  # a program from before the recorder
        real = builtins.__import__

        def refuse(name, *args, **kwargs):
            if name == 'vpd_tpu_torch.core.profiling':
                raise ImportError(name)
            return real(name, *args, **kwargs)

        monkeypatch.setattr(builtins, '__import__', refuse)
    r = train_readings(3 if case == 'too_few_epochs' else 2)
    for name in TRAIN:
        got = reader(name)(r)
        if case == 'no_device_ms' and name == 'sampler_host_ms.train':
            assert got == pytest.approx(2.)  # host stamps alone
        else:
            assert got is None, name


def test_a_traced_tiny_cell_reads_the_host_spans():
    """On the CPU the spans have host stamps and no device time: the
    sampler's host ms is read, the device-ms metrics are left out."""
    line = run('r34-train-cache', trace=True)
    got = set(line['metrics'])
    assert 'sampler_host_ms.train' in got
    assert not got & {'input_ms.train', 'fwd_bwd_ms.train',
                      'adamw_ms.train', 'epoch_self_ms.train'}
    line = run('r34-extract-pinned', trace=True)
    assert 'encode_ms.infer' not in line['metrics']
