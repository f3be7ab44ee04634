"""The port's spans (`vpd_tpu_torch.core.profiling.span`) on the CPU.

- Off (no profiler active) a span makes its one check: it enters no
  `record_function`, makes no CUDA event and keeps no record.
- Under `torch.profiler.profile` a tiny student's cached epoch records
  the tree `vpd.train.epoch` -> `vpd.train.sampler` and -> one
  `vpd.train.input`, `fwd_bwd` and `adamw` a step, each with its step
  id; the streamed step records its input span too.
- The same names are `user_annotation` events of the exported Chrome
  trace, and each record's host stamps lie within 1 ms of its event's
  `ts` on the trace's clock (`baseTimeNanoseconds`).
- The buffer keeps the newest records and counts those it dropped.
- `apply_vpd` records `vpd.extract.encode` once a chunk.

The device times are held on the card (`tests/test_torch_cuda.py`).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vpd_tpu_torch.core import profiling
from vpd_tpu_torch.data.hbm_cache import CacheIndexSource, DeviceCropCache
from vpd_tpu_torch.data.shards import ShardReader, write_raw_shards
from vpd_tpu_torch.infer import apply_vpd as tapply
from vpd_tpu_torch.train import vpd as tvpd
from vpd_tpu_torch.train.vpd_loop import (VPDTrainer, build_student,
                                          default_config)

torch.set_num_threads(2)

IMG, EMB, B, CROPS, STEPS = 32, 4, 4, 12, 3
IMG_DIR = 'crops'
STEP_SPANS = ('vpd.train.input', 'vpd.train.fwd_bwd', 'vpd.train.adamw')


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _prefixes(n):
    return ['{}/v0/{}'.format(IMG_DIR, f) for f in range(n)]


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    """Raw shards of CROPS random crops (rgb, flow, mask) under
    `IMG_DIR/v0/<frame>`."""
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp('spans') / 'shards')
    write_raw_shards(
        path, _prefixes(CROPS),
        rng.integers(0, 256, (CROPS, IMG, IMG, 3), np.uint8),
        flow=rng.integers(0, 256, (CROPS, IMG, IMG, 3), np.uint8),
        flow_img_name='flow',
        mask=(rng.random((CROPS, IMG, IMG)) < 0.5).astype(np.uint8) * 255,
        rows_per_shard=5)
    return path


def _config():
    return default_config('fs', EMB, batch_size=B, img_dim=IMG,
                          use_flow=True, motion=True,
                          encoder_arch='resnet18')


def _trainer(shards):
    cache = DeviceCropCache(ShardReader(shards), use_flow=True,
                            device='cpu', log=lambda *a: None)
    rng = np.random.default_rng(1)
    samples = [('v0', None, f, rng.standard_normal((2, 2 * EMB)).astype(
        np.float32)) for f in range(CROPS)]
    source = CacheIndexSource(samples, IMG_DIR, IMG, B, cache=cache,
                              target_len=STEPS * B, flow_img_name='flow',
                              seed=3)
    return VPDTrainer(source, None, _config(), seed=5,
                      dtype=torch.float32, device='cpu')


@pytest.fixture(scope='module')
def traced_epoch(shards, tmp_path_factory):
    """(records, Chrome trace) of one cached epoch under the profiler,
    the trainer's first epoch run before it untraced."""
    trainer = _trainer(shards)
    profiling.clear_spans()
    trainer.train_one_epoch(1)
    untraced = profiling.span_records()
    path = str(tmp_path_factory.mktemp('trace') / 'trace.json')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_one_epoch(2)
    prof.export_chrome_trace(path)
    spans = profiling.span_records()
    profiling.clear_spans()
    with open(path) as fp:
        chrome = json.load(fp)
    return untraced, spans, chrome


def test_span_off_makes_one_check_and_nothing_else(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('made while no profiler is active')

    checks = []

    def enabled():
        checks.append(1)
        return False

    monkeypatch.setattr(profiling, '_profiler_enabled', enabled)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.cuda, 'Event', refuse)
    monkeypatch.setattr(profiling, '_Span', refuse)
    with profiling.span('vpd.test.outer', 'cuda', step=1) as outer:
        with profiling.span('vpd.test.inner', torch.device('cuda')):
            pass
    assert outer is None and len(checks) == 2
    records, dropped = profiling.span_records()
    assert records == [] and dropped == 0


def test_span_off_keeps_no_record_through_an_epoch(shards):
    trainer = _trainer(shards)
    trainer.train_one_epoch(1)
    assert profiling.span_records() == ([], 0)


def test_cached_epoch_records_the_span_tree(traced_epoch):
    untraced, (records, dropped), _ = traced_epoch
    assert untraced == ([], 0) and dropped == 0
    by_name = {}
    for r in records:
        by_name.setdefault(r['name'], []).append(r)
    assert sorted(by_name) == sorted(('vpd.train.epoch',
                                      'vpd.train.sampler') + STEP_SPANS)
    (epoch,) = by_name['vpd.train.epoch']
    assert epoch['parent'] is None and epoch['ids'] == {'epoch': 2}
    assert [r['ids'] for r in by_name['vpd.train.sampler']] == [
        {'epoch': 2, 'batch': i} for i in range(STEPS)]
    # the first epoch took steps 0..STEPS-1
    steps = list(range(STEPS, 2 * STEPS))
    for name in STEP_SPANS:
        assert [r['ids'] for r in by_name[name]] == [
            {'step': s} for s in steps], name
    for r in records:
        assert r['thread'] == epoch['thread'] and r['device_ms'] is None
        assert epoch['start_ns'] <= r['start_ns'] <= r['end_ns'] <= \
            epoch['end_ns']
        if r is not epoch:
            assert r['parent'] == epoch['id'], r['name']
    # a step's spans follow one another, after its batch was drawn
    for i in range(STEPS):
        chain = [by_name['vpd.train.sampler'][i]] + [
            by_name[name][i] for name in STEP_SPANS]
        for a, b in zip(chain[:-1], chain[1:]):
            assert a['end_ns'] <= b['start_ns'], (a['name'], b['name'])


def test_spans_are_trace_events_on_the_trace_s_clock(traced_epoch):
    _, (records, _), chrome = traced_epoch
    base = int(chrome['baseTimeNanoseconds'])
    events = {}
    for e in chrome['traceEvents']:
        if e.get('cat') == 'user_annotation' and \
                e.get('name', '').startswith('vpd.'):
            events.setdefault(e['name'], []).append(e)
    names = {r['name'] for r in records}
    assert names == set(events)
    for name in names:
        mine = [r for r in records if r['name'] == name]
        theirs = sorted(events[name], key=lambda e: float(e['ts']))
        assert len(mine) == len(theirs), name
        for r, e in zip(mine, theirs):
            lo = float(e['ts']) * 1e3 + base
            hi = lo + float(e['dur']) * 1e3
            assert abs(r['start_ns'] - lo) < 1e6, (name, r['start_ns'] - lo)
            assert abs(r['end_ns'] - hi) < 1e6, (name, r['end_ns'] - hi)


@pytest.mark.parametrize('cached', [True, False])
def test_a_step_records_its_input_span(shards, cached):
    """One step of `make_cached_train_step` or `make_train_step`: one
    input, one fwd_bwd and one adamw span, all with the step's id."""
    cfg = _config()
    torch.manual_seed(0)
    state = tvpd.create_state(build_student(
        cfg, dtype=torch.float32, param_dtype=torch.float32), 1e-3)
    state.step = 7
    reader = ShardReader(shards)
    idx = torch.tensor([0, 3, 5, 11], dtype=torch.int32)
    batch = {'emb': torch.zeros(B, 2 * EMB), 'flip': torch.tensor(
        [False, True, False, True])}
    kw = dict(img_dim=IMG, use_flow=True, aug_dtype=torch.float32)
    if cached:
        cache = DeviceCropCache(reader, use_flow=True, device='cpu',
                                log=lambda *a: None).arrays
        step = tvpd.make_cached_train_step(*cfg['rgb_mean_std'], **kw)
        args = ({**batch, 'idx': idx}, 1, cache)
    else:
        rows = {k: torch.from_numpy(np.concatenate(s))[idx.long()]
                for k, s in (('rgb', reader._rgb), ('flow', reader._flow),
                             ('mask', reader._mask))}
        step = tvpd.make_train_step(*cfg['rgb_mean_std'], **kw)
        args = ({**batch, **rows}, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, *args)
    records, _ = profiling.span_records()
    assert [(r['name'], r['ids']) for r in records] == [
        (name, {'step': 7}) for name in STEP_SPANS]
    assert state.step == 8


def test_the_buffer_keeps_the_newest_and_counts_the_dropped():
    recorder = profiling.SpanRecorder(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with recorder.span('vpd.test', i=i):
                pass
    records, dropped = recorder.records()
    assert [r['ids'] for r in records] == [{'i': 2}, {'i': 3}, {'i': 4}]
    assert dropped == 2
    recorder.clear()
    assert recorder.records() == ([], 0)
    assert profiling.span_records() == ([], 0)


def test_apply_vpd_records_one_encode_span_a_chunk(shards, tmp_path):
    cfg = _config()
    torch.manual_seed(0)
    model = build_student(cfg, dtype=torch.float32).eval()
    tasks = [(0, f, p) for f, p in enumerate(_prefixes(CROPS))]
    with profile(activities=[ProfilerActivity.CPU]):
        tapply.apply_vpd(['v0'], tasks, None, str(tmp_path / 'out'),
                         flow_img_name='flow', batch_size=5,
                         prepared=(model, cfg), log=lambda *a: None,
                         shard_reader=ShardReader(shards), device='cpu')
    records, _ = profiling.span_records()
    assert [(r['name'], r['ids'], r['parent']) for r in records] == [
        ('vpd.extract.encode', {'chunk': i}, None) for i in range(3)]
    assert os.path.exists(tmp_path / 'out' / 'v0.emb.pkl')
