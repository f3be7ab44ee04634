"""The flow cell's driver and readers: what a pair costs against a hand
count and against chip_smoke's count of the port's own convolutions, and
the three readers of the program's RAFT spans on synthetic records and
launches, None where a chunk lacks an iteration or the trace its
launches."""

import contextlib
import math

import pytest
import torch

from vpd_tpu_torch.core import profiling
from vpdbench import bench, compare, flow_spans
from vpdbench.drivers import flow
from vpdbench.tests.tiny import REPO, SEED

torch.set_num_threads(2)

READERS = {'flow_encode_ms.infer': 'vpd.flow.encode',
           'flow_lookup_ms.infer': 'vpd.flow.lookup',
           'flow_update_ms.infer': 'vpd.flow.update'}


def cell(**config):
    spec = bench.Spec(REPO)
    w = spec.workload('raft-basic-flow')
    return flow.Cell(dict(spec.config(w['config']), **config),
                     spec.traffic(w['traffic']), SEED, 'cpu')


def encoder_macs(size, out):
    """The official BasicEncoder by hand: a 7x7/2 stem to 64, stages of
    two residual blocks (64; 96 and 128 at stride 2, each with a 1x1
    projection), a 1x1 head to `out`."""
    side = size // 2
    macs = 49 * 3 * 64 * side * side
    cin = 64
    for planes, stride in ((64, 1), (96, 2), (128, 2)):
        side //= stride
        macs += 9 * cin * planes * side * side \
            + 3 * 9 * planes * planes * side * side
        if stride != 1:
            macs += cin * planes * side * side
        cin = planes
    return macs + 128 * out * side * side


def update_macs(cells):
    """The BasicUpdateBlock by hand, a grid cell: motion encoder (324 ->
    256, 256 -> 192 3x3, 2 -> 128 7x7, 128 -> 64 3x3, 256 -> 126 3x3),
    six 1x5 / 5x1 GRU convolutions 384 -> 128, the flow head (128 -> 256
    -> 2, 3x3) and the mask head (128 -> 256 3x3, 256 -> 576)."""
    per = (324 * 256 + 9 * 256 * 192 + 49 * 2 * 128 + 9 * 128 * 64
           + 9 * 256 * 126 + 6 * 5 * 384 * 128 + 9 * 128 * 256
           + 9 * 256 * 2 + 9 * 128 * 256 + 256 * 576)
    return per * cells


def test_costs_match_a_hand_count():
    cells = (128 // 8) ** 2
    macs = 2 * encoder_macs(128, 256) + encoder_macs(128, 256) \
        + 20 * update_macs(cells)
    want = 2 * macs + 2 * cells * cells * 256
    assert cell().costs() == {'infer_per_sample': want}
    assert want / 1e9 == pytest.approx(38.65, abs=0.01)
    # the cut of the CPU tests: 64 x 64, 2 iterations
    cells = (64 // 8) ** 2
    macs = 3 * encoder_macs(64, 256) + 2 * update_macs(cells)
    assert cell(img_dim=64, iters=2).costs() == {
        'infer_per_sample': 2 * macs + 2 * cells * cells * 256}


def test_costs_match_chip_smoke_s_count():
    """chip_smoke's `gflop_per_pair`: 2 x out.numel() x the kernel's
    fan-in of each convolution the port's forward runs, by forward hooks,
    plus B (S/8)^4 256 x 2 for the correlation."""
    from vpd_tpu_torch.models import raft

    model = raft.build_raft()
    total = [0]

    def hook(mod, args, out):
        k = mod.in_channels // mod.groups * mod.kernel_size[0] * \
            mod.kernel_size[1]
        total[0] += 2 * out.numel() * k

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    img = torch.zeros((1, 128, 128, 3), dtype=torch.uint8)
    raft.raft_flow_fn(model, iters=20)(img, img)
    smoke = total[0] + 1 * (128 // 8) ** 4 * 256 * 2
    assert cell().costs()['infer_per_sample'] == smoke


class Book:
    """Records as `span_records` gives them, chunks and their spans, and
    the launches of their trace (`flow_spans.launches`): each span but a
    chunk launches one device event of its given ms inside its host
    stamps."""

    def __init__(self):
        self.records, self.found, self.clock = [], [], 0

    def add(self, name, parent=None, ms=None, **ids):
        rid, start = len(self.records), self.clock
        self.clock += 10
        if ms is not None:
            self.found.append((start + 5, 1e3 * ms))
        self.records.append({'id': rid, 'name': name, 'parent': parent,
                             'thread': 1, 'ids': ids, 'start_ns': start,
                             'end_ns': self.clock, 'device_ms': None})
        return rid

    def chunk(self, iters, encode=10., lookup=1., update=2., skip=None):
        c = self.add('vpd.flow.chunk')
        self.add('vpd.flow.encode', c, encode)
        self.add('vpd.flow.corr', c, 0.5)
        for k in range(iters):
            if k != skip:
                self.add('vpd.flow.lookup', c, lookup, iter=k)
            self.add('vpd.flow.update', c, update, iter=k)
        self.add('vpd.flow.upsample', c, 0.3)
        self.records[c]['end_ns'] = self.clock

    def launches(self):
        sums = [0.]
        for _, us in sorted(self.found):
            sums.append(sums[-1] + us)
        return [ns for ns, _ in sorted(self.found)], sums


def use(monkeypatch, book, dropped=0):
    monkeypatch.setattr(profiling, 'span_records',
                        lambda: profiling.Spans(list(book.records), dropped))


def readings(book, chunks=2, iters=3, kind='flow'):
    return {'kind': kind, 'traffic': {'trace_chunks': chunks},
            'config': {'iters': iters},
            'trace': {'launches': book.launches()}}


def read(name, r):
    return bench.Spec(REPO).reader(name)(r)


def test_launches_match_device_events_to_their_launch():
    """Each device event's time goes to its launch's stamp on the records'
    clock (base + ts in us); a device event with no launch is left out."""
    events = [
        {'cat': 'cuda_runtime', 'ts': 2.5, 'args': {'correlation': 7}},
        {'cat': 'cuda_driver', 'ts': 1.0, 'args': {'correlation': 8}},
        {'cat': 'cpu_op', 'ts': 0.5, 'args': {}},
        {'cat': 'kernel', 'ts': 9., 'dur': 4., 'args': {'correlation': 7}},
        {'cat': 'gpu_memcpy', 'ts': 12., 'dur': 1.5,
         'args': {'correlation': 8}},
        {'cat': 'kernel', 'ts': 13., 'dur': 50., 'args': {'correlation': 9}},
    ]
    assert flow_spans.launches(events, 1000) == ([2000, 3500], [0., 1.5, 5.5])


def test_the_readers_on_synthetic_records(monkeypatch):
    book = Book()
    book.chunk(3, encode=99., lookup=50.)  # older: not read
    book.chunk(3, encode=10., lookup=1., update=2.)
    book.chunk(3, encode=12., lookup=2., update=4.)
    use(monkeypatch, book)
    r = readings(book)
    assert read('flow_encode_ms.infer', r) == pytest.approx(11.)
    assert read('flow_lookup_ms.infer', r) == pytest.approx(4.5)
    assert read('flow_update_ms.infer', r) == pytest.approx(9.)
    for name in READERS:
        assert read(name, readings(book, kind='extract')) is None
        assert read(name, readings(book, chunks=4)) is None  # too few
        assert read(name, readings(book, iters=4)) is None  # a step short
    assert read('encode_ms.infer', dict(r, kind='extract')) is None


@pytest.mark.parametrize('case', ['missing_iteration', 'no_launches',
                                  'dropped', 'no_records'])
def test_the_readers_find_nothing_to_read(monkeypatch, case):
    book = Book()
    if case != 'no_records':
        book.chunk(3)
        book.chunk(3, skip=1 if case == 'missing_iteration' else None)
    if case == 'no_launches':
        book.found = []
    use(monkeypatch, book, dropped=int(case == 'dropped'))
    got = {name: read(name, readings(book)) for name in READERS}
    assert all(v is None for v in got.values()), got


def test_a_traced_tiny_cell_reads_no_device_times():
    """On the CPU the spans carry no device time: the readers are left
    out, the cell's other metrics read."""
    from vpdbench.tests.tiny import run

    line = run('raft-basic-flow', trace=True)
    assert not set(line['metrics']) & set(READERS)
    assert 'idle_pct.infer' in line['metrics'] and line['correct']


def test_the_correlation_check_reads_the_forward_s_own_lookups(
        monkeypatch):
    """`corr_stage_gap` compares the lookups the checked forward made
    through `models/raft.corr_lookup`; a forward that makes none there
    reads inf, and `correct` is false."""
    from vpd_tpu_torch.models import raft
    from vpdbench.tests.tiny import checked

    assert checked('raft-basic-flow').corr_stage_gap < 1e-5
    real = raft.corr_lookup
    forward = raft.RAFT.forward

    def bypassed(self, image1, image2, iters=12, train=False, dtype=None):
        with monkeypatch.context() as m:
            m.setattr(raft, 'corr_lookup', real)
            return forward(self, image1, image2, iters, train, dtype)

    monkeypatch.setattr(raft.RAFT, 'forward', bypassed)
    cell = checked('raft-basic-flow')
    assert cell.corr_stage_gap == math.inf
    assert not compare.judge(cell.numbers(), bench.Spec(REPO).limits(
        'raft-basic-flow'))[0]


@pytest.mark.cuda
def test_the_flow_cell_at_its_size_on_the_card():
    """The cell at its own size on the card: the program passes; the
    float8 control and each fault, planted underneath the timed path, do
    not."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from vpdbench import compare, faults
    from vpdbench.reference.arith import Fp8Arith

    spec = bench.Spec(REPO)
    w = spec.workload('raft-basic-flow')
    cfg, mix = spec.config(w['config']), spec.traffic(w['traffic'])
    limits = spec.limits('raft-basic-flow')

    def checked(fault=None):
        cell = flow.Cell(cfg, mix, SEED, 'cuda')
        with (faults.planted('flow', fault) if fault
              else contextlib.nullcontext()):
            cell.setup()
            cell.window(1.)
        cell.release()
        return cell

    cell = checked()
    assert compare.judge(cell.numbers(), limits)[0], cell.numbers()
    assert not compare.judge(cell.numbers(Fp8Arith()), limits)[0]
    for fault in flow.FAULTS:
        nums = checked(fault).numbers()
        assert not compare.judge(nums, limits)[0], (fault, nums)
