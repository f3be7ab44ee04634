"""Each cell at a tiny size on the CPU: a well-formed result line, the
reference agreeing with the program, faults and the control failing.

The sizes are cut and the program computes in float32 here, so that a
sound run must agree with the reference to rounding; the cells' bf16
readings and their limits come from the card (PERF.md).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from vpdbench import bench, compare, faults
from vpdbench.reference.arith import Fp8Arith
from vpdbench.tests.tiny import REPO, SEED, checked, driver, run

torch.set_num_threads(2)

CELLS = [w['name'] for w in bench.Spec(REPO).bench['workloads']]


def kind(workload):
    spec = bench.Spec(REPO)
    return spec.traffic(spec.workload(workload)['traffic'])['driver']


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('trace', [False, True])
def test_a_run_prints_a_well_formed_line(workload, trace):
    r = run(workload, trace=trace)
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == 'checks'
    for key in ('correct', 'attempted', 'failed', 'metrics', 'device'):
        assert key in line
    assert line['correct'] is True, line['checks']
    assert line['failed'] == 0 and line['attempted'] > 0
    wanted = {m['name'] for m in bench.Spec(REPO).metrics(workload, trace)}
    # the CPU has no entry in the table of peaks and no device events:
    # those metrics are left out, the rest are there
    got = set(line['metrics'])
    assert got <= wanted
    assert ({'setup_s'} if not trace else {
        'idle_pct.' + driver(workload).MEASURES} & wanted) <= got
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'}
    assert line['device']['platform'] == 'cpu'
    if trace:
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
        assert line['device']['window_s'] > 0


@pytest.mark.parametrize('workload', CELLS)
def test_the_reference_computes_the_program_s_function(workload):
    """In float32 the first step's loss and gradient, and every embedding,
    agree with the reference to float32 rounding (a BatchNorm leaf's
    gradient, a sum that cancels, to some 1e-3 of the median leaf); a
    driver's numbers without a tighter rule here are held to the cell's
    limits."""
    n = checked(workload).numbers()
    if kind(workload) == 'train':
        assert n['loss1_gap'] < 1e-5 and n['loss_stage_gap'] < 1e-5
        assert n['fwd_gap_median'] < 1e-4 and n['pred_gap_median'] < 1e-4
        assert n['grad_gap_median'] < 1e-4
        assert n['grad_gap'] < 1e-2
    elif kind(workload) == 'extract':
        assert n['emb_gap'] < 1e-4
    else:
        assert compare.judge(n, bench.Spec(REPO).limits(workload))[0], n


# the metrics each student cell reports at its CPU cut, where the table
# of peaks has no entry and the spans carry no device time
READ_BEFORE = {
    'r34-train-cache': ({'setup_s', 'train_samples_per_s'},
                        {'idle_pct.train', 'sampler_host_ms.train',
                         'sampler_ms.train'}),
    'r34-extract-pinned': ({'infer_samples_per_s', 'setup_s'},
                           {'idle_pct.infer'}),
    'b0-train-cache': ({'setup_s', 'train_samples_per_s'},
                       {'idle_pct.train', 'sampler_host_ms.train',
                        'sampler_ms.train'}),
}


@pytest.mark.parametrize('workload', sorted(READ_BEFORE))
def test_the_student_cells_read_as_before(workload, monkeypatch):
    """The student drivers' costs are the counts of `vpdbench/flops.py`
    for the cell's configuration, at its own size and at its cut, and
    plain and traced runs report the metrics they did."""
    from vpdbench import flops

    spec = bench.Spec(REPO)
    w = spec.workload(workload)
    cfg, mix = spec.config(w['config']), spec.traffic(w['traffic'])
    counts = {'train_per_sample': flops.train_flops_per_sample(cfg),
              'infer_per_sample': flops.infer_flops_per_sample(cfg)}
    assert driver(workload).Cell(cfg, mix, SEED, 'cpu').costs() == counts
    seen = []
    reader = bench.Spec.reader

    def keeping(self, name):
        read = reader(self, name)
        return lambda r: seen.append(r) or read(r)

    monkeypatch.setattr(bench.Spec, 'reader', keeping)
    for trace, names in enumerate(READ_BEFORE[workload]):
        assert set(run(workload, trace=bool(trace))['metrics']) == names
        r = seen[-1]
        assert r['kind'] == kind(workload)
        assert r['costs'] == {
            'train_per_sample': flops.train_flops_per_sample(r['config']),
            'infer_per_sample': flops.infer_flops_per_sample(r['config'])}


FAULTS = [(w, f) for w in CELLS for f in driver(w).FAULTS]


@pytest.mark.parametrize('workload,fault', FAULTS)
def test_a_fault_underneath_makes_correct_false(workload, fault):
    with faults.planted(kind(workload), fault):
        r = run(workload)
    assert r['correct'] is False, r['checks']


@pytest.mark.parametrize('workload', CELLS)
def test_the_control_fails(workload):
    """The reference in float8 e4m3 products in the program's place fails
    one of the cell's limits."""
    ok, checks = compare.judge(checked(workload).numbers(Fp8Arith()),
                               bench.Spec(REPO).limits(workload))
    assert not ok, checks


def test_the_command_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, '-m', 'vpdbench.run', '--workload', CELLS[0],
         '--seed', str(SEED), '--seconds', '1', '--trace', '0'],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0 and proc.stdout == ''
    assert 'CUDA' in proc.stderr


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cell_size():
    """The extraction cell at its own size on the card: the program
    passes, the float8 control does not."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from vpdbench.drivers import extract

    spec = bench.Spec(REPO)
    w = spec.workload('r34-extract-pinned')
    cfg, mix = spec.config(w['config']), spec.traffic(w['traffic'])
    cell = extract.Cell(cfg, mix, SEED, 'cuda')
    cell.setup()
    cell.window(1.)
    cell.release()
    limits = spec.limits('r34-extract-pinned')
    assert compare.judge(cell.numbers(), limits)[0]
    assert not compare.judge(cell.numbers(Fp8Arith()), limits)[0]
