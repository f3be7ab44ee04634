"""What a run and the reference load: never JAX or the JAX package
`vpd_tpu` (top-level names compared whole: `vpd_tpu_torch` is the port),
and the reference nothing of the port either."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest

from vpdbench import bench
from vpdbench.tests.tiny import REPO

CELLS = [w['name'] for w in bench.Spec(REPO).bench['workloads']]

_RUN = r'''
import json, sys
sys.path.insert(0, {repo!r})
from vpdbench.tests.tiny import run
from vpdbench import bench
run({workload!r}, trace=True)
print(json.dumps(bench.forbidden_modules()))
'''

_REFERENCE = r'''
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import vpdbench.reference as ref
for m in pkgutil.walk_packages(ref.__path__, 'vpdbench.reference.'):
    importlib.import_module(m.name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                               'vpd_tpu', 'vpd_tpu_torch'))))
'''


def _probe(code):
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('workload', CELLS)
def test_a_run_loads_no_jax(workload):
    assert _probe(_RUN.format(repo=REPO, workload=workload)) == []


def test_the_reference_loads_neither_jax_nor_the_port():
    assert _probe(_REFERENCE.format(repo=REPO)) == []


def test_no_source_imports_jax_and_the_reference_not_the_port():
    pattern = re.compile(r'^\s*(?:from|import)\s+([\w.]+)', re.M)
    root = os.path.join(REPO, 'vpdbench')
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as fp:
                tops = {m.split('.')[0] for m in pattern.findall(fp.read())}
            assert not tops & {'jax', 'jaxlib', 'flax', 'vpd_tpu'}, path
            if os.sep + 'reference' + os.sep in path:
                assert 'vpd_tpu_torch' not in tops, path


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'vpd_tpu_torch_like', object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'vpd_tpu.core', object())
    assert bench.forbidden_modules() == ['vpd_tpu.core']


def test_the_reference_package_is_walked():
    import vpdbench.reference as ref

    names = {m.name for m in pkgutil.walk_packages(ref.__path__)}
    assert {'resnet', 'efficientnet', 'augment', 'preprocess', 'student',
            'arith'} <= names
