"""Import guard: the port and chip_smoke.py never load JAX or vpd_tpu.

Importing `vpd_tpu` pulls in jax and turns on the XLA compile cache, and
the GPU host has no JAX at all, so `vpd_tpu_torch` (every submodule) and
`chip_smoke.py` must import neither. Checked both in a fresh interpreter
and in the sources.
"""

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'vpd_tpu')

_PROBE = r'''
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import vpd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vpd_tpu_torch.__path__,
                                               'vpd_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its import block, not main()
forbidden = {forbidden!r}
print(json.dumps({{'modules': names, 'loaded': sorted(
    m for m in sys.modules if m.split('.')[0] in forbidden)}}))
'''


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run(
        [sys.executable, '-c', _PROBE.format(repo=REPO,
                                             forbidden=FORBIDDEN)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert 'vpd_tpu_torch.infer.apply_vpd' in out['modules']
    assert 'vpd_tpu_torch.tools.apply_vpd' in out['modules']
    for name in ('tasks.recognize', 'tools.recognize', 'ops.dtw_kernel',
                 'train.vpd', 'train.vpd_loop', 'tools.train_vpd',
                 'core.metrics', 'data.hbm_cache', 'data.native_loader',
                 'data.parallel_batcher', 'models.torch_compat',
                 'tools.pack_crops'):
        assert 'vpd_tpu_torch.' + name in out['modules']
    assert out['loaded'] == []


def port_sources(root):
    """The `.py` files of the port under `root`: `vpd_tpu_torch/` without
    its gitignored build directory, whose contents are build outputs (and
    may be stale copies of anything)."""
    files = []
    for dirpath, dirnames, names in os.walk(os.path.join(root,
                                                         'vpd_tpu_torch')):
        dirnames[:] = [d for d in dirnames if d != '_build']
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    return files


def forbidden_imports(files):
    """{file: forbidden modules it imports}, by reading the sources."""
    pattern = re.compile(r'^\s*(?:from|import)\s+({})\b'.format(
        '|'.join(FORBIDDEN)), re.M)
    offenders = {}
    for path in files:
        with open(path) as fp:
            found = pattern.findall(fp.read())
        if found:
            offenders[path] = found
    return offenders


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, 'chip_smoke.py')] + port_sources(REPO)
    assert len(files) > 20
    assert forbidden_imports(files) == {}


def test_port_sources_skip_the_build_dir(tmp_path):
    pkg = tmp_path / 'vpd_tpu_torch'
    (pkg / '_build' / 'copy' / 'vpd_tpu_torch').mkdir(parents=True)
    (pkg / 'ok.py').write_text('import torch\n')
    stale = pkg / '_build' / 'copy' / 'vpd_tpu_torch' / 'stale.py'
    stale.write_text('import jax\n')
    files = port_sources(str(tmp_path))
    assert files == [str(pkg / 'ok.py')]
    assert forbidden_imports([str(stale)]) == {str(stale): ['jax']}
