"""The port's CLI flags against vpd_tpu's, and every port tool's --help.

An AST diff of argparse `add_argument` calls between `vpd_tpu/tools/*.py`
and `vpd_tpu_torch/tools/*.py` for every tool both packages have: the
same flags, except the port's `--device` (its entry points run on the
GPU unless asked for the CPU) and three flags the port drops:
`apply_vpd --preprocess` (one preprocess, the CUDA kernel or its plain
twin), `bench_preprocess --block_bs` (the CUDA kernel has no block of
samples to tune) and `bench_pipeline_e2e --platform` (the port's
`--device` is passed on to each stage instead). Every vpd_tpu tool has a
counterpart; `bench_pallas_preprocess`'s is named `bench_preprocess`, as
the port names the kernel's module.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = os.path.join(REPO, 'vpd_tpu', 'tools')
PORT_TOOLS = os.path.join(REPO, 'vpd_tpu_torch', 'tools')

NOT_TOOLS = {'__init__', 'paths'}
NOT_PORTED = set()
COMMON = [
    'apply_vipe', 'apply_vpd', 'bench_ensemble_train', 'bench_extract_e2e',
    'bench_pipeline_e2e', 'bench_preprocess', 'bench_train_e2e',
    'compute_flow', 'detect', 'dummy_2d_features', 'export_torch_model',
    'extract_square_crops', 'import_torch_model', 'pack_crops',
    'plot_losses', 'preprocess_3d_pose', 'recognize', 'recut_finegym_video',
    'recut_fs_video', 'stack_features', 'train_vipe', 'train_vpd',
    'view_2d_pose',
]
# a port tool's vpd_tpu counterpart, where the names differ
JAX_NAME = {'bench_preprocess': 'bench_pallas_preprocess'}
# the counterpart of `__graft_entry__.dryrun_multichip`, not of a tool
PORT_ONLY_TOOLS = {'dryrun_multichip'}
PORT_ONLY_FLAGS = {'--device'}
DROPPED_FLAGS = {'apply_vpd': {'--preprocess'},
                 'bench_preprocess': {'--block_bs'},
                 'bench_pipeline_e2e': {'--platform'}}


def _tools(path):
    return {f[:-3] for f in os.listdir(path)
            if f.endswith('.py') and f[:-3] not in NOT_TOOLS}


def flag_names(path):
    with open(path) as fp:
        tree = ast.parse(fp.read())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == 'add_argument'):
            names.update(
                a.value for a in node.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str))
    return names


def test_the_port_has_every_tool_but_benchmarks():
    """Every vpd_tpu tool, its benchmarks included, has a counterpart."""
    ported = {JAX_NAME.get(t, t) for t in COMMON}
    assert _tools(PORT_TOOLS) == set(COMMON) | PORT_ONLY_TOOLS
    assert _tools(JAX_TOOLS) - ported == NOT_PORTED
    assert ported <= _tools(JAX_TOOLS)
    assert len(COMMON) == 23


@pytest.mark.parametrize('tool', COMMON)
def test_port_flags_equal_vpd_tpu(tool):
    want = flag_names(os.path.join(JAX_TOOLS, JAX_NAME.get(tool, tool)
                                   + '.py'))
    got = flag_names(os.path.join(PORT_TOOLS, tool + '.py'))
    assert want, tool
    assert want - got == DROPPED_FLAGS.get(tool, set()), \
        '{} lacks vpd_tpu flags {}'.format(tool, sorted(want - got))
    assert got - want <= PORT_ONLY_FLAGS, \
        '{} adds flags {}'.format(tool, sorted(got - want - PORT_ONLY_FLAGS))


@pytest.mark.parametrize('tool', COMMON)
def test_port_tool_help(tool):
    result = subprocess.run(
        [sys.executable, '-m', 'vpd_tpu_torch.tools.{}'.format(tool),
         '--help'], capture_output=True, timeout=180, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert result.returncode == 0, result.stderr.decode()[-2000:]
    assert b'usage' in result.stdout.lower()
