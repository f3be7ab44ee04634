"""ptxas's resource report as `vpd_tpu_torch/ops/_build.py` reads it.

ptxas's `-v` report is read here from a sample in its own format: the
card-only tests (`tests/test_torch_cuda.py`) read the real one, since
nvcc exists only on the GPU host.
"""

import pytest
import torch

from vpd_tpu_torch.ops import _build

torch.set_num_threads(2)

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z17preprocess_vectorILi5ELi3EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z17preprocess_vectorILi5ELi3EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 42 registers, used 1 barriers
ptxas info    : Compile time = 49.752 ms
ptxas info    : Compiling entry function '_Z18preprocess_generalILi5EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z18preprocess_generalILi5EEvv
    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z10dtw_kernelILi8EEvv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem
"""


def test_ptxas_resources_reads_each_entry_function():
    assert _build.ptxas_resources(REPORT) == [
        {'kernel': '_Z17preprocess_vectorILi5ELi3EEvv', 'stack_bytes': 0,
         'spill_store_bytes': 0, 'spill_load_bytes': 0, 'registers': 42},
        {'kernel': '_Z18preprocess_generalILi5EEvv', 'stack_bytes': 16,
         'spill_store_bytes': 12, 'spill_load_bytes': 28, 'registers': 40},
        {'kernel': '_Z10dtw_kernelILi8EEvv', 'stack_bytes': 0,
         'spill_store_bytes': 0, 'spill_load_bytes': 0, 'registers': 128}]


def test_ptxas_resources_of_an_empty_report():
    assert _build.ptxas_resources('') == []


def test_ptxas_report_rejects_unknown_sources():
    with pytest.raises(ValueError, match='nope.cu'):
        _build.ptxas_report(['preprocess.cu', 'nope.cu'])
