"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

At first use every `vpd_tpu_torch/csrc/*.cu` is compiled for sm_90a, one
nvcc process per source, all started together, and linked into one shared
library with a plain C interface:

    vpd_tpu_torch/_build/<hash>/libvpd_tpu_torch_kernels.so

`<hash>` covers the sources and the flags, so an edited source rebuilds
and a stale library is never loaded. Every file is written under a temp
name and `os.replace`d into place, so concurrent builds (test workers, a
smoke run) cannot race. No PyTorch headers are compiled: a build takes
seconds. A missing nvcc or a failed build raises with the compiler's
output.

    python -m vpd_tpu_torch.ops._build

compiles every source once more with `-Xptxas -v` and prints ptxas's
report: registers, spill stores and loads, and static shared memory of
each kernel. `ptxas_resources` reads that report into one record a
kernel.

`build_locked` builds a host (C++) library into the same directory: the
native PNG decoder (`data/native_loader.py`) over `native/crop_loader.cpp`.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR / '_build'
LIB_NAME = 'libvpd_tpu_torch_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC')

# ctypes signatures of the exported entry points: restype, argtypes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # rgb, flow, flow_c, flip, out, B, H, W, mean x3, inv_std x3, mode,
    # vector, stream -> cudaError_t
    'vpd_preprocess_crops': (_I, (_P, _P, _I, _P, _P, _I, _I, _I,
                                  _F, _F, _F, _F, _F, _F, _I, _I, _P)),
    # q, q_lens, t, t_lens, out, Q, T, L, D, step_pattern, stream
    # -> cudaError_t
    'vpd_dtw_matrix': (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    # L, D, step_pattern, info (int[5]) -> cudaError_t
    'vpd_dtw_kernel_info': (_I, (_I, _I, _I, ctypes.POINTER(_I))),
}


def find_nvcc():
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default home."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin',
                                       'nvcc'))
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(on_path)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        'nvcc not found (looked in $CUDA_HOME/bin, $PATH and '
        '/usr/local/cuda/bin): the CUDA toolkit is needed to build the '
        'kernels in {}'.format(SRC_DIR))


def sources():
    srcs = sorted(SRC_DIR.glob('*.cu'))
    if not srcs:
        raise RuntimeError('no CUDA sources in {}'.format(SRC_DIR))
    return srcs


def source_hash():
    """Hash of the flags and every file in csrc/ (sources and headers)."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.iterdir()):
        h.update(path.name.encode() + b'\0' + path.read_bytes())
    return h.hexdigest()[:16]


def _run(procs):
    """Wait for every (cmd, Popen); raise with the output of any failure."""
    failures = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append('$ {}\n{}'.format(' '.join(cmd), out))
    if failures:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))


def build():
    """Compile the sources if this hash is not built yet; the .so path."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs, objs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', obj]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        _run(procs)
        tmp_lib = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, '-shared', *objs, '-o', tmp_lib]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_kernels():
    """The kernels' shared library, built if needed, with typed entries."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def build_locked(src, lib_path, extra_flags=()):
    """Race-safe on-demand g++ build of a host library (the port's copy of
    vpd_tpu's helper). Decode workers and test processes may all find the
    library missing at once: an exclusive flock serializes the compile,
    the output lands in a pid-unique temp file, and os.replace publishes
    it, so a concurrent dlopen never sees a half-written library. Rebuilds
    when `src` is newer than `lib_path`."""
    import fcntl

    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    with open(str(lib_path) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib_path) and (
                    os.path.getmtime(lib_path) >= os.path.getmtime(src)):
                return  # another process built it while we waited
            tmp = '{}.tmp.{}'.format(lib_path, os.getpid())
            subprocess.check_call(
                ['g++', '-O3', '-march=native', '-shared', '-fPIC',
                 '-o', tmp, str(src)] + list(extra_flags))
            os.replace(tmp, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def ptxas_report(names=None):
    """ptxas's resource report for every kernel in csrc/, or in the
    sources named (e.g. ['preprocess.cu']), as text."""
    srcs = [s for s in sources() if names is None or s.name in names]
    if names is not None and len(srcs) != len(set(names)):
        raise ValueError('no such sources in {}: {}'.format(
            SRC_DIR, sorted(set(names) - {s.name for s in srcs})))
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in srcs:
            cmd = [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-c', str(src), '-o',
                   os.path.join(tmp, src.stem + '.o')]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outs = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed:\n$ {}\n{}'.format(
                    ' '.join(cmd), out))
            outs.append(out)
    return ''.join(outs)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                     r'(\d+) bytes spill loads')
_REGISTERS = re.compile(r'Used (\d+) registers')


def ptxas_resources(report):
    """One record per entry function of a `ptxas_report`: its (mangled)
    name, registers, stack frame and spill store and load bytes."""
    kernels = []
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            kernels.append({'kernel': m.group(1)})
            continue
        m = _SPILLS.search(line)
        if m and kernels:
            kernels[-1].update(zip(('stack_bytes', 'spill_store_bytes',
                                    'spill_load_bytes'),
                                   map(int, m.groups())))
            continue
        m = _REGISTERS.search(line)
        if m and kernels:
            kernels[-1]['registers'] = int(m.group(1))
    return kernels


if __name__ == '__main__':
    sys.stdout.write(ptxas_report())
