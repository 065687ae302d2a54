"""Build, load and launch the port's hand-written CUDA kernels.

The kernels live in ``skypilot_tpu_torch/csrc/*.cu`` behind a plain C
interface.  At first use every source compiles with ``nvcc`` for
``sm_90a`` into an object file, all sources at once in parallel, and the
objects link into one shared library under ``build/torch_kernels/`` at the
root of the checkout.  The library's name carries a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one loads
the library already built.  Python loads it with ``ctypes``: every pointer
and the CUDA stream pass as ``c_void_p`` (ctypes would otherwise cut them
to 32 bits), and every entry point returns 0 or an error code, which
:func:`launch` turns into an exception.

Nothing here runs at import time: the CPU-only test environment imports
every module of the package and has neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas=-v')

# Dtype codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'skk_rmsnorm': [_P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _I,
                    _P],
    'skk_paged_decode': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, ctypes.c_float, _I, _P],
    'skk_flash_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.c_float, _P, _I, _P],
}


class _Library:
    """The loaded kernel library, built on first use (once per process)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ''

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                self.path = _build(self)
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.skk_error_string.argtypes = [_I]
                lib.skk_error_string.restype = ctypes.c_char_p
                self.build_seconds = time.perf_counter() - t0
                self._lib = lib
            return self._lib


LIBRARY = _Library()


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found on PATH or under CUDA_HOME: the '
                       'CUDA kernels are built from source and need the '
                       'CUDA toolkit')


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob('*.cu'))


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob('*.cu*')):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(library: _Library) -> Path:
    """Compile every csrc/*.cu in parallel and link one .so; returns
    its path.  A library whose hash matches the sources is reused."""
    lib_path = BUILD_DIR / f'libskypilot_torch_kernels_{_digest()}.so'
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    work = BUILD_DIR / f'objs_{lib_path.stem}_{os.getpid()}'
    work.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in _sources():
            obj = work / (src.stem + '.o')
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            library.build_log += f'== {src.name}\n{out}'
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n'
                               f'{library.build_log}')
        tmp_lib = work / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp_lib),
             *[str(obj) for _, obj, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        library.build_log += f'== link\n{link.stdout}'
        if link.returncode:
            raise RuntimeError(f'linking the kernels failed:\n{link.stdout}')
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point `name` on `device`'s current stream; raise if it
    reports an error (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = LIBRARY.get()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.skk_error_string(rc).decode()
        raise RuntimeError(f'{name} failed: {msg} (code {rc})')


def check(cond: bool, what: str) -> None:
    """Reject an input the kernel does not take (no fallback)."""
    if not cond:
        raise ValueError(what)


def dtype_code(t: torch.Tensor, kernel: str) -> int:
    check(t.dtype in DTYPE_CODES,
          f'{kernel}: dtype {t.dtype} not supported (float32 or bfloat16)')
    return DTYPE_CODES[t.dtype]


def aligned(t: torch.Tensor) -> bool:
    """16-byte aligned base pointer (the kernels load 16-byte vectors)."""
    return t.data_ptr() % 16 == 0
