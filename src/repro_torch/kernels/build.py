"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/csrc/*.cu`` file is one shared library with a plain C
interface, compiled at first use for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

into ``build/kernels/`` at the repository root, named by a hash of the
source and every local header it includes (``#include "x.cuh"``), so an
edit to either rebuilds and an unchanged source loads at once.
``build_all()`` starts one ``nvcc`` per source, all together.  A missing
``nvcc`` or a failed build raises: there is no fallback.
``kernel_resources()`` reads each kernel's registers and spilled bytes
from ``ptxas -v``'s report of the builds this process ran.

The C interface every library shares is here too: the dtype codes its
entry points take (``DTYPE_CODE``), the checks a wrapper makes before it
hands over raw pointers (``check_cuda``), and the launch's returned
``cudaError_t`` turned into an exception (``raise_on``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signature of each library's entry point: (argtypes, restype).
SIGNATURES = {
    "decode_attention": ("flash_decode",
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _F, _F, _I, _I, _P]),
    "decode_attention_paged": ("flash_decode_paged",
                               [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]),
    "cache_update": ("cache_update",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _P]),
    "cache_update_paged": ("cache_update_paged",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_attention": ("flash_attention_fwd",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _F, _I, _P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]),
    "grouped_matmul": ("grouped_matmul", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "ssd": ("ssd", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _I, _P]),
}

#: dtype code of a tensor at every kernel's C entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(name: str, device, **tensors) -> None:
    """Every tensor on ``device``, contiguous and (but int32 index
    tensors) 16-byte aligned, as the kernels' vector loads need."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.dtype != torch.int32 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def raise_on(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
#: the compiler's output of each library built in this process
_logs: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes, recursively,
    in a fixed order."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``name``; returns the process, or None if cached."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                           f"{log}")
    os.replace(tmp, out)
    _logs[name] = log


def build_all() -> list[Path]:
    """Compile every kernel source that is not built yet, one ``nvcc``
    per source running in parallel.  Returns the libraries' paths."""
    procs = {name: _start(name) for name in SIGNATURES}
    try:
        for name, proc in procs.items():
            _finish(name, proc)
    finally:
        for proc in procs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return [_target(name) for name in SIGNATURES]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use),
    with its entry point's argtypes and restype declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(_target(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def demangle(symbols: list[str]) -> list[str]:
    """The readable names of mangled kernel symbols, by the toolkit's
    ``cu++filt -p`` (no parameter types), e.g.
    ``<unnamed>::ssd_tc_kernel<(int)128, (int)64>``."""
    if not symbols:
        return []
    return subprocess.run([str(Path(nvcc()).with_name("cu++filt")), "-p",
                           *symbols], capture_output=True, text=True,
                          check=True).stdout.splitlines()


def kernel_resources() -> dict[str, dict[str, int]]:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} of every
    kernel of the libraries built in this process, from ``ptxas -v``
    (bytes spilled per thread), named by ``demangle``; a library loaded
    from the cache built nothing here and reports nothing."""
    out: dict[str, dict[str, int]] = {}
    for log in _logs.values():
        kernel = None
        for line in log.splitlines():
            m = _ENTRY.search(line)
            if m:
                kernel = m.group(1)
                out[kernel] = {}
            elif kernel is not None and _SPILL.search(line):
                st, ld = _SPILL.search(line).groups()
                out[kernel].update(spill_stores=int(st), spill_loads=int(ld))
            elif kernel is not None and _REGS.search(line):
                out[kernel]["registers"] = int(_REGS.search(line).group(1))
    return dict(zip(demangle(list(out)), out.values(), strict=True))
