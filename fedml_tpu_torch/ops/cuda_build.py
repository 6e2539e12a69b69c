"""Build and load the port's CUDA kernels (``fedml_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``fedml_tpu_torch/build/``
(listed in ``.gitignore``), then loaded with ``ctypes``.  Nothing includes
PyTorch's headers, so a build takes seconds.  A library's file name carries
a hash of its sources and flags, so an edited source is rebuilt at first
use.  :func:`build` starts one ``nvcc`` per source, all at once.

``nvcc``'s ``-Xptxas -v`` log is kept beside each library
(``lib<name>-<hash>.ptxas``), so a cached build still reports it;
:func:`ptxas_report` reads each kernel's registers, spills and static
shared memory from it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import re
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures, in argument order (all return a cudaError_t code as int)
SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P] + [_I] * 6 + [_F, _I, _I, _P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _log_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".ptxas"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library in ``names`` that is missing, one ``nvcc`` per
    source, all started together.  Returns per-name ``{"seconds", "ptxas",
    "cached"}`` (``ptxas``: the build's log, kept beside the library); raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, out = {}, {}
    t0 = time.time()
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path) and os.path.exists(_log_path(path)):
            with open(_log_path(path)) as f:
                out[name] = {"seconds": 0.0, "ptxas": f.read(), "cached": True}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path()] + FLAGS + [
            "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.time() - t0, "ptxas": log,
                     "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
        else:
            with open(f"{tmp}.ptxas", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.ptxas", _log_path(path))
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            lib.fa_error_string.argtypes = [ctypes.c_int]
            lib.fa_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def smem_bytes(name: str, head_dim: int, bf16: bool) -> int:
    """Dynamic shared memory per block of kernel ``name`` at ``head_dim``."""
    fn = getattr(library(name), f"{name}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(int(head_dim), int(bf16))


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch returned anything but ``cudaSuccess``."""
    if rc != 0:
        msg = lib.fa_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptxas_report(log: str) -> Dict[str, dict]:
    """Per kernel in an ``nvcc -Xptxas -v`` log: ``registers`` (per
    thread), ``spill_stores`` and ``spill_loads`` (bytes) and ``smem``
    (static shared memory, bytes; the kernels' tiles are dynamic), keyed
    ``"<kernel><template ints>"``, e.g. ``flash_fwd_bf16_kernel<128>``."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        entry = chunk.split("'", 1)[0]
        targs = entry.split("Ev", 1)[0]   # name and template arguments
        names = [entry[m.end():m.end() + int(m[0])]
                 for m in re.finditer(r"\d+", targs)]
        ints = re.findall(r"Li(\d+)E", targs)
        key = (next((n for n in names if n.endswith("kernel")), entry)
               + (f"<{','.join(ints)}>" if ints else ""))
        num = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        out[key] = {"registers": num(r"Used (\d+) registers"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads"),
                    "smem": num(r"(\d+) bytes smem")}
    return out
