"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, into ``build/torch_kernels/`` at
the repository root, from the sources in the checkout only; the library's
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is loaded as it is.  The sources compile in parallel,
one ``nvcc`` each.  A missing ``nvcc`` or a failed build raises: nothing
falls back to the plain versions.
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
from typing import Dict, List, Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("segsum.cu", "mobius.cu", "bdeu.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "segsum_ones": [_P, _P, _P, _I64, _I64, _P],
    "segsum_rows": [_P, _P, _P, _I64, _I64, _I64, _P],
    "mobius_batch": [_P, _P, _I64, ctypes.c_int, _I64, _P],
    "mobius_max_bits": [],
    "bdeu_batch": [_P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float,
                   _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the last build did: seconds, library path, and nvcc's ``-Xptxas -v``
#: lines (registers, shared memory and spills per kernel).
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: List[List[str]]) -> List[str]:
    """Run the commands in parallel; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                               f"{out}")
    return outs


def build(force: bool = False) -> Path:
    """Compile the kernels (unless an up-to-date library exists) and
    return the library's path."""
    lib_path = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if lib_path.exists() and not force:
        BUILD_INFO.update(seconds=0.0, path=str(lib_path), ptxas=[],
                          cached=True)
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{Path(s).stem}.{os.getpid()}.o" for s in SOURCES]
    outs = _run([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                  str(SRC_DIR / s), "-o", str(o)]
                 for s, o in zip(SOURCES, objs)])
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *map(str, objs)]])
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    ptxas = [line.strip() for out in outs for line in out.splitlines()
             if "ptxas" in line]
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      ptxas=ptxas, cached=False)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
