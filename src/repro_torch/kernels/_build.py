"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled at first use, one ``nvcc -c`` per
source started together, and the objects are linked into one shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu          (one per source)
    nvcc -shared -o libreprotorch.so *.o

The library lands in ``build/kernels/<hash>/`` under the checkout root
(``.gitignore`` lists ``build/``), where ``<hash>`` covers the sources
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import: the CPU tests import every module
of the port on a machine with no ``nvcc``.

Each C entry point takes its pointers and the stream as ``void*``, its
sizes as ``int`` and its scalars as ``float``, launches on the given
stream, allocates nothing, and returns ``cudaGetLastError()``;
:meth:`Kernel.launch` raises if that is not ``cudaSuccess`` and counts
the launch.  A build of the library (not a reuse) counts as one program
in ``repro_torch.obs.trace.compile_stats``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.obs import trace as obs_trace

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = ROOT / "build" / "kernels"
LIB_NAME = "libreprotorch.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source, header and flag that goes into the library."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the repro_torch CUDA kernels "
        "are built from csrc/ at first use and need the CUDA toolkit")


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands together; wait for every one; raise on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return outs


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build in a private directory and rename it into place, so two
    # processes building at once never load a half-written library
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        srcs = sources()
        objs = [tmp / (s.stem + ".o") for s in srcs]
        logs = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)]
                         for s, o in zip(srcs, objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
                   *map(str, objs)]])
        (tmp / "ptxas.log").write_text("\n".join(logs))
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib_path.exists():   # lost a race only if it is there
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(path=str(lib_path), cached=False,
                      seconds=time.perf_counter() - t0,
                      ptxas=(out_dir / "ptxas.log").read_text())
    # a build of the library counts as one program (obs.compile_stats)
    obs_trace.record_compile(BUILD_INFO["seconds"], what=LIB_NAME)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def _c_type(kind: str):
    return {"p": ctypes.c_void_p, "i": ctypes.c_int,
            "f": ctypes.c_float}[kind]


class Kernel:
    """One C entry point of the library and its launch count.

    ``signature`` spells the arguments after which the stream follows:
    ``"p"`` for a pointer, ``"i"`` for an int, ``"f"`` for a float.  ``launches`` goes up by
    one on each successful launch, and nowhere else, so a run can show
    that it went through the kernel.
    """

    def __init__(self, symbol: str, signature: str):
        self.symbol = symbol
        self.signature = signature
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = [_c_type(k) for k in self.signature] \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, stream: int) -> None:
        if len(args) != len(self.signature):
            raise TypeError(f"{self.symbol} takes {len(self.signature)} "
                            f"arguments, got {len(args)}")
        err = self._bind()(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1
