"""Build and bind the hand-written CUDA kernels (nvcc → shared library → ctypes).

Each kernel is one ``csrc/*.cu`` file with a plain C entry point that
returns a ``cudaError_t``.  :class:`CudaKernel` compiles it with ``nvcc``
for ``sm_90a`` into ``<repo>/build/repro_torch/`` at first use — the file
name carries a hash of the source, of every shared header ``csrc/*.cuh``
and of the flags, so an edited source or header is rebuilt and an
unchanged one is reused — loads it with ``ctypes``, and
raises if the build, the load or a launch fails.  Nothing is compiled or
loaded when this module is imported, so the CPU tests import every module
without ``nvcc``.  :func:`build_all` starts one ``nvcc`` per kernel at once
(the smoke script's parallel build).  No kernel links the driver API:
``csrc/hopper.cuh`` fetches ``cuTensorMapEncodeTiled`` (TMA descriptors)
through the runtime's ``cudaGetDriverEntryPoint``, so the flags name no
``-lcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    ``/usr/local/cuda/bin/nvcc``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels are built from csrc/ at first use on a GPU host"
    )


class CudaKernel:
    """One hand-written kernel: its source, its built library, and a plain
    integer count of its launches.

    ``argtypes`` maps the C entry point's name to its ctypes signature.
    :meth:`launch` calls the entry point, raises on a nonzero
    ``cudaError_t`` and adds one to :attr:`launches` — the only place the
    count moves, so a run's count is the number of kernels it launched.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence[object]):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.ptxas_log = ""
        self._fn = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def compile_cmd(self, out: Path) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _load(self) -> None:
        lib = ctypes.CDLL(str(self.library))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def build(self) -> None:
        """Compile (unless the hashed library exists) and load."""
        if self._fn is not None:
            return
        build_all([self])

    def launch(self, *args) -> None:
        if self._fn is None:
            self.build()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError_t {rc}"
            )
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Build every kernel not yet built, one ``nvcc`` each, all started
    together; load them all.  Returns seconds per kernel name (0.0 for a
    library reused from ``build/``).  Raises with the compiler's output on
    the first failure."""
    kernels = [k for k in kernels if k._fn is None]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    seconds: Dict[str, float] = {}
    for k in kernels:
        out = k.library
        if out.exists():
            seconds[k.name] = 0.0
            procs.append((k, None, out, None, time.perf_counter()))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        p = subprocess.Popen(
            k.compile_cmd(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        procs.append((k, p, out, tmp, time.perf_counter()))
    err: Optional[str] = None
    for k, p, out, tmp, t0 in procs:
        if p is not None:
            log, _ = p.communicate()
            seconds[k.name] = time.perf_counter() - t0
            k.ptxas_log = log
            if p.returncode != 0:
                err = err or f"nvcc failed for {k.source}:\n{log}"
                continue
            os.replace(tmp, out)
        k._load()
    if err:
        raise RuntimeError(err)
    return seconds
