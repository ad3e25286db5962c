"""Build the port's CUDA sources at first use and bind them with ctypes.

No counterpart in volsync_tpu (JAX traces its Pallas kernels itself).
Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``_build/`` inside
the package (git-ignored). The file name carries a hash of every
source in ``csrc/``, so an edited source rebuilds and a stale library
is never loaded. ``build_all()`` starts one ``nvcc`` per source, all at
once, and waits for them; a failed build raises with the compiler's
output.

A ``Kernel`` is one exported launcher. ``launch()`` passes device
pointers and the current CUDA stream as ``c_void_p``, raises if the
launcher returns a nonzero ``cudaGetLastError()``, and only then adds
one to ``launches`` (under a lock: backup and restore launch from
several threads), the count that shows a run went through the
kernel. Every Kernel registers itself in ``KERNELS``; a kernel with
several entry points has a Kernel for each under one name, and
``launch_counts()`` sums them by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from volsync_tpu_torch.analysis import lockcheck

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = lockcheck.make_lock("ops.build")
_count_lock = lockcheck.make_lock("ops.launch_counts")  # concurrent callers
_libs: dict = {}  # source file name -> ctypes.CDLL

#: Every kernel wrapper of the port, in definition order.
KERNELS: list = []


def launch_counts() -> dict:
    """Launches of every kernel by name, summed over its entry points."""
    counts: dict = {}
    for k in KERNELS:
        counts[k.name] = counts.get(k.name, 0) + k.launches
    return counts


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_sources_digest()}.so"


def build_all(sources=None) -> dict:
    """Compile every missing library (all of ``csrc/*.cu`` by default)
    with one ``nvcc`` per source started together. Returns
    ``{source: ptxas report}`` for the sources built now."""
    sources = sources or sorted(f.name for f in CSRC.glob("*.cu"))
    with _lock:
        return _build_locked(sources)


def _build_locked(sources) -> dict:
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {src} (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        reports[src] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _build_locked([source])
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p
        return lib


class Kernel:
    """One exported launcher ``symbol`` of ``csrc/<source>``.

    ``argtypes`` lists the launcher's arguments before the two every
    launcher ends with (device index, stream)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def _bind(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a refused
        launch. Pointer arguments are ``tensor.data_ptr()`` ints."""
        fn = self._bind()
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        rc = fn(*args, index, stream)
        if rc != 0:
            msg = load(self.source).vt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({rc}): "
                               f"{msg}")
        with _count_lock:
            self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim`` (what every launcher takes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")
