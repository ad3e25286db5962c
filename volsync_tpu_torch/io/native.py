"""ctypes bindings for the native host library (``native/volio.cpp``).

Ports ``volsync_tpu/io/native.py``. The compute path is the port's CUDA
kernels; this is the host runtime around them: a C++ readahead file
reader (disk IO overlapped with device hashing) and the C FastCDC
boundary walk. The library is built at first use from the port's own
copy of the source (``volsync_tpu_torch/native/volio.cpp``, byte for
byte the reference's ``native/volio.cpp``) with ``g++ -O2 -shared
-fPIC -pthread -std=c++17`` into ``volsync_tpu_torch/_build/``
(git-ignored). The file name carries the source's hash, as
``ops/_build.py`` keys the CUDA libraries, so a stale library is never
loaded. ``VOLSYNC_VOLIO_SO`` loads a prebuilt library instead and
``VOLSYNC_NO_NATIVE=1`` disables the library outright.

This is host code, and its pure-Python routes (``open()``,
``ops/gearcdc._select_boundaries_py``) are the reference's own design
for a host accelerator that is absent: ``available()`` gates use.
``LOAD_INFO`` says where the library came from and how long its build
took in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck

log = logging.getLogger("volsync_tpu_torch.native")

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "volio.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_LOCK = lockcheck.make_lock("io.native")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
#: {"path": library loaded, "build_s": seconds spent building it in this
#: process (None when it was already built or prebuilt)}
LOAD_INFO: dict = {}


def library_path() -> Path:
    """Where the library of the current source lives (hash-keyed)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libvolio-{digest}.so"


def _build(src: Path, out: Path) -> bool:
    cmd = ["g++", *GXX_FLAGS, "-o", str(out), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build failed to run: %s", e)
        return False
    if proc.returncode != 0:
        log.warning("native build failed:\n%s", proc.stderr[-2000:])
        return False
    return True


def _open_lib(path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
        _bind(lib)  # stale/wrong .so: missing symbols degrade
    except (OSError, AttributeError) as e:
        log.warning("native load failed (%s): %s", path, e)
        return None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if envflags.no_native():
            return None
        prebuilt = envflags.volio_so()
        if prebuilt:
            _LIB = _open_lib(prebuilt)
            if _LIB is not None:
                LOAD_INFO.update(path=prebuilt, build_s=None)
            return _LIB
        if not _SRC.is_file():
            return None
        so = library_path()
        build_s = None
        if not so.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a temp name and rename into place: concurrent
            # processes sharing the build dir must never dlopen a half-
            # written .so.
            tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            if not _build(_SRC, tmp):
                return None
            build_s = time.perf_counter() - t0
            os.replace(tmp, so)
        _LIB = _open_lib(so)
        if _LIB is not None:
            LOAD_INFO.update(path=str(so), build_s=build_s)
            log.info("native volio loaded from %s", so)
        return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    lib.volio_open.restype = ctypes.c_void_p
    lib.volio_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.volio_next.restype = ctypes.c_int64
    lib.volio_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.volio_close.restype = None
    lib.volio_close.argtypes = [ctypes.c_void_p]
    lib.volio_select_boundaries.restype = ctypes.c_int64
    lib.volio_select_boundaries.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]


def available() -> bool:
    return _load() is not None


class ReadaheadReader:
    """reader(n)-compatible streaming file reader with a C++ readahead
    thread: the next segment is on its way up from disk while the caller
    processes the current one."""

    def __init__(self, path, segment_size: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native volio unavailable")
        self._lib = lib
        self._segment = segment_size
        self._buf = ctypes.create_string_buffer(segment_size)
        self._handle = lib.volio_open(str(path).encode(), segment_size)
        if not self._handle:
            raise OSError(f"volio_open failed for {path}")
        self._carry = b""
        self._eof = False

    def read(self, n: int) -> bytes:
        """Return up to n bytes (b'' at EOF), the stream_chunks reader
        contract. Segments stream in whole; the carry bridges sizes."""
        while not self._eof and len(self._carry) < n:
            got = self._lib.volio_next(self._handle, self._buf)
            if got < 0:
                raise OSError("volio_next failed")
            if got == 0:
                self._eof = True
                break
            # ctypes slice copies exactly `got` bytes (.raw would copy
            # the whole segment buffer first).
            self._carry += self._buf[:got]
        out, self._carry = self._carry[:n], self._carry[n:]
        return out

    def readinto(self, view) -> int:
        """Fill ``view`` from the stream, returning bytes written (0 at
        EOF); short fills are allowed. One copy from the C++ readahead
        buffer straight into the caller's pooled segment; the carry only
        materializes when a caller mixes read() and readinto() or hands
        a view smaller than a native segment."""
        mv = memoryview(view).cast("B")
        if len(mv) == 0:
            return 0
        if self._carry:
            take = min(len(self._carry), len(mv))
            mv[:take] = self._carry[:take]
            self._carry = self._carry[take:]
            return take
        if self._eof:
            return 0
        got = self._lib.volio_next(self._handle, self._buf)
        if got < 0:
            raise OSError("volio_next failed")
        if got == 0:
            self._eof = True
            return 0
        take = min(got, len(mv))
        src = memoryview(self._buf).cast("B")
        mv[:take] = src[:take]
        if take < got:
            self._carry = bytes(src[take:got])
        from volsync_tpu_torch.obs import record_copy

        record_copy("chunker.ingest", take)
        return take

    def close(self):
        if self._handle:
            self._lib.volio_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def select_boundaries_native(idx_s, idx_l, length: int, params,
                             eof: bool, base: int = 0
                             ) -> Optional[list]:
    """The C FastCDC walk; None if the library is unavailable (the
    caller walks in Python; the tests pin their equality). ``idx_*``
    may be numpy arrays or CPU tensors of any integer type: they reach
    the library as contiguous int64."""
    lib = _load()
    if lib is None:
        return None
    a_s = np.ascontiguousarray(np.asarray(idx_s, dtype=np.int64))
    a_l = np.ascontiguousarray(np.asarray(idx_l, dtype=np.int64))
    cap = max(length // params.min_size + 2, 16)
    out = np.empty((cap * 2,), dtype=np.int64)
    n = lib.volio_select_boundaries(
        a_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(a_s),
        a_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(a_l),
        length, params.min_size, params.avg_size, params.max_size,
        1 if eof else 0, base,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if n < 0:
        return None  # capacity bug; be safe and walk in Python
    return [tuple(pair) for pair in out[: 2 * n].reshape(n, 2).tolist()]
