"""ctypes bindings to the port's native C++ host runtime (``src/sdrnative.cpp``).

The port of ``pycusdr_tpu/native/``: the complex64 ring buffer behind
``SigFIFO``, the frame finder's header/sync correlation
(``bit_correlate``), the complex split (``c2ri_native``; the port uploads
complex64, so no path calls it), PN9 whitening and the CC11xx CRC.

The library is compiled with ``g++`` at first use (the first read of
``AVAILABLE`` or the first call of a binding), never at import, into
``BUILD_DIR`` (``build/native/`` beside the package, git-ignored; never
next to the source). Its file name carries a digest of the source and the
flags. The build holds an exclusive ``flock`` on a lock file there and
looks for the library again once it has the lock, and it compiles to a
temporary name that ``os.replace`` moves into place, so processes that
start at once build it once and none loads a half-written file.

Every binding keeps the JAX package's numpy form as its plain version,
taken when the library is not there. ``counts`` holds each binding's calls
of its native and its numpy form, so a caller sees which ran; a child
process publishes them for its parent with ``publish`` into an Array from
``shared_counts``.
"""

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "src" / "sdrnative.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

#: the bindings, in the order ``shared_counts`` lays them out
NAMES = ("ring", "c2ri", "bit_correlate", "pn9_xor", "crc16")
#: binding -> [native calls, numpy calls] in this process ("ring": inserts)
counts = {name: [0, 0] for name in NAMES}

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsdrnative_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)


def _bind(lib) -> None:
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [i64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_flush.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = i64
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_insert.restype = i64
    lib.rb_insert.argtypes = [ctypes.c_void_p, f32p, i64]
    lib.rb_pop.restype = i64
    lib.rb_pop.argtypes = [ctypes.c_void_p, f32p, i64]

    lib.deinterleave_c64.argtypes = [f32p, f32p, f32p, i64]
    lib.interleave_c64.argtypes = [f32p, f32p, f32p, i64]
    lib.convolve_bits_i8.argtypes = [i8p, i64, i8p, i64, i32p]
    lib.pn9_xor.argtypes = [u8p, i64]
    lib.crc16_8005.restype = ctypes.c_uint16
    lib.crc16_8005.argtypes = [u8p, i64, ctypes.c_uint16]


def load():
    """The loaded library, built on the first call; None when it cannot
    be built or loaded (logged once: the bindings then run their numpy
    forms, counted in ``counts``)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                out = library_path()
                if not out.exists():
                    _build(out)
                lib = ctypes.CDLL(str(out))
                _bind(lib)
                _lib = lib
            except Exception as e:
                detail = getattr(e, "stderr", None) or e
                log.error("native library unavailable (%s) -- using numpy forms", detail)
        return _lib


def __getattr__(name):
    # ``AVAILABLE`` is read, not stored, so that reading it is the first use
    if name == "AVAILABLE":
        return load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def call_counts() -> dict:
    """binding -> {"native": calls, "numpy": calls} in this process."""
    return {name: {"native": c[0], "numpy": c[1]} for name, c in counts.items()}


def shared_counts(ctx):
    """An Array of ``ctx`` (a multiprocessing context) for a child to
    ``publish`` into and its parent to ``read``."""
    return ctx.Array("q", 1 + 2 * len(NAMES))


def publish(arr) -> None:
    """Write ``AVAILABLE`` and ``counts`` of this process into ``arr``."""
    available = load() is not None
    with arr.get_lock():
        arr[0] = int(available)
        for i, name in enumerate(NAMES):
            arr[1 + 2 * i], arr[2 + 2 * i] = counts[name]


def read(arr) -> dict:
    """What ``publish`` wrote: {"available": bool, binding: {"native",
    "numpy"}, ...}."""
    with arr.get_lock():
        vals = list(arr)
    out = {"available": bool(vals[0])}
    for i, name in enumerate(NAMES):
        out[name] = {"native": vals[1 + 2 * i], "numpy": vals[2 + 2 * i]}
    return out


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------- public wrappers ----------------


class NativeRingBuffer:
    """complex64 sample ring buffer backed by the C++ implementation.

    Same semantics as ``runtime.sigfifo.RingBuffer`` (flush-on-overflow,
    exact-size pops)."""

    def __init__(self, outLen, bufLen=None):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library not available")
        if bufLen is None:
            bufLen = 10 * outLen
        elif bufLen < outLen:
            raise IndexError("bufLen < outLen", "buffer too small for output block")
        self.outLen = outLen
        self.bufLen = bufLen
        self._h = self._lib.rb_create(bufLen)
        if not self._h:
            raise MemoryError("rb_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    @property
    def currentBufSize(self):
        return self._lib.rb_size(self._h)

    def insert(self, data):
        counts["ring"][0] += 1
        data = np.ascontiguousarray(data, dtype=np.complex64)
        return self._lib.rb_insert(self._h, _fptr(data.view(np.float32)), len(data))

    def popBlock(self, noSamples):
        out = np.empty(noSamples, np.complex64)
        got = self._lib.rb_pop(self._h, _fptr(out.view(np.float32)), noSamples)
        if got == 0:
            return []
        return out

    def flush(self):
        self._lib.rb_flush(self._h)


def c2ri_native(x: np.ndarray) -> np.ndarray:
    """complex64 (N,) -> float32 (2, N) split, via C++ deinterleave."""
    x = np.ascontiguousarray(x, np.complex64)
    out = np.empty((2, len(x)), np.float32)
    lib = load()
    if lib is not None:
        counts["c2ri"][0] += 1
        lib.deinterleave_c64(_fptr(x.view(np.float32)), _fptr(out[0]), _fptr(out[1]), len(x))
        return out
    counts["c2ri"][1] += 1
    out[0] = x.real
    out[1] = x.imag
    return out


def bit_correlate(bits: np.ndarray, mask_pm1: np.ndarray) -> np.ndarray:
    """Full convolution of {0,1} bits with a ±1 mask (``np.convolve``
    parity), float64 from either form. The native form counts only set
    bits against an int8 mask, so it runs on exactly such inputs; any
    other input (or no library) takes the numpy form, the exact
    convolution of the values given."""
    bits, mask = np.asarray(bits), np.asarray(mask_pm1)
    lib = load()
    if lib is None or not (((bits == 0) | (bits == 1)).all() and (abs(mask) == 1).all()):
        counts["bit_correlate"][1] += 1
        return np.convolve(bits.astype(np.float64), mask.astype(np.float64))
    counts["bit_correlate"][0] += 1
    b = np.ascontiguousarray(bits, np.int8)
    m = np.ascontiguousarray(mask, np.int8)
    out = np.empty(len(b) + len(m) - 1, np.int32)
    lib.convolve_bits_i8(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(b),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(m),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out.astype(np.float64)


def pn9_xor(data: np.ndarray) -> np.ndarray:
    """XOR bytes with the PN9 whitening sequence (in a copy)."""
    out = np.array(data, dtype=np.uint8, copy=True)
    lib = load()
    if lib is not None:
        counts["pn9_xor"][0] += 1
        lib.pn9_xor(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out))
        return out
    counts["pn9_xor"][1] += 1
    from pycusdr_tpu_torch.utils.shift_registers import pn9

    return out ^ pn9(len(out)).astype(np.uint8)


def crc16(data: np.ndarray, init: int = 0xFFFF) -> int:
    """CRC-16 poly 0x8005 (CC11xx framing)."""
    data = np.ascontiguousarray(data, np.uint8)
    lib = load()
    if lib is not None:
        counts["crc16"][0] += 1
        return int(lib.crc16_8005(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data), init
        ))
    counts["crc16"][1] += 1
    from pycusdr_tpu_torch.utils.crc import crc16_cc

    return crc16_cc(bytes(data), init)
