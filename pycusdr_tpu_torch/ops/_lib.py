"""Builds, loads and calls the port's hand-written CUDA kernels.

The sources in ``pycusdr_tpu_torch/csrc/*.cu`` export a plain C
interface, so they are compiled with ``nvcc`` alone (no PyTorch headers:
seconds, not minutes) into one shared library under
``build/torch_kernels/`` beside the package, at first use, and loaded
with ``ctypes``. Every pointer and the stream pass as ``c_void_p``; each
C entry point returns ``cudaGetLastError()`` after its launches, and
``launch`` raises on anything but ``cudaSuccess``.

Nothing here runs at import time: the CPU tests import every module on
a machine without ``nvcc`` or a card.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from pycusdr_tpu_torch.obs.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every exported C entry point (all return a cudaError_t)
SIGNATURES = {
    # P, Q, centre|NULL, rows, part, count, E, B, N, D, M, L, T, wwin, tg, bt, vec, scale,
    # stream
    "pycusdr_doppler_energy": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _P],
    # S, masks, shift, shift_stride, tw, Y, colsum, colmax, colargmax, B, N, M, n1, C, R,
    # Mg, sum_lo, sum_hi, mids, stream
    "pycusdr_mf_bank_colreduce": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P],
    # x, tw, part, spSym, codeOffset, code_val, B, N, lo, hi, n1, cw, groups, stream
    "pycusdr_timing_band": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # colmax, colargmax, spSym, codeOffset, bitLUT, symLUT, hits, code_val, clipped_any,
    # symbols, centres, mags, bits, trust, nSym, row, L, B, N, W, spsymMin,
    # numSymMax, trust_normal, hw_max, lutM, lutK, threads, spt, argwin, stream
    "pycusdr_symbol_detect": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # E, P, shifts, shifts_signed, hz, sc, sc_stride, e_out, e_stride, shift_out,
    # centre|NULL, B, N, D, M, num_dopplers, offset, sum_all, snr_window, if_hz,
    # bin_hz, stream
    "pycusdr_doppler_estimate": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # x, y, part|NULL, hits, clipped_any, B, N, chunk, scale, long_form, chunks, cluster,
    # stream
    "pycusdr_threshold": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    # N, chunks, cluster, count (int*): the clusters of K6's launch the device holds
    # at once (no stream)
    "pycusdr_threshold_clusters": [_I, _I, _I, _P],
    # sym, lengths, dec|NULL, bits|NULL, met, S, Tmax, soft, terminated, invert_g2,
    # decode, stream
    "pycusdr_viterbi": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # rows, out, C, L, S, master_idx, master_weight, mask_pad, stream
    "pycusdr_vote": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, state|NULL, h2, tw, y, carry, T, M, K, stream
    "pycusdr_channelize": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, state|NULL, h2, tw, y, carry, T, M, K, stream
    "pycusdr_channelize_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, state|NULL, h2, v, T, M, K, stream
    "pycusdr_channelize_fir": [_P, _P, _P, _P, _I, _I, _I, _P],
    # colmax, colargmax, spSym, codeOffset, pair, B, N, W, spsymMin, S, M, m0, threads, spt,
    # argwin, stream
    "pycusdr_symbol_detect_local": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _P],
    # pairs, nd, spSym, codeOffset, bitLUT, symLUT, hits, code_val, clipped_any, row, L, B,
    # N, W, spsymMin, S, M, trust_normal, hw_max, lutM, lutK, threads, spt, stream
    "pycusdr_shard_select": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raise rather than run on the CPU when no
    card is present and the caller did not ask for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        # integer-valued results (bins, shifts, indices) ride in f32: TF32
        # would round them (the TPU's bf16 matmul bug, docs/architecture.md)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started
    together) and link one shared library; reuse it when the sources are
    unchanged. Returns the library path.

    Safe across processes: the station's Rx children each build at their
    first launch, so the build runs under an exclusive ``flock`` on a lock
    file in ``BUILD_DIR``, and a process that waited on the lock finds
    the library the first one linked and reuses it."""
    nvcc = _nvcc()
    tag = _digest()
    out = BUILD_DIR / f"libpycusdr_kernels_{tag}.so"
    log_path = BUILD_DIR / f"build_{tag}.log"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log=str(log_path))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"build_{tag}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():
            build_info.update(path=str(out), seconds=0.0, cached=True, log=str(log_path))
            return out
        return _compile_and_link(nvcc, tag, out, log_path)


def _compile_and_link(nvcc: str, tag: str, out: Path, log_path: Path) -> Path:
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    log_path.write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log=str(log_path))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.pycusdr_error_string.argtypes = [ctypes.c_int]
            handle.pycusdr_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def ptr(t) -> int:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()


def launch(name: str, *args, stream: int = None) -> None:
    """Call C entry point ``name`` on ``stream`` (a raw CUDA stream handle;
    default the current stream); raise on error. Runs in a ``launch``
    span."""
    with span("launch"):
        L = lib()
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        err = getattr(L, name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}: "
                               f"{L.pycusdr_error_string(err).decode()}")


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Validate what a kernel takes: device, dtype, shape, contiguity.
    Called on every launch, so the common case compares cheaply (dtypes
    are singletons, a ``torch.Size`` is a tuple, and an indexed device is
    matched by ``get_device()``, -1 on the CPU, without building a
    ``torch.device``)."""
    if t.dtype is not dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and (t.get_device() != device.index if device.index is not None
                               else t.device != device):
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
