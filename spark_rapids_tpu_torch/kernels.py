"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/lib<name>-<hash>.so``; the hash covers the sources and flags, so
an edited kernel is rebuilt and a built one is reused.  The libraries
are bound with ctypes: pointers are ``tensor.data_ptr()`` and the stream
is PyTorch's current stream.  Every C entry point returns a
``cudaError_t``, which ``check`` turns into an exception.
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
from typing import Dict, Iterable

import torch

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
HEADERS = ("partition.cuh", "join_hash.cuh")
SOURCES = ("compact", "onesweep", "segment_reduce", "key_hash", "join_probe",
           "expand_ends", "join_expand", "gather_rows", "fetch_pack",
           "window_scan", "scatter_rows", "string_hashes", "hash_bytes",
           "gather_strings", "prefix_words")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "compact": {
        "srt_compact": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    },
    "onesweep": {
        "srt_sort_histogram": [_P, _I, _I, _P, _P, _P, _P],
        "srt_sort_pass": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P],
    },
    "segment_reduce": {
        "srt_segment_reduce_varying": [_P, _I, _P, _I, _P, _P],
        "srt_segment_reduce_set": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                                   _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                                   _L, _P],
    },
    "key_hash": {
        "srt_key_hash": [_P, _I, _I, _I, _I, _P, _P],
    },
    "join_probe": {
        "srt_join_table_slots": [_I],
        "srt_join_build_table": [_P, _I, _P, _I, _P],
        "srt_join_probe": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    },
    "expand_ends": {
        "srt_expand_ends": [_P, _P, _I, _I, _P, _P, _P, _P],
    },
    "join_expand": {
        "srt_join_expand": [_P, _I, _P, _P, _P, _I, _L, _L, _P, _P, _P, _P,
                            _I, _P],
    },
    "gather_rows": {
        "srt_gather_rows": [_P, _I, _I, _P, _P, _P, _P],
        "srt_gather_packed": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    },
    "fetch_pack": {
        "srt_lane_stats": [_P, _I, _I, _P, _P],
        "srt_pack_lanes": [_P, _I, _I, _P, _P],
    },
    "window_scan": {
        "srt_segment_scan_scratch_bytes": [_I],
        "srt_segment_scan": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                             _P, _P],
        "srt_run_ends": [_P, _P, _I, _I, _P, _P, _P, _P],
    },
    "scatter_rows": {
        "srt_scatter_rows": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    },
    "string_hashes": {
        "srt_string_hashes": [_P, _P, _I, _P, _P, _P, _P],
    },
    "hash_bytes": {
        "srt_hash_bytes": [_P, _P, _P, _P, _I, _P, _P],
    },
    "gather_strings": {
        "srt_gather_offsets": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P],
        "srt_gather_chars": [_P, _L, _P, _P, _I, _L, _I, _P, _P, _L, _P],
    },
    "prefix_words": {
        "srt_prefix_words": [_P, _P, _I, _P, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = Path("/usr/local/cuda/bin/nvcc")
    if fixed.exists():
        return str(fixed)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "spark_rapids_tpu_torch need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (0.0 for one already built); the compiler's output lands beside each
    library as ``.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    seconds = {}
    running = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                seconds[name] = 0.0
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in list(running.items()):
            log, _ = proc.communicate()
            del running[name]
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(rc={proc.returncode}):\n{log}")
            os.replace(tmp, out)
            seconds[name] = time.perf_counter() - t0
    finally:
        for proc, tmp, _, _ in running.values():
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.srt_error_string.argtypes = [ctypes.c_int]
            lib.srt_error_string.restype = ctypes.c_char_p
            lib.srt_tile_rows.argtypes = []
            lib.srt_tile_rows.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.srt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def num_tiles(lib: ctypes.CDLL, n: int) -> int:
    tile = lib.srt_tile_rows()
    return (n + tile - 1) // tile


def pointers(tensors) -> ctypes.Array:
    """A host array of device pointers (0 for None)."""
    ptrs = [0 if x is None else x.data_ptr() for x in tensors]
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


def device_int64s(values, device) -> torch.Tensor:
    """An int64 array on ``device`` (pointers, kinds) that a kernel reads,
    copied from pinned host memory on the current stream, so the host
    does not wait for the device."""
    host = torch.tensor(list(values) or [0], dtype=torch.int64,
                        pin_memory=True)
    return host.to(device, non_blocking=True)


def ints(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int * max(len(values), 1))(*values)


def require_row_lanes(what: str, lanes) -> None:
    """A kernel that moves row lanes never takes a string's chars: uint8
    is the chars lane's dtype and no row lane's (a span column moves
    through K16, ops/strings.py)."""
    for x in lanes:
        if x is not None and x.dtype == torch.uint8:
            raise TypeError(f"{what}: a uint8 lane is a string's chars, "
                            f"not a row lane; gather span columns with "
                            f"ops/strings.py:gather_strings")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor a kernel reads or writes: on one CUDA device and
    contiguous."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device, "
                             f"got {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
