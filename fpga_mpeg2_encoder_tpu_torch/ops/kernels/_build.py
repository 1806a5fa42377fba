"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with nvcc for Hopper (sm_90a) into one shared
library with a plain C interface, at first use, into the package's ignored
``build/`` directory, named by a hash of the sources: a changed source is
rebuilt, and concurrent processes never load a half-written file.  The
library is loaded with ctypes; each C entry point launches on the caller's
stream and returns ``cudaGetLastError()``.

Nothing here runs at import time: importing the package needs neither nvcc
nor a card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("transform.cu", "acsym.cu", "pack.cu", "me.cu", "glue.cu", "subsample.cu",
           "carry.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.  pack_symbols has no kernel of its
# own and no count: its launches are pack_slots'.  merge_rows and
# merge_append launch the one merge kernel and share its count, and so do
# subsample_420 and subsample_420_stack, the subsample kernel's two entries.
# gop_carry runs only in encode_gop_scan's step on a card, once a frame.  A
# launch made while a CUDA graph is captured runs only when the graph is
# replayed: it goes to the capture's tally (``tally_into``), and each replay
# adds the tally here (``add_launches``), so the counts are the same as if
# each replayed step had launched its kernels one by one.
LAUNCHES: Dict[str, int] = {"transform": 0, "acsym": 0, "pack_slots": 0,
                            "merge_rows": 0, "me_fused": 0, "me_luma": 0,
                            "chroma_pred": 0, "glue": 0, "subsample": 0, "gop_carry": 0}
_tally: Optional[Dict[str, int]] = None     # the open capture's, if any

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mpeg2_transform": [_P] * 11 + [_I, _I, _I, _P],
    "mpeg2_transform_stage": [_P] * 4 + [_I, _I, _I, _P],
    "mpeg2_acsym": [_P, _P, _P, _I, _I, _P],
    "mpeg2_pack_slots": [_P] * 5 + [_I] * 6 + [_P],
    "mpeg2_merge_rows": [_P] * 7 + [_I, _I, _I, ctypes.c_longlong, _P],
    "mpeg2_me_fused": [_P] * 11 + [_I] * 8 + [_P],
    "mpeg2_me_luma": [_P] * 7 + [_I] * 8 + [_P],
    "mpeg2_chroma_pred": [_P] * 7 + [_I] * 4 + [_P],
    "mpeg2_glue": [_P] * 15 + [_I] * 5 + [_P],
    "mpeg2_subsample": [_P] * 4 + [_I, _I, _P],
    "mpeg2_subsample_stack": [_P] * 5 + [_I, _I, _P],
    "mpeg2_gop_carry": [_P] * 12 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(counter: str) -> None:
    """One launch of kernel ``counter``: into the open capture's tally, or
    into LAUNCHES.  A launch captured with no tally open raises: its count
    would be lost at every replay."""
    if _tally is not None:
        _tally[counter] = _tally.get(counter, 0) + 1
    elif torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{counter}: a kernel captured in a CUDA graph outside "
                           f"tally_into(): its launches would not be counted")
    else:
        LAUNCHES[counter] += 1


@contextlib.contextmanager
def tally_into(tally: Dict[str, int]):
    """Within the block, launches count into ``tally`` instead of LAUNCHES:
    the launches of a CUDA graph's capture, or of a warm-up that the
    counts must not see."""
    global _tally
    if _tally is not None:
        raise RuntimeError("tally_into() does not nest")
    _tally = tally
    try:
        yield tally
    finally:
        _tally = None


def add_launches(tally: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` replays of a graph whose capture counted ``tally``."""
    for k, n in tally.items():
        LAUNCHES[k] += n * times


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): under CUDA_HOME, on
    PATH, or (cuobjdump) the copy in Triton's package."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
             shutil.which(name)]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia",
                                  "bin", name))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on PATH")


def sass(lib: str, kernel: str) -> List[str]:
    """The SASS instructions of the kernel whose symbol contains ``kernel``
    in the shared library ``lib``, from cuobjdump, one opcode line each."""
    res = subprocess.run([cuda_tool("cuobjdump"), "-sass", lib], capture_output=True,
                         text=True, check=True)
    out, inside = [], False
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            inside = kernel in ln.split("Function :")[1]
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if inside and m:
            out.append(m.group(1))
    if not out:
        raise RuntimeError(f"no SASS for {kernel} in {lib}")
    return out


def library_path() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmpeg2kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists.
    Returns the library path; the compiler's output (per-kernel registers,
    shared memory, spills) is kept beside it as ``.log``."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp,
             *(os.path.join(CSRC, s) for s in SOURCES)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, counter: Optional[str], device: torch.device, *args) -> None:
    """Call C entry point ``name`` with ``args`` (tensors become device
    pointers) and the current stream of ``device``; raise on a launch error.
    Counts one launch of ``counter`` (see ``count``); a test probe passes
    None."""
    lib = library()
    conv = [t.data_ptr() if torch.is_tensor(t) else t for t in args]
    with torch.cuda.device(device):
        err = getattr(lib, name)(*conv, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    if counter is not None:
        count(counter)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device (the kernel runs).  Raises on
    anything else: there is no silent move between devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, align: int = 1) -> None:
    """Raise unless ``t`` has this dtype and shape, is contiguous and its
    data starts on an ``align``-byte boundary (for the kernels' vector
    loads)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")
