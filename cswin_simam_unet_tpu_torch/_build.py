"""Build and bind the port's CUDA kernels.

All sources under ``csrc/`` are compiled by ONE ``nvcc`` call into a shared
library with a plain C interface, at first use, into
``<checkout>/build/cuda_kernels/<hash>/`` (listed in ``.gitignore``).  The
directory name is a hash of the sources and flags, so a process builds at
most once and an edited source gets a fresh build.  The library is loaded
with ctypes, with ``argtypes`` and ``restype`` declared for every function:
a pointer passed without them is cut to 32 bits.

Each C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and counts
the launch.  Nothing here runs on import.
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

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "cuda_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k, v, lepe_w, out, ldq, ldk, ldv, ldo,
    # B, H, W, hsp, wsp, heads, head_dim, scale, stream
    "csu_stripe_attention_fwd": [_I, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, x, enc, out, B, H, W, C, S, vec, px, stream
    "csu_carafe_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, enc, bias, fb, s1, s2, B, H, W, C, S, vec, px, stream
    "csu_carafe_head_fwd": [_I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, fb, mu, var, w, out, items, items_per_image, C, F, vec, lanes,
    # lam, gate, stream
    "csu_simam_head_fwd": [_I, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                           _F, _I, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset, counted by launch()
LAUNCHES = {name: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _build() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libcsu_kernels.so"
    if lib.is_file():
        build_info.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libcsu_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(_CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-6000:]}")
    os.replace(tmp, lib)
    build_info.update(path=str(lib), seconds=seconds, cached=False,
                      log=proc.stderr)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.csu_error_string.argtypes = [ctypes.c_int]
            lib.csu_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry ``name`` on ``device``'s current stream with
    ``args`` (the stream is appended); raise if the launch failed."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.csu_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")
    LAUNCHES[name] += 1


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def vec_width(t: torch.Tensor, *aligned: torch.Tensor, channels: int) -> int:
    """Channel vector width of the 16-byte loads (1 where channels or the
    pointers do not allow it)."""
    vec = 16 // t.element_size()
    if channels % vec or any(a.data_ptr() % 16 for a in (t, *aligned)):
        return 1
    return vec


def check_cuda(*tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous, of one kernel dtype."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    dtype_code(tensors[0])
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"mixed dtypes {[t.dtype for t in tensors]}")
