"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, at first use, into
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
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
# a compile or the link that runs this long has hung (each takes seconds)
NVCC_TIMEOUT_S = 300

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_U = ctypes.c_uint32
_SIGNATURES = {
    # dtype, q, k, v, lepe_w, out, lse, ldq, ldk, ldv, ldo,
    # B, H, W, hsp, wsp, heads, head_dim, scale, seed, threshold, inv_keep, stream
    "csu_stripe_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _U, _U, _F, _P],
    # dtype, x, enc, out, B, H, W, C, S, vec, pass pixels, pc, stream
    "csu_carafe_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, enc, bias, fb, s1, s2, B, H, W, C, S, vec, pass pixels, pc, stream
    "csu_carafe_head_fwd": [_I, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, fb, mu, var, w, out, B, H, W, C, G, F, vec, lanes, lam, gate, pc, stream
    "csu_simam_head_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _F, _I, _I, _P],
    # dtype, q, k, v, lepe_w, dout, lse, delta, dq, dk, dv, dw_part, ldq, ldk, ldv,
    # ldg, B, H, W, hsp, wsp, heads, head_dim, scale, seed, threshold, inv_keep, stream
    "csu_stripe_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L,
                                 _L, _L, _I, _I, _I, _I, _I, _I, _I, _F, _U, _U, _F, _P],
    # dtype, x, enc, dacc, dx, denc, B, H, W, C, S, vec, px, rows, stream
    "csu_carafe_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, fb, dy, mu, var, w, part, B, H, W, C, G, F, vec, lam, pc, stream
    "csu_head_bwd1": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # dtype, x, enc, fb, dy, w, mu, var, A, Bq, dx, denc, db_part, B, H, W, C,
    # S, F, vec, px, rows, lam, stream
    "csu_carafe_head_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, fb, dy, part, B, H, W, C, G, F, vec, pc, stream
    "csu_head_bwd1_nogate": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, q, k, v, lepe_w, out, lse, ldq, ldk, ldv, B, H, W, hsp, wsp, heads,
    # head_dim, scale, mask_tile, seed, threshold, inv_keep, stream
    "csu_flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I,
                                _I, _I, _F, _I, _U, _U, _F, _P],
    # dtype, q, k, v, dout, lse, delta, delta_given, dq, ldq, ldk, ldv, ldg, B, H,
    # W, hsp, wsp, heads, head_dim, scale, mask_tile, seed, threshold, inv_keep, stream
    "csu_flash_attention_dq": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _L, _L, _L, _L, _I, _I,
                               _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _P],
    # dtype, q, k, v, lepe_w, dout, lse, delta, dk, dv, dw_part, ldq, ldk, ldv, ldg,
    # B, H, W, hsp, wsp, heads, head_dim, scale, mask_tile, seed, threshold,
    # inv_keep, stream
    "csu_flash_attention_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                                _I, _I, _I, _I, _I, _I, _I, _F, _I, _U, _U, _F, _P],
    # dtype, x, enc, dy, w, dx, denc, db_part, B, H, W, C, S, F, vec, px, rows, stream
    "csu_carafe_head_bwd_nogate": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P],
    # dtype, fb, dy, mu, var, A, Bq, w, dx, db_part, B, H, W, C, G, F, vec, lam, stream
    "csu_head_bwd2": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _F, _P],
    # dtype, dy, w, dx, db_part, B, H, W, C, G, F, vec, stream
    "csu_head_bwd2_nogate": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, g, b, y, M, C, eps, stream
    "csu_layernorm_fwd": [_I, _P, _P, _P, _P, _L, _I, _F, _P],
    # dtype, x, g, dy, dx, dg_part, db_part, M, C, eps, stream
    "csu_layernorm_bwd": [_I, _P, _P, _P, _P, _P, _P, _L, _I, _F, _P],
    # dtype, q, k, v, out, lse, G, Np, head_dim, n_valid, scale, stream
    "csu_window_attention_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # dtype, q, k, v, dout, lse, delta, dq, dk, dv, G, Np, head_dim, n_valid, scale, stream
    "csu_window_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                 _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The flash-attention family runs in two modes, counted apart as
# "<entry>:window" (windows of up to 2048 tokens too large for K-A / K-A',
# LePE fused) and "<entry>:flash" (longer windows, LePE outside).
FLASH_ENTRIES = ("csu_flash_attention_fwd", "csu_flash_attention_dq",
                 "csu_flash_attention_dkv")
FLASH_MODES = ("window", "flash")

# launches of each kernel (and mode) since the last reset, counted by launch()
LAUNCHES = {key: 0 for name in _SIGNATURES for key in (
    [f"{name}:{mode}" for mode in FLASH_MODES] if name in FLASH_ENTRIES else [name])}

# The attention entries (K-A, K-A', the flash family's three, K-V1 and
# K-V1') launch one of two bodies, which the C entry picks by dtype and head
# dim (csu_attention_body): "mma", the bf16 tensor-core body, or "fma", the
# CUDA-core body.  Each launch also counts under "<entry>:<body>" (K-A,
# K-A', K-V1, K-V1') or "<entry>:<mode>:<body>" (the flash family) here,
# apart from LAUNCHES, whose keys stay one per entry and mode.
BODY_ENTRIES = ("csu_stripe_attention_fwd", "csu_stripe_attention_bwd", *FLASH_ENTRIES,
                "csu_window_attention_fwd", "csu_window_attention_bwd")
BODIES = ("mma", "fma")
BODY_LAUNCHES = {f"{key}:{body}": 0 for key in LAUNCHES
                 if key.split(":")[0] in BODY_ENTRIES for body in BODIES}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


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
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src.name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    try:
        for name, _, proc in jobs:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} (code {proc.returncode}):\n{out[-4000:]}")
    finally:  # no compiler outlives a failed or interrupted build
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log = "\n".join(logs)
    if not failed:
        tmp = out_dir / f"libcsu_kernels.{pid}.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
                              capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(f"link (code {link.returncode}):\n{link.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(log)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    build_info.update(path=str(lib), seconds=seconds, cached=False, log=log)
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
            lib.csu_attention_body.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.csu_attention_body.restype = ctypes.c_int
            lib.csu_window_attention_design.argtypes = [ctypes.c_int] * 3
            lib.csu_window_attention_design.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args, mode: str | None = None,
           body: str | None = None) -> None:
    """Call kernel entry ``name`` on ``device``'s current stream with
    ``args`` (the stream is appended); raise if the launch failed.  The
    launch counts under ``name``, or ``name:mode`` for the flash family, and
    under that key and ``:body`` in BODY_LAUNCHES where the entry picks a
    body."""
    key = name if mode is None else f"{name}:{mode}"
    if key not in LAUNCHES:
        raise KeyError(f"no launch counter {key!r}")
    body_key = None if body is None else f"{key}:{body}"
    if body_key is not None and body_key not in BODY_LAUNCHES:
        raise KeyError(f"no body counter {body_key!r}")
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.csu_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")
    LAUNCHES[key] += 1
    if body_key is not None:
        BODY_LAUNCHES[body_key] += 1


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


def token_stride(t: torch.Tensor) -> int | None:
    """Row stride of a (B, L, C) tensor whose rows are unit-stride and evenly
    spaced (a column slice of a wider token tensor qualifies); None else."""
    B, L, C = t.shape
    if t.stride(2) != 1 or (L > 1 and t.stride(1) < C) or (
            B > 1 and t.stride(0) != L * t.stride(1)):
        return None
    return t.stride(1)


def token_strides(*named: tuple[torch.Tensor, str]) -> list[int]:
    """:func:`token_stride` of each (tensor, name); raise for one without."""
    out = []
    for t, name in named:
        ld = token_stride(t)
        if ld is None:
            raise ValueError(f"{name}: rows must be unit-stride and evenly spaced, "
                             f"got strides {t.stride()}")
        out.append(ld)
    return out


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
