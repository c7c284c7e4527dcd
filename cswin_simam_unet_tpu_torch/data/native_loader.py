"""ctypes bindings of the native JPEG loader (``native/dataio.cpp``).

Counterpart of ``cswin_simam_unet_tpu/data/native_loader.py``, with its own
bindings: the same two C entry points and ``argtypes``.  The library is the
repository's ``native/libcsu_dataio.so``.  It was built with
``-march=native`` against ``libjpeg.so.62``, so on another machine it may
not load, or may stop the process on an instruction that the CPU lacks;
each candidate is therefore first tried in a child process, which decodes
a small JPEG through it.  Where the committed library fails, ``dataio.cpp``
is built once with ``native/build.sh``'s g++ flags into the git-ignored
``build/dataio/`` (never over the committed file) and tried the same way.
Where neither works, :func:`available` is False and the callers decode with
cv2 or PIL.  ctypes calls release the GIL, so a thread pool decodes in
parallel.
"""

from __future__ import annotations

import base64
import ctypes
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
COMMITTED = _REPO / "native" / "libcsu_dataio.so"
SOURCE = _REPO / "native" / "dataio.cpp"
BUILT = _REPO / "build" / "dataio" / "libcsu_dataio.so"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
PROBE_TIMEOUT_S = 60

# an 8x8 grayscale JPEG (a diagonal ramp) that the child process decodes
_PROBE_JPEG = base64.b64decode(
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDABALDA4MChAODQ4SERATGCgaGBYWGDEjJR0oOjM9PDkzODdASFxO"
    "QERXRTc4UG1RV19iZ2hnPk1xeXBkeFxlZ2P/wAALCAAIAAgBAREA/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAEC"
    "AwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAk"
    "M2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJ"
    "ipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3"
    "+Pn6/9oACAEBAAA/AK+iaP8Ad+Wv/9k=")
_PROBE = """
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
data = sys.stdin.buffer.read()
out = ctypes.create_string_buffer(12 * 12)
rc = lib.csu_decode_resize(data, ctypes.c_size_t(len(data)), 12, 12, 1, out)
sys.exit(0 if rc == 0 and len(set(out.raw)) > 4 else 3)
"""

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
STATUS = "not tried"  # which library loaded, or why none did


def _probe(path: Path) -> Optional[str]:
    """None if a child process decodes the probe JPEG through the library
    at ``path``, else what went wrong."""
    try:
        res = subprocess.run([sys.executable, "-c", _PROBE, str(path)], input=_PROBE_JPEG,
                             capture_output=True, timeout=PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return "the probe timed out"
    if res.returncode == 0:
        return None
    err = res.stderr.decode(errors="replace").strip().splitlines()
    return f"the probe exited with {res.returncode}" + (f": {err[-1]}" if err else "")


def _build() -> Optional[str]:
    """Build ``dataio.cpp`` into ``BUILT``; None on success, else why not."""
    gxx = shutil.which("g++")
    if gxx is None or not SOURCE.exists():
        return "no g++" if gxx is None else f"no {SOURCE}"
    BUILT.parent.mkdir(parents=True, exist_ok=True)
    tmp = BUILT.with_name(f"{BUILT.name}.tmp{os.getpid()}")
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-ljpeg", "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return "g++ timed out"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        tail = res.stderr.strip().splitlines()
        return f"g++ failed: {tail[-1] if tail else res.returncode}"
    os.replace(tmp, BUILT)
    return None


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.csu_decode_resize.restype = ctypes.c_int
    lib.csu_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.csu_load_batch.restype = ctypes.c_int
    lib.csu_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _lib():
    global _LIB, _TRIED, STATUS
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        notes = []
        why = _probe(COMMITTED) if COMMITTED.exists() else f"no {COMMITTED}"
        if why is None:
            path = COMMITTED
        else:
            notes.append(f"committed library: {why}")
            why = None if BUILT.exists() else _build()
            why = why or _probe(BUILT)
            path = BUILT if why is None else None
            if why is not None:
                notes.append(f"built library: {why}")
        if path is not None:
            _LIB = _bind(path)
            notes.append(f"loaded {path.relative_to(_REPO)}")
        STATUS = "; ".join(notes)
        return _LIB


def available() -> bool:
    return _lib() is not None


def decode_resize(data: bytes, size: Tuple[int, int],
                  gray: bool = False) -> Optional[np.ndarray]:
    """JPEG decode and bilinear resize: uint8 (H, W, 3) RGB or (H, W) gray;
    None where the library is missing or cannot decode the bytes (PNG
    bytes, say), and the caller falls back to cv2 or PIL."""
    lib = _lib()
    if lib is None:
        return None
    h, w = size
    out = np.empty((h, w) if gray else (h, w, 3), dtype=np.uint8)
    rc = lib.csu_decode_resize(data, len(data), h, w, int(gray),
                               out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def load_batch(img_paths: Sequence[str], mask_paths: Sequence[Optional[str]],
               size: Tuple[int, int], threads: int = 4):
    """Threaded batch load: (images (N, H, W, 3), masks (N, H, W, 1),
    status (N,): 0 ok, 1 bad image, 2 zero-filled mask), uint8; None
    without the library."""
    lib = _lib()
    if lib is None:
        return None
    n = len(img_paths)
    h, w = size
    images = np.empty((n, h, w, 3), dtype=np.uint8)
    masks = np.empty((n, h, w, 1), dtype=np.uint8)
    status = np.empty((n,), dtype=np.uint8)
    c_imgs = (ctypes.c_char_p * n)(*[p.encode() for p in img_paths])
    c_masks = (ctypes.c_char_p * n)(*[(p.encode() if p else None) for p in mask_paths])
    lib.csu_load_batch(c_imgs, c_masks, n, h, w, threads,
                       images.ctypes.data_as(ctypes.c_void_p),
                       masks.ctypes.data_as(ctypes.c_void_p),
                       status.ctypes.data_as(ctypes.c_void_p))
    return images, masks, status
