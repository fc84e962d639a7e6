"""ctypes bindings for the native slamio library (native/slamio.cpp).

Provides the C implementations of the hot host-side paths — YUYV pixel
conversion, the threaded frame ring buffer, V4L2 capture — with pure-numpy
fallbacks when the library cannot be built. The library is not committed:
:func:`load` builds it from source with ``make -C native`` at first use
when a compiler is present (or run that command yourself).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_LIB = None
_NATIVE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SO = os.path.join(_NATIVE, "libslamio.so")
_SEARCH = (_SO, "libslamio.so")


def _build() -> None:
    """``make -C native`` if the library is missing or older than its
    source. A file lock keeps concurrent first users (test workers) from
    racing on the same output."""
    src = os.path.join(_NATIVE, "slamio.cpp")
    if not os.path.exists(src) or shutil.which("make") is None:
        return
    import fcntl

    with open(os.path.join(_NATIVE, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(src)):
            return
        subprocess.run(["make", "-C", _NATIVE], capture_output=True,
                       check=False)


def load():
    global _LIB
    if _LIB is not None:
        return _LIB
    _build()
    for p in _SEARCH:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.path.sep in p else p)
            break
        except OSError:
            lib = None
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.yuyv_to_bgr.argtypes = [u8p, ctypes.c_int, u8p]
    lib.yuyv_to_grey.argtypes = [u8p, ctypes.c_int, f32p]
    lib.bgr_to_grey.argtypes = [u8p, ctypes.c_int, f32p]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_start.restype = None
    lib.ring_start.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_next.restype = ctypes.c_int
    lib.ring_next.argtypes = [ctypes.c_void_p, f32p]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "v4l2_open"):
        lib.v4l2_open.restype = ctypes.c_void_p
        lib.v4l2_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
        lib.v4l2_read_grey.restype = ctypes.c_int
        lib.v4l2_read_grey.argtypes = [ctypes.c_void_p, f32p]
        lib.v4l2_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def yuyv_to_bgr(yuyv: np.ndarray, width: int, height: int) -> np.ndarray:
    """YUYV bytes -> BGR888 [h,w,3] u8 (video.cpp:187-223 integer math)."""
    yuyv = np.ascontiguousarray(yuyv, np.uint8).reshape(-1)
    out = np.empty(height * width * 3, np.uint8)
    lib = load()
    if lib is not None:
        lib.yuyv_to_bgr(_u8p(yuyv), yuyv.size, _u8p(out))
        return out.reshape(height, width, 3)
    # numpy fallback, same integer math
    p = yuyv.reshape(-1, 4).astype(np.int32)
    y = np.stack([p[:, 0], p[:, 2]], axis=1)  # [n,2]
    cb = ((p[:, 1] - 128) * 454) >> 8
    cg = ((p[:, 1] - 128) * 88 + (p[:, 3] - 128) * 183) >> 8
    cr = ((p[:, 3] - 128) * 359) >> 8
    b = np.clip(y + cb[:, None], 0, 255)
    g = np.clip(y - cg[:, None], 0, 255)
    r = np.clip(y + cr[:, None], 0, 255)
    out = np.stack([b, g, r], axis=-1).astype(np.uint8)  # [n,2,3]
    return out.reshape(height, width, 3)


def yuyv_to_grey(yuyv: np.ndarray, width: int, height: int) -> np.ndarray:
    """YUYV bytes -> grey f32 [h,w] in [0,1] (luma only)."""
    yuyv = np.ascontiguousarray(yuyv, np.uint8).reshape(-1)
    lib = load()
    if lib is not None:
        out = np.empty(height * width, np.float32)
        lib.yuyv_to_grey(_u8p(yuyv), yuyv.size, _f32p(out))
        return out.reshape(height, width)
    return (yuyv.reshape(-1, 2)[:, 0].astype(np.float32) / 255.0).reshape(
        height, width
    )


class FrameRing:
    """Native threaded prefetch ring over a Python frame callback.

    fill(dst_f32_flat) -> bool; runs on a native-owned thread via a
    ctypes callback. Falls back to the pure-Python prefetch in sources.py
    when the library is missing.
    """

    _FILL = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_float))

    def __init__(self, frame_shape, capacity: int = 4, fill=None):
        self.shape = tuple(frame_shape)
        self.n = int(np.prod(self.shape))
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self.lib = lib
        self.ring = lib.ring_create(capacity, self.n)

        def _fill(_ctx, dst):
            buf = np.ctypeslib.as_array(dst, shape=(self.n,))
            frame = fill()
            if frame is None:
                return 0
            buf[:] = np.asarray(frame, np.float32).reshape(-1)
            return 1

        self._cb = self._FILL(_fill)
        lib.ring_start(self.ring, ctypes.cast(self._cb, ctypes.c_void_p), None)

    def next(self):
        out = np.empty(self.n, np.float32)
        fid = self.lib.ring_next(self.ring, _f32p(out))
        if fid < 0:
            return None, -1
        return out.reshape(self.shape), fid

    def close(self):
        if self.ring:
            self.lib.ring_destroy(self.ring)
            self.ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
