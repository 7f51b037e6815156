"""ctypes bindings for the native runtime library (hyslam_rt.cpp),
compiled on demand with g++. Queues carry uint64 handles; HandleRegistry
maps handles to Python payloads on this side of the ABI."""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "hyslam_rt.cpp")
# git-ignored build directory of the checkout
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
_lock = threading.Lock()
_lib = None


def library_path(src: str = _SRC) -> str:
    """Where the library built from `src` lives: the file name carries a
    hash of the source's content, so an edited source builds anew."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhyslam_rt-{digest}.so")


def build(src: str = _SRC) -> str:
    """Compile `src` unless its library exists; returns the library path.
    The compiler writes a private temporary file that is renamed into
    place, so concurrent builders never load a half-written library."""
    lib = library_path(src)
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src,
             "-lpthread"],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.hq_create.restype = ctypes.c_void_p
        lib.hq_create.argtypes = [ctypes.c_size_t]
        lib.hq_push.restype = ctypes.c_int
        lib.hq_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_long]
        lib.hq_pop.restype = ctypes.c_int
        lib.hq_pop.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_long
        ]
        lib.hq_size.restype = ctypes.c_size_t
        lib.hq_size.argtypes = [ctypes.c_void_p]
        lib.hq_clear.restype = ctypes.c_size_t
        lib.hq_clear.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t
        ]
        lib.hq_close.argtypes = [ctypes.c_void_p]
        lib.hq_destroy.argtypes = [ctypes.c_void_p]
        lib.hs_create.restype = ctypes.c_void_p
        lib.hs_destroy.argtypes = [ctypes.c_void_p]
        for f in ("stop_requested", "stopped", "release_requested",
                  "finish_requested", "finished", "interrupt_requested",
                  "accepting_input", "queue_length"):
            getattr(lib, f"hs_set_{f}").argtypes = [ctypes.c_void_p, ctypes.c_int]
            getattr(lib, f"hs_get_{f}").restype = ctypes.c_int
            getattr(lib, f"hs_get_{f}").argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class HandleRegistry:
    """uint64 handle <-> Python object mapping (payload side of the native
    queue)."""

    def __init__(self):
        self._objs = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def put(self, obj) -> int:
        h = next(self._next)
        with self._lock:
            self._objs[h] = obj
        return h

    def take(self, handle: int):
        with self._lock:
            return self._objs.pop(handle)

    def __len__(self):
        with self._lock:
            return len(self._objs)


class NativeQueue:
    """Bounded blocking queue backed by hyslam_rt (ThreadSafeQueue analog).

    capacity=0 means unbounded. Push applies backpressure when full."""

    def __init__(self, capacity: int = 0):
        self._lib = load_library()
        self._q = self._lib.hq_create(capacity)
        self._reg = HandleRegistry()
        self._closed = False

    def push(self, obj, timeout_ms: int = -1) -> bool:
        h = self._reg.put(obj)
        ok = self._lib.hq_push(self._q, h, timeout_ms)
        if not ok:
            self._reg.take(h)
            return False
        return True

    def pop(self, timeout_ms: int = -1):
        out = ctypes.c_uint64()
        ok = self._lib.hq_pop(self._q, ctypes.byref(out), timeout_ms)
        if not ok:
            return None
        return self._reg.take(out.value)

    def clear(self) -> int:
        """Drop everything queued (mapping overflow clearing). Returns the
        number of dropped items."""
        buf = (ctypes.c_uint64 * 4096)()
        n = self._lib.hq_clear(self._q, buf, 4096)
        for i in range(n):
            self._reg.take(buf[i])
        return n

    def size(self) -> int:
        return self._lib.hq_size(self._q)

    def close(self):
        if not self._closed:
            self._lib.hq_close(self._q)
            self._closed = True

    def __del__(self):
        try:
            self.close()
            self._lib.hq_destroy(self._q)
        except Exception:
            pass


class ThreadStatus:
    """Native atomic flag block (InterThread.h ThreadStatus analog)."""

    _FLAGS = ("stop_requested", "stopped", "release_requested",
              "finish_requested", "finished", "interrupt_requested",
              "accepting_input", "queue_length")

    def __init__(self):
        self._lib = load_library()
        self._s = self._lib.hs_create()

    def __getattr__(self, name):
        if name in ThreadStatus._FLAGS:
            # note: lib["f"] would create a fresh FuncPtr WITHOUT the
            # argtypes configured in load_library; getattr reuses it
            return getattr(self._lib, f"hs_get_{name}")(self._s)
        raise AttributeError(name)

    def set(self, name, value: int):
        assert name in ThreadStatus._FLAGS
        getattr(self._lib, f"hs_set_{name}")(self._s, int(value))

    def __del__(self):
        try:
            self._lib.hs_destroy(self._s)
        except Exception:
            pass
