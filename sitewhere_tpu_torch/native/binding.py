"""ctypes binding of the native host data plane (port of
``sitewhere_tpu/native/binding.py``).

The port compiles the repository's shared host sources,
``native/src/swtpu.cpp`` (the packed-buffer decoders, the interners and the
shard-decode context) and ``native/src/swtpu_py.cpp`` (the entry points
that take a ``list[bytes]``), with ``g++ -O3 -shared -fPIC -std=c++17``
into ``sitewhere_tpu_torch/csrc/build/``: file names carry a hash of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded. The JAX package keeps its own libraries in ``native/build/``.

There is no quiet fallback: a failed build or load raises and says why.
The Python decode path runs only when an engine is asked for it
(``EngineConfig(use_native=False)``). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sysconfig
import tempfile
import threading

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "src" / "swtpu.cpp"
_PY_SRC = _REPO / "native" / "src" / "swtpu_py.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "build"
# no -march=native: a library built on one host must load on another
# (the build directory may travel with a copy of the checkout)
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_py_lib: ctypes.PyDLL | None = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.swtpu_interner_create.restype = c.c_void_p
    lib.swtpu_interner_create.argtypes = [c.c_int32]
    lib.swtpu_interner_destroy.argtypes = [c.c_void_p]
    lib.swtpu_intern.restype = c.c_int32
    lib.swtpu_intern.argtypes = [c.c_void_p, c.c_char_p, c.c_int32]
    lib.swtpu_interner_lookup.restype = c.c_int32
    lib.swtpu_interner_lookup.argtypes = [c.c_void_p, c.c_char_p, c.c_int32]
    lib.swtpu_interner_size.restype = c.c_int32
    lib.swtpu_interner_size.argtypes = [c.c_void_p]
    lib.swtpu_interner_get.restype = c.c_int32
    lib.swtpu_interner_get.argtypes = [c.c_void_p, c.c_int32, c.c_char_p, c.c_int32]
    lib.swtpu_interner_truncate.argtypes = [c.c_void_p, c.c_int32]
    lib.swtpu_decoder_create.restype = c.c_void_p
    lib.swtpu_decoder_create.argtypes = [c.c_void_p, c.c_int32, c.c_int32,
                                         c.c_int32]
    lib.swtpu_decoder_destroy.argtypes = [c.c_void_p]
    lib.swtpu_decoder_names.restype = c.c_void_p
    lib.swtpu_decoder_names.argtypes = [c.c_void_p]
    lib.swtpu_decoder_alert_types.restype = c.c_void_p
    lib.swtpu_decoder_alert_types.argtypes = [c.c_void_p]
    lib.swtpu_decoder_event_ids.restype = c.c_void_p
    lib.swtpu_decoder_event_ids.argtypes = [c.c_void_p]
    lib.swtpu_decode_batch.restype = c.c_int32
    lib.swtpu_decode_batch.argtypes = [
        c.c_void_p,                      # decoder
        c.c_char_p,                      # buf
        c.POINTER(c.c_int64),            # offsets
        c.c_int32, c.c_int32,            # n_msgs, channels
        c.POINTER(c.c_int32),            # out_rtype
        c.POINTER(c.c_int32),            # out_token
        c.POINTER(c.c_int64),            # out_ts
        c.POINTER(c.c_float),            # out_values
        c.POINTER(c.c_uint8),            # out_chmask
        c.POINTER(c.c_int32),            # out_aux0
        c.POINTER(c.c_int32),            # out_aux1
        c.POINTER(c.c_int32),            # out_level
        c.POINTER(c.c_int32),            # out_collisions
    ]
    lib.swtpu_decode_binary_batch.restype = c.c_int32
    lib.swtpu_decode_binary_batch.argtypes = lib.swtpu_decode_batch.argtypes
    # arena fill: strided aux columns + a json/binary flag
    lib.swtpu_decode_arena_batch.restype = c.c_int32
    lib.swtpu_decode_arena_batch.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64),
        c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32), c.c_int64,     # aux0 + stride
        c.POINTER(c.c_int32), c.c_int64,     # aux1 + stride
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32,
    ]
    # sharded-decode context (multi-worker arena decode)
    lib.swtpu_shard_create.restype = c.c_void_p
    lib.swtpu_shard_create.argtypes = [c.c_void_p]
    lib.swtpu_shard_destroy.argtypes = [c.c_void_p]
    lib.swtpu_shard_reset.argtypes = [c.c_void_p]
    lib.swtpu_shard_new_count.restype = c.c_int32
    lib.swtpu_shard_new_count.argtypes = [c.c_void_p, c.c_int32]
    lib.swtpu_shard_new_string.restype = c.c_int32
    lib.swtpu_shard_new_string.argtypes = [
        c.c_void_p, c.c_int32, c.c_int32, c.c_char_p, c.c_int32]
    lib.swtpu_shard_patch_count.restype = c.c_int32
    lib.swtpu_shard_patch_count.argtypes = [c.c_void_p, c.c_int32]
    lib.swtpu_shard_patch_fetch.argtypes = [
        c.c_void_p, c.c_int32, c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_float)]
    return lib


def _configure_py(lib: ctypes.PyDLL) -> ctypes.PyDLL:
    """Only the list entry points: this handle holds the GIL for every
    call (until the entry point drops it itself), so the packed batch
    functions must never be reached through it — they would run the whole
    scan under the GIL. Those go through the CDLL handle."""
    c = ctypes
    lib.swtpu_decode_pylist.restype = c.c_int32
    lib.swtpu_decode_pylist.argtypes = [
        c.c_void_p, c.py_object, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32]
    lib.swtpu_decode_arena_pylist.restype = c.c_int32
    lib.swtpu_decode_arena_pylist.argtypes = [
        c.c_void_p, c.py_object, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32), c.c_int64,   # aux0 + stride
        c.POINTER(c.c_int32), c.c_int64,   # aux1 + stride
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32]
    # ranged shard decode: list slice [start, start+n) into a disjoint
    # arena row range through a ShardCtx created by the CDLL handle (the
    # py library includes swtpu.cpp, so the structures agree)
    lib.swtpu_shard_decode_arena_pylist.restype = c.c_int32
    lib.swtpu_shard_decode_arena_pylist.argtypes = [
        c.c_void_p, c.py_object, c.c_int32, c.c_int32,
        c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32), c.c_int64,
        c.POINTER(c.c_int32), c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32]
    return lib


def _build(name: str, sources: list[pathlib.Path], extra: list[str]) -> pathlib.Path:
    """Compile ``sources[0]`` (the others are headers it includes) into
    ``BUILD_DIR/lib<name>-<hash>.so``; cached by the hash of every source
    and the flags. The link writes a temporary file that is renamed over
    the target, so a process that already loaded an older library keeps
    its mapping. Raises RuntimeError with the compiler's output."""
    flags = GXX_FLAGS + extra
    digest = hashlib.sha1(b"".join(s.read_bytes() for s in sources)
                          + " ".join(flags).encode()).hexdigest()[:12]
    target = BUILD_DIR / f"lib{name}-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, str(sources[0]), "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build of {name} failed: cannot run g++ ({e})") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build of {name} failed (g++ exit "
                           f"{res.returncode}):\n{res.stderr.strip()}")
    os.replace(tmp, target)
    return target


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the packed-ABI library; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            so = _build("swtpu", [_SRC], [])
            try:
                _lib = _configure(ctypes.CDLL(str(so)))
            except OSError as e:
                raise RuntimeError(f"native library {so} failed to load: {e}") from e
        return _lib


def load_py_library() -> ctypes.PyDLL:
    """Build (if needed) and load the CPython-aware library (the
    ``list[bytes]`` entry points), as a PyDLL; raises when it cannot be
    built or loaded."""
    global _py_lib
    with _lock:
        if _py_lib is None:
            so = _build("swtpu_py", [_PY_SRC, _SRC],
                        [f"-I{sysconfig.get_path('include')}", f"-I{_SRC.parent}"])
            try:
                _py_lib = _configure_py(ctypes.PyDLL(str(so)))
            except OSError as e:
                raise RuntimeError(f"native library {so} failed to load: {e}") from e
        return _py_lib


class NativeInterner:
    """TokenInterner-compatible wrapper over the C++ open-addressing table.

    Keeps a lazily-synced Python-side list of strings (ids are dense and
    append-only, so syncing pulls only the tail)."""

    def __init__(self, capacity: int, lib: ctypes.CDLL | None = None,
                 handle: int | None = None):
        self.capacity = capacity
        self.lib = lib or load_library()
        self.handle = (handle if handle is not None
                       else self.lib.swtpu_interner_create(capacity))
        self._tokens: list[str] = []

    def __len__(self) -> int:
        return int(self.lib.swtpu_interner_size(self.handle))

    def intern(self, token: str) -> int:
        b = token.encode()
        tid = int(self.lib.swtpu_intern(self.handle, b, len(b)))
        if tid < 0:
            raise RuntimeError(f"token capacity {self.capacity} exhausted")
        return tid

    def lookup(self, token: str) -> int:
        b = token.encode()
        return int(self.lib.swtpu_interner_lookup(self.handle, b, len(b)))

    def _sync(self) -> None:
        n = len(self)
        buf = ctypes.create_string_buffer(1024)
        while len(self._tokens) < n:
            i = len(self._tokens)
            ln = int(self.lib.swtpu_interner_get(self.handle, i, buf, 1024))
            self._tokens.append(buf.raw[: min(ln, 1024)].decode(errors="replace"))

    def token(self, tid: int) -> str:
        if tid >= len(self._tokens):
            self._sync()
        return self._tokens[tid]

    def truncate(self, n: int) -> None:
        """Roll back to the first ``n`` entries (rejected-batch cleanup)."""
        self.lib.swtpu_interner_truncate(self.handle, n)
        del self._tokens[n:]

    def items(self):
        self._sync()
        return ((s, i) for i, s in enumerate(self._tokens))
