"""ctypes bindings for the native host runtime (``src/liorf_native.cpp``).

Host code only: the scan packer of the resident pipeline, PointCloud2
field extraction and bz2 chunk decoding for the rosbag reader, and a
threaded file prefetcher. Built with g++ at first use into
``build/liorf_tpu_torch/`` beside the package (or ``$LIORF_TORCH_BUILD_DIR``),
one library per source content, and loaded with ctypes. Every consumer has
a numpy fallback (the JAX package's behaviour), so an unavailable library
is an accelerator missing, never an error: ``get_lib()`` then returns None
and ``build_error`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..core.build import build_dir

_SRC = Path(__file__).resolve().parent / "src" / "liorf_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
build_error: str | None = None  # why get_lib() returned None, if it did


def _build() -> Path | None:
    """The library for this source, built now unless it exists."""
    global build_error
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    out_dir = build_dir()
    so = out_dir / f"liorf_native_{tag}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-ldl", "-lpthread"],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"g++ did not run: {e}"
        return None
    if proc.returncode != 0:
        build_error = f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}"
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded native library, or None if it cannot be built or loaded."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        build_error = f"load failed: {e}"
        return None
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    lib.ln_pc2_extract.restype = ctypes.c_int
    lib.ln_pc2_extract.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, ctypes.c_int32, f32p,
    ]
    lib.ln_bz2_decompress.restype = ctypes.c_int64
    lib.ln_bz2_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.ln_has_bz2.restype = ctypes.c_int
    lib.ln_prefetcher_create.restype = ctypes.c_void_p
    lib.ln_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ln_prefetcher_get.restype = ctypes.c_int64
    lib.ln_prefetcher_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.ln_prefetcher_size.restype = ctypes.c_int64
    lib.ln_prefetcher_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ln_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.ln_pack_scan.restype = ctypes.c_int64
    lib.ln_pack_scan.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_double), i32p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, f32p, f32p, f32p,
    ]
    _lib = lib
    return _lib


def pack_scan_into(
    xyz: np.ndarray, rel: np.ndarray, ring: np.ndarray,
    min_r2: float, max_r2: float, dsr: int, pfn: int,
    xyz_out: np.ndarray, rts_out: np.ndarray, msk_out: np.ndarray | None = None,
) -> int:
    """One-pass range/ring/stride filter + pad, written straight into the
    caller's f32 buffers. msk_out may be None — packed points are compact,
    so callers can derive the mask from the kept count. Returns the TOTAL
    count passing the filters (> cap means the pack was truncated; at most
    cap points are written), or -1 when the native lib is unavailable or
    the inputs are malformed (callers fall back to numpy, which raises
    loudly on the same malformed inputs)."""
    lib = get_lib()
    if lib is None:
        return -1
    xyz = np.ascontiguousarray(xyz, np.float32)
    rel = np.ascontiguousarray(rel, np.float64)
    # the C loop indexes rel[i]/ring[i] up to len(xyz): a shorter array would
    # be a silent out-of-bounds read here where the numpy path IndexErrors
    if xyz.ndim != 2 or xyz.shape[1] != 3 or len(rel) != len(xyz):
        return -1
    fp = ctypes.POINTER(ctypes.c_float)
    cap = len(rts_out)
    ring_p = None
    if dsr > 1:
        if ring is None or len(ring) != len(xyz):
            return -1  # numpy path raises on ring=None with downsampleRate>1
        ring = np.ascontiguousarray(ring, np.int32)
        ring_p = ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return int(
        lib.ln_pack_scan(
            xyz.ctypes.data_as(fp),
            rel.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ring_p, len(xyz), min_r2, max_r2, dsr, pfn, cap,
            xyz_out.ctypes.data_as(fp), rts_out.ctypes.data_as(fp),
            None if msk_out is None else msk_out.ctypes.data_as(fp),
        )
    )


def pc2_extract(data: bytes, n: int, point_step: int, fields):
    """Native AoS->SoA extraction. fields: [(offset, dtype_code)] ->
    float32 array [n_fields, n]; returns None when the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    offs = np.asarray([f[0] for f in fields], np.int32)
    dts = np.asarray([f[1] for f in fields], np.int32)
    out = np.zeros((len(fields), n), np.float32)
    rc = lib.ln_pc2_extract(
        data, n, point_step,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(fields),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


def bz2_decompress(src: bytes, uncompressed_size: int):
    """Native bz2 chunk decode; None if unavailable."""
    lib = get_lib()
    if lib is None or not lib.ln_has_bz2():
        return None
    dest = ctypes.create_string_buffer(uncompressed_size)
    n = lib.ln_bz2_decompress(src, len(src), dest, uncompressed_size)
    if n < 0:
        return None
    return dest.raw[:n]


class FilePrefetcher:
    """Threaded read-ahead over an ordered list of files."""

    def __init__(self, paths: list[str], n_threads: int = 2, depth: int = 8):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.ln_prefetcher_create(arr, len(paths), n_threads, depth)
        self._n = len(paths)

    def get(self, idx: int) -> bytes:
        size = self._lib.ln_prefetcher_size(self._h, idx)
        buf = ctypes.create_string_buffer(max(int(size), 1))
        n = self._lib.ln_prefetcher_get(self._h, idx, buf, size)
        if n < 0:
            raise IOError(f"prefetch failed for index {idx}")
        return buf.raw[:n]

    def close(self):
        if self._h:
            self._lib.ln_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
