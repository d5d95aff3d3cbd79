"""ctypes loader (with on-demand build) for libspringtpu.so.

The native library holds the sequential/byte-oriented codecs that the
reference implements in C++ (libbsc, id_compression): our xbc block codec
(SA-IS BWT + MTF/RLE0 + adaptive range coder) and the tokenized id codec.
Built with `make` on first use; rebuilt when sources are newer than the .so.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# SPRING_TPU_SO overrides the library path (sanitizer builds in tests)
_SO = os.environ.get("SPRING_TPU_SO",
                     os.path.join(_CSRC, "libspringtpu.so"))
_lock = threading.Lock()
_lib = None


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_mtime = os.path.getmtime(_SO)
    for f in os.listdir(_CSRC):
        if f.endswith((".cpp", ".h", "Makefile")):
            if os.path.getmtime(os.path.join(_CSRC, f)) > so_mtime:
                return True
    return False


def _build() -> None:
    target = os.path.basename(_SO)
    r = subprocess.run(["make", "-s", "-C", _CSRC, target],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {target} failed (make exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            _build()
        lib = ctypes.CDLL(_SO)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.stpu_xbc_bound.restype = ctypes.c_int64
        lib.stpu_xbc_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.stpu_xbc_compress.restype = ctypes.c_int64
        lib.stpu_xbc_compress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int]
        lib.stpu_xbc_decompressed_size.restype = ctypes.c_int64
        lib.stpu_xbc_decompressed_size.argtypes = [c_u8p, ctypes.c_int64]
        lib.stpu_xbc_decompress.restype = ctypes.c_int64
        lib.stpu_xbc_decompress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                            ctypes.c_int64, ctypes.c_int]
        lib.stpu_id_compress.restype = ctypes.c_int64
        lib.stpu_id_compress.argtypes = [c_u8p, c_u32p, ctypes.c_uint32,
                                         c_u8p, ctypes.c_int64]
        lib.stpu_id_decompress.restype = ctypes.c_int64
        lib.stpu_id_decompress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                           ctypes.c_int64, c_u32p,
                                           ctypes.c_int64, c_u32p]
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        lib.stpu_fastq_ckpt_stride.restype = ctypes.c_int64
        lib.stpu_fastq_ckpt_stride.argtypes = []
        lib.stpu_fastq_scan.restype = ctypes.c_int64
        lib.stpu_fastq_scan.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int,
                                        c_i64p, c_i64p, c_i64p, c_i64p,
                                        c_i64p, c_i64p]
        lib.stpu_fastq_parse.restype = ctypes.c_int64
        lib.stpu_fastq_parse.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int64, ctypes.c_int64,
                                         c_u8p, c_i32p, c_u8p, ctypes.c_int,
                                         c_u8p, c_u32p, c_i64p, c_i64p,
                                         ctypes.c_int]
        lib.stpu_fastq_parse_packed.restype = ctypes.c_int64
        lib.stpu_fastq_parse_packed.argtypes = [
            c_u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, c_u32p, c_i32p, c_u8p, ctypes.c_int, c_u8p,
            c_u32p, c_i64p, c_i64p, c_i32p, ctypes.c_int64, c_i64p,
            ctypes.c_int]
        lib.stpu_pack_2bit.restype = None
        lib.stpu_pack_2bit.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_uint32),
                                       ctypes.c_int]
        lib.stpu_fastq_format.restype = ctypes.c_int64
        lib.stpu_fastq_format.argtypes = [c_u8p, c_i32p, c_u8p, c_u8p,
                                          c_u32p, ctypes.c_int64,
                                          ctypes.c_int64, c_u8p]
        lib.stpu_qv_bound.restype = ctypes.c_int64
        lib.stpu_qv_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.stpu_qv_compress.restype = ctypes.c_int64
        lib.stpu_qv_compress.argtypes = [c_u8p, ctypes.c_int64, c_i32p,
                                         c_u8p, ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int]
        lib.stpu_qv_dims.restype = ctypes.c_int
        lib.stpu_qv_dims.argtypes = [c_u8p, ctypes.c_int64, c_i64p, c_i64p,
                                     c_i64p]
        lib.stpu_qv_decompress.restype = ctypes.c_int64
        lib.stpu_qv_decompress.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                           ctypes.c_int64, c_i32p,
                                           ctypes.c_int64, ctypes.c_int]
        lib.stpu_consensus.restype = None
        lib.stpu_consensus.argtypes = [c_u8p, ctypes.c_int64, c_i32p, c_i32p,
                                       c_i64p, c_u8p, ctypes.c_int64,
                                       ctypes.c_int64, c_u8p, ctypes.c_int]
        lib.stpu_noise_count.restype = None
        lib.stpu_noise_count.argtypes = [c_u8p, ctypes.c_int64, c_i32p,
                                         c_i32p, c_i64p, c_u8p,
                                         ctypes.c_int64, c_u8p,
                                         ctypes.c_int64, c_i32p, ctypes.c_int]
        lib.stpu_noise_fill.restype = None
        lib.stpu_noise_fill.argtypes = [c_u8p, ctypes.c_int64, c_i32p, c_i32p,
                                        c_i64p, c_u8p, ctypes.c_int64, c_u8p,
                                        ctypes.c_int64, c_i64p, c_i32p,
                                        c_u8p, ctypes.c_int]
        lib.stpu_unpack_2bit.restype = None
        lib.stpu_unpack_2bit.argtypes = [c_u32p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         c_u8p, ctypes.c_int]
        lib.stpu_consensus_p.restype = None
        lib.stpu_consensus_p.argtypes = [c_u32p, ctypes.c_int64, c_i32p,
                                         c_i32p, c_i64p, c_u8p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         c_u8p, ctypes.c_int]
        lib.stpu_noise_count_p.restype = None
        lib.stpu_noise_count_p.argtypes = [c_u32p, ctypes.c_int64, c_i32p,
                                           c_i32p, c_i64p, c_i32p,
                                           ctypes.c_int64, c_i32p, c_i64p,
                                           c_u8p, ctypes.c_int64, c_u8p,
                                           ctypes.c_int64, c_i32p,
                                           ctypes.c_int]
        lib.stpu_noise_fill_p.restype = None
        lib.stpu_noise_fill_p.argtypes = [c_u32p, ctypes.c_int64, c_i32p,
                                          c_i32p, c_i64p, c_i32p,
                                          ctypes.c_int64, c_i32p, c_i64p,
                                          c_u8p, ctypes.c_int64, c_u8p,
                                          ctypes.c_int64, c_i64p, c_i32p,
                                          c_u8p, ctypes.c_int]
        lib.stpu_reconstruct.restype = None
        lib.stpu_reconstruct.argtypes = [c_u8p, ctypes.c_int64, c_i64p,
                                         c_i32p, c_u8p, c_i32p, c_i64p,
                                         c_i32p, c_u8p, ctypes.c_int64,
                                         ctypes.c_int64, c_u8p, ctypes.c_int]
        _lib = lib
        return _lib


def _as_u8p(buf) -> ctypes.POINTER(ctypes.c_uint8):
    return ctypes.cast(ctypes.c_char_p(bytes(buf)) if isinstance(buf, memoryview)
                       else buf, ctypes.POINTER(ctypes.c_uint8))
