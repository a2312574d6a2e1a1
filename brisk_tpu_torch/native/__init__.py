"""Native (C++) FASTA parser, loaded via ctypes.

`fasta_codec.cpp` (a copy of the JAX package's) is built with g++ into
`brisk_tpu_torch/_build/` at first use, named by the source's content
hash. If the build fails (no compiler or no zlib), `parse_fasta_codes`
returns None and callers fall back to the Python parser
(`oracle.pyref.read_fasta_chunks`) — host code only, slower.
"""

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fasta_codec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if the build fails."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libbrisk_native_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++"] + _FLAGS + [_SRC, "-lz", "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.brisk_fasta_parse.restype = ctypes.c_void_p
        lib.brisk_fasta_parse.argtypes = [ctypes.c_char_p]
        lib.brisk_fasta_n_chunks.restype = ctypes.c_uint64
        lib.brisk_fasta_n_chunks.argtypes = [ctypes.c_void_p]
        lib.brisk_fasta_n_codes.restype = ctypes.c_uint64
        lib.brisk_fasta_n_codes.argtypes = [ctypes.c_void_p]
        lib.brisk_fasta_codes.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.brisk_fasta_codes.argtypes = [ctypes.c_void_p]
        lib.brisk_fasta_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
        lib.brisk_fasta_offsets.argtypes = [ctypes.c_void_p]
        lib.brisk_fasta_free.restype = None
        lib.brisk_fasta_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
    return _lib


def parse_fasta_codes(path: str):
    """Parse a FASTA file natively: a list of numpy uint8 code arrays
    (one per cleaned chunk), or None if the native lib is unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    h = lib.brisk_fasta_parse(path.encode())
    if not h:
        raise IOError(f"native FASTA parse failed: {path}")
    try:
        n_codes = lib.brisk_fasta_n_codes(h)
        n_chunks = lib.brisk_fasta_n_chunks(h)
        codes = np.ctypeslib.as_array(lib.brisk_fasta_codes(h),
                                      shape=(n_codes,)).copy()
        offsets = np.ctypeslib.as_array(lib.brisk_fasta_offsets(h),
                                        shape=(n_chunks + 1,)).copy()
    finally:
        lib.brisk_fasta_free(h)
    return [codes[offsets[i]:offsets[i + 1]] for i in range(n_chunks)]
