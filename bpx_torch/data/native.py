"""ctypes bindings for the native WordPiece tokenizer (counterpart:
``bpx/data/native.py``).

Builds ``csrc/wordpiece.cpp`` at the root of the checkout, unedited, with
``g++`` on first use into ``build/bpx_torch/`` there (named by the source's
hash).  Host code: where the library does not build, or for non-ASCII text
(the C path covers ASCII only), :meth:`NativeWordPieceTokenizer.encode`
uses the Python tokenizer, which gives the same ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "csrc" / "wordpiece.cpp"
BUILD_DIR = _ROOT / "build" / "bpx_torch"


def _build_lib() -> Optional[Path]:
    """Compile the library (cached by source hash); None on failure."""
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"libwordpiece-{digest}.so"
        if not lib_path.exists():
            # a private name, then a rename: concurrent builds never
            # load a half-written library
            tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True)
            tmp.replace(lib_path)
        return lib_path
    except (OSError, subprocess.CalledProcessError):
        return None


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        path = _build_lib()
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(str(path))
        lib.wp_load_vocab.restype = ctypes.c_void_p
        lib.wp_load_vocab.argtypes = [ctypes.c_char_p]
        lib.wp_free_vocab.argtypes = [ctypes.c_void_p]
        lib.wp_vocab_size.restype = ctypes.c_int32
        lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wp_encode.restype = ctypes.c_int32
        lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib if _lib is not False else None


class NativeWordPieceTokenizer:
    """Fast path for :class:`bpx_torch.data.tokenization.WordPieceTokenizer`.

    ``encode`` uses the C library for ASCII text and the given Python
    tokenizer otherwise (or when the library did not build).
    """

    def __init__(self, vocab_path: str, fallback):
        self.fallback = fallback
        self._handle = None
        lib = _get_lib()
        if lib is not None:
            handle = lib.wp_load_vocab(vocab_path.encode())
            if handle:
                self._handle = ctypes.c_void_p(handle)
                self._lib = lib

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def encode(self, text: str, max_len: int) -> List[int]:
        if self._handle is not None:
            try:
                raw = text.encode("ascii")
            except UnicodeEncodeError:
                return self.fallback.encode(text, max_len)
            out = (ctypes.c_int32 * max_len)()
            n = self._lib.wp_encode(self._handle, raw, max_len, out)
            if n >= 0:
                return list(out[:n])
        return self.fallback.encode(text, max_len)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.wp_free_vocab(self._handle)
