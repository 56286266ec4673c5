"""Build and load the port's CUDA kernels.

At first use, every ``bpx_torch/csrc/*.cu`` is compiled for ``sm_90a`` by its
own ``nvcc`` process (all started together), and the objects are linked into
one shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``build/bpx_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so an unchanged tree builds once.  A failed
build raises; nothing here falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bpx_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: a source's own extra flags: the generic flash kernels' instantiations
#: are optimised and assembled in parallel threads (alone they took twice
#: as long as any other source), and the chunked ones' 14 likewise
SOURCE_FLAGS = {"flash_generic.cu": ["-split-compile=0"],
                "flash_chunked.cu": ["-split-compile=0"]}

_lib: Optional[ctypes.CDLL] = None
#: ptxas' register / shared-memory / spill report of the library last
#: built or found built (kept beside it)
build_log: str = ""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from source at first use")
    return found


def sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(flags: Sequence[str] = ()) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS + list(flags)).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(flags: Sequence[str] = ()) -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  ``flags``, extra nvcc flags (a ``-D`` macro), build a variant
    library of its own.  Raises RuntimeError with nvcc's output if any
    step fails."""
    global build_log
    digest = _digest(flags)
    out = BUILD_DIR / f"libbpx_kernels_{digest}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{digest}_{os.getpid()}.o"
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, *SOURCE_FLAGS.get(src.name, ()),
               *flags, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log.write_text(build_log)
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    u = ctypes.c_uint
    # on, seeds (one per group), groups, threshold, inv_keep, tk_p, and
    # the placement b_off, h_off, H_g, group stride
    dropout = [i, ctypes.POINTER(u), i, u, f, i, i, i, i, i]
    lib.bpx_flash_fwd.argtypes = ([p] * 6 + [i] * 5 + [ll] * 12 + [i, i]
                                  + dropout + [p])
    lib.bpx_flash_fwd.restype = i
    lib.bpx_flash_bwd.argtypes = ([p] * 11 + [i] * 5 + [ll] * 24 + [i, i]
                                  + dropout + [p])
    lib.bpx_flash_bwd.restype = i
    lib.bpx_flash_delta.argtypes = [p] * 3 + [i] * 4 + [ll] * 6 + [p]
    lib.bpx_flash_delta.restype = i
    # the panel builds (flash_panel_fwd.cu, flash_panel_bwd.cu): as the
    # tabled entries, at any head dim from 1 to 256 (declared where present:
    # a tree from before them, built beside this one for an A/B, has none)
    for name in ("fwd", "bwd", "delta"):
        if hasattr(lib, f"bpx_flash_panel_{name}"):
            entry = getattr(lib, f"bpx_flash_panel_{name}")
            entry.argtypes = getattr(lib, f"bpx_flash_{name}").argtypes
            entry.restype = i
    # the generic kernels (flash_generic.cu): as above, with the dtype's
    # code (0 bf16, 1 fp32) after the head dim
    lib.bpx_flash_generic_fwd.argtypes = ([p] * 6 + [i] * 6 + [ll] * 12
                                          + [i, i] + dropout + [p])
    lib.bpx_flash_generic_fwd.restype = i
    lib.bpx_flash_generic_bwd.argtypes = ([p] * 11 + [i] * 6 + [ll] * 24
                                          + [i, i] + dropout + [p])
    lib.bpx_flash_generic_bwd.restype = i
    lib.bpx_flash_generic_delta.argtypes = [p] * 3 + [i] * 5 + [ll] * 6 + [p]
    lib.bpx_flash_generic_delta.restype = i
    # the chunked kernels (flash_chunked.cu): as the generic ones
    lib.bpx_flash_chunked_fwd.argtypes = lib.bpx_flash_generic_fwd.argtypes
    lib.bpx_flash_chunked_fwd.restype = i
    lib.bpx_flash_chunked_bwd.argtypes = lib.bpx_flash_generic_bwd.argtypes
    lib.bpx_flash_chunked_bwd.restype = i
    lib.bpx_flash_chunked_delta.argtypes = lib.bpx_flash_generic_delta.argtypes
    lib.bpx_flash_chunked_delta.restype = i
    out = ctypes.POINTER(i)
    lib.bpx_flash_fwd_blocks_per_sm.argtypes = [i, out]
    lib.bpx_flash_fwd_blocks_per_sm.restype = i
    lib.bpx_flash_bwd_blocks_per_sm.argtypes = [i, i, out]
    lib.bpx_flash_bwd_blocks_per_sm.restype = i
    for name, args in (("fwd", [i, out]), ("bwd", [i, i, out])):
        if hasattr(lib, f"bpx_flash_panel_{name}_blocks_per_sm"):
            entry = getattr(lib, f"bpx_flash_panel_{name}_blocks_per_sm")
            entry.argtypes = args
            entry.restype = i
    lib.bpx_flash_generic_blocks_per_sm.argtypes = [i, i, i, out]
    lib.bpx_flash_generic_blocks_per_sm.restype = i
    lib.bpx_flash_chunked_blocks_per_sm.argtypes = [i, i, i, out]
    lib.bpx_flash_chunked_blocks_per_sm.restype = i
    lib.bpx_layer_norm_fwd.argtypes = [p] * 6 + [i, i, f, i, i, i, p]
    lib.bpx_layer_norm_fwd.restype = i
    lib.bpx_layer_norm_bwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.bpx_layer_norm_bwd.restype = i
    lib.bpx_layer_norm_bwd_workspace.argtypes = [i] * 5
    lib.bpx_layer_norm_bwd_workspace.restype = ll
    lib.bpx_error_string.argtypes = [i]
    lib.bpx_error_string.restype = ctypes.c_char_p


def load(flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The library built with the extra nvcc ``flags``, loaded (built
    first if need be)."""
    lib = ctypes.CDLL(str(build(flags)))
    _declare(lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = load()
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().bpx_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
