"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by its own `nvcc -c` for `sm_90a`, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with `ctypes`.  The build runs at first use into
`dcfa_yolo_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of the
sources and flags so an edited source never loads a stale library.  Nothing
here runs at import time: the package imports on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# per-source flags: the NMS IoU must round like the JAX package's f32 ops,
# so no FMA contraction there (an IoU at the threshold must not flip)
SOURCES = {
    "stem_eval.cu": [],
    "nms_suppress.cu": ["-fmad=false"],
    "stem_train.cu": [],
    "stem_probe.cu": [],
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update(" ".join(_ARCH + _COMMON + flags).encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, flags in SOURCES.items():
        obj = BUILD_DIR / (Path(name).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *_ARCH, *_COMMON, *flags, "-Xptxas", "-v", "-c",
               str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, obj, p in procs:
        log, _ = p.communicate()
        (BUILD_DIR / (Path(name).stem + ".log")).write_text(log)
        if p.returncode:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stem_eval_bf16.argtypes = [p, p, p, p, i, i, i, p]
    lib.stem_eval_bf16.restype = i
    lib.nms_suppress.argtypes = [p, p, p, i, i, f, p]
    lib.nms_suppress.restype = i
    lib.stem_train_num_ctas.argtypes = [i, i, i]
    lib.stem_train_num_ctas.restype = i
    for fn in (lib.stem_train_bf16, lib.stem_train_f32):
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
        fn.restype = i
    lib.stem_probe_bf16.argtypes = [i, p, p, p, p, i, i, i, p]
    lib.stem_probe_bf16.restype = i
    lib.dcfa_error_string.argtypes = [i]
    lib.dcfa_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call (raises where it cannot be
    built; there is no fallback)."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        t0 = time.perf_counter()
        out = BUILD_DIR / f"libdcfa_kernels.{_digest()}.so"
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc:
        msg = _LIB.dcfa_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
