"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by its own `nvcc -c` for `sm_90a`, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with `ctypes`.  The build runs at first use into
`dcfa_yolo_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of the
sources, the headers they include and the flags, so an edited source or
header never loads a stale library.  Nothing here runs at import time: the
package imports on machines without `nvcc`.
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

import torch

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
HEADERS = ("stem_core.cuh",)  # included by stem_eval.cu, stem_train.cu, stem_probe.cu

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
    for name in HEADERS:
        h.update(name.encode())
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
    lib.stem_eval_bf16.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.stem_eval_bf16.restype = i
    lib.stem_eval_info.argtypes = [p]
    lib.stem_eval_info.restype = i
    lib.nms_suppress.argtypes = [p, p, p, i, p, i, i, f, p]
    lib.nms_suppress.restype = i
    lib.nms_scan_smem.argtypes = [i]
    lib.nms_scan_smem.restype = i
    lib.stem_train_info.argtypes = [i, p]
    lib.stem_train_info.restype = i
    for fn in (lib.stem_train_bf16, lib.stem_train_f32):
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.stem_probe_bf16.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.stem_probe_bf16.restype = i
    lib.stem_probe_info.argtypes = [i, p]
    lib.stem_probe_info.restype = i
    lib.dcfa_error_string.argtypes = [i]
    lib.dcfa_error_string.restype = ctypes.c_char_p


def load_library(build: bool = True) -> ctypes.CDLL:
    """The kernel library, built on first call (raises where it cannot be
    built; there is no fallback).  `build=False` only loads a library built
    before (the ranks of a data-parallel run that their parent built for),
    and raises where there is none."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        t0 = time.perf_counter()
        out = BUILD_DIR / f"libdcfa_kernels.{_digest()}.so"
        if not out.exists():
            if not build:
                raise RuntimeError(f"no kernel library at {out}: build it first "
                                   "(ops/_build.py::load_library)")
            _build(out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
    return _LIB


# the kernels on csrc/stem_core.cuh's persistent walk, whose grids are sized
# from the card's resident CTAs
STEM_KERNELS = ("stem_eval", "stem_train_bf16", "stem_train_f32", "stem_probe_conv",
                "stem_probe_pool", "stem_probe_dblbuf", "stem_probe_pipe")
# the stem split probe's entry codes (csrc/stem_probe.cu's stem_probe_bf16
# and stem_probe_info)
PROBE_CODES = {"conv": 1, "pool": 2, "dblbuf": 3, "pipe": 4}
_INFO_KEYS = ("registers", "stack_bytes", "static_smem", "dynamic_smem",
              "resident_ctas")
_INFO: dict = {}


def stem_kernel_info(name: str, device: torch.device) -> dict:
    """What the card says of a stem kernel (`STEM_KERNELS`): registers and
    stack bytes a thread, static and dynamic shared memory a CTA, and the
    CTAs resident on `device` at once (SMs × CTAs per SM), which sizes the
    persistent grid.  Cached per device; raises where the query fails."""
    key = (name, device.index)
    if key not in _INFO:
        lib = load_library()
        buf = (ctypes.c_int * len(_INFO_KEYS))()
        with torch.cuda.device(device):
            if name == "stem_eval":
                rc = lib.stem_eval_info(buf)
            elif name.startswith("stem_probe_"):
                rc = lib.stem_probe_info(PROBE_CODES[name[len("stem_probe_"):]], buf)
            else:
                rc = lib.stem_train_info(int(name == "stem_train_f32"), buf)
        check(rc, f"{name} info")
        _INFO[key] = dict(zip(_INFO_KEYS, buf))
    return _INFO[key]


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc:
        msg = _LIB.dcfa_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
