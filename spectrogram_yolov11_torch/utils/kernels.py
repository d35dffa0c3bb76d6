"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/lib<name>.so` inside the package (git-ignored), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [per-kernel flags] -o build/lib<name>.so csrc/<name>.cu

A library newer than its source is reused. Nothing here runs at import: nvcc,
the build and ctypes are reached only when a kernel is first launched (or
`build_all` is called), so the package imports on a machine without them.
Every C entry point returns cudaGetLastError() after its launches; `check`
raises if that is not 0.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

# name -> (extra nvcc flags, {C function: argument kinds}); "p" pointer or
# stream, "i" int, "f" float
KERNELS: Dict[str, Tuple[List[str], Dict[str, str]]] = {
    # no fused multiply-add: the IoU must round exactly as the plain version's
    "greedy_nms": (["-fmad=false"], {"greedy_nms_keep": "ppppiifp"}),
    "fused_bottleneck": ([], {"fused_bottleneck_f32": "ppppppiiiip", "fused_bottleneck_bf16": "ppppppiiiip"}),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, object] = {}
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc/ptxas output of the build made in this process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _command(name: str, out: Path) -> List[str]:
    flags, _ = KERNELS[name]
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def _fresh(name: str) -> bool:
    lib = BUILD / f"lib{name}.so"
    return lib.exists() and lib.stat().st_mtime >= (CSRC / f"{name}.cu").stat().st_mtime


def build_all(names=None, force: bool = False) -> Dict[str, float]:
    """Build the stale kernels (every kernel with force=True) in parallel, one
    nvcc per source, all started together. Returns the build seconds of each
    kernel built."""
    names = list(names or KERNELS)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if force or not _fresh(name):
            tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
            procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
    secs = {}
    errors = []
    for name, (p, tmp) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, BUILD / f"lib{name}.so")  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str):
    """The ctypes library of kernel `name`, built if needed, with argtypes set."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        import ctypes

        build_all([name])
        lib = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        for fn, sig in KERNELS[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = [kinds[c] for c in sig]
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
