"""Build the port's native code and load it with ctypes: the CUDA kernels
with nvcc, the host library with the host C++ compiler.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/lib<name>.so` inside the package (git-ignored), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [per-kernel flags] -o build/lib<name>.so csrc/<name>.cu

The host libraries (HOST_LIBS: the JPEG decoder's body and the PNG row
filters; the JPEG encoder's body; the augmentation's warps and HSV
conversions; csrc/*.cpp) compile the same way with `c++` (or `g++`) from PATH:

    c++ -O3 -std=c++17 -shared -fPIC [per-library flags] -o build/lib<name>.so csrc/<source>.cpp ...

A missing compiler raises RuntimeError; nothing falls back to another reader.
A library newer than its sources is reused. Nothing here runs at import: the
compilers, the build and ctypes are reached only when a kernel is first
launched or an image first decoded or encoded (or `build_all` is called), so
the package imports on a machine without them. ctypes releases the GIL during
a call, so the host libraries decode and encode in several threads at once. Every CUDA entry point
returns cudaGetLastError() after its launches; `check` raises if that is not 0.
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

# host libraries: name -> (sources in csrc/, {C function: argument kinds}, extra compiler flags);
# "l" is a 64-bit int
HOST_LIBS: Dict[str, Tuple[List[str], Dict[str, str], List[str]]] = {
    "image_decode": (["jpeg_decode.cpp", "png_unfilter.cpp"],
                     {"jpeg_scan": "pllppiiiipp", "jpeg_render": "pppiiiip", "png_unfilter_row": "ipppli"}, []),
    "image_encode": (["jpeg_encode.cpp"], {"jpeg_encode": "piiippplp"}, []),
    # no contraction: every multiply-add that OpenCV fuses is an explicit fmaf in the source
    "image_warp": (["warp.cpp"], {"warp_affine_u8": "piipiipi", "warp_perspective_u8": "piipiipi",
                                  "bgr_to_hsv_u8": "ppl", "hsv_to_bgr_u8": "ppii", "augment_hsv_u8": "piip"},
                   ["-ffp-contract=off", "-fno-math-errno"]),
}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
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


def host_compiler() -> str:
    for cxx in ("c++", "g++"):
        found = shutil.which(cxx)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the port's image decoder, encoder and "
                       "augmentation (csrc/jpeg_decode.cpp, csrc/png_unfilter.cpp, csrc/jpeg_encode.cpp, "
                       "csrc/warp.cpp) are built with one at first use")


def _sources(name: str) -> List[Path]:
    return [CSRC / s for s in HOST_LIBS[name][0]] if name in HOST_LIBS else [CSRC / f"{name}.cu"]


def _command(name: str, out: Path) -> List[str]:
    if name in HOST_LIBS:
        return [host_compiler(), "-O3", "-std=c++17", "-shared", "-fPIC", *HOST_LIBS[name][2], "-o", str(out),
                *map(str, _sources(name))]
    flags, _ = KERNELS[name]
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", str(out), *map(str, _sources(name)),
    ]


def _fresh(name: str) -> bool:
    lib = BUILD / f"lib{name}.so"
    return lib.exists() and lib.stat().st_mtime >= max(s.stat().st_mtime for s in _sources(name))


def build_all(names=None, force: bool = False) -> Dict[str, float]:
    """Build the stale libraries (every CUDA kernel and host library with
    force=True) in parallel, one compiler per library, all started together.
    Returns the build seconds of each library built."""
    names = list(names or [*KERNELS, *HOST_LIBS])
    BUILD.mkdir(parents=True, exist_ok=True)
    tmps = {name: BUILD / f"lib{name}.{os.getpid()}.tmp.so" for name in names if force or not _fresh(name)}
    cmd_of = {name: _command(name, tmp) for name, tmp in tmps.items()}  # a missing compiler raises before any build
    t0 = time.perf_counter()
    procs = {name: (subprocess.Popen(cmd_of[name], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
             for name, tmp in tmps.items()}
    secs = {}
    errors = []
    for name, (p, tmp) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if p.returncode != 0:
            errors.append(f"{Path(cmd_of[name][0]).name} failed for {name} (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, BUILD / f"lib{name}.so")  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str):
    """The ctypes library of kernel or host library `name`, built if needed, with argtypes set."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        import ctypes

        build_all([name])
        lib = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64, "f": ctypes.c_float}
        for fn, sig in (HOST_LIBS if name in HOST_LIBS else KERNELS)[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = [kinds[c] for c in sig]
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def count(wrapper) -> None:
    """One more launch on a kernel wrapper's `launches`, under a lock: the
    kernels launch from several threads (a server's dispatcher, its clients),
    and `+=` on an attribute is a read, an add and a write."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
