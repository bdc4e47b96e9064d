"""Build the CUDA kernels at first use and bind them with ctypes.

`nvcc` compiles every csrc/*.cu (with the csrc/*.cuh headers) into one
shared library with a plain C interface, in build/vpt_torch/ beside the
package. The library is named by a hash of the sources and flags, so it is
rebuilt only when they change. A missing nvcc or a failed build raises with
the compiler's output: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vpt_torch"

# no --use_fast_math, no FMA contraction: the kernel keeps vpt's f32
# rounding (csrc/path.cuh)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvpt_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's report (ptxas registers and spills) goes to a .log file
    beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)        # atomic: concurrent builds agree
    return out


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface."""
    lib = ctypes.CDLL(str(build()))
    lib.vpt_wavefront_fwd.argtypes = [ctypes.c_void_p] * 4
    lib.vpt_wavefront_fwd.restype = ctypes.c_int
    lib.vpt_params_words.argtypes = []
    lib.vpt_params_words.restype = ctypes.c_int
    lib.vpt_error_string.argtypes = [ctypes.c_int]
    lib.vpt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return load().vpt_error_string(err).decode()
