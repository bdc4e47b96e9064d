"""Build the CUDA kernels at first use and bind them with ctypes.

One `nvcc -c` per csrc/*.cu (with the csrc/*.cuh headers), all started
together, then one link into a shared library with a plain C interface, in
build/vpt_torch/ beside the package. The library is named by a hash of the
sources and flags, so it is rebuilt only when they change. A missing nvcc
or a failed build raises with the compiler's output: there is no fallback
to the plain versions.
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
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    try:
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            _check(proc.returncode, cmd, stdout, stderr)
            log.append(stdout + stderr)
        tmp = out.with_name(f"{tag}.tmp.so")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _check(res.returncode, cmd, res.stdout, res.stderr)
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)        # atomic: concurrent builds agree
    return out


def _check(code: int, cmd: list, stdout: str, stderr: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed with exit code {code}:\n"
                           f"{' '.join(cmd)}\n{stdout}\n{stderr}")


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # K1, one entry per instantiation (csrc/wavefront*.cu), homogeneous, in
    # an analytic density field and in a voxel grid
    from .wavefront import FIELD_ENTRIES, GRID_ENTRIES, KERNEL_ENTRIES

    for entry in (*KERNEL_ENTRIES.values(), *FIELD_ENTRIES.values()):
        fn = getattr(lib, entry)
        fn.argtypes = [vp, vp, vp, ci, ci, vp, vp]
        fn.restype = ci
    for entry in GRID_ENTRIES.values():     # and the grid's table
        fn = getattr(lib, entry)
        fn.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
        fn.restype = ci
    lib.vpt_params_words.argtypes = []
    lib.vpt_params_words.restype = ctypes.c_int
    # the differentiable pair (csrc/diff.cu; in a density field
    # csrc/diff_field_fwd.cu and diff_field_bwd.cu; with an HG phase
    # csrc/diff_hg.cu, diff_field_hg_fwd.cu and diff_field_hg_bwd.cu)
    for sfx in ("", "_field", "_hg", "_field_hg"):
        fwd = getattr(lib, "vpt_diff_fwd" + sfx)
        fwd.argtypes = [vp] * 5
        fwd.restype = ci
        bwd = getattr(lib, "vpt_diff_bwd" + sfx)
        bwd.argtypes = [vp] * 7
        bwd.restype = ci
    # ... and in a voxel grid (csrc/diff_grid_fwd.cu, diff_grid_bwd.cu),
    # with the grid's table and the voxel gradient
    lib.vpt_diff_fwd_grid.argtypes = [vp] * 6
    lib.vpt_diff_fwd_grid.restype = ci
    lib.vpt_diff_bwd_grid.argtypes = [vp] * 9
    lib.vpt_diff_bwd_grid.restype = ci
    lib.vpt_diff_grid_shared_bytes.argtypes = [ci]
    lib.vpt_diff_grid_shared_bytes.restype = ci
    # ... and with the extended estimators (equi-angular, the implicit and
    # physical estimators, shells, HG in a grid: csrc/diff_ext*.cu,
    # diff_field_ext*.cu, diff_grid_ext*.cu), with the signatures above
    for sfx, n_fwd, n_bwd in (("_ext", 5, 7), ("_field_ext", 5, 7),
                              ("_grid_ext", 6, 9)):
        fwd = getattr(lib, "vpt_diff_fwd" + sfx)
        fwd.argtypes = [vp] * n_fwd
        fwd.restype = ci
        bwd = getattr(lib, "vpt_diff_bwd" + sfx)
        bwd.argtypes = [vp] * n_bwd
        bwd.restype = ci
    lib.vpt_diff_grid_ext_shared_bytes.argtypes = [ci]
    lib.vpt_diff_grid_ext_shared_bytes.restype = ci
    lib.vpt_diff_params_words.argtypes = []
    lib.vpt_diff_params_words.restype = ctypes.c_int
    lib.vpt_diff_block_threads.argtypes = []
    lib.vpt_diff_block_threads.restype = ctypes.c_int
    # the dual kernel (csrc/geom.cu): the default estimator and the
    # extended ones (csrc/geom_k<K>.cu, geom_ext_k<K>.cu)
    for entry in ("vpt_geom_fwd", "vpt_geom_fwd_ext"):
        fn = getattr(lib, entry)
        fn.argtypes = [vp, vp, vp, ci, ci, vp, vp]
        fn.restype = ci
    lib.vpt_geom_params_words.argtypes = []
    lib.vpt_geom_params_words.restype = ctypes.c_int
    lib.vpt_error_string.argtypes = [ctypes.c_int]
    lib.vpt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return load().vpt_error_string(err).decode()
