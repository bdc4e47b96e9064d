"""The CUDA kernels' per-path code, built for the host, against the plain
versions.

csrc/path.cuh, csrc/diff_path.cuh and csrc/geom_path.cuh are
__host__ __device__. Here g++
compiles them through the test-only shim csrc/path_host.cpp (a loop over
pixels in place of the CUDA grid), with FMA contraction off as nvcc builds
the kernels (--fmad=false). Images are held against the plain versions at
the same seed with the criterion of the other parity tests:
quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4 (libm's and torch's
transcendentals differ by an ulp on some inputs). K3's per-pixel gradient
vectors are held against diff_bwd_plain's per-lane rows by the same
criterion, per entry column: quantile over lanes of the largest
|a-b| / max(1, |column|max) below 1e-4. K4's planes (geom_pixel<K>) are
held against geom_fwd_plain's: the image planes by the image criterion,
each tangent plane by q99 of |a-b| below 1e-4 of the plane's scale. This
catches a fault in the kernels' path code where there is no card; the card
itself is checked by chip_smoke.py and tests/test_torch_cuda.py.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import vpt_torch
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "vpt_torch", "csrc")
FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]


@pytest.fixture(scope="module")
def host_lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the host build of csrc/path.cuh needs it")
    srcs = [os.path.join(CSRC, f)
            for f in ("path_host.cpp", "path.cuh", "diff_path.cuh",
                      "geom_path.cuh")]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(REPO, "build", "vpt_torch_host")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libpath_host_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        res = subprocess.run([cxx, *FLAGS, "-o", tmp, srcs[0]],
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        os.replace(tmp, lib)
    so = ctypes.CDLL(lib)
    so.vpt_params_words.argtypes = []
    so.vpt_params_words.restype = ctypes.c_int
    so.vpt_render_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    so.vpt_render_host.restype = None
    so.vpt_diff_params_words.argtypes = []
    so.vpt_diff_params_words.restype = ctypes.c_int
    so.vpt_diff_fwd_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    so.vpt_diff_fwd_host.restype = None
    so.vpt_diff_bwd_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    so.vpt_diff_bwd_host.restype = None
    so.vpt_geom_params_words.argtypes = []
    so.vpt_geom_params_words.restype = ctypes.c_int
    so.vpt_geom_fwd_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    so.vpt_geom_fwd_host.restype = ctypes.c_int
    return so


W, H, SPP, MB, SEED = 32, 16, 4, 8, 3
CASES = [("cornell_vpt", "random", True), ("cornell_vpt", "random", False),
         ("cornell_vpt", "ld", True), ("cornell_vpt", "ld", False),
         ("one_primitive_infinite", "random", True),
         ("simple_cornell", "ld", True), ("cornell_glass", "random", True)]


def _scene(name):
    if name == "cornell_glass":     # no built-in scene has a dielectric
        d = scene_to_dict(vpt_torch.cornell_vpt())
        d["spheres"][6]["material"] = 2
        return scene_from_dict(d)[0]
    return vpt_torch.SCENES[name]()


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_host_build_matches_plain(host_lib, case):
    name, sampler, jitter = case
    pk = wf.pack_scene(_scene(name), vpt_torch.default_camera(),
                       W, H, SPP, max_bounces=MB, sampler=sampler,
                       jitter=jitter)
    words = np.ascontiguousarray(pk.words())
    assert words.size == host_lib.vpt_params_words()   # struct layout
    out = np.full((W * H, 3), np.nan, np.float32)
    host_lib.vpt_render_host(words.ctypes.data, SEED, out.ctypes.data)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    ref = ref.numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / max(1.0, float(np.abs(ref).max()))
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)


# the pair on the main-path scene (both samplers, jitter on and off), the
# glass variant and an open scene
DIFF_CASES = [("cornell_vpt", "random", True), ("cornell_vpt", "ld", True),
              ("cornell_vpt", "ld", False), ("cornell_glass", "random", True),
              ("one_primitive_infinite", "ld", True)]


@pytest.mark.parametrize("case", DIFF_CASES,
                         ids=["-".join(map(str, c)) for c in DIFF_CASES])
def test_host_build_of_diff_pair_matches_plain(host_lib, case):
    name, sampler, jitter = case
    scene = _scene(name)
    dp = df.pack_diff(scene, vpt_torch.default_camera(), W, H, SPP,
                      max_bounces=MB, sampler=sampler, jitter=jitter)
    words = np.ascontiguousarray(dp.words())
    assert words.size == host_lib.vpt_diff_params_words()   # struct layout
    pvec = df._flatten(df.pack_params(scene), scene.count).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = np.full((W * H, 3), np.nan, np.float32)
    host_lib.vpt_diff_fwd_host(words.ctypes.data, pvec.data_ptr(), SEED,
                               out.ctypes.data)
    ref = df.diff_fwd_plain(dp, pvec, seed).numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / max(1.0, float(np.abs(ref).max()))
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)

    gbar = np.random.default_rng(0).standard_normal((W * H, 3)).astype(
        np.float32)
    G = np.full((W * H, dp.P), np.nan, np.float32)
    host_lib.vpt_diff_bwd_host(words.ctypes.data, pvec.data_ptr(), SEED,
                               gbar.ctypes.data, G.ctypes.data)
    Gp = df.diff_bwd_plain(dp, pvec, seed, torch.from_numpy(gbar),
                           per_lane=True).numpy()
    assert np.isfinite(G).all()
    rel = (np.abs(G - Gp) / np.maximum(1.0, np.abs(Gp).max(0))).max(1)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    assert np.array_equal(G == 0.0, Gp == 0.0)


# K4 at every tangent count the host build is tested for, both samplers:
# (K, sphere, cam_grads, dir_grads, primal_only)
GEOM_CASES = [(0, 8, False, False, True), (3, 8, False, False, False),
              (4, None, True, False, False), (7, 8, True, False, False),
              (10, 9, True, True, False)]


@pytest.mark.parametrize("sampler", ["random", "ld"])
@pytest.mark.parametrize("case", GEOM_CASES, ids=[f"K{c[0]}" for c in
                                                  GEOM_CASES])
def test_host_build_of_geom_matches_plain(host_lib, case, sampler):
    K, sphere, cam, dirg, primal = case
    gp = gm.pack_geom(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                      12, 8, 2, sphere=sphere, cam_grads=cam,
                      dir_grads=dirg, primal_only=primal, max_bounces=5,
                      sampler=sampler)
    assert gp.K == K
    words = np.ascontiguousarray(gp.words())
    assert words.size == host_lib.vpt_geom_params_words()   # struct layout
    theta = gm.flatten_theta(gm.pack_theta(
        vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
        sphere)).contiguous()
    out = np.full((gp.planes, gp.npix), np.nan, np.float32)
    assert host_lib.vpt_geom_fwd_host(words.ctypes.data, theta.data_ptr(),
                                      SEED, out.ctypes.data) == 0
    ref = gm.geom_fwd_plain(gp, theta,
                            torch.tensor([SEED], dtype=torch.int32)).numpy()
    assert np.isfinite(out).all()
    for j in range(gp.planes):
        if j % (1 + K) == 0:        # an image plane
            scale = max(1.0, float(np.abs(ref[j]).max()))
        else:       # a tangent plane; some are exactly 0 (a red light)
            scale = float(np.abs(ref[j]).max())
            if scale == 0.0:
                assert np.all(out[j] == 0.0), j
                continue
        q = float(np.quantile(np.abs(out[j] - ref[j]), 0.99)) / scale
        assert q < 1e-4, (j, q)
