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
import dataclasses
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

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "vpt_torch", "csrc")
FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]


@pytest.fixture(scope="module")
def host_lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the host build of csrc/path.cuh needs it")
    srcs = [os.path.join(CSRC, f)
            for f in ("path_host.cpp", "path.cuh", "field.cuh",
                      "diff_path.cuh", "geom_path.cuh")]
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
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    so.vpt_render_host.restype = ctypes.c_int
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


def _scene(name, g=0.0):
    if name == "cornell_glass":     # no built-in scene has a dielectric
        d = scene_to_dict(vpt_torch.cornell_vpt())
        d["spheres"][6]["material"] = 2
        return scene_from_dict(d)[0]
    if g != 0.0:
        return vpt_torch.make_scene(
            list(vpt_torch.scene.scene.CORNELL_VPT_SPHERES), g=g)
    return vpt_torch.SCENES[name]()


# K1's instantiations in the host build (csrc/path_host.cpp); their field
# instantiations follow at +4
HOST_VARIANT = {(True, "free"): 0, (False, "free"): 1,
                (True, "equiangular"): 2, (False, "ea_clamped"): 3}
FIELD_VARIANT = 4


def _host_render(host_lib, pk, bases=None, n_lanes=None, sums=0):
    words = np.ascontiguousarray(pk.words())
    assert words.size == host_lib.vpt_params_words()   # struct layout
    n_lanes = pk.npix if n_lanes is None else n_lanes
    out = np.full((n_lanes, 3), np.nan, np.float32)
    b = None if bases is None else np.ascontiguousarray(bases, np.int32)
    variant = HOST_VARIANT[(pk.nee, pk.distance)] + (
        0 if pk.field is None else FIELD_VARIANT)
    assert host_lib.vpt_render_host(
        words.ctypes.data, variant, SEED,
        None if b is None else b.ctypes.data, n_lanes, sums,
        out.ctypes.data) == 0
    return out


def _assert_q99(out, ref, nonneg=True):
    # medium_shell's shell is shaded from inside, where pLight's unclamped
    # cosine is negative: vpt's image has negative pixels there too
    assert np.isfinite(out).all() and (not nonneg or (out >= 0).all())
    rel = np.abs(out - ref) / max(1.0, float(np.abs(ref).max()))
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_host_build_matches_plain(host_lib, case):
    name, sampler, jitter = case
    pk = wf.pack_scene(_scene(name), vpt_torch.default_camera(),
                       W, H, SPP, max_bounces=MB, sampler=sampler,
                       jitter=jitter)
    out = _host_render(host_lib, pk)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    _assert_q99(out, ref.numpy())


# the other instantiations and launch-parameter modes: (integrator, scene,
# g, sampler)
VARIANT_CASES = [("implicit_free", "cornell_vpt", 0.0, "random"),
                 ("explicit_equiangular", "cornell_vpt", 0.0, "random"),
                 ("explicit_equiangular", "cornell_vpt", 0.5, "ld"),
                 ("implicit_equiangular", "cornell_vpt", 0.0, "ld"),
                 ("implicit_free_physical", "cornell_vpt", -0.3, "random"),
                 ("explicit_free", "medium_shell", 0.0, "ld"),
                 ("explicit_free_physical", "medium_shell", 0.0, "random")]


@pytest.mark.parametrize("case", VARIANT_CASES,
                         ids=["-".join(map(str, c)) for c in VARIANT_CASES])
def test_host_build_of_variant_matches_plain(host_lib, case):
    integrator, name, g, sampler = case
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(_scene(name, g), vpt_torch.default_camera(),
                       W, H, SPP, max_bounces=MB, sampler=sampler, nee=nee,
                       distance=distance, physical=physical)
    out = _host_render(host_lib, pk)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    _assert_q99(out, ref.numpy(), nonneg=name != "medium_shell")


# every field instantiation on both fields: (scene, integrator, sampler)
FIELD_CASES = [(name, integrator, sampler)
               for name in ("foggy_cornell", "blob_cloud")
               for integrator, sampler in (
                   ("explicit_free", "ld"), ("implicit_free", "random"),
                   ("explicit_equiangular", "random"),
                   ("implicit_equiangular", "ld"))]


@pytest.mark.parametrize("case", FIELD_CASES,
                         ids=["-".join(c) for c in FIELD_CASES])
def test_host_build_of_field_variant_matches_plain(host_lib, case):
    """csrc/field.cuh in K1's field instantiations (render_pixel<..., true>):
    closed-form exp_height inversion, delta tracking at max_null 64 with
    Pcg::skip after acceptance, every field transmittance."""
    name, integrator, sampler = case
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(_scene(name), vpt_torch.default_camera(), W, H, SPP,
                       max_bounces=MB, sampler=sampler, nee=nee,
                       distance=distance, physical=physical)
    assert pk.field is not None and pk.field.max_null == 64
    out = _host_render(host_lib, pk)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    _assert_q99(out, ref.numpy())


def test_host_build_of_scatter_matches_plain(host_lib):
    """The kernel's lane mapping: tiles from a list of bases (reversed
    here), per-lane sums, padding lanes of the partial last tile."""
    pk = wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                       96, 48, 1, max_bounces=4, sampler="ld")
    lanes = wf.LANES_PER_TILE
    bases = np.arange(pk.num_tiles, dtype=np.int32)[::-1] * lanes
    out = _host_render(host_lib, pk, bases, pk.num_tiles * lanes, sums=1)
    ref = wf.render_raw_plain(pk, torch.tensor([SEED], dtype=torch.int32),
                              torch.from_numpy(bases.copy()))
    _assert_q99(out, ref.numpy())


# the pair on the main-path scene (both samplers, jitter on and off), the
# glass variant and an open scene
DIFF_CASES = [("cornell_vpt", "random", True), ("cornell_vpt", "ld", True),
              ("cornell_vpt", "ld", False), ("cornell_glass", "random", True),
              ("one_primitive_infinite", "ld", True)]


@pytest.mark.parametrize("case", DIFF_CASES,
                         ids=["-".join(map(str, c)) for c in DIFF_CASES])
def test_host_build_of_diff_pair_matches_plain(host_lib, case):
    name, sampler, jitter = case
    _check_host_pair(host_lib, _scene(name), sampler, jitter, {})


# the pair's field instantiations: the fog with and without the falloff
# traced, the blobs with and without their rows traced
FIELD_DIFF_CASES = [("foggy_cornell", "ld", "diff_field"),
                    ("foggy_cornell", "random", None),
                    ("blob_cloud", "random", "diff_blobs"),
                    ("blob_cloud", "ld", None)]


@pytest.mark.parametrize("case", FIELD_DIFF_CASES,
                         ids=["-".join(map(str, c)) for c in FIELD_DIFF_CASES])
def test_host_build_of_field_pair_matches_plain(host_lib, case):
    """diff_pixel<kGrads, true>: the field's transmittances and sigma
    scores, and with traced parameters their n_fp slots (pair_field
    computes the traced constants as the kernel's staging does)."""
    name, sampler, traced = case
    _check_host_pair(host_lib, _scene(name), sampler, True,
                     {traced: True} if traced else {}, max_flips=1)


# the pair's HG instantiations (diff_pixel<kGrads, kField, true>): the
# baked g and the traced diff_g, homogeneous and in the fog, and the traced
# g at 0 (the isotropic snap of the scatter draw)
HG_DIFF_CASES = [("cornell_vpt", 0.5, "ld", {}),
                 ("cornell_vpt", -0.3, "random", {}),
                 ("cornell_vpt", 0.5, "random", {"diff_g": True}),
                 ("cornell_vpt", 0.0, "ld", {"diff_g": True}),
                 ("foggy_cornell", 0.5, "ld",
                  {"diff_g": True, "diff_field": True}),
                 ("foggy_cornell", 0.5, "random", {}),
                 ("blob_cloud", 0.5, "random",
                  {"diff_g": True, "diff_blobs": True})]


@pytest.mark.parametrize("case", HG_DIFF_CASES, ids=[
    f"{c[0]}-g{c[1]}-{c[2]}-{'-'.join(c[3]) or 'baked'}"
    for c in HG_DIFF_CASES])
def test_host_build_of_hg_pair_matches_plain(host_lib, case):
    """The HG phase in medium NEE and the scatter draw, and with diff_g the
    g slot's pathwise NEE term and deferred phase-draw scores. The g slot
    folds as A_g L - B_g and cancels like sigma's: on a lane whose phase
    draws add nothing later, an ulp of libm's exp against torch's leaves
    2.3e-10 in one build and 0 in the other (lane 479 of the fog case), so
    its zero pattern is checked above 1e-7 of the column's scale."""
    name, g, sampler, kw = case
    scene = vpt_torch.SCENES[name]()
    scene = dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))
    _check_host_pair(host_lib, scene, sampler, True, kw,
                     max_flips=int(name != "cornell_vpt"), zero_tol=1e-7)


def _check_host_pair(host_lib, scene, sampler, jitter, kw, max_flips=0,
                     zero_tol=0.0):
    """The host build of K2/K3 against the plain pair. max_flips: lanes
    whose path may take the other branch of a discrete event (libm's and
    torch's exp / log1p differ by an ulp on some inputs): more than 1e-4 of
    their own scale apart in the image, they are left out of the gradient's
    zero-pattern check. Measured: lane 502 of the fog at "random", a
    free-flight inversion, 28 % apart; no lane in the homogeneous cases."""
    dp = df.pack_diff(scene, vpt_torch.default_camera(), W, H, SPP,
                      max_bounces=MB, sampler=sampler, jitter=jitter, **kw)
    words = np.ascontiguousarray(dp.words())
    assert words.size == host_lib.vpt_diff_params_words()   # struct layout
    pvec = df._flatten(df.pack_params(
        scene, with_g=kw.get("diff_g", False),
        with_field=kw.get("diff_field", False),
        with_blobs=kw.get("diff_blobs", False)), scene.count).contiguous()
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = np.full((W * H, 3), np.nan, np.float32)
    host_lib.vpt_diff_fwd_host(words.ctypes.data, pvec.data_ptr(), SEED,
                               out.ctypes.data)
    ref = df.diff_fwd_plain(dp, pvec, seed).numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref) / max(1.0, float(np.abs(ref).max()))
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    flips = (np.abs(out - ref).max(1)
             / np.maximum(1.0, np.abs(ref).max(1))) > 1e-4
    assert flips.sum() <= max_flips, np.flatnonzero(flips)

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
    tiny = zero_tol * np.maximum(1.0, np.abs(Gp).max(0))
    assert np.array_equal(np.abs(G[~flips]) > tiny, np.abs(Gp[~flips]) > tiny)


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
