"""The CUDA kernels' per-path code, built for the host, against the plain
versions.

csrc/path.cuh (with field.cuh and grid.cuh), csrc/diff_path.cuh and
csrc/geom_path.cuh are __host__ __device__. Here g++
compiles them through the test-only shim csrc/path_host.cpp (a loop over
pixels in place of the CUDA grid), with FMA contraction off as nvcc builds
the kernels (--fmad=false). Images are held against the plain versions at
the same seed with the criterion of the other parity tests:
quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4 (libm's and torch's
transcendentals differ by an ulp on some inputs). K3's per-pixel gradient
vectors are held against diff_bwd_plain's per-lane rows by the same
criterion, per entry column: quantile over lanes of the largest
|a-b| / max(1, |column|max) below 1e-4. K4's planes (geom_pixel<K>) are
held against geom_fwd_plain's (in a density field too, geom_pixel<K,
true, true>): the image planes by the image criterion,
each tangent plane by q99 of |a-b| below 1e-4 of the plane's scale. The
grid pair's voxel gradient (diff_grid) is held to the plain version's by
q99 over voxels of |a-b| below 1e-4 of max(1, the largest voxel's sum of
|terms|). This
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
from vpt_torch.kernels import prims as tp
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

from test_torch_grid import port_scene
from test_torch_wavefront import REFERENCE_TIMEOUT_S, lowest_priority

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "vpt_torch", "csrc")
# -O1: half -O2's compile time for the same IEEE results (no fast-math, no
# FMA contraction); the frames here are small, so the code's speed does not
# matter
FLAGS = ["-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]


@pytest.fixture(scope="module")
def host_lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the host build of csrc/path.cuh needs it")
    srcs = [os.path.join(CSRC, f)
            for f in ("path_host.cpp", "path.cuh", "field.cuh", "grid.cuh",
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
                             capture_output=True, text=True,
                             timeout=REFERENCE_TIMEOUT_S,
                             preexec_fn=lowest_priority)
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
    so.vpt_render_grid_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
    so.vpt_render_grid_host.restype = ctypes.c_int
    so.vpt_diff_grid_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    so.vpt_diff_grid_host.restype = None
    so.vpt_diff_params_words.argtypes = []
    so.vpt_diff_params_words.restype = ctypes.c_int
    so.vpt_diff_fwd_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    so.vpt_diff_fwd_host.restype = None
    so.vpt_diff_bwd_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    so.vpt_diff_bwd_host.restype = None
    so.vpt_diff_ext_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    so.vpt_diff_ext_host.restype = None
    so.vpt_geom_params_words.argtypes = []
    so.vpt_geom_params_words.restype = ctypes.c_int
    so.vpt_geom_fwd_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    so.vpt_geom_fwd_host.restype = ctypes.c_int
    so.vpt_geom_field_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
    so.vpt_geom_field_host.restype = ctypes.c_int
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
    if pk.grid is not None:
        tab = np.ascontiguousarray(pk.grid.tab.numpy())
        assert host_lib.vpt_render_grid_host(
            words.ctypes.data, HOST_VARIANT[(pk.nee, pk.distance)], SEED,
            None if b is None else b.ctypes.data, n_lanes, sums,
            tab.ctypes.data, out.ctypes.data) == 0
        return out
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


# K1's grid instantiations (render_pixel<..., kGridField>), both transport
# interpolants: (integrator, interpolant, sampler)
GRID_CASES = [("explicit_free", "tri", "ld"), ("explicit_free", "nearest",
                                                "random"),
              ("implicit_free", "tri", "random"),
              ("explicit_equiangular", "nearest", "ld"),
              ("explicit_equiangular", "tri", "random"),
              ("implicit_equiangular", "tri", "ld")]


@pytest.mark.parametrize("case", GRID_CASES,
                         ids=["-".join(c) for c in GRID_CASES])
def test_host_build_of_grid_variant_matches_plain(host_lib, case):
    """csrc/grid.cuh in K1: the free flight's march (the inverted distance
    and the surface's tau), the shadow rays' marches, the equi-angular
    signed tau with its reverse march, sigma_s(xt) trilinear."""
    integrator, interp, sampler = case
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    scene, cam = port_scene(interp)
    pk = wf.pack_scene(scene, cam, W, H, SPP, max_bounces=MB,
                       sampler=sampler, nee=nee, distance=distance,
                       physical=physical)
    out = _host_render(host_lib, pk)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    _assert_q99(out, ref.numpy())


# the grid pair: diff_grid (both interpolants, both samplers) and the baked
# grid: (interpolant, sampler, diff_grid)
GRID_DIFF_CASES = [("tri", "ld", True), ("nearest", "random", True),
                   ("tri", "random", False)]


@pytest.mark.parametrize("case", GRID_DIFF_CASES, ids=[
    f"{c[0]}-{c[1]}-{'diff_grid' if c[2] else 'baked'}"
    for c in GRID_DIFF_CASES])
def test_host_build_of_grid_pair_matches_plain(host_lib, case):
    """diff_pixel<kGrads, kGridField>: the grid's sigma scores and
    transmittances, and with diff_grid the two-phase replay and the voxel
    scatter (plain adds here, atomics on the card)."""
    interp, sampler, dg = case
    scene, cam = port_scene(interp)
    dp = df.pack_diff(scene, cam, W, H, SPP, max_bounces=MB, sampler=sampler,
                      diff_grid=dg)
    words = np.ascontiguousarray(dp.words())
    assert words.size == host_lib.vpt_diff_params_words()   # struct layout
    params = df.pack_params(scene, with_grid=dg)
    pvec = df._flatten(params, scene.count).contiguous()
    tab = tp.grid_table(scene.medium.density.params)
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = np.full((W * H, 3), np.nan, np.float32)
    host_lib.vpt_diff_grid_host(words.ctypes.data, pvec.data_ptr(), SEED,
                                None, tab.data_ptr(), out.ctypes.data, None)
    _assert_q99(out, df.diff_fwd_plain(dp, pvec, seed, tab=tab).numpy())
    gbar = np.random.default_rng(0).standard_normal((W * H, 3)).astype(
        np.float32)
    G = np.full((W * H, dp.P), np.nan, np.float32)
    gg = np.zeros(int(np.prod(dp.pk.grid.dims)), np.float32)
    host_lib.vpt_diff_grid_host(words.ctypes.data, pvec.data_ptr(), SEED,
                                gbar.ctypes.data, tab.data_ptr(),
                                G.ctypes.data, gg.ctypes.data if dg else None)
    ref = df.diff_bwd_plain(dp, pvec, seed, torch.from_numpy(gbar),
                            per_lane=True, tab=tab, voxel_abs=True)
    Gp = (ref[0] if dg else ref).numpy()
    assert np.isfinite(G).all()
    rel = (np.abs(G - Gp) / np.maximum(1.0, np.abs(Gp).max(0))).max(1)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    if dg:
        want, gabs = ref[1].numpy().reshape(-1), ref[2].numpy()
        assert np.isfinite(gg).all() and np.abs(want).max() > 0
        rel = np.abs(gg - want) / max(1.0, float(gabs.max()))
        assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    else:
        assert not gg.any()


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


# the pair's extended instantiations (diff_pixel<kGrads, kField, true,
# true>): equi-angular (homogeneous, in the fog with diff_g + diff_field,
# on the grid with diff_grid at a baked g), the implicit and physical
# estimators, material-3 shells, HG in a grid under free flight: (scene, g,
# traced, estimator, sampler)
EXT_CASES = [
    ("cornell_vpt", 0.0, {}, dict(distance="equiangular"), "ld"),
    ("cornell_vpt", 0.5, {"diff_g": True},
     dict(distance="equiangular", nee=False, physical=True), "random"),
    ("cornell_vpt", 0.0, {}, dict(physical=True), "random"),
    ("medium_shell", 0.0, {}, {}, "ld"),
    ("foggy_cornell", 0.5, {"diff_g": True, "diff_field": True},
     dict(distance="equiangular", physical=True), "random"),
    ("blob_cloud", 0.0, {"diff_blobs": True},
     dict(distance="equiangular"), "ld"),
    ("grid", 0.5, {"diff_grid": True}, dict(distance="equiangular"), "ld"),
    ("grid_nearest", 0.0, {"diff_grid": True},
     dict(distance="equiangular", nee=False, physical=True), "random"),
    ("grid", -0.3, {"diff_grid": True}, {}, "random")]


@pytest.mark.parametrize("case", EXT_CASES, ids=[
    f"{c[0]}-g{c[1]}-{'-'.join(c[2]) or 'baked'}-"
    f"{'-'.join(f'{k}={v}' for k, v in c[3].items()) or 'free'}-{c[4]}"
    for c in EXT_CASES])
def test_host_build_of_ext_pair_matches_plain(host_lib, case):
    """The extended estimators read at run time: K2's image, K3's per-pixel
    rows and (diff_grid) the voxel gradient against the plain pair, as the
    grid pair's test holds them; the image criterion's flip lanes (an ulp
    of libm against torch deciding a discrete event) at most 1."""
    name, g, traced, est, sampler = case
    if name.startswith("grid"):
        scene, cam = port_scene("nearest" if name == "grid_nearest"
                                else "tri")
    else:
        scene, cam = vpt_torch.SCENES[name](), vpt_torch.default_camera()
    scene = dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))
    dp = df.pack_diff(scene, cam, W, H, SPP, max_bounces=MB, sampler=sampler,
                      **traced, **est)
    assert dp.ext
    words = np.ascontiguousarray(dp.words())
    assert words.size == host_lib.vpt_diff_params_words()   # struct layout
    params = df.pack_params(scene, with_g=traced.get("diff_g", False),
                            with_field=traced.get("diff_field", False),
                            with_blobs=traced.get("diff_blobs", False),
                            with_grid=traced.get("diff_grid", False))
    pvec = df._flatten(params, scene.count).contiguous()
    grid = dp.pk.grid is not None
    tab = tp.grid_table(scene.medium.density.params) if grid else None
    tab_p = tab.data_ptr() if grid else None
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = np.full((W * H, 3), np.nan, np.float32)
    host_lib.vpt_diff_ext_host(words.ctypes.data, pvec.data_ptr(), SEED,
                               None, tab_p, out.ctypes.data, None)
    ref = df.diff_fwd_plain(dp, pvec, seed, tab=tab).numpy()
    assert np.isfinite(out).all()
    rel = np.abs(out - ref) / max(1.0, float(np.abs(ref).max()))
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    flips = (np.abs(out - ref).max(1)
             / np.maximum(1.0, np.abs(ref).max(1))) > 1e-4
    assert flips.sum() <= 1, np.flatnonzero(flips)
    gbar = np.random.default_rng(0).standard_normal((W * H, 3)).astype(
        np.float32)
    G = np.full((W * H, dp.P), np.nan, np.float32)
    dg = dp.diff_grid
    gg = np.zeros(int(np.prod(dp.pk.grid.dims)) if grid else 1, np.float32)
    host_lib.vpt_diff_ext_host(words.ctypes.data, pvec.data_ptr(), SEED,
                               gbar.ctypes.data, tab_p, G.ctypes.data,
                               gg.ctypes.data if dg else None)
    refg = df.diff_bwd_plain(dp, pvec, seed, torch.from_numpy(gbar),
                             per_lane=True, tab=tab, voxel_abs=True)
    Gp = (refg[0] if dg else refg).numpy()
    assert np.isfinite(G).all()
    rel = (np.abs(G - Gp) / np.maximum(1.0, np.abs(Gp).max(0))).max(1)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    if dg:
        want, gabs = refg[1].numpy().reshape(-1), refg[2].numpy()
        assert np.isfinite(gg).all() and np.abs(want).max() > 0
        rel = np.abs(gg - want) / max(1.0, float(gabs.max()))
        assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)


def _geom_planes_match(gp, out, ref):
    """geom_fwd_plain's criterion per plane (see the module docstring)."""
    assert np.isfinite(out).all()
    for j in range(gp.planes):
        if j % (1 + gp.K) == 0:        # an image plane
            scale = max(1.0, float(np.abs(ref[j]).max()))
        else:       # a tangent plane; some are exactly 0 (a red light)
            scale = float(np.abs(ref[j]).max())
            if scale == 0.0:
                assert np.all(out[j] == 0.0), j
                continue
        q = float(np.quantile(np.abs(out[j] - ref[j]), 0.99)) / scale
        assert q < 1e-4, (j, q)


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
                                      SEED, 0, out.ctypes.data) == 0
    ref = gm.geom_fwd_plain(gp, theta,
                            torch.tensor([SEED], dtype=torch.int32)).numpy()
    _geom_planes_match(gp, out, ref)


# K4's extended estimators (geom_pixel<K, true>): (K, sphere, cam_grads,
# dir_grads, primal_only, scene, HG g, estimator, sampler). A scene with a
# material-3 shell runs the default estimator in geom_pixel<K> (vpt's K4
# has no shell cascade) and any other in the extended one.
EA = dict(distance="equiangular")
GEOM_EXT_CASES = [
    (7, 8, True, False, False, "cornell_vpt", 0.0, EA, "random"),
    (7, 8, True, False, False, "cornell_vpt", 0.0,
     dict(nee=False, physical=True), "ld"),
    (0, 8, False, False, True, "cornell_vpt", 0.0, dict(physical=True),
     "random"),
    (0, 8, False, False, True, "cornell_vpt", 0.0,
     dict(nee=False, distance="equiangular"), "ld"),
    (3, 8, False, False, False, "cornell_vpt", 0.5, {}, "random"),
    (10, 9, True, True, False, "cornell_vpt", 0.5, EA, "ld"),
    (4, None, True, False, False, "medium_shell", 0.0, {}, "random"),
    (6, 8, False, True, False, "medium_shell", 0.5,
     dict(distance="equiangular", physical=True), "ld"),
]


@pytest.mark.parametrize("case", GEOM_EXT_CASES, ids=[
    f"K{c[0]}-{c[5]}-g{c[6]}-{'-'.join(f'{k}={v}' for k, v in c[7].items())}"
    f"-{c[8]}" for c in GEOM_EXT_CASES])
def test_host_build_of_geom_ext_matches_plain(host_lib, case):
    K, sphere, cam, dirg, primal, name, g, est, sampler = case
    scene = _scene(name)
    scene = dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))
    cam_ = vpt_torch.default_camera()
    gp = gm.pack_geom(scene, cam_, 12, 8, 2, sphere=sphere, cam_grads=cam,
                      dir_grads=dirg, primal_only=primal, max_bounces=5,
                      sampler=sampler, **est)
    assert gp.K == K and gp.ext == bool(est or g)
    words = np.ascontiguousarray(gp.words())
    assert words.size == host_lib.vpt_geom_params_words()   # struct layout
    theta = gm.flatten_theta(gm.pack_theta(scene, cam_, sphere)).contiguous()
    out = np.full((gp.planes, gp.npix), np.nan, np.float32)
    assert host_lib.vpt_geom_fwd_host(words.ctypes.data, theta.data_ptr(),
                                      SEED, int(gp.ext), out.ctypes.data) == 0
    ref = gm.geom_fwd_plain(gp, theta,
                            torch.tensor([SEED], dtype=torch.int32)).numpy()
    _geom_planes_match(gp, out, ref)


# K4 in a density field (geom_pixel<K, true, true>, csrc/geom_field_k<K>.cu):
# (K, sphere, cam_grads, primal_only, scene, HG g, estimator, sampler); the
# grid (K = 0 only) is test_torch_geom_field.py's 8^3 xy-nearest one
GEOM_FIELD_CASES = [
    (7, 8, True, False, "foggy_cornell", 0.0, {}, "random"),
    (3, 8, False, False, "foggy_cornell", 0.5, EA, "ld"),
    (4, None, True, False, "blob_cloud", 0.0, {}, "random"),
    (0, 2, False, True, "blob_cloud", 0.0, EA, "ld"),
    (0, 2, False, True, "grid", 0.0, {}, "random"),
    (0, 2, False, True, "grid", 0.0, EA, "ld"),
]


@pytest.mark.parametrize("case", GEOM_FIELD_CASES, ids=[
    f"K{c[0]}-{c[4]}-g{c[5]}-{'-'.join(f'{k}={v}' for k, v in c[6].items())}"
    f"-{c[7]}" for c in GEOM_FIELD_CASES])
def test_host_build_of_geom_field_matches_plain(host_lib, case):
    K, sphere, cam, primal, name, g, est, sampler = case
    if name == "grid":
        from test_torch_geom import make
        from test_torch_geom_field import BLOB_SPHERES, grid_spec
        scene = make(BLOB_SPHERES, (0.004, 0.04), g, grid_spec())
    else:
        scene = vpt_torch.SCENES[name]()
        scene = dataclasses.replace(scene, medium=dataclasses.replace(
            scene.medium, g=torch.tensor(g)))
    cam_ = vpt_torch.default_camera()
    gp = gm.pack_geom(scene, cam_, 12, 8, 2, sphere=sphere, cam_grads=cam,
                      primal_only=primal, max_bounces=5, sampler=sampler,
                      **est)
    assert gp.K == K and gp.field and gp.entry == f"geom_field_k{K}"
    words = np.ascontiguousarray(gp.words())
    assert words.size == host_lib.vpt_geom_params_words()
    theta = gm.flatten_theta(gm.pack_theta(scene, cam_, sphere)).contiguous()
    tab = (None if gp.pk.grid is None
           else np.ascontiguousarray(gp.pk.grid.tab.numpy()))
    out = np.full((gp.planes, gp.npix), np.nan, np.float32)
    assert host_lib.vpt_geom_field_host(
        words.ctypes.data, theta.data_ptr(), SEED,
        None if tab is None else tab.ctypes.data, out.ctypes.data) == 0
    ref = gm.geom_fwd_plain(gp, theta,
                            torch.tensor([SEED], dtype=torch.int32)).numpy()
    _geom_planes_match(gp, out, ref)
