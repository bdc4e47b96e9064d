"""Smoke run of the vpt_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and drives each
path of the port once at full size, checking every kernel against its
plain torch version on the card:

  1. the card; 2. the build (one nvcc per source, in parallel) and the
     registers, spills and stack frames ptxas reports;
  3. K1, the render kernel, against its plain version on a small frame;
  4. the forward main path: cornell_vpt at 1024x1024, 64 spp, sampler
     "ld", max_bounces 32, through vpt_torch.render; 5. its throughput;
  6. K2 and K3, the differentiable pair, against their plain versions on a
     small frame (images, per-pixel gradient vectors and the summed
     gradient);
  7. the fwd+bwd pair at the same size through make_diff_renderer and
     loss.backward(); K2 against its plain version there, K3 against its
     plain version at 4 spp; times;
  8. the trainer: three vpt_torch.dist.fit_kernel steps on a 1024x1024
     target, as examples/recover_sigma.py runs at 256x256;
  9. K4, the dual kernel, against its plain version on a small frame: K = 7
     (sphere 8 + camera, both samplers, seeds 3 and 11), K = 10 and K = 0;
 10. the geom main path, vpt's bench.py:191-193 workload: cornell_vpt,
     sphere 8 + camera (K = 7), sampler "random", max_bounces 32,
     1024x1024x64 through make_geom_renderer(...)(theta, seed); camera
     paths/s; K4 against its plain version at 2 spp and, at K = 0, at the
     full size; K = 0 timed beside K1;
 11. the geometric trainers: three fit_geom steps at 1024x1024, then
     examples/localize_light.py's chip configuration through fit_geom_fd
     (an area light 8 units off in y, 80 CRN-FD steps at 64x48);
 12. K1's variants: every instantiation (free flight with and without NEE,
     equi-angular with NEE, clamped equi-angular without) and launch mode
     (physical, HG g, material-3 shells), under every integrator name of
     vpt's PALLAS_INTEGRATORS: bit-equal to the plain version at 64x32x8
     (both samplers, seeds 3 and 11); then each through vpt_torch.render at
     1024x1024x64 "ld" (cornell_vpt, or medium_shell), bit-equal to the
     plain version at that frame (whose counters give the work), timed,
     with its operations bound; the card-side agreement of the free,
     equi-angular and implicit estimators' means at 256x256x256;
 13. the scatter-tile mode (every instantiation: contiguous raw sums,
     scatter forward and reversed, plain scatter, bit for bit at 128x64x4)
     and the entry points on it: vpt_torch.render_adaptive at 1024x1024x64
     (boost 3, frac 0.25), timed, with its first pass and its scatter
     launch on the tiles it selected bit-equal to the plain version; and
     vpt_torch.render_to_noise at 256x256 (batches of 16 spp, target
     0.05), timed;
 14. the analytic density fields (exp_height, blobs): ptxas of the field
     instantiations and the homogeneous ones unchanged; K1's field
     instantiations bit-equal to the plain version at 64x32x8
     (foggy_cornell and blob_cloud under explicit_free,
     explicit_equiangular and implicit_free, both samplers, seeds 3 and
     11); each field instantiation through vpt_torch.render at 1024x1024x64
     "ld" (explicit_free on both scenes, the other three on foggy_cornell),
     bit-equal to the plain version there, timed, with its bound; K2/K3's
     field instantiations against their plain versions at 64x32x8
     (foggy_cornell without and with the falloff traced, blob_cloud with
     the blobs traced); the fog pair with diff_field at 1024x1024x64,
     fwd+bwd timed, K2 bit-equal to plain there and K3 at 4 spp; the
     trainers at the examples' settings: examples/recover_fog.py --kernel
     (k 0.12 -> 0.06 at 128x128) and examples/recover_blobs.py (blob 0's
     shape at 256x192; Adam at 0.15 with only the blob rows kept), then
     K2/K3 with the blobs traced at that trainer's shape (256x192, 16 spp
     per render, 16 bounces) against their plain versions, and blob 0's gradients against
     common-random-number central differences;
 15. the Henyey-Greenstein phase in the pair and the multi-view trainer:
     ptxas of K2/K3's HG instantiations (the isotropic ones held to their
     registers); each against its plain version at 64x32x8 (cornell_vpt at
     a baked g = 0.5 under both samplers, the traced diff_g, foggy_cornell
     with diff_g + diff_field; seeds 3 and 11) and at
     examples/recover_fog_multiview.py's shape (192x192, 16 spp per render,
     32 bounces, "ld"); the fog pair with diff_g + diff_field and the
     homogeneous pair at the baked g through make_diff_renderer at
     1024x1024x64 "ld", fwd+bwd timed, K2 bit-equal to plain there; then
     the examples at their own settings through the port's API:
     examples/recover_sigma.py (256x256, 200 steps),
     examples/recover_all.py --seed 0 --views 2 (1024x1024; the material
     block through make_multiview_train_step with per-leaf Adam groups,
     the geometry block through fit_geom_fd; 3 rounds) against
     BASELINE.md's tolerances, and FOG_MV_STEPS of
     examples/recover_fog_multiview.py's 2400 steps through fit_multiview;
 16. voxel grids: ptxas of the grid instantiations (K1's four, K2's and
     K3's) and every kernel from before the grid unchanged; K1's grid
     instantiations bit-equal to the plain version at 64x32x8 on grid_cloud
     (both transport interpolants and samplers); K2 and K3 on the grid,
     baked and with diff_grid, against theirs there (the image and K3's
     per-pixel rows bit for bit, the voxel gradient per voxel within
     GVEC_TOL of its terms' absolute sum), and at examples/recover_grid.py's
     training shape (128x96x8) on its 16^3 truth; the voxel gradient against
     common-random-number finite differences (vpt's criterion) at the test's
     shape and the trainer's; K1 on the 32^3 nearest grid and every K1 grid
     instantiation on the 16^3 trilinear one through vpt_torch.render at
     1024x1024x64 "ld", timed, with bounds from counters at a smaller
     frame; the diff_grid pair there, fwd+bwd, K2 and K3 timed, the scatter
     mode reported; then examples/recover_grid.py at its defaults through
     fit_grid;
 17. the rest of the pair, in its extended instantiations (equi-angular
     distances, the implicit and physical estimators, material-3 shells,
     HG in a grid): ptxas of the six new kernels and the 28 older ones
     held to their numbers; each new K2/K3 against its plain version at
     64x32x8 under both samplers (the image and K3's rows bit for bit, the
     voxel gradient per voxel within GVEC_TOL of its terms' absolute sum)
     and K2 against K1's image of the same estimator (vpt's contract 1),
     the equi-angular diff_grid pair also at vpt's test shape and at
     recover_grid's 128x96x8; the equi-angular voxel gradient against
     CRN FD; the equi-angular, physical, implicit, fog equi-angular,
     medium_shell and equi-angular diff_grid pairs timed at 1024x1024x64
     through make_diff_renderer; the reference's research question in
     gradient form (free flight against equi-angular, 40 seeds each at
     256x256x16); and examples/recover_grid.py --distance equiangular
     through fit_grid for RG_EA_STEPS steps;
 18. the rest of the dual kernel K4, in its extended instantiations
     (equi-angular distances, the implicit and physical estimators, a baked
     HG g; material-3 shells run the default instantiations, as vpt's K4
     has no shell cascade): ptxas of the six new kernels and the six older
     K4 ones held to their numbers; every extended K against its plain
     version at 64x32x8, bit for bit (image and every tangent plane:
     equi-angular NEE at g = 0.5 for each K under both samplers, and at
     K = 7 and K = 0 each estimator route and medium_shell), and the
     K = 7 primal bit-equal to the K = 0 one; the geom main frame
     (cornell_vpt, 1024x1024x64, "random", sphere 8 + camera) under
     equi-angular, nee=False + physical, a baked g = 0.5 and medium_shell,
     and K = 0 under equi-angular, through make_geom_renderer, timed, the
     equi-angular K = 7 bit-equal to plain at 2 spp; K = 3, 4, 6 and 10
     through make_geom_renderer at 128x128x8; and
     examples/recover_camera.py at its own setting through
     make_fd_geom_train_step with per-leaf decaying Adam rates.

The main-frame plain versions (phases 4, 7, 10, 12, 14 and 15) and the
plain checks of phases 9 and 14-18 run in worker processes on the same card
while the kernels build (PlainPool); they are collected before the first
timing. `--recover-fog-multiview STEPS` runs the card, the build and that
example's fit alone; `--geom-ext` the card, the build and phase 18;
`--recover-grid STEPS` the same for
examples/recover_grid.py at vpt's round-4 setting (RG_ROUND4; 250 steps
is that run, about 80 s of fitting); `--recover-grid-ea STEPS` runs
tools/studies/tomo_quality_study.py's rows B (free flight) and F
(equi-angular) of that example (RG_ROWS).

Each main path (phases 4, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17 and 18) runs with every
launch count set to 0 just before it and read just after. The line before the last is the
per-kernel JSON record, the last line the device record. Any failed phase
raises and the script exits non-zero; without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import vpt_torch
from vpt_torch.kernels import _build
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.scene import SCENES

# pixel-by-pixel agreement: the 99th percentile of |a-b| / max(1, |ref|max)
# stays below 1e-4. The kernel and the plain version round the same f32
# operations in the same order with the same device math (expf, log1pf,
# sinf, cosf, rsqrtf), and agree bit for bit on an H100 with torch 2.11. The
# quantile leaves room for a torch build whose CUDA ops use other math
# functions: an ulp of difference can flip a rare discrete event (a
# visibility or Fresnel choice) and change a few pixels by a lot.
Q99_TOL = 1e-4
# K3's summed gradient, per entry: |kernel - plain| <= GVEC_TOL * sum over
# pixels of |G_pixel, k|. Both sum the same per-pixel f32 vectors (which
# agree per pixel by the criterion above, and bit for bit where the device
# math agrees), in another order: the kernel a warp-shuffle tree and 4 warp
# sums per block of 128 pixels, then torch's sum over blocks; the plain
# version torch's sum over pixels. Each order's rounding error is below
# about log2(n) * 2^-24 of sum |x| (1.3e-6 for n = 2^20).
GVEC_TOL = 1e-5

MAIN_CFG = dict(width=1024, height=1024, spp=64, sampler="ld", max_bounces=32)
# K1 (explicit_free) at MAIN_CFG when the kernel had only its free-flight NEE
# body (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): the variants must leave
# it within 3 %
K1_FREE_ONLY_MS = 82.132
# phase 12: (label, integrator, scene, HG g): every name of vpt's
# PALLAS_INTEGRATORS, then the launch-parameter modes
VARIANTS = [(name, name, "cornell_vpt", 0.0)
            for name in wf.KERNEL_INTEGRATORS] + [
    ("explicit_equiangular g=0.5", "explicit_equiangular", "cornell_vpt", 0.5),
    ("implicit_free g=-0.3", "implicit_free", "cornell_vpt", -0.3),
    ("explicit_free medium_shell", "explicit_free", "medium_shell", 0.0),
    ("explicit_free_physical medium_shell", "explicit_free_physical",
     "medium_shell", 0.0)]
CHECK_SPP = 4           # K3 against its plain version at the main frame
GEOM_CHECK_SPP = 2      # K4 (K = 7) against its plain version at the main frame

# the card's peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): f32
# outside the tensor cores and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def with_g(scene, g: float):
    """The scene with its medium's HG anisotropy set to g."""
    if g == 0.0:
        return scene
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))


def q99_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    rel = (a - ref).abs() / max(1.0, float(ref.abs().max()))
    return float(torch.quantile(rel.flatten().double().cpu(), 0.99))


def lane_q99(G: torch.Tensor, Gp: torch.Tensor) -> float:
    """q99 over pixels of the largest per-entry error, each entry column
    scaled by max(1, |column|max): the image criterion for gradients."""
    rel = ((G - Gp).abs() / Gp.abs().amax(0).clamp_min(1.0)).amax(1)
    return float(torch.quantile(rel.double().cpu(), 0.99))


def cuda_ms(fn) -> tuple[object, float]:
    """Run fn once between two CUDA events; (result, milliseconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def median_ms(fn, n: int = 3, warm_up: bool = True) -> tuple[float, list]:
    """Median of n CUDA-event timings after one warm-up run (warm_up=False:
    the caller ran fn already)."""
    if warm_up:
        fn()
    times = [cuda_ms(fn)[1] for _ in range(n)]
    return statistics.median(times), [round(t, 3) for t in times]


def reset_counts() -> None:
    wf.LAUNCHES_BY.clear()
    df.LAUNCHES_BY.clear()
    gm.LAUNCHES_BY.clear()
    gm.LAUNCHES = 0


def counts() -> dict:
    return {"wavefront_fwd": wf.LAUNCHES, "diff_fwd": df.LAUNCHES_FWD,
            "diff_bwd": df.LAUNCHES_BWD, "geom_fwd": gm.LAUNCHES}


def plane_check(k: torch.Tensor, p: torch.Tensor, K: int) -> tuple:
    """K4's planes against the plain version's: image planes by q99_rel,
    tangent planes by q99 of |a-b| over the plane's scale (a plane that is
    0 in the plain version must be 0). Returns (worst q99, max abs error,
    the share of bit-equal pixels per plane)."""
    worst, shares = 0.0, []
    for j in range(k.shape[0]):
        if j % (1 + K) == 0:
            q = q99_rel(k[j], p[j])
        else:
            scale = float(p[j].abs().max())
            q = (float(torch.quantile((k[j] - p[j]).abs().double().cpu(),
                                      0.99)) / scale if scale > 0.0
                 else float(k[j].abs().max()))
        worst = max(worst, q)
        shares.append(round(float((k[j] == p[j]).float().mean()), 4))
    return worst, float((k - p).abs().max()), shares


# ---- the least time the card could take for a kernel's work --------------
#
# f32 operations per unit of work, counted from csrc/path.cuh and
# csrc/diff_path.cuh: add, sub, mul, div, sqrt, rsqrt, exp, log, sin, cos
# and floor count one each; compares, selects and the integer PCG
# arithmetic count zero; every material branch is counted as its Lambert
# branch, the cheapest. So the count is a lower bound. S spheres, M MIS
# lights, E emitters, A spheres with deferred albedo terms:
#   per thread-iteration (draws, scene intersection, hit frame, light pick,
#     free-flight distance): 41 + 23 S (23 per sphere test);
#   per sample (camera ray): 29;
#   per surface-shading event (pLight 15 + 23 S, its NEE sum 35, per MIS
#     light 109 + 23 S, the MIS BSDF strategy 86 + 23 S, BSDF sampling and
#     throughput 72): 208 + 109 M + 23 S (2 + M);
#   per medium-scattering event (medium NEE, phase sample, throughput):
#     102 + 23 S;
#   K3 on top: 9 per thread-iteration (score pair), per shading event
#     76 + 39 M + 3 E (NEE, MIS and albedo partials, deferred lambert
#     pair), 42 per medium event, 11 + 9 A per sample (the fold at path
#     death), 3 per pixel (the cotangent's scale).
def ops_lower_bound(kernel: str, stats: dict, dp: df.DiffPacked) -> float:
    pk = dp.pk
    S, M, E, A = pk.S, len(pk.mis_lights), len(pk.emitters), len(dp.lam_ids)
    samples = pk.npix * pk.spp
    ops = (stats["thread_iters"] * (41 + 23 * S) + samples * 29
           + stats["shade"] * (208 + 109 * M + 23 * S * (2 + M))
           + stats["medium"] * (102 + 23 * S))
    if kernel == "diff_bwd":
        ops += (stats["thread_iters"] * 9
                + stats["shade"] * (76 + 39 * M + 3 * E)
                + stats["medium"] * 42 + samples * (11 + 9 * A)
                + pk.npix * 3)
    return float(ops)


# K4 (csrc/geom_path.cuh) runs the path work above in dual numbers: every
# operation on a dual value also does at least one operation per tangent
# (add 1, multiply 1 or 3, divide 3, sqrt / rsqrt / exp / abs 1), and only a
# few per event stay plain (draws, the free-flight distance, the light
# pick, the camera's sx and sy, the cosine and phase samplers' local
# frames). So, counting K2's operations as above and at most PLAIN_OPS of
# them as plain, ops(K4) >= (1 + K) * (ops - plain) + plain: a lower bound.
PLAIN_OPS = {"thread_iters": 10, "samples": 10, "shade": 40, "medium": 15}


def geom_ops_lower_bound(stats: dict, gp: gm.GeomPacked) -> float:
    pk = gp.pk
    dp = df.DiffPacked(pk=pk, cp=gp.cp, inv_spp=0.0, alb_ids=(), lam_ids=())
    ops = ops_lower_bound("diff_fwd", stats, dp)
    plain = (stats["thread_iters"] * PLAIN_OPS["thread_iters"]
             + pk.npix * pk.spp * PLAIN_OPS["samples"]
             + stats["shade"] * PLAIN_OPS["shade"]
             + stats["medium"] * PLAIN_OPS["medium"])
    return (1 + gp.K) * (ops - plain) + plain


def geom_bound(stats: dict, gp: gm.GeomPacked) -> tuple[float, str]:
    t_ops = geom_ops_lower_bound(stats, gp) / PEAK_F32 * 1e3
    # theta and the seed in, 3 (1 + K) planes of per-pixel sums out
    t_bytes = (48.0 + 4.0 + 4.0 * gp.planes * gp.npix) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# K1's variants (csrc/path.cuh render_pixel<kNee, kDist>), counted the same
# way from the code on top of the free-flight NEE counts above:
#   per thread-iteration, the equi-angular families: +60 (transmittance,
#     foot point and D, two atan2_posx of 15 each, tan as sin/cos, the
#     sample point, its pdf and pSuccess, less the free-flight sample);
#   per shading event without NEE: 72 (BSDF sampling and throughput only);
#   per medium event: 14 for the phase sample and throughput, +88 + 23 S
#     with NEE (the medium NEE trace), +8 for the equi-angular weight,
#     +30 for the HG direction at g != 0 and +12 for the HG phase value
#     with NEE; the material-3 cascade and the physical credit count 0.
def variant_ops_lower_bound(stats: dict, pk: wf.Packed,
                            n_lanes: int | None = None) -> float:
    """n_lanes: the lanes launched where they are not pk's whole frame."""
    S, M = pk.S, len(pk.mis_lights)
    ea = pk.distance != "free"
    hg = pk.g != 0.0
    it = 41 + 23 * S + (60 if ea else 0)
    shade = 72 + ((136 + 109 * M + 23 * S * (2 + M)) if pk.nee else 0)
    medium = (14 + ((88 + 23 * S) if pk.nee else 0) + (8 if ea else 0)
              + (30 if hg else 0) + (12 if hg and pk.nee else 0))
    lanes = pk.npix if n_lanes is None else n_lanes
    return float(stats["thread_iters"] * it + lanes * pk.spp * 29
                 + stats["shade"] * shade + stats["medium"] * medium)


def variant_bound(stats: dict, pk: wf.Packed,
                  n_lanes: int | None = None) -> tuple[float, str]:
    t_ops = variant_ops_lower_bound(stats, pk, n_lanes) / PEAK_F32 * 1e3
    # seed (and tile bases) in, 12 bytes of radiance out per lane
    lanes = pk.npix if n_lanes is None else n_lanes
    t_bytes = (4.0 + 12.0 * lanes) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bytes_moved(kernel: str, dp: df.DiffPacked) -> float:
    """Each input read once, each output written once."""
    npix, P = dp.npix, dp.P
    if kernel == "wavefront_fwd":           # seed in, image out
        return 4.0 + 12.0 * npix
    if kernel == "diff_fwd":                # pvec and seed in, image out
        return 4.0 * P + 4.0 + 12.0 * npix
    blocks = -(-npix // _build.load().vpt_diff_block_threads())
    # pvec, seed and the cotangent in, one P-vector per block out
    return 4.0 * P + 4.0 + 12.0 * npix + 4.0 * P * blocks


def bound(kernel: str, stats: dict, dp: df.DiffPacked) -> tuple[float, str]:
    t_ops = ops_lower_bound(kernel, stats, dp) / PEAK_F32 * 1e3
    t_bytes = bytes_moved(kernel, dp) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- the plain versions at the main frame, in worker processes
#
# A plain version is host-bound: one Python thread issues thousands of small
# CUDA kernels per loop iteration, 13-34 s at the main frame, and leaves the
# card nearly idle. The main-frame runs (each an oracle for a kernel's
# output there and the counter of the work its bound reads) go to
# PLAIN_WORKERS spawned processes on the same card, submitted before the
# build and collected before the first kernel timing, so that no timing
# shares the card with them. A job rebuilds its inputs from a hashable spec
# at MAIN_CFG's frame and seed, and times the plain call alone; its time is
# that of one of PLAIN_WORKERS concurrent processes (a record says so with
# "plain_alone": false), which phase 5 sets beside K1's plain version run
# alone (NVIDIA H100 80GB HBM3: 18.5 s alone, 60.3 s in a pool started
# after the build, so the workers slow each other, not the build):
#   ("k1", scene, g, integrator): the render kernel's plain version;
#   ("fk1", scene, integrator, sampler, seed): K1 in a field at 64x32x8;
#   ("k4x", scene, g, estimator, K, frame): the dual kernel's at a frame
#     (phases 9 and 18);
#   ("k2", scene, g, traced): the pair's forward, traced a tuple of
#     make_diff_renderer flags (diff_g, diff_field);
#   ("k4", sphere, primal_only, spp): the dual kernel's at spp;
#   ("pair", scene, g, traced, frame): the pair's image and K3's per-pixel
#     rows at a pair_inputs frame.
PLAIN_WORKERS = 8   # the card's host has 8 cores; the main process waits
PLAIN_TIMEOUT_S = 600   # the pool took 211.6 s in all (NVIDIA H100 80GB HBM3)


def pair_inputs(name: str, g: float, traced: tuple, frame: tuple, camera,
                dev: torch.device) -> tuple:
    """The pair's inputs on SCENES[name] at HG g, traced a tuple of
    make_diff_renderer flags, frame (width, height, spp, max_bounces,
    sampler, seed): (packed, P-vector, seed tensor, cotangent drawn from
    np.random.default_rng(seed)). The kernels and their plain versions
    are both fed from here."""
    w, h, spp, mb, sampler, s = frame
    sc = with_g(SCENES[name](), g)
    kw = dict.fromkeys(traced, True)
    dp = df.pack_diff(sc, camera, w, h, spp, max_bounces=mb, sampler=sampler,
                      **kw)
    pvec = df._flatten(df.pack_params(
        sc, with_g="diff_g" in kw, with_field="diff_field" in kw),
        sc.count).to(dev)
    seed = torch.tensor([s], dtype=torch.int32, device=dev)
    gbar = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (dp.npix, 3)).astype(np.float32)).to(dev)
    return dp, pvec, seed, gbar


def main_frame() -> tuple:
    """MAIN_CFG as a pair_inputs frame."""
    c = vpt_torch.RenderConfig(**MAIN_CFG)
    return (c.width, c.height, c.spp, c.max_bounces, c.sampler, c.seed)


def plain_job(spec: tuple) -> tuple:
    """Run one plain version on the card; (output as numpy, the work
    counters, ms of the plain call alone, its inputs built before)."""
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    cfg = vpt_torch.RenderConfig(**MAIN_CFG)
    cam = vpt_torch.default_camera()
    seed = torch.tensor([cfg.seed], dtype=torch.int32, device=dev)
    kind, name = spec[:2]
    stats = {}
    if kind in ("gk1", "gpair"):
        return grid_plain_job(spec, dev, cam)
    if kind == "xpair":
        return ext_plain_job(spec, dev, cam)
    if kind == "k4x":
        return geom_ext_plain_job(spec, dev, cam)
    if kind == "fk1":
        pk = field_k1_pack(spec, cam)
        s = torch.tensor([spec[4]], dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        out = wf.render_tile_plain(pk, s)
        torch.cuda.synchronize()
        return out.cpu().numpy(), stats, (time.perf_counter() - t0) * 1e3
    if kind in ("pair", "k2"):
        frame = spec[4] if kind == "pair" else main_frame()
        dp, pvec, seed, gbar = pair_inputs(name, spec[2], spec[3], frame,
                                           cam, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = df.diff_fwd_plain(dp, pvec, seed, stats=stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if kind == "k2":
            return out.cpu().numpy(), stats, ms
        t0 = time.perf_counter()
        G = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True)
        torch.cuda.synchronize()
        stats["plain_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        return (out.cpu().numpy(), G.cpu().numpy()), stats, ms
    if kind == "k1":
        _, _, g, integrator = spec
        pk = wf.pack_config(with_g(SCENES[name](), g), cam,
                            dataclasses.replace(cfg, integrator=integrator))
        t0 = time.perf_counter()
        out = wf.render_tile_plain(pk, seed, stats)
    else:
        _, _, sphere, primal, spp = spec
        sc = SCENES[name]()
        gp = gm.pack_geom(sc, cam, cfg.width, cfg.height, spp,
                          sphere=sphere, primal_only=primal,
                          max_bounces=cfg.max_bounces)
        th = gm.flatten_theta(gm.pack_theta(sc, cam, sphere)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gm.geom_fwd_plain(gp, th, seed, stats=stats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out.cpu().numpy(), stats, ms


class PlainPool:
    """The main-frame plain versions, computed ahead in worker processes."""

    def __init__(self, specs: list):
        import multiprocessing
        self.t0 = time.perf_counter()
        self.pool = multiprocessing.get_context("spawn").Pool(PLAIN_WORKERS)
        self.jobs = {spec: self.pool.apply_async(plain_job, (spec,))
                     for spec in dict.fromkeys(specs)}

    def wait(self) -> None:
        """Block until every job is done, then stop the workers."""
        deadline = self.t0 + PLAIN_TIMEOUT_S
        for spec, job in self.jobs.items():
            job.wait(max(0.0, deadline - time.perf_counter()))
            if not job.ready():
                raise TimeoutError(f"plain version {spec}: not done "
                                   f"{PLAIN_TIMEOUT_S} s after the start")
        self.pool.close()
        self.pool.join()
        ms = sorted(j.get()[2] for j in self.jobs.values())
        by_kind = {}
        for spec, job in self.jobs.items():
            by_kind[spec[0]] = by_kind.get(spec[0], 0.0) + job.get()[2] / 1e3
        print(f"plain versions: {len(self.jobs)} main-frame runs in "
              f"{PLAIN_WORKERS} worker processes, "
              f"{time.perf_counter() - self.t0:.1f} s wall (each "
              f"{ms[0] / 1e3:.1f}-{ms[-1] / 1e3:.1f} s, "
              f"{sum(ms) / 1e3:.1f} s in all; by kind "
              f"{ {k: round(v, 1) for k, v in by_kind.items()} })",
              flush=True)

    def get(self, spec: tuple, dev: torch.device) -> tuple:
        """(output on dev, work counters, ms) of one job; a pair job's
        output is (image, per-pixel rows)."""
        out, stats, ms = self.jobs[spec].get()
        if out is None:
            return None, stats, ms
        if isinstance(out, tuple):
            return tuple(torch.from_numpy(o).to(dev) for o in out), stats, ms
        return torch.from_numpy(out).to(dev), stats, ms

    def terminate(self) -> None:
        self.pool.terminate()
        self.pool.join()


def k1_spec(integrator: str, scene: str = "cornell_vpt",
            g: float = 0.0) -> tuple:
    """The spec of K1's plain version under `integrator`, named by the
    first integrator with the same flags (one run serves them all)."""
    flags = wf.KERNEL_INTEGRATORS[integrator]
    first = next(n for n, f in wf.KERNEL_INTEGRATORS.items() if f == flags)
    return ("k1", scene, g, first)


def pair_spec(scene: str = "cornell_vpt", g: float = 0.0,
              traced: tuple = ()) -> tuple:
    return ("k2", scene, g, traced)


GEOM0_SPEC = ("k4", "cornell_vpt", 8, True, MAIN_CFG["spp"])
# phase 9's checks at 64x32x8, 8 bounces: K = 7 (sphere 8 + camera) under
# both samplers and seeds, K = 10 and K = 0 (phase 18's "k4x" jobs)
GEOM9_CHECKS = [("k4x", "cornell_vpt", 0.0, (), k, (64, 32, 8, 8, sampler,
                                                     seed))
                for k, sampler, seed in ((7, "random", 3), (7, "random", 11),
                                         (7, "ld", 3), (7, "ld", 11),
                                         (10, "random", 3), (0, "random", 3))]
GEOM7_SPEC = ("k4", "cornell_vpt", 8, False, 2)       # GEOM_CHECK_SPP


def plain_specs() -> list:
    """The plain runs of phases 4-18."""
    k1 = [k1_spec(integ, sname, g) for _, integ, sname, g in VARIANTS]
    k1 += [k1_spec(integ, sname) for integ, sname in FIELD_VARIANTS]
    return [*geom_ext_specs(), *ext_specs(), k1_spec("explicit_free"),
            pair_spec(), GEOM0_SPEC, GEOM7_SPEC, *GEOM9_CHECKS, *k1, pair_spec("foggy_cornell", 0.0, ("diff_field",)),
            pair_spec("foggy_cornell", 0.5, ("diff_g", "diff_field")),
            pair_spec("cornell_vpt", 0.5), *HG_CHECKS, HG_TRAINER_CHECK,
            *HG_MAIN_CHECKS.values(), *grid_specs(), *FIELD_K1_CHECKS]


# ---- phase 14: analytic density fields (exp_height, blobs) in K1 and the pair

# registers and spill stores ptxas gives the homogeneous instantiations
# without the field code (NVIDIA H100 80GB HBM3, this toolkit): the field
# instantiations must leave them as they were
HOMOGENEOUS_PTXAS = {
    "vpt_wavefront6kernelILb1ELi0ELb0E": (116, 0),   # free + NEE
    "vpt_wavefront6kernelILb1ELi1ELb0E": (119, 0),   # EA + NEE
    "vpt_wavefront6kernelILb0ELi0ELb0E": (61, 0),    # free
    "vpt_wavefront6kernelILb0ELi2ELb0E": (68, 0),    # clamped EA
    "vpt_diff10fwd_kernelILb0ELb0E": (118, 0),       # K2
    "vpt_diff10bwd_kernelILb0ELb0E": (128, 56),      # K3
}
FIELD_SCENES = ("foggy_cornell", "blob_cloud")
# K1's field instantiations against their plain versions at 64x32x8, 8
# bounces: ("fk1", scene, integrator, sampler, seed)
FIELD_K1_CHECKS = [("fk1", name, integrator, sampler, seed)
                   for name in FIELD_SCENES
                   for integrator in ("explicit_free", "explicit_equiangular",
                                      "implicit_free")
                   for sampler in ("random", "ld") for seed in (3, 11)]


def field_k1_pack(spec: tuple, camera) -> wf.Packed:
    _, name, integrator, sampler, _ = spec
    nee, dist, phys = wf.KERNEL_INTEGRATORS[integrator]
    return wf.pack_scene(SCENES[name](), camera, 64, 32, 8, max_bounces=8,
                         sampler=sampler, nee=nee, distance=dist,
                         physical=phys)
# K1's field instantiations: (integrator, its first variant's scene at the
# served frame)
FIELD_VARIANTS = [("explicit_free", "foggy_cornell"),
                  ("explicit_free", "blob_cloud"),
                  ("implicit_free", "foggy_cornell"),
                  ("explicit_equiangular", "foggy_cornell"),
                  ("implicit_equiangular", "foggy_cornell")]


def ptxas_report() -> dict:
    """{mangled kernel name: (registers, spill store bytes, stack bytes)}
    from the build's ptxas -v log."""
    out, cur, stack, spill = {}, None, 0, 0
    for ln in _build.build_log().splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            stack = spill = None
        elif cur and "stack frame" in ln and stack is None:
            w = ln.replace(",", "").split()
            stack = int(w[w.index("bytes") - 1])
            spill = int(w[w.index("spill") - 2])
        elif cur and "Used" in ln and "registers" in ln:
            w = ln.replace(",", "").split()
            out[cur] = (int(w[w.index("registers") - 1]), spill or 0,
                        stack or 0)
            cur = None
    return out


def field_tau_ops(pk: wf.Packed) -> int:
    """f32 operations of one field optical depth (csrc/field.cuh
    field_tau), counted as ops_lower_bound counts: exp_height 13; blobs 59
    per blob (the offset and the two dot products 15, the Gaussian 4, two
    erf_poly of 17 and their arguments 3, the sum 3) + 1."""
    if pk.field.kind == "exp_height":
        return 13
    return 59 * len(pk.field.blobs) + 1


def field_density_ops(pk: wf.Packed) -> int:
    return 3 if pk.field.kind == "exp_height" else 13 * len(pk.field.blobs)


def field_ops_lower_bound(stats: dict, pk: wf.Packed) -> float:
    """The field's operations on top of the homogeneous counts: each
    optical depth in place of one exp(-sigma t) (tau - 1 more), the
    equi-angular densities, each delta-tracking null step (10 + a
    density), exp_height's closed-form inversion (9 more than the
    homogeneous flight per thread-iteration, free flight only) and pLight's
    light direction (7 per shading event with NEE)."""
    tau = field_tau_ops(pk)
    dens = field_density_ops(pk)
    ops = (stats["taus"] * (tau - 1) + stats.get("densities", 0) * dens
           + stats["null_steps"] * (10 + dens))
    if pk.field.kind == "exp_height" and pk.distance == "free":
        ops += stats["thread_iters"] * 9
    if pk.nee:
        ops += stats["shade"] * 7
    return float(ops)


def field_variant_bound(stats: dict, pk: wf.Packed) -> tuple[float, str]:
    ops = variant_ops_lower_bound(stats, pk) + field_ops_lower_bound(stats,
                                                                     pk)
    t_ops = ops / PEAK_F32 * 1e3
    t_bytes = (4.0 + 12.0 * pk.npix) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def field_pair_ops(kernel: str, stats: dict, dp: df.DiffPacked) -> float:
    """ops_lower_bound plus the field's operations: K2 as K1's free-flight
    NEE field terms; K3 replays them, evaluates one more optical depth per
    shading or medium event (the sigma score), and with traced field
    parameters at least one derivative (>= an optical depth's operations)
    per optical depth it evaluates."""
    pk = dp.pk
    ops = ops_lower_bound(kernel, stats, dp) + field_ops_lower_bound(stats,
                                                                     pk)
    if kernel == "diff_bwd":
        events = stats["shade"] + stats["medium"]
        ops += events * field_tau_ops(pk)
        if dp.n_fp:
            ops += (stats["taus"] + events) * field_tau_ops(pk)
    return ops


def field_pair_bound(kernel: str, stats: dict,
                     dp: df.DiffPacked) -> tuple[float, str]:
    t_ops = field_pair_ops(kernel, stats, dp) / PEAK_F32 * 1e3
    t_bytes = bytes_moved(kernel, dp) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def field_phases(card: str, dev: torch.device, camera, cfg,
                 seed_t: torch.Tensor, plains: PlainPool) -> list:
    """Phase 14; returns the field instantiations' kernel records."""
    t14 = time.perf_counter()
    # -- build and registers
    rep = ptxas_report()

    def find(prefix):
        hits = [v for k, v in rep.items() if prefix in k]
        if len(hits) != 1:
            raise AssertionError(f"ptxas reports {len(hits)} kernels for "
                                 f"{prefix}")
        return hits[0]

    for prefix, (regs, spill) in HOMOGENEOUS_PTXAS.items():
        got = find(prefix)
        print(f"phase 14 ptxas homogeneous {prefix}: {got[0]} registers, "
              f"{got[1]} B spill stores, {got[2]} B stack (expected {regs}, "
              f"{spill})", flush=True)
        if got[:2] != (regs, spill):
            raise AssertionError(f"{prefix} changed: {got} against "
                                 f"{(regs, spill)}")
    field_ptxas = {}
    for (nee, dist), entry in wf.FIELD_ENTRIES.items():
        k = {"free": 0, "equiangular": 1, "ea_clamped": 2}[dist]
        field_ptxas[entry] = find(
            f"vpt_wavefront6kernelILb{int(nee)}ELi{k}ELb1E")
    field_ptxas["vpt_diff_fwd_field"] = find("vpt_diff10fwd_kernelILb1ELb0E")
    field_ptxas["vpt_diff_bwd_field"] = find("vpt_diff10bwd_kernelILb1ELb0E")
    for entry, (regs, spill, stack) in field_ptxas.items():
        print(f"phase 14 ptxas {entry}: {regs} registers, {spill} B spill "
              f"stores, {stack} B stack", flush=True)

    # -- K1 at a small frame, bit for bit (the plain versions from the pool)
    scenes = {n: SCENES[n]() for n in FIELD_SCENES}
    t0 = time.perf_counter()
    for spec in FIELD_K1_CHECKS:
        _, name, integrator, sampler, seed = spec
        pk = field_k1_pack(spec, camera)
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        k = wf.render_tile(pk, s)
        p = plains.get(spec, dev)[0]
        if not (bool(torch.equal(k, p)) and bool(torch.isfinite(k).all())):
            raise AssertionError(
                f"K1 field {name} {integrator} {sampler} seed {seed}: not "
                f"bit-equal to the plain version (max abs "
                f"{float((k - p).abs().max())})")
    print(f"phase 14 K1 field check 64x32x8: foggy_cornell and blob_cloud "
          f"under explicit_free, explicit_equiangular, implicit_free, both "
          f"samplers, seeds 3 and 11: all bit-equal to plain "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- K1 at the served frame, through vpt_torch.render
    n_paths = cfg.width * cfg.height * cfg.spp
    k1_rows = {}
    for integrator, name in FIELD_VARIANTS:
        nee, dist, phys = wf.KERNEL_INTEGRATORS[integrator]
        entry = wf.FIELD_ENTRIES[(nee, dist)]
        vcfg = dataclasses.replace(cfg, integrator=integrator)
        reset_counts()
        img = vpt_torch.render(scenes[name], camera, vcfg, device="cuda")
        torch.cuda.synchronize()
        launched = dict(wf.LAUNCHES_BY)
        if launched != {entry: 1}:
            raise AssertionError(f"{name} {integrator}: render launched "
                                 f"{launched}")
        pk = wf.pack_config(scenes[name], camera, vcfg)
        plain, stats, p_ms = plains.get(k1_spec(integrator, name), dev)
        flat = img.reshape(-1, 3)
        equal = bool(torch.equal(flat, plain))
        err = float((flat - plain).abs().max())
        del plain
        if not (equal and bool(torch.isfinite(img).all())):
            raise AssertionError(f"{name} {integrator}: not bit-equal to "
                                 f"the plain version at the served frame "
                                 f"(max abs {err})")
        ms, times = median_ms(lambda: wf.render_tile(pk, seed_t))
        b_ms, b_by = field_variant_bound(stats, pk)
        mean = [round(float(v), 6) for v in img.mean(dim=(0, 1))]
        k1_rows[(integrator, name)] = dict(
            entry=entry, scene=name, integrator=integrator,
            launches=launched[entry], ms=ms, times=times, plain_ms=p_ms,
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by, work=stats,
            paths_per_sec=n_paths / (ms / 1e3), mean=mean)
        print(f"phase 14 {name} {integrator} {cfg.width}x{cfg.height}x"
              f"{cfg.spp} {cfg.sampler} via render: launches {launched}; "
              f"bit-equal to plain ({p_ms:.3f} ms); kernel {ms:.3f} ms "
              f"(median of {times}), {n_paths / (ms / 1e3):.6e} camera "
              f"paths/s; bound {b_ms:.3f} ms ({b_by}); work {stats}; "
              f"channel means {mean} on {card}", flush=True)

    # -- the pair at a small frame
    # the fog without traced field parameters under both samplers; the
    # traced modes under "random" here, and under "ld" at their main-path
    # frames below (the fog falloff at the served frame, the blobs at
    # examples/recover_blobs.py's)
    pair_cases = [("foggy_cornell", {}, "random", 3),
                  ("foggy_cornell", {}, "ld", 11),
                  ("foggy_cornell", {"diff_field": True}, "random", 3),
                  ("blob_cloud", {"diff_blobs": True}, "random", 3)]
    t0 = time.perf_counter()
    for name, kw, sampler, seed in pair_cases:
        sc = scenes[name]
        dp = df.pack_diff(sc, camera, 64, 32, 8, max_bounces=8,
                          sampler=sampler, **kw)
        pvec = df._flatten(df.pack_params(
            sc, with_field="diff_field" in kw,
            with_blobs="diff_blobs" in kw), sc.count).to(dev)
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        gbar = torch.from_numpy(np.random.default_rng(seed)
                                .standard_normal((dp.npix, 3))
                                .astype(np.float32)).to(dev)
        k = df.diff_fwd(dp, pvec, s)
        g = df.diff_bwd(dp, pvec, s, gbar)
        G = df.diff_bwd(dp, pvec, s, gbar, per_lane=True)
        p = df.diff_fwd_plain(dp, pvec, s)
        Gp = df.diff_bwd_plain(dp, pvec, s, gbar, per_lane=True)
        torch.cuda.synchronize()
        over = int(((g - Gp.sum(0)).abs()
                    > GVEC_TOL * Gp.abs().sum(0)).sum())
        equal = bool(torch.equal(k, p))
        rows = float((G == Gp).all(1).float().mean())
        q_lane = lane_q99(G, Gp)
        print(f"phase 14 K2/K3 field check 64x32x8 {name} {kw} "
              f"{sampler} seed {seed}: image bit-equal {equal}, "
              f"per-pixel gradient q99 {q_lane:.3e}, bit-equal rows "
              f"{rows:.4f}, summed entries over bound {over} of {dp.P}",
              flush=True)
        if not (equal and over == 0 and q_lane < Q99_TOL
                and bool(torch.isfinite(G).all())):
            raise AssertionError(f"K2/K3 field {name} {kw} {sampler}: "
                                 f"disagree with their plain versions")
    print(f"phase 14 pair checks {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- the fog pair with the falloff traced at the served frame
    fog = scenes["foggy_cornell"]
    render = df.make_diff_renderer(fog, camera, cfg.width, cfg.height,
                                   cfg.spp, max_bounces=cfg.max_bounces,
                                   sampler=cfg.sampler, diff_field=True,
                                   device="cuda")
    params = {k: v.to(dev).requires_grad_()
              for k, v in df.pack_params(fog, with_field=True).items()}
    reset_counts()
    render(params, cfg.seed).mean().backward()
    torch.cuda.synchronize()
    launched_pair = dict(df.LAUNCHES_BY)
    if launched_pair != {"vpt_diff_fwd_field": 1, "vpt_diff_bwd_field": 1}:
        raise AssertionError(f"fog fwd+bwd launched {launched_pair}")
    if not all(bool(torch.isfinite(v.grad).all()) for v in params.values()):
        raise AssertionError("fog gradient not finite")
    dk = float(params["fog_k"].grad)

    def fwd_bwd():
        for v in params.values():
            v.grad = None
        render(params, cfg.seed).mean().backward()

    pair_ms, pair_times = median_ms(fwd_bwd)
    dp = render.packed
    pvec = df._flatten({k: v.detach() for k, v in params.items()},
                       fog.count)
    gmean = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix), device=dev)
    k2_ms, k2_times = median_ms(lambda: df.diff_fwd(dp, pvec, seed_t))
    k3_ms, k3_times = median_ms(lambda: df.diff_bwd(dp, pvec, seed_t,
                                                    gmean))
    k2 = df.diff_fwd(dp, pvec, seed_t)
    k2p, pstats, k2p_ms = plains.get(
        pair_spec("foggy_cornell", 0.0, ("diff_field",)), dev)
    k2_equal = bool(torch.equal(k2, k2p))
    k2_err = float((k2 - k2p).abs().max())
    del k2p
    dp4 = df.pack_diff(fog, camera, cfg.width, cfg.height, CHECK_SPP,
                       max_bounces=cfg.max_bounces, sampler=cfg.sampler,
                       diff_field=True)
    gbar4 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (dp4.npix, 3)).astype(np.float32)).to(dev)
    k3_4_ms, _ = median_ms(lambda: df.diff_bwd(dp4, pvec, seed_t, gbar4))
    g4 = df.diff_bwd(dp4, pvec, seed_t, gbar4)
    G4p, k3p_ms = cuda_ms(lambda: df.diff_bwd_plain(dp4, pvec, seed_t, gbar4,
                                                    per_lane=True))
    over = int(((g4 - G4p.sum(0)).abs() > GVEC_TOL * G4p.abs().sum(0)).sum())
    k3_err = float((g4 - G4p.sum(0)).abs().max())
    del G4p
    k2_bound, k2_by = field_pair_bound("diff_fwd", pstats, dp)
    k3_bound, k3_by = field_pair_bound("diff_bwd", pstats, dp)
    print(f"phase 14 fog pair (diff_field) {cfg.width}x{cfg.height}x"
          f"{cfg.spp} {cfg.sampler}: launches {launched_pair}; dL/dk "
          f"{dk:.6e}; fwd+bwd {pair_ms:.3f} ms (median of {pair_times}), "
          f"{n_paths / (pair_ms / 1e3):.6e} camera paths/s; K2 {k2_ms:.3f} "
          f"ms ({k2_times}), bit-equal to plain {k2_equal} ({k2p_ms:.3f} "
          f"ms), bound {k2_bound:.3f} ms ({k2_by}); K3 {k3_ms:.3f} ms "
          f"({k3_times}), at {CHECK_SPP} spp {k3_4_ms:.3f} ms against plain "
          f"{k3p_ms:.3f} ms, summed entries over bound {over}, bound "
          f"{k3_bound:.3f} ms ({k3_by}); work {pstats} on {card}",
          flush=True)
    if not (k2_equal and over == 0):
        raise AssertionError("the fog pair disagrees with its plain "
                             "versions at the served frame")

    # -- the trainers at the examples' own settings
    # examples/recover_fog.py --kernel: k 0.12 -> 0.06 from a 128x128
    # target at 256 spp (max_bounces 32), 32 spp per render, lr 4e-3, 100
    # steps, only fog_k kept
    from vpt_torch.media.density import exp_height
    reset_counts()
    t0 = time.perf_counter()
    fcfg = vpt_torch.RenderConfig(width=128, height=128, spp=256,
                                  max_bounces=32, sampler="ld", seed=123)
    target = vpt_torch.render(fog, camera, fcfg, device="cuda")
    wrong = dataclasses.replace(fog, medium=dataclasses.replace(
        fog.medium, density=exp_height(k=0.12, y0=-40.8, majorant=1.01)))
    fitted, losses = vpt_torch.dist.fit_kernel(
        wrong, camera, target, steps=100, spp=32, learning_rate=4e-3,
        sampler="ld", diff_field=True,
        param_filter=lambda upd, init: {**init, "fog_k": upd["fog_k"]},
        device="cuda")
    torch.cuda.synchronize()
    fog_s = time.perf_counter() - t0
    k_rec = float(fitted["fog_k"])
    launched_fog = {**wf.LAUNCHES_BY, **df.LAUNCHES_BY}
    print(f"phase 14 recover_fog (128x128, target 256 spp, 32 spp, lr 4e-3, "
          f"100 steps): k 0.12 -> {k_rec:.6f} (true 0.06, |err| "
          f"{abs(k_rec - 0.06):.6f}); loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}; {fog_s:.3f} s wall; launches {launched_fog} "
          f"on {card}", flush=True)
    if launched_fog.get("vpt_diff_bwd_field") != 200 or \
            not abs(k_rec - 0.06) < 0.006:
        raise AssertionError(f"recover_fog: k {k_rec}, launches "
                             f"{launched_fog}")
    # examples/recover_blobs.py: blob 0 perturbed (cx +6, cy -4, r x1.5,
    # w x0.6); 256x192 target at 256 spp, 32 spp per render, 16 bounces,
    # Adam at 0.15 on the blobs only, 120 steps, seed 1
    from vpt_torch.scene.scene import Medium
    truth = scenes["blob_cloud"]
    reset_counts()
    t0 = time.perf_counter()
    bcfg = vpt_torch.RenderConfig(width=256, height=192, spp=256,
                                  max_bounces=16, sampler="ld", seed=42)
    btarget = vpt_torch.render(truth, camera, bcfg, device="cuda")
    tb = truth.medium.density.params.clone()
    wb = tb.clone()
    wb[0, 0] += 6.0
    wb[0, 1] -= 4.0
    wb[0, 3] *= 1.5
    wb[0, 4] *= 0.6
    bwrong = dataclasses.replace(truth, medium=Medium(
        truth.medium.sigma_a, truth.medium.sigma_s, 0.0,
        dataclasses.replace(truth.medium.density, params=wb)))
    def fit_blobs(steps):
        return vpt_torch.dist.fit_kernel(
            bwrong, camera, btarget, steps=steps, spp=32, max_bounces=16,
            learning_rate=0.15, sampler="ld", diff_blobs=True, seed=1,
            param_filter=lambda upd, init: {**init, "blobs": upd["blobs"]},
            device="cuda")

    bfit, blosses = fit_blobs(120)
    torch.cuda.synchronize()
    blob_s = time.perf_counter() - t0
    launched_blob = {**wf.LAUNCHES_BY, **df.LAUNCHES_BY}
    rec = bfit["blobs"].cpu()
    l1_0 = float((wb[0] - tb[0]).abs().sum())
    l1_1 = float((rec[0] - tb[0]).abs().sum())
    print(f"phase 14 recover_blobs (256x192, target 256 spp, 32 spp, 16 "
          f"bounces, Adam 0.15 on the blobs, 120 steps): blob 0 "
          f"{[round(float(v), 4) for v in wb[0]]} -> "
          f"{[round(float(v), 4) for v in rec[0]]} (true "
          f"{[round(float(v), 4) for v in tb[0]]}); param-error L1 "
          f"{l1_0:.4f} -> {l1_1:.4f} (halved: {l1_1 <= 0.5 * l1_0}); loss "
          f"{blosses[0]:.6g} -> {blosses[-1]:.6g}; {blob_s:.3f} s wall; "
          f"launches {launched_blob} on {card}", flush=True)
    # the example's 120 steps are deterministic on the card (no atomics):
    # the fit must take them through the field kernels and move blob 0
    # toward the truth; the trend beyond them is reported, not held
    if launched_blob.get("vpt_diff_bwd_field") != 240 or \
            not (l1_1 < l1_0 and blosses[-1] < blosses[0]
                 and bool(torch.isfinite(rec).all())):
        raise AssertionError(f"recover_blobs: L1 {l1_0} -> {l1_1}, loss "
                             f"{blosses[0]} -> {blosses[-1]}, launches "
                             f"{launched_blob}")
    # K2/K3 with every blob parameter traced at the shape the trainer gave
    # them (256x192, 32 spp per step: 16 per render, 16 bounces: long
    # paths, the 15 blob slots of K3's accumulator) against their plain
    # versions, at the fit's start (its first render's seed)
    t0 = time.perf_counter()
    bdp = df.pack_diff(bwrong, camera, 256, 192, 16, max_bounces=16,
                       sampler="ld", diff_blobs=True)
    bvec = df._flatten(df.pack_params(bwrong, with_blobs=True),
                       truth.count).to(dev)
    bseed = torch.tensor([2], dtype=torch.int32, device=dev)
    bgbar = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (bdp.npix, 3)).astype(np.float32)).to(dev)
    bk = df.diff_fwd(bdp, bvec, bseed)
    bg = df.diff_bwd(bdp, bvec, bseed, bgbar)
    bG = df.diff_bwd(bdp, bvec, bseed, bgbar, per_lane=True)
    bp_img = df.diff_fwd_plain(bdp, bvec, bseed)
    bGp = df.diff_bwd_plain(bdp, bvec, bseed, bgbar, per_lane=True)
    torch.cuda.synchronize()
    b_equal = bool(torch.equal(bk, bp_img))
    b_over = int(((bg - bGp.sum(0)).abs()
                  > GVEC_TOL * bGp.abs().sum(0)).sum())
    b_q = lane_q99(bG, bGp)
    b_rows = float((bG == bGp).all(1).float().mean())
    print(f"phase 14 K2/K3 blob check at the recover_blobs frame 256x192x16 "
          f"ld, 16 bounces, diff_blobs (n_fp {bdp.n_fp}, P {bdp.P}): image "
          f"bit-equal {b_equal}, per-pixel gradient q99 {b_q:.3e}, bit-equal "
          f"rows {b_rows:.4f}, summed entries over bound {b_over} of "
          f"{bdp.P} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not (b_equal and b_over == 0 and b_q < Q99_TOL
            and bool(torch.isfinite(bG).all())):
        raise AssertionError("K2/K3 with diff_blobs disagree with their "
                             "plain versions at the recover_blobs frame")
    del bG, bGp
    t0 = time.perf_counter()
    l1_long = {}
    for steps in (480,):
        rec_l = fit_blobs(steps)[0]["blobs"].cpu()
        l1_long[steps] = float((rec_l[0] - tb[0]).abs().sum())
    print(f"phase 14 recover_blobs continued with the same settings: "
          f"param-error L1 after {sorted(l1_long.items())} steps; blob 0 "
          f"{[round(float(v), 4) for v in rec_l[0]]} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    # the example's own CPU toy setting (recover_blobs.py --cpu: 32x24,
    # target 32 spp, 8 spp, 20 steps), to set beside vpt's run of it
    ttarget = vpt_torch.render(truth, camera, dataclasses.replace(
        bcfg, width=32, height=24, spp=32), device="cuda")
    trec = vpt_torch.dist.fit_kernel(
        bwrong, camera, ttarget, steps=20, spp=8, max_bounces=16,
        learning_rate=0.15, sampler="ld", diff_blobs=True, seed=1,
        param_filter=lambda upd, init: {**init, "blobs": upd["blobs"]},
        device="cuda")[0]["blobs"].cpu()
    l1_toy = float((trec[0] - tb[0]).abs().sum())
    print(f"phase 14 recover_blobs at the example's --cpu setting (32x24, "
          f"target 32 spp, 8 spp, 20 steps): blob 0 "
          f"{[round(float(v), 4) for v in trec[0]]}, param-error L1 "
          f"{l1_0:.4f} -> {l1_toy:.4f}", flush=True)
    if not bool(torch.isfinite(trec).all()):
        raise AssertionError("recover_blobs toy fit: not finite")
    # blob 0's gradients at the example's frame against common-random-
    # number central differences of the pair's own forward, by vpt's
    # criterion (tests/test_diff_kernel.py:586-612: 16 seeds, |mean grad -
    # mean FD| < 4 sigma + 10 %)
    brender = df.make_diff_renderer(truth, camera, 256, 192, 32,
                                    max_bounces=16, sampler="ld",
                                    diff_blobs=True, device="cuda")
    bp = {k: v.to(dev) for k, v in df.pack_params(
        truth, with_blobs=True).items()}
    fd_rows = []
    for ci, h in ((0, 0.5), (1, 0.5), (3, 0.3), (4, 0.05)):
        gs_, fds = [], []
        for k in range(16):
            p_ = {kk: v.clone().requires_grad_(kk == "blobs")
                  for kk, v in bp.items()}
            brender(p_, 900 + k).mean().backward()
            gs_.append(float(p_["blobs"].grad[0, ci]))
            with torch.no_grad():
                pp = {kk: v.clone() for kk, v in bp.items()}
                pm = {kk: v.clone() for kk, v in bp.items()}
                pp["blobs"][0, ci] += h
                pm["blobs"][0, ci] -= h
                fds.append((float(brender(pp, 900 + k).mean())
                            - float(brender(pm, 900 + k).mean())) / (2 * h))
        gm, gse = float(np.mean(gs_)), float(np.std(gs_) / 4.0)
        fm, fse = float(np.mean(fds)), float(np.std(fds) / 4.0)
        tol = 4.0 * float(np.hypot(gse, fse)) + 0.1 * max(abs(gm), abs(fm))
        fd_rows.append((ci, gm, gse, fm, fse, abs(gm - fm) < tol))
    print(f"phase 14 blob 0 gradients vs CRN FD at 256x192x32 (param, grad "
          f"mean, se, FD mean, se, agree): {fd_rows}", flush=True)
    if not all(r[-1] for r in fd_rows):
        raise AssertionError(f"blob gradients disagree with CRN FD: "
                             f"{fd_rows}")
    print(f"phase 14 {time.perf_counter() - t14:.1f} s", flush=True)

    # -- the records
    common = {"route": "cuda", "library_ms": None, "card": card}
    records = []
    srcs = {"vpt_wavefront_free_nee_field": "wavefront_field.cu",
            "vpt_wavefront_free_implicit_field":
                "wavefront_field_free_implicit.cu",
            "vpt_wavefront_ea_nee_field": "wavefront_field_ea.cu",
            "vpt_wavefront_eac_implicit_field":
                "wavefront_field_eac_implicit.cu"}
    for entry, src in srcs.items():
        rows = [r for r in k1_rows.values() if r["entry"] == entry]
        regs, spill, stack = field_ptxas[entry]
        records.append({
            "name": entry[4:], **common,
            "source": f"vpt_torch/csrc/{src}",
            "replaces": "vpt/kernels/wavefront.py:465",
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": rows[0]["max_abs_err"], "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"], "plain_alone": False,
            "bound_ms": rows[0]["bound_ms"],
            "bound_by": rows[0]["bound_by"], "variants": rows,
            "ptxas": {"registers": regs, "spill_stores": spill,
                      "stack": stack},
            "launches_recover_fog": launched_fog.get(entry, 0),
            "launches_recover_blobs": launched_blob.get(entry, 0)})
    for name, src, ms, p_ms, b_ms, b_by, err, extra in (
            ("diff_fwd_field", "diff_field_fwd.cu", k2_ms, k2p_ms, k2_bound,
             k2_by, k2_err, {"fwd_bwd_ms": pair_ms}),
            ("diff_bwd_field", "diff_field_bwd.cu", k3_ms, k3p_ms, k3_bound,
             k3_by, k3_err, {"checked_spp": CHECK_SPP,
                             "ms_at_checked_spp": k3_4_ms})):
        regs, spill, stack = field_ptxas["vpt_" + name]
        records.append({
            "name": name, **common, "source": f"vpt_torch/csrc/{src}",
            "replaces": ("vpt/kernels/diff.py:1274" if "fwd" in name
                         else "vpt/kernels/diff.py:1303"),
            "launches": launched_pair["vpt_" + name],
            "launches_recover_fog": launched_fog["vpt_" + name],
            "launches_recover_blobs": launched_blob["vpt_" + name],
            "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "plain_alone": "bwd" in name,
            "bound_ms": b_ms, "bound_by": b_by,
            "ptxas": {"registers": regs, "spill_stores": spill,
                      "stack": stack},
            "recover_fog_k": k_rec, "recover_fog_s": fog_s,
            "recover_blobs_l1": [l1_0, l1_1], "recover_blobs_s": blob_s,
            "recover_blobs_l1_by_steps": l1_long,
            "recover_blobs_l1_cpu_setting": l1_toy,
            **extra})
    return records


# ---- phase 15: the HG phase in the pair, the multi-view trainer and the
# recovery examples

# the pair's HG instantiations (kernel <kField, kHG>) and the isotropic
# field ones, whose registers phase 14 reported (NVIDIA H100 80GB HBM3, this
# toolkit): the HG code must leave them as they were
FIELD_PAIR_PTXAS = {
    "vpt_diff10fwd_kernelILb1ELb0E": (121, 0),       # field K2
    "vpt_diff10bwd_kernelILb1ELb0E": (160, 0),       # field K3
}
HG_ENTRIES = {"vpt_diff_fwd_hg": "vpt_diff10fwd_kernelILb0ELb1E",
              "vpt_diff_bwd_hg": "vpt_diff10bwd_kernelILb0ELb1E",
              "vpt_diff_fwd_field_hg": "vpt_diff10fwd_kernelILb1ELb1E",
              "vpt_diff_bwd_field_hg": "vpt_diff10bwd_kernelILb1ELb1E"}
HG_SOURCES = {"vpt_diff_fwd_hg": "diff_hg.cu", "vpt_diff_bwd_hg": "diff_hg.cu",
              "vpt_diff_fwd_field_hg": "diff_field_hg_fwd.cu",
              "vpt_diff_bwd_field_hg": "diff_field_hg_bwd.cu"}
# examples/recover_fog_multiview.py: its four cameras (:73-78), at 192x192;
# phase 15 runs FOG_MV_STEPS of its 2400 steps (the whole fit is
# `python3 chip_smoke.py --recover-fog-multiview 2400`)
FOG_MV_CAMS = [((0.0, 0.0, 0.0), None),
               ((35.0, 30.0, 180.0), (0.0, -10.0, 0.0)),
               ((-38.0, -20.0, 150.0), (10.0, 0.0, -40.0)),
               ((0.0, 25.0, 60.0), (0.0, -10.0, 200.0))]
FOG_MV_STEPS = 600
# K2/K3 against their plain versions: at 64x32x8 (the baked g under both
# samplers, the traced g, the fog with the traced g and falloff; seeds 3 and
# 11), and at recover_fog_multiview's shape (192x192, 16 spp per render, 32
# bounces, "ld": the fog at its truth, g = 0.5, the fit's first seed)
HG_CHECKS = [("pair", name, 0.5, traced, (64, 32, 8, 8, sampler, seed))
             for name, traced, sampler in (
                 ("cornell_vpt", (), "random"), ("cornell_vpt", (), "ld"),
                 ("cornell_vpt", ("diff_g",), "random"),
                 ("foggy_cornell", ("diff_g", "diff_field"), "random"))
             for seed in (3, 11)]
HG_TRAINER_CHECK = ("pair", "foggy_cornell", 0.5, ("diff_g", "diff_field"),
                    (192, 192, 16, 32, "ld", 0))
# and at the main frame with CHECK_SPP samples, as phases 7 and 14 hold the
# isotropic K3s: (label, check) for the two pairs phase 15 times there
HG_MAIN_CHECKS = {
    label: ("pair", name, 0.5, traced,
            (MAIN_CFG["width"], MAIN_CFG["height"], CHECK_SPP,
             MAIN_CFG["max_bounces"], MAIN_CFG["sampler"], 0))
    for label, name, traced in (
        ("homogeneous", "cornell_vpt", ()),
        ("fog", "foggy_cornell", ("diff_g", "diff_field")))}
# K1 (explicit_free) at MAIN_CFG before the HG pair (PERF.md; NVIDIA H100
# 80GB HBM3, 700.00 W)
FREE_MS_BEFORE_HG = 81.565


# HG on top of the pair's counts, as variant_ops_lower_bound counts K1's:
# per medium event 30 for the HG direction and 12 for the phase value; K3
# replays them, and with the traced g adds two dlog_hg_dg of 11 with their
# cosines (5) and the 4 accumulations of the g slot: 36
def hg_pair_bound(kernel: str, stats: dict,
                  dp: df.DiffPacked) -> tuple[float, str]:
    ops = (ops_lower_bound(kernel, stats, dp) if dp.pk.field is None
           else field_pair_ops(kernel, stats, dp))
    extra = 42
    if kernel == "diff_bwd" and dp.hg_mode == df.HG_TRACED:
        extra += 36
    t_ops = (ops + stats["medium"] * extra) / PEAK_F32 * 1e3
    t_bytes = bytes_moved(kernel, dp) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_vs_plain(spec: tuple, plains: PlainPool, camera,
                  dev: torch.device) -> dict:
    """K2 and K3 against their plain versions (a "pair" job of the pool)
    on the same inputs: the image bit for bit, K3's per-pixel rows by
    lane_q99 (and their bit-equal share), the block-summed vector within
    GVEC_TOL of sum |G|."""
    _, name, g_, traced, frame = spec
    w, h, spp, mb, sampler, seed = frame
    dp, pvec, s, gbar = pair_inputs(name, g_, traced, frame, camera, dev)
    k = df.diff_fwd(dp, pvec, s)
    g = df.diff_bwd(dp, pvec, s, gbar)
    G = df.diff_bwd(dp, pvec, s, gbar, per_lane=True)
    (p, Gp), pstats, p_ms = plains.get(spec, dev)
    gp_ms = pstats["plain_bwd_ms"]
    label = (f"{w}x{h}x{spp} {sampler} {mb} bounces {name} g={g_} "
             f"{traced or 'baked'}")
    res = dict(
        equal=bool(torch.equal(k, p)), err=float((k - p).abs().max()),
        rows=float((G == Gp).all(1).float().mean()), q_lane=lane_q99(G, Gp),
        over=int(((g - Gp.sum(0)).abs() > GVEC_TOL * Gp.abs().sum(0)).sum()),
        g_err=float((g - Gp.sum(0)).abs().max()), plain_ms=p_ms,
        plain_bwd_ms=gp_ms, finite=bool(torch.isfinite(G).all()
                                         and torch.isfinite(k).all()))
    res.update(dp=dp, pvec=pvec, seed=s, gbar=gbar)
    print(f"phase 15 K2/K3 check {label} seed {seed}: image bit-equal "
          f"{res['equal']}, per-pixel gradient q99 {res['q_lane']:.3e}, "
          f"bit-equal rows {res['rows']:.4f}, summed entries over bound "
          f"{res['over']} of {dp.P}", flush=True)
    if not (res["equal"] and res["over"] == 0 and res["q_lane"] < Q99_TOL
            and res["finite"]):
        raise AssertionError(f"K2/K3 {label} seed {seed}: disagree with "
                             f"their plain versions")
    return res


def falls(losses: list, frac: float = 0.25) -> tuple:
    """(whether the mean of the last frac of the losses is below that of
    the first, the two means): A/B losses are noisy step to step."""
    n = max(1, int(len(losses) * frac))
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    return last < first, first, last


def recover_fog_multiview(camera, steps: int, card: str) -> dict:
    """examples/recover_fog_multiview.py at its own settings through the
    port: 4 cameras, 192x192 targets at 4096 spp through K1 (foggy_cornell
    at g = 0.5, 32 bounces, "ld", seed 123; divided by the spp once more,
    as the example does), fit_multiview with diff_g + diff_field from
    (0.010, 0.020, g 0, k 0.12), 32 spp, lr 2.5e-3, the materials frozen,
    a Polyak tail of steps / 8."""
    from vpt_torch.media.density import exp_height
    from vpt_torch.scene.camera import look_at
    fog = SCENES["foggy_cornell"]()
    truth = with_g(fog, 0.5)
    cams = [camera if tgt is None else look_at(org, tgt)
            for org, tgt in FOG_MV_CAMS]
    size, tspp = 192, 4096
    reset_counts()
    t0 = time.perf_counter()
    tcfg = vpt_torch.RenderConfig(width=size, height=size, spp=tspp,
                                  max_bounces=32, sampler="ld", seed=123)
    targets = [vpt_torch.render(truth, c, tcfg, device="cuda") / tspp
               for c in cams]
    torch.cuda.synchronize()
    t_targets = time.perf_counter() - t0
    wrong = dataclasses.replace(truth, medium=dataclasses.replace(
        truth.medium, sigma_a=torch.tensor(0.010),
        sigma_s=torch.tensor(0.020), g=torch.tensor(0.0),
        density=exp_height(k=0.12, y0=-40.8, majorant=1.01)))

    def freeze_materials(p, p0):
        out = dict(p)
        for k in ("albedo", "radiance"):
            out[k] = p0[k]
        return out

    t0 = time.perf_counter()
    params, losses = vpt_torch.dist.fit_multiview(
        wrong, cams, targets, steps=steps, spp=32, learning_rate=2.5e-3,
        max_bounces=32, sampler="ld", diff_g=True, diff_field=True,
        param_filter=freeze_materials, polyak_tail=max(steps // 8, 1),
        device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launched = {**wf.LAUNCHES_BY, **df.LAUNCHES_BY}
    rec = {k: float(params[k]) for k in ("sigma_a", "sigma_s", "g", "fog_k")}
    print(f"phase 15 recover_fog_multiview (4 views, 192x192, targets 4096 "
          f"spp in {t_targets:.3f} s, 32 spp, lr 2.5e-3, {steps} steps, "
          f"Polyak tail {max(steps // 8, 1)}): recovered sa "
          f"{rec['sigma_a']:.6f} ss {rec['sigma_s']:.6f} g {rec['g']:.6f} "
          f"k {rec['fog_k']:.6f} (truth 0.004 0.036 0.5 0.06); loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}; {fit_s:.3f} s wall "
          f"({1e3 * fit_s / steps:.3f} ms per step); launches {launched} "
          f"on {card}", flush=True)
    # each step: 4 views x an A and a B render, each K2 then K3
    want = {"vpt_diff_fwd_field_hg": 8 * steps,
            "vpt_diff_bwd_field_hg": 8 * steps,
            "vpt_wavefront_free_nee_field": 4}
    if launched != want or not (all(np.isfinite(list(rec.values())))
                                and np.isfinite(losses).all()
                                and falls(losses)[0]):
        raise AssertionError(f"recover_fog_multiview: launches {launched}, "
                             f"params {rec}, loss {losses[0]} -> "
                             f"{losses[-1]}")
    return dict(steps=steps, recovered=rec, loss=[losses[0], losses[-1]],
                wall_s=fit_s, targets_s=t_targets, launches=launched)


def recover_all(camera, card: str, dev: torch.device) -> dict:
    """examples/recover_all.py --seed 0 --views 2 at its own settings
    through the port: 1024x1024 targets at 64 spp, 16 bounces, "ld", seeds
    99 and 77 (the main and the close-up view); 3 rounds of block
    coordinate descent: the material block through
    make_multiview_train_step (sigma at exponential_decay(1.5e-3 dec, 25,
    0.7), albedo at 2.5e-2, radiance frozen: per-leaf groups; 80, 40, 40
    steps at 16 spp; only sphere 6's albedo kept), then the geometry block
    through fit_geom_fd (light 8's centre, exponential_decay(max(0.5 dec,
    0.3), 25, 0.85); 120, 60, 60 steps at 16 spp), dec = 0.5^round."""
    from vpt_torch.dist.train_fast import adam, exponential_decay
    from vpt_torch.scene.camera import look_at
    W = H = 1024
    spp_t, spp_m, spp_g, n_m, n_g = 64, 16, 16, 80, 60
    LIGHT, SPHERE, SEED = 8, 6, 0
    truth = vpt_torch.cornell_vpt()
    t0 = time.perf_counter()
    tcfg = vpt_torch.RenderConfig(width=W, height=H, spp=spp_t,
                                  max_bounces=16, sampler="ld", seed=99 + SEED)
    reset_counts()
    target = vpt_torch.render(truth, camera, tcfg, device="cuda")
    sc_c = truth.center[SPHERE].double().numpy()
    cam2 = look_at(tuple(sc_c + np.asarray([-20.0, 18.0, 50.0])),
                   tuple(sc_c))
    target2 = vpt_torch.render(truth, cam2, dataclasses.replace(
        tcfg, seed=77 + SEED), device="cuda")
    est = dataclasses.replace(truth, medium=dataclasses.replace(
        truth.medium, sigma_a=torch.tensor(0.003),
        sigma_s=torch.tensor(0.025)))
    albedo = est.albedo.clone()
    albedo[SPHERE] = torch.tensor([0.5, 0.5, 0.35])
    center = est.center.clone()
    center[LIGHT, 1] += 8.0
    est = dataclasses.replace(est, albedo=albedo, center=center)
    tgt_flat = torch.stack([target.reshape(-1, 3), target2.reshape(-1, 3)])
    log = []

    def matl_block(r, steps, dec):
        sched = exponential_decay(1.5e-3 * dec, 25, 0.7)
        params = {k: v.to(dev).requires_grad_()
                  for k, v in df.pack_params(est).items()}
        opt = adam(params, {"sigma_a": sched, "sigma_s": sched,
                            "albedo": 2.5e-2})
        step = vpt_torch.dist.make_multiview_train_step(
            est, [camera, cam2], W, H, spp_m, opt, max_bounces=16,
            sampler="ld", log_medium=False, device="cuda")
        alb0 = params["albedo"].detach().clone()
        losses = []
        for i in range(steps):
            losses.append(step(params, tgt_flat, None,
                               10000 * SEED + 2000 * r + i))
            with torch.no_grad():       # only sphere 6's albedo is unknown
                keep = params["albedo"][SPHERE].clone()
                params["albedo"].copy_(alb0)
                params["albedo"][SPHERE] = keep
        losses = [float(v) for v in losses]
        alb = est.albedo.clone()
        alb[SPHERE] = params["albedo"][SPHERE].detach().cpu()
        return dataclasses.replace(
            est, medium=dataclasses.replace(
                est.medium, sigma_a=params["sigma_a"].detach().cpu(),
                sigma_s=params["sigma_s"].detach().cpu()),
            albedo=alb), losses

    def geom_filter(th, init):
        out = dict(init)
        out["center"] = th["center"]
        return out

    def geom_block(r, steps, dec):
        theta, losses = vpt_torch.dist.fit_geom_fd(
            est, camera, target, sphere=LIGHT, cam_grads=False, sigma=False,
            steps=steps, spp=spp_g,
            learning_rate=exponential_decay(max(0.5 * dec, 0.3), 25, 0.85),
            max_bounces=16, sampler="ld", seed=100 + 17 * SEED + r,
            param_filter=geom_filter, device="cuda")
        c = est.center.clone()
        c[LIGHT] = theta["center"].detach().cpu()
        return dataclasses.replace(est, center=c), losses

    def report(tag, t_block):
        c_err = float((est.center[LIGHT] - truth.center[LIGHT]).norm())
        a = [round(float(v), 4) for v in est.albedo[SPHERE]]
        log.append((tag, float(est.medium.sigma_a),
                    float(est.medium.sigma_s), a, c_err, t_block))
        print(f"phase 15 recover_all [{tag}] sigma_a "
              f"{float(est.medium.sigma_a):.5f} sigma_s "
              f"{float(est.medium.sigma_s):.5f} albedo[6] {a} |light dc| "
              f"{c_err:.3f} ({t_block:.3f} s)", flush=True)

    block_losses = []
    for r in range(3):
        dec = 0.5 ** r
        tb = time.perf_counter()
        est, lm = matl_block(r, n_m if r == 0 else n_m // 2, dec)
        torch.cuda.synchronize()
        report(f"round {r + 1} matl", time.perf_counter() - tb)
        tb = time.perf_counter()
        est, lg = geom_block(r, n_g * 2 if r == 0 else n_g, dec)
        torch.cuda.synchronize()
        report(f"round {r + 1} geom", time.perf_counter() - tb)
        block_losses += [lm, lg]
    wall = time.perf_counter() - t0
    launched = {**wf.LAUNCHES_BY, **df.LAUNCHES_BY, "geom_fwd": gm.LAUNCHES}
    sa, ss = float(est.medium.sigma_a), float(est.medium.sigma_s)
    alb = [float(v) for v in est.albedo[SPHERE]]
    light = float((est.center[LIGHT] - truth.center[LIGHT]).norm())
    true_alb = [float(v) for v in truth.albedo[SPHERE]]
    met = {"sigma_a": abs(sa - 0.001) <= 1.2e-3,
           "sigma_s": abs(ss - 0.009) <= 1.3e-3,
           "albedo": all(abs(a - t) <= 0.10 for a, t in zip(alb, true_alb)),
           "light": light <= 5.4}
    print(f"phase 15 recover_all --seed 0 --views 2 (1024x1024): sigma_a "
          f"{sa:.6f} (true 0.001), sigma_s {ss:.6f} (true 0.009), albedo[6] "
          f"{[round(a, 4) for a in alb]} (true {true_alb}), light error "
          f"{light:.4f}; BASELINE.md tolerances met {met}; wall {wall:.3f} "
          f"s; launches {launched} on {card}", flush=True)
    # the losses of each block over its 3 rounds: first and last quarters.
    # The material block's falls as sigma and the albedo approach the
    # truth; the geometry block's CRN-FD loss at 16 spp is the A/B noise
    # (flat within it while the light closes from 8 units), so that block
    # is held to its parameter, the light error, instead
    matl = falls(sum(block_losses[0::2], []))
    geom = falls(sum(block_losses[1::2], []))
    rounds = [(round(falls(b)[1], 6), round(falls(b)[2], 6))
              for b in block_losses]
    print(f"phase 15 recover_all losses (first quarter -> last quarter): "
          f"material {matl[1]:.6g} -> {matl[2]:.6g}, geometry {geom[1]:.6g} "
          f"-> {geom[2]:.6g}; per round {rounds}", flush=True)
    # 3 rounds: 160 material steps of 2 views x (2 K2 + 2 K3), 240
    # geometry steps of 12 K4 launches; the two targets through K1
    want = {"vpt_wavefront_free_nee": 2, "vpt_diff_fwd": 640,
            "vpt_diff_bwd": 640, "geom_fwd": 240 * 12}
    finite = np.isfinite([sa, ss, light, *alb]).all()
    if launched != want or not finite or not (matl[0] and light < 8.0):
        raise AssertionError(f"recover_all: launches {launched}, finite "
                             f"{finite}, material losses {matl}, light "
                             f"error 8 -> {light}")
    return dict(sigma_a=sa, sigma_s=ss, albedo=alb, light_err=light,
                wall_s=wall, met=met, rounds=log, launches=launched)


def hg_phases(card: str, dev: torch.device, camera, cfg,
              seed_t: torch.Tensor, free_ms: float,
              plains: PlainPool) -> list:
    """Phase 15; returns the HG instantiations' kernel records. free_ms:
    phase 12's explicit_free time, set beside FREE_MS_BEFORE_HG."""
    t15 = time.perf_counter()
    print(f"phase 15 explicit_free {free_ms:.3f} ms = "
          f"{100.0 * (free_ms / FREE_MS_BEFORE_HG - 1.0):+.2f} % on the "
          f"{FREE_MS_BEFORE_HG} ms before the HG pair (within 3 %: "
          f"{free_ms <= 1.03 * FREE_MS_BEFORE_HG})", flush=True)
    # -- registers: the new instantiations, and the isotropic ones kept
    rep = ptxas_report()

    def find(name):
        hits = [v for k, v in rep.items() if name in k]
        if len(hits) != 1:
            raise AssertionError(f"ptxas reports {len(hits)} kernels for "
                                 f"{name}")
        return hits[0]

    # (phase 14 holds the homogeneous ones)
    for prefix, (regs, spill) in FIELD_PAIR_PTXAS.items():
        got = find(prefix)
        print(f"phase 15 ptxas isotropic {prefix}: {got[0]} registers, "
              f"{got[1]} B spill stores, {got[2]} B stack (expected {regs}, "
              f"{spill})", flush=True)
        if got[:2] != (regs, spill):
            raise AssertionError(f"{prefix} changed: {got} against "
                                 f"{(regs, spill)}")
    hg_ptxas = {entry: find(fn) for entry, fn in HG_ENTRIES.items()}
    for entry, (regs, spill, stack) in hg_ptxas.items():
        print(f"phase 15 ptxas {entry}: {regs} registers, {spill} B spill "
              f"stores, {stack} B stack", flush=True)

    # -- K2/K3 against their plain versions at 64x32x8
    hg = with_g(vpt_torch.cornell_vpt(), 0.5)
    fog = with_g(SCENES["foggy_cornell"](), 0.5)
    t0 = time.perf_counter()
    for spec in HG_CHECKS:
        pair_vs_plain(spec, plains, camera, dev)
    print(f"phase 15 pair checks 64x32x8 {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- the same at recover_fog_multiview's shape
    t0 = time.perf_counter()
    shape_chk = pair_vs_plain(HG_TRAINER_CHECK, plains, camera, dev)
    fdp, fvec, s0, gb = (shape_chk.pop(k)
                         for k in ("dp", "pvec", "seed", "gbar"))
    shape_k2_ms, _ = median_ms(lambda: df.diff_fwd(fdp, fvec, s0))
    shape_k3_ms, _ = median_ms(lambda: df.diff_bwd(fdp, fvec, s0, gb))
    print(f"phase 15 trainer-shape check {time.perf_counter() - t0:.1f} s; "
          f"K2 {shape_k2_ms:.3f} ms (plain {shape_chk['plain_ms']:.3f}), K3 "
          f"{shape_k3_ms:.3f} ms (plain per-lane "
          f"{shape_chk['plain_bwd_ms']:.3f})", flush=True)

    # -- the two pairs at the main frame: the fog with diff_g + diff_field,
    # the homogeneous one at the baked g; fwd+bwd through
    # make_diff_renderer, K2 and K3 by CUDA events, K2 against its plain
    # version there (whose counters give the bounds' work)
    n_paths = cfg.width * cfg.height * cfg.spp
    timed = {}
    for label, sc, kw, spec in (
            ("fog", fog, dict(diff_g=True, diff_field=True),
             pair_spec("foggy_cornell", 0.5, ("diff_g", "diff_field"))),
            ("homogeneous", hg, {}, pair_spec("cornell_vpt", 0.5))):
        render = df.make_diff_renderer(sc, camera, cfg.width, cfg.height,
                                       cfg.spp, max_bounces=cfg.max_bounces,
                                       sampler=cfg.sampler, device="cuda",
                                       **kw)
        dp = render.packed
        params = {k: v.to(dev).requires_grad_() for k, v in df.pack_params(
            sc, with_g="diff_g" in kw, with_field="diff_field" in kw).items()}
        reset_counts()
        render(params, cfg.seed).mean().backward()
        torch.cuda.synchronize()
        launched = dict(df.LAUNCHES_BY)
        if launched != {dp.entries[0]: 1, dp.entries[1]: 1}:
            raise AssertionError(f"{label} HG fwd+bwd launched {launched}")
        grads = {k: float(v.grad.abs().sum()) for k, v in params.items()}
        if not all(np.isfinite(list(grads.values()))):
            raise AssertionError(f"{label} HG gradient not finite: {grads}")

        def fwd_bwd():
            for v in params.values():
                v.grad = None
            render(params, cfg.seed).mean().backward()

        pair_ms, pair_times = median_ms(fwd_bwd)
        pvec = df._flatten({k: v.detach() for k, v in params.items()},
                           sc.count)
        gmean = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix), device=dev)
        k2_ms, k2_times = median_ms(lambda: df.diff_fwd(dp, pvec, seed_t))
        k3_ms, k3_times = median_ms(lambda: df.diff_bwd(dp, pvec, seed_t,
                                                        gmean))
        k2 = df.diff_fwd(dp, pvec, seed_t)
        k2p, stats, k2p_ms = plains.get(spec, dev)
        equal = bool(torch.equal(k2, k2p))
        err = float((k2 - k2p).abs().max())
        del k2p
        b2 = hg_pair_bound("diff_fwd", stats, dp)
        b3 = hg_pair_bound("diff_bwd", stats, dp)
        timed[label] = dict(
            entries=dp.entries, launches=launched, pair_ms=pair_ms,
            k2_ms=k2_ms, k3_ms=k3_ms, k2_plain_ms=k2p_ms, k2_err=err,
            bound=(b2, b3), work=stats, grads=grads,
            paths_per_sec=n_paths / (pair_ms / 1e3))
        print(f"phase 15 {label} HG pair {kw or 'baked g=0.5'} "
              f"{cfg.width}x{cfg.height}x{cfg.spp} {cfg.sampler}: launches "
              f"{launched}; |grad| sums {grads}; fwd+bwd {pair_ms:.3f} ms "
              f"(median of {pair_times}), {n_paths / (pair_ms / 1e3):.6e} "
              f"camera paths/s; K2 {k2_ms:.3f} ms ({k2_times}), bit-equal to "
              f"plain {equal} ({k2p_ms:.3f} ms), bound {b2[0]:.3f} ms "
              f"({b2[1]}); K3 {k3_ms:.3f} ms ({k3_times}), bound "
              f"{b3[0]:.3f} ms ({b3[1]}); work {stats} on {card}",
              flush=True)
        if not equal:
            raise AssertionError(f"{label} HG K2 is not bit-equal to its "
                                 f"plain version at the main frame")
        # K3 against its plain version at the main frame, CHECK_SPP samples
        chk = pair_vs_plain(HG_MAIN_CHECKS[label], plains, camera, dev)
        k3c_ms, k3c_times = median_ms(lambda: df.diff_bwd(
            chk["dp"], chk["pvec"], chk["seed"], chk["gbar"]))
        print(f"phase 15 {label} HG K3 at {cfg.width}x{cfg.height}x"
              f"{CHECK_SPP}: kernel {k3c_ms:.3f} ms (median of {k3c_times}),"
              f" plain per-lane {chk['plain_bwd_ms']:.3f} ms", flush=True)
        for key in ("dp", "pvec", "seed", "gbar"):
            del chk[key]
        timed[label].update(check=chk, k3_check_ms=k3c_ms)

    # -- the examples at their own settings
    # examples/recover_sigma.py: 256x256, a target at 512 spp (16 bounces,
    # seed 99), sigma_s x 2.78, 200 fit_kernel steps at 32 spp, lr 1.5e-3
    scene = vpt_torch.cornell_vpt()
    reset_counts()
    t0 = time.perf_counter()
    starget = vpt_torch.render(scene, camera, vpt_torch.RenderConfig(
        width=256, height=256, spp=512, max_bounces=16, seed=99),
        device="cuda")
    swrong = dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, sigma_s=scene.medium.sigma_s * 2.78))
    sfit, slosses = vpt_torch.dist.fit_kernel(
        swrong, camera, starget, steps=200, spp=32, learning_rate=1.5e-3,
        max_bounces=16, device="cuda")
    torch.cuda.synchronize()
    sigma_s_time = time.perf_counter() - t0
    launched_sigma = {**wf.LAUNCHES_BY, **df.LAUNCHES_BY}
    ss0, ss1 = float(swrong.medium.sigma_s), float(sfit["sigma_s"])
    print(f"phase 15 recover_sigma (256x256, target 512 spp, 32 spp, 200 "
          f"steps, lr 1.5e-3): sigma_s start {ss0:.5f} true 0.00900 "
          f"recovered {ss1:.5f} (|err| {abs(ss1 - 0.009):.5f}); loss "
          f"{slosses[0]:.6g} -> {slosses[-1]:.6g}; {sigma_s_time:.3f} s "
          f"wall; launches {launched_sigma} on {card}", flush=True)
    if launched_sigma != {"vpt_wavefront_free_nee": 1, "vpt_diff_fwd": 400,
                          "vpt_diff_bwd": 400} or not (
            np.isfinite(slosses).all() and falls(slosses)[0]
            and abs(ss1 - 0.009) < abs(ss0 - 0.009)):
        raise AssertionError(f"recover_sigma: sigma_s {ss0} -> {ss1}, "
                             f"launches {launched_sigma}")
    flagship = recover_all(camera, card, dev)
    fog_mv = recover_fog_multiview(camera, FOG_MV_STEPS, card)
    print(f"phase 15 {time.perf_counter() - t15:.1f} s", flush=True)

    # -- the records
    common = {"route": "cuda", "library_ms": None, "card": card}
    records = []
    for label, k in (("homogeneous", 0), ("fog", 1)):
        row = timed[label]
        for j, kernel in enumerate(("diff_fwd", "diff_bwd")):
            entry = row["entries"][j]
            regs, spill, stack = hg_ptxas[entry]
            rec = {
                "name": entry[4:], **common,
                "source": f"vpt_torch/csrc/{HG_SOURCES[entry]}",
                "replaces": ("vpt/kernels/diff.py:1274" if j == 0
                             else "vpt/kernels/diff.py:1303"),
                "launches": row["launches"][entry],
                "ms": row["k2_ms"] if j == 0 else row["k3_ms"],
                "bound_ms": row["bound"][j][0],
                "bound_by": row["bound"][j][1],
                "fwd_bwd_ms": row["pair_ms"], "work": row["work"],
                "ptxas": {"registers": regs, "spill_stores": spill,
                          "stack": stack},
                "mode": "diff_g + diff_field" if k else "baked g = 0.5"}
            if j == 0:
                rec.update(max_abs_err=row["k2_err"],
                           plain_ms=row["k2_plain_ms"])
            else:
                # K3 and its plain version at the main frame, CHECK_SPP
                # samples; at the trainer's shape beside (fog)
                chk = row["check"]
                rec.update(max_abs_err=chk["g_err"],
                           per_pixel_q99_rel_err=chk["q_lane"],
                           plain_ms=chk["plain_bwd_ms"],
                           checked_spp=CHECK_SPP,
                           ms_at_checked_spp=row["k3_check_ms"])
                if k:
                    rec.update(trainer_shape_192x192x16={
                        "max_abs_err": shape_chk["g_err"],
                        "per_pixel_q99_rel_err": shape_chk["q_lane"],
                        "ms": shape_k3_ms,
                        "plain_ms": shape_chk["plain_bwd_ms"]})
            rec.update(plain_alone=False)
            if k:
                rec.update(launches_recover_fog_multiview=fog_mv[
                    "launches"].get(entry, 0),
                    recover_fog_multiview=fog_mv,
                    trainer_shape_k2_ms=shape_k2_ms)
            records.append(rec)
    records[0].update(recover_all=flagship)
    return records


# ---- phase 16: voxel grids in K1 and the pair, fit_grid, recover_grid

# the grid instantiations' kernels (mangled-name fragments) and sources
GRID_K1 = {integ: (wf.GRID_ENTRIES[wf.KERNEL_INTEGRATORS[integ][:2]],
                   f"vpt_wavefront11grid_kernelILb{int(nee)}ELi{k}EE", src)
           for integ, nee, k, src in (
               ("explicit_free", True, 0, "wavefront_grid.cu"),
               ("implicit_free", False, 0, "wavefront_grid_free_implicit.cu"),
               ("explicit_equiangular", True, 1, "wavefront_grid_ea.cu"),
               ("implicit_equiangular", False, 2,
                "wavefront_grid_eac_implicit.cu"))}
GRID_PAIR = {"vpt_diff_fwd_grid": ("vpt_diff15grid_fwd_kernelILi2EE",
                                   "diff_grid_fwd.cu",
                                   "vpt/kernels/diff.py:1274"),
             "vpt_diff_bwd_grid": ("vpt_diff15grid_bwd_kernelILi2EE",
                                   "diff_grid_bwd.cu",
                                   "vpt/kernels/diff.py:1303")}
# ptxas of the 22 kernels of the 21 sources before the grid (registers,
# spill stores, stack; the parent's sources built beside these on NVIDIA
# H100 80GB HBM3, this toolkit): the grid must leave them as they were
EXISTING_PTXAS = {
    "_ZN13vpt_wavefront6kernelILb0ELi0ELb0EEEv9VptParamsPKiS3_iiPf":
        (61, 0, 56),
    "_ZN13vpt_wavefront6kernelILb0ELi0ELb1EEEv9VptParamsPKiS3_iiPf":
        (64, 16, 72),
    "_ZN13vpt_wavefront6kernelILb0ELi2ELb0EEEv9VptParamsPKiS3_iiPf":
        (68, 0, 56),
    "_ZN13vpt_wavefront6kernelILb0ELi2ELb1EEEv9VptParamsPKiS3_iiPf":
        (56, 108, 112),
    "_ZN13vpt_wavefront6kernelILb1ELi0ELb0EEEv9VptParamsPKiS3_iiPf":
        (116, 0, 56),
    "_ZN13vpt_wavefront6kernelILb1ELi0ELb1EEEv9VptParamsPKiS3_iiPf":
        (115, 0, 56),
    "_ZN13vpt_wavefront6kernelILb1ELi1ELb0EEEv9VptParamsPKiS3_iiPf":
        (119, 0, 56),
    "_ZN13vpt_wavefront6kernelILb1ELi1ELb1EEEv9VptParamsPKiS3_iiPf":
        (119, 0, 56),
    "_ZN3vpt4geom15vpt_geom_kernelILi0EEEv10GeomParamsPKfPKiiiPf":
        (128, 0, 32),
    "_ZN3vpt4geom15vpt_geom_kernelILi10EEEv10GeomParamsPKfPKiiiPf":
        (255, 5080, 2296),
    "_ZN3vpt4geom15vpt_geom_kernelILi3EEEv10GeomParamsPKfPKiiiPf":
        (255, 320, 320),
    "_ZN3vpt4geom15vpt_geom_kernelILi4EEEv10GeomParamsPKfPKiiiPf":
        (255, 1104, 592),
    "_ZN3vpt4geom15vpt_geom_kernelILi6EEEv10GeomParamsPKfPKiiiPf":
        (255, 2296, 1144),
    "_ZN3vpt4geom15vpt_geom_kernelILi7EEEv10GeomParamsPKfPKiiiPf":
        (255, 2908, 1440),
    "_ZN8vpt_diff10bwd_kernelILb0ELb0EEEv10DiffParamsPKfPKiS3_PfS6_":
        (128, 56, 1456),
    "_ZN8vpt_diff10bwd_kernelILb0ELb1EEEv10DiffParamsPKfPKiS3_PfS6_":
        (149, 0, 1440),
    "_ZN8vpt_diff10bwd_kernelILb1ELb0EEEv10DiffParamsPKfPKiS3_PfS6_":
        (160, 0, 5248),
    "_ZN8vpt_diff10bwd_kernelILb1ELb1EEEv10DiffParamsPKfPKiS3_PfS6_":
        (165, 0, 5280),
    "_ZN8vpt_diff10fwd_kernelILb0ELb0EEEv10DiffParamsPKfPKiPf":
        (118, 0, 32),
    "_ZN8vpt_diff10fwd_kernelILb0ELb1EEEv10DiffParamsPKfPKiPf":
        (96, 140, 152),
    "_ZN8vpt_diff10fwd_kernelILb1ELb0EEEv10DiffParamsPKfPKiPf":
        (121, 0, 32),
    "_ZN8vpt_diff10fwd_kernelILb1ELb1EEEv10DiffParamsPKfPKiPf":
        (96, 196, 160),
}
# the checks: grid_cloud (tests/test_diff_kernel.py: blob_cloud on an 8^3
# grid, n_march 8) at 64x32x8, both interpolants and samplers, seed 3; and
# examples/recover_grid.py's training shape (128x96x8, 8 bounces, "ld") on
# its 16^3 truth
GRID_FRAME = (64, 32, 8, 8)
GRID_TRAIN_FRAME = (128, 96, 8, 8, "ld", 0)
# the work counters of the timed frames come from the plain versions at
# this smaller frame, scaled by the paths (the plain versions run a march
# per event: far slower than K1's at the main frame)
GRID_COUNT_FRAME = (128, 128, 8)
# vpt's recorded round-4 run of examples/recover_grid.py --steps 250 --spp
# 16 --reg-l1 2e-2 (BASELINE.md:704-716, a TPU v5e): MAE 0.223 -> 0.138,
# corr 0.76; the port is held to corr >= 0.70 and MAE <= 0.16
RG_ROUND4 = dict(steps=250, spp=16, reg_l1=2e-2)
# examples/recover_grid.py's cameras (:108-119) after the default one
RG_CAMS = [((150, 30, 170), (0, 0, 170)), ((-140, -20, 175), (0, 0, 170)),
           ((80, 90, 120), (0, 0, 170)), ((-90, 70, 240), (0, 0, 170)),
           ((40, -60, 100), (0, 0, 170)), ((5, 160, 172), (0, 0, 172)),
           ((-10, -150, 170), (0, 5, 170)), ((10, 20, 330), (0, 0, 172)),
           ((120, -90, 230), (0, 0, 170)), ((-120, 110, 120), (0, 0, 170)),
           ((60, 140, 250), (0, 0, 170))]


def grid_scene(key: tuple):
    """("cloud", interp): grid_cloud; ("truth", n, interp): recover_grid's
    truth, blob_cloud rasterized onto n^3 voxels over its box (n_march 32,
    majorant 1.3 x the largest value). Returns (scene, truth values)."""
    from vpt_torch.media import density as dfn
    from vpt_torch.scene.scene import Medium
    base = SCENES["blob_cloud"]()
    if key[0] == "cloud":
        n, interp = 8, key[1]
        xs = ys = np.linspace(-40, 40, n)
        zs = np.linspace(130, 220, n)
        pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)
        fld = dataclasses.replace(base.medium.density, params=(
            base.medium.density.params.to(torch.float64)))
        vals = dfn.density(fld, torch.from_numpy(pts)).numpy()
        sx, sz = 80 / (n - 1), 90 / (n - 1)
        f = dataclasses.replace(dfn.grid(
            vals, origin=(-40 - sx / 2, -40 - sx / 2, 130 - sz / 2),
            spacing=(sx, sx, sz), transport_interp=interp), n_march=8)
    else:
        _, n, interp = key
        xs, ys, zs = (np.linspace(-28, 28, n), np.linspace(-18, 24, n),
                      np.linspace(150, 195, n))
        pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)
        vals = dfn.density(base.medium.density, torch.from_numpy(
            pts.astype(np.float32))).numpy()
        sp = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
        org = (xs[0] - sp[0] / 2, ys[0] - sp[1] / 2, zs[0] - sp[2] / 2)
        f = dfn.grid(vals, origin=org, spacing=sp,
                     majorant=float(vals.max()) * 1.3,
                     transport_interp=interp)
    return dataclasses.replace(base, medium=Medium(
        base.medium.sigma_a, base.medium.sigma_s, 0.0, f)), vals


def grid_k1_spec(key: tuple, integrator: str, frame: tuple) -> tuple:
    return ("gk1", key, integrator, frame)


def grid_pair_spec(key: tuple, diff_grid: bool, frame: tuple) -> tuple:
    return ("gpair", key, diff_grid, frame)


def grid_pair_inputs(key, diff_grid, frame, camera, dev) -> tuple:
    """(packed, P-vector, table, seed, cotangent) of the grid pair."""
    w, h, spp, mb, sampler, s = frame
    sc, _ = grid_scene(key)
    dp = df.pack_diff(sc, camera, w, h, spp, max_bounces=mb, sampler=sampler,
                      diff_grid=diff_grid)
    params = df.pack_params(sc, with_grid=diff_grid)
    pvec = df._flatten(params, sc.count).to(dev)
    tab = (dp.pk.table(dev) if not diff_grid
           else vpt_torch.kernels.prims.grid_table(params["grid"].to(dev)))
    seed = torch.tensor([s], dtype=torch.int32, device=dev)
    gbar = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (dp.npix, 3)).astype(np.float32)).to(dev)
    return dp, pvec, tab, seed, gbar


def grid_plain_job(spec: tuple, dev, camera) -> tuple:
    """A "gk1" or "gpair" job of plain_job: K1's image and work counters,
    or the pair's image, per-pixel rows (with diff_grid the voxel gradient
    and its terms' absolute sums), K2's counters."""
    kind, key = spec[:2]
    stats = {}
    if kind == "gk1":
        integrator, (w, h, spp, mb, sampler, s) = spec[2:]
        nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
        pk = wf.pack_scene(grid_scene(key)[0], camera, w, h, spp,
                           max_bounces=mb, sampler=sampler, nee=nee,
                           distance=distance, physical=physical)
        seed = torch.tensor([s], dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wf.render_tile_plain(pk, seed, stats)
        torch.cuda.synchronize()
        return out.cpu().numpy(), stats, (time.perf_counter() - t0) * 1e3
    dg, frame = spec[2:]
    dp, pvec, tab, seed, gbar = grid_pair_inputs(key, dg, frame, camera, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = df.diff_fwd_plain(dp, pvec, seed, stats=stats, tab=tab)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True, tab=tab,
                            voxel_abs=True)
    torch.cuda.synchronize()
    stats["plain_bwd_ms"] = (time.perf_counter() - t0) * 1e3
    G = out[0] if dg else out
    rest = tuple(o.cpu().numpy() for o in out[1:]) if dg else ()
    return (img.cpu().numpy(), G.cpu().numpy(), *rest), stats, ms


def grid_counter_frame() -> tuple:
    w, h, spp = GRID_COUNT_FRAME
    return (w, h, spp, MAIN_CFG["max_bounces"], MAIN_CFG["sampler"], 0)


GRID_TIMED = [(("truth", 32, "nearest"), "explicit_free"),
              (("truth", 16, "tri"), "explicit_free"),
              (("truth", 16, "tri"), "implicit_free"),
              (("truth", 16, "tri"), "explicit_equiangular"),
              (("truth", 16, "tri"), "implicit_equiangular")]


def grid_specs() -> list:
    """Phase 16's plain runs."""
    checks = [grid_k1_spec(("cloud", interp), integ,
                           (*GRID_FRAME, sampler, 3))
              for interp in ("tri", "nearest") for integ in GRID_K1
              for sampler in ("ld", "random")]
    checks += [grid_pair_spec(("cloud", interp), dg,
                              (*GRID_FRAME, sampler, 3))
               for interp in ("tri", "nearest") for sampler in ("ld", "random")
               for dg in (False, True)]
    checks += [grid_k1_spec(("truth", 16, "tri"), "explicit_free",
                            GRID_TRAIN_FRAME),
               grid_pair_spec(("truth", 16, "tri"), True, GRID_TRAIN_FRAME)]
    counters = [grid_k1_spec(key, integ, grid_counter_frame())
                for key, integ in GRID_TIMED]
    counters.append(grid_pair_spec(("truth", 16, "tri"), True,
                                   grid_counter_frame()))
    return checks + counters


def grid_march_ops(pk: wf.Packed) -> int:
    """f32 operations of one march of the transport model (csrc/grid.cuh),
    counted as ops_lower_bound counts: the window 34, then per segment
    (and the head and the tail) its start, midpoint and overlap 13 plus a
    density: trilinear 33 (3 lattice coordinates of 4, 7 lerps of 3),
    xy-nearest 15."""
    gc = pk.grid
    return 34 + (gc.n_march + 2) * (13 + (15 if gc.nearest else 33))


def grid_k1_bound(stats: dict, pkc: wf.Packed, pk: wf.Packed,
                  scale: float) -> tuple[float, str]:
    """K1's grid bound from counters taken at another frame (pkc's; scale:
    the ratio of camera paths to pk's): the variant's operations plus a
    march per optical depth the plain version counted; bytes: the seed and
    the table in, pk's image out."""
    ops = (variant_ops_lower_bound(stats, pkc)
           + stats["taus"] * grid_march_ops(pkc)) * scale
    t_ops = ops / PEAK_F32 * 1e3
    t_bytes = (4.0 + 4.0 * int(np.prod(pk.grid.dims))
               + 12.0 * pk.npix) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def grid_pair_bound(kernel: str, stats: dict, dpc: df.DiffPacked,
                    dp: df.DiffPacked, scale: float) -> tuple[float, str]:
    """K2: the pair's operations plus its marches (K2's counters, from a
    plain run on dpc's frame, scaled by `scale` to dp's). K3 with
    diff_grid replays every sample twice (two-phase), so at least twice
    K2's operations; its scatters are not counted. Bytes: K2's or K3's
    inputs and outputs on dp's frame plus the table, and K3's voxel
    gradient."""
    ops = (ops_lower_bound("diff_fwd", stats, dpc)
           + stats["taus"] * grid_march_ops(dpc.pk)) * scale
    if kernel == "diff_bwd":
        ops *= 2.0
    T = int(np.prod(dp.pk.grid.dims))
    by = bytes_moved(kernel, dp) + 4.0 * T * (2 if kernel == "diff_bwd"
                                              else 1)
    t_ops = ops / PEAK_F32 * 1e3
    t_bytes = by / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def voxel_check(gg: torch.Tensor, gp: torch.Tensor,
                gabs: torch.Tensor) -> tuple:
    """(voxels over GVEC_TOL of their sum of |terms|, the largest ratio of
    error to that sum): the kernel's atomics sum the plain version's terms
    in another order. The atomics flush subnormal sums to zero (PTX
    atom.add.f32), so a difference below the smallest normal f32 counts as
    none."""
    err = (gg - gp).abs()
    tiny = torch.finfo(torch.float32).tiny
    over = int((err > GVEC_TOL * gabs + tiny).sum())
    normal = gabs >= tiny
    ratio = float((err[normal] / gabs[normal]).max()) if normal.any() \
        else 0.0
    return over, ratio


def grid_pair_vs_plain(spec, plains, camera, dev) -> dict:
    """K2 and K3 on a grid against their plain versions: the image and
    K3's per-pixel rows bit for bit, the summed vector within GVEC_TOL of
    sum |G|, with diff_grid the voxel gradient per voxel within GVEC_TOL of
    its terms' absolute sum."""
    _, key, dg, frame = spec
    dp, pvec, tab, s, gbar = grid_pair_inputs(key, dg, frame, camera, dev)
    k = df.diff_fwd(dp, pvec, s, tab)
    out = df.diff_bwd(dp, pvec, s, gbar, per_lane=True, tab=tab)
    outs = df.diff_bwd(dp, pvec, s, gbar, tab=tab)
    G, g = (out[0], outs[0]) if dg else (out, outs)
    plain, pstats, p_ms = plains.get(spec, dev)
    p, Gp = plain[:2]
    res = dict(equal=bool(torch.equal(k, p)), err=float((k - p).abs().max()),
               rows=bool(torch.equal(G, Gp)), q_lane=lane_q99(G, Gp),
               over=int(((g - Gp.sum(0)).abs()
                         > GVEC_TOL * Gp.abs().sum(0)).sum()),
               g_err=float((g - Gp.sum(0)).abs().max()), plain_ms=p_ms,
               plain_bwd_ms=pstats["plain_bwd_ms"],
               finite=bool(torch.isfinite(G).all()
                           and torch.isfinite(k).all()))
    label = f"{frame[0]}x{frame[1]}x{frame[2]} {frame[4]} {key}"
    msg = (f"phase 16 K2/K3 grid {label} {'diff_grid' if dg else 'baked'}: "
           f"image bit-equal {res['equal']}, rows bit-equal {res['rows']}, "
           f"summed entries over bound {res['over']} of {dp.P}")
    ok = res["equal"] and res["rows"] and res["over"] == 0 and res["finite"]
    if dg:
        gg1 = out[1]
        gg2 = outs[1]
        over1, r1 = voxel_check(gg1, plain[2], plain[3])
        over2, r2 = voxel_check(gg2, plain[2], plain[3])
        res.update(voxel_over=over1 + over2, voxel_ratio=max(r1, r2),
                   voxel_err=float((gg2 - plain[2]).abs().max()),
                   voxel_finite=bool(torch.isfinite(gg2).all()))
        msg += (f", voxels over {GVEC_TOL} of sum |terms| {over1 + over2} "
                f"(largest err / sum |terms| {max(r1, r2):.3e})")
        ok = ok and over1 + over2 == 0 and res["voxel_finite"]
    print(msg, flush=True)
    if not ok:
        raise AssertionError(f"grid K2/K3 {label}: disagree with their plain "
                             f"versions: {res}")
    res.update(dp=dp, pvec=pvec, tab=tab, seed=s, gbar=gbar)
    return res


def crn_fd(key: tuple, frame: tuple, camera, dev,
           distance: str = "free") -> dict:
    """vpt's test_diff_grid_voxel_grads_match_crn_fd on the card: the
    voxel with the largest |gradient| at seed 11 among those whose value
    exceeds h (v - h must stay a density: on recover_grid's truth the
    largest gradient sits on an almost empty corner voxel, which every ray
    past that corner reads); over 20 seeds the mean of K3's gradient there
    against common-random-number central differences of K2 (h = 0.1):
    |g - f| < 4 hypot(se_g, se_f) + 0.1 max(|g|, |f|)."""
    w, h, spp, mb, sampler = frame
    sc, _ = grid_scene(key)
    render = df.make_diff_renderer(sc, camera, w, h, spp, max_bounces=mb,
                                   sampler=sampler, diff_grid=True,
                                   distance=distance, device="cuda")
    base = {k: v.to(dev) for k, v in df.pack_params(sc, with_grid=True
                                                   ).items()}

    def grad(seed):
        p = dict(base, grid=base["grid"].clone().requires_grad_())
        render(p, seed).mean().backward()
        return p["grid"].grad

    def loss(grid, seed):
        with torch.no_grad():
            return float(render(dict(base, grid=grid), seed).mean())

    hh, K = 0.1, 20
    g0 = grad(11)
    vox = np.unravel_index(int((g0.abs() * (base["grid"] > hh)).argmax()),
                           tuple(g0.shape))
    gs, fds = [], []
    for k in range(K):
        s = 4000 + k
        gs.append(float(grad(s)[vox]))
        pp, pm = base["grid"].clone(), base["grid"].clone()
        pp[vox] += hh
        pm[vox] -= hh
        fds.append((loss(pp, s) - loss(pm, s)) / (2 * hh))
    gm_, gse = float(np.mean(gs)), float(np.std(gs) / np.sqrt(K))
    fm, fse = float(np.mean(fds)), float(np.std(fds) / np.sqrt(K))
    tol = 4.0 * np.hypot(gse, fse) + 0.1 * max(abs(gm_), abs(fm))
    res = dict(distance=distance, voxel=[int(v) for v in vox], grad=gm_,
               grad_se=gse, fd=fm,
               fd_se=fse, tol=float(tol), met=bool(
                   np.isfinite([gm_, fm]).all() and abs(gm_ - fm) < tol))
    print(f"phase {16 if distance == 'free' else 17} CRN FD {distance} "
          f"{w}x{h}x{spp} {sampler} {mb} bounces {key}: "
          f"voxel {res['voxel']}: K3 {gm_:.6g} (se {gse:.3g}) against FD "
          f"{fm:.6g} (se {fse:.3g}), |diff| {abs(gm_ - fm):.4g} < "
          f"{tol:.4g}: {res['met']}", flush=True)
    if not res["met"]:
        raise AssertionError(f"voxel gradient against CRN FD: {res}")
    return res


def recover_grid(camera, card: str, steps: int = 150, spp: int = 8,
                 reg_l1: float = 2e-3, reg_tv: float = 0.0,
                 interp: str = "tri", distance: str = "free") -> dict:
    """examples/recover_grid.py through the port at its defaults (n = 16,
    6 views, 128x96 targets at 64 spp through K1, fit_grid from 0.05
    everywhere: lr 3e-2, L1 2e-3, no TV, trilinear, free flight, seed 7)
    or another steps / spp / reg_l1 / reg_tv / interp / distance (the
    round-4 setting: RG_ROUND4; tomo_quality_study.py's rows B and F:
    --recover-grid-ea)."""
    from vpt_torch.dist.tomography import _grid_scene
    from vpt_torch.scene.camera import look_at
    n, views, res, tspp = 16, 6, 128, 64
    W, H = res, (res * 3) // 4
    truth, vals_true = grid_scene(("truth", n, interp))
    cams = [camera] + [look_at(o, t) for o, t in RG_CAMS][:views - 1]
    reset_counts()
    t0 = time.perf_counter()
    targets = []
    for i, c in enumerate(cams):
        pk = wf.pack_scene(truth, c, W, H, tspp, max_bounces=8, sampler="ld")
        targets.append(wf.render_tile(pk, torch.tensor(
            [100 + i], dtype=torch.int32, device="cuda")).reshape(H, W, 3))
    torch.cuda.synchronize()
    t_targets = time.perf_counter() - t0
    init = np.full((n, n, n), 0.05, np.float32)
    t0 = time.perf_counter()
    rec, losses = vpt_torch.dist.fit_grid(
        _grid_scene(truth, torch.from_numpy(init)), cams, targets,
        steps=steps, spp=spp, learning_rate=3e-2, max_bounces=8, seed=7,
        reg_l1=reg_l1, reg_tv=reg_tv, distance=distance, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**wf.LAUNCHES_BY, **df.LAUNCHES_BY}
    rec = rec.cpu().numpy()
    mae0 = float(np.abs(init - vals_true).mean())
    mae1 = float(np.abs(rec - vals_true).mean())
    corr = float(np.corrcoef(rec.ravel(), vals_true.ravel())[0, 1])
    out = dict(steps=steps, spp=spp, reg_l1=reg_l1, reg_tv=reg_tv,
               interp=interp, distance=distance, loss_first=losses[0],
               loss_last5=float(np.mean(losses[-5:])), mae_init=mae0,
               mae_final=mae1, corr=corr, fit_s=dt, targets_s=t_targets,
               launches=launches, finite=bool(np.isfinite(losses).all()
                                              and np.isfinite(rec).all()))
    print(f"phase {16 if distance == 'free' else 17} recover_grid (n {n}, "
          f"{views} views, {W}x{H}, targets {tspp} spp, {steps} steps at "
          f"{spp} spp, lr 3e-2, L1 {reg_l1}, TV {reg_tv}, {interp}, "
          f"{distance}): loss {losses[0]:.6g} -> {out['loss_last5']:.6g} "
          f"(mean of the last 5); voxel MAE {mae0:.4f} -> {mae1:.4f}, "
          f"corr(recovered, truth) {corr:.3f}; {dt:.3f} s fit, "
          f"{t_targets:.3f} s targets; launches {launches} on {card}",
          flush=True)
    return out


def grid_phases(card: str, dev: torch.device, camera,
                plains: PlainPool) -> list:
    """Phase 16; returns the grid instantiations' kernel records."""
    t16 = time.perf_counter()
    # -- registers: the new instantiations, the existing ones kept
    rep = ptxas_report()
    grid_ptxas = {}
    for name, frag in [*((v[0], v[1]) for v in GRID_K1.values()),
                       *((k, v[0]) for k, v in GRID_PAIR.items())]:
        hits = [v for k, v in rep.items() if frag in k]
        if len(hits) != 1:
            raise AssertionError(f"ptxas reports {len(hits)} kernels for "
                                 f"{frag}")
        grid_ptxas[name] = hits[0]
        print(f"phase 16 ptxas {name}: {hits[0][0]} registers, {hits[0][1]} "
              f"B spill stores, {hits[0][2]} B stack", flush=True)
    changed = {k: (rep.get(k), v) for k, v in EXISTING_PTXAS.items()
               if rep.get(k) != v}
    print(f"phase 16 ptxas of the {len(EXISTING_PTXAS)} kernels from before "
          f"the grid: {'unchanged' if not changed else changed}", flush=True)
    if changed:
        raise AssertionError(f"kernels changed by the grid: {changed}")

    # -- K1's grid instantiations, then K2/K3, against their plain versions
    t0 = time.perf_counter()
    k1_err = dict.fromkeys(GRID_K1, 0.0)
    for spec in grid_specs():
        if spec[0] == "gk1" and spec[3][:3] != GRID_COUNT_FRAME:
            _, key, integ, (w, h, spp, mb, sampler, s) = spec
            nee, distance, physical = wf.KERNEL_INTEGRATORS[integ]
            pk = wf.pack_scene(grid_scene(key)[0], camera, w, h, spp,
                               max_bounces=mb, sampler=sampler, nee=nee,
                               distance=distance, physical=physical)
            k = wf.render_tile(pk, torch.tensor([s], dtype=torch.int32,
                                                device=dev))
            p, _, _ = plains.get(spec, dev)
            equal = bool(torch.equal(k, p))
            k1_err[integ] = max(k1_err[integ], float((k - p).abs().max()))
            print(f"phase 16 K1 grid {integ} {key} {w}x{h}x{spp} {sampler}: "
                  f"bit-equal {equal}, mean {float(k.mean()):.6g}",
                  flush=True)
            if not equal or not bool(torch.isfinite(k).all()):
                raise AssertionError(f"K1 grid {integ} {key} disagrees with "
                                     f"its plain version")
    pair_err = {"vpt_diff_fwd_grid": 0.0, "vpt_diff_bwd_grid": 0.0}
    voxel = dict(over=0, ratio=0.0, err=0.0)
    for spec in grid_specs():
        if spec[0] == "gpair" and spec[3][:3] != GRID_COUNT_FRAME:
            r = grid_pair_vs_plain(spec, plains, camera, dev)
            pair_err["vpt_diff_fwd_grid"] = max(pair_err["vpt_diff_fwd_grid"],
                                                r["err"])
            pair_err["vpt_diff_bwd_grid"] = max(pair_err["vpt_diff_bwd_grid"],
                                                r["g_err"])
            if spec[2]:
                voxel.update(over=voxel["over"] + r["voxel_over"],
                             ratio=max(voxel["ratio"], r["voxel_ratio"]),
                             err=max(voxel["err"], r["voxel_err"]))
    print(f"phase 16 checks {time.perf_counter() - t0:.1f} s", flush=True)

    # -- the voxel gradient against CRN finite differences
    fd = {"test_shape": crn_fd(("cloud", "tri"), (16, 12, 4, 8, "random"),
                               camera, dev),
          "trainer_shape": crn_fd(("truth", 16, "tri"), (128, 96, 8, 8, "ld"),
                                  camera, dev)}

    # -- timings at 1024x1024x64 "ld", default_camera
    cfg = vpt_torch.RenderConfig(**MAIN_CFG)
    n_paths = cfg.width * cfg.height * cfg.spp
    wc, hc, sc_ = GRID_COUNT_FRAME
    scale = n_paths / (wc * hc * sc_)
    seed_t = torch.tensor([cfg.seed], dtype=torch.int32, device=dev)
    timed = {}
    for key, integ in GRID_TIMED:
        scene, _ = grid_scene(key)
        rcfg = dataclasses.replace(cfg, integrator=integ)
        reset_counts()
        img = vpt_torch.render(scene, camera, rcfg, device="cuda")
        torch.cuda.synchronize()
        launched = dict(wf.LAUNCHES_BY)
        entry = GRID_K1[integ][0]
        if launched != {entry: 1} or tuple(img.shape) != (
                cfg.height, cfg.width, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"grid render {integ} {key}: launches "
                                 f"{launched}, shape {tuple(img.shape)}")
        pk = wf.pack_config(scene, camera, rcfg)
        ms, times = median_ms(lambda: wf.render_tile(pk, seed_t))
        cspec = grid_k1_spec(key, integ, grid_counter_frame())
        _, stats, p_ms = plains.get(cspec, dev)
        pkc = wf.pack_scene(scene, camera, wc, hc, sc_,
                            max_bounces=cfg.max_bounces, sampler=cfg.sampler,
                            nee=pk.nee, distance=pk.distance,
                            physical=pk.physical)
        kc_ms, _ = median_ms(lambda: wf.render_tile(pkc, torch.tensor(
            [0], dtype=torch.int32, device=dev)))
        b = grid_k1_bound(stats, pkc, pk, scale)
        timed[(key, integ)] = dict(ms=ms, launches=launched[entry], bound=b,
                                   plain_ms=p_ms, kernel_ms_at_plain=kc_ms,
                                   work=stats)
        print(f"phase 16 K1 grid {integ} {key} {cfg.width}x{cfg.height}x"
              f"{cfg.spp} {cfg.sampler}: {ms:.3f} ms (median of {times}), "
              f"{n_paths / (ms / 1e3):.6e} camera paths/s; bound {b[0]:.3f} "
              f"ms ({b[1]}, counters at {wc}x{hc}x{sc_} x {scale:.0f}); at "
              f"{wc}x{hc}x{sc_} kernel {kc_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"(pooled) on {card}", flush=True)

    key16 = ("truth", 16, "tri")
    scene16, _ = grid_scene(key16)
    render = df.make_diff_renderer(scene16, camera, cfg.width, cfg.height,
                                   cfg.spp, max_bounces=cfg.max_bounces,
                                   sampler=cfg.sampler, diff_grid=True,
                                   device="cuda")
    dp = render.packed
    params = {k: v.to(dev).requires_grad_() for k, v in df.pack_params(
        scene16, with_grid=True).items()}
    reset_counts()
    render(params, cfg.seed).mean().backward()
    torch.cuda.synchronize()
    launched = dict(df.LAUNCHES_BY)
    if launched != {"vpt_diff_fwd_grid": 1, "vpt_diff_bwd_grid": 1} or \
            not bool(torch.isfinite(params["grid"].grad).all()):
        raise AssertionError(f"grid fwd+bwd launched {launched}")
    gsum = float(params["grid"].grad.abs().sum())

    def fwd_bwd():
        for v in params.values():
            v.grad = None
        render(params, cfg.seed).mean().backward()

    # the launch-counted call above is the warm-up (K3 takes seconds here)
    pair_ms, pair_times = median_ms(fwd_bwd, warm_up=False)
    pvec = df._flatten({k: v.detach() for k, v in params.items()},
                       scene16.count)
    tab = vpt_torch.kernels.prims.grid_table(params["grid"].detach())
    gmean = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix), device=dev)
    k2_ms, k2_times = median_ms(lambda: df.diff_fwd(dp, pvec, seed_t, tab))
    k3_ms, k3_times = median_ms(lambda: df.diff_bwd(dp, pvec, seed_t, gmean,
                                                    tab=tab), warm_up=False)
    T = int(np.prod(dp.pk.grid.dims))
    smem = _build.load().vpt_diff_grid_shared_bytes(T)
    mode = (f"shared memory ({smem} B per block, global atomics once per "
            f"block)" if smem else "global atomics")
    cspec = grid_pair_spec(key16, True, grid_counter_frame())
    cplain, cstats, cp_ms = plains.get(cspec, dev)
    dpc, pvc, tabc, sc0, gbc = grid_pair_inputs(key16, True,
                                                grid_counter_frame(), camera,
                                                dev)
    k2c_ms, _ = median_ms(lambda: df.diff_fwd(dpc, pvc, sc0, tabc))
    k3c_ms, _ = median_ms(lambda: df.diff_bwd(dpc, pvc, sc0, gbc, tab=tabc))
    b2 = grid_pair_bound("diff_fwd", cstats, dpc, dp, scale)
    b3 = grid_pair_bound("diff_bwd", cstats, dpc, dp, scale)
    print(f"phase 16 grid pair diff_grid 16^3 tri {cfg.width}x{cfg.height}x"
          f"{cfg.spp} {cfg.sampler}: launches {launched}; |grid grad| sum "
          f"{gsum:.6g}; fwd+bwd {pair_ms:.3f} ms (median of {pair_times}), "
          f"{n_paths / (pair_ms / 1e3):.6e} camera paths/s; K2 {k2_ms:.3f} ms"
          f" ({k2_times}), bound {b2[0]:.3f} ms ({b2[1]}); K3 {k3_ms:.3f} ms "
          f"({k3_times}), bound {b3[0]:.3f} ms ({b3[1]}); voxel scatter: "
          f"{mode}; at {wc}x{hc}x{sc_}: K2 {k2c_ms:.3f} ms (plain "
          f"{cp_ms:.3f}), K3 {k3c_ms:.3f} ms (plain "
          f"{cstats['plain_bwd_ms']:.3f}) on {card}", flush=True)
    del cplain

    # -- examples/recover_grid.py at its defaults (vpt's round-4 setting
    # takes another 80 s: --recover-grid 250)
    rg = recover_grid(camera, card)
    if not (rg["finite"] and rg["mae_final"] < rg["mae_init"]):
        raise AssertionError(f"recover_grid: MAE {rg['mae_init']} -> "
                             f"{rg['mae_final']}")
    print(f"phase 16 {time.perf_counter() - t16:.1f} s", flush=True)

    # -- the records
    common = {"route": "cuda", "library_ms": None, "card": card}
    records = []
    for (key, integ), row in timed.items():
        entry, _, src = GRID_K1[integ]
        regs, spill, stack = grid_ptxas[entry]
        records.append({
            "name": f"{entry[4:]} {key[1]}^3 {key[2]}", **common,
            "source": f"vpt_torch/csrc/{src}",
            "replaces": "vpt/kernels/wavefront.py:756",
            "launches": row["launches"], "max_abs_err": k1_err[integ],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "plain_frame": list(GRID_COUNT_FRAME), "plain_alone": False,
            "ms_at_plain_frame": row["kernel_ms_at_plain"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "work_at_plain_frame": row["work"],
            "ptxas": {"registers": regs, "spill_stores": spill,
                      "stack": stack}})
        if integ == "explicit_free" and key[1] == 16:
            records[-1]["launches_recover_grid"] = rg["launches"].get(entry, 0)
    for j, (entry, (_, src, repl)) in enumerate(GRID_PAIR.items()):
        regs, spill, stack = grid_ptxas[entry]
        rec = {
            "name": f"{entry[4:]} 16^3 tri diff_grid", **common,
            "source": f"vpt_torch/csrc/{src}", "replaces": repl,
            "launches": launched[entry], "max_abs_err": pair_err[entry],
            "ms": k2_ms if j == 0 else k3_ms, "fwd_bwd_ms": pair_ms,
            "plain_ms": cp_ms if j == 0 else cstats["plain_bwd_ms"],
            "plain_frame": list(GRID_COUNT_FRAME), "plain_alone": False,
            "ms_at_plain_frame": k2c_ms if j == 0 else k3c_ms,
            "bound_ms": (b2 if j == 0 else b3)[0],
            "bound_by": (b2 if j == 0 else b3)[1],
            "work_at_plain_frame": cstats,
            "launches_recover_grid": rg["launches"].get(entry, 0),
            "ptxas": {"registers": regs, "spill_stores": spill,
                      "stack": stack}}
        if j == 1:
            rec.update(voxel_scatter=mode, voxel_check=voxel, crn_fd=fd,
                       recover_grid=rg)
        records.append(rec)
    return records


# ---- phase 17: the rest of the pair (the extended instantiations):
# equi-angular, the implicit and physical estimators, shells, HG in a grid

# the extended kernels (mangled-name fragments), their sources and vpt's
# calls they replace
EXT_PAIR = {
    f"vpt_diff_{kind}{sfx}_ext": (
        f"vpt_diff14ext_{kind}_kernelILi{k}EE", f"diff{sfx}_ext_{kind}.cu",
        f"vpt/kernels/diff.py:{1274 if kind == 'fwd' else 1303}")
    for sfx, k in (("", 0), ("_field", 1), ("_grid", 2))
    for kind in ("fwd", "bwd")}
# ptxas of the grid kernels before this phase's sources (NVIDIA H100 80GB
# HBM3, this toolkit; PERF.md section 6): with EXISTING_PTXAS the 28
# kernels of the 27 sources from before the extended instantiations
GRID_PTXAS = {
    "_ZN13vpt_wavefront11grid_kernelILb0ELi0EEEv9VptParamsPKiS3_iiPfPKj":
        (72, 0, 56),
    "_ZN13vpt_wavefront11grid_kernelILb0ELi2EEEv9VptParamsPKiS3_iiPfPKj":
        (72, 16, 72),
    "_ZN13vpt_wavefront11grid_kernelILb1ELi0EEEv9VptParamsPKiS3_iiPfPKj":
        (120, 0, 56),
    "_ZN13vpt_wavefront11grid_kernelILb1ELi1EEEv9VptParamsPKiS3_iiPfPKj":
        (121, 0, 56),
    "_ZN8vpt_diff15grid_bwd_kernelILi2EEEv10DiffParamsPKfPKiS3_PfS6_PKjS6_i":
        (168, 0, 1408),
    "_ZN8vpt_diff15grid_fwd_kernelILi2EEEv10DiffParamsPKfPKiPfPKj":
        (119, 0, 32),
}
EA = (("distance", "equiangular"),)
IMPLICIT = (("nee", False), ("physical", True))
# K2/K3 against their plain versions at 64x32x8, 8 bounces, seed 3: (scene
# key, g, traced flags, estimator); every extended kernel under both
# samplers, each estimator and field kind at least once
EXT_CHECK_CFGS = [
    ("cornell_vpt", 0.0, (), EA, "ld"),
    ("cornell_vpt", 0.5, (), EA, "random"),
    ("cornell_vpt", 0.5, ("diff_g",), EA + IMPLICIT, "ld"),
    ("cornell_vpt", 0.0, (), (("physical", True),), "random"),
    ("medium_shell", 0.0, (), (), "ld"),
    ("medium_shell", 0.0, (), IMPLICIT, "random"),
    ("foggy_cornell", 0.0, ("diff_field",), EA, "ld"),
    ("foggy_cornell", 0.5, ("diff_g", "diff_field"),
     EA + (("physical", True),), "random"),
    ("blob_cloud", 0.0, ("diff_blobs",), EA + IMPLICIT, "ld"),
    (("cloud", "tri"), 0.5, ("diff_grid",), EA, "ld"),
    (("cloud", "nearest"), 0.0, ("diff_grid",), EA + IMPLICIT, "random"),
    (("cloud", "tri"), -0.3, ("diff_grid",), (), "random"),
    (("cloud", "nearest"), 0.0, (), EA, "ld")]
EXT_CHECKS = [("xpair", key, g, tr, est, (64, 32, 8, 8, sampler, 3))
              for key, g, tr, est, sampler in EXT_CHECK_CFGS]
# the EA diff_grid pair at vpt's test shape (grid_cloud, 16x12x4, 8
# bounces, "random": tests/test_diff_kernel.py:528-537, whose K1 agreement
# is 1e-6 absolute), and at recover_grid's training shape on its truth
EXT_VPT_CHECK = ("xpair", ("cloud", "tri"), 0.0, ("diff_grid",), EA,
                 (16, 12, 4, 8, "random", 3))
EXT_TRAINER_CHECK = ("xpair", ("truth", 16, "tri"), 0.0, ("diff_grid",), EA,
                     GRID_TRAIN_FRAME)
# the timed cells at MAIN_CFG (label: scene key, g, traced, estimator);
# their work counters come from the plain versions at EXT_COUNT_FRAME,
# scaled by the paths
EXT_TIMED = {
    "ea": ("cornell_vpt", 0.0, (), EA),
    "explicit_free_physical": ("cornell_vpt", 0.0, (), (("physical", True),)),
    "implicit_free_physical": ("cornell_vpt", 0.0, (), IMPLICIT),
    "fog_ea": ("foggy_cornell", 0.0, ("diff_field",), EA),
    "medium_shell": ("medium_shell", 0.0, (), ()),
    "grid_ea": (("truth", 16, "tri"), 0.0, ("diff_grid",), EA)}
EXT_COUNT_FRAME = (128, 128, 8, 32, "ld", 0)
# a fwd+bwd above this many ms at MAIN_CFG is timed at 512x512x64 instead,
# and one above EXT_ONCE_MS once after its warm-up (the script's budget)
EXT_SLOW_MS = 10000.0
EXT_ONCE_MS = 2000.0
# the research question in gradient form (BASELINE.md:273-289): cornell_vpt
# at 256x256x16, the pair's default sampler, the mean-pixel loss, 40 seeds
# per family; vpt's recorded means and sds (a TPU v5e: a record only)
RQ_FRAME = (256, 256, 16)
RQ_SEEDS = 40
RQ_VPT = {"free": ((-16.893, 0.221), (-7.114, 0.207)),
          "equiangular": ((-16.865, 0.464), (-7.070, 0.272))}
# tools/studies/tomo_quality_study.py rows B and F (16^3, 6 views, 250
# steps, L1 2e-2, TV 1e-2, nearest; free flight, then equi-angular): vpt's
# corr and MAE (BASELINE.md:845-856, a TPU v5e); F is held to corr >= 0.65
# and MAE <= 0.18
RG_ROWS = {"free": (0.753, 0.138), "equiangular": (0.705, 0.159)}
RG_EA_STEPS = 60        # the in-script EA recover_grid at its defaults


def ext_spec(key, g, traced, est, frame) -> tuple:
    return ("xpair", key, g, tuple(traced), tuple(est), frame)


def ext_specs() -> list:
    """Phase 17's plain runs, the longest first: the trainer-shape check,
    the timed cells' counters, the checks."""
    counters = [ext_spec(*cell, EXT_COUNT_FRAME)
                for cell in EXT_TIMED.values()]
    return [EXT_TRAINER_CHECK, *counters[::-1], EXT_VPT_CHECK, *EXT_CHECKS]


def ext_inputs(key, g, traced, est, frame, camera, dev) -> tuple:
    """(packed, P-vector, grid table or None, seed, cotangent) of an
    extended pair."""
    w, h, spp, mb, sampler, s = frame
    sc = grid_scene(key)[0] if isinstance(key, tuple) else SCENES[key]()
    sc = with_g(sc, g)
    kw = dict.fromkeys(traced, True)
    dp = df.pack_diff(sc, camera, w, h, spp, max_bounces=mb,
                      sampler=sampler, **kw, **dict(est))
    params = df.pack_params(sc, with_g="diff_g" in kw,
                            with_field="diff_field" in kw,
                            with_blobs="diff_blobs" in kw,
                            with_grid="diff_grid" in kw)
    pvec = df._flatten(params, sc.count).to(dev)
    tab = None
    if dp.pk.grid is not None:
        tab = vpt_torch.kernels.prims.grid_table(
            params["grid"].to(dev)) if dp.diff_grid else dp.pk.table(dev)
    seed = torch.tensor([s], dtype=torch.int32, device=dev)
    gbar = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (dp.npix, 3)).astype(np.float32)).to(dev)
    return dp, pvec, tab, seed, gbar


def ext_plain_job(spec: tuple, dev, camera) -> tuple:
    """An "xpair" job of plain_job: the image, K3's per-pixel rows (with
    diff_grid the voxel gradient and its terms' absolute sums), K2's
    counters; a counter job (EXT_COUNT_FRAME) returns no output, and with
    diff_grid runs no K3 (its plain time comes from EXT_TRAINER_CHECK)."""
    _, key, g, traced, est, frame = spec
    dp, pvec, tab, seed, gbar = ext_inputs(key, g, traced, est, frame,
                                           camera, dev)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = df.diff_fwd_plain(dp, pvec, seed, stats=stats, tab=tab)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counter = frame == EXT_COUNT_FRAME
    if counter and dp.diff_grid:
        return None, stats, ms
    t0 = time.perf_counter()
    out = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=not counter,
                            tab=tab, voxel_abs=True)
    torch.cuda.synchronize()
    stats["plain_bwd_ms"] = (time.perf_counter() - t0) * 1e3
    if counter:
        return None, stats, ms
    G = out[0] if dp.diff_grid else out
    rest = tuple(o.cpu().numpy() for o in out[1:]) if dp.diff_grid else ()
    return (img.cpu().numpy(), G.cpu().numpy(), *rest), stats, ms


def k1_image(pk: wf.Packed, seed: torch.Tensor) -> torch.Tensor:
    """K1's image of the same estimator: its kernel where it has an
    instantiation, else (equi-angular without NEE) its plain version on
    the card."""
    entries = (wf.KERNEL_ENTRIES if pk.field is None else
               wf.GRID_ENTRIES if pk.grid is not None else wf.FIELD_ENTRIES)
    if (pk.nee, pk.distance) in entries:
        return wf.render_tile(pk, seed)
    return wf.render_tile_plain(pk, seed)


def ext_vs_plain(spec, plains, camera, dev) -> dict:
    """An extended K2/K3 against its plain version: the image and K3's
    rows bit for bit, the block-summed vector within GVEC_TOL of sum |G|,
    the voxel gradient per voxel within GVEC_TOL of its terms' absolute
    sum; and vpt's contract 1: K2's image against K1's of the same
    estimator within 1e-5 of its scale (1e-6 absolute at EXT_VPT_CHECK,
    vpt's own test of the diff_grid equi-angular pair against the baked
    one)."""
    _, key, g, traced, est, frame = spec
    dp, pvec, tab, s, gbar = ext_inputs(key, g, traced, est, frame, camera,
                                        dev)
    k = df.diff_fwd(dp, pvec, s, tab)
    out = df.diff_bwd(dp, pvec, s, gbar, per_lane=True, tab=tab)
    outs = df.diff_bwd(dp, pvec, s, gbar, tab=tab)
    G, gsum = (out[0], outs[0]) if dp.diff_grid else (out, outs)
    plain, pstats, p_ms = plains.get(spec, dev)
    p, Gp = plain[:2]
    k1 = k1_image(dp.pk, s)
    c1_tol = (1e-6 if spec == EXT_VPT_CHECK
              else 1e-5 * max(1.0, float(k1.abs().max())))
    # at the trainer's shape K1 and the pair round sigma differently on
    # enough paths that a few pixels take another discrete branch: there
    # the criterion is the image's q99 (Q99_TOL's form at 1e-5)
    trainer = spec == EXT_TRAINER_CHECK
    res = dict(equal=bool(torch.equal(k, p)), err=float((k - p).abs().max()),
               rows=bool(torch.equal(G, Gp)),
               over=int(((gsum - Gp.sum(0)).abs()
                         > GVEC_TOL * Gp.abs().sum(0)).sum()),
               g_err=float((gsum - Gp.sum(0)).abs().max()),
               k1_err=float((k - k1).abs().max()), k1_tol=c1_tol,
               k1_q99=q99_rel(k, k1),
               plain_ms=p_ms, plain_bwd_ms=pstats["plain_bwd_ms"],
               finite=bool(torch.isfinite(G).all()
                           and torch.isfinite(k).all()))
    w, h, spp, mb, sampler, seed = frame
    label = (f"{w}x{h}x{spp} {sampler} {key} g={g} {'+'.join(traced) or '-'}"
             f" {dict(est) or 'free NEE'}")
    ok = (res["equal"] and res["rows"] and res["over"] == 0 and res["finite"]
          and (res["k1_q99"] <= 1e-5 if trainer else res["k1_err"] <= c1_tol))
    msg = (f"phase 17 K2/K3 {dp.entries[0][13:]} {label}: image bit-equal "
           f"{res['equal']}, rows bit-equal {res['rows']}, summed entries "
           f"over bound {res['over']} of {dp.P}, K2 - K1 {res['k1_err']:.3e}"
           + (f" (q99 of |K2 - K1| / max(1, |K1|max) {res['k1_q99']:.3e} <= "
              f"1e-5)" if trainer else f" (<= {c1_tol:.1e})"))
    if dp.diff_grid:
        over1, r1 = voxel_check(out[1], plain[2], plain[3])
        over2, r2 = voxel_check(outs[1], plain[2], plain[3])
        res.update(voxel_over=over1 + over2, voxel_ratio=max(r1, r2),
                   voxel_finite=bool(torch.isfinite(outs[1]).all()))
        msg += (f", voxels over {GVEC_TOL} of sum |terms| {over1 + over2} "
                f"(largest err / sum |terms| {max(r1, r2):.3e})")
        ok = ok and over1 + over2 == 0 and res["voxel_finite"]
    print(msg, flush=True)
    if not ok:
        raise AssertionError(f"extended K2/K3 {label}: {res}")
    res["entries"] = dp.entries
    return res


def ext_pair_bound(kernel: str, stats: dict, dpc: df.DiffPacked,
                   dp: df.DiffPacked, scale: float) -> tuple[float, str]:
    """The extended pair's bound from counters at EXT_COUNT_FRAME (dpc)
    scaled to dp's frame, counted as ops_lower_bound and
    variant_ops_lower_bound count: per thread-iteration 41 + 23 S (+60
    equi-angular); per sample 29; per shading event 208 + 109 M + 23 S (2 +
    M) with NEE, else 72; per medium event 102 + 23 S with NEE, else 14,
    +8 for the equi-angular weight, +42 with an HG phase; an analytic
    field's optical depths and densities (field_tau_ops,
    field_density_ops), a grid's marches (grid_march_ops) and trilinear
    densities (33); K3 on top as ops_lower_bound (without NEE 3 per
    shading event), with diff_grid twice K2's work (two replays). Bytes:
    bytes_moved, with a grid its table and K3's voxel gradient."""
    pk = dpc.pk
    S, M, E, A = pk.S, len(pk.mis_lights), len(pk.emitters), len(
        dpc.lam_ids)
    ea = dpc.distance == df.DIST_EA
    it, sh, md = stats["thread_iters"], stats["shade"], stats["medium"]
    samples = pk.npix * pk.spp
    ops = (it * (41 + 23 * S + (60 if ea else 0)) + samples * 29
           + sh * ((208 + 109 * M + 23 * S * (2 + M)) if dpc.nee else 72)
           + md * (((102 + 23 * S) if dpc.nee else 14) + (8 if ea else 0)
                   + (42 if dpc.hg_mode != df.HG_NONE else 0)))
    if pk.grid is not None:
        ops += stats["taus"] * grid_march_ops(pk) + (md * 33 if ea else 0)
    elif pk.field is not None:
        ops += stats["taus"] * field_tau_ops(pk) + (
            md * field_density_ops(pk) if ea else 0)
    if kernel == "diff_bwd":
        ops += (it * 9 + sh * ((76 + 39 * M + 3 * E) if dpc.nee else 3)
                + md * 42 + samples * (11 + 9 * A) + pk.npix * 3)
        if dpc.diff_grid:
            ops *= 2.0
    by = bytes_moved(kernel, dp)
    if dp.pk.grid is not None:
        T = int(np.prod(dp.pk.grid.dims))
        by += 4.0 * T * (2 if kernel == "diff_bwd" and dp.diff_grid else 1)
    t_ops = ops * scale / PEAK_F32 * 1e3
    t_bytes = by / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ext_timed(label: str, camera, dev, plains, card: str) -> dict:
    """One timed cell at MAIN_CFG through make_diff_renderer: the launches
    of one render(params, seed).mean().backward() (counts set to 0 just
    before), then fwd+bwd, K2 and K3 timed (median of 3; the
    launch-counted call is the warm-up; a fwd+bwd over EXT_ONCE_MS is
    timed once, and its K3 too); a fwd+bwd over EXT_SLOW_MS is timed at
    512x512x64 instead."""
    key, g, traced, est = EXT_TIMED[label]
    cfg = vpt_torch.RenderConfig(**MAIN_CFG)
    sc = grid_scene(key)[0] if isinstance(key, tuple) else SCENES[key]()
    sc = with_g(sc, g)
    kw = dict.fromkeys(traced, True)
    w, h = cfg.width, cfg.height
    for attempt in range(2):
        render = df.make_diff_renderer(
            sc, camera, w, h, cfg.spp, max_bounces=cfg.max_bounces,
            sampler=cfg.sampler, device="cuda", **kw, **dict(est))
        dp = render.packed
        params = {k: v.to(dev).requires_grad_() for k, v in df.pack_params(
            sc, with_field="diff_field" in kw,
            with_grid="diff_grid" in kw).items()}
        reset_counts()
        _, first_ms = cuda_ms(lambda: render(params, cfg.seed).mean()
                              .backward())
        launched = dict(df.LAUNCHES_BY)
        if launched != {dp.entries[0]: 1, dp.entries[1]: 1} or not all(
                bool(torch.isfinite(v.grad).all()) for v in params.values()):
            raise AssertionError(f"{label} fwd+bwd launched {launched}")
        if first_ms <= EXT_SLOW_MS or attempt:
            break
        w, h = 512, 512
    grads = {k: float(v.grad.abs().sum()) for k, v in params.items()}

    def fwd_bwd():
        for v in params.values():
            v.grad = None
        render(params, cfg.seed).mean().backward()

    n = 1 if first_ms > EXT_ONCE_MS else 3
    pair_ms, pair_times = median_ms(fwd_bwd, n=n, warm_up=False)
    seed_t = torch.tensor([cfg.seed], dtype=torch.int32, device=dev)
    pvec = df._flatten({k: v.detach() for k, v in params.items()}, sc.count)
    tab = (vpt_torch.kernels.prims.grid_table(params["grid"].detach())
           if dp.diff_grid else None)
    gmean = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix), device=dev)
    k2_ms, k2_times = median_ms(lambda: df.diff_fwd(dp, pvec, seed_t, tab))
    k3_ms, k3_times = median_ms(lambda: df.diff_bwd(dp, pvec, seed_t, gmean,
                                                    tab=tab), n=n,
                                warm_up=False)
    cspec = ext_spec(key, g, traced, est, EXT_COUNT_FRAME)
    _, cstats, cp_ms = plains.get(cspec, dev)
    dpc, pvc, tabc, sc0, gbc = ext_inputs(key, g, traced, est,
                                          EXT_COUNT_FRAME, camera, dev)
    k2c_ms, _ = median_ms(lambda: df.diff_fwd(dpc, pvc, sc0, tabc))
    # K3's plain time: at the counters' frame, or with diff_grid at the
    # trainer check's (its plain K3 takes minutes at the counters' frame)
    bframe = EXT_TRAINER_CHECK[5] if dp.diff_grid else EXT_COUNT_FRAME
    if dp.diff_grid:
        dpc3, pvc3, tabc3, s3, gb3 = ext_inputs(key, g, traced, est, bframe,
                                                camera, dev)
        cstats = dict(cstats, plain_bwd_ms=plains.get(
            EXT_TRAINER_CHECK, dev)[1]["plain_bwd_ms"])
    else:
        dpc3, pvc3, tabc3, s3, gb3 = dpc, pvc, tabc, sc0, gbc
    k3c_ms, _ = median_ms(lambda: df.diff_bwd(dpc3, pvc3, s3, gb3,
                                              tab=tabc3))
    n_paths = w * h * cfg.spp
    wc, hc, sc_ = EXT_COUNT_FRAME[:3]
    scale = n_paths / (wc * hc * sc_)
    b2 = ext_pair_bound("diff_fwd", cstats, dpc, dp, scale)
    b3 = ext_pair_bound("diff_bwd", cstats, dpc, dp, scale)
    print(f"phase 17 {label} pair {w}x{h}x{cfg.spp} {cfg.sampler} "
          f"({dp.entries[0]}): launches {launched}; fwd+bwd {pair_ms:.3f} "
          f"ms (median of {pair_times}; first {first_ms:.3f}), "
          f"{n_paths / (pair_ms / 1e3):.6e} camera paths/s; K2 {k2_ms:.3f} "
          f"ms ({k2_times}), bound {b2[0]:.3f} ms ({b2[1]}); K3 "
          f"{k3_ms:.3f} ms ({k3_times}), bound {b3[0]:.3f} ms ({b3[1]}); "
          f"at {wc}x{hc}x{sc_}: K2 {k2c_ms:.3f} ms (plain {cp_ms:.3f}), "
          f"at {bframe[0]}x{bframe[1]}x{bframe[2]}: K3 {k3c_ms:.3f} ms "
          f"(plain {cstats['plain_bwd_ms']:.3f}, pooled);"
          f" |grad| sums {grads} on {card}", flush=True)
    return dict(frame=[w, h, cfg.spp], entries=dp.entries, launches=launched,
                fwd_bwd_ms=pair_ms, k2_ms=k2_ms, k3_ms=k3_ms, bound2=b2,
                bound3=b3, plain_ms=cp_ms, plain_bwd_ms=cstats["plain_bwd_ms"],
                k2_ms_at_plain=k2c_ms, k3_ms_at_plain=k3c_ms,
                k3_plain_frame=list(bframe[:3]), work=cstats)


def gradient_question(camera, dev, card: str) -> dict:
    """BASELINE.md:273-289 on the card: dL/dsigma_a and dL/dsigma_s of the
    mean-pixel loss on cornell_vpt at RQ_FRAME through make_diff_renderer
    (sampler "random", 32 bounces), RQ_SEEDS seeds under free flight and
    under equi-angular; the two families' means must agree by vpt's rule
    (tests/test_diff_kernel.py:113-117)."""
    sc = vpt_torch.cornell_vpt()
    w, h, spp = RQ_FRAME
    out = {}
    reset_counts()
    for dist in ("free", "equiangular"):
        render = df.make_diff_renderer(sc, camera, w, h, spp,
                                       distance=dist, device="cuda")
        base = {k: v.to(dev) for k, v in df.pack_params(sc).items()}
        ga, gs = [], []
        for s in range(RQ_SEEDS):
            p = {k: v.clone().requires_grad_() for k, v in base.items()}
            render(p, 1000 + s).mean().backward()
            ga.append(float(p["sigma_a"].grad))
            gs.append(float(p["sigma_s"].grad))
        out[dist] = {n: (float(np.mean(v)), float(np.std(v)),
                         float(np.std(v) / np.sqrt(len(v))))
                     for n, v in (("sigma_a", ga), ("sigma_s", gs))}
    launched = dict(df.LAUNCHES_BY)
    agree = {}
    for n in ("sigma_a", "sigma_s"):
        (m1, _, se1), (m2, _, se2) = out["free"][n], out["equiangular"][n]
        tol = 4.0 * np.hypot(se1, se2) + 0.05 * max(abs(m1), abs(m2))
        agree[n] = bool(abs(m1 - m2) < tol)
    ratio = {n: out["equiangular"][n][1] / out["free"][n][1]
             for n in ("sigma_a", "sigma_s")}
    res = dict(families=out, agree=agree, sd_ratio=ratio, launches=launched)
    print(f"phase 17 research question in gradient form (cornell_vpt "
          f"{w}x{h}x{spp}, random, {RQ_SEEDS} seeds per family): "
          + "; ".join(f"{d} dL/dsigma_a {out[d]['sigma_a'][0]:.4f} (sd "
                      f"{out[d]['sigma_a'][1]:.4f}), dL/dsigma_s "
                      f"{out[d]['sigma_s'][0]:.4f} (sd "
                      f"{out[d]['sigma_s'][1]:.4f})" for d in out)
          + f"; means agree {agree}; sd ratio EA / free {ratio['sigma_a']:.3f}"
          f" (sigma_a; vpt 2.1), {ratio['sigma_s']:.3f} (sigma_s; vpt 1.3); "
          f"vpt's means -16.893 / -7.114 (free), -16.865 / -7.070 (EA), a "
          f"TPU v5e; launches {launched} on {card}", flush=True)
    if not all(agree.values()):
        raise AssertionError(f"free and EA gradient means disagree: {res}")
    return res


def ext_phases(card: str, dev: torch.device, camera,
               plains: PlainPool) -> list:
    """Phase 17; returns the extended instantiations' kernel records."""
    t17 = time.perf_counter()
    rep = ptxas_report()
    ext_ptxas = {}
    for entry, (frag, _, _) in EXT_PAIR.items():
        hits = [v for k, v in rep.items() if frag in k]
        if len(hits) != 1:
            raise AssertionError(f"ptxas reports {len(hits)} kernels for "
                                 f"{frag}")
        ext_ptxas[entry] = hits[0]
        print(f"phase 17 ptxas {entry}: {hits[0][0]} registers, {hits[0][1]}"
              f" B spill stores, {hits[0][2]} B stack", flush=True)
    held = {**EXISTING_PTXAS, **GRID_PTXAS}
    changed = {k: (rep.get(k), v) for k, v in held.items() if rep.get(k) != v}
    print(f"phase 17 ptxas of the {len(held)} kernels from before the "
          f"extended instantiations: "
          f"{'unchanged' if not changed else changed}", flush=True)
    if changed:
        raise AssertionError(f"kernels changed: {changed}")

    # -- every extended K2/K3 against its plain version and K1
    t0 = time.perf_counter()
    errs = dict.fromkeys(EXT_PAIR, 0.0)
    c1 = {}
    voxel = dict(over=0, ratio=0.0)
    for spec in EXT_CHECKS + [EXT_VPT_CHECK, EXT_TRAINER_CHECK]:
        r = ext_vs_plain(spec, plains, camera, dev)
        fwd, bwd = r["entries"]
        errs[fwd] = max(errs[fwd], r["err"])
        errs[bwd] = max(errs[bwd], r["g_err"])
        c1[fwd] = max(c1.get(fwd, 0.0), r["k1_err"])
        if "voxel_over" in r:
            voxel.update(over=voxel["over"] + r["voxel_over"],
                         ratio=max(voxel["ratio"], r["voxel_ratio"]))
    print(f"phase 17 checks {time.perf_counter() - t0:.1f} s", flush=True)

    # -- the equi-angular voxel gradient against CRN finite differences
    fd = crn_fd(("truth", 16, "tri"), (128, 96, 8, 8, "ld"), camera, dev,
                distance="equiangular")

    # -- timings at MAIN_CFG
    timed = {label: ext_timed(label, camera, dev, plains, card)
             for label in EXT_TIMED}

    # -- the research question, in gradient form and in tomography form
    rq = gradient_question(camera, dev, card)
    rg = recover_grid(camera, card, steps=RG_EA_STEPS, distance="equiangular")
    if not (rg["finite"] and rg["mae_final"] < rg["mae_init"]
            and rg["loss_last5"] < rg["loss_first"]):
        raise AssertionError(f"recover_grid --distance equiangular: {rg}")
    print(f"phase 17 {time.perf_counter() - t17:.1f} s", flush=True)

    # -- the records
    common = {"route": "cuda", "library_ms": None, "card": card}
    rows = {"vpt_diff_fwd_ext": "ea", "vpt_diff_bwd_ext": "ea",
            "vpt_diff_fwd_field_ext": "fog_ea",
            "vpt_diff_bwd_field_ext": "fog_ea",
            "vpt_diff_fwd_grid_ext": "grid_ea",
            "vpt_diff_bwd_grid_ext": "grid_ea"}
    records = []
    for entry, (_, src, repl) in EXT_PAIR.items():
        fwd = "_fwd" in entry
        t = timed[rows[entry]]
        b = t["bound2" if fwd else "bound3"]
        regs, spill, stack = ext_ptxas[entry]
        rec = {
            "name": f"{entry[4:]} {rows[entry]}", **common,
            "source": f"vpt_torch/csrc/{src}", "replaces": repl,
            "launches": sum(tt["launches"].get(entry, 0)
                            for tt in timed.values()),
            "max_abs_err": errs[entry],
            "ms": t["k2_ms" if fwd else "k3_ms"],
            "frame": t["frame"], "fwd_bwd_ms": t["fwd_bwd_ms"],
            "plain_ms": t["plain_ms" if fwd else "plain_bwd_ms"],
            "plain_frame": (list(EXT_COUNT_FRAME[:3]) if fwd
                            else t["k3_plain_frame"]),
            "plain_alone": False,
            "ms_at_plain_frame": t["k2_ms_at_plain" if fwd
                                   else "k3_ms_at_plain"],
            "bound_ms": b[0], "bound_by": b[1],
            "work_at_plain_frame": t["work"],
            "ptxas": {"registers": regs, "spill_stores": spill,
                      "stack": stack}}
        if fwd:
            rec["k2_minus_k1"] = c1.get(entry, 0.0)
        others = {lab: {k: tt[k] for k in ("frame", "k2_ms", "k3_ms",
                                           "fwd_bwd_ms", "launches",
                                           "bound2", "bound3")}
                  for lab, tt in timed.items()
                  if tt["entries"][0 if fwd else 1] == entry
                  and lab != rows[entry]}
        if others:
            rec["cells"] = others
        if entry == "vpt_diff_bwd_grid_ext":
            rec.update(voxel_check=voxel, crn_fd=fd, recover_grid_ea=rg,
                       launches_recover_grid=rg["launches"].get(entry, 0))
        if entry == "vpt_diff_bwd_ext":
            rec["gradient_question"] = rq
        records.append(rec)
    return records


# ---- phase 18: the rest of the dual kernel K4 (the extended
# instantiations): equi-angular, the implicit and physical estimators, a
# baked HG g; material-3 shells

# the extended kernels (mangled-name fragments) and their sources
GEOM_EXT = {f"vpt_geom_ext_k{k}": (f"19vpt_geom_ext_kernelILi{k}EE",
                                   f"geom_ext_k{k}.cu")
            for k in (0, 3, 4, 6, 7, 10)}
# the tangent blocks of each K: (sphere 8's centre, camera origin + fov,
# look direction)
GEOM_BLOCKS = {0: dict(primal_only=True), 3: dict(cam_grads=False),
               4: dict(sphere=None), 6: dict(cam_grads=False, dir_grads=True),
               7: {}, 10: dict(dir_grads=True)}
GEA = (("distance", "equiangular"),)
GIMPLICIT = (("nee", False), ("physical", True))
# K4 against its plain version at 64x32x8, 8 bounces, seed 3, under both
# samplers: (scene, HG g, estimator, K); every extended K at equi-angular
# NEE with g = 0.5, and at K = 7 and K = 0 each route
GEOM_EXT_CFGS = [("cornell_vpt", 0.5, GEA, k) for k in (0, 3, 4, 6, 7, 10)]
GEOM_EXT_CFGS += [
    (name, g, est, k) for k in (7, 0)
    for name, g, est in (
        ("cornell_vpt", 0.0, GEA), ("cornell_vpt", 0.0, GIMPLICIT),
        ("cornell_vpt", 0.0, (("physical", True),)),
        ("cornell_vpt", 0.0, GEA + (("nee", False),)),
        ("cornell_vpt", 0.5, ()), ("medium_shell", 0.0, ()))]
GEOM_EXT_FRAME = (64, 32, 8, 8)
GEOM_EXT_CHECKS = [("k4x", name, g, est, k, (*GEOM_EXT_FRAME, sampler, 3))
                   for name, g, est, k in GEOM_EXT_CFGS
                   for sampler in ("random", "ld")]
# the timed cells at the geom main frame (cornell_vpt, 1024x1024x64,
# "random", K = 7 sphere 8 + camera; label: scene, g, estimator, K); their
# work counters come from K = 0 plain versions at GEOM_COUNT_FRAME, scaled
# by the paths (equi-angular's from its 2-spp check at the main frame)
GEOM_TIMED = {"ea": ("cornell_vpt", 0.0, GEA, 7),
              "implicit_physical": ("cornell_vpt", 0.0, GIMPLICIT, 7),
              "hg": ("cornell_vpt", 0.5, (), 7),
              "medium_shell": ("medium_shell", 0.0, (), 7),
              "ea_k0": ("cornell_vpt", 0.0, GEA, 0)}
GEOM_COUNT_FRAME = (128, 128, 8, 32, "random", 0)
# the other extended K (3, 4, 6, 10) through make_geom_renderer at
# GEOM_COUNT_FRAME, equi-angular NEE at g = 0.5, beside their counters
GEOM_K_TIMED = ("cornell_vpt", 0.5, GEA)
GEOM_EA_CHECK = ("k4x", "cornell_vpt", 0.0, GEA, 7,
                 (1024, 1024, GEOM_CHECK_SPP, 32, "random", 0))
# examples/recover_camera.py at its own setting (:36-105): 64x48, the
# target at 128 spp and 16 bounces, FD renders at 64 spp; the camera starts
# at origin + (4, -3, 6), direction + (0.010, -0.008, 0), fov x 1.06; 3
# rounds of 30 direction-only and 60 origin + fov steps, Adam rates
# exponential_decay(rate 0.7^r, 15, 0.75); vpt's run (BASELINE.md:600-612,
# a TPU v5e, the example's expected answer) and the criteria it is held to
RC_FRAME = (64, 48, 128, 64)
RC_ROUNDS, RC_STEPS = 3, (30, 60)
RC_OFF, RC_DIR_OFF, RC_FOV = (4.0, -3.0, 6.0), (0.010, -0.008, 0.0), 1.06
RC_VPT = {"origin": (7.81, 1.58), "fov": (0.0306, 0.0045),
          "direction_deg": (0.733, 0.270)}
RC_CRITERIA = {"origin": 2.6, "fov": 0.01, "direction_deg": 0.4}


def geom_ext_inputs(name, g, est, k, frame, camera, dev) -> tuple:
    """(packed, theta vector, seed) of K4 with K = k on SCENES[name] at g."""
    w, h, spp, mb, sampler, s = frame
    sc = with_g(SCENES[name](), g)
    blocks = {"sphere": 8, **GEOM_BLOCKS[k]}
    gp = gm.pack_geom(sc, camera, w, h, spp, max_bounces=mb,
                      sampler=sampler, **blocks, **dict(est))
    if gp.K != k:
        raise AssertionError(f"K4 blocks {blocks}: K = {gp.K}, not {k}")
    th = gm.flatten_theta(gm.pack_theta(sc, camera, blocks["sphere"])).to(
        dev)
    return gp, th, torch.tensor([s], dtype=torch.int32, device=dev)


def geom_ext_plain_job(spec: tuple, dev, camera) -> tuple:
    """A "k4x" job of plain_job: K4's planes and counters (a counter job,
    at GEOM_COUNT_FRAME, returns no output)."""
    _, name, g, est, k, frame = spec
    gp, th, s = geom_ext_inputs(name, g, est, k, frame, camera, dev)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gm.geom_fwd_plain(gp, th, s, stats=stats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (None if frame == GEOM_COUNT_FRAME else out.cpu().numpy(), stats,
            ms)


def geom_count_spec(name: str, g: float, est: tuple) -> tuple:
    """The K = 0 plain run whose counters give an estimator's work (the
    same at any K)."""
    return ("k4x", name, g, est, 0, GEOM_COUNT_FRAME)


def geom_ext_specs() -> list:
    """Phase 18's plain runs, the longest first."""
    counters = [geom_count_spec(*GEOM_TIMED[lab][:3]) for lab in GEOM_TIMED
                if lab != "ea"]
    return [GEOM_EA_CHECK, *counters, geom_count_spec(*GEOM_K_TIMED),
            *GEOM_EXT_CHECKS]


def geom_ext_ops_lower_bound(stats: dict, gpc: gm.GeomPacked,
                             K: int) -> float:
    """K4's operations under its estimator on the frame whose plain run
    gave `stats` (gpc; its samples, not the timed frame's): the pair's
    forward counts of ext_pair_bound (equi-angular +60 per thread-iteration
    for the distance, the foot point and the two atan2_posx and tan_sc, +8
    per medium event for its weight; without NEE 72 per shading event and
    14 per medium event; HG +42 per medium event), each dual operation
    taken 1 + K times but for the PLAIN_OPS that stay plain, as
    geom_ops_lower_bound takes them."""
    pk = gpc.pk
    S, M = pk.S, len(pk.mis_lights)
    it, sh, md = stats["thread_iters"], stats["shade"], stats["medium"]
    samples = pk.npix * pk.spp
    ops = (it * (41 + 23 * S + (60 if gpc.ea else 0)) + samples * 29
           + sh * ((208 + 109 * M + 23 * S * (2 + M)) if gpc.nee else 72)
           + md * (((102 + 23 * S) if gpc.nee else 14)
                   + (8 if gpc.ea else 0) + (42 if gpc.hg else 0)))
    plain = (it * PLAIN_OPS["thread_iters"] + samples * PLAIN_OPS["samples"]
             + sh * PLAIN_OPS["shade"] + md * PLAIN_OPS["medium"])
    return (1 + K) * (ops - plain) + plain


def geom_ext_bound(stats: dict, gpc: gm.GeomPacked, gp: gm.GeomPacked,
                   scale: float) -> tuple[float, str]:
    """geom_bound's bytes of gp's frame against geom_ext_ops_lower_bound's
    operations at gpc's (the frame of the plain run that gave `stats`)
    scaled by `scale` to gp's, counted at gp's K."""
    t_ops = (geom_ext_ops_lower_bound(stats, gpc, gp.K) * scale / PEAK_F32
             * 1e3)
    t_bytes = (48.0 + 4.0 + 4.0 * gp.planes * gp.npix) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def geom_ext_vs_plain(spec, plains, camera, dev) -> dict:
    """One K4 launch against its plain version: every plane bit for bit."""
    _, name, g, est, k, frame = spec
    gp, th, s = geom_ext_inputs(name, g, est, k, frame, camera, dev)
    out = gm.geom_fwd(gp, th, s)
    plain, _, p_ms = plains.get(spec, dev)
    torch.cuda.synchronize()
    res = dict(equal=bool(torch.equal(out, plain)),
               err=float((out - plain).abs().max()),
               finite=bool(torch.isfinite(out).all()), plain_ms=p_ms,
               ext=gp.ext, K=gp.K, primal=out[::1 + gp.K].clone())
    if not (res["equal"] and res["finite"]):
        raise AssertionError(f"K4 {spec}: {res}")
    return res


def recover_camera(camera, card: str, dev: torch.device) -> dict:
    """examples/recover_camera.py at its own setting (RC_*) through
    make_fd_geom_train_step with dist.adam's per-leaf rates: the direction
    block, then the origin + fov block, each round; the other leaves
    frozen."""
    scene = vpt_torch.cornell_vpt()
    w, h, spp_t, spp = RC_FRAME
    pk = wf.pack_scene(scene, camera, w, h, spp_t, max_bounces=16)
    target = wf.render_tile(pk, torch.tensor([99], dtype=torch.int32,
                                             device=dev)).reshape(-1, 3)
    cam_w = vpt_torch.Camera(
        origin=camera.origin + torch.tensor(RC_OFF),
        direction=camera.direction + torch.tensor(RC_DIR_OFF),
        fov_scale=camera.fov_scale * RC_FOV)
    theta = {k: v.to(dev) for k, v in gm.pack_theta(scene, cam_w,
                                                     None).items()}
    decay = vpt_torch.dist.exponential_decay

    def residuals(th) -> dict:
        d = th["cam_dir"].double().cpu()
        d0 = camera.direction.double()
        c = float(torch.dot(d / d.norm(), d0 / d0.norm()).clamp(-1.0, 1.0))
        return {"origin": float((th["cam_origin"].cpu()
                                 - camera.origin).norm()),
                "fov": float(th["fov"].cpu() - camera.fov_scale),
                "direction_deg": float(np.degrees(np.arccos(c)))}

    start = residuals(theta)
    reset_counts()
    losses, per_step, blocks_end = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(RC_ROUNDS):
        dec = 0.7 ** r
        blocks = (
            ({"cam_dir": decay(0.002 * dec, 15, 0.75)},
             dict(cam_grads=False, dir_grads=True), RC_STEPS[0], 1000 * r),
            ({"cam_origin": decay(0.5 * dec, 15, 0.75),
              "fov": decay(0.004 * dec, 15, 0.75)},
             dict(cam_grads=True), RC_STEPS[1], 5000 * r + 17))
        for rates, kw, n, seed0 in blocks:
            opt = vpt_torch.dist.adam(theta, rates)
            step = vpt_torch.dist.make_fd_geom_train_step(
                scene, cam_w, w, h, spp, opt, sphere=None, max_bounces=16,
                device="cuda", **kw)
            for i in range(n):
                n0 = gm.LAUNCHES
                losses.append(float(step(theta, target, seed0 + i)))
                per_step.append(gm.LAUNCHES - n0)
            blocks_end.append(residuals(theta))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    end = residuals(theta)
    met = {k: abs(end[k]) < v for k, v in RC_CRITERIA.items()}
    launches = dict(gm.LAUNCHES_BY)
    res = dict(start=start, end=end, met=met, all_met=all(met.values()),
               after_each_block=blocks_end,
               seconds=secs, loss_first=losses[0], loss_last=losses[-1],
               steps=len(losses), launches=launches,
               launches_per_step=sorted(set(per_step)),
               finite=bool(np.isfinite(losses).all() and all(
                   bool(torch.isfinite(v).all()) for v in theta.values())))
    print(f"phase 18 recover_camera ({w}x{h}, target {spp_t} spp, {spp} spp, "
          f"{RC_ROUNDS} rounds of {RC_STEPS[0]} + {RC_STEPS[1]} FD steps): "
          f"origin {start['origin']:.3f} -> "
          f"{end['origin']:.3f} (< {RC_CRITERIA['origin']}: "
          f"{'met' if met['origin'] else 'not met'}), fov "
          f"{start['fov']:+.5f} -> {end['fov']:+.5f} (|.| < "
          f"{RC_CRITERIA['fov']}: {'met' if met['fov'] else 'not met'}), "
          f"direction {start['direction_deg']:.4f} -> "
          f"{end['direction_deg']:.4f} deg (< "
          f"{RC_CRITERIA['direction_deg']}: "
          f"{'met' if met['direction_deg'] else 'not met'}) in {secs:.3f} s; "
          f"loss {losses[0]:.6g} -> {losses[-1]:.6g}; launches {launches} "
          f"({res['launches_per_step']} per step); vpt's round-4 row "
          f"(BASELINE.md:600-612, a TPU v5e): origin 7.81 -> 1.58, fov "
          f"+0.0306 -> +0.0045, direction 0.733 -> 0.270 deg; on {card}",
          flush=True)
    if not (res["finite"] and res["launches_per_step"] == [12, 16]
            and len(losses) == RC_ROUNDS * sum(RC_STEPS)):
        raise AssertionError(f"recover_camera: {res}")
    return res


def geom_ext_phases(card: str, dev: torch.device, camera,
                    plains: PlainPool) -> list:
    """Phase 18; returns the extended K4 instantiations' kernel records."""
    t18 = time.perf_counter()
    rep = ptxas_report()
    ext_ptxas = {}
    for entry, (frag, _) in GEOM_EXT.items():
        hits = [v for k, v in rep.items() if frag in k]
        if len(hits) != 1:
            raise AssertionError(f"ptxas reports {len(hits)} kernels for "
                                 f"{frag}")
        ext_ptxas[entry] = hits[0]
        print(f"phase 18 ptxas {entry}: {hits[0][0]} registers, {hits[0][1]}"
              f" B spill stores, {hits[0][2]} B stack", flush=True)
    older = {k: v for k, v in EXISTING_PTXAS.items() if "vpt_geom" in k}
    changed = {k: (rep.get(k), v) for k, v in older.items()
               if rep.get(k) != v}
    print(f"phase 18 ptxas of the six older K4 instantiations: "
          f"{'unchanged' if not changed else changed} (registers, spill "
          f"stores, stack: {sorted(older.values())})", flush=True)
    if changed:
        raise AssertionError(f"K4 kernels changed: {changed}")

    # -- every extended instantiation against its plain version, bit for
    # bit, and the K = 7 primal against the K = 0 one
    t0 = time.perf_counter()
    errs = dict.fromkeys(GEOM_EXT, 0.0)
    primals, n_old = {}, 0
    for spec in GEOM_EXT_CHECKS:
        r = geom_ext_vs_plain(spec, plains, camera, dev)
        entry = f"vpt_geom_ext_k{r['K']}" if r["ext"] else None
        if entry:
            errs[entry] = max(errs[entry], r["err"])
        else:
            n_old += 1
        _, name, g, est, k, frame = spec
        primals.setdefault((name, g, est, frame), {})[k] = r["primal"]
    # the K = 7 primal against the K = 0 launch of the same estimator and
    # sampler (the checks hold both for every K = 7 configuration)
    same = {key: bool(torch.equal(p[0], p[7])) for key, p in primals.items()
            if 7 in p}
    print(f"phase 18 K4 checks {GEOM_EXT_FRAME[0]}x{GEOM_EXT_FRAME[1]}x"
          f"{GEOM_EXT_FRAME[2]}: {len(GEOM_EXT_CHECKS)} launches bit-equal to "
          f"plain ({n_old} of them the default estimator on medium_shell, "
          f"geom_k<K>); K = 7 primal == K = 0 primal in {sum(same.values())} "
          f"of {len(same)} (estimator, sampler) pairs; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not all(same.values()):
        raise AssertionError(f"K4 primal depends on K: {same}")

    # -- the main frame: the extended K = 7 and K = 0 through
    # make_geom_renderer, timed; equi-angular K = 7 against its plain
    # version at GEOM_CHECK_SPP
    cfg = vpt_torch.RenderConfig(**MAIN_CFG)
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_paths = w * h * spp
    seed_t = torch.tensor([cfg.seed], dtype=torch.int32, device=dev)
    timed = {}
    for label, (name, g, est, k) in GEOM_TIMED.items():
        sc = with_g(SCENES[name](), g)
        blocks = {"sphere": 8, **GEOM_BLOCKS[k]}
        render = gm.make_geom_renderer(sc, camera, w, h, spp,
                                       max_bounces=cfg.max_bounces,
                                       device="cuda", **blocks, **dict(est))
        theta = {kk: v.to(dev) for kk, v in gm.pack_theta(
            sc, camera, 8).items()}
        reset_counts()
        (img, tang), first_ms = cuda_ms(lambda: render(theta, cfg.seed))
        launched = dict(gm.LAUNCHES_BY)
        gp = render.packed
        entry = f"geom_{'ext_' if gp.ext else ''}k{k}"
        if launched != {entry: 1} or not (bool(torch.isfinite(img).all())
                                          and bool(torch.isfinite(tang).all())):
            raise AssertionError(f"geom {label}: launches {launched}")
        ms, times = median_ms(lambda: render(theta, cfg.seed), warm_up=False)
        thv = gm.flatten_theta(theta)
        k_ms, k_times = median_ms(lambda: gm.geom_fwd(gp, thv, seed_t))
        if label == "ea":
            _, stats, cp_ms = plains.get(GEOM_EA_CHECK, dev)
            gpc = geom_ext_inputs(*GEOM_EA_CHECK[1:], camera, dev)[0]
            scale = spp / GEOM_CHECK_SPP
            c_ms = None
        else:
            _, stats, cp_ms = plains.get(geom_count_spec(name, g, est), dev)
            cw, ch, cs = GEOM_COUNT_FRAME[:3]
            scale = n_paths / (cw * ch * cs)
            gpc, thc, sc0 = geom_ext_inputs(name, g, est, k,
                                            GEOM_COUNT_FRAME, camera, dev)
            c_ms, _ = median_ms(lambda: gm.geom_fwd(gpc, thc, sc0))
        b = geom_ext_bound(stats, gpc, gp, scale)
        timed[label] = dict(entry=entry, launches=launched, ms=k_ms,
                            render_ms=ms, first_ms=first_ms,
                            paths_per_sec=n_paths / (ms / 1e3), bound=b,
                            plain_ms=cp_ms, ms_at_count_frame=c_ms,
                            work=stats, image_mean=float(img.mean()),
                            tangent_means=[round(float(v), 6) for v in
                                           tang.mean(dim=(1, 2))])
        print(f"phase 18 geom {label} {w}x{h}x{spp} random K={k} "
              f"(launches {launched}): render {ms:.3f} ms (median of {times}; "
              f"first {first_ms:.3f}), {n_paths / (ms / 1e3):.6e} camera "
              f"paths/s; the kernel alone {k_ms:.3f} ms ({k_times}); bound "
              f"{b[0]:.3f} ms ({b[1]}); image mean {float(img.mean()):.6f}, "
              f"tangent means {timed[label]['tangent_means']} on {card}",
              flush=True)
        del img, tang
    gp2, th2, s2 = geom_ext_inputs(*GEOM_EA_CHECK[1:], camera, dev)
    k2_ms, _ = median_ms(lambda: gm.geom_fwd(gp2, th2, s2))
    r = geom_ext_vs_plain(GEOM_EA_CHECK, plains, camera, dev)
    errs["vpt_geom_ext_k7"] = max(errs["vpt_geom_ext_k7"], r["err"])
    timed["ea"].update(ms_at_check=k2_ms, plain_ms=r["plain_ms"])
    print(f"phase 18 K4 EA check {w}x{h}x{GEOM_CHECK_SPP} K=7: bit-equal "
          f"{r['equal']}; kernel {k2_ms:.3f} ms, plain {r['plain_ms']:.3f} ms"
          f" (pooled)", flush=True)

    # -- the other extended K through make_geom_renderer at
    # GEOM_COUNT_FRAME, beside their plain versions' counters there
    name, g, est = GEOM_K_TIMED
    _, kstats, kp_ms = plains.get(geom_count_spec(name, g, est), dev)
    cw, ch, cs, cmb, csampler, cseed = GEOM_COUNT_FRAME
    for k in (3, 4, 6, 10):
        sc = with_g(SCENES[name](), g)
        blocks = {"sphere": 8, **GEOM_BLOCKS[k]}
        render = gm.make_geom_renderer(sc, camera, cw, ch, cs,
                                       max_bounces=cmb, sampler=csampler,
                                       device="cuda", **blocks, **dict(est))
        theta = {kk: v.to(dev) for kk, v in gm.pack_theta(
            sc, camera, 8).items()}
        reset_counts()
        img, tang = render(theta, cseed)
        torch.cuda.synchronize()
        launched = dict(gm.LAUNCHES_BY)
        if launched != {f"geom_ext_k{k}": 1} or not (
                bool(torch.isfinite(img).all())
                and bool(torch.isfinite(tang).all())):
            raise AssertionError(f"geom K={k}: launches {launched}")
        gp = render.packed
        thv = gm.flatten_theta(theta)
        s0 = torch.tensor([cseed], dtype=torch.int32, device=dev)
        k_ms, k_times = median_ms(lambda: gm.geom_fwd(gp, thv, s0))
        b = geom_ext_bound(kstats, gp, gp, 1.0)
        timed[f"ea_g0.5_k{k}"] = dict(
            entry=f"geom_ext_k{k}", launches=launched, ms=k_ms,
            render_ms=None, paths_per_sec=cw * ch * cs / (k_ms / 1e3),
            bound=b, plain_ms=kp_ms, work=kstats)
        print(f"phase 18 geom ea g=0.5 {cw}x{ch}x{cs} {csampler} K={k}: "
              f"launches {launched}; kernel {k_ms:.3f} ms ({k_times}), bound "
              f"{b[0]:.3f} ms ({b[1]}); plain K=0 {kp_ms:.3f} ms (pooled)",
              flush=True)

    # -- the recovery
    rc = recover_camera(camera, card, dev)
    print(f"phase 18 {time.perf_counter() - t18:.1f} s", flush=True)

    # -- the records: K = 7 and K = 0 at the main frame, the others at
    # GEOM_COUNT_FRAME
    rows = {"vpt_geom_ext_k7": "ea", "vpt_geom_ext_k0": "ea_k0",
            **{f"vpt_geom_ext_k{k}": f"ea_g0.5_k{k}" for k in (3, 4, 6, 10)}}
    records = []
    for entry, (_, src) in GEOM_EXT.items():
        regs, spill, stack = ext_ptxas[entry]
        t = timed[rows[entry]]
        cells = {lab: {kk: tt[kk] for kk in ("ms", "render_ms", "bound",
                                             "launches", "paths_per_sec")}
                 for lab, tt in timed.items() if tt["entry"] == t["entry"]}
        main = rows[entry] in ("ea", "ea_k0")
        rec = {"name": entry[4:], "route": "cuda", "library_ms": None,
               "card": card, "source": f"vpt_torch/csrc/{src}",
               "replaces": "vpt/kernels/geom.py:609",
               "launches": sum(c["launches"].get(t["entry"], 0)
                               for c in cells.values()),
               "max_abs_err": errs[entry], "ms": t["ms"],
               "frame": ([w, h, spp] if main else list(GEOM_COUNT_FRAME[:3])),
               "plain_ms": t["plain_ms"], "plain_alone": False,
               "plain_frame": (list(GEOM_EA_CHECK[5][:3]) if entry.endswith(
                   "k7") else list(GEOM_COUNT_FRAME[:3])),
               "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
               "cells": cells,
               "ptxas": {"registers": regs, "spill_stores": spill,
                         "stack": stack}}
        if entry.endswith("k7"):
            rec["ms_at_plain_frame"] = t["ms_at_check"]
            # medium_shell under the default estimator runs geom_k7
            rec["medium_shell_default_estimator"] = {
                kk: timed["medium_shell"][kk]
                for kk in ("entry", "ms", "render_ms", "bound", "launches",
                           "paths_per_sec")}
        elif entry.endswith("k0"):
            rec["ms_at_plain_frame"] = t["ms_at_count_frame"]
            rec["recover_camera"] = rc
        else:
            rec["ms_at_plain_frame"] = t["ms"]
        records.append(rec)
    return records


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the vpt_torch "
                                 "port on one NVIDIA GPU (no arguments: "
                                 "every phase)")
    ap.add_argument("--recover-fog-multiview", type=int, default=None,
                    metavar="STEPS",
                    help="the card, the build and "
                         "examples/recover_fog_multiview.py's fit at its "
                         "own settings for STEPS steps (2400: the whole "
                         "example)")
    ap.add_argument("--recover-grid", type=int, default=None,
                    metavar="STEPS",
                    help="the card, the build and examples/recover_grid.py "
                         "at the round-4 setting (--spp 16 --reg-l1 2e-2) "
                         "for STEPS steps (250: the round-4 run)")
    ap.add_argument("--geom-ext", action="store_true",
                    help="the card, the build and phase 18 alone (the "
                         "extended K4 instantiations and recover_camera)")
    ap.add_argument("--recover-grid-ea", type=int, default=None,
                    metavar="STEPS",
                    help="the card, the build and tomo_quality_study.py's "
                         "rows B (free flight) and F (equi-angular) of "
                         "examples/recover_grid.py for STEPS steps each "
                         "(250: the study's rows)")
    return ap.parse_args(argv)


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; no result")
    plains = None
    if args.geom_ext:
        plains = PlainPool(geom_ext_specs())
    elif (args.recover_fog_multiview is None and args.recover_grid is None
            and args.recover_grid_ea is None):
        plains = PlainPool(plain_specs())
    try:
        return run(args, plains)
    finally:
        if plains is not None:
            plains.terminate()


def run(args, plains: PlainPool | None) -> int:
    t_start = time.perf_counter()
    # ---- phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {name})", flush=True)

    # ---- phase 2: build the kernels from this checkout's sources
    t0 = time.perf_counter()
    lib = _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "Compiling entry" in ln or "registers" in ln
             or "spill" in ln]
    print(f"phase 2 build: {build_s:.2f} s -> {_build.library_path().name}; "
          f"VptParams {lib.vpt_params_words()} words, DiffParams "
          f"{lib.vpt_diff_params_words()} words; ptxas: {' | '.join(ptxas)}",
          flush=True)

    dev = torch.device("cuda", 0)
    scene = vpt_torch.cornell_vpt()
    camera = vpt_torch.default_camera()
    S = scene.count
    if args.recover_fog_multiview is not None:
        res = recover_fog_multiview(camera, args.recover_fog_multiview, card)
        print(json.dumps({"recover_fog_multiview": res, "card": card}))
        print(f"chip_smoke: partial run, {time.perf_counter() - t_start:.1f}"
              f" s", flush=True)
        return 0
    if args.recover_grid is not None:
        res = recover_grid(camera, card, **dict(RG_ROUND4,
                                                steps=args.recover_grid))
        res["round4_met"] = bool(res["corr"] >= 0.70
                                 and res["mae_final"] <= 0.16)
        print(f"recover_grid at the round-4 setting: corr {res['corr']:.3f} "
              f"(>= 0.70), MAE {res['mae_final']:.4f} (<= 0.16): "
              f"{'met' if res['round4_met'] else 'not met'} (vpt on a TPU "
              f"v5e: 0.223 -> 0.138, corr 0.76)", flush=True)
        print(json.dumps({"recover_grid": res, "card": card}))
        print(f"chip_smoke: partial run, {time.perf_counter() - t_start:.1f}"
              f" s", flush=True)
        return 0
    if args.geom_ext:
        plains.wait()
        records = geom_ext_phases(card, dev, camera, plains)
        print(json.dumps({"kernels": records}))
        print(f"chip_smoke: partial run, {time.perf_counter() - t_start:.1f}"
              f" s", flush=True)
        return 0
    if args.recover_grid_ea is not None:
        rows = {dist: recover_grid(camera, card, steps=args.recover_grid_ea,
                                   reg_l1=2e-2, reg_tv=1e-2,
                                   interp="nearest", distance=dist)
                for dist in ("free", "equiangular")}
        ea = rows["equiangular"]
        met = bool(ea["finite"] and ea["corr"] >= 0.65
                   and ea["mae_final"] <= 0.18)
        free_better = rows["free"]["corr"] > ea["corr"]
        print(f"recover_grid rows B / F (16^3, 6 views, "
              f"{args.recover_grid_ea} steps, L1 2e-2, TV 1e-2, nearest): "
              f"free corr {rows['free']['corr']:.3f}, MAE "
              f"{rows['free']['mae_final']:.4f}; equi-angular corr "
              f"{ea['corr']:.3f} (>= 0.65), MAE {ea['mae_final']:.4f} (<= "
              f"0.18): {'met' if met else 'not met'}; free flight beats "
              f"equi-angular: {free_better} (vpt on a TPU v5e: B 0.753 / "
              f"0.138, F 0.705 / 0.159)", flush=True)
        print(json.dumps({"recover_grid_rows": rows, "f_met": met,
                          "free_beats_ea": free_better, "card": card}))
        print(f"chip_smoke: partial run, {time.perf_counter() - t_start:.1f}"
              f" s", flush=True)
        return 0 if met else 1

    # ---- phase 3: K1 against its plain version, small frame
    for sampler in ("random", "ld"):
        for seed in (3, 11):
            pk = wf.pack_scene(scene, camera, 64, 32, 8, max_bounces=8,
                               sampler=sampler)
            s = torch.tensor([seed], dtype=torch.int32, device=dev)
            k = wf.render_tile(pk, s)
            p = wf.render_tile_plain(pk, s)
            torch.cuda.synchronize()
            q = q99_rel(k, p)
            print(f"phase 3 K1 check 64x32x8 {sampler} seed {seed}: "
                  f"q99 rel {q:.3e}, max abs {float((k - p).abs().max()):.3e}",
                  flush=True)
            if not bool(torch.isfinite(k).all()) or not q < Q99_TOL:
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"q99 {q} (tolerance {Q99_TOL})")
    # the main-frame plain versions are done before the first timing
    print(f"phases 1-3: {time.perf_counter() - t_start:.1f} s", flush=True)
    plains.wait()

    # ---- phase 4: the forward main path through the public API
    cfg = vpt_torch.RenderConfig(**MAIN_CFG)
    reset_counts()
    img, main_ms = cuda_ms(lambda: vpt_torch.render(scene, camera, cfg,
                                                    device="cuda"))
    launched = counts()
    if launched["wavefront_fwd"] < 1:
        raise AssertionError("the main path did not launch the render kernel")
    if tuple(img.shape) != (cfg.height, cfg.width, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or bool((img < 0).any()):
        raise AssertionError("image has non-finite or negative values")
    pk = wf.pack_scene(scene, camera, cfg.width, cfg.height, cfg.spp,
                       continue_prob=cfg.continue_prob,
                       max_bounces=cfg.max_bounces, sampler=cfg.sampler,
                       jitter=cfg.jitter)
    seed_t = torch.tensor([cfg.seed], dtype=torch.int32, device=dev)
    plain, k1_stats, plain_ms = plains.get(k1_spec("explicit_free"), dev)
    # the same call again, warm: the first one above carries one-time costs
    warm_ms, warm_times = median_ms(lambda: vpt_torch.render(
        scene, camera, cfg, device="cuda"))
    flat = img.reshape(-1, 3)
    q_main = q99_rel(flat, plain)
    err_main = float((flat - plain).abs().max())
    mean = [round(float(v), 6) for v in img.mean(dim=(0, 1))]
    print(f"phase 4 main path {cfg.width}x{cfg.height}x{cfg.spp} "
          f"{cfg.sampler}: launches {launched}, channel means {mean}, vs "
          f"plain q99 rel {q_main:.3e}, max abs {err_main:.3e}; render call "
          f"{main_ms:.3f} ms first, {warm_ms:.3f} ms warm (median of "
          f"{warm_times}); work {k1_stats}", flush=True)
    if not q_main < Q99_TOL:
        raise AssertionError(f"main path disagrees with plain version: "
                             f"q99 {q_main} (tolerance {Q99_TOL})")

    print(f"phases 1-4: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 5: K1 throughput (CUDA events; median of 3 after a warm-up)
    kernel_ms, times = median_ms(lambda: wf.render_tile(pk, seed_t))
    # K1's plain version once more, alone on the card and the host: the
    # pool's time of it beside this one gives the share of its
    # PLAIN_WORKERS concurrent processes
    _, plain_alone_ms = cuda_ms(lambda: wf.render_tile_plain(pk, seed_t))
    n_paths = cfg.width * cfg.height * cfg.spp
    dp_main = df.pack_diff(scene, camera, cfg.width, cfg.height, cfg.spp,
                           max_bounces=cfg.max_bounces, sampler=cfg.sampler)
    k1_bound, k1_by = bound("wavefront_fwd", k1_stats, dp_main)
    print(f"phase 5 K1: {n_paths / (kernel_ms / 1e3):.6e} camera paths/s "
          f"({kernel_ms:.3f} ms median of {times}); plain {plain_alone_ms:.3f}"
          f" ms alone, {plain_ms:.3f} ms in {PLAIN_WORKERS} concurrent "
          f"processes; bound {k1_bound:.3f} ms ({k1_by}) on {card}",
          flush=True)
    records = [{
        "name": "wavefront_fwd", "route": "cuda",
        "source": "vpt_torch/csrc/wavefront.cu",
        "replaces": "vpt/kernels/wavefront.py:230",
        "launches": launched["wavefront_fwd"],
        "max_abs_err": err_main, "q99_rel_err": q_main,
        "ms": kernel_ms, "plain_ms": plain_alone_ms, "plain_alone": True,
        "plain_pool_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
        "library_ms": None,
        "main_path_ms": main_ms, "main_path_warm_ms": warm_ms,
        "card": card,
    }]

    print(f"phases 1-5: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 6: K2 and K3 against their plain versions, small frame
    for sampler in ("random", "ld"):
        for seed in (3, 11):
            dp = df.pack_diff(scene, camera, 64, 32, 8, max_bounces=8,
                              sampler=sampler)
            pvec = df._flatten(df.pack_params(scene), S).to(dev)
            s = torch.tensor([seed], dtype=torch.int32, device=dev)
            gbar = torch.from_numpy(np.random.default_rng(seed)
                                    .standard_normal((dp.npix, 3))
                                    .astype(np.float32)).to(dev)
            k = df.diff_fwd(dp, pvec, s)
            g = df.diff_bwd(dp, pvec, s, gbar)
            G = df.diff_bwd(dp, pvec, s, gbar, per_lane=True)
            p = df.diff_fwd_plain(dp, pvec, s)
            Gp = df.diff_bwd_plain(dp, pvec, s, gbar, per_lane=True)
            torch.cuda.synchronize()
            q_img, q_lane = q99_rel(k, p), lane_q99(G, Gp)
            gp = Gp.sum(0)
            gerr = (g - gp).abs()
            over = int((gerr > GVEC_TOL * Gp.abs().sum(0)).sum())
            print(f"phase 6 K2/K3 check 64x32x8 {sampler} seed {seed}: image "
                  f"q99 rel {q_img:.3e}, max abs "
                  f"{float((k - p).abs().max()):.3e}, bit-equal "
                  f"{float((k == p).float().mean()):.4f}; per-pixel gradient "
                  f"q99 {q_lane:.3e}, bit-equal rows "
                  f"{float((G == Gp).all(1).float().mean()):.4f}; summed "
                  f"gradient max abs {float(gerr.max()):.3e}, entries over "
                  f"bound {over}", flush=True)
            if not (bool(torch.isfinite(k).all())
                    and bool(torch.isfinite(G).all())):
                raise AssertionError("K2/K3 gave non-finite values")
            if not (q_img < Q99_TOL and q_lane < Q99_TOL and over == 0):
                raise AssertionError(
                    f"K2/K3 disagree with their plain versions: image q99 "
                    f"{q_img}, per-pixel gradient q99 {q_lane} (tolerance "
                    f"{Q99_TOL}); {over} summed entries over {GVEC_TOL} of "
                    f"their scale")

    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 7: the fwd+bwd pair at the main-path size
    render = df.make_diff_renderer(scene, camera, cfg.width, cfg.height,
                                   cfg.spp, max_bounces=cfg.max_bounces,
                                   sampler=cfg.sampler, device="cuda")
    params = {k: v.to(dev).requires_grad_()
              for k, v in df.pack_params(scene).items()}
    reset_counts()
    loss = render(params, cfg.seed).mean()
    loss.backward()
    torch.cuda.synchronize()
    launched_pair = counts()
    if (launched_pair["diff_fwd"], launched_pair["diff_bwd"]) != (1, 1):
        raise AssertionError(f"fwd+bwd launched {launched_pair}, not K2 and "
                             f"K3 once each")
    for k, v in params.items():
        if v.grad is None or not bool(torch.isfinite(v.grad).all()):
            raise AssertionError(f"gradient of {k} missing or not finite")
    grads = {k: [round(float(x), 6) for x in v.grad.reshape(-1)[:3]]
             for k, v in params.items()}
    print(f"phase 7 fwd+bwd {cfg.width}x{cfg.height}x{cfg.spp} "
          f"{cfg.sampler}: loss {float(loss.detach()):.6f}, launches "
          f"{launched_pair}, "
          f"gradients finite, first entries {grads}", flush=True)

    dp = render.packed
    pvec = df._flatten({k: v.detach() for k, v in params.items()}, S)
    gmean = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix), device=dev)
    k2_ms, k2_times = median_ms(lambda: df.diff_fwd(dp, pvec, seed_t))
    k3_ms, k3_times = median_ms(lambda: df.diff_bwd(dp, pvec, seed_t, gmean))

    def fwd_bwd():
        for v in params.values():
            v.grad = None
        render(params, cfg.seed).mean().backward()

    pair_ms, pair_times = median_ms(fwd_bwd)
    k2 = df.diff_fwd(dp, pvec, seed_t)
    k2_plain, pair_stats, k2_plain_ms = plains.get(pair_spec(), dev)
    q_k2 = q99_rel(k2, k2_plain)
    err_k2 = float((k2 - k2_plain).abs().max())
    print(f"phase 7 K2 {k2_ms:.3f} ms (median of {k2_times}), K3 "
          f"{k3_ms:.3f} ms (median of {k3_times}); fwd+bwd through "
          f"render().mean().backward() {pair_ms:.3f} ms (median of "
          f"{pair_times}), {n_paths / (pair_ms / 1e3):.6e} camera paths/s; "
          f"K2 vs plain q99 rel {q_k2:.3e}, max abs {err_k2:.3e}, plain "
          f"{k2_plain_ms:.3f} ms; work {pair_stats}; on {card}", flush=True)
    if not q_k2 < Q99_TOL:
        raise AssertionError(f"K2 disagrees with its plain version at the "
                             f"main path: q99 {q_k2}")

    # K3 against its plain version at the main frame, CHECK_SPP samples
    dp4 = df.pack_diff(scene, camera, cfg.width, cfg.height, CHECK_SPP,
                       max_bounces=cfg.max_bounces, sampler=cfg.sampler)
    gbar4 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (dp4.npix, 3)).astype(np.float32)).to(dev)
    k3_4_ms, k3_4_times = median_ms(lambda: df.diff_bwd(dp4, pvec, seed_t,
                                                        gbar4))
    g4 = df.diff_bwd(dp4, pvec, seed_t, gbar4)
    G4 = df.diff_bwd(dp4, pvec, seed_t, gbar4, per_lane=True)
    G4p, k3_plain_ms = cuda_ms(lambda: df.diff_bwd_plain(
        dp4, pvec, seed_t, gbar4, per_lane=True))
    q_k3 = lane_q99(G4, G4p)
    g4p = G4p.sum(0)
    err_k3 = float((g4 - g4p).abs().max())
    over = int(((g4 - g4p).abs() > GVEC_TOL * G4p.abs().sum(0)).sum())
    rows_eq = float((G4 == G4p).all(1).float().mean())
    del G4, G4p
    print(f"phase 7 K3 check {cfg.width}x{cfg.height}x{CHECK_SPP}: kernel "
          f"{k3_4_ms:.3f} ms (median of {k3_4_times}), plain "
          f"{k3_plain_ms:.3f} ms; per-pixel q99 {q_k3:.3e}, bit-equal rows "
          f"{rows_eq:.4f}; summed max abs {err_k3:.3e}, entries over bound "
          f"{over}", flush=True)
    if not (q_k3 < Q99_TOL and over == 0 and bool(torch.isfinite(g4).all())):
        raise AssertionError(f"K3 disagrees with its plain version: "
                             f"per-pixel q99 {q_k3}, {over} entries over "
                             f"bound")
    k2_bound, k2_by = bound("diff_fwd", pair_stats, dp)
    k3_bound, k3_by = bound("diff_bwd", pair_stats, dp)
    print(f"phase 7 bounds: K2 {k2_bound:.3f} ms ({k2_by}), K3 "
          f"{k3_bound:.3f} ms ({k3_by})", flush=True)

    print(f"phases 1-7: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 8: the trainer, fit_kernel on a 1024x1024 target
    tcfg = vpt_torch.RenderConfig(width=cfg.width, height=cfg.height, spp=64,
                                  max_bounces=16, seed=99)
    target = vpt_torch.render(scene, camera, tcfg, device="cuda")
    wrong = dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, sigma_s=scene.medium.sigma_s * 2.78))
    steps = []

    def observe(updated, initial):
        # an identity filter: fit_kernel calls it once after each step
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), df.LAUNCHES_FWD, df.LAUNCHES_BWD,
                      float(updated["sigma_a"].detach()),
                      float(updated["sigma_s"].detach())))
        return updated

    # the first optimizer step of a process pays torch's one-time set-up;
    # time it apart from the trainer's steps
    t0 = time.perf_counter()
    probe = torch.zeros(1, device=dev, requires_grad=True)
    probe.grad = torch.ones_like(probe)
    torch.optim.Adam([probe]).step()
    torch.cuda.synchronize()
    print(f"phase 8 first torch.optim.Adam step of the process: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    fitted, losses = vpt_torch.dist.fit_kernel(
        wrong, camera, target, steps=3, spp=16, max_bounces=16,
        learning_rate=1.5e-3, param_filter=observe, device="cuda")
    launched_train = counts()
    prev = (t0, 0, 0)
    for i, ((t, nf, nb, sa, ss), l) in enumerate(zip(steps, losses)):
        print(f"phase 8 step {i}: loss {l:.6g}, sigma_a {sa:.6g}, sigma_s "
              f"{ss:.6g}, {t - prev[0]:.3f} s, K2 +{nf - prev[1]} K3 "
              f"+{nb - prev[2]}", flush=True)
        if (nf - prev[1], nb - prev[2]) != (2, 2):
            raise AssertionError(f"step {i} launched K2 {nf - prev[1]} and "
                                 f"K3 {nb - prev[2]} times, not 2 and 2")
        if not all(np.isfinite([l, sa, ss])):
            raise AssertionError(f"step {i} is not finite")
        prev = (t, nf, nb)
    if len(steps) != 3 or not all(bool(torch.isfinite(v).all())
                                  for v in fitted.values()):
        raise AssertionError("fit_kernel did not take 3 finite steps")
    print(f"phase 8 fit_kernel {cfg.width}x{cfg.height}, spp 16, 3 steps: "
          f"launches {launched_train}; sigma_s {float(wrong.medium.sigma_s):.6g}"
          f" -> {float(fitted['sigma_s']):.6g} (truth "
          f"{float(scene.medium.sigma_s):.6g}) on {card}", flush=True)

    print(f"phases 1-8: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 9: K4 against its plain version (from the pool), small frame
    for spec in GEOM9_CHECKS:
        gp, th, s = geom_ext_inputs(*spec[1:], camera, dev)
        k = gm.geom_fwd(gp, th, s)
        p = plains.get(spec, dev)[0]
        torch.cuda.synchronize()
        sampler, seed = spec[5][4:]
        q, err, shares = plane_check(k, p, gp.K)
        print(f"phase 9 K4 check 64x32x8 K={gp.K} {sampler} seed {seed}: "
              f"worst plane q99 {q:.3e}, max abs {err:.3e}; bit-equal share "
              f"per plane {shares}", flush=True)
        if not bool(torch.isfinite(k).all()) or not q < Q99_TOL:
            raise AssertionError(f"K4 (K={gp.K}) disagrees with its plain "
                                 f"version: worst plane q99 {q}")

    print(f"phases 1-9: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 10: the geom main path (bench.py:191-193), K = 7
    G_CFG = dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                 max_bounces=cfg.max_bounces)
    grender = gm.make_geom_renderer(scene, camera, sphere=8, cam_grads=True,
                                    device="cuda", **G_CFG)
    theta = {k: v.to(dev) for k, v in gm.pack_theta(scene, camera,
                                                     8).items()}
    reset_counts()
    (gimg, gtang), gfirst_ms = cuda_ms(lambda: grender(theta, cfg.seed))
    launched_geom = counts()
    if launched_geom["geom_fwd"] != 1 or grender.K != 7:
        raise AssertionError(f"the geom main path launched {launched_geom}")
    if tuple(gimg.shape) != (cfg.width * cfg.height, 3) or \
            tuple(gtang.shape) != (7, cfg.width * cfg.height, 3):
        raise AssertionError(f"geom shapes {gimg.shape}, {gtang.shape}")
    if not (bool(torch.isfinite(gimg).all())
            and bool(torch.isfinite(gtang).all())):
        raise AssertionError("a geom plane is not finite")
    gmeans = [round(float(v), 6) for v in gtang.mean(dim=(1, 2))]
    k4_ms, k4_times = median_ms(lambda: grender(theta, cfg.seed))
    gp = grender.packed
    thv = gm.flatten_theta(theta)
    k4k_ms, k4k_times = median_ms(lambda: gm.geom_fwd(gp, thv, seed_t))
    print(f"phase 10 geom main path {cfg.width}x{cfg.height}x{cfg.spp} "
          f"random K=7: launches {launched_geom}, image mean "
          f"{float(gimg.mean()):.6f}, tangent means {gmeans}; render call "
          f"{gfirst_ms:.3f} ms first, {k4_ms:.3f} ms warm (median of "
          f"{k4_times}), {n_paths / (k4_ms / 1e3):.6e} camera paths/s; the "
          f"kernel alone {k4k_ms:.3f} ms (median of {k4k_times}) on {card}",
          flush=True)
    # the primal_only mode (K = 0) at the full size: against its plain
    # version (whose counters give the frame's work, the same at any K),
    # and timed beside K1 with the same sampler
    gp0 = gm.pack_geom(scene, camera, sphere=8, primal_only=True, **G_CFG)
    k0_out = gm.geom_fwd(gp0, thv, seed_t)
    k0_plain, geom_stats, k0_plain_ms = plains.get(GEOM0_SPEC, dev)
    q_k0, err_k0, share_k0 = plane_check(k0_out, k0_plain, 0)
    del k0_plain
    k0_ms, k0_times = median_ms(lambda: gm.geom_fwd(gp0, thv, seed_t))
    pk_r = wf.pack_scene(scene, camera, cfg.width, cfg.height, cfg.spp,
                         max_bounces=cfg.max_bounces, sampler="random")
    k1r_ms, k1r_times = median_ms(lambda: wf.render_tile(pk_r, seed_t))
    print(f"phase 10 K=0 (primal_only) {k0_ms:.3f} ms (median of "
          f"{k0_times}), K1 random {k1r_ms:.3f} ms (median of {k1r_times}); "
          f"K=0 vs plain q99 {q_k0:.3e}, max abs {err_k0:.3e}, bit-equal "
          f"{share_k0}, plain {k0_plain_ms:.3f} ms; work {geom_stats}",
          flush=True)
    if not q_k0 < Q99_TOL:
        raise AssertionError(f"K4 (K=0) disagrees with its plain version at "
                             f"the main frame: q99 {q_k0}")
    # K = 7 against its plain version at the main frame, GEOM_CHECK_SPP
    gp2 = gm.pack_geom(scene, camera, cfg.width, cfg.height, GEOM_CHECK_SPP,
                       sphere=8, max_bounces=cfg.max_bounces)
    k7_2_ms, k7_2_times = median_ms(lambda: gm.geom_fwd(gp2, thv, seed_t))
    k7_2 = gm.geom_fwd(gp2, thv, seed_t)
    k7_2p, _, k7_plain_ms = plains.get(GEOM7_SPEC, dev)
    q_k7, err_k7, share_k7 = plane_check(k7_2, k7_2p, 7)
    del k7_2, k7_2p
    print(f"phase 10 K4 check {cfg.width}x{cfg.height}x{GEOM_CHECK_SPP} K=7: "
          f"kernel {k7_2_ms:.3f} ms (median of {k7_2_times}), plain "
          f"{k7_plain_ms:.3f} ms; worst plane q99 {q_k7:.3e}, max abs "
          f"{err_k7:.3e}, bit-equal share per plane {share_k7}", flush=True)
    if not q_k7 < Q99_TOL:
        raise AssertionError(f"K4 (K=7) disagrees with its plain version at "
                             f"the main frame: worst plane q99 {q_k7}")
    k4_bound, k4_by = geom_bound(geom_stats, gp)
    k0_bound, k0_by = geom_bound(geom_stats, gp0)
    print(f"phase 10 bounds: K=7 {k4_bound:.3f} ms ({k4_by}), K=0 "
          f"{k0_bound:.3f} ms ({k0_by})", flush=True)

    print(f"phases 1-10: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 11: the geometric trainers
    y_off = 8.0
    center = scene.center.clone()
    center[8, 1] += y_off
    wrong_light = dataclasses.replace(scene, center=center)
    gsteps = []

    def observe_geom(updated, initial):
        torch.cuda.synchronize()
        gsteps.append((time.perf_counter(), gm.LAUNCHES,
                       float(updated["center"][1].detach())))
        return updated

    reset_counts()
    t0 = time.perf_counter()
    gtheta, glosses = vpt_torch.dist.fit_geom(
        wrong_light, camera, target, sphere=8, steps=3, spp=16,
        max_bounces=16, param_filter=observe_geom, device="cuda")
    launched_fit = counts()
    prev = (t0, 0)
    for i, ((t, n4, y), l) in enumerate(zip(gsteps, glosses)):
        print(f"phase 11 fit_geom step {i}: loss {l:.6g}, light y {y:.6g}, "
              f"{t - prev[0]:.3f} s, K4 +{n4 - prev[1]}", flush=True)
        if n4 - prev[1] != 2 or not np.isfinite([l, y]).all():
            raise AssertionError(f"fit_geom step {i}: {n4 - prev[1]} K4 "
                                 f"launches, loss {l}, y {y}")
        prev = (t, n4)
    if len(gsteps) != 3:
        raise AssertionError("fit_geom did not take 3 steps")

    # examples/localize_light.py's chip configuration on the port
    glow = vpt_torch.make_scene(
        [(2.0, (0.0, 0.0, -50.0), (0, 0, 0), (60.0, 50.0, 40.0), 0,
          (0, 0, 0), (0, 0, 0), 0.0)], sigma_a=0.002, sigma_s=0.015)
    pk_t = wf.pack_scene(glow, camera, 64, 48, 128, max_bounces=16)
    glow_target = wf.render_tile(
        pk_t, torch.tensor([99], dtype=torch.int32, device=dev)).reshape(
            48, 64, 3)
    true_y = float(glow.center[0, 1])
    c0 = glow.center.clone()
    c0[0, 1] = true_y + y_off
    glow_wrong = dataclasses.replace(glow, center=c0)
    reset_counts()
    t0 = time.perf_counter()
    ftheta, flosses = vpt_torch.dist.fit_geom_fd(
        glow_wrong, camera, glow_target, sphere=0, cam_grads=False, steps=80,
        spp=64, learning_rate=vpt_torch.dist.exponential_decay(0.8, 12, 0.75),
        max_bounces=16, seed=3, device="cuda")
    torch.cuda.synchronize()
    fd_s = time.perf_counter() - t0
    launched_fd = counts()
    got_y = float(ftheta["center"][1])
    resid = abs(got_y - true_y)
    print(f"phase 11 fit_geom_fd (examples/localize_light.py, 64x48, spp 64, "
          f"80 steps): light y start {true_y + y_off:.3f} true {true_y:.3f} "
          f"recovered {got_y:.6f}, residual {resid:.6f}; loss {flosses[0]:.6g}"
          f" -> {flosses[-1]:.6g}; {fd_s:.3f} s, launches {launched_fd} on "
          f"{card}", flush=True)
    if launched_fd["geom_fwd"] != 80 * 12 or not resid < 1.0:
        raise AssertionError(f"fit_geom_fd: residual {resid} (limit 1.0), "
                             f"launches {launched_fd}")

    print(f"phases 1-11: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 12: K1's variants
    # registers, spill stores and stack of each K1 instantiation (kernel
    # <nee, distance>)
    k1_ptxas = {}
    entry_fn = None
    for ln in _build.build_log().splitlines():
        if "Compiling entry" in ln or "Function properties" in ln:
            # ptxas reports each function, out-of-line callees included
            entry_fn = ln.split()[-1].strip("'") \
                if "vpt_wavefront6kernel" in ln else None
            if "Compiling entry" in ln and entry_fn:
                entry_fn = ln.split("'")[1]
        elif entry_fn and ("registers" in ln or "spill" in ln):
            k1_ptxas.setdefault(entry_fn, []).append(" ".join(ln.split()))
    for fn, lines in sorted(k1_ptxas.items()):
        print(f"phase 12 ptxas {fn}: {' | '.join(lines)}", flush=True)
    shell = SCENES["medium_shell"]()
    scenes = {"cornell_vpt": scene, "medium_shell": shell}
    checked = set()
    for label, integrator, sname, g in VARIANTS:
        nee, dist, phys = wf.KERNEL_INTEGRATORS[integrator]
        if (nee, dist, phys, sname, g) in checked:
            print(f"phase 12 check {label}: the launches of an integrator "
                  f"checked above (same flags and scene)", flush=True)
            continue
        checked.add((nee, dist, phys, sname, g))
        sc_v = with_g(scenes[sname], g)
        for sampler in ("random", "ld"):
            for seed in (3, 11):
                pk = wf.pack_scene(sc_v, camera, 64, 32, 8, max_bounces=8,
                                   sampler=sampler, nee=nee, distance=dist,
                                   physical=phys)
                s = torch.tensor([seed], dtype=torch.int32, device=dev)
                k = wf.render_tile(pk, s)
                p = wf.render_tile_plain(pk, s)
                equal = bool(torch.equal(k, p))
                print(f"phase 12 check {label} 64x32x8 {sampler} seed {seed}:"
                      f" bit-equal {equal}, q99 rel {q99_rel(k, p):.3e}",
                      flush=True)
                if not (equal and bool(torch.isfinite(k).all())):
                    raise AssertionError(f"K1 {label} disagrees with its "
                                         f"plain version ({sampler}, seed "
                                         f"{seed})")
    # each variant through the public API at the main frame, held to its
    # plain version there bit for bit (whose counters give the frame's work:
    # phase 4's for explicit_free), then timed
    var_rows = []
    for label, integrator, sname, g in VARIANTS:
        nee, dist, phys = wf.KERNEL_INTEGRATORS[integrator]
        sc_v = with_g(scenes[sname], g)
        vcfg = dataclasses.replace(cfg, integrator=integrator)
        reset_counts()
        vimg = vpt_torch.render(sc_v, camera, vcfg, device="cuda")
        torch.cuda.synchronize()
        launched_v = dict(wf.LAUNCHES_BY)
        entry = wf.KERNEL_ENTRIES[(nee, dist)]
        if launched_v != {entry: 1}:
            raise AssertionError(f"{label}: render launched {launched_v}")
        pk = wf.pack_config(sc_v, camera, vcfg)
        key = (nee, dist, phys, sname, g)
        vplain, vstats, vp_ms = plains.get(k1_spec(integrator, sname, g),
                                           dev)
        vflat = vimg.reshape(-1, 3)
        v_equal = bool(torch.equal(vflat, vplain))
        v_err = float((vflat - vplain).abs().max())
        if not (v_equal and bool(torch.isfinite(vimg).all())):
            raise AssertionError(f"{label}: not bit-equal to its plain "
                                 f"version at the main frame (max abs "
                                 f"{v_err})")
        v_ms, v_times = median_ms(lambda: wf.render_tile(pk, seed_t))
        b_ms, b_by = variant_bound(vstats, pk)
        row = {"variant": label, "integrator": integrator, "scene": sname,
               "g": g, "entry": entry, "launches": launched_v[entry],
               "ms": v_ms, "times": v_times,
               "paths_per_sec": n_paths / (v_ms / 1e3), "plain_ms": vp_ms,
               "max_abs_err": v_err, "bound_ms": b_ms, "bound_by": b_by,
               "work": vstats,
               "mean": [round(float(v), 6) for v in vimg.mean(dim=(0, 1))]}
        var_rows.append(row)
        print(f"phase 12 {label}: {cfg.width}x{cfg.height}x{cfg.spp} "
              f"{cfg.sampler} via render, launches {launched_v}; bit-equal "
              f"to plain ({vp_ms:.3f} ms); kernel {v_ms:.3f} ms (median of "
              f"{v_times}), {row['paths_per_sec']:.6e} camera paths/s; bound "
              f"{b_ms:.3f} ms ({b_by}); work {vstats}; channel means "
              f"{row['mean']} on {card}", flush=True)
    del vplain
    free_ms = var_rows[0]["ms"]
    print(f"phase 12 explicit_free {free_ms:.3f} ms = "
          f"{100.0 * (free_ms / K1_FREE_ONLY_MS - 1.0):+.2f} % on the "
          f"{K1_FREE_ONLY_MS} ms of the free-flight-only kernel", flush=True)
    # the estimators agree in expectation, by vpt's own comparisons: bit
    # parity cannot see an estimator that is wrong in both versions.
    # Equi-angular vs free flight on cornell_vpt by clipped means
    # (tests/test_pallas.py:115-130, rtol 0.3); implicit vs explicit free
    # flight in vpt's open scene, one area light in fog, by raw means
    # (tests/test_integrators.py:39-60, rtol 0.2, 24 bounces): the implicit
    # estimator never hits cornell_vpt's point light, so there it estimates
    # another integral
    ecfg = vpt_torch.RenderConfig(width=256, height=256, spp=256,
                                  max_bounces=24)
    open_scene = vpt_torch.make_scene(
        [(30.0, (0.0, 11.0, 120.0), (0, 0, 0), (8, 7, 6), 0,
          (0, 0, 0), (0, 0, 0), 0.0)], sigma_a=0.002, sigma_s=0.012)
    emeans = {}
    for sname, sc_e, integrator in (
            ("cornell_vpt", scene, "explicit_free"),
            ("cornell_vpt", scene, "explicit_equiangular"),
            ("open", open_scene, "explicit_free"),
            ("open", open_scene, "implicit_free")):
        eimg = vpt_torch.render(sc_e, camera, dataclasses.replace(
            ecfg, integrator=integrator), device="cuda")
        emeans[f"{sname} {integrator}"] = (
            float(eimg.clamp(0.0, 1.0).mean()), float(eimg.mean()))
    r_ea = (emeans["cornell_vpt explicit_equiangular"][0]
            / emeans["cornell_vpt explicit_free"][0] - 1.0)
    r_imp = (emeans["open implicit_free"][1]
             / emeans["open explicit_free"][1] - 1.0)
    print(f"phase 12 estimators at 256x256x256 random, 24 bounces (clipped "
          f"mean, raw mean): {emeans}; equi-angular {100 * r_ea:+.2f} % "
          f"(clipped, limit 30 %), implicit {100 * r_imp:+.2f} % (raw, "
          f"limit 20 %)", flush=True)
    if not (abs(r_ea) < 0.30 and abs(r_imp) < 0.20):
        raise AssertionError(f"estimator means disagree: {emeans}")

    print(f"phases 1-12: {time.perf_counter() - t_start:.1f} s", flush=True)
    # ---- phase 13: scatter tiles, render_adaptive, render_to_noise
    scat_check = {}
    for (nee, dist), entry in wf.KERNEL_ENTRIES.items():
        pk = wf.pack_scene(scene, camera, 128, 64, 4, max_bounces=8,
                           nee=nee, distance=dist)
        s = torch.tensor([11], dtype=torch.int32, device=dev)
        n_t, lanes = pk.num_tiles, wf.LANES_PER_TILE
        bases = torch.arange(n_t, dtype=torch.int32, device=dev) * lanes
        full = wf.render_raw(pk, s)
        scat = wf.render_raw(pk, s, bases)
        rev = wf.render_raw(pk, s, bases.flip(0).contiguous())
        pscat = wf.render_raw_plain(pk, s, bases)
        ok = (bool(torch.equal(full, scat)) and bool(torch.equal(scat, pscat))
              and bool(torch.equal(full, rev.reshape(n_t, lanes, 3).flip(0)
                                   .reshape(-1, 3))))
        scat_check[entry] = ok
        print(f"phase 13 scatter {entry} 128x64x4 ({n_t} tiles): raw == "
              f"scatter == reversed == plain scatter: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"scatter mode of {entry} is not bit-equal")
    acfg = vpt_torch.RenderConfig(**MAIN_CFG)
    reset_counts()
    aimg, a_first_ms = cuda_ms(lambda: vpt_torch.render_adaptive(
        scene, camera, acfg, boost=3.0, frac=0.25, device="cuda"))
    launched_a = dict(wf.LAUNCHES_BY)
    if launched_a != {"vpt_wavefront_free_nee": 2,
                      "vpt_wavefront_free_nee_scatter": 1}:
        raise AssertionError(f"render_adaptive launched {launched_a}")
    if not (bool(torch.isfinite(aimg).all()) and bool((aimg >= 0).all())
            and tuple(aimg.shape) == (acfg.height, acfg.width, 3)):
        raise AssertionError("adaptive image is not finite and >= 0")
    go = vpt_torch.make_adaptive_renderer(scene, camera, acfg, boost=3.0,
                                          frac=0.25, device="cuda")
    a_ms, a_times = median_ms(lambda: go(acfg.seed))
    pk1, pk2 = go.packed
    # its launches against the plain version at their shapes: the first
    # pass's A sums over the whole frame, and the scatter launch on the
    # tiles that pass selected
    a_sums, _, sel = go.first_pass(acfg.seed)
    a_plain = wf.render_raw_plain(pk1, torch.tensor(
        [2 * acfg.seed], dtype=torch.int32, device=dev))
    bases2 = (sel * wf.LANES_PER_TILE).to(torch.int32)
    seed2 = torch.tensor([2 * acfg.seed + 0x5E11], dtype=torch.int32,
                         device=dev)
    extra = wf.render_raw(pk2, seed2, bases2)
    sc_stats = {}
    extra_plain, sp_ms = cuda_ms(lambda: wf.render_raw_plain(
        pk2, seed2, bases2, sc_stats))
    a_equal = (bool(torch.equal(a_sums, a_plain))
               and bool(torch.equal(extra, extra_plain)))
    s_err = float((extra - extra_plain).abs().max())
    del a_sums, a_plain, extra_plain
    if not a_equal:
        raise AssertionError("render_adaptive's launches are not bit-equal "
                             "to the plain version")
    sc_ms, sc_times = median_ms(lambda: wf.render_raw(pk2, seed2, bases2))
    sc_bound, sc_by = variant_bound(sc_stats, pk2,
                                    n_lanes=go.k * wf.LANES_PER_TILE)
    a_mean = float(aimg.mean())
    rel_mean = a_mean / float(img.mean()) - 1.0
    print(f"phase 13 render_adaptive {acfg.width}x{acfg.height}x{acfg.spp} "
          f"(boost 3, frac 0.25: {go.k} of {pk1.num_tiles} tiles get "
          f"{pk2.spp} more spp): launches {launched_a}; {a_first_ms:.3f} ms "
          f"first, {a_ms:.3f} ms (median of {a_times}); mean {a_mean:.6f} "
          f"({100 * rel_mean:+.3f} % on the 64-spp render); first pass "
          f"and scatter launch bit-equal to plain; the scatter launch "
          f"{sc_ms:.3f} ms (median of {sc_times}), plain {sp_ms:.3f} ms, "
          f"bound {sc_bound:.3f} ms ({sc_by}), work {sc_stats} on {card}",
          flush=True)
    if not abs(rel_mean) < 0.05:
        raise AssertionError(f"adaptive mean {a_mean} is off the render's")
    ncfg = vpt_torch.RenderConfig(width=256, height=256, spp=16,
                                  max_bounces=cfg.max_bounces)
    reset_counts()
    t0 = time.perf_counter()
    nimg, n_spp, n_se = vpt_torch.render_to_noise(
        scene, camera, ncfg, target_rel_se=0.05, batch_spp=16,
        device="cuda")
    n_s = time.perf_counter() - t0
    launched_n = dict(wf.LAUNCHES_BY)
    print(f"phase 13 render_to_noise 256x256 (batches of 16 spp, target "
          f"0.05): {n_spp} spp, median rel SE {n_se:.6f}, {n_s:.3f} s, "
          f"launches {launched_n} on {card}", flush=True)
    if launched_n != {"vpt_wavefront_free_nee": n_spp // 16} or \
            not np.isfinite(n_se) or not bool(torch.isfinite(nimg).all()):
        raise AssertionError(f"render_to_noise: launches {launched_n}, SE "
                             f"{n_se}")

    common = {"route": "cuda", "library_ms": None, "card": card}
    records += [
        {"name": "diff_fwd", **common, "source": "vpt_torch/csrc/diff.cu",
         "replaces": "vpt/kernels/diff.py:1274",
         "launches": launched_pair["diff_fwd"],
         "launches_train": launched_train["diff_fwd"],
         "max_abs_err": err_k2, "q99_rel_err": q_k2,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "plain_alone": False,
         "bound_ms": k2_bound, "bound_by": k2_by,
         "fwd_bwd_ms": pair_ms},
        {"name": "diff_bwd", **common, "source": "vpt_torch/csrc/diff.cu",
         "replaces": "vpt/kernels/diff.py:1303",
         "launches": launched_pair["diff_bwd"],
         "launches_train": launched_train["diff_bwd"],
         "max_abs_err": err_k3, "per_pixel_q99_rel_err": q_k3,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "plain_alone": True,
         "checked_spp": CHECK_SPP, "ms_at_checked_spp": k3_4_ms,
         "bound_ms": k3_bound, "bound_by": k3_by},
        {"name": "geom_fwd", **common, "source": "vpt_torch/csrc/geom.cu",
         "replaces": "vpt/kernels/geom.py:609",
         "launches": launched_geom["geom_fwd"],
         "launches_fit_geom": launched_fit["geom_fwd"],
         "launches_fit_geom_fd": launched_fd["geom_fwd"],
         "max_abs_err": err_k7, "worst_plane_q99": q_k7,
         "ms": k4k_ms, "plain_ms": k7_plain_ms, "plain_alone": False,
         "main_path_ms": k4_ms,
         "checked_spp": GEOM_CHECK_SPP, "ms_at_checked_spp": k7_2_ms,
         "bound_ms": k4_bound, "bound_by": k4_by,
         "paths_per_sec": n_paths / (k4_ms / 1e3),
         "k0_ms": k0_ms, "k0_plain_ms": k0_plain_ms,
         "k0_bound_ms": k0_bound,
         "k0_max_abs_err": err_k0, "k1_random_ms": k1r_ms,
         "fit_geom_fd_residual": resid},
    ]
    # K1's instantiations: the first variant of each is its row's time
    sources = {"vpt_wavefront_free_nee": ("wavefront.cu", ":464-493"),
               "vpt_wavefront_free_implicit": ("wavefront_free_implicit.cu",
                                               ":464-493, :654-665"),
               "vpt_wavefront_ea_nee": ("wavefront_ea.cu", ":494-535"),
               "vpt_wavefront_eac_implicit": ("wavefront_eac_implicit.cu",
                                              ":536-574")}
    for entry, (src, branch) in sources.items():
        rows = [r for r in var_rows if r["entry"] == entry]
        fields = {"instantiation": entry, "branch": branch, "variants": rows,
                  "phase12_launches": sum(r["launches"] for r in rows)}
        if entry == "vpt_wavefront_free_nee":
            records[0].update(fields, estimator_means=emeans)
            continue
        records.append({
            "name": entry[4:], **common,
            "source": f"vpt_torch/csrc/{src}",
            "replaces": "vpt/kernels/wavefront.py:230",
            "launches": fields["phase12_launches"],
            "max_abs_err": rows[0]["max_abs_err"], "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"], "plain_alone": False,
            "bound_ms": rows[0]["bound_ms"],
            "bound_by": rows[0]["bound_by"], **fields})
    records.append({
        "name": "wavefront_free_nee_scatter", **common,
        "source": "vpt_torch/csrc/wavefront.cu",
        "replaces": "vpt/kernels/wavefront.py:799",
        "launches": launched_a["vpt_wavefront_free_nee_scatter"],
        "max_abs_err": s_err, "ms": sc_ms, "plain_ms": sp_ms,
        "plain_alone": True,
        "bound_ms": sc_bound, "bound_by": sc_by, "adaptive_ms": a_ms,
        "adaptive_tiles": [go.k, pk1.num_tiles, pk2.spp],
        "noise_spp": n_spp, "noise_rel_se": n_se, "noise_s": n_s,
        "scatter_checks_128x64x4": scat_check})
    print(f"phases 1-13: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 14: the density fields
    records += field_phases(card, dev, camera, cfg, seed_t, plains)
    print(f"phases 1-14: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 15: the HG phase in the pair, the multi-view trainer and
    # the recovery examples
    records += hg_phases(card, dev, camera, cfg, seed_t, free_ms, plains)
    print(f"phases 1-15: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 16: voxel grids in K1 and the pair, fit_grid, recover_grid
    records += grid_phases(card, dev, camera, plains)
    print(f"phases 1-16: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 17: the rest of the pair: equi-angular, the implicit and
    # physical estimators, shells, HG in a grid
    records += ext_phases(card, dev, camera, plains)
    print(f"phases 1-17: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 18: the rest of the dual kernel K4: equi-angular, the
    # implicit and physical estimators, a baked HG g, shells; recover_camera
    records += geom_ext_phases(card, dev, camera, plains)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
