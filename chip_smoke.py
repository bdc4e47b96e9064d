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
     0.05), timed.

Each main path (phases 4, 7, 8, 10, 11, 12 and 13) runs with every launch
count set to 0 just before it and read just after. The line before the last is the
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


def median_ms(fn, n: int = 3) -> tuple[float, list]:
    """Median of n CUDA-event timings after one warm-up run."""
    fn()
    times = [cuda_ms(fn)[1] for _ in range(n)]
    return statistics.median(times), [round(t, 3) for t in times]


def reset_counts() -> None:
    wf.LAUNCHES_BY.clear()
    df.LAUNCHES_FWD = 0
    df.LAUNCHES_BWD = 0
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
def variant_ops_lower_bound(stats: dict, pk: wf.Packed) -> float:
    S, M = pk.S, len(pk.mis_lights)
    ea = pk.distance != "free"
    hg = pk.g != 0.0
    it = 41 + 23 * S + (60 if ea else 0)
    shade = 72 + ((136 + 109 * M + 23 * S * (2 + M)) if pk.nee else 0)
    medium = (14 + ((88 + 23 * S) if pk.nee else 0) + (8 if ea else 0)
              + (30 if hg else 0) + (12 if hg and pk.nee else 0))
    return float(stats["thread_iters"] * it + pk.npix * pk.spp * 29
                 + stats["shade"] * shade + stats["medium"] * medium)


def variant_bound(stats: dict, pk: wf.Packed,
                  n_lanes: int | None = None) -> tuple[float, str]:
    t_ops = variant_ops_lower_bound(stats, pk) / PEAK_F32 * 1e3
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


def main() -> int:
    t_start = time.perf_counter()
    # ---- phase 1: the card
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; no result")
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
    k1_stats = {}
    plain, plain_ms = cuda_ms(lambda: wf.render_tile_plain(pk, seed_t,
                                                           k1_stats))
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

    # ---- phase 5: K1 throughput (CUDA events; median of 3 after a warm-up)
    kernel_ms, times = median_ms(lambda: wf.render_tile(pk, seed_t))
    n_paths = cfg.width * cfg.height * cfg.spp
    dp_main = df.pack_diff(scene, camera, cfg.width, cfg.height, cfg.spp,
                           max_bounces=cfg.max_bounces, sampler=cfg.sampler)
    k1_bound, k1_by = bound("wavefront_fwd", k1_stats, dp_main)
    print(f"phase 5 K1: {n_paths / (kernel_ms / 1e3):.6e} camera paths/s "
          f"({kernel_ms:.3f} ms median of {times}); plain {plain_ms:.3f} ms "
          f"(one run); bound {k1_bound:.3f} ms ({k1_by}) on {card}",
          flush=True)
    records = [{
        "name": "wavefront_fwd", "route": "cuda",
        "source": "vpt_torch/csrc/wavefront.cu",
        "replaces": "vpt/kernels/wavefront.py:230",
        "launches": launched["wavefront_fwd"],
        "max_abs_err": err_main, "q99_rel_err": q_main,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
        "main_path_ms": main_ms, "main_path_warm_ms": warm_ms,
        "card": card,
    }]

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
    pair_stats = {}
    k2_plain, k2_plain_ms = cuda_ms(lambda: df.diff_fwd_plain(
        dp, pvec, seed_t, stats=pair_stats))
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

    # ---- phase 9: K4 against its plain version, small frame
    for K_kw, sampler, seed in (
            (dict(), "random", 3), (dict(), "random", 11), (dict(), "ld", 3),
            (dict(), "ld", 11), (dict(dir_grads=True), "random", 3),
            (dict(primal_only=True), "random", 3)):
        gp = gm.pack_geom(scene, camera, 64, 32, 8, sphere=8, max_bounces=8,
                          sampler=sampler, **K_kw)
        th = gm.flatten_theta(gm.pack_theta(scene, camera, 8)).to(dev)
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        k = gm.geom_fwd(gp, th, s)
        p = gm.geom_fwd_plain(gp, th, s)
        torch.cuda.synchronize()
        q, err, shares = plane_check(k, p, gp.K)
        print(f"phase 9 K4 check 64x32x8 K={gp.K} {sampler} seed {seed}: "
              f"worst plane q99 {q:.3e}, max abs {err:.3e}; bit-equal share "
              f"per plane {shares}", flush=True)
        if not bool(torch.isfinite(k).all()) or not q < Q99_TOL:
            raise AssertionError(f"K4 (K={gp.K}) disagrees with its plain "
                                 f"version: worst plane q99 {q}")

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
    geom_stats = {}
    k0_plain, k0_plain_ms = cuda_ms(lambda: gm.geom_fwd_plain(
        gp0, thv, seed_t, stats=geom_stats))
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
    k7_2p, k7_plain_ms = cuda_ms(lambda: gm.geom_fwd_plain(gp2, thv, seed_t))
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
    main_key = (*wf.KERNEL_INTEGRATORS[cfg.integrator], "cornell_vpt", 0.0)
    plains = {main_key: (plain, k1_stats, plain_ms)}
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
        if key not in plains:
            vstats = {}
            vplain, vp_ms = cuda_ms(lambda: wf.render_tile_plain(pk, seed_t,
                                                                 vstats))
            plains[key] = (vplain, vstats, vp_ms)
        vplain, vstats, vp_ms = plains[key]
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
    del plains, vplain
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
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by,
         "fwd_bwd_ms": pair_ms},
        {"name": "diff_bwd", **common, "source": "vpt_torch/csrc/diff.cu",
         "replaces": "vpt/kernels/diff.py:1303",
         "launches": launched_pair["diff_bwd"],
         "launches_train": launched_train["diff_bwd"],
         "max_abs_err": err_k3, "per_pixel_q99_rel_err": q_k3,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "checked_spp": CHECK_SPP, "ms_at_checked_spp": k3_4_ms,
         "bound_ms": k3_bound, "bound_by": k3_by},
        {"name": "geom_fwd", **common, "source": "vpt_torch/csrc/geom.cu",
         "replaces": "vpt/kernels/geom.py:609",
         "launches": launched_geom["geom_fwd"],
         "launches_fit_geom": launched_fit["geom_fwd"],
         "launches_fit_geom_fd": launched_fd["geom_fwd"],
         "max_abs_err": err_k7, "worst_plane_q99": q_k7,
         "ms": k4k_ms, "plain_ms": k7_plain_ms, "main_path_ms": k4_ms,
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
            "plain_ms": rows[0]["plain_ms"], "bound_ms": rows[0]["bound_ms"],
            "bound_by": rows[0]["bound_by"], **fields})
    records.append({
        "name": "wavefront_free_nee_scatter", **common,
        "source": "vpt_torch/csrc/wavefront.cu",
        "replaces": "vpt/kernels/wavefront.py:799",
        "launches": launched_a["vpt_wavefront_free_nee_scatter"],
        "max_abs_err": s_err, "ms": sc_ms, "plain_ms": sp_ms,
        "bound_ms": sc_bound, "bound_by": sc_by, "adaptive_ms": a_ms,
        "adaptive_tiles": [go.k, pk1.num_tiles, pk2.spp],
        "noise_spp": n_spp, "noise_rel_se": n_se, "noise_s": n_s,
        "scatter_checks_128x64x4": scat_check})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
