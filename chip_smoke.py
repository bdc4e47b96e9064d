"""Smoke run of the vpt_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA render kernel from the sources in this checkout, checks it
against its plain torch version on the card, drives the main path (the
forward render of cornell_vpt at 1024x1024, 64 spp, sampler "ld",
max_bounces 32) through vpt_torch.render, checks that the render went
through the kernel and agrees with the plain version pixel by pixel, and
times both. Each phase prints one line; the line before the last is the
per-kernel JSON record, the last line the device record. Any failed phase
raises and the script exits non-zero; without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

import vpt_torch
from vpt_torch.kernels import _build
from vpt_torch.kernels import wavefront as wf

# pixel-by-pixel agreement: the 99th percentile of |a-b| / max(1, |ref|max)
# stays below 1e-4. The kernel and the plain version round the same f32
# operations in the same order with the same device math (expf, log1pf,
# sinf, cosf, rsqrtf), and agree bit for bit on an H100 with torch 2.11. The
# quantile leaves room for a torch build whose CUDA ops use other math
# functions: an ulp of difference can flip a rare discrete event (a
# visibility or Fresnel choice) and change a few pixels by a lot.
Q99_TOL = 1e-4

MAIN_CFG = dict(width=1024, height=1024, spp=64, sampler="ld", max_bounces=32)


def q99_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    rel = (a - ref).abs() / max(1.0, float(ref.abs().max()))
    return float(torch.quantile(rel.flatten().double().cpu(), 0.99))


def cuda_ms(fn) -> tuple[object, float]:
    """Run fn once between two CUDA events; (result, milliseconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main() -> int:
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

    # ---- phase 2: build the kernel from this checkout's sources
    t0 = time.perf_counter()
    lib = _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {build_s:.2f} s -> {_build.library_path().name}; "
          f"VptParams {lib.vpt_params_words()} words; ptxas: "
          f"{' | '.join(ptxas)}", flush=True)

    dev = torch.device("cuda", 0)
    scene = vpt_torch.cornell_vpt()
    camera = vpt_torch.default_camera()

    # ---- phase 3: kernel against its plain version, small frame
    for sampler in ("random", "ld"):
        for seed in (3, 11):
            pk = wf.pack_scene(scene, camera, 64, 32, 8, max_bounces=8,
                               sampler=sampler)
            s = torch.tensor([seed], dtype=torch.int32, device=dev)
            k = wf.render_tile(pk, s)
            p = wf.render_tile_plain(pk, s)
            torch.cuda.synchronize()
            q = q99_rel(k, p)
            print(f"phase 3 check 64x32x8 {sampler} seed {seed}: "
                  f"q99 rel {q:.3e}, max abs {float((k - p).abs().max()):.3e}",
                  flush=True)
            if not bool(torch.isfinite(k).all()) or not q < Q99_TOL:
                raise AssertionError(f"kernel disagrees with plain version: "
                                     f"q99 {q} (tolerance {Q99_TOL})")

    # ---- phase 4: the main path through the public API
    cfg = vpt_torch.RenderConfig(**MAIN_CFG)
    wf.LAUNCHES = 0
    img, main_ms = cuda_ms(lambda: vpt_torch.render(scene, camera, cfg,
                                                    device="cuda"))
    launches = wf.LAUNCHES
    if launches < 1:
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
    plain, plain_ms = cuda_ms(lambda: wf.render_tile_plain(pk, seed_t))
    flat = img.reshape(-1, 3)
    q_main = q99_rel(flat, plain)
    err_main = float((flat - plain).abs().max())
    mean = [round(float(v), 6) for v in img.mean(dim=(0, 1))]
    print(f"phase 4 main path {cfg.width}x{cfg.height}x{cfg.spp} "
          f"{cfg.sampler}: {launches} kernel launch(es), channel means "
          f"{mean}, vs plain q99 rel {q_main:.3e}, max abs {err_main:.3e}",
          flush=True)
    if not q_main < Q99_TOL:
        raise AssertionError(f"main path disagrees with plain version: "
                             f"q99 {q_main} (tolerance {Q99_TOL})")

    # ---- phase 5: throughput (CUDA events; median of 3 after a warm-up)
    wf.render_tile(pk, seed_t)
    times = [cuda_ms(lambda: wf.render_tile(pk, seed_t))[1] for _ in range(3)]
    kernel_ms = statistics.median(times)
    n_paths = cfg.width * cfg.height * cfg.spp
    print(f"phase 5 kernel: {n_paths / (kernel_ms / 1e3):.6e} camera paths/s "
          f"({kernel_ms:.3f} ms median of {[round(t, 3) for t in times]}) "
          f"on {card}", flush=True)
    print(f"phase 5 plain: {n_paths / (plain_ms / 1e3):.6e} camera paths/s "
          f"({plain_ms:.3f} ms, one run) on {card}", flush=True)

    record = {"kernels": [{
        "name": "wavefront_fwd",
        "route": "cuda",
        "source": "vpt_torch/csrc/wavefront.cu",
        "replaces": "vpt/kernels/wavefront.py:230",
        "launches": launches,
        "max_abs_err": err_main,
        "q99_rel_err": q_main,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "main_path_ms": main_ms,
        "card": card,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
