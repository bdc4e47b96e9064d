"""Command-line entry point (counterpart of ``vpt/cli.py``).

Mirrors the reference's `./rt <spp>`: render the active scene at 1024x768
with the active integrator, write `image.ppm`, print the elapsed wall clock
(src/rt.cpp:824-827).

Usage:
  python -m vpt_torch.cli 64                    # on the GPU, spp only
  python -m vpt_torch.cli --device cpu --spp 4 --width 64 --height 48
  python -m vpt_torch.cli --spp 64 --integrator explicit_equiangular \
      --hg-g 0.5 --adaptive -o out.ppm
  torchrun --nproc_per_node=1 -m vpt_torch.cli 64 --sharded
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from .kernels.wavefront import KERNEL_INTEGRATORS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vpt_torch", description=__doc__)
    p.add_argument("spp_pos", nargs="?", type=int, default=None,
                   help="samples per pixel (positional, reference-style argv[1])")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--width", type=int, default=1024)    # src/rt.cpp:752
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--integrator", default="explicit_free",
                   help="one of vpt's fused-kernel integrators: "
                        + ", ".join(sorted(KERNEL_INTEGRATORS)))
    p.add_argument("--scene", default="cornell_vpt")
    p.add_argument("--scene-file", default=None,
                   help="JSON scene file (vpt_torch.scene.io, same schema as "
                        "vpt's) — overrides --scene; uses the file's camera")
    p.add_argument("--dump-scene", default=None, metavar="FILE",
                   help="write the resolved scene + camera as JSON and exit")
    # None: an unset flag defers to the scene's own medium
    p.add_argument("--sigma-a", type=float, default=None)
    p.add_argument("--sigma-s", type=float, default=None)
    p.add_argument("--hg-g", type=float, default=None, metavar="G",
                   help="Henyey-Greenstein anisotropy in (-1,1); default: the "
                        "scene's (0, isotropic, for every built-in scene)")
    p.add_argument("--max-bounces", type=int, default=32)
    p.add_argument("--continue-prob", type=float, default=0.6)
    p.add_argument("--seed", type=int, default=0)
    # vpt's engine renderers dispatch this many pixels at a time; the
    # kernel renders the frame in one launch and ignores it
    p.add_argument("--chunk-pixels", type=int, default=65536)
    p.add_argument("--no-jitter", action="store_true")
    p.add_argument("--renderer", default="auto",
                   help="auto | kernel (vpt's 'pallas' is read as kernel)")
    p.add_argument("--sampler", default="random", choices=["random", "ld"],
                   help="ld: low-discrepancy first-5-dim stratification")
    p.add_argument("--target-noise", type=float, default=None, metavar="SE",
                   help="render batches of --spp until the median per-pixel "
                        "relative standard error reaches SE "
                        "(vpt_torch.render_to_noise)")
    p.add_argument("--max-spp", type=int, default=4096,
                   help="total spp cap for --target-noise")
    p.add_argument("--adaptive", action="store_true",
                   help="two-pass variance-guided adaptive sampling "
                        "(spp must be even)")
    p.add_argument("--adaptive-boost", type=float, default=3.0,
                   help="extra samples on hot tiles = boost*spp/2")
    p.add_argument("--adaptive-frac", type=float, default=0.25,
                   help="fraction of tiles that get the boost pass")
    p.add_argument("-o", "--output", default="image.ppm")
    p.add_argument("--device", default="cuda",
                   help="cuda: the CUDA kernel; cpu: its plain torch version")
    p.add_argument("--sharded", action="store_true",
                   help="render over the ranks of the process group (one per "
                        "device, e.g. under torchrun) via the (data, sample) "
                        "mesh; one process without one")
    # vpt's flags whose paths are not ported yet: accepted, then refused
    p.add_argument("--checkpoint", default=None,
                   help="not ported yet (ROADMAP Queue 1 item 9)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="not ported yet (ROADMAP Queue 1 item 9)")
    p.add_argument("--preview", default=None,
                   help="not ported yet (ROADMAP Queue 1 item 9)")
    p.add_argument("--preview-every", type=int, default=0,
                   help="not ported yet (ROADMAP Queue 1 item 9)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.spp_pos is not None:
        args.spp = args.spp_pos
    if args.checkpoint or args.checkpoint_every or args.preview \
            or args.preview_every:
        raise NotImplementedError(
            "--checkpoint/--preview: vpt's progressive renderer runs its XLA "
            "engine, ROADMAP Queue 1 item 9")

    import torch
    import torch.distributed as dist

    import vpt_torch
    from vpt_torch.io.ppm import write_ppm
    from vpt_torch.scene.scene import SCENES, Medium

    if args.scene_file:
        scene, file_cam = vpt_torch.load_scene(args.scene_file)
    else:
        scene, file_cam = SCENES[args.scene](), None
    med = scene.medium
    sigma_a = med.sigma_a if args.sigma_a is None else torch.tensor(args.sigma_a)
    sigma_s = med.sigma_s if args.sigma_s is None else torch.tensor(args.sigma_s)
    g = med.g if args.hg_g is None else torch.tensor(args.hg_g)
    dtype = scene.radius.dtype
    scene = dataclasses.replace(
        scene, medium=Medium(sigma_a.to(dtype), sigma_s.to(dtype),
                             torch.as_tensor(g).to(dtype), med.density))
    camera = file_cam if file_cam is not None else vpt_torch.default_camera()
    if args.dump_scene:
        vpt_torch.save_scene(args.dump_scene, scene, camera)
        print(f"wrote {args.dump_scene}")
        return 0
    cfg = vpt_torch.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        integrator=args.integrator, max_bounces=args.max_bounces,
        continue_prob=args.continue_prob, seed=args.seed,
        chunk_pixels=args.chunk_pixels, jitter=not args.no_jitter, renderer=args.renderer,
        sampler=args.sampler,
    )

    t0 = time.time()
    effective_spp = args.spp          # --target-noise overrides with actual
    if args.sharded:
        from vpt_torch.dist import render_sharded
        from vpt_torch.dist.multihost import global_mesh, initialize

        initialize()
        img = render_sharded(scene, camera, cfg,
                             global_mesh(device=args.device))
    elif args.target_noise is not None:
        img, spp_used, achieved = vpt_torch.render_to_noise(
            scene, camera, cfg, target_rel_se=args.target_noise,
            max_spp=args.max_spp, log=print, device=args.device)
        effective_spp = spp_used
        print(f"render_to_noise: stopped at {spp_used} spp "
              f"(median rel SE {achieved:.4f})")
    elif args.adaptive:
        img = vpt_torch.render_adaptive(
            scene, camera, cfg, boost=args.adaptive_boost,
            frac=args.adaptive_frac, device=args.device)
    else:
        img = vpt_torch.render(scene, camera, cfg, device=args.device)
    img = img.cpu()
    elapsed = time.time() - t0

    if dist.is_initialized() and dist.get_rank() != 0:
        return 0                    # every rank holds the frame; one writes
    write_ppm(args.output, img)
    n_paths = args.width * args.height * effective_spp
    # reference prints "elapsed time: <s>s" (src/rt.cpp:824-827)
    print(f"elapsed time: {elapsed:.5g}s  "
          f"({n_paths / max(elapsed, 1e-9):.3e} paths/s on {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
