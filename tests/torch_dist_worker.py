"""One rank of tests/test_torch_dist.py's two-rank gloo runs.

Not a test module: test_torch_dist.py starts one process per rank, as
tests/test_multihost.py starts vpt's. Each rank joins a gloo process group
on 127.0.0.1, builds the (2, 1) and (1, 2) meshes of the world of two, runs
the port's sharded entries on the CPU (their plain versions) and writes
what it got to an npz file that the test compares with the single-process
results.

argv: <rank> <world> <port> <out.npz>

The shared inputs (frames, scenes, seeds) live here, and the test imports
them.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import vpt_torch  # noqa: E402
from vpt_torch.dist import (make_kernel_train_step,  # noqa: E402
                            make_mesh, make_sharded_fd_geom_train_step,
                            make_sharded_kernel_train_step)
from vpt_torch.dist.multihost import assemble_image  # noqa: E402
from vpt_torch.dist.sharded_pallas import render_pallas_sharded  # noqa: E402
from vpt_torch.dist.train_fast import adam  # noqa: E402
from vpt_torch.kernels import diff as df  # noqa: E402
from vpt_torch.kernels import geom as gm  # noqa: E402
from vpt_torch.kernels import wavefront as wf  # noqa: E402
from vpt_torch.media.density import grid  # noqa: E402

# K1: 96x64 is 1.5 of its 4096-lane tiles, so the second data rank's shard
# runs past the frame
K1_CFG = dict(width=96, height=64, spp=4, max_bounces=3, seed=7)
# the pair and K4: 48x32 at tile_rows 8 is 1.5 tiles of 1024 lanes
W, H, SPP, MB, TILE_ROWS = 48, 32, 4, 3, 8
STEP_SEED = 5
LR = 2e-3
FD_LIGHT, FD_LR = 8, 0.3


def k1_cfg():
    return vpt_torch.RenderConfig(**K1_CFG)


def step_target():
    rng = np.random.default_rng(1)
    return torch.from_numpy((0.1 * rng.random((W * H, 3))).astype(
        np.float32))


def grid_scene():
    """blob_cloud with a 4^3 voxel grid for its density (the diff_grid
    step's scene)."""
    sc = vpt_torch.SCENES["blob_cloud"]()
    vals = np.random.default_rng(2).uniform(0.2, 1.0, (4, 4, 4))
    fld = grid(vals, origin=(-28.0, -18.0, 150.0),
               spacing=(56.0 / 3, 42.0 / 3, 15.0), n_march=8)
    return dataclasses.replace(sc, medium=dataclasses.replace(
        sc.medium, density=fld))


def kernel_step(mesh, scene, diff_grid=False):
    """One sharded kernel step on `mesh` from pack_params(scene) (mesh
    None: make_kernel_train_step's, the whole frame on the CPU): (loss,
    the updated leaves flattened, the all-reduced gradient flattened). A
    rank that applied its own shard's gradient would leave the replicas
    apart after it."""
    params = {k: v.requires_grad_() for k, v in df.pack_params(
        scene, with_grid=diff_grid).items()}
    cam, opt = vpt_torch.default_camera(), adam(params, LR)
    if mesh is None:
        step = make_kernel_train_step(scene, cam, W, H, SPP, opt,
                                      max_bounces=MB, diff_grid=diff_grid,
                                      device="cpu")
    else:
        step = make_sharded_kernel_train_step(
            scene, cam, W, H, SPP, opt, mesh, max_bounces=MB,
            tile_rows=TILE_ROWS, diff_grid=diff_grid)
    loss = float(step(params, step_target(), STEP_SEED))
    grad = torch.cat([v.grad.reshape(-1) for v in params.values()])
    flat = torch.cat([v.detach().reshape(-1) for v in params.values()])
    return np.float32(loss), flat.numpy(), grad.numpy()


def fd_step(mesh):
    """One sharded FD step over the point light's centre: (loss, theta
    flattened)."""
    scene, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    theta = fd_theta(scene, cam)
    step = make_sharded_fd_geom_train_step(
        scene, cam, W, H, SPP, adam(theta, FD_LR), mesh, sphere=FD_LIGHT,
        cam_grads=False, max_bounces=MB)
    loss = float(step(theta, torch.full((W * H, 3), 0.05), STEP_SEED))
    return np.float32(loss), gm.flatten_theta(theta).numpy()


def fd_theta(scene, cam):
    """The FD steps' start: the point light 4 units off in y."""
    theta = gm.pack_theta(scene, cam, FD_LIGHT)
    theta["center"] = theta["center"] + torch.tensor([0.0, 4.0, 0.0])
    return theta


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    from vpt_torch.dist.multihost import initialize
    initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    m21 = make_mesh(sample_shards=1, device="cpu")
    m12 = make_mesh(sample_shards=2, device="cpu")
    scene, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    cfg = k1_cfg()
    res = {"coords": np.asarray([m21.di, m21.si, m12.di, m12.si])}
    res["r21"] = render_pallas_sharded(scene, cam, cfg, m21).numpy()
    res["r12"] = render_pallas_sharded(scene, cam, cfg, m12).numpy()
    # assemble_image from this rank's raw shard of the (2, 1) mesh
    pk = wf.pack_config(scene, cam, cfg)
    shard = -(-pk.npix // (wf.LANES_PER_TILE * 2)) * wf.LANES_PER_TILE
    seed = torch.tensor([cfg.seed], dtype=torch.int32)
    local = wf.make_raw(pk, shard // wf.LANES_PER_TILE)(seed, m21.di * shard)
    res["asm"] = assemble_image(local / torch.tensor(float(cfg.spp)), cfg,
                                m21).numpy()
    res["k_loss"], res["k_params"], res["k_grad"] = kernel_step(m21, scene)
    res["g_loss"], res["g_params"], _ = kernel_step(m21, grid_scene(), True)
    res["fd21_loss"], res["fd21_theta"] = fd_step(m21)
    res["fd12_loss"], res["fd12_theta"] = fd_step(m12)
    np.savez(out, **res)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
