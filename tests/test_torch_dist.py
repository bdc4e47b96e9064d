"""vpt_torch's sharded entries: the shard range of K2/K3, K4's make_raw and
K1's contiguous make_raw, the (data, sample) mesh on torch.distributed,
render_sharded and the two sharded train steps.

Two kinds of check, started together at the first test (their processes
run beside each other and beside the single-process work of the tests):

  - one vpt reference subprocess (interpret mode, XLA:CPU capped at AVX,
    tests/test_torch_wavefront.reference_env) on light_near_camera (3
    spheres: the cheapest compiles) at 48x32, 2 spp, max_bounces 3,
    "random", seed 3, tile_rows 8: a frame of 1.5 tiles of 1024 lanes, so
    the second tile (base 1024) holds 512 lanes past the frame. vpt's
    make_shard(1) forward on every lane of that tile and its VJP, and vpt's
    K4 make_raw(1) at K = 0 on the same lanes. The port's plain shard twins
    are held to them at tests/test_torch_diff.py's image and gradient
    criteria (image q99 < 1e-4 of its scale; flip lanes, more than 1e-4 of
    the scale apart, zeroed in vpt's cotangent and left out of the port's
    sum; each gradient entry within 2e-4 of sum_lanes |G_lane, k|) and
    tests/test_torch_geom_fd.py's for K4's primal;
  - two ranks of a gloo process group on 127.0.0.1
    (tests/torch_dist_worker.py), port against port, on the CPU: the (2, 1)
    and (1, 2) meshes of the world of two against the single process (a
    (1, 1) mesh, or the unsharded entries).

The single-process kernel steps (the (1, 1) mesh) are held to
make_kernel_train_step (gradient and updated leaves bit for bit, the loss
at rtol 1e-6) and the (2, 1) FD step to make_fd_geom_train_step; those
unsharded steps are held to vpt's single-device steps in
tests/test_torch_diff.py (test_train_step_matches_vpt) and
tests/test_torch_geom_fd.py (test_fd_step_matches_vpt): with the
comparisons here that closes the chain from the sharded steps to vpt.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import vpt_torch
from vpt_torch.dist import (make_fd_geom_train_step, make_mesh,
                            mesh_shape_for, render_sharded)
from vpt_torch.dist.sharded_pallas import render_pallas_sharded
from vpt_torch.dist.train_fast import adam
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import geom as gm
from test_torch_wavefront import REFERENCE_TIMEOUT_S, reference_env
import torch_dist_worker as wk

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# the vpt reference's frame: 1.5 tiles of tile_rows * 128 lanes
RW, RH, RSPP, RMB, RSEED, RTILE = 48, 32, 2, 3, 3, 8
BASE = RTILE * 128                  # the second tile
RLIGHT = 2                          # light_near_camera's emitter
Q99_TOL = 1e-4
FLIP_TOL = 1e-4
GRAD_TOL = 2e-4

_JAX_REF = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
import jax.numpy as jnp
import vpt
from vpt.kernels.diff import make_diff_renderer, pack_params
from vpt.kernels.geom import make_geom_renderer, pack_theta
with open(sys.argv[1]) as f:
    job = json.load(f)
inp = np.load(job["inputs"])
scene, cam = vpt.SCENES[job["scene"]](), vpt.default_camera()
W, H, spp, mb = job["width"], job["height"], job["spp"], job["max_bounces"]
seed, base = jnp.int32(job["seed"]), jnp.int32(job["base"])
render = make_diff_renderer(scene, cam, W, H, spp, max_bounces=mb,
                            tile_rows=job["tile_rows"], interpret=True)
shard = render.make_shard(1)
params = pack_params(scene)
img, vjp = jax.vjp(lambda p: shard(p, seed, base), params)
img = np.asarray(img)
rel = (np.abs(img - inp["port_img"]).max(-1)
       / max(1.0, float(np.abs(img).max())))
flip = np.flatnonzero(rel > job["flip_tol"])
gbar = inp["gbar"].copy()
gbar[flip] = 0.0
g = vjp(jnp.asarray(gbar))[0]
grad = np.concatenate([np.asarray(g[k]).reshape(-1) for k in
                       ("sigma_a", "sigma_s", "albedo", "radiance")])
geom = make_geom_renderer(scene, cam, W, H, spp, sphere=job["light"],
                          cam_grads=False, max_bounces=mb, primal_only=True,
                          tile_rows=job["tile_rows"], interpret=True)
theta = geom.flatten(pack_theta(scene, cam, job["light"]))
k4, tang = geom.make_raw(1)(theta, seed, base)
np.savez(job["out"], img=img, flip=flip, grad=grad, k4=np.asarray(k4),
         k4_tang=np.asarray(tang))
"""


def ref_scene():
    return vpt_torch.SCENES["light_near_camera"]()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_inputs():
    """The port's shard image (for vpt's flip lanes) and the cotangent."""
    scene = ref_scene()
    render = df.make_diff_renderer(scene, vpt_torch.default_camera(), RW, RH,
                                   RSPP, max_bounces=RMB, tile_rows=RTILE,
                                   device="cpu")
    img = render.make_shard(1)(df.pack_params(scene), RSEED, BASE)
    gbar = np.random.default_rng(0).standard_normal(
        (RTILE * 128, 3)).astype(np.float32)
    return render, img.detach().numpy(), gbar


class _Runs:
    """The vpt reference and the two ranks, started at once."""

    def __init__(self, tmp):
        self.tmp = tmp
        _, port_img, gbar = _ref_inputs()
        inputs = os.path.join(tmp, "in.npz")
        np.savez(inputs, port_img=port_img, gbar=gbar)
        self.ref_out = os.path.join(tmp, "ref.npz")
        job = dict(inputs=inputs, out=self.ref_out,
                   scene="light_near_camera", width=RW, height=RH, spp=RSPP,
                   max_bounces=RMB, seed=RSEED, base=BASE, tile_rows=RTILE,
                   light=RLIGHT, flip_tol=FLIP_TOL)
        spec = os.path.join(tmp, "job.json")
        with open(spec, "w") as f:
            json.dump(job, f)
        self.ref = subprocess.Popen(
            [sys.executable, "-c", _JAX_REF, spec], cwd=REPO,
            env=reference_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        port = str(_free_port())
        self.rank_out = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.ranks = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
             str(r), "2", port, self.rank_out[r]], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        self._ref = self._ranks = None

    def reference(self) -> dict:
        if self._ref is None:
            _, err = self.ref.communicate(timeout=REFERENCE_TIMEOUT_S)
            assert self.ref.returncode == 0, err[-4000:]
            with np.load(self.ref_out) as z:
                self._ref = {k: z[k] for k in z.files}
        return self._ref

    def rank_results(self) -> list:
        if self._ranks is None:
            for p in self.ranks:
                _, err = p.communicate(timeout=REFERENCE_TIMEOUT_S)
                assert p.returncode == 0, err[-4000:]
            self._ranks = []
            for path in self.rank_out:
                with np.load(path) as z:
                    self._ranks.append({k: z[k] for k in z.files})
        return self._ranks

    def stop(self):
        for p in [self.ref, *self.ranks]:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        r = _Runs(tmp)
        try:
            yield r
        finally:
            r.stop()


@pytest.fixture(scope="module")
def ranks(runs):
    return runs.rank_results()


def test_mesh_shape_for_matches_vpt(runs):
    from vpt.dist.mesh import mesh_shape_for as vpt_mesh_shape_for

    for args in ((8,), (8, 4), (1,), (2,), (2, 1), (2, 2), (6,), (3,)):
        assert mesh_shape_for(*args) == vpt_mesh_shape_for(*args), args
    for args in ((7, 2), (1, 2)):
        with pytest.raises(ValueError):
            vpt_mesh_shape_for(*args)
        with pytest.raises(ValueError):
            mesh_shape_for(*args)
    mesh = make_mesh(device="cpu")      # no process group: one rank
    assert (mesh.n_data, mesh.n_sample, mesh.di, mesh.si) == (1, 1, 0, 0)


def test_no_port_module_imports_jax_or_vpt():
    """Every module of vpt_torch/, read as source: no import of jax or of
    the vpt package, at any depth of the code (the import test of
    tests/test_torch_render.py loads the package's modules)."""
    import ast

    for path in sorted(Path(REPO, "vpt_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "vpt"), \
                    (path, name)


def test_shards_concatenate_to_the_frame(runs):
    """K2's and K4's shards at base 0 and at the second tile are the
    frame's lanes bit for bit (the streams are keyed by the global lane);
    K3's per-lane rows likewise, and its shard gradients sum to the
    frame's within rounding. Lanes past the frame render a clamped
    duplicate in K2 and add nothing in K3."""
    scene, cam = ref_scene(), vpt_torch.default_camera()
    dp = df.pack_diff(scene, cam, RW, RH, RSPP, max_bounces=RMB)
    pvec = df._flatten(df.pack_params(scene), scene.count)
    seed = torch.tensor([RSEED], dtype=torch.int32)
    npix, n = RW * RH, BASE
    full = df.diff_fwd(dp, pvec, seed)
    parts = [df.diff_fwd(dp, pvec, seed, base=b, n=n) for b in (0, BASE)]
    assert torch.equal(torch.cat(parts)[:npix], full)
    gbar = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2 * n, 3)).astype(np.float32))
    G = df.diff_bwd(dp, pvec, seed, gbar[:npix], per_lane=True)
    Gs = [df.diff_bwd(dp, pvec, seed, gbar[b:b + n], per_lane=True, base=b,
                      n=n) for b in (0, BASE)]
    rows = torch.cat(Gs)
    assert torch.equal(rows[:npix], G)
    assert not bool(rows[npix:].any())      # masked: no gradient
    g = df.diff_bwd(dp, pvec, seed, gbar[:npix])
    gs = sum(df.diff_bwd(dp, pvec, seed, gbar[b:b + n], base=b, n=n)
             for b in (0, BASE))
    assert bool((gs - g).abs().le(1e-5 * G.abs().sum(0)).all())
    gp = gm.pack_geom(scene, cam, RW, RH, RSPP, sphere=RLIGHT,
                      cam_grads=False, primal_only=True, max_bounces=RMB)
    th = gm.flatten_theta(gm.pack_theta(scene, cam, RLIGHT))
    k4 = gm.geom_fwd(gp, th, seed)
    k4s = torch.cat([gm.geom_fwd(gp, th, seed, base=b, n=n)
                     for b in (0, BASE)], dim=1)
    assert torch.equal(k4s[:, :npix], k4)


@pytest.mark.parametrize("kind", ["diff_g", "diff_grid"])
def test_make_shard_runs_with_traced_leaves(kind):
    """make_shard with the traced HG g, and with the voxel grid (its own
    voxel gradient per shard), under equi-angular distances: two shards of
    tile_rows = 1 (128 lanes) on a 16x12 frame concatenate to the render,
    and their gradients sum to its gradient within rounding."""
    if kind == "diff_g":
        scene, kw = vpt_torch.cornell_vpt(), dict(diff_g=True)
    else:
        scene, kw = wk.grid_scene(), dict(diff_grid=True)
    render = df.make_diff_renderer(scene, vpt_torch.default_camera(), 16, 12,
                                   2, max_bounces=3, distance="equiangular",
                                   tile_rows=1, device="cpu", **kw)
    assert (render.lanes_per_tile, render.num_tiles) == (128, 2)
    shard = render.make_shard(1)

    def grads(fn):
        params = {k: v.requires_grad_() for k, v in df.pack_params(
            scene, with_g=kind == "diff_g",
            with_grid=kind == "diff_grid").items()}
        img = fn(params)
        img.sum().backward()
        return img.detach(), {k: v.grad for k, v in params.items()}

    img, g = grads(lambda p: render(p, 3))
    parts, gs = grads(lambda p: torch.cat([shard(p, 3, b)
                                           for b in (0, 128)])[:192])
    assert torch.equal(parts, img)
    for k in g:
        assert torch.allclose(gs[k], g[k], rtol=1e-5,
                              atol=1e-5 * float(g[k].abs().max())), k


def test_k1_raw_and_render_sharded_2x1(runs, ranks):
    """(2, 1): every rank's frame bit-equal to vpt_torch.render; the data
    ranks' raw shards assembled (assemble_image) give the same frame."""
    scene, cam, cfg = vpt_torch.cornell_vpt(), vpt_torch.default_camera(), \
        wk.k1_cfg()
    ref = vpt_torch.render(scene, cam, cfg, device="cpu").numpy()
    assert sorted(tuple(r["coords"][:2]) for r in ranks) == [(0, 0), (1, 0)]
    for r in ranks:
        assert np.array_equal(r["r21"], ref)
        assert np.array_equal(r["asm"], ref)
    # the single process: a (1, 1) mesh and the CLI's route
    mesh = make_mesh(device="cpu")
    assert np.array_equal(render_pallas_sharded(scene, cam, cfg,
                                                mesh).numpy(), ref)
    assert np.array_equal(render_sharded(scene, cam, cfg, mesh).numpy(), ref)
    with pytest.raises(NotImplementedError, match="item 9"):
        render_sharded(scene, cam, cfg, mesh, backend="engine")


def test_render_sharded_1x2_is_the_mean_of_two_seeds(ranks):
    """(1, 2): the sample ranks render spp / 2 at seed and seed + 0x9E37;
    the frame is their mean (vpt's pmean)."""
    scene, cam, cfg = vpt_torch.cornell_vpt(), vpt_torch.default_camera(), \
        wk.k1_cfg()
    half = [vpt_torch.render(scene, cam, vpt_torch.RenderConfig(
        **dict(wk.K1_CFG, spp=cfg.spp // 2, seed=cfg.seed + s)), device="cpu")
        for s in (0, 0x9E37)]
    ref = ((half[0] + half[1]) / 2).numpy()
    assert sorted(tuple(r["coords"][2:]) for r in ranks) == [(0, 0), (0, 1)]
    for r in ranks:
        assert np.array_equal(r["r12"], ref)


def _check_kernel_step(ranks, key, d1, unsharded, n_sigma=2):
    """D = 1 against make_kernel_train_step (the whole frame in one
    process): the loss rtol 1e-6, the gradient and the updated leaves bit
    for bit (one shard of the frame's lanes, the lanes past it masked).
    D = 2 against D = 1: losses rtol 1e-6, sigma rtol 1e-5, replicas
    bitwise equal."""
    loss1, params1, grad1 = d1
    np.testing.assert_allclose(loss1, unsharded[0], rtol=1e-6)
    assert np.array_equal(grad1, unsharded[2])
    assert np.array_equal(params1, unsharded[1])
    a, b = ranks
    assert np.array_equal(a[f"{key}_params"], b[f"{key}_params"])
    assert np.array_equal(a[f"{key}_loss"], b[f"{key}_loss"])
    assert np.isfinite(a[f"{key}_params"]).all()
    np.testing.assert_allclose(a[f"{key}_loss"], loss1, rtol=1e-6)
    np.testing.assert_allclose(a[f"{key}_params"][:n_sigma],
                               params1[:n_sigma], rtol=1e-5)
    return a[f"{key}_params"], params1


def test_sharded_kernel_step_d2_matches_d1_and_stays_replicated(ranks):
    """vpt's test_sharded_kernel_train_step_multi_active_shards_stay_
    replicated: both data ranks hold pixels (the second half past the
    frame); the all-reduced gradient matches the single process' within
    rounding; the single process' step is make_kernel_train_step's."""
    scene = vpt_torch.cornell_vpt()
    d1 = wk.kernel_step(make_mesh(device="cpu"), scene)
    p2, p1 = _check_kernel_step(ranks, "k", d1, wk.kernel_step(None, scene))
    g2, g1 = ranks[0]["k_grad"], d1[2]
    assert np.all(np.abs(g2 - g1) <= 1e-5 * np.abs(g1).max() + 1e-6
                  * np.abs(g1))
    init = torch.cat([v.reshape(-1) for v in
                      df.pack_params(scene).values()]).numpy()
    assert not np.array_equal(p2, init)
    np.testing.assert_allclose(p2, p1, rtol=1e-4, atol=1e-6)


def test_sharded_grid_step_d2_matches_d1(ranks):
    """diff_grid on a 4^3 grid: the voxel table is all-reduced with the
    rest, moves, and the replicas stay bitwise equal; the single process'
    step is make_kernel_train_step's."""
    scene = wk.grid_scene()
    d1 = wk.kernel_step(make_mesh(device="cpu"), scene, diff_grid=True)
    p2, p1 = _check_kernel_step(ranks, "g", d1,
                                wk.kernel_step(None, scene, diff_grid=True))
    init = torch.cat([v.reshape(-1) for v in df.pack_params(
        scene, with_grid=True).values()]).numpy()
    vox = slice(len(init) - 64, len(init))
    assert not np.array_equal(p2[vox], init[vox])
    np.testing.assert_allclose(p2, p1, rtol=1e-4, atol=1e-6)


def test_sharded_fd_step_2x1_matches_single_device(ranks):
    """(2, 1) against make_fd_geom_train_step: the loss within rtol 1e-5
    (a sum of two partial sums), the light's centre within vpt's test_dist
    tolerance, the camera untouched; the replicas bitwise equal."""
    scene, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    theta = wk.fd_theta(scene, cam)
    init = gm.flatten_theta(theta).numpy()
    step = make_fd_geom_train_step(scene, cam, wk.W, wk.H, wk.SPP,
                                   adam(theta, wk.FD_LR), sphere=wk.FD_LIGHT,
                                   cam_grads=False, max_bounces=wk.MB,
                                   device="cpu")
    loss = float(step(theta, torch.full((wk.W * wk.H, 3), 0.05),
                      wk.STEP_SEED))
    t1 = gm.flatten_theta(theta).numpy()
    a, b = ranks
    assert np.array_equal(a["fd21_theta"], b["fd21_theta"])
    assert np.isfinite(a["fd21_loss"])
    np.testing.assert_allclose(a["fd21_loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(a["fd21_theta"][:3], t1[:3], rtol=1e-4,
                               atol=1e-5)
    assert not np.array_equal(a["fd21_theta"][:3], init[:3])
    assert np.array_equal(a["fd21_theta"][3:], init[3:])


def test_sharded_fd_step_1x2_moves_only_the_light(ranks):
    scene, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    init = gm.flatten_theta(wk.fd_theta(scene, cam)).numpy()
    a, b = ranks
    assert np.array_equal(a["fd12_theta"], b["fd12_theta"])
    assert np.isfinite(a["fd12_loss"]) and np.isfinite(a["fd12_theta"]).all()
    assert not np.array_equal(a["fd12_theta"][:3], init[:3])
    assert np.array_equal(a["fd12_theta"][3:], init[3:])


def test_cli_sharded_equals_the_plain_render(tmp_path):
    from vpt_torch import cli

    argv = ["--device", "cpu", "--spp", "2", "--width", "24", "--height",
            "16", "--max-bounces", "3"]
    cli.main(argv + ["--sharded", "-o", str(tmp_path / "a.ppm")])
    cli.main(argv + ["-o", str(tmp_path / "b.ppm")])
    assert ((tmp_path / "a.ppm").read_bytes()
            == (tmp_path / "b.ppm").read_bytes())


def test_shard_twins_match_vpt(runs):
    """vpt's make_shard(1) forward and VJP and its K4 make_raw(1) at K = 0,
    at base = the second tile, every lane (512 past the frame)."""
    ref = runs.reference()
    render, img, gbar = _ref_inputs()
    assert img.shape == ref["img"].shape == (BASE, 3)
    rel = np.abs(img - ref["img"]) / max(1.0, float(np.abs(ref["img"]).max()))
    assert np.quantile(rel, 0.99) < Q99_TOL, np.quantile(rel, 0.99)
    assert len(ref["flip"]) <= 2, ref["flip"]
    dp = render.packed
    pvec = df._flatten(df.pack_params(ref_scene()), dp.pk.S)
    seed = torch.tensor([RSEED], dtype=torch.int32)
    G = df.diff_bwd_plain(dp, pvec, seed, torch.from_numpy(gbar),
                          per_lane=True, base=BASE, n=BASE).numpy()
    assert np.isfinite(G).all() and not G[RW * RH - BASE:].any()
    keep = np.ones(BASE, bool)
    keep[ref["flip"]] = False
    g = G[keep].sum(0, dtype=np.float64)
    scale = np.abs(G).sum(0, dtype=np.float64)
    bad = np.flatnonzero(np.abs(g - ref["grad"]) > GRAD_TOL * scale)
    assert bad.size == 0, (bad, g[bad], ref["grad"][bad])
    assert np.array_equal(scale == 0.0, ref["grad"] == 0.0)
    # K4's raw sums, K = 0
    scene, cam = ref_scene(), vpt_torch.default_camera()
    geom = gm.make_geom_renderer(scene, cam, RW, RH, RSPP, sphere=RLIGHT,
                                 cam_grads=False, max_bounces=RMB,
                                 primal_only=True, tile_rows=RTILE,
                                 device="cpu")
    k4, tang = geom.make_raw(1)(gm.flatten_theta(gm.pack_theta(
        scene, cam, RLIGHT)), RSEED, BASE)
    assert tang.shape == ref["k4_tang"].shape == (0, BASE, 3)
    k4, k4_ref = k4.numpy(), ref["k4"]
    rel = np.abs(k4 - k4_ref) / max(1.0, float(np.abs(k4_ref).max()))
    assert np.quantile(rel, 0.99) < Q99_TOL, np.quantile(rel, 0.99)
    assert len(np.flatnonzero(rel.max(-1) > FLIP_TOL)) <= 2
