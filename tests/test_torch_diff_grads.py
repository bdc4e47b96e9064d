"""vpt_torch.kernels.diff and vpt_torch.dist on their own: no vpt kernel is
compiled here.

  - albedo and radiance gradients are exact per seed: no sampling decision
    depends on them, so central differences of the plain forward at a fixed
    seed match the plain backward (vpt's contract and cases,
    tests/test_diff_kernel.py:46-67), with both samplers;
  - the pair's forward at the scene's own values matches the forward render
    kernel's plain version within vpt's own K2-vs-K1 bound
    (tests/test_diff_kernel.py:43): the two associate a few sums
    differently;
  - the parameter packing, the autograd binding, fit_kernel on the CPU,
    project_params against vpt's, and what the pair refuses.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpt.dist.train as vpt_train

import vpt_torch
from vpt_torch.dist.train import project_params
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import wavefront as wf

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

SCENE = vpt_torch.cornell_vpt()
CAM = vpt_torch.default_camera()
W, H, SPP, MB, SEED = 16, 12, 4, 8, 3


def _packed(sampler):
    return df.pack_diff(SCENE, CAM, W, H, SPP, max_bounces=MB,
                        sampler=sampler)


@pytest.mark.parametrize("sampler", ["random", "ld"])
@pytest.mark.parametrize("leaf,index,eps", [
    ("albedo", (6, 2), 1e-3),     # blue sphere, blue channel
    ("albedo", (0, 0), 1e-3),     # left wall
    ("radiance", (9, 0), 1e-2),   # area light power
    ("radiance", (7, 0), 1.0),    # the (6000, 0, 0) point light
])
def test_albedo_radiance_grads_exact_per_seed(sampler, leaf, index, eps):
    """d mean(image) / d theta by the backward against central differences
    of the forward at the same seed: rtol 3e-2, atol 1e-7 (vpt's bounds;
    the means are summed in float64 so the differences see the f32 image,
    not the f32 sum)."""
    dp = _packed(sampler)
    params = df.pack_params(SCENE)
    seed = torch.tensor([SEED], dtype=torch.int32)
    pvec = df._flatten(params, SCENE.count)
    gbar = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix))
    g = df.unpack_params(df.diff_bwd_plain(dp, pvec, seed, gbar),
                         SCENE.count)[leaf][index]

    def loss(e):
        p = {k: v.clone() for k, v in params.items()}
        p[leaf][index] += e
        img = df.diff_fwd_plain(dp, df._flatten(p, SCENE.count), seed)
        return float(img.double().mean())

    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    assert np.isfinite(float(g)) and np.isfinite(fd)
    assert np.isclose(float(g), fd, rtol=3e-2, atol=1e-7), (float(g), fd)


@pytest.mark.parametrize("sampler", ["random", "ld"])
def test_diff_fwd_matches_render_kernel(sampler):
    dp = _packed(sampler)
    seed = torch.tensor([SEED], dtype=torch.int32)
    img = df.diff_fwd_plain(dp, df._flatten(df.pack_params(SCENE),
                                            SCENE.count), seed)
    ref = wf.render_tile_plain(dp.pk, seed)
    assert torch.isfinite(img).all()
    assert float((img - ref).abs().max()) < 1e-5 * max(1.0, float(
        ref.abs().max()))


def test_pack_flatten_unpack_round_trip():
    params = df.pack_params(SCENE)
    S = SCENE.count
    assert set(params) == {"sigma_a", "sigma_s", "albedo", "radiance"}
    assert params["albedo"].shape == (S, 3)
    assert all(v.dtype == torch.float32 for v in params.values())
    vec = df._flatten(params, S)
    assert vec.shape == (2 + 6 * S,) == (62,)
    back = df.unpack_params(vec, S)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    assert float(vec[0]) == np.float32(0.001) and float(vec[1]) == \
        np.float32(0.009)
    # _flatten is differentiable: the gradient splits back into the leaves
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    (df._flatten(leaves, S) * torch.arange(62.0)).sum().backward()
    assert torch.equal(leaves["radiance"].grad.reshape(-1),
                       torch.arange(2.0 + 3 * S, 62.0))


def test_autograd_function_runs_the_plain_pair_on_cpu():
    render = df.make_diff_renderer(SCENE, CAM, 8, 4, 2, max_bounces=4,
                                   sampler="ld", device="cpu")
    assert render.npix == 32
    params = {k: v.requires_grad_() for k, v in df.pack_params(SCENE).items()}
    before = (df.LAUNCHES_FWD, df.LAUNCHES_BWD)
    img = render(params, 5)
    (img * 2.0).sum().backward()
    assert (df.LAUNCHES_FWD, df.LAUNCHES_BWD) == before    # no kernel
    dp = render.packed
    pvec = df._flatten(df.pack_params(SCENE), SCENE.count)
    seed = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(img.detach(), df.diff_fwd_plain(dp, pvec, seed))
    g = df.diff_bwd_plain(dp, pvec, seed, torch.full((32, 3), 2.0))
    assert torch.equal(df._flatten({k: v.grad for k, v in params.items()},
                                   SCENE.count), g)


def test_fit_kernel_cpu_moves_only_what_the_filter_frees():
    pk = wf.pack_scene(SCENE, CAM, 8, 8, 16, max_bounces=6)
    target = wf.render_tile_plain(
        pk, torch.tensor([99], dtype=torch.int32)).reshape(8, 8, 3)
    wrong = dataclasses.replace(SCENE, medium=dataclasses.replace(
        SCENE.medium, sigma_s=SCENE.medium.sigma_s * 2.78))
    params, losses = vpt_torch.dist.fit_kernel(
        wrong, CAM, target, steps=2, spp=4, max_bounces=6, device="cpu",
        param_filter=lambda p, init: {**init, "sigma_s": p["sigma_s"]})
    assert len(losses) == 2 and np.isfinite(losses).all()
    start = df.pack_params(wrong)
    for k in ("sigma_a", "albedo", "radiance"):
        assert torch.equal(params[k], start[k]), k
    # Adam's first steps move sigma_s by about lr each, toward the truth
    moved = float(start["sigma_s"] - params["sigma_s"])
    assert 1e-3 < moved <= 2 * 1.5e-3 * 1.001


def test_project_params_clamps_like_vpt():
    rng = np.random.default_rng(1)
    vals = {"sigma_a": np.float32(-0.5), "sigma_s": np.float32(2e-7),
            "albedo": rng.uniform(-0.5, 1.5, (10, 3)).astype(np.float32),
            "radiance": rng.uniform(-2, 2, (10, 3)).astype(np.float32),
            "g": np.float32(0.99), "fog_k": np.float32(-1.0),
            "blobs": rng.uniform(-1, 1, (3, 5)).astype(np.float32),
            "grid": rng.uniform(-1, 1, (4, 4, 4)).astype(np.float32)}
    ours = project_params({k: torch.tensor(v) for k, v in vals.items()})
    theirs = vpt_train.project_params({k: jnp.asarray(v)
                                       for k, v in vals.items()})
    for k in vals:
        assert np.array_equal(ours[k].numpy(), np.asarray(theirs[k])), k


def _grid_scene():
    """cornell_vpt in a 2^3 voxel grid."""
    return vpt_torch.make_scene(
        list(vpt_torch.scene.scene.CORNELL_VPT_SPHERES),
        density=vpt_torch.media.density.grid(np.ones((2, 2, 2)), (0, 0, 0),
                                             (1, 1, 1)))


# vpt's reason for refusing K4's tangent planes in a voxel grid
GRID_DUAL = "the geometric DUAL planes would need dual trilinear gathers"


# the traced and baked HG g run (tests/test_torch_hg_diff.py,
# test_torch_multiview.py), and so do voxel grids with diff_grid
# (tests/test_torch_grid_diff.py); their cases check what stays refused
# with them: equi-angular, physical, material-3 shells, an HG phase in a
# grid, the dual kernel in a grid, vpt's engine backend of the grid trainer
# what stays refused: the engine (item 9), K4 with a tangent plane in a
# voxel grid (vpt's reason, GRID_DUAL: K4 takes the analytic fields in dual
# form and a grid in the primal_only mode); vpt's own refusal of the
# non-physical implicit pair names the engine too. The shard variant runs
# (tests/test_torch_dist.py); its cases check what stays refused with it:
# the non-physical implicit pair with diff_g or diff_grid, and vpt's engine
# backend of the sharded render
REFUSED = {
    "diff_g": lambda: df.make_diff_renderer(
        SCENE, CAM, 8, 4, 1, diff_g=True, distance="equiangular", nee=False,
        physical=False, device="cpu"),
    "diff_field": lambda: df.make_diff_renderer(SCENE, CAM, 8, 4, 1,
                                                diff_field=True, device="cpu"),
    "diff_blobs": lambda: df.make_diff_renderer(SCENE, CAM, 8, 4, 1,
                                                diff_blobs=True, device="cpu"),
    "diff_grid": lambda: df.make_diff_renderer(
        _grid_scene(), CAM, 8, 4, 1, diff_grid=True, distance="equiangular",
        nee=False, physical=False, device="cpu"),
    "with_grid": lambda: vpt_torch.dist.fit_grid(
        _grid_scene(), [CAM], [torch.zeros(4, 8, 3)], steps=1,
        backend="engine", device="cpu"),
    "hg_scene": lambda: df.make_diff_renderer(
        vpt_torch.make_scene(list(vpt_torch.scene.scene.CORNELL_VPT_SPHERES),
                             g=0.3), CAM, 8, 4, 1, nee=False, physical=False,
        device="cpu"),
    "make_shard": lambda: vpt_torch.dist.render_sharded(
        SCENE, CAM, vpt_torch.RenderConfig(width=8, height=4, spp=1),
        vpt_torch.dist.make_mesh(device="cpu"), backend="engine"),
    "fit_kernel_diff_g": lambda: vpt_torch.dist.fit_grid(
        _grid_scene(), [CAM], [torch.zeros(4, 8, 3)], steps=1,
        backend="engine", distance="equiangular", device="cpu"),
    # the traced field parameters need their field kind
    "diff_field_blob_scene": lambda: df.make_diff_renderer(
        vpt_torch.scene.scene.blob_cloud(), CAM, 8, 4, 1, diff_field=True,
        device="cpu"),
    "diff_blobs_fog_scene": lambda: df.make_diff_renderer(
        vpt_torch.scene.scene.foggy_cornell(), CAM, 8, 4, 1,
        diff_blobs=True, device="cpu"),
    # K4 runs every estimator, a baked g, shells and the analytic fields
    # (tests/test_torch_geom_ext.py, test_torch_geom_field.py); in a grid
    # only its primal_only mode: the light's tangents, and on foggy_cornell's
    # geometry the camera's, are refused
    "grid_field": (lambda: vpt_torch.kernels.geom.make_geom_renderer(
        _grid_scene(), CAM, 8, 4, 1, sphere=8, cam_grads=False,
        device="cpu"), GRID_DUAL),
    "geom_fog": (lambda: vpt_torch.kernels.geom.make_geom_renderer(
        dataclasses.replace(vpt_torch.scene.scene.foggy_cornell(),
                            medium=_grid_scene().medium), CAM, 8, 4, 1,
        sphere=None, cam_grads=True, device="cpu"), GRID_DUAL),
}


REFUSED_VALUES = {
    "diff_field_and_blobs": lambda: df.make_diff_renderer(
        vpt_torch.scene.scene.blob_cloud(), CAM, 8, 4, 1, diff_field=True,
        diff_blobs=True, device="cpu"),
    "more_blobs_than_the_cap": lambda: wf.pack_scene(
        vpt_torch.make_scene(
            list(vpt_torch.scene.scene.CORNELL_VPT_SPHERES),
            density=vpt_torch.media.density.blobs(
                [(0.0, 0.0, -30.0 + i, 5.0, 0.1)
                 for i in range(wf.MAX_BLOBS + 1)])), CAM, 8, 4, 1),
    "with_field_blob_scene": lambda: df.pack_params(
        vpt_torch.scene.scene.blob_cloud(), with_field=True),
    "with_blobs_fog_scene": lambda: df.pack_params(
        vpt_torch.scene.scene.foggy_cornell(), with_blobs=True),
    "diff_grid_without_grid": lambda: df.make_diff_renderer(
        SCENE, CAM, 8, 4, 1, diff_grid=True, device="cpu"),
    "with_grid_without_grid": lambda: df.pack_params(SCENE, with_grid=True),
}


@pytest.mark.parametrize("case", sorted(REFUSED_VALUES))
def test_misuse_raises_value_error(case):
    """vpt's ValueErrors: one traced field kind per scene, the scene's own
    field kind for pack_params and diff_grid, and the kernels' blob
    cap."""
    with pytest.raises(ValueError):
        REFUSED_VALUES[case]()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_raises_not_implemented(case):
    make, match = (REFUSED[case] if isinstance(REFUSED[case], tuple)
                   else (REFUSED[case], "ROADMAP Queue 1 item"))
    with pytest.raises(NotImplementedError, match=match):
        make()


def test_cuda_renderer_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "covers the kernels")
    with pytest.raises(RuntimeError, match="cuda"):
        df.make_diff_renderer(SCENE, CAM, 8, 4, 1, device="cuda")
