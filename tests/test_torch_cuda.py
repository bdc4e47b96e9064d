"""The CUDA kernels on the card (marked `cuda`; skipped without one): the
render kernel K1 (every instantiation and its raw and scatter modes, with
the adaptive and noise-target entry points), the differentiable pair K2/K3
and the dual kernel K4; K1's and the pair's field instantiations on
foggy_cornell and blob_cloud; the pair's HG instantiations (a baked g and
the traced diff_g) and fit_multiview; K1's and the pair's grid
instantiations (diff_grid's voxel gradient included) and fit_grid; the
pair's extended instantiations (equi-angular, the implicit and physical
estimators, shells, HG in a grid) and fit_grid under equi-angular.

Run on a machine with an NVIDIA GPU (--noconftest: tests/conftest.py
imports jax, which the port's machines need not have):
    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Whether there is a card is decided inside the tests, never at import.
"""
import pytest
import torch

import numpy as np

import vpt_torch
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _glass_cornell():
    """cornell_vpt with its blue sphere made dielectric (no built-in scene
    has one)."""
    d = scene_to_dict(vpt_torch.cornell_vpt())
    d["spheres"][6]["material"] = 2
    return scene_from_dict(d)[0]


@pytest.mark.parametrize("scene,sampler", [
    ("cornell_vpt", "random"), ("cornell_vpt", "ld"),
    ("one_primitive_infinite", "random"), ("cornell_glass", "ld")])
def test_kernel_matches_plain_on_card(cuda, scene, sampler):
    """The kernel against its plain version on the same device and seed:
    99th percentile of |a-b| / max(1, |ref|max) below 1e-4 (the card's
    transcendentals may differ from torch's by an ulp)."""
    sc = _glass_cornell() if scene == "cornell_glass" else \
        vpt_torch.SCENES[scene]()
    pk = wf.pack_scene(sc, vpt_torch.default_camera(),
                       64, 32, 8, max_bounces=8, sampler=sampler)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    before = wf.LAUNCHES
    k = wf.render_tile(pk, seed)
    assert wf.LAUNCHES == before + 1
    p = wf.render_tile_plain(pk, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    rel = (k - p).abs() / max(1.0, float(p.abs().max()))
    assert float(torch.quantile(rel.flatten().double(), 0.99)) < 1e-4


def test_render_on_card_goes_through_the_kernel(cuda):
    cfg = vpt_torch.RenderConfig(width=48, height=32, spp=4, max_bounces=6,
                                 sampler="ld")
    before = wf.LAUNCHES
    img = vpt_torch.render(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                           cfg, device="cuda")
    torch.cuda.synchronize()
    assert wf.LAUNCHES == before + 1
    assert img.shape == (32, 48, 3) and img.device.type == "cuda"
    assert torch.isfinite(img).all() and (img >= 0).all()


# every instantiation of K1 and its launch-parameter modes: (integrator,
# scene, g)
VARIANTS = [("implicit_free", "cornell_vpt", 0.0),
            ("explicit_equiangular", "cornell_vpt", 0.0),
            ("implicit_equiangular", "cornell_vpt", 0.0),
            ("explicit_free_physical", "medium_shell", 0.0),
            ("implicit_free_physical", "cornell_vpt", 0.0),
            ("explicit_equiangular", "cornell_vpt", 0.5),
            ("implicit_free", "cornell_vpt", -0.3)]


def _scene_g(name, g):
    sc = vpt_torch.SCENES[name]()
    if g == 0.0:
        return sc
    import dataclasses
    return dataclasses.replace(sc, medium=dataclasses.replace(
        sc.medium, g=torch.tensor(g)))


@pytest.mark.parametrize("sampler", ["random", "ld"])
@pytest.mark.parametrize("integrator,scene,g", VARIANTS,
                         ids=[f"{v[0]}-{v[1]}-g{v[2]}" for v in VARIANTS])
def test_kernel_variant_bit_equal_to_plain_on_card(cuda, integrator, scene, g,
                                                   sampler):
    """Each instantiation (and the physical, HG and shell modes) against
    its plain version on the card: bit for bit (nvcc --fmad=false; the
    same device math as torch's CUDA ops)."""
    nee, dist, phys = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(_scene_g(scene, g), vpt_torch.default_camera(),
                       64, 32, 8, max_bounces=8, sampler=sampler, nee=nee,
                       distance=dist, physical=phys)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    before = wf.LAUNCHES
    k = wf.render_tile(pk, seed)
    assert wf.LAUNCHES == before + 1
    p = wf.render_tile_plain(pk, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert torch.equal(k, p)


def test_scatter_kernel_bit_equal_on_card(cuda):
    """The raw modes: contiguous tiles, scatter in forward and reversed
    order, and the plain scatter, bit for bit."""
    pk = wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                       128, 64, 4, max_bounces=6, distance="equiangular")
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    n, lanes = pk.num_tiles, wf.LANES_PER_TILE
    bases = torch.arange(n, dtype=torch.int32, device=cuda) * lanes
    full = wf.render_raw(pk, seed)
    scat = wf.render_raw(pk, seed, bases)
    rev = wf.render_raw(pk, seed, bases.flip(0).contiguous())
    plain = wf.render_raw_plain(pk, seed, bases)
    torch.cuda.synchronize()
    assert torch.equal(full, scat) and torch.equal(scat, plain)
    assert torch.equal(full, rev.reshape(n, lanes, 3).flip(0).reshape(-1, 3))


def test_adaptive_and_noise_go_through_the_kernel(cuda):
    cam = vpt_torch.default_camera()
    cfg = vpt_torch.RenderConfig(width=128, height=64, spp=4, max_bounces=6)
    before = wf.LAUNCHES
    img = vpt_torch.render_adaptive(vpt_torch.cornell_vpt(), cam, cfg,
                                    boost=2.0, frac=0.5, device="cuda")
    torch.cuda.synchronize()
    assert wf.LAUNCHES == before + 3
    assert img.shape == (64, 128, 3) and torch.isfinite(img).all()
    ref = vpt_torch.render_adaptive(vpt_torch.cornell_vpt(), cam, cfg,
                                    boost=2.0, frac=0.5, device="cpu")
    assert _q99(img.cpu(), ref) < 1e-4
    before = wf.LAUNCHES
    cfg = vpt_torch.RenderConfig(width=32, height=16, spp=8, max_bounces=6)
    img, spp, _ = vpt_torch.render_to_noise(
        vpt_torch.cornell_vpt(), cam, cfg, target_rel_se=1e-9, max_spp=32,
        device="cuda")
    assert spp == 32 and wf.LAUNCHES == before + 4
    assert torch.isfinite(img).all() and img.shape == (16, 32, 3)


def _q99(a, ref):
    rel = (a - ref).abs() / max(1.0, float(ref.abs().max()))
    return float(torch.quantile(rel.flatten().double(), 0.99))


@pytest.mark.parametrize("scene,sampler", [
    ("cornell_vpt", "random"), ("cornell_vpt", "ld"), ("cornell_glass", "ld")])
def test_diff_pair_matches_plain_on_card(cuda, scene, sampler):
    """K2's image by the q99 criterion; K3's per-pixel gradient vectors
    (the kernel's per_lane output) per entry column by the same criterion,
    and its block-summed P-vector within 1e-5 of sum_lanes |G_lane, k| (the
    same f32 values summed in another order)."""
    sc = _glass_cornell() if scene == "cornell_glass" else \
        vpt_torch.SCENES[scene]()
    dp = df.pack_diff(sc, vpt_torch.default_camera(), 64, 32, 8,
                      max_bounces=8, sampler=sampler)
    pvec = df._flatten(df.pack_params(sc), sc.count).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    gen = np.random.default_rng(0)
    gbar = torch.from_numpy(gen.standard_normal((dp.npix, 3)).astype(
        np.float32)).to(cuda)
    before = (df.LAUNCHES_FWD, df.LAUNCHES_BWD)
    k = df.diff_fwd(dp, pvec, seed)
    g = df.diff_bwd(dp, pvec, seed, gbar)
    G = df.diff_bwd(dp, pvec, seed, gbar, per_lane=True)
    assert (df.LAUNCHES_FWD, df.LAUNCHES_BWD) == (before[0] + 1,
                                                  before[1] + 2)
    p = df.diff_fwd_plain(dp, pvec, seed)
    Gp = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all() and torch.isfinite(G).all()
    assert _q99(k, p) < 1e-4
    rel = ((G - Gp).abs() / Gp.abs().amax(0).clamp_min(1.0)).amax(1)
    assert float(torch.quantile(rel.double(), 0.99)) < 1e-4
    scale = Gp.abs().sum(0)
    assert bool(((g - Gp.sum(0)).abs() <= 1e-5 * scale).all())


def test_diff_renderer_backward_goes_through_the_kernels(cuda):
    render = df.make_diff_renderer(vpt_torch.cornell_vpt(),
                                   vpt_torch.default_camera(), 48, 32, 4,
                                   max_bounces=6, sampler="ld", device="cuda")
    params = {k: v.to(cuda).requires_grad_()
              for k, v in df.pack_params(vpt_torch.cornell_vpt()).items()}
    before = (df.LAUNCHES_FWD, df.LAUNCHES_BWD)
    loss = render(params, 7).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert (df.LAUNCHES_FWD, df.LAUNCHES_BWD) == (before[0] + 1,
                                                  before[1] + 1)
    for k, v in params.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
    # the same gradient from the plain pair on the card
    dp = render.packed
    pvec = df._flatten({k: v.detach() for k, v in params.items()}, 10)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    gp = df.diff_bwd_plain(dp, pvec, seed, torch.full(
        (dp.npix, 3), 1.0 / (3 * dp.npix), device=cuda), per_lane=True)
    got = df._flatten({k: v.grad for k, v in params.items()}, 10)
    assert bool(((got - gp.sum(0)).abs() <= 1e-5 * gp.abs().sum(0)).all())


@pytest.mark.parametrize("kw,sampler", [
    (dict(sphere=8, primal_only=True), "random"), (dict(sphere=8), "random"),
    (dict(sphere=8), "ld")], ids=["K0-random", "K7-random", "K7-ld"])
def test_geom_kernel_matches_plain_on_card(cuda, kw, sampler):
    """K4's planes against its plain version: the image planes by the q99
    criterion, each tangent plane by q99 of |a-b| below 1e-4 of its scale
    (zero planes exactly zero)."""
    sc, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    gp = gm.pack_geom(sc, cam, 64, 32, 8, max_bounces=8, sampler=sampler,
                      **kw)
    theta = gm.flatten_theta(gm.pack_theta(sc, cam, 8)).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    before = gm.LAUNCHES
    k = gm.geom_fwd(gp, theta, seed)
    assert gm.LAUNCHES == before + 1
    p = gm.geom_fwd_plain(gp, theta, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    for j in range(gp.planes):
        if j % (1 + gp.K) == 0:
            assert _q99(k[j], p[j]) < 1e-4, j
        else:
            scale = float(p[j].abs().max())
            if scale == 0.0:
                assert bool((k[j] == 0.0).all()), j
                continue
            q = torch.quantile((k[j] - p[j]).abs().double(), 0.99)
            assert float(q) < 1e-4 * scale, j


def test_geom_renderer_goes_through_the_kernel(cuda):
    sc, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    render = gm.make_geom_renderer(sc, cam, 48, 32, 4, sphere=8,
                                   max_bounces=6, device="cuda")
    theta = {k: v.to(cuda).requires_grad_()
             for k, v in gm.pack_theta(sc, cam, 8).items()}
    before = gm.LAUNCHES
    img, tang = render(theta, 7)
    render.grad_render(theta, 7).mean().backward()
    torch.cuda.synchronize()
    assert gm.LAUNCHES == before + 2
    assert img.shape == (48 * 32, 3) and tang.shape == (7, 48 * 32, 3)
    assert torch.isfinite(img).all() and torch.isfinite(tang).all()
    got = gm.flatten_theta({k: v.grad for k, v in theta.items()})
    want = tang.sum((1, 2)) / (3 * 48 * 32)
    assert torch.allclose(got[:7], want, rtol=1e-5, atol=1e-9)


FIELD_K1 = [(name, integrator) for name in ("foggy_cornell", "blob_cloud")
            for integrator in ("explicit_free", "implicit_free",
                               "explicit_equiangular", "implicit_equiangular")]


@pytest.mark.parametrize("name,integrator", FIELD_K1)
def test_field_kernel_bit_equal_to_plain_on_card(cuda, name, integrator):
    """K1's field instantiations (csrc/wavefront_field*.cu) launch for a
    scene with a density field and equal the plain version bit for bit."""
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(vpt_torch.SCENES[name](), vpt_torch.default_camera(),
                       64, 32, 8, max_bounces=8, sampler="ld", nee=nee,
                       distance=distance, physical=physical)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    wf.LAUNCHES_BY.clear()
    k = wf.render_tile(pk, seed)
    assert wf.LAUNCHES_BY == {wf.FIELD_ENTRIES[(nee, distance)]: 1}
    p = wf.render_tile_plain(pk, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all() and torch.equal(k, p)


@pytest.mark.parametrize("name,traced", [
    ("foggy_cornell", None), ("foggy_cornell", "diff_field"),
    ("blob_cloud", "diff_blobs")])
def test_field_pair_matches_plain_on_card(cuda, name, traced):
    """K2/K3's field instantiations (csrc/diff_field_*.cu): the image bit
    for bit, K3's per-pixel vectors row for row, the block-summed vector
    within 1e-5 of sum_lanes |G_lane, k|, the field slots included."""
    sc = vpt_torch.SCENES[name]()
    kw = {traced: True} if traced else {}
    dp = df.pack_diff(sc, vpt_torch.default_camera(), 64, 32, 8,
                      max_bounces=8, sampler="random", **kw)
    pvec = df._flatten(df.pack_params(
        sc, with_field=traced == "diff_field",
        with_blobs=traced == "diff_blobs"), sc.count).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    gbar = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (dp.npix, 3)).astype(np.float32)).to(cuda)
    df.LAUNCHES_BY.clear()
    k = df.diff_fwd(dp, pvec, seed)
    g = df.diff_bwd(dp, pvec, seed, gbar)
    G = df.diff_bwd(dp, pvec, seed, gbar, per_lane=True)
    assert df.LAUNCHES_BY == {"vpt_diff_fwd_field": 1,
                              "vpt_diff_bwd_field": 2}
    p = df.diff_fwd_plain(dp, pvec, seed)
    Gp = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True)
    torch.cuda.synchronize()
    assert torch.isfinite(G).all() and torch.equal(k, p)
    assert torch.equal(G, Gp)
    assert bool(((g - Gp.sum(0)).abs() <= 1e-5 * Gp.abs().sum(0)).all())


HG_PAIRS = [("cornell_vpt", 0.5, "ld", {}),
            ("cornell_vpt", 0.5, "random", {"diff_g": True}),
            ("foggy_cornell", 0.5, "random",
             {"diff_g": True, "diff_field": True}),
            ("blob_cloud", -0.3, "random", {"diff_g": True,
                                            "diff_blobs": True})]


@pytest.mark.parametrize("name,g,sampler,kw", HG_PAIRS, ids=[
    f"{c[0]}-{'-'.join(c[3]) or 'baked'}" for c in HG_PAIRS])
def test_hg_pair_bit_equal_to_plain_on_card(cuda, name, g, sampler, kw):
    """K2/K3's HG instantiations (csrc/diff_hg.cu, diff_field_hg_*.cu):
    the image bit for bit, K3's per-pixel vectors row for row (the g slot
    included), the block-summed vector within 1e-5 of sum_lanes |G_lane,
    k|."""
    import dataclasses

    sc = vpt_torch.SCENES[name]()
    sc = dataclasses.replace(sc, medium=dataclasses.replace(
        sc.medium, g=torch.tensor(g)))
    dp = df.pack_diff(sc, vpt_torch.default_camera(), 64, 32, 8,
                      max_bounces=8, sampler=sampler, **kw)
    pvec = df._flatten(df.pack_params(
        sc, with_g=kw.get("diff_g", False),
        with_field=kw.get("diff_field", False),
        with_blobs=kw.get("diff_blobs", False)), sc.count).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    gbar = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (dp.npix, 3)).astype(np.float32)).to(cuda)
    df.LAUNCHES_BY.clear()
    k = df.diff_fwd(dp, pvec, seed)
    g_ = df.diff_bwd(dp, pvec, seed, gbar)
    G = df.diff_bwd(dp, pvec, seed, gbar, per_lane=True)
    fwd, bwd = dp.entries
    assert fwd.endswith("_hg") and df.LAUNCHES_BY == {fwd: 1, bwd: 2}
    p = df.diff_fwd_plain(dp, pvec, seed)
    Gp = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True)
    torch.cuda.synchronize()
    assert torch.isfinite(G).all() and torch.equal(k, p)
    assert torch.equal(G, Gp)
    assert bool(((g_ - Gp.sum(0)).abs() <= 1e-5 * Gp.abs().sum(0)).all())


def test_fit_multiview_goes_through_the_hg_kernels(cuda):
    """Two views of the fog at g = 0.5 with diff_g + diff_field: each step
    launches K2 and K3 twice per view, and the medium moves."""
    import dataclasses

    from vpt_torch.scene.camera import look_at

    fog = vpt_torch.SCENES["foggy_cornell"]()
    fog = dataclasses.replace(fog, medium=dataclasses.replace(
        fog.medium, g=torch.tensor(0.5)))
    cams = [vpt_torch.default_camera(),
            look_at((35.0, 30.0, 180.0), (0.0, -10.0, 0.0))]
    cfg = vpt_torch.RenderConfig(width=32, height=24, spp=16, max_bounces=8,
                                 sampler="ld")
    targets = [vpt_torch.render(fog, c, cfg, device="cuda") for c in cams]
    df.LAUNCHES_BY.clear()
    params, losses = vpt_torch.dist.fit_multiview(
        fog, cams, targets, steps=3, spp=8, learning_rate=2.5e-3,
        max_bounces=8, sampler="ld", diff_g=True, diff_field=True,
        device="cuda")
    assert df.LAUNCHES_BY == {"vpt_diff_fwd_field_hg": 12,
                              "vpt_diff_bwd_field_hg": 12}
    assert np.isfinite(losses).all()
    assert all(torch.isfinite(v).all() for v in params.values())


def _grid_cloud(interp):
    """blob_cloud rasterized onto an 8^3 grid, n_march 8 (vpt's grid_cloud,
    tests/test_diff_kernel.py), through the port alone."""
    import dataclasses

    from vpt_torch.media import density as dfn
    from vpt_torch.scene.scene import Medium
    base = vpt_torch.SCENES["blob_cloud"]()
    xs, zs = np.linspace(-40, 40, 8), np.linspace(130, 220, 8)
    pts = torch.from_numpy(np.stack(np.meshgrid(xs, xs, zs, indexing="ij"),
                                    -1))
    fld = dataclasses.replace(base.medium.density, params=(
        base.medium.density.params.to(torch.float64)))
    sx, sz = 80 / 7, 90 / 7
    f = dataclasses.replace(dfn.grid(
        dfn.density(fld, pts).numpy(),
        origin=(-40 - sx / 2, -40 - sx / 2, 130 - sz / 2),
        spacing=(sx, sx, sz), transport_interp=interp), n_march=8)
    return dataclasses.replace(base, medium=Medium(
        base.medium.sigma_a, base.medium.sigma_s, 0.0, f))


@pytest.mark.parametrize("interp", ["tri", "nearest"])
@pytest.mark.parametrize("integrator", ["explicit_free", "implicit_free",
                                        "explicit_equiangular",
                                        "implicit_equiangular"])
def test_grid_kernel_bit_equal_to_plain_on_card(cuda, integrator, interp):
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(_grid_cloud(interp), vpt_torch.default_camera(),
                       64, 32, 8, max_bounces=8, sampler="ld", nee=nee,
                       distance=distance, physical=physical)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    wf.LAUNCHES_BY.clear()
    k = wf.render_tile(pk, seed)
    assert wf.LAUNCHES_BY == {wf.GRID_ENTRIES[(nee, distance)]: 1}
    assert torch.equal(k, wf.render_tile_plain(pk, seed))


@pytest.mark.parametrize("interp,diff_grid", [("tri", True),
                                              ("nearest", True),
                                              ("tri", False)])
def test_grid_pair_matches_plain_on_card(cuda, interp, diff_grid):
    """K2 and K3's per-pixel rows bit for bit; the voxel gradient (atomic
    adds in another order, subnormal sums flushed to zero) per voxel within
    1e-5 of its terms' absolute sum."""
    sc = _grid_cloud(interp)
    dp = df.pack_diff(sc, vpt_torch.default_camera(), 64, 32, 8,
                      max_bounces=8, sampler="random", diff_grid=diff_grid)
    params = df.pack_params(sc, with_grid=diff_grid)
    pvec = df._flatten(params, sc.count).to(cuda)
    tab = (vpt_torch.kernels.prims.grid_table(params["grid"].to(cuda))
           if diff_grid else None)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    gbar = torch.randn(dp.npix, 3, generator=torch.Generator().manual_seed(0)
                       ).to(cuda)
    assert torch.equal(df.diff_fwd(dp, pvec, seed, tab),
                       df.diff_fwd_plain(dp, pvec, seed, tab=tab))
    got = df.diff_bwd(dp, pvec, seed, gbar, per_lane=True, tab=tab)
    want = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True, tab=tab,
                             voxel_abs=True)
    if not diff_grid:
        assert torch.equal(got, want)
        return
    assert torch.equal(got[0], want[0])
    tiny = torch.finfo(torch.float32).tiny
    assert ((got[1] - want[1]).abs() <= 1e-5 * want[2] + tiny).all()
    assert want[1].abs().max() > 0


def test_fit_grid_goes_through_the_grid_kernels(cuda):
    sc = _grid_cloud("tri")
    cam = vpt_torch.default_camera()
    targets = [torch.rand(24, 32, 3, device=cuda) for _ in range(2)]
    df.LAUNCHES_BY.clear()
    values, losses = vpt_torch.dist.fit_grid(
        sc, [cam, cam], targets, steps=2, spp=2, reg_l1=2e-3, reg_tv=1e-3,
        device="cuda")
    assert df.LAUNCHES_BY == {"vpt_diff_fwd_grid": 8,
                              "vpt_diff_bwd_grid": 8}
    assert np.isfinite(losses).all() and values.is_cuda
    assert values.min() >= 0.0


# the pair's extended instantiations (csrc/diff_ext_*.cu,
# diff_field_ext_*.cu, diff_grid_ext_*.cu): (scene, g, traced, estimator,
# sampler)
EXT_PAIRS = [
    ("cornell_vpt", 0.0, {}, dict(distance="equiangular"), "ld"),
    ("cornell_vpt", 0.5, {"diff_g": True},
     dict(distance="equiangular", nee=False, physical=True), "random"),
    ("cornell_vpt", 0.0, {}, dict(physical=True), "ld"),
    ("medium_shell", 0.0, {}, {}, "random"),
    ("foggy_cornell", 0.5, {"diff_g": True, "diff_field": True},
     dict(distance="equiangular", physical=True), "random"),
    ("blob_cloud", 0.0, {"diff_blobs": True},
     dict(nee=False, physical=True), "ld"),
    ("grid", 0.5, {"diff_grid": True}, dict(distance="equiangular"), "ld"),
    ("grid_nearest", 0.0, {"diff_grid": True},
     dict(distance="equiangular", nee=False, physical=True), "random"),
    ("grid", -0.3, {"diff_grid": True}, {}, "random"),
    ("grid", 0.0, {}, dict(distance="equiangular"), "ld")]


@pytest.mark.parametrize("name,g,kw,est,sampler", EXT_PAIRS, ids=[
    f"{c[0]}-g{c[1]}-{'-'.join(c[2]) or 'baked'}-"
    f"{'-'.join(f'{k}={v}' for k, v in c[3].items()) or 'free'}-{c[4]}"
    for c in EXT_PAIRS])
def test_ext_pair_matches_plain_on_card(cuda, name, g, kw, est, sampler):
    """The extended K2/K3: the image bit for bit, K3's per-pixel rows row
    for row, the block-summed vector within 1e-5 of sum_lanes |G_lane, k|,
    the voxel gradient per voxel within 1e-5 of its terms' absolute sum;
    launched under the "_ext" entries."""
    import dataclasses

    if name.startswith("grid"):
        sc = _grid_cloud("nearest" if name == "grid_nearest" else "tri")
    else:
        sc = vpt_torch.SCENES[name]()
    sc = dataclasses.replace(sc, medium=dataclasses.replace(
        sc.medium, g=torch.tensor(g)))
    dp = df.pack_diff(sc, vpt_torch.default_camera(), 64, 32, 8,
                      max_bounces=8, sampler=sampler, **kw, **est)
    params = df.pack_params(sc, with_g=kw.get("diff_g", False),
                            with_field=kw.get("diff_field", False),
                            with_blobs=kw.get("diff_blobs", False),
                            with_grid=kw.get("diff_grid", False))
    pvec = df._flatten(params, sc.count).to(cuda)
    tab = (vpt_torch.kernels.prims.grid_table(params["grid"].to(cuda))
           if "grid" in params else None)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    gbar = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (dp.npix, 3)).astype(np.float32)).to(cuda)
    df.LAUNCHES_BY.clear()
    k = df.diff_fwd(dp, pvec, seed, tab)
    got = df.diff_bwd(dp, pvec, seed, gbar, tab=tab)
    lanes = df.diff_bwd(dp, pvec, seed, gbar, per_lane=True, tab=tab)
    fwd, bwd = dp.entries
    assert fwd.endswith("_ext") and df.LAUNCHES_BY == {fwd: 1, bwd: 2}
    p = df.diff_fwd_plain(dp, pvec, seed, tab=tab)
    want = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True, tab=tab,
                             voxel_abs=True)
    torch.cuda.synchronize()
    G, Gp = (lanes[0], want[0]) if dp.diff_grid else (lanes, want)
    g_ = got[0] if dp.diff_grid else got
    assert torch.isfinite(G).all() and torch.equal(k, p)
    assert torch.equal(G, Gp)
    assert bool(((g_ - Gp.sum(0)).abs() <= 1e-5 * Gp.abs().sum(0)).all())
    if dp.diff_grid:
        tiny = torch.finfo(torch.float32).tiny
        for gg in (lanes[1], got[1]):
            assert ((gg - want[1]).abs() <= 1e-5 * want[2] + tiny).all()


def test_ea_fit_grid_goes_through_the_ext_kernels(cuda):
    sc = _grid_cloud("nearest")
    cam = vpt_torch.default_camera()
    targets = [torch.rand(24, 32, 3, device=cuda) for _ in range(2)]
    df.LAUNCHES_BY.clear()
    values, losses = vpt_torch.dist.fit_grid(
        sc, [cam, cam], targets, steps=2, spp=2, reg_l1=2e-3,
        distance="equiangular", device="cuda")
    assert df.LAUNCHES_BY == {"vpt_diff_fwd_grid_ext": 8,
                              "vpt_diff_bwd_grid_ext": 8}
    assert np.isfinite(losses).all() and values.min() >= 0.0
