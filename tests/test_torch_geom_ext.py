"""vpt_torch.kernels.geom's estimators beyond free-flight NEE (the plain
version of K4's extended instantiations, csrc/geom_ext_k<K>.cu) against
vpt's geometric-gradient kernel, and port-only checks of the same paths.

vpt's make_geom_renderer runs in interpret mode in ONE subprocess
(tests/test_torch_geom.vpt_reference: XLA:CPU capped at AVX, no Eigen pool,
lowest priority), two compiles, seed 3:
  (a) "ea": a 4-sphere cut (cornell_vpt's back wall, medium_shell's
      material-3 shell, cornell_vpt's yellow area light and red point
      light) at a baked g = 0.5, distance="equiangular" with NEE, sphere =
      the area light (K = 3), "random", 16x8 at 4 spp, 6 bounces: the dual
      equi-angular trig, u_ev and 1/pSuccess, the HG phase of medium NEE
      and the HG scatter direction, a shell (a Lambertian sphere to vpt's
      K4, which has no shell cascade);
  (b) "implicit": nee=False, physical=True, free flight, the camera block
      (K = 4), "ld", 32x32 at 2 spp, 6 bounces, on an aluminium back wall,
      the floor, the blue sphere and a radius-300 lamp behind the camera,
      in a medium ten times thinner than cornell_vpt's. Without NEE a
      tangent comes only from a path that hits an emitter after a
      microfacet bounce: the Lambertian and dielectric throughput ratios do
      not depend on the geometry, and a camera ray that sees the lamp
      carries none. vpt's tile is 1024 lanes, so this frame costs its
      compile and run no more than 16x8.

Criteria (tests/test_torch_geom.py's):
  - image: quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4. A lane more
    than 1e-4 of its own scale, max(1, |ref lane|max), apart took another
    branch of a discrete event (a flip lane: an ulp of an XLA
    transcendental against torch's decides a Bernoulli, visibility or
    Fresnel choice). Measured on the CPU: (a) q99 1.5e-5, flip lanes
    FLIPS["ea"]; (b) q99 1.5e-7, flip lanes FLIPS["implicit"];
  - tangent planes: on the other lanes, quantile(|a-b|, 0.99) < 1e-4 of
    the plane's scale max|ref|, every plane nonzero on some lane. Measured:
    at most 9.7e-7 (a), 4.4e-7 (b).

Port-only (no vpt compile): the K = 0 primal bit-equal to the K = 7 primal
under each estimator; grad_render's VJP against the tangent contraction;
the draws per iteration; the GeomParams layout; the refusal that remains (a
voxel grid with a tangent plane, with vpt's reason); fixed-seed central FD
of an equi-angular light-centre tangent on the one-sphere medium scene.
"""
import dataclasses

import numpy as np
import pytest
import torch

import vpt
import vpt_torch
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import prims as tp
from vpt_torch.scene.scene import (ALUMINUM_ETA, ALUMINUM_KAPPA,
                                   CORNELL_VPT_SPHERES, SCENES)

from test_torch_geom import (FLIP_TOL, Q99_TOL, check_tangents, port_render,
                             vpt_reference)
from test_torch_geom_grads import MEDIUM_SCENE, _fd

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

Z3 = (0, 0, 0)
C = CORNELL_VPT_SPHERES
SHELL = (14.0, (0, -10.0, -10.0), (1, 1, 1), Z3, 3, Z3, Z3, 0.0)
EA_TASK = dict(name="ea", spheres=[C[2], SHELL, C[7], C[8]],
               sigma=(0.001, 0.009), g=0.5, width=16, height=8, spp=4,
               seed=3, kw=dict(sphere=2, cam_grads=False,
                               distance="equiangular", max_bounces=6,
                               sampler="random"))
MIRROR_WALL = (1e5, (0, 0, -1e5 - 81.6), Z3, Z3, 1, ALUMINUM_ETA,
               ALUMINUM_KAPPA, 0.09)
LAMP = (300.0, (0.0, 11.2, 600.0), Z3, (1, 1, 0.8), 0, Z3, Z3, 0.0)
IMPLICIT_TASK = dict(name="implicit", spheres=[MIRROR_WALL, C[3], C[6], LAMP],
                     sigma=(0.0001, 0.0009), width=32, height=32, spp=2,
                     seed=3, kw=dict(sphere=None, cam_grads=True, nee=False,
                                     physical=True, max_bounces=6,
                                     sampler="ld"))
TASKS = {"ea": EA_TASK, "implicit": IMPLICIT_TASK}
FLIPS = {"ea": [52, 56], "implicit": [662, 762]}


@pytest.fixture(scope="module")
def ref():
    port = {n: port_render(t) for n, t in TASKS.items()}
    out = vpt_reference([dict(t) for t in TASKS.values()],
                        {f"{n}.port_img": p[2] for n, p in port.items()})
    return port, out


def flip_lanes(img, ref_img):
    """Lanes more than FLIP_TOL of their own scale apart."""
    err = np.abs(img - ref_img).max(-1)
    return np.flatnonzero(err > FLIP_TOL * np.maximum(
        1.0, np.abs(ref_img).max(-1)))


@pytest.mark.parametrize("name", sorted(TASKS))
def test_image_matches_vpt(ref, name):
    port, out = ref
    img, want = port[name][2], out[f"{name}.img"]
    assert img.shape == want.shape and np.isfinite(img).all()
    rel = np.abs(img - want) / max(1.0, float(np.abs(want).max()))
    assert float(np.quantile(rel, 0.99)) < Q99_TOL
    assert flip_lanes(img, want).tolist() == FLIPS[name]


@pytest.mark.parametrize("name", sorted(TASKS))
def test_tangent_planes_match_vpt(ref, name):
    port, out = ref
    render, tang, want = port[name][0], port[name][3], out[f"{name}.tang"]
    assert render.K == {"ea": 3, "implicit": 4}[name]
    assert render.packed.ext
    for k in range(render.K):       # every plane moves somewhere
        assert np.abs(want[k]).max() > 0.0, k
    check_tangents(tang, want, np.asarray(FLIPS[name], int))


def _with_g(scene, g):
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))


# (scene, HG g, estimator): each route of the extended instantiations, and
# a shell scene under the default estimator (geom_pixel<K>); "lamp" is job
# (b)'s scene, whose lamp the implicit estimator's paths hit
EA = dict(distance="equiangular")
ESTIMATORS = {
    "ea": ("cornell_vpt", 0.0, EA),
    "implicit_physical": ("lamp", 0.0, dict(nee=False, physical=True)),
    "physical": ("cornell_vpt", 0.0, dict(physical=True)),
    "ea_implicit": ("lamp", 0.0, dict(nee=False, distance="ea")),
    "hg": ("cornell_vpt", 0.5, {}),
    "shell_ea_hg": ("medium_shell", 0.5, EA),
    "shell_default": ("medium_shell", 0.0, {}),
}


@pytest.mark.parametrize("est", sorted(ESTIMATORS))
def test_primal_does_not_depend_on_k(est):
    """A dual's primal is the same at any tangent count: the K = 0
    (primal_only) image equals the K = 7 primal plane bit for bit."""
    name, g, kw = ESTIMATORS[est]
    if name == "lamp":
        scene = vpt_torch.make_scene(IMPLICIT_TASK["spheres"],
                                     *IMPLICIT_TASK["sigma"])
        sphere = 3
    else:
        scene, sphere = _with_g(SCENES[name](), g), 8
    cam = vpt_torch.default_camera()
    theta = gm.pack_theta(scene, cam, sphere)
    imgs = []
    for blocks in (dict(primal_only=True), dict(cam_grads=True)):
        render = gm.make_geom_renderer(scene, cam, 8, 6, 2, sphere=sphere,
                                       max_bounces=5, device="cpu",
                                       **blocks, **kw)
        img, tang = render(theta, 5)
        assert torch.isfinite(img).all() and torch.isfinite(tang).all()
        assert render.packed.ext == (est != "shell_default")
        imgs.append(img)
    assert float(imgs[0].abs().max()) > 0.0
    assert torch.equal(imgs[0], imgs[1])


def test_grad_render_vjp_is_the_tangent_contraction(ref):
    """grad_render under autograd (job a's renderer): the contraction of
    its tangent planes with the cotangent."""
    render, theta = ref[0]["ea"][:2]
    theta = {k: v.clone().requires_grad_() for k, v in theta.items()}
    img = render.grad_render(theta, EA_TASK["seed"])
    gbar = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(img.shape)).astype(np.float32))
    (img * gbar).sum().backward()
    _, tang = render(theta, EA_TASK["seed"])
    want = torch.einsum("kpc,pc->k", tang, gbar)
    got = gm.flatten_theta({k: v.grad for k, v in theta.items()})
    assert torch.allclose(got[:3], want, rtol=1e-6, atol=0.0)
    assert torch.all(got[3:] == 0.0) and float(want.abs().max()) > 0.0


# draws per iteration on cornell_vpt (2 MIS lights): camera 2 ("random"),
# u_rr, u_pick, u_dist, u_ev (equi-angular), MISv2 3 per MIS light + 3 (with
# NEE), BSDF 3, phase 2, medium NEE 2 (with NEE)
@pytest.mark.parametrize("sampler,distance,nee,draws", [
    ("ld", "equiangular", True, 20), ("random", "equiangular", True, 22),
    ("ld", "free", False, 8), ("random", "free", False, 10),
    ("ld", "equiangular", False, 9), ("random", "equiangular", False, 11)])
def test_draw_count(monkeypatch, sampler, distance, nee, draws):
    calls = []
    real = tp.Pcg.__call__

    def counted(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(tp.Pcg, "__call__", counted)
    scene = vpt_torch.cornell_vpt()
    gp = gm.pack_geom(scene, vpt_torch.default_camera(), 1, 1, 2, sphere=8,
                      max_bounces=2, sampler=sampler, nee=nee,
                      distance=distance, physical=not nee)
    stats = {}
    gm.geom_fwd_plain(gp, gm.flatten_theta(gm.pack_theta(
        scene, vpt_torch.default_camera(), 8)),
        torch.tensor([3], dtype=torch.int32), stats)
    # "ld" also draws its 5 Cranley-Patterson offsets once per lane, from
    # another stream
    offsets = 5 if sampler == "ld" else 0
    assert len(calls) == offsets + draws * stats["thread_iters"]
    assert len(scene.mis_light_idx) == 2


def test_geom_params_layout():
    """GeomParams (csrc/geom_path.cuh): VptParams' 616 words, the 7 basis
    ints, aspect and cp, then the estimator's ea, nee, physical and hg:
    629 words. Any distance other than "free" packs vpt's equi-angular
    branch; a |g| at or below 1e-3 is isotropic (vpt's _baked_g)."""
    scene = vpt_torch.cornell_vpt()
    cam = vpt_torch.default_camera()
    for g, kw, tail in ((0.0, {}, [0, 1, 0, 0]),
                        (0.0, dict(distance="ea_clamped"), [1, 1, 0, 0]),
                        (0.5, dict(nee=False, physical=True), [0, 0, 1, 1]),
                        (5e-4, {}, [0, 1, 0, 0])):
        gp = gm.pack_geom(_with_g(scene, g), cam, 8, 4, 1, sphere=8, **kw)
        words = gp.words()
        assert words.dtype == np.int32 and words.size == 616 + 7 + 2 + 4
        assert list(words[-4:]) == tail
        assert gp.ext == any(tail[i] != v for i, v in enumerate([0, 1, 0, 0]))


@pytest.mark.parametrize("blocks", [dict(sphere=2, cam_grads=False),
                                    dict(sphere=None, cam_grads=True)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_grid_with_tangents_is_refused(blocks, device):
    """What stays refused: a voxel grid with a tangent plane (the light's
    centre, or the camera), before any device check, with vpt's reason
    (vpt/kernels/geom.py:141-149: vpt raises it the same way); the
    primal_only renderer of the same scene is built."""
    from vpt.kernels.geom import make_geom_renderer as vpt_make
    from vpt.media.density import grid as vpt_grid
    from test_torch_geom import make
    from test_torch_geom_field import BLOB_SPHERES, grid_spec
    spec = grid_spec(4)
    scene = make(BLOB_SPHERES, (0.004, 0.04), 0.0, spec)
    cam = vpt_torch.default_camera()
    with pytest.raises(NotImplementedError) as port:
        gm.make_geom_renderer(scene, cam, 8, 4, 1, device=device, **blocks)
    vscene = vpt.make_scene(BLOB_SPHERES, 0.004, 0.04,
                            density=vpt_grid(
                                np.asarray(spec["values"], np.float32),
                                **spec["kw"]))
    with pytest.raises(NotImplementedError) as ref:
        vpt_make(vscene, vpt.default_camera(), 8, 4, 1, interpret=True,
                 **blocks)
    # vpt's reason, word for word up to its list of where grids run
    head = str(ref.value).split(";")[0]
    assert str(port.value).startswith(head + ";") and "DUAL planes" in head
    r = gm.make_geom_renderer(scene, cam, 8, 4, 1, primal_only=True,
                              device="cpu", **blocks)
    assert r.K == 0 and r.packed.entry == "geom_field_k0"


def test_equiangular_light_tangent_matches_fixed_seed_fd():
    """The light centre's y tangent under equi-angular sampling (the sample
    point moves with the light) against fixed-seed central FD of the image
    mean (tests/test_torch_geom_grads.py's criterion, rtol 8e-2; h = 3e-2:
    at 1e-2 the f32 secant's cancellation is larger than the gap).
    Measured: 3.9e-3 relative (x and z: 8.6e-3, 2.6e-2)."""
    index = 1
    render = gm.make_geom_renderer(MEDIUM_SCENE, vpt_torch.default_camera(),
                                   12, 8, 2, sphere=0, cam_grads=False,
                                   distance="equiangular", max_bounces=5,
                                   device="cpu")
    theta = gm.pack_theta(MEDIUM_SCENE, vpt_torch.default_camera(), 0)
    g, fd = _fd(render, theta, "center", index, 3e-2, index)
    assert np.isfinite(g) and np.isfinite(fd) and g != 0.0
    assert np.isclose(g, fd, rtol=8e-2, atol=1e-6), (g, fd)
