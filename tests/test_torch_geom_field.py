"""vpt_torch.kernels.geom in a density field (the plain version of K4's
field instantiations, csrc/geom_field_k<K>.cu) against vpt's
geometric-gradient kernel, and port-only checks of the same paths.

vpt's make_geom_renderer runs in interpret mode in ONE subprocess
(tests/test_torch_geom.vpt_reference: XLA:CPU capped at AVX, no Eigen pool,
normal priority), four compiles, seed 3, 16x8 at 4 spp, 6 bounces:
  (a) "fog": foggy_cornell's exp_height fog (k 0.06, y0 -40.8, majorant
      1.01; sigma 0.004 / 0.036) on a 3-sphere cut of it (the floor, the
      yellow area light, the red point light: a vpt compile's cost grows
      with the spheres), free flight with NEE, sphere = the area light (K = 3),
      "random": the dual closed-form inversion and its escape, the dual
      optical depths of pLight, MISv2 and medium NEE;
  (b) "fog_ea": the same cut at a baked g = 0.5, equi-angular NEE, the
      camera block (K = 4), "ld": Bernoulli(Tr), T with |tau| behind the
      origin, sigma_s(xt), the HG phase in a field;
  (c) "blobs": blob_cloud, free flight with NEE, sphere = its light (K =
      3), "random": delta tracking's 2 max_null draws on the primal lanes,
      the erf-pair optical depths in dual form;
  (d) "grid": blob_cloud's spheres in GRID, an 8^3 xy-nearest voxel grid of
      its blobs (n_march 8), primal_only (K = 0), free flight, "random"; and
      one step of vpt's own make_fd_geom_train_step on it (its jitted step
      through __wrapped__, make_geom_renderer memoized in the subprocess:
      no further compile) over the light's centre and sigma.

Criteria (tests/test_torch_geom.py's): the image at q99 < 1e-4 of
max(1, |ref|max); each tangent plane at q99 < 1e-4 of its scale on the
lanes that do not flip (a flip lane: more than 1e-4 of its own scale,
max(1, |ref lane|max), apart: an ulp of an XLA transcendental against
torch's decides a discrete event). Measured on the CPU: image q99 fog
3.0e-8, fog_ea 1.8e-7, blobs 1.2e-6, grid 1.4e-5 (the grid's marches: XLA
folds their constant products, ROADMAP Queue 3); flip lanes FLIPS (grid:
lane 113, which the port's K1 and vpt's K1 part on too); tangent planes at
most 9.1e-7 of their scale.

The dual field forms (erf_poly, log1p, field_density, field_tau,
field_sample_free) run beside vpt's kernels/dual.py ones, eagerly
in-process, on the rays of tests/test_torch_hetero.py (some far below the
fog plane, some near-horizontal), with random tangents: values and tangents
at rtol 1e-5, atol 1e-6 of each output's scale where vpt's are finite, and
non-finite exactly where vpt's are.

Port-only (no vpt compile): the K4 field primal against the port's plain K1
field image (vpt's own contract, tests/test_geom_kernel.py:434-456); the
K = 0 primal bit-equal to the K = 7 one under each estimator; the exp_height
light-y tangent against fixed-seed FD of the port's primal
(tests/test_geom_kernel.py:459-470); the blobs' draw count; the trainers on
field scenes on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vpt.kernels import dual as jd

import vpt_torch
from vpt_torch.dist import train_fast
from vpt_torch.kernels import dual as du
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import prims as tp
from vpt_torch.kernels import wavefront as wf
from vpt_torch.media import density as dfn
from vpt_torch.scene.scene import CORNELL_VPT_SPHERES, SCENES

from test_torch_geom import (FLIP_TOL, Q99_TOL, check_image, check_tangents,
                             make, port_render, vpt_reference)
from test_torch_geom_ext import IMPLICIT_TASK
from test_torch_geom_fd import SPLICE_TOL, fd_grad
from test_torch_geom_grads import MEDIUM_SCENE, _fd
from test_torch_hetero import _field_inputs, _fields

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

C = CORNELL_VPT_SPHERES
FOG_CUT = [C[i] for i in (3, 7, 8)]
FOG = {"kind": "exp_height", "args": [0.06, -40.8, 1.01]}
BLOB_ROWS = [[-8.0, 2.0, 178.0, 9.0, 0.9], [8.0, -2.0, 170.0, 12.0, 0.7],
             [0.0, 10.0, 162.0, 8.0, 1.0]]
BLOB_SPHERES = [
    (12.0, (-18, -8, 150), (0.75, 0.3, 0.2), (0, 0, 0), 0, (0, 0, 0),
     (0, 0, 0), 0.0),
    (12.0, (18, -8, 160), (0.2, 0.4, 0.75), (0, 0, 0), 0, (0, 0, 0),
     (0, 0, 0), 0.0),
    (3.0, (0, 35, 190), (0, 0, 0), (130, 130, 115), 0, (0, 0, 0), (0, 0, 0),
     0.0)]
BLOBS = {"kind": "blobs", "rows": BLOB_ROWS, "majorant": 1.8}


def grid_spec(n=8):
    """blob_cloud's blobs sampled at the centres of n^3 voxels over
    examples/recover_grid.py's box (x -28..28, y -18..24, z 150..195),
    xy-nearest transport, n_march 8, majorant 1.3 x the largest value."""
    axes = [np.linspace(a, b, n) for a, b in ((-28, 28), (-18, 24),
                                               (150, 195))]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    rows = np.asarray(BLOB_ROWS)
    q = ((pts[..., None, :] - rows[:, :3]) ** 2).sum(-1)
    vals = (rows[:, 4] * np.exp(-0.5 * q / rows[:, 3] ** 2)).sum(-1).astype(
        np.float32)
    sp = [float(a[1] - a[0]) for a in axes]
    org = [float(a[0]) - s / 2 for a, s in zip(axes, sp)]
    return {"kind": "grid", "values": vals.tolist(),
            "kw": dict(origin=org, spacing=sp,
                       majorant=float(vals.max()) * 1.3, n_march=8,
                       transport_interp="nearest")}


FRAME = dict(width=16, height=8, spp=4, seed=3)
FOG_TASK = dict(name="fog", spheres=FOG_CUT, sigma=(0.004, 0.036),
                density=FOG, **FRAME,
                kw=dict(sphere=1, cam_grads=False, max_bounces=6,
                        sampler="random"))
FOG_EA_TASK = dict(name="fog_ea", spheres=FOG_CUT, sigma=(0.004, 0.036),
                   density=FOG, g=0.5, **FRAME,
                   kw=dict(sphere=None, cam_grads=True,
                           distance="equiangular", max_bounces=6,
                           sampler="ld"))
BLOBS_TASK = dict(name="blobs", spheres=BLOB_SPHERES, sigma=(0.004, 0.04),
                  density=BLOBS, **FRAME,
                  kw=dict(sphere=2, cam_grads=False, max_bounces=6,
                          sampler="random"))
# the FD step's optimizer: Adam per leaf (optax.multi_transform in vpt), the
# light at 0.2, sigma at 1e-4, exponential_decay(rate, 15, 0.75)
GRID_RATES = {"center": (0.2, 15, 0.75), "sigma_a": (1e-4, 15, 0.75),
              "sigma_s": (1e-4, 15, 0.75)}
GRID_BLOCKS = dict(sphere=2, cam_grads=False, sigma=True)
GRID_STEP_SEED = 5
GRID_TASK = dict(name="grid", spheres=BLOB_SPHERES, sigma=(0.004, 0.04),
                 density=grid_spec(), **FRAME,
                 kw=dict(sphere=2, cam_grads=False, primal_only=True,
                         max_bounces=6, sampler="random"),
                 fd_steps={"fd": dict(rates=GRID_RATES, seed=GRID_STEP_SEED,
                                      blocks=GRID_BLOCKS)})
TASKS = {t["name"]: t for t in (FOG_TASK, FOG_EA_TASK, BLOBS_TASK,
                                GRID_TASK)}
FLIPS = {"fog": [], "fog_ea": [], "blobs": [], "grid": [113]}
GRID_STEP_FLIPS = [113, 114]
K_OF = {"fog": 3, "fog_ea": 4, "blobs": 3, "grid": 0}


def _target(npix):
    return (0.2 * np.random.default_rng(2).random((npix, 3))).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref():
    port = {n: port_render(t) for n, t in TASKS.items()}
    npix = FRAME["width"] * FRAME["height"]
    inputs = {f"{n}.port_img": p[2] for n, p in port.items()}
    inputs["grid.fd_step_theta"] = gm.flatten_theta(port["grid"][1]).numpy()
    inputs["grid.fd_step_target"] = _target(npix)
    out = vpt_reference([dict(t) for t in TASKS.values()], inputs)
    return port, out


@pytest.mark.parametrize("name", sorted(TASKS))
def test_image_matches_vpt(ref, name):
    port, out = ref
    render, img = port[name][0], port[name][2]
    assert render.K == K_OF[name] and render.packed.field
    assert render.packed.entry == f"geom_field_k{K_OF[name]}"
    flip = check_image(img, out[f"{name}.img"])
    assert np.array_equal(flip, out[f"{name}.flip"])
    assert flip.tolist() == FLIPS[name]
    assert float(np.abs(img).max()) > 0.0


@pytest.mark.parametrize("name", ["fog", "fog_ea", "blobs"])
def test_tangent_planes_match_vpt(ref, name):
    port, out = ref
    tang, want = port[name][3], out[f"{name}.tang"]
    for k in range(tang.shape[0]):      # every plane moves somewhere
        assert np.abs(want[k]).max() > 0.0, k
    check_tangents(tang, want, np.asarray(FLIPS[name], int))


def test_grid_fd_step_matches_vpt(ref):
    """One make_fd_geom_train_step step in the grid medium (GRID_BLOCKS:
    the light's centre and sigma, dims 0-2 and 7-8) against vpt's own step
    with optax.multi_transform on the same theta and target, taken apart as
    tests/test_torch_geom_fd.check_rc_step takes recover_camera's:
      - every A/B render of every probe (2 x 2 x 5) against vpt's: q99
        below 1e-4 of the image scale on the lanes that do not flip, at
        most GRID_STEP_FLIPS flipping (more than 1e-4 of their own scale
        apart);
      - the probe losses: vpt's are the port's renders' with vpt's values
        on the lanes more than SPLICE_TOL of the image scale apart, within
        SPLICE_TOL relative;
      - the port's probe losses are its own renders', within 1e-5
        relative;
      - the update: the port's theta is dist.adam's first step on the
        port's FD gradient, and dist.adam on vpt's gradient is vpt's
        theta, within 1e-6 relative; the frozen leaves stay; the FD
        gradients of the light's centre and sigma have vpt's signs, and
        the two thetas agree within 1e-6 relative plus what the
        gradients' difference moves Adam's first step;
      - the loss: the port's renders with vpt's values on the flip lanes
        alone give vpt's within SPLICE_TOL relative.
    Lanes 113 and 114 (the bottom row, two rays that graze the grid's box)
    flip in every render of the step's A seed (10): the port's K1 and vpt's
    K1 part there too, on this grid with trilinear transport (XLA:CPU folds
    the march's constant products; ROADMAP Queue 3), and the port's K4
    primal equals its K1 image on them. Measured: the rest at q99 1.1e-5 of
    the scale; the spliced probe losses within 9.9e-6 relative (1.5e-3
    unspliced); the FD gradients of dims 0-2, 7, 8 of vpt's signs, the two
    thetas 8.3e-7 relative apart; the loss 1.4e-3 relative off vpt's (the
    homogeneous step's bound is 1e-3: ROADMAP Queue 3), 6.7e-6 with the flip
    lanes fixed."""
    port, out = ref
    t = GRID_TASK
    scene = make(t["spheres"], t["sigma"], 0.0, t["density"])
    cam = vpt_torch.default_camera()
    theta = gm.pack_theta(scene, cam, 2)
    init = gm.flatten_theta(theta).numpy()
    rates = {k: vpt_torch.dist.exponential_decay(*r)
             for k, r in GRID_RATES.items()}
    opt = vpt_torch.dist.adam(theta, rates)
    renders, make_r = [], train_fast.make_geom_renderer

    def recording(*args, **kw):
        render = make_r(*args, **kw)
        run = render.run_vec

        def run_vec(v, s):
            res = run(v, s)
            renders.append(res[0].numpy().copy())
            return res
        render.run_vec = run_vec
        return render

    train_fast.make_geom_renderer = recording
    try:
        step = vpt_torch.dist.make_fd_geom_train_step(
            scene, cam, t["width"], t["height"], 2 * t["spp"], opt,
            max_bounces=6, sampler="random", device="cpu", **GRID_BLOCKS)
    finally:
        train_fast.make_geom_renderer = make_r
    target = _target(t["width"] * t["height"])
    loss = float(step(theta, torch.from_numpy(target), GRID_STEP_SEED))
    probes = np.asarray([[float(a), float(b)] for a, b in step.probe_losses],
                        np.float32)
    ref_probes = out["grid.fd_step_fd_probes"].reshape(-1, 2)
    ref_imgs = out["grid.fd_step_fd_imgs"].reshape(-1, *renders[0].shape)
    assert len(renders) == len(ref_imgs) == 20
    spliced, flips = [], []
    for mine, theirs in zip(renders, ref_imgs):
        lane = np.abs(mine - theirs).max(-1)
        flip = np.flatnonzero(lane > FLIP_TOL * np.maximum(
            1.0, np.abs(theirs).max(-1)))
        flips.append(flip.tolist())
        keep = np.ones(lane.shape, bool)
        keep[flip] = False
        scale = max(1.0, float(np.abs(theirs).max()))
        assert float(np.quantile(lane[keep], 0.99)) / scale < Q99_TOL
        far = lane / scale > SPLICE_TOL
        mixed = mine.copy()
        mixed[far] = theirs[far]
        spliced.append(mixed)
    assert all(set(f) <= set(GRID_STEP_FLIPS) for f in flips), flips
    own = np.stack(renders).reshape(-1, 2, *renders[0].shape)
    own_l = np.mean((own[:, 0] - target) * (own[:, 1] - target),
                    axis=(1, 2)).reshape(-1, 2)
    assert np.allclose(own_l, probes, rtol=1e-5, atol=0.0), (own_l, probes)
    spliced = np.stack(spliced).reshape(-1, 2, *renders[0].shape)
    spliced_l = np.mean((spliced[:, 0] - target) * (spliced[:, 1] - target),
                        axis=(1, 2)).reshape(-1, 2)
    assert np.allclose(spliced_l, ref_probes, rtol=SPLICE_TOL, atol=0.0), (
        spliced_l, ref_probes)
    dims = [7, 8]
    g, g_ref = fd_grad(probes, dims), fd_grad(ref_probes, dims)
    new = gm.flatten_theta(theta).numpy()
    ref_new = out["grid.fd_step_fd_new"]
    assert np.allclose(new, _adam_first_step(scene, cam, rates, g),
                       rtol=1e-6, atol=0.0)
    assert np.allclose(_adam_first_step(scene, cam, rates, g_ref), ref_new,
                       rtol=1e-6, atol=0.0)
    frozen = [3, 4, 5, 6, 9, 10, 11]
    assert np.array_equal(new[frozen], init[frozen])
    assert np.array_equal(ref_new[frozen], init[frozen])
    # the two thetas directly (tests/test_torch_geom_fd.check_rc_step):
    # Adam's first step lr g / (|g| + eps) moves by lr eps |g - g_vpt| /
    # ((|g| + eps)(|g_vpt| + eps)) between two gradients of one sign
    live = [0, 1, 2] + dims
    lr = np.asarray([GRID_RATES["center"][0]] * 3
                    + [GRID_RATES["sigma_a"][0], GRID_RATES["sigma_s"][0]])
    gd, gr = g[live], g_ref[live]
    assert np.all(np.sign(gd) == np.sign(gr)), (gd, gr)
    slack = lr * 1e-8 * np.abs(gd - gr) / (np.abs(gd) * np.abs(gr))
    assert np.all(np.abs(new[live] - ref_new[live])
                  <= 1e-6 * np.abs(ref_new[live]) + slack), (
        new[live], ref_new[live], slack)
    # the loss, (l+ + l-) / 2 of the first dimension: the port's renders
    # with vpt's values on the flip lanes alone give vpt's loss within
    # SPLICE_TOL relative, so those lanes are the whole of the port's gap
    # to it (1.4e-3 relative, more than the homogeneous step's 1e-3 bound:
    # ROADMAP Queue 3)
    want = float(out["grid.fd_step_fd_loss"])
    assert np.isclose(loss, 0.5 * (probes[0, 0] + probes[0, 1]), rtol=1e-6,
                      atol=0.0)
    fixed = []
    for mine, theirs, flip in zip(renders[:4], ref_imgs[:4], flips[:4]):
        mixed = mine.copy()
        mixed[flip] = theirs[flip]
        fixed.append(mixed - target)
    fixed_loss = 0.5 * (np.mean(fixed[0] * fixed[1])
                        + np.mean(fixed[2] * fixed[3]))
    assert abs(fixed_loss - want) <= SPLICE_TOL * abs(want), (fixed_loss,
                                                              want)
    print(f"grid FD step: flip lanes per render {flips}; loss "
          f"{abs(loss - want) / want:.2e} relative (flip lanes fixed "
          f"{abs(fixed_loss - want) / want:.2e}), probes "
          f"{np.abs(probes / ref_probes - 1).max():.2e} (spliced "
          f"{np.abs(spliced_l / ref_probes - 1).max():.2e}); gradient "
          f"{gd} vs {gr}; theta {new[live]} vs {ref_new[live]}, "
          f"{np.abs(new[live] / ref_new[live] - 1).max():.2e} relative")


def _adam_first_step(scene, cam, rates, grad):
    theta = gm.pack_theta(scene, cam, 2)
    opt = vpt_torch.dist.adam(theta, rates)
    off = 0
    for key, n in gm.THETA_KEYS:
        theta[key].grad = torch.from_numpy(
            grad[off:off + n].copy()).reshape(theta[key].shape)
        off += n
    train_fast._optimizer_step(opt)
    with torch.no_grad():
        for k in ("sigma_a", "sigma_s"):
            theta[k].clamp_(min=1e-6)
    return gm.flatten_theta(theta).numpy()


# ---- the dual field forms against vpt's, eagerly --------------------------

NT = 2      # tangent planes of the eager inputs


def _dual_pair(a, rs):
    """The same dual input for vpt (jnp) and the port (torch): the array
    with NT random tangents."""
    tans = [rs.normal(size=a.shape).astype(np.float32) for _ in range(NT)]
    return (jd.D(jnp.asarray(a), tuple(jnp.asarray(x) for x in tans)),
            du.D(torch.from_numpy(a), tuple(torch.from_numpy(x)
                                            for x in tans)))


def _planes(x, like):
    """(value, tangents...) of a dual or plain output as float64 numpy."""
    v = np.asarray(jd.val(x) if isinstance(x, jd.D) else du.val(x),
                   np.float64) * np.ones(like)
    t = jd.tan(x) if isinstance(x, jd.D) else du.tan(x)
    t = [np.zeros(like) if (t is None or c is None)
         else np.asarray(c, np.float64) * np.ones(like) for c in
         (t if t is not None else [None] * NT)]
    return [v] + t


def _same(a, b, what):
    """vpt's a and the port's b: finite where vpt's is, within rtol 1e-5 /
    atol 1e-6 of the finite scale there. Returns the non-finite count."""
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b)), what
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    if fin.any():
        np.testing.assert_allclose(
            b[fin], a[fin], rtol=1e-5,
            atol=1e-6 * max(1.0, np.abs(a[fin]).max()), err_msg=what)
    return int((~fin).sum())


@pytest.mark.parametrize("name", ["foggy_cornell", "blob_cloud"])
@pytest.mark.parametrize("fn", ["erf_poly", "log1p", "field_density",
                                "field_tau", "field_sample_free"])
def test_dual_field_form(name, fn):
    """The port's kernels/dual.py form against vpt's, value and every
    tangent. field_sample_free: exp_height's dual inversion; blobs' delta
    tracking (primal, the same draws). Non-finite results (none on these
    rays) must sit where vpt's do: the port reproduces vpt's arithmetic,
    overflow included (ROADMAP Queue 3)."""
    sc, pk = _fields(name)
    fcj, fct = sc["field"], pk.field
    st = np.float32(sc["sigma_a"] + sc["sigma_s"])
    o, d, t, u = _field_inputs(name, 13)
    N = t.shape[0]
    rs = np.random.RandomState(5)
    pairs = [_dual_pair(x, rs) for x in (*o, *d, t)]
    oj, ot = [p[0] for p in pairs[:3]], [p[1] for p in pairs[:3]]
    dj, dt = [p[0] for p in pairs[3:6]], [p[1] for p in pairs[3:6]]
    tj, tt = pairs[6]
    stj, stt = jnp.float32(st), torch.tensor(st)
    if fn == "erf_poly":       # arguments over [-3, 15]
        a, b = jd.erf_poly(tj * 0.05), du.erf_poly(tt * 0.05)
    elif fn == "log1p":         # of -u, as the inversion takes it
        xj, xt = _dual_pair(-u * np.float32(0.999), rs)
        a, b = jd.log1p(xj), du.log1p(xt)
    elif fn == "field_density":
        xj = [oj[i] + tj * dj[i] for i in range(3)]
        xt = [ot[i] + tt * dt[i] for i in range(3)]
        a, b = jd.field_density(fcj, xj), du.field_density(fct, xt)
    elif fn == "field_tau":
        a = jd.field_tau(fcj, stj, oj, dj, tj)
        b = du.field_tau(fct, stt, ot, dt, tt)
    else:
        lane = np.arange(N, dtype=np.int32)
        from vpt.kernels import prims as jp
        rj = jp.Pcg(jp.pcg_seed(jnp.asarray(lane), jnp.int32(5)))
        rt = tp.Pcg(tp.pcg_seed(torch.from_numpy(lane), 5))
        cap = np.where(lane % 3 == 0, 1e8, np.abs(t)).astype(np.float32)
        a = jd.field_sample_free(fcj, stj, oj, dj, jnp.asarray(u), rj,
                                 jnp.asarray(cap))
        b = du.field_sample_free(fct, stt, ot, dt, torch.from_numpy(u), rt,
                                 torch.from_numpy(cap))
        assert np.array_equal(np.asarray(rj.s).astype(np.int64) & 0xFFFFFFFF,
                              rt.s.numpy())
        if name == "blob_cloud":    # delta tracking: a primal distance
            av, bv = np.asarray(a), b.numpy()
            same = (av == 1e8) == (bv == 1e8)
            close = np.isclose(bv, av, rtol=1e-5, atol=1e-6)
            assert same.mean() >= 0.999 and close.mean() >= 0.999
            return
    bad = 0
    for k, (pa, pb) in enumerate(zip(_planes(a, (N,)), _planes(b, (N,)))):
        bad += _same(pa, pb, f"{fn} plane {k}")
    assert bad == 0, bad


def _extreme_fog_rays(seed):
    """Rays where exp_height's f32 rails engage: origins far below the fog
    plane (the density saturates at e^80) and far above it (e^-80),
    near-horizontal and steep directions, distances up to BIG."""
    rs = np.random.RandomState(seed)
    n = 2048
    y = np.concatenate([rs.uniform(-4000, -1400, n // 2),
                        rs.uniform(1400, 4000, n // 2)])
    o = np.stack([rs.uniform(-50, 50, n), y, rs.uniform(-80, 60, n)])
    d = rs.normal(size=(3, n))
    d[1, ::4] = rs.uniform(-2e-5, 2e-5, n // 4)
    d /= np.linalg.norm(d, axis=0)
    t = np.exp(rs.uniform(0.0, np.log(1e8), n)) * np.where(
        rs.uniform(size=n) < 0.8, 1.0, -1.0)
    u = rs.uniform(0, 1, n)
    return (o.astype(np.float32), d.astype(np.float32), t.astype(np.float32),
            u.astype(np.float32))


def test_exp_height_rails_against_vpt():
    """The overflow question (ROADMAP Queue 3), on rays far below and far
    above the fog plane. field_tau: vpt's dual form divides d0 - d_end (up
    to e^80) by m = k d_y (|m| >= 1e-6), which overflows f32; its
    +-TAU_CAP clip then zeroes the tangent, so every value and tangent is
    finite and the port matches vpt's (the port reproduces it). The
    free-flight inversion: above the plane a = sigma_t d0 is tiny (on its
    1e-30 floor with a zero tangent far above), and vpt's tangent of
    arg = -tau m / a adds a.t (-arg / a) with arg / a past f32's range:
    inf, or NaN where a.t is 0; the port takes that term as -(arg (a.t /
    a)) there (dual._div_guarded). Its values equal vpt's everywhere, its
    tangents equal vpt's wherever vpt's are finite, and are finite where
    vpt's are not (measured: 400 of 2048 rays NaN in vpt)."""
    _, pk = _fields("foggy_cornell")
    fcj = _fields("foggy_cornell")[0]["field"]
    fct = pk.field
    st = np.float32(0.04)
    o, d, t, u = _extreme_fog_rays(17)
    rs = np.random.RandomState(3)
    pairs = [_dual_pair(x, rs) for x in (*o, *d, t)]
    oj, ot = [p[0] for p in pairs[:3]], [p[1] for p in pairs[:3]]
    dj, dt = [p[0] for p in pairs[3:6]], [p[1] for p in pairs[3:6]]
    tj, tt = pairs[6]
    stj, stt = jnp.float32(st), torch.tensor(st)
    n = t.shape[0]
    a = jd.field_tau(fcj, stj, oj, dj, tj)
    b = du.field_tau(fct, stt, ot, dt, tt)
    for k, (pa, pb) in enumerate(zip(_planes(a, (n,)), _planes(b, (n,)))):
        assert np.isfinite(pa).all(), k
        assert _same(pa, pb, f"field_tau plane {k}") == 0
    lane = np.arange(n, dtype=np.int32)
    from vpt.kernels import prims as jp
    a = jd.field_sample_free(fcj, stj, oj, dj, jnp.asarray(u),
                             jp.Pcg(jp.pcg_seed(jnp.asarray(lane),
                                                jnp.int32(5))),
                             jnp.asarray(np.full(n, 1e8, np.float32)))
    b = du.field_sample_free(fct, stt, ot, dt, torch.from_numpy(u),
                             tp.Pcg(tp.pcg_seed(torch.from_numpy(lane), 5)),
                             torch.from_numpy(np.full(n, 1e8, np.float32)))
    pa, pb = _planes(a, (n,)), _planes(b, (n,))
    assert _same(pa[0], pb[0], "the distance") == 0
    bad = np.zeros(n, bool)
    for k in range(1, NT + 1):
        fin = np.isfinite(pa[k])
        bad |= ~fin
        assert np.isfinite(pb[k]).all(), k
        np.testing.assert_allclose(pb[k][fin], pa[k][fin], rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(
                                       pa[k][fin]).max()))
    above = o[1] > 1000.0           # where sigma_t d0 is tiny
    assert bad.any() and not (bad & ~above).any()


# ---- port-only -----------------------------------------------------------

W, H, SPP, MB = 12, 8, 2, 5     # tests/test_geom_kernel.py's frame
SEED = 3


@pytest.mark.parametrize("name,distance", [
    ("foggy_cornell", "free"), ("blob_cloud", "free"),
    ("foggy_cornell", "equiangular"), ("grid", "free"),
    ("grid", "equiangular")])
def test_field_primal_matches_k1(name, distance):
    """vpt's contract (tests/test_geom_kernel.py:434-456): K4's primal in a
    field against the forward kernel's image (here the port's plain K1,
    itself held against vpt's) at q99 < 1e-4 of the image scale; the dual
    arithmetic rounds differently, so not bit for bit. "grid": GRID_TASK's
    scene (grid_spec's 8^3 xy-nearest grid of blob_cloud's blobs), K = 0
    (primal_only), so under equi-angular K4's Bernoulli(Tr) through the
    grid's optical depth, |tau| behind the origin and sigma_s(xt) through
    its density (the grid moves 79 and 80 of the 96 pixels against the
    same scene's homogeneous medium). Measured: q99 0 (fog), 0 (blobs), 0
    (fog EA), 2.2e-7 (grid free), 9.9e-7 (grid EA)."""
    cam = vpt_torch.default_camera()
    if name == "grid":
        scene = make(GRID_TASK["spheres"], GRID_TASK["sigma"], 0.0,
                     GRID_TASK["density"])
        blocks = dict(sphere=2, primal_only=True)
    else:
        scene = SCENES[name]()
        blocks = dict(sphere=9 if name == "foggy_cornell" else 2,
                      cam_grads=False)
    sphere = blocks["sphere"]
    render = gm.make_geom_renderer(scene, cam, W, H, SPP, distance=distance,
                                   max_bounces=MB, device="cpu", **blocks)
    assert render.packed.field and render.K == (0 if name == "grid" else 3)
    img, tang = render(gm.pack_theta(scene, cam, sphere), SEED)
    assert torch.isfinite(img).all() and torch.isfinite(tang).all()
    pk = wf.pack_scene(scene, cam, W, H, SPP, max_bounces=MB,
                       distance=distance)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    rel = (img - ref).abs() / max(1.0, float(ref.abs().max()))
    assert float(torch.quantile(rel.flatten(), 0.99)) < Q99_TOL


def _with_g(scene, g):
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))


EA = dict(distance="equiangular")
FIELD_ESTIMATORS = {
    "fog_free": ("foggy_cornell", 0.0, {}),
    "fog_ea": ("foggy_cornell", 0.0, EA),
    "fog_implicit_physical": ("lamp_fog", 0.0,
                              dict(nee=False, physical=True)),
    "fog_hg": ("foggy_cornell", 0.5, {}),
    "blobs_free": ("blob_cloud", 0.0, {}),
    "blobs_ea_hg": ("blob_cloud", 0.5, EA),
}


@pytest.mark.parametrize("est", sorted(FIELD_ESTIMATORS))
def test_field_primal_does_not_depend_on_k(est):
    """The K = 0 (primal_only) image equals the K = 7 primal plane bit for
    bit in a field too (the dual forms' primal is the same at any K)."""
    name, g, kw = FIELD_ESTIMATORS[est]
    cam = vpt_torch.default_camera()
    if name == "lamp_fog":      # implicit paths reach the big lamp
        scene = make(IMPLICIT_TASK["spheres"], IMPLICIT_TASK["sigma"], g,
                     FOG)
        sphere = 3
    else:
        scene = _with_g(SCENES[name](), g)
        sphere = 2 if name == "blob_cloud" else 8
    theta = gm.pack_theta(scene, cam, sphere)
    imgs = []
    for blocks in (dict(primal_only=True), dict(cam_grads=True)):
        render = gm.make_geom_renderer(scene, cam, 8, 6, 2, sphere=sphere,
                                       max_bounces=5, device="cpu",
                                       **blocks, **kw)
        img, tang = render(theta, 5)
        assert torch.isfinite(img).all() and torch.isfinite(tang).all()
        assert render.packed.field and not render.packed.ext
        imgs.append(img)
    assert float(imgs[0].abs().max()) > 0.0
    assert torch.equal(imgs[0], imgs[1])


FOG_MEDIUM_SCENE = dataclasses.replace(
    MEDIUM_SCENE, medium=dataclasses.replace(
        MEDIUM_SCENE.medium,
        density=dfn.exp_height(k=0.03, y0=-30.0, majorant=2.5)))


def test_exp_height_light_tangent_matches_fixed_seed_fd():
    """tests/test_geom_kernel.py:459-470: the one-sphere medium scene in
    exp_height fog, the light's y tangent (the fog's optical depth toward
    the light and the reparameterized inversion move smoothly with it)
    against fixed-seed central FD of the port's own primal, rtol 8e-2.
    Measured: 1.1e-3 relative."""
    cam = vpt_torch.default_camera()
    render = gm.make_geom_renderer(FOG_MEDIUM_SCENE, cam, W, H, SPP,
                                   sphere=0, cam_grads=False, max_bounces=MB,
                                   device="cpu")
    theta = gm.pack_theta(FOG_MEDIUM_SCENE, cam, 0)
    g, fd = _fd(render, theta, "center", 1, 1e-2, 1)
    assert np.isfinite(g) and np.isfinite(fd) and g != 0.0
    assert np.isclose(g, fd, rtol=8e-2, atol=1e-6), (g, fd)


@pytest.mark.parametrize("sampler,draws", [("ld", 144), ("random", 146)])
def test_blob_free_flight_draw_count(monkeypatch, sampler, draws):
    """Free flight in blob_cloud (one MIS light): camera 2 ("random"),
    u_rr, u_pick, u_dist, delta tracking's 2 max_null = 128 draws, MISv2 3
    + 3, BSDF 3, phase 2, medium NEE 2 per iteration (K1's count, ROADMAP
    Queue 2's contract)."""
    calls = []
    real = tp.Pcg.__call__

    def counted(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(tp.Pcg, "__call__", counted)
    scene, cam = SCENES["blob_cloud"](), vpt_torch.default_camera()
    assert len(scene.mis_light_idx) == 1
    gp = gm.pack_geom(scene, cam, 1, 1, 2, sphere=2, max_bounces=2,
                      sampler=sampler)
    stats = {}
    gm.geom_fwd_plain(gp, gm.flatten_theta(gm.pack_theta(scene, cam, 2)),
                      torch.tensor([3], dtype=torch.int32), stats)
    offsets = 5 if sampler == "ld" else 0
    assert len(calls) == offsets + draws * stats["thread_iters"]
    assert stats["null_steps"] > 0 and stats["taus"] > 0


def test_fit_geom_and_fd_in_field_media():
    """The trainers take field scenes on the CPU: two fit_geom steps in the
    fog (the dual kernel's tangents) and two fit_geom_fd steps in the grid
    (its primal_only mode), each finite and moving the light."""
    cam = vpt_torch.default_camera()
    fog = make(FOG_CUT, (0.004, 0.036), 0.0, FOG)
    grid = make(BLOB_SPHERES, (0.004, 0.04), 0.0, grid_spec())
    for scene, sphere, fit in ((fog, 1, vpt_torch.dist.fit_geom),
                               (grid, 2, vpt_torch.dist.fit_geom_fd)):
        pk = wf.pack_scene(scene, cam, 8, 6, 8, max_bounces=4)
        target = wf.render_tile_plain(
            pk, torch.tensor([7], dtype=torch.int32)).reshape(6, 8, 3)
        moved = dataclasses.replace(scene, center=scene.center.clone())
        moved.center[sphere, 1] += 2.0
        theta, losses = fit(moved, cam, target, sphere=sphere,
                            cam_grads=False, steps=2, spp=4, max_bounces=4,
                            device="cpu")
        assert len(losses) == 2 and np.isfinite(losses).all()
        start = moved.center[sphere].numpy()
        assert np.isfinite(theta["center"].detach().numpy()).all()
        assert not np.array_equal(theta["center"].detach().numpy(), start)
