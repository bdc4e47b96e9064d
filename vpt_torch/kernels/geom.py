"""Geometric-gradient render: forward-mode dual kernel K4, plus its plain
version.

Counterpart of ``vpt/kernels/geom.py``. One pass renders the image and K
directional image-derivatives ("tangent planes") for the basis
[centre.xyz of one sphere?, cam_origin.xyz + fov?, cam_dir.xyz?], K <= 10;
`primal_only` is K = 0: a forward render whose geometry and medium come
from theta at each call, the substrate of the CRN finite-difference
trainer (dist/train_fast.make_fd_geom_train_step). Here the same estimator
runs as

  - ``geom_fwd``: the hand-written CUDA kernel (csrc/geom.cu over the
    per-path code in csrc/geom_path.cuh), one thread per pixel, launched on
    CUDA tensors; on CPU tensors it runs the plain version;
  - ``geom_fwd_plain``: a line-by-line torch counterpart of vpt's body
    (geom.py:182-599) on (N,) lanes in lockstep, built on kernels/dual.py;
  - ``make_geom_renderer``: render(theta, seed) -> (img, tang), with
    vpt's attributes (grad_render, run_vec, flatten, K, basis_names, npix).

theta (pack_theta) flattens to 12 floats: [centre 3, cam_origin 3, fov,
sigma_a, sigma_s, cam_dir 3]. The estimator is vpt's detached-decision
pathwise derivative: event masks are detached, every smooth chain carries
tangents, so the boundary terms of geometric derivatives (silhouettes,
shadow edges, an emitter's own disk) are dropped by design (vpt's module
docstring); CRN finite differences on the primal_only mode recover them.

Draw order: K2's (kernels/diff.py), which vpt's geom body mirrors: camera
u, v (random sampler with jitter), u_rr, u_pick, u_dist, MISv2, BSDF,
phase, medium NEE. Arithmetic: vpt's dual.py conventions (kernels/dual.py),
so the primal plane is not bit-equal to K1's image (q99 < 1e-4, vpt's own
contract); the camera basis, sigma_t, 1/sigma_t and (sigma_s/sigma_t)/cp
are f32 operations on theta.

Scope: nee=True, distance="free", physical=False, a homogeneous medium
with g == 0, no material-3 shell, samplers "random" and "ld". Everything
else raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..scene.camera import Camera
from ..scene.scene import Scene
from . import dual as du
from . import prims as pr
from .prims import BIG, INV_4PI, TWO_PI, f32
from .wavefront import _G_EPS, Packed, pack_scene

__all__ = ["pack_theta", "flatten_theta", "GeomPacked", "pack_geom",
           "geom_fwd_plain", "geom_fwd", "make_geom_renderer", "LAUNCHES",
           "THETA_KEYS"]

# kernel launches in this process (geom_fwd adds one per launch)
LAUNCHES = 0

# flattened theta layout: (key, size)
THETA_KEYS = (("center", 3), ("cam_origin", 3), ("fov", 1), ("sigma_a", 1),
              ("sigma_s", 1), ("cam_dir", 3))


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} in the geometric-gradient kernel is ROADMAP Queue 1 item "
        f"{item}")


def pack_theta(scene, camera: Camera | None = None,
               sphere: int | None = None) -> dict:
    """Geometric and medium parameters: the differentiated sphere's centre
    (zeros when sphere is None), the camera origin, fov scale and look
    direction, and sigma_a / sigma_s, as float32 tensors.

    `scene` may also be a dict with those keys (vpt's pack_theta output as
    numpy arrays, or this function's): it is converted as it stands."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    if isinstance(scene, dict):
        return {k: t(scene[k]).reshape(() if n == 1 else (n,))
                for k, n in THETA_KEYS}
    center = (np.zeros(3, np.float32) if sphere is None
              else scene.center[sphere].detach().cpu().numpy())
    return {
        "center": t(center),
        "cam_origin": t(camera.origin.detach().cpu().numpy()),
        "fov": t(float(camera.fov_scale)),
        "sigma_a": t(float(scene.medium.sigma_a)),
        "sigma_s": t(float(scene.medium.sigma_s)),
        "cam_dir": t(camera.direction.detach().cpu().numpy()),
    }


def flatten_theta(theta: dict) -> torch.Tensor:
    """theta dict -> (12,) float32 vector, differentiable (torch.cat)."""
    return torch.cat([theta[k].reshape(n).to(torch.float32)
                      for k, n in THETA_KEYS])


@dataclasses.dataclass(frozen=True)
class GeomPacked:
    """What one K4 launch reads besides theta and the seed: the render
    kernel's Packed scene and frame, and the tangent basis. `words()` lays
    them out as csrc/geom_path.cuh's GeomParams."""

    pk: Packed
    sphere: int         # the sphere whose centre comes from theta; -1: none
    n_center: int       # 3 or 0: centre tangents
    n_cam: int          # 4 or 0: camera origin + fov tangents
    n_dir: int          # 3 or 0: look-direction tangents
    aspect: float       # f32(width / height)
    cp: float           # continue_prob as f32

    @property
    def K(self) -> int:
        return self.n_center + self.n_cam + self.n_dir

    @property
    def k_cam(self) -> int:
        return self.n_center

    @property
    def k_dir(self) -> int:
        return self.n_center + self.n_cam

    @property
    def npix(self) -> int:
        return self.pk.npix

    @property
    def planes(self) -> int:
        return 3 * (1 + self.K)

    def words(self) -> np.ndarray:
        ints = np.asarray([self.sphere, self.K, self.n_center, self.n_cam,
                           self.n_dir, self.k_cam, self.k_dir], np.int32)
        fl = np.asarray([self.aspect, self.cp], np.float32).view(np.int32)
        return np.concatenate([self.pk.words(), ints, fl])


def pack_geom(scene: Scene, camera: Camera, width: int, height: int,
              spp: int, *, sphere: int | None, cam_grads: bool = True,
              dir_grads: bool = False, primal_only: bool = False,
              continue_prob: float = 0.6, max_bounces: int = 32,
              sampler: str = "random", jitter: bool = True) -> GeomPacked:
    """Freeze scene, frame and tangent basis for K4. Radii, materials,
    albedo, radiance and the emitter structure are baked, as in vpt; the
    centre of `sphere`, the camera and sigma come from theta at each
    call."""
    if (sphere is None and not cam_grads and not dir_grads
            and not primal_only):
        raise ValueError("no differentiated block enabled")
    if sampler not in ("random", "ld"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if abs(float(torch.as_tensor(scene.medium.g))) > _G_EPS:
        raise _todo("a baked HG g != 0 (dual.hg_phase / hg_dir)", "5")
    pk = pack_scene(scene, camera, width, height, spp,
                    continue_prob=continue_prob, max_bounces=max_bounces,
                    sampler=sampler, jitter=jitter)
    if pk.vol:
        raise _todo("material-3 volumetric shells", "5")
    if sphere is not None and not 0 <= sphere < pk.S:
        raise ValueError(f"sphere {sphere} of a {pk.S}-sphere scene")
    return GeomPacked(
        pk=pk, sphere=-1 if sphere is None else int(sphere),
        n_center=3 if sphere is not None and not primal_only else 0,
        n_cam=4 if cam_grads and not primal_only else 0,
        n_dir=3 if dir_grads and not primal_only else 0,
        aspect=f32(width / height), cp=f32(continue_prob))


# ---------------------------------------------------------------------------
# plain version: vpt/kernels/geom.py:182-599 on (N,) lanes
# ---------------------------------------------------------------------------

def _geom_body(gp: GeomPacked, theta: torch.Tensor, seed: torch.Tensor,
               stats: dict | None = None) -> torch.Tensor:
    pk = gp.pk
    dev = theta.device
    K = gp.K
    S, W, H, spp = pk.S, pk.width, pk.height, pk.spp
    N = pk.npix
    n_em = len(pk.emitters)
    cp = gp.cp              # f32(continue_prob)
    inv_cp = pk.inv_cp      # f32(1 / continue_prob), folded in float64
    th = theta.detach()

    def scalar(v):
        # a device tensor: torch's CUDA ops divide by a host scalar as a
        # multiply by its reciprocal, which rounds differently
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def basis(k):
        return tuple(1.0 if i == k else None for i in range(K))

    pc = [th[i] for i in range(3)]
    co = [th[3 + i] for i in range(3)]
    fv = th[6]
    sigma_t = th[7] + th[8]
    inv_st = 1.0 / sigma_t
    ar_cp = th[8] * inv_st * inv_cp
    if gp.sphere >= 0:
        ctr_dual = (pc if not gp.n_center
                    else [du.D(pc[i], basis(i)) for i in range(3)])
    if gp.n_cam:
        cam_o = [du.D(co[i], basis(gp.k_cam + i)) for i in range(3)]
        fov = du.D(fv, basis(gp.k_cam + 3))
    else:
        cam_o = co
        fov = fv
    cd = [th[9 + i] for i in range(3)]
    if gp.n_dir:
        cam_d = [du.D(cd[i], basis(gp.k_dir + i)) for i in range(3)]
    else:
        cam_d = cd
    ctr_tab = [ctr_dual if s_ == gp.sphere else [float(v) for v in pk.c[s_]]
               for s_ in range(S)]

    # camera frame (src/rt.cpp:755-759), in f32 from theta
    cx = [fov * (W / H), 0.0, 0.0]
    cy_u = du.normalize3(du.cross3(cx, cam_d))
    cy = [cy_u[i] * fov for i in range(3)]

    lane = torch.arange(N, dtype=torch.int64, device=dev)
    px = (lane % W).to(torch.float32)
    py = (H - 1 - lane // W).to(torch.float32)
    seed_i = seed.to(torch.int64).reshape(())
    z = torch.zeros(N, dtype=torch.float32, device=dev)
    w_f, h_f = scalar(float(W)), scalar(float(H))
    if pk.ld:
        A1, A2, A3, A4, A5 = pr.LD_ALPHA
        off_u, off_v, off_w, off_r, off_p = pr.ld_offsets(lane, seed_i)
        strat = pr.ld_strat
    em_ids = torch.tensor(list(pk.emitters) + [-1], dtype=torch.int64,
                          device=dev)
    rad_tab = torch.tensor(pk.rad, dtype=torch.float32, device=dev)
    r_tab = torch.tensor(pk.r, dtype=torch.float32, device=dev)

    # the loop carry: every tangent materialised (geom.py mats/und)
    def mats(x):
        v, t = du.val(x), du.tan(x)
        out = [v + z]
        for k in range(K):
            tk = None if t is None else t[k]
            out.append(z if tk is None else tk + z)
        return du.D(out[0], tuple(out[1:]))

    def camera_ray(rng, samples):
        if pk.ld and pk.jitter:
            s_f = samples.to(torch.float32)
            u = strat(A1, off_u, s_f)
            v = strat(A2, off_v, s_f)
        elif pk.jitter:
            u, v = rng(), rng()
        else:
            u = torch.full_like(z, 0.5)
            v = torch.full_like(z, 0.5)
        sx = (px + u - 0.5) / w_f - 0.5
        sy = (py + v - 0.5) / h_f - 0.5
        d = [cx[i] * sx + cy[i] * sy + cam_d[i] for i in range(3)]
        return du.normalize3(d)

    def light_attrs(u_pick):
        k = torch.clamp((u_pick * n_em).to(torch.int64), 0, n_em - 1)
        k = torch.where(k >= 0, k, n_em)     # no emitters: the miss row
        lid = em_ids[k]
        lc = du.centre_of(pk, ctr_tab, lid)
        rows = pr.per_sphere(rad_tab, lid)
        lrad = [rows[:, 0], rows[:, 1], rows[:, 2]]
        lr = pr.per_sphere(r_tab, lid)
        return lc, lrad, lr, lid

    def plight_term(at, xs, n, d, lc, lrad):
        vis, dist, dl = du.visibility_from(pk, ctr_tab, lc, xs)
        le_scale = du.where(vis, 1.0 / du.maximum(dist * dist, 1e-20), z)
        wi = [-dl[0], -dl[1], -dl[2]]
        fr = du.eval_fr_nee_plight(at, n, d, wi)
        cosw = du.dot3(n, wi)
        return [lrad[i] * (le_scale * fr[i] * cosw) for i in range(3)], dist

    def mis_v2(rng, at, xs, n, d):
        acc = [z, z, z]
        wo = [-d[0], -d[1], -d[2]]
        for e in pk.mis_lights:
            ec = ctr_tab[e]
            er = float(pk.r[e])
            cxv = [ec[i] - xs[i] for i in range(3)]
            normcx = du.norm3(cxv)
            inv_ncx = 1.0 / normcx
            wc = du.scale3(cxv, inv_ncx)
            ratio = er * inv_ncx
            cos_max = du.sqrt(du.maximum(1.0 - ratio * ratio, 1e-12))
            u1 = rng()
            u2 = rng()
            wi = du.cone_dir(wc, cos_max, u1, u2)
            hit, _, sid = du.nearest_id_t(pk, ctr_tab, xs, wi)
            visible = hit & (sid == e)
            fr = du.eval_fr_nee(at, n, d, wi)
            fpdf_inv = TWO_PI * du.maximum(1.0 - cos_max, 1e-12)
            tr = du.exp(normcx * (-sigma_t))
            w_vis = du.where(visible, tr * du.dot3(n, wi) * fpdf_inv, z)
            gpdf = du.bsdf_pdf_for_dir(at, n, wo, wi, rng())
            wf = du.power_h_invf(fpdf_inv, gpdf)
            for i in range(3):
                acc[i] = acc[i] + float(pk.rad[e][i]) * (fr[i] * w_vis * wf)
        # BSDF strategy (misSamplingFunctions.h:132-167)
        u1, u2, u_choice = rng(), rng(), rng()
        wi_l = du.cosine_hemi(n, u1, u2)
        wt_, _ = du.refract_quirk(wo, n)
        fres = du.fresnel_die(du.dot3(n, wt_), du.dot3(n, wo))
        refl = u_choice < du.val(fres)
        ndotwo = du.dot3(n, wo)
        wr = du.normalize3([2.0 * ndotwo * n[i] - wo[i] for i in range(3)])
        wi_d = du.sel3(refl, wr, wt_)
        wh_loc = du.beckmann_wh(at["alpha"], u1, u2)
        wo_loc = du.to_local(n, wo)
        whw = 2.0 * du.dot3(wh_loc, wo_loc)
        wi_m_loc = du.normalize3([whw * wh_loc[i] - wo_loc[i]
                                  for i in range(3)])
        wi_m = du.normalize3(du.from_local(n, wi_m_loc))
        wi_sel = du.sel3(at["is_mic"], wi_m,
                         du.sel3(at["is_die"], wi_d, wi_l))
        hit, _, sid2 = du.nearest_id_t(pk, ctr_tab, xs, wi_sel)
        le_row = pr.per_sphere(rad_tab, sid2)
        le = [le_row[:, 0], le_row[:, 1], le_row[:, 2]]
        hit_r = pr.per_sphere(r_tab, sid2)
        hc = du.centre_of(pk, ctr_tab, sid2)
        cos_l = du.dot3(n, wi_l)
        gpdf_l = cos_l * (1.0 / math.pi)
        # cos_l/gpdf_l == pi when gpdf_l != 0, else 0 (the 1e-12 guard)
        nz_l = du.val(gpdf_l) != 0.0
        g_l = [du.where(nz_l, le[i] * at[("ar", "ag", "ab")[i]], z)
               for i in range(3)]
        cos_d = du.absd(du.dot3(n, wi_d))
        scale_d = (1.0 / du.maximum(cos_d, 1e-12)) * torch.where(
            refl, 1.0, pr.GLASS_ETA_T * pr.GLASS_ETA_T)
        g_d = [le[i] * scale_d for i in range(3)]
        gpdf_d = du.where(refl, fres, 1.0 - fres)
        fr_m = du.fr_microfacet(at, wi_m_loc, wh_loc, wo_loc)
        gpdf_m = du.ndf_beckmann(wh_loc[2], at["alpha"]) * wh_loc[2] / (
            4.0 * du.maximum(du.absd(du.dot3(wo_loc, wh_loc)), 1e-12))
        winv_m = wi_m_loc[2] / du.maximum(gpdf_m, 1e-20)
        g_m = [le[i] * (fr_m[i] * winv_m) for i in range(3)]
        g = du.sel3(at["is_mic"], g_m, du.sel3(at["is_die"], g_d, g_l))
        gpdf = du.where(at["is_mic"], gpdf_m,
                        du.where(at["is_die"], gpdf_d, gpdf_l))
        pos_all = ((du.val(g[0]) > 0.0) & (du.val(g[1]) > 0.0)
                   & (du.val(g[2]) > 0.0))
        gate = ((at["is_mic"] & (du.val(g[0]) > 0.0))
                | (~at["is_mic"] & pos_all))
        hcx = [hc[i] - xs[i] for i in range(3)]
        n2 = du.maximum(du.dot3(hcx, hcx), 1e-20)
        cmax = du.sqrt(du.maximum(1.0 - hit_r * hit_r / n2, 1e-12))
        fpdf_h_inv = TWO_PI * du.maximum(1.0 - cmax, 1e-12)
        wg = du.where(gate & hit, du.power_h_invg(gpdf, fpdf_h_inv), z)
        return [acc[i] + g[i] * wg for i in range(3)]

    def medium_nee(rng, xt, lc, lrad, lr, lid):
        wc = [lc[i] - xt[i] for i in range(3)]
        inv_mag = du.rsqrt(du.maximum(du.dot3(wc, wc), 1e-20))
        wc_n = du.scale3(wc, inv_mag)
        ratio = lr * inv_mag
        cos_max = du.sqrt(du.maximum(1.0 - ratio * ratio, 1e-12))
        u1 = rng()
        u2 = rng()
        wl = du.cone_dir(wc_n, cos_max, u1, u2)
        hit, t, sid = du.nearest_id_t(pk, ctr_tab, xt, wl)
        visible = hit & (sid == lid) & (lr > 0.0)
        phase_2pi = INV_4PI * TWO_PI    # isotropic: a folded constant
        tr_l = du.exp(t * (-sigma_t))
        # phase / cone_pdf = phase * 2pi * (1 - cos_max): no dual division
        w = du.where(visible,
                     tr_l * phase_2pi * du.maximum(1.0 - cos_max, 1e-12), z)
        return [lrad[i] * w for i in range(3)]

    rng = pr.Pcg(pr.pcg_seed(lane, seed_i))
    d0 = du.D(z + 1.0, tuple(z for _ in range(K)))
    zero_d = du.D(z, tuple(z for _ in range(K)))
    o, d, tp, L = [zero_d] * 3, [zero_d, zero_d, d0], [zero_d] * 3, \
        [zero_d] * 3
    alive = torch.zeros(N, dtype=torch.bool, device=dev)
    depth = torch.zeros(N, dtype=torch.int64, device=dev)
    samples = torch.zeros(N, dtype=torch.int64, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    one = 1.0 + z
    inv_ps = float(n_em)
    it = 0
    while it < pk.max_iters and bool((samples < spp).any()):
        need = ~alive & (samples < spp)
        if stats is not None:
            counts[0] += (samples < spp).sum()
        nd = camera_ray(rng, samples)
        o = du.sel3(need, cam_o, o)
        d = du.sel3(need, nd, d)
        tp = du.sel3(need, [one, one, one], tp)
        alive = alive | need
        depth = torch.where(need, 0, depth)
        was_alive = alive

        # ---- bounce (the draw order of kernels/diff.py)
        u_rr = rng()
        u_pick = rng()
        u_dist = rng()
        if pk.ld:
            s_f = samples.to(torch.float32)
            dz = depth == 0
            u_rr = torch.where(dz, strat(A4, off_r, s_f), u_rr)
            u_pick = torch.where(dz, strat(A5, off_p, s_f), u_pick)
            u_dist = torch.where(dz, strat(A3, off_w, s_f), u_dist)
        alive = alive & (u_rr >= pk.q)
        hit, t, at = du.nearest(pk, ctr_tab, o, d)
        t_eff = du.where(hit, t, BIG + z)
        xs = [o[i] + t_eff * d[i] for i in range(3)]
        nrm = du.normalize3([xs[0] - at["cx"], xs[1] - at["cy"],
                             xs[2] - at["cz"]])
        lc, lrad, lr, lid = light_attrs(u_pick)

        d_s = -torch.log1p(-u_dist) * inv_st    # sigma-only: plain
        surface = (t_eff < d_s) & hit
        xt = [o[i] + d[i] * d_s for i in range(3)]
        medium = alive & ~surface

        em_hit = surface & at["is_em"]
        credit = alive & em_hit & (depth == 0)
        radh = [at["rr"], at["rg"], at["rb"]]
        L = [L[i] + du.where(credit, radh[i] * tp[i], z) for i in range(3)]
        shade = alive & surface & ~em_hit

        ldp, dist_ls = plight_term(at, xs, nrm, d, lc, lrad)
        trs = du.exp(dist_ls * (-sigma_t))
        ldm = mis_v2(rng, at, xs, nrm, d)
        L = [L[i] + du.where(
            shade, (ldp[i] * trs * inv_ps + ldm[i]) * tp[i] * inv_cp, z)
            for i in range(3)]

        fs, wi_s, pdf_b = du.sample_bsdf(rng, at, d, nrm)
        cosine = du.dot3(nrm, wi_s)
        wscale = cosine / (du.maximum(pdf_b, 1e-20) * cp)
        tp_surface = [tp[i] * fs[i] * wscale for i in range(3)]

        u_p1, u_p2 = rng(), rng()
        wi_m = du.uniform_sphere(u_p1, u_p2)
        med_scale = ar_cp
        ld_med = medium_nee(rng, xt, lc, lrad, lr, lid)
        L = [L[i] + du.where(medium, ld_med[i] * inv_ps * tp[i] * med_scale,
                             z) for i in range(3)]
        tp_medium = [tp[i] * med_scale for i in range(3)]

        if stats is not None:
            counts[1] += shade.sum()
            counts[2] += medium.sum()
        o = du.sel3(shade, xs, du.sel3(medium, xt, o))
        d = du.sel3(shade, wi_s, du.sel3(medium, wi_m, d))
        tp = du.sel3(shade, tp_surface, du.sel3(medium, tp_medium, tp))
        alive2 = (shade | medium) & (depth + 1 < pk.max_bounces)
        depth = torch.where(alive2, depth + 1, depth)
        finished = was_alive & ~alive2
        samples = samples + finished.to(torch.int64)
        o, d, tp, L = ([mats(x) for x in v] for v in (o, d, tp, L))
        alive = alive2
        it += 1

    if stats is not None:
        for k, v in zip(("thread_iters", "shade", "medium"), counts.tolist()):
            stats[k] = stats.get(k, 0) + v
    return torch.stack([p for c in range(3)
                        for p in (L[c].v,) + tuple(L[c].t)])


def geom_fwd_plain(gp: GeomPacked, theta: torch.Tensor, seed: torch.Tensor,
                   stats: dict | None = None) -> torch.Tensor:
    """Plain torch K4 on theta.device: (3(1+K), npix) float32 per-pixel
    radiance SUMS over the samples, plane c*(1+K) + j for channel c, j = 0
    the image and j = 1..K the tangents. `stats`, if given, gains the
    lockstep loop's thread-iterations and its shading and medium events."""
    with torch.no_grad():
        return _geom_body(gp, theta, seed, stats)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def geom_fwd(gp: GeomPacked, theta: torch.Tensor,
             seed: torch.Tensor) -> torch.Tensor:
    """K4 on theta.device: the planes of geom_fwd_plain. A CUDA tensor
    launches csrc/geom.cu on the current stream without synchronising; a
    CPU tensor runs geom_fwd_plain."""
    global LAUNCHES
    if theta.dtype != torch.float32 or tuple(theta.shape) != (12,) \
            or not theta.is_contiguous():
        raise ValueError("theta must be a contiguous float32 tensor of "
                         "shape (12,)")
    if seed.dtype != torch.int32 or tuple(seed.shape) != (1,) \
            or not seed.is_contiguous():
        raise ValueError("seed must be a contiguous int32 tensor of shape "
                         "(1,)")
    if theta.device != seed.device:
        raise ValueError(f"theta on {theta.device}, seed on {seed.device}")
    if theta.device.type == "cpu":
        return geom_fwd_plain(gp, theta, seed)
    if theta.device.type != "cuda":
        raise ValueError(f"no geom kernel for device {theta.device}")
    from . import _build

    lib = _build.load()
    words = np.ascontiguousarray(gp.words())
    if words.size != lib.vpt_geom_params_words():
        raise RuntimeError(
            f"GeomParams layout mismatch: python packs {words.size} words, "
            f"the kernel expects {lib.vpt_geom_params_words()}")
    out = torch.empty((gp.planes, gp.npix), dtype=torch.float32,
                      device=theta.device)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = lib.vpt_geom_fwd(words.ctypes.data, theta.data_ptr(),
                               seed.data_ptr(), 0, gp.npix, out.data_ptr(),
                               stream)
    if err != 0:
        raise RuntimeError(f"vpt_geom_fwd launch failed: "
                           f"{_build.error_string(err)} ({err})")
    LAUNCHES += 1
    return out


def _split(planes: torch.Tensor, K: int, inv_spp: float):
    """(3(1+K), npix) sums -> (img (npix, 3), tang (K, npix, 3)), each
    scaled by a multiply by f32(1/spp) as vpt's run does."""
    p = planes.reshape(3, 1 + K, -1) * inv_spp
    return p[:, 0].T.contiguous(), p[:, 1:].permute(1, 2, 0).contiguous()


class _GeomRender(torch.autograd.Function):
    """image = K4(theta, seed)'s primal; d(image . gbar)/d(theta_k) is the
    contraction of tangent plane k with gbar (vpt's custom VJP,
    geom.py:651-679). The forward keeps the tangent planes for it."""

    @staticmethod
    def forward(ctx, vec, seed, run, slots):
        img, tang = run(vec, seed)
        ctx.save_for_backward(tang)
        ctx.slots = slots
        return img

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        (tang,) = ctx.saved_tensors
        g = torch.einsum("kpc,pc->k", tang, gbar)
        out = g.new_zeros(12)
        out[list(ctx.slots)] = g
        return out, None, None, None


def make_geom_renderer(scene: Scene, camera: Camera, width: int, height: int,
                       spp: int, *, sphere: int | None,
                       cam_grads: bool = True, dir_grads: bool = False,
                       nee: bool = True, distance: str = "free",
                       continue_prob: float = 0.6, max_bounces: int = 32,
                       jitter: bool = True, sampler: str = "random",
                       primal_only: bool = False, physical: bool = False,
                       device="cuda"):
    """Build render(theta, seed) -> (img (npix, 3), tang (K, npix, 3)) on
    `device` ("cuda": K4 or raise; "cpu": its plain version). theta is a
    pack_theta dict; tang[k] is d(img)/d(theta_k) for the basis
    render.basis_names. render.grad_render(theta, seed) is the image as a
    function differentiable by torch autograd (tangent contraction);
    render.run_vec(vec (12,), seed) is the vector-level entry, the FD
    substrate; primal_only=True gives K = 0."""
    if not nee:
        raise _todo("nee=False (the implicit estimator)", "5 (follow-up)")
    if distance != "free":
        raise _todo(f"distance={distance!r} (the equi-angular trig)",
                    "5 (follow-up)")
    if physical:
        raise _todo("physical=True", "5 (follow-up)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_geom_renderer(device='cuda'): "
                           "torch.cuda.is_available() is False")
    gp = pack_geom(scene, camera, width, height, spp, sphere=sphere,
                   cam_grads=cam_grads, dir_grads=dir_grads,
                   primal_only=primal_only, continue_prob=continue_prob,
                   max_bounces=max_bounces, sampler=sampler, jitter=jitter)
    K = gp.K
    inv_spp = f32(1.0 / spp)
    # the theta-vector slot of each tangent plane
    slots = (tuple(range(gp.n_center)) + tuple(range(3, 3 + gp.n_cam))
             + tuple(range(9, 9 + gp.n_dir)))

    def _seed(seed):
        if isinstance(seed, torch.Tensor):
            return seed.to(device=dev, dtype=torch.int32).reshape(1)
        return torch.tensor([int(seed)], dtype=torch.int32, device=dev)

    def run_vec(vec: torch.Tensor, seed):
        vec = vec.detach().to(device=dev, dtype=torch.float32).contiguous()
        return _split(geom_fwd(gp, vec, _seed(seed)), K, inv_spp)

    def render(theta: dict, seed):
        return run_vec(flatten_theta(theta), seed)

    def grad_render(theta: dict, seed):
        vec = flatten_theta(theta).to(dev)
        return _GeomRender.apply(vec, _seed(seed), run_vec, slots)

    if not primal_only:
        render.grad_render = grad_render
    render.run_vec = run_vec
    render.flatten = flatten_theta
    render.K = K
    render.basis_names = (
        tuple(f"center.{a}" for a in "xyz")[:gp.n_center]
        + (("cam_origin.x", "cam_origin.y", "cam_origin.z", "fov")
           if gp.n_cam else ())
        + (("cam_dir.x", "cam_dir.y", "cam_dir.z") if gp.n_dir else ()))
    render.npix = gp.npix
    render.packed = gp
    return render
