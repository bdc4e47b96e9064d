"""Forward render kernel: one CUDA thread per pixel, plus its plain version.

Counterpart of ``vpt/kernels/wavefront.py``. vpt renders a frame with one
Pallas TPU kernel (``build_tile_renderer``, a persistent wavefront over
(R, 128) lane tiles); here the same estimator runs as

  - ``render_tile`` / ``render_raw``: the hand-written CUDA kernel
    (csrc/wavefront_kernel.cuh over the per-path code in csrc/path.cuh),
    one thread per lane, launched on a CUDA tensor; on a CPU tensor they
    run the plain version;
  - ``render_tile_plain`` / ``render_raw_plain``: a line-by-line torch
    counterpart of the vpt kernel body on (N,) lane tensors in lockstep —
    the same masked selects, the same draw order and the same loop
    condition. It runs on any device; the tests hold it against vpt and the
    kernel against it.

Estimator variants (vpt's ``nee``, ``distance`` and ``physical``, picked by
integrator name in KERNEL_INTEGRATORS): free-flight or equi-angular
(``"equiangular"``, ``"ea_clamped"``) distance sampling, with or without
next-event estimation, and the textbook RR compensation (``physical``). The
kernel is compiled once per (nee, distance) pair it serves, in its own
source (csrc/wavefront*.cu); physical, the Henyey-Greenstein g and the
material-3 shells are launch parameters. A medium with an analytic density
field (exp_height or blobs, media/density.py) runs in a second set of
instantiations, one per pair again (csrc/wavefront_field*.cu): the field
is a compile-time parameter, so the homogeneous kernels keep their code,
and exp_height against blobs is a uniform switch inside them. A voxel grid
runs in a third set (csrc/wavefront_grid*.cu), which reads the grid's
packed table (prims.grid_table, on the launch's device) beside the launch
parameters; its transport interpolant is a launch parameter.

Draw-order contract (what makes per-pixel parity with vpt possible): every
iteration takes every draw the vpt body takes, in the same order, whether
or not its branch is taken — camera jitter (u, v; "random" sampler with
jitter only), u_rr, u_pick, u_dist, u_ev (equi-angular families only); with
NEE, for each MIS light two cone draws and the pdf flip draw, then the MIS
BSDF draws (u1, u2, u_choice); the continuation BSDF draws (u1, u2,
u_choice), the phase draws (u_p1, u_p2) and, with NEE, the two medium-NEE
cone draws. Without NEE the MIS and medium-NEE draws do not exist. The "ld"
sampler's offsets come from a second PCG stream drawn once before the loop.
A blobs field's free flight takes 2 * max_null more draws right after
u_dist (delta tracking's u1, u2 per null step, taken whether or not the
lane has accepted); exp_height takes none, nor does a grid (its free
flight inverts the march of its transport model with u_dist), nor
equi-angular sampling in a field.

Lanes and pixels: a lane renders pixel min(lane, npix - 1) and seeds its
PCG streams with the lane id, as vpt's tiles do. ``render_raw`` returns
per-lane radiance sums for contiguous tiles (vpt's ``make_raw``) or for a
list of tile bases in one launch (``make_raw_scatter``, the second pass of
adaptive sampling). A tile is LANES_PER_TILE lanes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.camera import Camera, screen_basis
from ..scene.scene import (DIELECTRIC, MICROFACET, VOLUME_BOUNDARY, Scene)
from . import prims as pr
from .prims import BIG, F32EPS, INV_4PI, TWO_PI, f32

__all__ = ["MAX_SPHERES", "MAX_BLOBS", "KERNEL_INTEGRATORS",
           "LANES_PER_TILE", "Packed",
           "pack_scene", "render_tile_plain", "render_raw_plain",
           "render_tile", "render_raw", "make_raw", "render_kernel",
           "LAUNCHES",
           "LAUNCHES_BY"]

MAX_SPHERES = 16        # VPT_MAX_SPHERES in csrc/path.cuh
MAX_BLOBS = 16          # VPT_MAX_BLOBS in csrc/path.cuh
FIELD_KINDS = {"exp_height": 1, "blobs": 2}     # FieldParams.kind

# integrator name -> (nee, distance, physical): vpt's PALLAS_INTEGRATORS
KERNEL_INTEGRATORS = {
    "explicit_free": (True, "free", False),
    "iterative_vpt_free": (True, "free", False),
    "implicit_free": (False, "free", False),
    "explicit_equiangular": (True, "equiangular", False),
    "mis_hybrid": (True, "equiangular", False),
    "implicit_equiangular": (False, "ea_clamped", False),
    "explicit_free_physical": (True, "free", True),
    "implicit_free_physical": (False, "free", True),
}
DISTANCES = ("free", "equiangular", "ea_clamped")

# (nee, distance) -> the C entry of its kernel instantiation
# (csrc/wavefront.cu, wavefront_free_implicit.cu, wavefront_ea.cu,
# wavefront_eac_implicit.cu)
KERNEL_ENTRIES = {
    (True, "free"): "vpt_wavefront_free_nee",
    (False, "free"): "vpt_wavefront_free_implicit",
    (True, "equiangular"): "vpt_wavefront_ea_nee",
    (False, "ea_clamped"): "vpt_wavefront_eac_implicit",
}
# the same pairs in an analytic density field (csrc/wavefront_field*.cu)
FIELD_ENTRIES = {key: entry + "_field"
                 for key, entry in KERNEL_ENTRIES.items()}
# and in a voxel grid (csrc/wavefront_grid*.cu), whose entries take the
# grid's table
GRID_ENTRIES = {key: entry + "_grid"
                for key, entry in KERNEL_ENTRIES.items()}

# Lanes per tile: the unit in which render_raw renders tiles and adaptive
# sampling selects them. vpt's tile is one Pallas program, (32, 128) lanes
# at its default tile_rows; here it is only the estimator's unit (the
# kernel runs one thread per lane whatever the tile), kept so the port
# selects the same tiles as vpt.
LANES_PER_TILE = 32 * 128

# launches of the CUDA kernel in this process: the wrapper adds one per
# launch under its instantiation's C entry, with "_scatter" appended for
# launches from a list of tile bases and "_raw" for make_raw's contiguous
# range. LAUNCHES reads their total. Callers that must show the kernel ran
# read them, and reset them by clearing LAUNCHES_BY.
LAUNCHES_BY: dict = {}


def __getattr__(name: str):
    if name == "LAUNCHES":
        return sum(LAUNCHES_BY.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_G_EPS = 1e-3   # |g| at or below this is isotropic, as in vpt


@dataclasses.dataclass(frozen=True)
class Packed:
    """Everything one render launch reads: the scene, the camera basis and
    the estimator constants, as python floats already rounded to f32.
    Constants that vpt folds in float64 when it bakes its kernel (r*r and
    the intersection epsilon per sphere, the camera basis, 1/sigma_t, the
    HG constants, ...) are folded the same way here, so both kernels see
    the same f32 values. `words()` lays the same values out as
    csrc/path.cuh's VptParams; nee and distance pick the kernel
    instantiation instead."""

    S: int
    r: tuple
    r2: tuple
    eps: tuple
    c: tuple            # (S, 3)
    alb: tuple          # (S, 3)
    rad: tuple          # (S, 3)
    eta: tuple          # (S, 3)
    kap: tuple          # (S, 3)
    alpha: tuple
    mat: tuple
    emitters: tuple
    mis_lights: tuple
    vol: tuple          # material-3 shells (pLight's multipleT cascade)
    sigma_a: float
    sigma_s: float
    # frame and estimator
    width: int
    height: int
    spp: int
    max_bounces: int
    max_iters: int
    ld: bool
    jitter: bool
    nee: bool
    distance: str
    physical: bool      # credit x 1/cp (the textbook RR compensation)
    cam_o: tuple
    cam_d: tuple
    cx: tuple
    cy: tuple
    inv_w: float
    inv_h: float
    q: float            # 1 - continue_prob
    inv_cp: float
    sigma_t: float
    inv_sigma_t: float
    tp_med: float       # albedo_ratio / cp
    med_c: float        # n_em * albedo_ratio / cp
    n_em_f: float
    nee_phase: float    # INV_4PI * TWO_PI
    slack: float        # pLight visibility slack 1 - 1024 eps
    ss_cp: float        # sigma_s / cp (the equi-angular medium weight)
    g: float            # baked HG anisotropy; 0.0 is isotropic
    hg_1pg2: float      # the HG constants of prims.hg_consts (0.0 at g == 0)
    hg_2g: float
    hg_phase: float
    hg_1mg2: float
    hg_1mg: float
    hg_inv2g: float
    # the density field (None: homogeneous), analytic (pr.FieldConsts) or
    # a voxel grid (pr.GridConsts, its table on the CPU), and 1/(sigma_t
    # majorant) folded in float64 (delta tracking's step scale)
    field: object
    inv_maj_rate: float
    # a grid's table per device, filled by table()
    _tabs: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    ATTR_KEYS = ("cx", "cy", "cz", "ar", "ag", "ab", "rr", "rg", "rb",
                 "er", "eg", "eb", "kr", "kg", "kb", "alpha",
                 "em_f", "mic_f", "die_f")

    @property
    def npix(self) -> int:
        return self.width * self.height

    @property
    def grid(self):
        """The grid's GridConsts, or None without a voxel grid."""
        fc = self.field
        return fc if fc is not None and fc.kind == "grid" else None

    def table(self, device) -> torch.Tensor:
        """The grid's packed table on `device`, copied there once."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._tabs:
            self._tabs[key] = self.grid.tab.to(dev).contiguous()
        return self._tabs[key]

    def field_on(self, device):
        """The field for lanes on `device`: a grid's with its table
        there."""
        if self.grid is None:
            return self.field
        return dataclasses.replace(self.grid, tab=self.table(device))

    @property
    def num_tiles(self) -> int:
        return -(-self.npix // LANES_PER_TILE)

    def attr_table(self, device) -> torch.Tensor:
        """(S+1, len(ATTR_KEYS)) per-sphere attributes; row S (a miss) is
        all zeros. Made on `device` once."""
        key = ("attr", str(torch.device(device)))
        if key not in self._tabs:
            rows = [list(self.c[s]) + list(self.alb[s]) + list(self.rad[s])
                    + list(self.eta[s]) + list(self.kap[s])
                    + [self.alpha[s]]
                    + [1.0 if any(v > 0 for v in self.rad[s]) else 0.0,
                       1.0 if self.mat[s] == MICROFACET else 0.0,
                       1.0 if self.mat[s] == DIELECTRIC else 0.0]
                    for s in range(self.S)]
            rows.append([0.0] * len(self.ATTR_KEYS))
            self._tabs[key] = torch.tensor(rows, dtype=torch.float32,
                                           device=device)
        return self._tabs[key]

    def centre_table(self, device) -> torch.Tensor:
        """(S, 3) sphere centres on `device`, made once."""
        key = ("c", str(torch.device(device)))
        if key not in self._tabs:
            self._tabs[key] = torch.tensor(self.c, dtype=torch.float32,
                                           device=device)
        return self._tabs[key]

    def words(self) -> np.ndarray:
        """The VptParams struct of csrc/path.cuh as 32-bit words (ints and
        f32 bit patterns), in field order."""
        M = MAX_SPHERES
        buf = bytearray()

        def i32(*vals):
            buf.extend(np.asarray(vals, np.int32).tobytes())

        def fl(*vals):
            buf.extend(np.asarray(vals, np.float32).tobytes())

        def pad_i(vals):
            i32(*(list(vals) + [-1] * (M - len(vals))))

        def pad_f(vals, k=1):
            flat = np.zeros((M, k), np.float32)
            flat[:len(vals)] = np.asarray(vals, np.float32).reshape(-1, k)
            fl(*flat.reshape(-1))

        i32(self.width, self.height, self.spp, self.max_bounces,
            self.max_iters, int(self.ld), int(self.jitter), self.S,
            len(self.emitters), len(self.mis_lights), len(self.vol),
            int(self.physical))
        pad_i(self.emitters)
        pad_i(self.mis_lights)
        pad_i(self.mat)
        pad_i(self.vol)
        fl(*self.cam_o, *self.cam_d, *self.cx, *self.cy)
        fl(self.inv_w, self.inv_h, self.q, self.inv_cp, self.sigma_t,
           self.inv_sigma_t, self.tp_med, self.med_c, self.n_em_f,
           self.nee_phase, self.slack, self.ss_cp, self.g, self.hg_1pg2,
           self.hg_2g, self.hg_phase, self.hg_1mg2, self.hg_1mg,
           self.hg_inv2g)
        pad_f(self.r)
        pad_f(self.r2)
        pad_f(self.eps)
        pad_f(self.alpha)
        for tab in (self.c, self.alb, self.rad, self.eta, self.kap):
            pad_f(tab, 3)
        analytic = None if self.grid is not None else self.field
        buf.extend(field_words(analytic, self.inv_maj_rate).tobytes())
        buf.extend(grid_words(self.grid).tobytes())
        return np.frombuffer(bytes(buf), np.int32).copy()


BLOB_KEYS = ("cx", "cy", "cz", "r", "w", "dens_c", "tau_c", "amp_c", "kh",
             "inv_r", "ramp")


def field_words(fc: pr.FieldConsts | None, inv_maj_rate: float) -> np.ndarray:
    """csrc/path.cuh's FieldParams as 32-bit words: kind, n_blobs,
    max_null, then k, y0, majorant, 1/majorant, 1/(sigma_t majorant), then
    MAX_BLOBS rows of BLOB_KEYS (zero-padded). All zeros when homogeneous."""
    ints = np.zeros(3, np.int32)
    fl = np.zeros(5 + MAX_BLOBS * len(BLOB_KEYS), np.float32)
    if fc is not None:
        ints[:] = (FIELD_KINDS[fc.kind], len(fc.blobs), fc.max_null)
        fl[:5] = (float(fc.k), fc.y0, fc.maj, fc.inv_maj, inv_maj_rate)
        for i, b in enumerate(fc.blobs):
            fl[5 + i * len(BLOB_KEYS):5 + (i + 1) * len(BLOB_KEYS)] = [
                float(getattr(b, key)) for key in BLOB_KEYS]
    return np.concatenate([ints, fl.view(np.int32)])


def grid_words(gc) -> np.ndarray:
    """csrc/path.cuh's GridParams as 32-bit words: nx, ny, nz, n_march, M1,
    nearest, then origin, 1/spacing, the low and high rails, the window
    cap, 1/M1 and 1/M2. All zeros without a grid."""
    ints = np.zeros(6, np.int32)
    fl = np.zeros(15, np.float32)
    if gc is not None:
        ints[:] = (*gc.dims, gc.n_march, gc.m1, int(gc.nearest))
        fl[:] = (*gc.org, *gc.inv_sp, *gc.lo, *gc.hi, gc.cap, gc.inv_m1,
                 gc.inv_m2)
    return np.concatenate([ints, fl.view(np.int32)])


def _f32_tuple(a) -> tuple:
    return tuple(float(v) for v in np.asarray(a, np.float32).reshape(-1))


def pack_scene(scene: Scene, camera: Camera, width: int, height: int,
               spp: int, *, continue_prob: float = 0.6,
               max_bounces: int = 32, sampler: str = "random",
               jitter: bool = True, nee: bool = True,
               distance: str = "free", physical: bool = False) -> Packed:
    """Freeze a scene, camera, frame and estimator variant into the launch
    parameters (replaces vpt's ``_scene_consts`` and the python constants
    of ``build_tile_renderer``, which bake them into the kernel source;
    here one build of each kernel instantiation serves every scene)."""
    if sampler not in ("random", "ld"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if distance not in DISTANCES:
        raise ValueError(f"unknown distance sampling {distance!r}")
    S = scene.count
    if S > MAX_SPHERES:
        raise ValueError(f"{S} spheres; the render kernel takes at most "
                         f"{MAX_SPHERES}")
    # vpt's _baked_g: a tiny |g| snaps to exactly 0 (the isotropic build)
    g = float(torch.as_tensor(scene.medium.g))
    g = g if abs(g) > _G_EPS else 0.0

    def f64(t):
        return torch.as_tensor(t).detach().cpu().to(torch.float64).numpy()

    mat = tuple(int(m) for m in scene.material.detach().cpu().numpy())
    r = f64(scene.radius)
    sigma_a = float(f64(scene.medium.sigma_a))
    sigma_s = float(f64(scene.medium.sigma_s))
    # float64 folds, as vpt's build_tile_renderer does them
    sigma_t = sigma_a + sigma_s
    albedo_ratio = sigma_s / sigma_t if sigma_t > 0 else 0.0
    cp = float(continue_prob)
    inv_cp = 1.0 / cp
    n_em = len(scene.emitter_idx)
    cx, cy = screen_basis(camera, width, height)
    fld = scene.medium.density
    field, inv_maj_rate = None, 0.0
    if fld is not None:
        if fld.kind == "blobs" and fld.params.shape[0] > MAX_BLOBS:
            raise ValueError(f"{fld.params.shape[0]} blobs; the kernels take "
                             f"at most {MAX_BLOBS} (VPT_MAX_BLOBS)")
        if fld.kind == "grid":
            field = pr.grid_consts(fld)
        else:
            field = pr.field_consts(fld.kind, f64(fld.params), fld.majorant,
                                    fld.max_null)
            inv_maj_rate = f32(1.0 / (sigma_t * float(fld.majorant)))

    def rows3(t):
        return tuple(_f32_tuple(row) for row in f64(t).reshape(-1, 3))

    return Packed(
        S=S, r=_f32_tuple(r), r2=_f32_tuple(r * r),
        eps=_f32_tuple(pr.EPS_T + 16.0 * F32EPS * r),
        c=rows3(scene.center), alb=rows3(scene.albedo),
        rad=rows3(scene.radiance), eta=rows3(scene.eta),
        kap=rows3(scene.kappa), alpha=_f32_tuple(f64(scene.alpha)),
        mat=mat, emitters=tuple(scene.emitter_idx),
        mis_lights=tuple(scene.mis_light_idx),
        vol=tuple(s for s, m in enumerate(mat) if m == VOLUME_BOUNDARY),
        sigma_a=f32(sigma_a), sigma_s=f32(sigma_s),
        width=int(width), height=int(height), spp=int(spp),
        max_bounces=int(max_bounces),
        max_iters=int(spp) * int(max_bounces) + 64,
        ld=sampler == "ld", jitter=bool(jitter),
        nee=bool(nee), distance=distance, physical=bool(physical),
        cam_o=_f32_tuple(f64(camera.origin)),
        cam_d=_f32_tuple(f64(camera.direction)),
        cx=_f32_tuple(cx), cy=_f32_tuple(cy),
        inv_w=f32(1.0 / width), inv_h=f32(1.0 / height),
        q=f32(1.0 - cp), inv_cp=f32(inv_cp), sigma_t=f32(sigma_t),
        inv_sigma_t=f32(1.0 / sigma_t),
        tp_med=f32(albedo_ratio * inv_cp),
        med_c=f32(float(n_em) * albedo_ratio * inv_cp),
        n_em_f=f32(n_em), nee_phase=f32(INV_4PI * TWO_PI),
        slack=f32(1.0 - 1024.0 * F32EPS),
        ss_cp=f32(sigma_s * inv_cp), g=f32(g), **pr.hg_consts(g),
        field=field, inv_maj_rate=inv_maj_rate,
    )


# ---------------------------------------------------------------------------
# plain version: vpt/kernels/wavefront.py:230-741 on (N,) lanes
# ---------------------------------------------------------------------------

def _const3(vals, like):
    return [torch.full_like(like, v) for v in vals]


def _render_lanes(pk: Packed, seed: torch.Tensor, lane: torch.Tensor,
                  stats: dict | None = None) -> torch.Tensor:
    """Plain torch render of the given lanes (int64 (N,) on seed.device):
    lane i renders pixel min(lane, npix - 1), pixel id = row*W + col, top
    row first, and seeds its streams with the lane id. Returns (N, 3)
    float32 radiance sums. `stats`, if given, gains the work it took: the
    thread-iterations (lanes still short of spp, summed over iterations)
    and the surface-shading and medium-scattering events, and in a density
    field the optical depths ("taus"; in a grid its marches), the densities
    and the delta-tracking null steps ("null_steps") the kernel's threads
    evaluate."""
    dev = seed.device
    fc = pk.field_on(dev)
    grid = pk.grid is not None
    W, H, spp = pk.width, pk.height, pk.spp
    N = lane.shape[0]
    n_em = len(pk.emitters)
    nee, distance = pk.nee, pk.distance
    pixel = torch.clamp_max(lane, pk.npix - 1)
    px = (pixel % W).to(torch.float32)
    py = (H - 1 - pixel // W).to(torch.float32)
    seed_i = seed.to(torch.int64).reshape(())
    if pk.ld:
        A1, A2, A3, A4, A5 = pr.LD_ALPHA
        off_u, off_v, off_w, off_r, off_p = pr.ld_offsets(lane, seed_i)
        strat = pr.ld_strat
    z = torch.zeros(N, dtype=torch.float32, device=dev)
    em_tab = torch.tensor(
        [list(pk.c[e]) + list(pk.rad[e]) + [pk.r[e]] for e in pk.emitters]
        + [[0.0] * 7], dtype=torch.float32, device=dev)
    em_ids = torch.tensor(list(pk.emitters) + [-1], dtype=torch.int64,
                          device=dev)

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
        sx = (px + u - 0.5) * pk.inv_w - 0.5
        sy = (py + v - 0.5) * pk.inv_h - 0.5
        d = [pk.cx[i] * sx + pk.cy[i] * sy + pk.cam_d[i] for i in range(3)]
        return pr.normalize3(d)

    def light_attrs(u_pick):
        """Uniform emitter pick; per-lane light constants by index."""
        k = torch.clamp((u_pick * float(n_em)).to(torch.int64), 0, n_em - 1)
        k = torch.where(k >= 0, k, n_em)     # no emitters: the zero row
        row = em_tab[k]
        return ([row[:, 0], row[:, 1], row[:, 2]],
                [row[:, 3], row[:, 4], row[:, 5]], row[:, 6], em_ids[k])

    def plight_term(at, xs, n, d, lc, lrad):
        le_scale, dist, dl = pr.plight_le_scale(pk, lc, xs)
        le = [lrad[i] * le_scale for i in range(3)]
        wi = [-dl[0], -dl[1], -dl[2]]
        fr = pr.eval_fr_nee_plight(at, n, d, wi)
        cosw = pr.dot3(n, wi)
        return [le[i] * fr[i] * cosw for i in range(3)], dist

    def mis_v2(rng, at, xs, n, d):
        """MISv2 (misSamplingFunctions.h:96-170) over the spherical
        emitters."""
        acc = [torch.zeros_like(z) for _ in range(3)]
        wo = [-d[0], -d[1], -d[2]]
        for e in pk.mis_lights:
            ec = pk.c[e]; er = pk.r[e]; erad = pk.rad[e]
            cxv = [ec[i] - xs[i] for i in range(3)]
            normcx = pr.norm3(cxv)
            inv_ncx = 1.0 / normcx
            wc = pr.scale3(cxv, inv_ncx)
            ratio = er * inv_ncx
            cos_max = torch.sqrt(torch.clamp_min(1.0 - ratio * ratio, 1e-12))
            u1 = rng()
            u2 = rng()
            wi = pr.cone_dir(wc, cos_max, u1, u2)
            hit, _, sid = pr.nearest_id_t(pk, xs, wi)
            visible = hit & (sid == e)
            fr = pr.eval_fr_nee(at, n, d, wi)
            fpdf_inv = TWO_PI * torch.clamp_min(1.0 - cos_max, 1e-12)
            if fc is None:
                tr = torch.exp(-pk.sigma_t * normcx)
            else:
                tr = pr.field_tr_toward(fc, pk.sigma_t, xs, wc, normcx)
            w_vis = torch.where(visible, tr * pr.dot3(n, wi) * fpdf_inv, 0.0)
            gpdf = pr.bsdf_pdf_for_dir(at, n, wo, wi, rng())
            wf = pr.power_h_invf(fpdf_inv, gpdf)
            for i in range(3):
                acc[i] = acc[i] + erad[i] * fr[i] * w_vis * wf
        # BSDF strategy: sample all lobes, one trace
        u1, u2, u_choice = rng(), rng(), rng()
        wi_l = pr.cosine_hemi(n, u1, u2)
        wt, _ = pr.refract_quirk(wo, n)
        fres = pr.fresnel_die(pr.dot3(n, wt), pr.dot3(n, wo))
        refl = u_choice < fres
        ndotwo = pr.dot3(n, wo)
        wr = pr.normalize3([2.0 * ndotwo * n[i] - wo[i] for i in range(3)])
        wi_d = pr.sel3(refl, wr, wt)
        wh_loc = pr.beckmann_wh(at["alpha"], u1, u2)
        wo_loc = pr.to_local(n, wo)
        whw = 2.0 * pr.dot3(wh_loc, wo_loc)
        wi_m_loc = pr.normalize3([whw * wh_loc[i] - wo_loc[i]
                                  for i in range(3)])
        wi_m = pr.normalize3(pr.from_local(n, wi_m_loc))
        wi_sel = pr.sel3(at["is_mic"], wi_m,
                         pr.sel3(at["is_die"], wi_d, wi_l))
        hit, _, sid = pr.nearest_id_t(pk, xs, wi_sel)
        hat = pr.attrs(pk, sid)
        le = [hat["rr"], hat["rg"], hat["rb"]]
        hit_r = torch.tensor(list(pk.r) + [0.0], dtype=torch.float32,
                             device=dev)[torch.where(sid >= 0, sid, pk.S)]
        hc = [hat["cx"], hat["cy"], hat["cz"]]
        cos_l = pr.dot3(n, wi_l)
        gpdf_l = cos_l * pr.INV_PI
        g_l = [torch.where(gpdf_l != 0.0,
                           le[i] * (at["ar"], at["ag"], at["ab"])[i], 0.0)
               for i in range(3)]
        cos_d = torch.abs(pr.dot3(n, wi_d))
        scale_d = torch.where(refl, 1.0, pr.GLASS_ETA_T * pr.GLASS_ETA_T) \
            / torch.clamp_min(cos_d, 1e-12)
        g_d = [le[i] * scale_d for i in range(3)]
        gpdf_d = torch.where(refl, fres, 1.0 - fres)
        fr_m = pr.fr_microfacet(at, wi_m_loc, wh_loc, wo_loc)
        gpdf_m = pr.ndf_beckmann(wh_loc[2], at["alpha"]) * wh_loc[2] / (
            4.0 * torch.clamp_min(torch.abs(pr.dot3(wo_loc, wh_loc)), 1e-12))
        winv_m = wi_m_loc[2] / torch.clamp_min(gpdf_m, 1e-20)
        g_m = [le[i] * fr_m[i] * winv_m for i in range(3)]
        g = pr.sel3(at["is_mic"], g_m, pr.sel3(at["is_die"], g_d, g_l))
        gpdf = torch.where(at["is_mic"], gpdf_m,
                           torch.where(at["is_die"], gpdf_d, gpdf_l))
        pos_all = (g[0] > 0.0) & (g[1] > 0.0) & (g[2] > 0.0)
        gate = (at["is_mic"] & (g[0] > 0.0)) | (~at["is_mic"] & pos_all)
        hcx = [hc[i] - xs[i] for i in range(3)]
        n2 = torch.clamp_min(pr.dot3(hcx, hcx), 1e-20)
        cmax = torch.sqrt(torch.clamp_min(1.0 - hit_r * hit_r / n2, 1e-12))
        fpdf_h_inv = TWO_PI * torch.clamp_min(1.0 - cmax, 1e-12)
        wg = torch.where(gate & hit, pr.power_h_invg(gpdf, fpdf_h_inv), 0.0)
        for i in range(3):
            acc[i] = acc[i] + g[i] * wg
        return acc

    def medium_nee(rng, d, xt, lc, lrad, lr, lid):
        """freeSingleScattering (volumetricBasicFunctions.h:284-340) with
        the missing-else point kill: point sources contribute 0. d is the
        incoming propagation direction (the HG phase value needs it)."""
        wc = [lc[i] - xt[i] for i in range(3)]
        inv_mag = torch.rsqrt(torch.clamp_min(pr.dot3(wc, wc), 1e-20))
        wc_n = pr.scale3(wc, inv_mag)
        ratio = lr * inv_mag
        cos_max = torch.sqrt(torch.clamp_min(1.0 - ratio * ratio, 1e-12))
        u1 = rng()
        u2 = rng()
        wl = pr.cone_dir(wc_n, cos_max, u1, u2)
        hit, t, sid = pr.nearest_id_t(pk, xt, wl)
        visible = hit & (sid == lid) & (lr > 0.0)
        # phase / cone pdf = phase * 2pi * (1 - cos_max)
        if pk.g != 0.0:
            phase_2pi = pr.hg_phase_const(pk, pr.dot3(d, wl)) * TWO_PI
        else:
            phase_2pi = pk.nee_phase
        if grid:
            # vpt leaves the grid's transmittance out of the weight and
            # multiplies the radiance by it after (its merged NEE march)
            w = torch.where(visible,
                            phase_2pi * torch.clamp_min(1.0 - cos_max, 1e-12),
                            0.0)
            tr_l = pr.field_tr_toward(fc, pk.sigma_t, xt, wl, t)
            return [lrad[i] * w * tr_l for i in range(3)]
        if fc is None:
            tr_l = torch.exp(-pk.sigma_t * t)
        else:
            tr_l = pr.field_tr_toward(fc, pk.sigma_t, xt, wl, t)
        w = torch.where(visible,
                        tr_l * phase_2pi
                        * torch.clamp_min(1.0 - cos_max, 1e-12), 0.0)
        return [lrad[i] * w for i in range(3)]

    def bounce(rng, o, d, tp, L, alive, depth, samples):
        u_rr = rng()
        u_pick = rng()
        if pk.ld:
            s_f = samples.to(torch.float32)
            d0 = depth == 0
            u_rr = torch.where(d0, strat(A4, off_r, s_f), u_rr)
            u_pick = torch.where(d0, strat(A5, off_p, s_f), u_pick)
        alive = alive & (u_rr >= pk.q)
        hit, t, at = pr.nearest(pk, o, d)
        t_eff = torch.where(hit, t, BIG)
        xs = [o[i] + t_eff * d[i] for i in range(3)]
        nrm = pr.normalize3([xs[0] - at["cx"], xs[1] - at["cy"],
                             xs[2] - at["cz"]])
        lc, lrad, lr, lid = light_attrs(u_pick)
        act = samples < spp         # the kernel's threads still looping

        u_dist = rng()
        if pk.ld:
            u_dist = torch.where(
                depth == 0, strat(A3, off_w, samples.to(torch.float32)),
                u_dist)
        if fc is None:
            tr_actual = torch.where(hit, torch.exp(-pk.sigma_t * t), 0.0)
        elif distance == "free":
            if not grid:    # a grid's comes from its free-flight march
                tr_actual = torch.where(hit, torch.exp(
                    -pr.field_tau(fc, pk.sigma_t, o, d, t_eff)), 0.0)
        else:
            t_det = torch.where(hit, t, 0.0)
            tr_actual = torch.where(hit, torch.exp(
                -pr.field_tau(fc, pk.sigma_t, o, d, t_det, nonneg=True)), 0.0)
            if stats is not None:
                counts[3] += (hit & act).sum()
        if distance == "free":
            if fc is None:
                d_s = -torch.log1p(-u_dist) * pk.inv_sigma_t
            elif grid:
                # one march of the transport model: the inverted distance
                # and the surface's optical depth
                d_s, tau_cap = pr.grid_sample_free_and_tau(
                    fc, pk.sigma_t, o, d, u_dist, t_eff)
                tr_actual = torch.where(hit, torch.exp(-tau_cap), 0.0)
                if stats is not None:
                    counts[3] += act.sum()
            else:
                # analytic inversion (exp_height) or delta tracking (blobs)
                d_s = pr.field_sample_free(
                    fc, pk.sigma_t, pk.inv_maj_rate, o, d, u_dist, rng,
                    t_eff, active=act,
                    work=counts[5:6] if stats is not None else None)
            surface = (d_s > t_eff) & hit
            if fc is not None:
                # an escaped flight (d_s == BIG off any surface) kills the
                # lane instead of scattering at a far point
                alive = alive & ((d_s < 0.5 * BIG) | surface)
            xt = [o[i] + d_s * d[i] for i in range(3)]
        else:
            # equi-angular (equiAngularParams2 + sample/pdf,
            # volumetricBasicFunctions.h:209-223) or its clamped form
            # (equiAngularParams, :180-207): foot point clamped into
            # [o, xs], D measured from it to the light centre
            lo = [lc[i] - o[i] for i in range(3)]
            if distance == "equiangular":
                delta = pr.dot3(lo, d)
                D = torch.sqrt(torch.clamp_min(
                    pr.dot3(lo, lo) - delta * delta, 1e-12))
            else:
                delta = torch.minimum(torch.clamp_min(pr.dot3(lo, d), 0.0),
                                      t_eff)
                x0 = [o[i] + delta * d[i] for i in range(3)]
                x0c = [x0[i] - lc[i] for i in range(3)]
                D = torch.sqrt(torch.clamp_min(pr.dot3(x0c, x0c), 1e-12))
            th_a = pr.atan2_posx(-delta, D)
            th_b = pr.atan2_posx(t_eff - delta, D)
            # clipped: f32 tan reaches inf where cos == 0
            sample_t = torch.clamp(
                D * pr.tan_sc((1.0 - u_dist) * th_a + u_dist * th_b),
                -BIG, BIG)
            if distance == "equiangular":
                d_along = sample_t + delta
                xt = [o[i] + d_along * d[i] for i in range(3)]
            else:
                d_along = delta + sample_t
                xt = [x0[i] + sample_t * d[i] for i in range(3)]
            dist_pdf = D / (torch.clamp_min(torch.abs(th_b - th_a), 1e-12)
                            * (sample_t * sample_t + D * D))
            if fc is None:
                t_xt = torch.exp(-pk.sigma_t * torch.abs(d_along))
            else:
                # the field's optical depth is odd in t: |tau| is the
                # segment's depth when the sample lies behind the origin
                t_xt = torch.exp(-torch.abs(
                    pr.field_tau(fc, pk.sigma_t, o, d, d_along)))
            u_ev = rng()
            surface = (u_ev <= tr_actual) & hit
            # pSuccess = pdf * (1 - Tr), floored twice: the product can
            # underflow f32 where the medium is thin along the ray
            pdf_success = torch.clamp_min(
                dist_pdf * torch.clamp_min(1.0 - tr_actual, 1e-20), 1e-30)

        em_hit = surface & at["is_em"]
        credit = alive & em_hit
        if nee:
            credit = credit & (depth == 0)
        rad = [at["rr"], at["rg"], at["rb"]]
        for i in range(3):
            add = rad[i] * tp[i]
            if pk.physical:     # compensate the iteration's own RR survival
                add = add * pk.inv_cp
            L[i] = L[i] + torch.where(credit, add, 0.0)
        shade = alive & surface & ~em_hit

        if nee:
            ldp, dist_l = plight_term(at, xs, nrm, d, lc, lrad)
            if fc is None:
                trs = torch.exp(-pk.sigma_t * dist_l)
            else:
                inv_dl = 1.0 / torch.clamp_min(dist_l, 1e-20)
                wlight = [(lc[i] - xs[i]) * inv_dl for i in range(3)]
                trs = pr.field_tr_toward(fc, pk.sigma_t, xs, wlight, dist_l)
            ldm = mis_v2(rng, at, xs, nrm, d)
            for i in range(3):
                ld = ldp[i] * (trs * pk.n_em_f) + ldm[i]
                L[i] = L[i] + torch.where(shade, ld * tp[i] * pk.inv_cp, 0.0)

        fs, wi_s, pdf_b = pr.sample_bsdf(rng, at, d, nrm)
        cosine = pr.dot3(nrm, wi_s)
        wscale = cosine * pk.inv_cp / torch.clamp_min(pdf_b, 1e-20)
        tp_surface = [tp[i] * fs[i] * wscale for i in range(3)]

        medium = alive & ~surface
        u_p1 = rng()
        u_p2 = rng()
        if pk.g != 0.0:     # HG importance sampling: phase/pdf == 1
            wi_m = pr.hg_dir(pk, d, u_p1, u_p2)
        else:
            wi_m = pr.uniform_sphere(u_p1, u_p2)
        if distance == "free":
            if nee:
                # explicit free flight: transmittance/pdf cancel
                # analytically (the PBRT simplification,
                # vptShadeMethods.h:1248)
                ld_med = medium_nee(rng, d, xt, lc, lrad, lr, lid)
                for i in range(3):
                    L[i] = L[i] + torch.where(
                        medium, ld_med[i] * tp[i] * pk.med_c, 0.0)
                w_med = pk.tp_med
            elif pk.physical:
                # textbook weight: sigma_s * T / ffProb = sigma_s / sigma_t
                w_med = pk.tp_med
            else:
                # implicit free: (sigma_s/sigma_t) / (cp (1 - Tr))
                # (vptShadeMethods.h:977,1006)
                w_med = torch.full_like(tr_actual, pk.tp_med) / \
                    torch.clamp_min(1.0 - tr_actual, 1e-20)
        else:
            # equi-angular: T and pdf appear explicitly
            # (vptShadeMethods.h:1134-1146)
            inv_pdf_s = 1.0 / pdf_success
            w_med = pk.ss_cp * t_xt * inv_pdf_s
            if fc is not None:
                # sigma_s(xt) = sigma_s dens(xt)
                w_med = w_med * pr.field_density(fc, xt)
            if nee:
                ld_med = medium_nee(rng, d, xt, lc, lrad, lr, lid)
                scale = w_med * pk.n_em_f
                for i in range(3):
                    L[i] = L[i] + torch.where(
                        medium, ld_med[i] * scale * tp[i], 0.0)
        tp_medium = [tp[i] * w_med for i in range(3)]

        if stats is not None:
            counts[1] += shade.sum()
            counts[2] += medium.sum()
            if fc is not None:
                # the kernel's other field evaluations: pLight and one per
                # MIS light on shading lanes, medium NEE, the implicit
                # (1 - Tr) and the equi-angular T on medium lanes
                n_sh = shade.sum() * (1 + len(pk.mis_lights)) if nee else 0
                n_md = medium.sum() * (
                    int(nee) + int(distance != "free")
                    + int(distance == "free" and not nee
                          and not pk.physical and not grid))
                counts[3] += n_sh + n_md
                if distance != "free":
                    counts[4] += medium.sum()
        o = pr.sel3(shade, xs, pr.sel3(medium, xt, o))
        d = pr.sel3(shade, wi_s, pr.sel3(medium, wi_m, d))
        tp = pr.sel3(shade, tp_surface, pr.sel3(medium, tp_medium, tp))
        alive2 = (shade | medium) & (depth + 1 < pk.max_bounces)
        depth = torch.where(alive2, depth + 1, depth)
        return o, d, tp, L, alive2, depth

    rng = pr.Pcg(pr.pcg_seed(lane, seed_i))
    o = [z, z, z]
    d = [z, z, z + 1.0]
    tp = [z, z, z]
    L = [z, z, z]
    alive = torch.zeros(N, dtype=torch.bool, device=dev)
    depth = torch.zeros(N, dtype=torch.int64, device=dev)
    samples = torch.zeros(N, dtype=torch.int64, device=dev)
    cam_o = _const3(pk.cam_o, z)
    one = torch.ones_like(z)
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    it = 0
    while it < pk.max_iters and bool((samples < spp).any()):
        need = ~alive & (samples < spp)
        if stats is not None:
            counts[0] += (samples < spp).sum()
        nd = camera_ray(rng, samples)
        o = pr.sel3(need, cam_o, o)
        d = pr.sel3(need, nd, d)
        tp = pr.sel3(need, [one, one, one], tp)
        alive = alive | need
        depth = torch.where(need, 0, depth)
        was_alive = alive
        o, d, tp, L, alive, depth = bounce(rng, o, d, tp, L, alive, depth,
                                           samples)
        samples = samples + (was_alive & ~alive).to(torch.int64)
        it += 1
    if stats is not None:
        keys = ("thread_iters", "shade", "medium", "taus", "densities",
                "null_steps")
        for k, v in zip(keys, counts.tolist()):
            stats[k] = stats.get(k, 0) + v
    return torch.stack(L, dim=-1)


def render_raw_plain(pk: Packed, seed: torch.Tensor, bases=None,
                     stats: dict | None = None) -> torch.Tensor:
    """Plain twin of render_raw: (n_tiles * LANES_PER_TILE, 3) per-lane
    radiance sums."""
    if bases is None:
        lane = torch.arange(pk.num_tiles * LANES_PER_TILE, dtype=torch.int64,
                            device=seed.device)
    else:
        off = torch.arange(LANES_PER_TILE, dtype=torch.int64,
                           device=seed.device)
        lane = (bases.to(torch.int64).reshape(-1, 1) + off).reshape(-1)
    return _render_lanes(pk, seed, lane, stats)


def render_tile_plain(pk: Packed, seed: torch.Tensor,
                      stats: dict | None = None) -> torch.Tensor:
    """Plain torch render of the whole frame on seed.device. seed: int32
    (1,). Returns (npix, 3) float32 radiance / spp (see _render_lanes for
    `stats`)."""
    lane = torch.arange(pk.npix, dtype=torch.int64, device=seed.device)
    sums = _render_lanes(pk, seed, lane, stats)
    # a device tensor: CUDA divides by a host scalar through its reciprocal
    return sums / torch.tensor(float(pk.spp), device=seed.device)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_seed(seed: torch.Tensor) -> None:
    if seed.dtype != torch.int32 or tuple(seed.shape) != (1,) \
            or not seed.is_contiguous():
        raise ValueError("seed must be a contiguous int32 tensor of shape (1,)")
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no render kernel for device {seed.device}")


def _launch(pk: Packed, seed: torch.Tensor, bases, n_lanes: int,
            sums: bool, tag: str = "_scatter") -> torch.Tensor:
    """One launch of the kernel instantiation for (pk.nee, pk.distance),
    in a density field its field instantiation, in a voxel grid its grid
    one, on seed.device's current stream, without synchronising. A launch
    from tile bases counts under its entry + tag."""
    entries = (KERNEL_ENTRIES if pk.field is None else
               GRID_ENTRIES if pk.grid is not None else FIELD_ENTRIES)
    entry = entries.get((pk.nee, pk.distance))
    if entry is None:
        raise NotImplementedError(
            f"no render kernel is built for nee={pk.nee}, distance="
            f"{pk.distance!r}: the kernel has {sorted(KERNEL_ENTRIES)}, the "
            "pairs of vpt's fused-kernel integrators")
    from . import _build

    lib = _build.load()
    words = np.ascontiguousarray(pk.words())
    if words.size != lib.vpt_params_words():
        raise RuntimeError(
            f"VptParams layout mismatch: python packs {words.size} words, "
            f"the kernel expects {lib.vpt_params_words()}")
    out = torch.empty((n_lanes, 3), dtype=torch.float32, device=seed.device)
    tab = () if pk.grid is None else (pk.table(seed.device).data_ptr(),)
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        err = getattr(lib, entry)(
            words.ctypes.data, seed.data_ptr(),
            None if bases is None else bases.data_ptr(), int(n_lanes),
            int(sums), out.data_ptr(), *tab, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{_build.error_string(err)} ({err})")
    key = entry if bases is None else entry + tag
    LAUNCHES_BY[key] = LAUNCHES_BY.get(key, 0) + 1
    return out


def render_tile(pk: Packed, seed: torch.Tensor) -> torch.Tensor:
    """Render the frame on seed.device. seed: int32 (1,) contiguous.

    On a CUDA tensor this launches the kernel instantiation for the
    packed variant on the current stream, without synchronising; on a CPU
    tensor it runs render_tile_plain. Returns (npix, 3) float32
    radiance / spp."""
    _check_seed(seed)
    if seed.device.type == "cpu":
        return render_tile_plain(pk, seed)
    return _launch(pk, seed, None, pk.npix, False)


def render_raw(pk: Packed, seed: torch.Tensor, bases=None) -> torch.Tensor:
    """Per-lane radiance SUMS, (n_tiles * LANES_PER_TILE, 3), one launch.

    bases None: all the frame's tiles, contiguous from lane 0 (vpt's
    make_raw over num_tiles). bases, a contiguous int32 (n_tiles,) tensor
    on seed.device: tile i is the LANES_PER_TILE lanes from bases[i]
    (vpt's make_raw_scatter). Lanes past npix render a clamped duplicate of
    the last pixel with their own streams; callers discard them. On a CPU
    tensor this runs render_raw_plain."""
    _check_seed(seed)
    if bases is not None:
        if bases.dtype != torch.int32 or bases.dim() != 1 \
                or not bases.is_contiguous() or bases.device != seed.device:
            raise ValueError("bases must be a contiguous int32 (n_tiles,) "
                             "tensor on the seed's device")
        n = bases.shape[0]
    else:
        n = pk.num_tiles
    if seed.device.type == "cpu":
        return render_raw_plain(pk, seed, bases)
    return _launch(pk, seed, bases, n * LANES_PER_TILE, True)


def make_raw(pk: Packed, n_tiles: int):
    """vpt's contiguous make_raw: raw(seed, base) -> (n_tiles *
    LANES_PER_TILE, 3) per-lane radiance SUMS of the lanes base .. base +
    n_tiles * LANES_PER_TILE - 1, one launch (render_raw's, from the tile
    bases base + i * LANES_PER_TILE; counted under the entry + "_raw").
    Lanes past npix render a clamped duplicate of the last pixel with
    their own streams; the caller discards them. A CPU seed runs
    render_raw_plain."""
    def raw(seed: torch.Tensor, base: int) -> torch.Tensor:
        _check_seed(seed)
        bases = int(base) + LANES_PER_TILE * torch.arange(
            n_tiles, dtype=torch.int32, device=seed.device)
        if seed.device.type == "cpu":
            return render_raw_plain(pk, seed, bases)
        return _launch(pk, seed, bases, n_tiles * LANES_PER_TILE, True,
                       "_raw")

    return raw


def pack_config(scene: Scene, camera: Camera, cfg, spp: int | None = None
                ) -> Packed:
    """pack_scene for a RenderConfig (spp overrides cfg.spp); vpt's engine
    integrators raise."""
    if cfg.integrator not in KERNEL_INTEGRATORS:
        raise NotImplementedError(
            f"integrator {cfg.integrator!r} is one of vpt's XLA engine "
            f"integrators (the render kernel has {sorted(KERNEL_INTEGRATORS)}"
            "), not ported yet (ROADMAP Queue 1 item 9)")
    nee, distance, physical = KERNEL_INTEGRATORS[cfg.integrator]
    return pack_scene(scene, camera, cfg.width, cfg.height,
                      cfg.spp if spp is None else spp,
                      continue_prob=cfg.continue_prob,
                      max_bounces=cfg.max_bounces, sampler=cfg.sampler,
                      jitter=cfg.jitter, nee=nee, distance=distance,
                      physical=physical)


def render_kernel(scene: Scene, camera: Camera, cfg,
                  device="cuda") -> torch.Tensor:
    """Render with the forward kernel (≙ vpt's render_pallas); returns
    (H, W, 3) on `device`."""
    pk = pack_config(scene, camera, cfg)
    seed_t = torch.tensor([cfg.seed], dtype=torch.int32, device=device)
    return render_tile(pk, seed_t).reshape(cfg.height, cfg.width, 3)
