"""Differentiable render pair: forward kernel K2, single-replay backward K3.

Counterpart of ``vpt/kernels/diff.py``. vpt builds both passes from one
Pallas kernel body (``make_kernel(grads=False|True)``) behind a custom VJP;
here the same estimator runs as

  - ``diff_fwd`` / ``diff_bwd``: the hand-written CUDA kernels
    (csrc/diff.cu over the per-path code in csrc/diff_path.cuh), one thread
    per pixel, launched on CUDA tensors; on CPU tensors they run the plain
    versions;
  - ``diff_fwd_plain`` / ``diff_bwd_plain``: one line-by-line torch
    counterpart of vpt's body on (N,) lanes in lockstep, with a `grads`
    flag as vpt's body has;
  - ``_DiffRender``: the torch.autograd.Function that binds them, and
    ``make_diff_renderer``, which returns render(params, seed) -> (npix, 3).

Differentiable parameters (vpt's pack_params): sigma_a, sigma_s, albedo
(S, 3) and radiance (S, 3), flattened to P = 2 + 6S entries, then the HG
anisotropy "g" (diff_g) at IG = 2 + 6S and the traced field parameters
from IK = IG (+ 1 with diff_g). The gradient
estimator is vpt's: sampled distances and events are detached, albedo and
radiance are pathwise (exact per seed), and the sigma dependence of the
free-flight sampling density enters through score-function terms. The
backward replays the forward's paths from the same PCG streams: emission
terms are immediate, log-throughput and score terms accumulate as deferred
(A, B) pairs folded in at path death (vpt/kernels/diff.py docstring).

Arithmetic follows vpt's diff body, not its forward kernel: sigma_t,
1/sigma_t and (sigma_s/sigma_t)/cp are f32 operations on the parameter
vector, the camera divides by the frame size, and the NEE sums associate as
diff.py writes them. The draw order is K1's (kernels/wavefront.py).

Density fields (vpt's diff_field / diff_blobs, diff.py:306-345): in an
analytic field (exp_height or blobs) every transmittance is the field's,
the free flight inverts or delta-tracks it with K1's draws, and the sigma
scores take the optical paths per unit sigma (field_tau(fc, 1.0, ...)).
diff_field traces the exp_height falloff "fog_k" and diff_blobs the blob
rows "blobs" (K, 5): n_fp = 1 or 5K slots after the 2 + 6S, each with a
pathwise term (the transmittances' d/dtheta through fp_dI) and a deferred
event-score pair (fp_dI and fp_dlogdens at the sampled distance). The
field runs in the kernels' field instantiations (csrc/diff_field_fwd.cu,
diff_field_bwd.cu).

The Henyey-Greenstein phase (vpt's baked g_hg and diff_g, diff.py:560-583,
:931-941): medium NEE takes the phase toward the cone sample and the
scatter draw samples HG with the same u_p1, u_p2. At the scene's baked g
the constants are K1's, folded in float64; with diff_g the phase and the
draw are f32 operations on the vector's g with a true division by 2g and
the isotropic snap at |g| <= 1e-3 (prims.hg_phase_traced, hg_dir_traced),
and dL/dg is the NEE value's pathwise term gx * dlog_hg_dg(cos_nee, g)
plus the phase draw's score as a deferred (A_g, B_g) pair folded like the
sigma scores. Both run in the kernels' HG instantiations (csrc/diff_hg.cu,
diff_field_hg_fwd.cu, diff_field_hg_bwd.cu; the mode is a launch
parameter).

Arithmetic of the field: where no field parameter is traced, the field's
constants are K1's, folded in float64 on the host; where one is, vpt's
expressions are f32 operations on the parameter vector (1/r, (1/r)^2,
1/(r r), r sqrt(pi/2), r sqrt(pi/2) w, (1/r) sqrt(1/2), and 1/(sigma_t
majorant) always, sigma_t being traced). So the pair matches K1 within
vpt's 1e-5 of scale, not bit for bit.

Voxel grids (vpt's grid_mode and diff_grid, diff.py:205-219, 600-617,
656-662, 761-784, 880-884, 990-1008, 1115-1126): the free flight is K1's
march of the grid's transport model (prims.grid_sample_free_and_tau), and
the sigma scores take its optical paths, tau(t)/sigma_t at the surface and
-log1p(-u)/sigma_t at the sampled distance. The table is baked from the
scene, or with diff_grid rebuilt from the "grid" leaf (prims.grid_table,
elementwise torch on the leaf's device) at every call. With diff_grid K3
replays each sample twice from the same PCG state (vpt's two-phase
replay): phase A, with the cotangent zeroed, learns the sample's weighted
total wLtot; phase B replays it, adds every gradient term and scatters the
voxel terms: the free-flight event scores against wLtot, and the pathwise
terms of the pLight, medium-NEE and MIS light-strategy transmittances. The
iteration cap doubles. The grid runs in csrc/diff_grid_fwd.cu and
diff_grid_bwd.cu; the voxel gradient comes back in the grid's shape.

Scope: nee=True, distance="free", physical=False, no material-3 shell,
samplers "random" and "ld", no HG phase in a grid. Everything else raises
NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..scene.camera import Camera
from ..scene.scene import LAMBERT, MICROFACET, Scene
from . import prims as pr
from .prims import BIG, INV_PI, TWO_PI, f32
from .wavefront import Packed, pack_scene

__all__ = ["pack_params", "unpack_params", "DiffPacked", "pack_diff",
           "diff_fwd_plain", "diff_bwd_plain", "diff_fwd", "diff_bwd",
           "make_diff_renderer", "LAUNCHES_FWD", "LAUNCHES_BWD",
           "LAUNCHES_BY"]

# kernel launches in this process: diff_fwd / diff_bwd add one per launch
# under the C entry they launch (the field instantiations' entries end in
# "_field"). LAUNCHES_FWD and LAUNCHES_BWD read the totals of the K2 and
# K3 entries; callers reset all of them by clearing LAUNCHES_BY.
LAUNCHES_BY: dict = {}


def __getattr__(name: str):
    prefix = {"LAUNCHES_FWD": "vpt_diff_fwd",
              "LAUNCHES_BWD": "vpt_diff_bwd"}.get(name)
    if prefix is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return sum(n for k, n in LAUNCHES_BY.items() if k.startswith(prefix))

# DiffParams.fp_kind: the traced field parameters
FP_NONE, FP_FOG_K, FP_BLOBS = 0, 1, 2
# DiffParams.hg_mode: the phase (csrc/diff_path.cuh HgMode)
HG_NONE, HG_BAKED, HG_TRACED = 0, 1, 2

def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} in the differentiable pair is ROADMAP Queue 1 item {item}")


def pack_params(scene: Scene, with_g: bool = False, with_field: bool = False,
                with_grid: bool = False, with_blobs: bool = False) -> dict:
    """Differentiable parameters of a scene: a dict of float32 tensors
    sigma_a (), sigma_s (), albedo (S, 3), radiance (S, 3); with_g adds the
    HG anisotropy "g" (), with_field the exp_height falloff "fog_k" (),
    with_blobs the blob rows "blobs" (K, 5), with_grid the voxel values
    "grid" (nx, ny, nz) (pair them with diff_g, diff_field / diff_blobs,
    diff_grid). The voxel values ride beside the packed vector, as vpt's
    ride in their own table."""
    def t(x):
        return torch.as_tensor(x).detach().to(torch.float32).clone()

    p = {"sigma_a": t(scene.medium.sigma_a),
         "sigma_s": t(scene.medium.sigma_s),
         "albedo": t(scene.albedo), "radiance": t(scene.radiance)}
    if with_g:
        p["g"] = t(scene.medium.g)
    fld = scene.medium.density
    if with_field:
        if fld is None or fld.kind != "exp_height":
            raise ValueError("with_field=True needs an exp_height "
                             "Medium.density")
        p["fog_k"] = t(fld.params[0])
    if with_blobs:
        if fld is None or fld.kind != "blobs":
            raise ValueError("with_blobs=True needs a blobs Medium.density")
        p["blobs"] = t(fld.params)
    if with_grid:
        if fld is None or fld.kind != "grid":
            raise ValueError("with_grid=True needs a voxel-grid "
                             "Medium.density")
        p["grid"] = t(fld.params)
    return p


def _flatten(params: dict, S: int) -> torch.Tensor:
    """params -> packed (2 + 6S [+ 1 g] [+ 1 | + 5K],) vector,
    differentiable (torch.cat): vpt's order, g at 2 + 6S, then the field
    slots. A "grid" leaf is not in the vector."""
    extra = sorted(set(params) - {"sigma_a", "sigma_s", "albedo", "radiance",
                                  "g", "fog_k", "blobs", "grid"})
    if extra:
        raise ValueError(f"unknown parameters {extra}")
    parts = [params["sigma_a"].reshape(1), params["sigma_s"].reshape(1),
             params["albedo"].reshape(3 * S), params["radiance"].reshape(3 * S)]
    if "g" in params:
        parts.append(params["g"].reshape(1))
    if "fog_k" in params:
        parts.append(params["fog_k"].reshape(1))
    if "blobs" in params:
        parts.append(params["blobs"].reshape(-1))
    return torch.cat(parts).to(torch.float32)


def unpack_params(vec: torch.Tensor, S: int, *, with_g: bool = False,
                  with_field: bool = False, n_blobs: int = 0) -> dict:
    """Packed vector -> params dict (views of vec); with_g reads the "g"
    slot at 2 + 6S, with_field the "fog_k" slot after it, n_blobs > 0 a
    trailing (n_blobs, 5) "blobs" block."""
    n = 2 + 6 * S + int(with_g) + int(with_field) + 5 * n_blobs
    if vec.shape[0] != n:
        raise ValueError(f"a packed vector of {vec.shape[0]} entries; "
                         f"{S} spheres, with_g={with_g}, with_field="
                         f"{with_field} and n_blobs={n_blobs} pack {n}")
    p = {"sigma_a": vec[0], "sigma_s": vec[1],
         "albedo": vec[2:2 + 3 * S].reshape(S, 3),
         "radiance": vec[2 + 3 * S:2 + 6 * S].reshape(S, 3)}
    idx = 2 + 6 * S
    if with_g:
        p["g"] = vec[idx]
        idx += 1
    if with_field:
        p["fog_k"] = vec[idx]
        idx += 1
    if n_blobs:
        p["blobs"] = vec[idx:idx + 5 * n_blobs].reshape(n_blobs, 5)
    return p


@dataclasses.dataclass(frozen=True)
class DiffPacked:
    """What one K2/K3 launch reads besides the parameter vector: the
    render kernel's Packed scene, camera and estimator constants, plus the
    pair's own. `words()` lays them out as csrc/diff_path.cuh's
    DiffParams."""

    pk: Packed
    cp: float           # continue_prob as f32: (sigma_s/sigma_t) / cp
    inv_spp: float      # f32(1/spp), the cotangent's scale
    alb_ids: tuple      # spheres with an albedo gradient
    lam_ids: tuple      # spheres with deferred lambert-albedo terms
    fp_kind: int = FP_NONE  # traced field parameters: none, fog_k, blobs
    hg_mode: int = HG_NONE  # the phase: isotropic, the baked g, diff_g
    diff_grid: bool = False  # K3 also returns the voxel gradient

    @property
    def IG(self) -> int:
        """The packed index of the traced g (diff_g)."""
        return 2 + 6 * self.pk.S

    @property
    def IK(self) -> int:
        """The packed index of the first traced field parameter."""
        return self.IG + int(self.hg_mode == HG_TRACED)

    @property
    def n_fp(self) -> int:
        """Traced field-parameter slots: 1 (fog_k), 5K (blobs) or 0."""
        if self.fp_kind == FP_FOG_K:
            return 1
        return 5 * len(self.pk.field.blobs) if self.fp_kind == FP_BLOBS else 0

    @property
    def P(self) -> int:
        return self.IK + self.n_fp

    @property
    def npix(self) -> int:
        return self.pk.npix

    @property
    def entries(self) -> tuple:
        """The C entries of K2 and K3 for this scene: the field
        instantiations in an analytic density field, the grid ones in a
        voxel grid, the HG ones with a phase g."""
        if self.pk.grid is not None:
            return "vpt_diff_fwd_grid", "vpt_diff_bwd_grid"
        sfx = (("" if self.pk.field is None else "_field")
               + ("" if self.hg_mode == HG_NONE else "_hg"))
        return "vpt_diff_fwd" + sfx, "vpt_diff_bwd" + sfx

    def words(self) -> np.ndarray:
        fl = np.asarray([self.cp, self.inv_spp], np.float32).view(np.int32)
        mask = lambda ids: sum(1 << s for s in ids)   # noqa: E731
        ints = np.asarray([self.P, mask(self.alb_ids), mask(self.lam_ids),
                           self.n_fp, self.fp_kind, self.hg_mode,
                           int(self.diff_grid)], np.int32)
        return np.concatenate([self.pk.words(), fl, ints])


def pack_diff(scene: Scene, camera: Camera, width: int, height: int,
              spp: int, *, continue_prob: float = 0.6, max_bounces: int = 32,
              sampler: str = "random", jitter: bool = True,
              diff_g: bool = False, diff_field: bool = False,
              diff_blobs: bool = False, diff_grid: bool = False
              ) -> DiffPacked:
    """Freeze scene, camera and frame for the pair. The geometry, the
    emitter structure, the materials, the density field and the HG g are
    baked, as in vpt; sigma, albedo and radiance come from the parameter
    vector at each call, and so do the HG g (diff_g: the scene's g is then
    ignored), the fog falloff (diff_field), the blob rows (diff_blobs) or
    the voxel values (diff_grid: the table is rebuilt at each call). vpt's
    guards (diff.py:205-237) carry over."""
    fld = scene.medium.density
    grid = fld is not None and fld.kind == "grid"
    if diff_grid and not grid:
        raise ValueError("diff_grid=True needs a voxel-grid Medium.density")
    if diff_field and diff_blobs:
        raise ValueError("diff_field and diff_blobs are mutually exclusive "
                         "(one field kind per scene)")
    # vpt points other fields' training at its engine (AD / FD), which is
    # ROADMAP Queue 1 item 9 here
    if diff_blobs and (fld is None or fld.kind != "blobs"):
        raise NotImplementedError(
            "diff_blobs traces the Gaussian-blob parameters; the scene needs "
            "Medium.density = blobs(...) (other fields train on vpt's "
            "engine: ROADMAP Queue 1 item 9)")
    if diff_field and (fld is None or fld.kind != "exp_height"):
        raise NotImplementedError(
            "diff_field traces the exp_height fog falloff k; the scene needs "
            "Medium.density = exp_height(...) (blob parameters: diff_blobs; "
            "other fields train on vpt's engine: ROADMAP Queue 1 item 9)")
    pk = pack_scene(scene, camera, width, height, spp,
                    continue_prob=continue_prob, max_bounces=max_bounces,
                    sampler=sampler, jitter=jitter)
    if pk.vol:
        raise _todo("material-3 volumetric shells", "4.5")
    if grid and (diff_g or pk.g != 0.0):
        raise _todo("the Henyey-Greenstein phase in a voxel grid", "4.4")
    is_em = [any(v > 0 for v in pk.rad[s]) for s in range(pk.S)]
    # vpt: the albedo gradient lives on non-microfacet non-emitters (pLight's
    # lambert fr also covers glass); the deferred lambert terms on lamberts
    alb_ids = tuple(s for s in range(pk.S)
                    if pk.mat[s] != MICROFACET and not is_em[s])
    lam_ids = tuple(s for s in range(pk.S)
                    if pk.mat[s] == LAMBERT and not is_em[s])
    fp_kind = FP_FOG_K if diff_field else FP_BLOBS if diff_blobs else FP_NONE
    hg_mode = HG_TRACED if diff_g else HG_BAKED if pk.g != 0.0 else HG_NONE
    return DiffPacked(pk=pk, cp=f32(continue_prob), inv_spp=f32(1.0 / spp),
                      alb_ids=alb_ids, lam_ids=lam_ids, fp_kind=fp_kind,
                      hg_mode=hg_mode, diff_grid=bool(diff_grid))


def traced_field(dp: DiffPacked, pv: torch.Tensor):
    """The pair's FieldConsts: K1's (folded in float64) when no field
    parameter is traced; with fog_k, k read from the parameter vector; with
    blobs, every blob constant an f32 operation on its row of the vector,
    as vpt's traced forms compute them."""
    fc = dp.pk.field
    ik = dp.IK
    if dp.fp_kind == FP_FOG_K:
        return dataclasses.replace(fc, k=pv[ik])
    if dp.fp_kind != FP_BLOBS:
        return fc
    blobs = []
    for b in range(len(fc.blobs)):
        cx, cy, cz, r, w = (pv[ik + 5 * b + j] for j in range(5))
        inv_r = 1.0 / r
        ramp = r * pr._SQRT_HALF_PI
        blobs.append(pr.Blob(cx=cx, cy=cy, cz=cz, r=r, w=w,
                             dens_c=1.0 / (r * r), tau_c=inv_r * inv_r,
                             amp_c=ramp * w, kh=inv_r * pr._SQRT_HALF,
                             inv_r=inv_r, ramp=ramp))
    return dataclasses.replace(fc, blobs=tuple(blobs))


# ---------------------------------------------------------------------------
# plain version: vpt/kernels/diff.py:290-1251 on (N,) lanes
# ---------------------------------------------------------------------------

def _wdot(wt, v):
    return wt[0] * v[0] + wt[1] * v[1] + wt[2] * v[2]


def _diff_body(dp: DiffPacked, pvec: torch.Tensor, seed: torch.Tensor,
               gbar: torch.Tensor | None = None, stats: dict | None = None,
               tab: torch.Tensor | None = None):
    """The pair's lockstep body. gbar None: the image (npix, 3) / spp.
    gbar (npix, 3): the per-lane gradient contributions (npix, P), whose
    column sum is the packed gradient of sum(image * gbar); with diff_grid
    also the voxel gradient and the sum of the absolute values of the
    terms it adds, each in the grid's shape. tab: a grid's packed table
    (default: the scene's, baked)."""
    grads = gbar is not None
    pk = dp.pk
    dev = pvec.device
    S, W, H, spp = pk.S, pk.width, pk.height, pk.spp
    N = pk.npix
    n_em = len(pk.emitters)
    pv = pvec.detach()
    alb = pv[2:2 + 3 * S].reshape(S, 3)
    rad = pv[2 + 3 * S:2 + 6 * S].reshape(S, 3)

    def scalar(v):
        # a device tensor: torch's CUDA ops divide by a host scalar as a
        # multiply by its reciprocal, which rounds differently
        return torch.tensor(v, dtype=torch.float32, device=dev)

    sa, ss = pv[0], pv[1]
    sigma_t = sa + ss
    inv_st = 1.0 / sigma_t
    albedo_ratio = ss * inv_st
    ar_cp = albedo_ratio / scalar(dp.cp)
    inv_ss = 1.0 / ss
    inv_ps = float(n_em)
    inv_cp = pk.inv_cp
    # the density field, its traced parameters (n_fp slots from IK) and the
    # hooks of their derivatives: fp_dI(o, d, t) -> n_fp values of
    # d(optical path per unit sigma)/dtheta, fp_dlogdens(x) -> n_fp values
    # of d log(density)/dtheta
    grid = pk.grid is not None
    if grid:
        fc = dataclasses.replace(
            pk.grid, tab=pk.table(dev) if tab is None else tab.to(dev))
    else:
        fc = traced_field(dp, pv)
    n_fp, IK = dp.n_fp, dp.IK
    # vpt's two-phase replay per sample (K3 with diff_grid): the voxel
    # gradient, and the absolute values of its terms, summed in float64 so
    # that this sum's own rounding stays far below the kernel's (f32
    # atomics in another order)
    two_phase = grads and dp.diff_grid
    if two_phase:
        T = int(np.prod(pk.grid.dims))
        gg = torch.zeros(T, dtype=torch.float64, device=dev)
        gabs = torch.zeros(T, dtype=torch.float64, device=dev)
    # the HG phase: the traced g (diff_g) at IG, or the scene's baked g
    traced_g = dp.hg_mode == HG_TRACED
    gph = pv[dp.IG] if traced_g else None
    if fc is not None and not grid:
        inv_mr = 1.0 / (sigma_t * fc.maj)   # delta tracking's step scale
    if dp.fp_kind == FP_FOG_K:
        def fp_dI(o_, d_, t_):
            return [pr.field_tau_dk(fc, o_, d_, t_)]

        def fp_dlogdens(x_):
            return [-(x_[1] - fc.y0)]
    elif dp.fp_kind == FP_BLOBS:
        def fp_dI(o_, d_, t_):
            return [v for tup in pr.field_blob_tau_grads(fc.blobs, o_, d_, t_)
                    for v in tup]

        def fp_dlogdens(x_):
            dens_, dd = pr.field_blob_dens_grads(fc.blobs, x_)
            inv = 1.0 / torch.clamp_min(dens_, 1e-30)
            return [v * inv for tup in dd for v in tup]

    lane = torch.arange(N, dtype=torch.int64, device=dev)
    px = (lane % W).to(torch.float32)
    py = (H - 1 - lane // W).to(torch.float32)
    seed_i = seed.to(torch.int64).reshape(())
    z = torch.zeros(N, dtype=torch.float32, device=dev)
    if grads:
        wt = [gbar[:, i] * dp.inv_spp for i in range(3)]
    if pk.ld:
        A1, A2, A3, A4, A5 = pr.LD_ALPHA
        off_u, off_v, off_w, off_r, off_p = pr.ld_offsets(lane, seed_i)
        strat = pr.ld_strat
    w_f, h_f = scalar(float(W)), scalar(float(H))
    em = list(pk.emitters)
    em_c = torch.tensor([list(pk.c[e]) for e in em] + [[0.0] * 3],
                        dtype=torch.float32, device=dev)
    em_r = torch.tensor([pk.r[e] for e in em] + [0.0], dtype=torch.float32,
                        device=dev)
    em_ids = torch.tensor(em + [-1], dtype=torch.int64, device=dev)
    em_rad = torch.cat([rad[em], rad.new_zeros(1, 3)])
    r_tab = torch.tensor(pk.r, dtype=torch.float32, device=dev)
    c_tab = torch.tensor(pk.c, dtype=torch.float32, device=dev)

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
        d = [pk.cx[i] * sx + pk.cy[i] * sy + pk.cam_d[i] for i in range(3)]
        return pr.normalize3(d)

    def light_attrs(u_pick):
        k = torch.clamp((u_pick * float(n_em)).to(torch.int64), 0, n_em - 1)
        k = torch.where(k >= 0, k, n_em)     # no emitters: the zero row
        lc, lrad = em_c[k], em_rad[k]
        return ([lc[:, 0], lc[:, 1], lc[:, 2]],
                [lrad[:, 0], lrad[:, 1], lrad[:, 2]], em_r[k], em_ids[k])

    def plight_term(at, xs, n, d, lc, lrad):
        """pLight and its partials: (ldp, d/dlrad, d/dalb, distance)."""
        le_scale, dist, dl = pr.plight_le_scale(pk, lc, xs)
        wi = [-dl[0], -dl[1], -dl[2]]
        fr = pr.eval_fr_nee_plight(at, n, d, wi)
        cosw = pr.dot3(n, wi)
        coef = [le_scale * fr[i] * cosw for i in range(3)]
        ldp = [lrad[i] * coef[i] for i in range(3)]
        if not grads:
            return ldp, None, None, dist
        not_mic = ~at["is_mic"]
        lam = [torch.where(not_mic, lrad[i] * le_scale * cosw * INV_PI, 0.0)
               for i in range(3)]
        return ldp, coef, lam, dist

    def mis_v2(rng, at, xs, n, d, wtp=None):
        """MISv2 and its partials (vpt/kernels/diff.py mis_v2). wtp (a
        grid's two-phase replay): per-channel adjoint weights; each light
        strategy's (sum_i wtp[i] term[i], direction, distance) lands in
        "scat" for the voxel march scatter."""
        acc = [z, z, z]
        scat = []
        wo = [-d[0], -d[1], -d[2]]
        dsig = [z, z, z]
        drad = {}
        dalb = [z, z, z]
        dk = [[z, z, z] for _ in range(n_fp)]   # d/d(field param) per slot
        is_lam = ~at["is_mic"] & ~at["is_die"]
        for e in pk.mis_lights:
            ec = pk.c[e]
            er = pk.r[e]
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
            # att: the optical path per unit sigma_t (the distance when
            # homogeneous); d(tr)/dsigma = -att tr
            att = normcx if fc is None else pr.field_tau(fc, 1.0, xs, wc,
                                                         normcx, nonneg=True)
            tr = torch.exp(-sigma_t * att)
            w_vis = torch.where(visible, tr * pr.dot3(n, wi) * fpdf_inv, 0.0)
            gpdf = pr.bsdf_pdf_for_dir(at, n, wo, wi, rng())
            wf = pr.power_h_invf(fpdf_inv, gpdf)
            re = rad[e]
            term = [re[i] * fr[i] * w_vis * wf for i in range(3)]
            for i in range(3):
                acc[i] = acc[i] + term[i]
            if grads:
                for i in range(3):
                    dsig[i] = dsig[i] + term[i] * (-att)
                    dalb[i] = dalb[i] + torch.where(
                        is_lam, re[i] * w_vis * wf * INV_PI, 0.0)
                drad[e] = [fr[i] * w_vis * wf for i in range(3)]
                if wtp is not None:
                    scat.append((wtp[0] * term[0] + wtp[1] * term[1]
                                 + wtp[2] * term[2], wc, normcx))
                if n_fp:
                    # d(tr)/dtheta = tr (-sigma_t dI/dtheta)
                    dIs = fp_dI(xs, wc, normcx)
                    for f in range(n_fp):
                        for i in range(3):
                            dk[f][i] = dk[f][i] + term[i] * (-sigma_t
                                                             * dIs[f])
        # BSDF strategy
        u1, u2, u_choice = rng(), rng(), rng()
        wi_l = pr.cosine_hemi(n, u1, u2)
        wt_, _ = pr.refract_quirk(wo, n)
        fres = pr.fresnel_die(pr.dot3(n, wt_), pr.dot3(n, wo))
        refl = u_choice < fres
        ndotwo = pr.dot3(n, wo)
        wr = pr.normalize3([2.0 * ndotwo * n[i] - wo[i] for i in range(3)])
        wi_d = pr.sel3(refl, wr, wt_)
        wh_loc = pr.beckmann_wh(at["alpha"], u1, u2)
        wo_loc = pr.to_local(n, wo)
        whw = 2.0 * pr.dot3(wh_loc, wo_loc)
        wi_m_loc = pr.normalize3([whw * wh_loc[i] - wo_loc[i]
                                  for i in range(3)])
        wi_m = pr.normalize3(pr.from_local(n, wi_m_loc))
        wi_sel = pr.sel3(at["is_mic"], wi_m, pr.sel3(at["is_die"], wi_d, wi_l))
        hit, _, sid2 = pr.nearest_id_t(pk, xs, wi_sel)
        le_row = pr.per_sphere(rad, sid2)
        le = [le_row[:, 0], le_row[:, 1], le_row[:, 2]]
        hit_r = pr.per_sphere(r_tab, sid2)
        hc_row = pr.per_sphere(c_tab, sid2)
        hc = [hc_row[:, 0], hc_row[:, 1], hc_row[:, 2]]
        cos_l = pr.dot3(n, wi_l)
        gpdf_l = cos_l * INV_PI
        nz_l = gpdf_l != 0.0
        coef_l = [torch.where(nz_l, (at["ar"], at["ag"], at["ab"])[i], 0.0)
                  for i in range(3)]
        g_l = [le[i] * coef_l[i] for i in range(3)]
        cos_d = torch.abs(pr.dot3(n, wi_d))
        scale_d = torch.where(refl, 1.0, pr.GLASS_ETA_T * pr.GLASS_ETA_T) \
            / torch.clamp_min(cos_d, 1e-12)
        g_d = [le[i] * scale_d for i in range(3)]
        gpdf_d = torch.where(refl, fres, 1.0 - fres)
        fr_m = pr.fr_microfacet(at, wi_m_loc, wh_loc, wo_loc)
        gpdf_m = pr.ndf_beckmann(wh_loc[2], at["alpha"]) * wh_loc[2] / (
            4.0 * torch.clamp_min(torch.abs(pr.dot3(wo_loc, wh_loc)), 1e-12))
        winv_m = wi_m_loc[2] / torch.clamp_min(gpdf_m, 1e-20)
        coef_m = [fr_m[i] * winv_m for i in range(3)]
        g_m = [le[i] * coef_m[i] for i in range(3)]
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
        if not grads:
            return acc, None
        sel = pr.sel3(at["is_mic"], coef_m,
                      pr.sel3(at["is_die"], [scale_d] * 3, coef_l))
        dle = [sel[i] * wg for i in range(3)]
        for i in range(3):
            dalb[i] = dalb[i] + torch.where(is_lam & nz_l, le[i] * wg, 0.0)
        return acc, {"dsig": dsig, "drad": drad, "dalb": dalb, "dle": dle,
                     "sid2": sid2, "dk": dk, "scat": scat}

    def medium_nee(rng, d, xt, lc, lrad, lr, lid):
        """freeSingleScattering; returns (radiance, weight, optical path
        per unit sigma, d/dg log phase (diff_g; else None), the cone
        direction and the shadow distance). d: the incoming direction,
        which the HG phase toward the cone sample reads."""
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
        att = t if fc is None else pr.field_tau(fc, 1.0, xt, wl, t,
                                                nonneg=True)
        dlogp = None
        if traced_g:
            cos_nee = pr.dot3(d, wl)
            phase_2pi = pr.hg_phase_traced(cos_nee, gph) * TWO_PI
            if grads:
                dlogp = pr.dlog_hg_dg(cos_nee, gph)
        elif dp.hg_mode == HG_BAKED:
            phase_2pi = pr.hg_phase_const(pk, pr.dot3(d, wl)) * TWO_PI
        else:
            phase_2pi = pk.nee_phase
        w = torch.where(visible,
                        torch.exp(-sigma_t * att) * phase_2pi
                        * torch.clamp_min(1.0 - cos_max, 1e-12), 0.0)
        return [lrad[i] * w for i in range(3)], w, att, dlogp, wl, t

    acc = {}
    if grads:
        for k in ("g_st", "g_ssx", "A_st", "B_st", "A_ssx", "B_ssx"):
            acc[k] = z
        for e in em:
            for i in range(3):
                acc[("rad", e, i)] = z
        for s in dp.alb_ids:
            for i in range(3):
                acc[("alb", s, i)] = z
        for s in dp.lam_ids:
            for i in range(3):
                acc[("A_alb", s, i)] = z
                acc[("B_alb", s, i)] = z
        for f in range(n_fp):
            for k in ("g_fp", "A_fp", "B_fp"):
                acc[(k, f)] = z
        if traced_g:
            for k in ("g_g", "A_g", "B_g"):
                acc[k] = z
        if two_phase:
            acc["wLtot"] = z
            phase = torch.zeros(N, dtype=torch.bool, device=dev)
            rng_save = torch.zeros(N, dtype=torch.int64, device=dev)

    rng = pr.Pcg(pr.pcg_seed(lane, seed_i))
    o = [z, z, z]
    d = [z, z, z + 1.0]
    tp = [z, z, z]
    L = [z, z, z]
    Lps = [z, z, z]
    alive = torch.zeros(N, dtype=torch.bool, device=dev)
    depth = torch.zeros(N, dtype=torch.int64, device=dev)
    samples = torch.zeros(N, dtype=torch.int64, device=dev)
    cam_o = [torch.full_like(z, v) for v in pk.cam_o]
    one = torch.ones_like(z)
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    it = 0
    iters_cap = 2 * pk.max_iters if two_phase else pk.max_iters
    wl = wt if grads else None
    while it < iters_cap and bool((samples < spp).any()):
        act = samples < spp         # the kernels' threads still looping
        need = ~alive & act
        if stats is not None:
            counts[0] += (samples < spp).sum()
        if two_phase:
            # phase A saves the stream at the sample's start, phase B
            # replays it; the cotangent is zero in phase A
            phB = phase
            rng.s = torch.where(need & phB, rng_save, rng.s)
            rng_save = torch.where(need & ~phB, rng.s, rng_save)
            wl = [torch.where(phB, wt[i], 0.0) for i in range(3)]
        nd = camera_ray(rng, samples)
        o = pr.sel3(need, cam_o, o)
        d = pr.sel3(need, nd, d)
        tp = pr.sel3(need, [one, one, one], tp)
        alive = alive | need
        depth = torch.where(need, 0, depth)
        was_alive = alive

        # ---- bounce (the forward kernel's draw order)
        u_rr = rng()
        u_pick = rng()
        u_dist = rng()
        if pk.ld:
            s_f = samples.to(torch.float32)
            d0 = depth == 0
            u_rr = torch.where(d0, strat(A4, off_r, s_f), u_rr)
            u_pick = torch.where(d0, strat(A5, off_p, s_f), u_pick)
            u_dist = torch.where(d0, strat(A3, off_w, s_f), u_dist)
        alive = alive & (u_rr >= pk.q)
        hit, t, at = pr.nearest(pk, o, d, alb, rad)
        t_eff = torch.where(hit, t, BIG)
        xs = [o[i] + t_eff * d[i] for i in range(3)]
        nrm = pr.normalize3([xs[0] - at["cx"], xs[1] - at["cy"],
                             xs[2] - at["cz"]])
        lc, lrad, lr, lid = light_attrs(u_pick)

        if fc is None:
            d_s = -torch.log1p(-u_dist) * inv_st
            surface = (d_s > t_eff) & hit
        elif grid:
            # K1's march: the inverted distance and tau(t_eff)
            d_s, tau_cap = pr.grid_sample_free_and_tau(
                fc, sigma_t, o, d, u_dist, t_eff)
            surface = (d_s > t_eff) & hit
            alive = alive & ((d_s < 0.5 * BIG) | surface)
            if stats is not None:
                counts[3] += act.sum()
        else:
            # K1's field free flight and draws; an escaped flight kills the
            # lane (its score would weight no future contribution)
            d_s = pr.field_sample_free(
                fc, sigma_t, inv_mr, o, d, u_dist, rng, t_eff, active=act,
                work=counts[4:5] if stats is not None else None)
            surface = (d_s > t_eff) & hit
            alive = alive & ((d_s < 0.5 * BIG) | surface)
        xt = [o[i] + d_s * d[i] for i in range(3)]
        medium = alive & ~surface
        shade_pre = alive & surface

        if grads:
            # free-flight score vs the L-prefix before this bounce
            if fc is None:
                k_sc = torch.where(shade_pre, -t_eff,
                                   torch.where(medium, inv_st - d_s, 0.0))
            elif grid:
                # p(d) = sigma_t rho_pc(d) e^{-sigma_t I(d)}: both optical
                # paths come from the sampling march
                I_surf = tau_cap * inv_st
                I_med = -torch.log1p(-u_dist) * inv_st
                k_sc = torch.where(shade_pre, -I_surf,
                                   torch.where(medium, inv_st - I_med, 0.0))
            else:
                # p(d) = sigma_t dens(x_d) e^{-sigma_t I(d)}, P(surface) =
                # e^{-sigma_t I(t)}: dlog/dsigma = 1/sigma_t - I(d) | -I(t);
                # the gated distances keep the chains finite (d_s == BIG)
                t_det = torch.where(shade_pre, t_eff, 0.0)
                d_det = torch.where(medium, d_s, 0.0)
                I_surf = pr.field_tau(fc, 1.0, o, d, t_det)
                I_med = pr.field_tau(fc, 1.0, o, d, d_det)
                k_sc = torch.where(shade_pre, -I_surf,
                                   torch.where(medium, inv_st - I_med, 0.0))
            wL0 = _wdot(wl, Lps)
            acc["A_st"] = acc["A_st"] + k_sc
            acc["B_st"] = acc["B_st"] + k_sc * wL0
            if two_phase:
                # the voxel event scores, at once (phase B knows wLtot):
                # dlog P(surface)/dv = -sigma dI(t)/dv; dlog p(d)/dv =
                # dlog rho_pc(d)/dv - sigma dI(d)/dv
                w_sc = torch.where(phB & (shade_pre | medium),
                                   acc["wLtot"] - wL0, 0.0)
                t_detg = torch.where(shade_pre, t_eff, 0.0)
                d_detg = torch.where(medium & (d_s < 0.5 * BIG), d_s, 0.0)
                pr.grid_march_scatter(
                    fc, o, d, torch.where(shade_pre, -sigma_t * w_sc, 0.0),
                    t_detg, torch.where(medium, -sigma_t * w_sc, 0.0),
                    d_detg, gg, gabs)
                x_pc, rho_pc = pr.grid_pc_point(fc, o, d, d_detg)
                pr.grid_scatter_point(
                    fc, x_pc, torch.where(
                        medium, w_sc / torch.clamp_min(rho_pc, 1e-30), 0.0),
                    gg, gabs)
            if n_fp:
                # field-parameter event scores: dlog p(d)/dtheta = dlog
                # dens(x_d)/dtheta - sigma dI(d)/dtheta (medium), dlog
                # P(surface)/dtheta = -sigma dI(t)/dtheta (surface)
                dI_s = fp_dI(o, d, t_det)
                dI_m = fp_dI(o, d, d_det)
                dlogd = fp_dlogdens([o[j] + d_det * d[j] for j in range(3)])
                for f in range(n_fp):
                    k_f = torch.where(
                        shade_pre, -sigma_t * dI_s[f],
                        torch.where(medium, dlogd[f] - sigma_t * dI_m[f], 0.0))
                    acc[("A_fp", f)] = acc[("A_fp", f)] + k_f
                    acc[("B_fp", f)] = acc[("B_fp", f)] + k_f * wL0

        em_hit = surface & at["is_em"]
        credit = alive & em_hit & (depth == 0)
        radh = [at["rr"], at["rg"], at["rb"]]
        for i in range(3):
            add = torch.where(credit, radh[i] * tp[i], 0.0)
            L[i] = L[i] + add
            Lps[i] = Lps[i] + add
        if grads:
            for e in em:
                m = credit & (at["sid"] == e)
                for i in range(3):
                    acc[("rad", e, i)] = acc[("rad", e, i)] + torch.where(
                        m, wl[i] * tp[i], 0.0)
        shade = alive & surface & ~em_hit

        ldp, ldp_coef, ldp_lam, dist_ls = plight_term(at, xs, nrm, d, lc,
                                                      lrad)
        if fc is None:
            att_pl = dist_ls
        else:
            inv_dl = 1.0 / torch.clamp_min(dist_ls, 1e-20)
            wlight = [(lc[i] - xs[i]) * inv_dl for i in range(3)]
            att_pl = pr.field_tau(fc, 1.0, xs, wlight, dist_ls, nonneg=True)
        trs = torch.exp(-sigma_t * att_pl)
        wtp = ([wl[i] * tp[i] * inv_cp for i in range(3)] if two_phase
               else None)
        ldm, misp = mis_v2(rng, at, xs, nrm, d, wtp)
        for i in range(3):
            add = torch.where(
                shade, (ldp[i] * trs * inv_ps + ldm[i]) * tp[i] * inv_cp, 0.0)
            L[i] = L[i] + add
            Lps[i] = Lps[i] + add
        if grads:
            gs = z
            for i in range(3):
                gs = gs + wl[i] * (ldp[i] * trs * (-att_pl) * inv_ps
                                   + misp["dsig"][i]) * tp[i] * inv_cp
            acc["g_st"] = acc["g_st"] + torch.where(shade, gs, 0.0)
            if two_phase:
                gpl = z
                for i in range(3):
                    gpl = gpl + (wl[i] * ldp[i] * trs * inv_ps * tp[i]
                                 * inv_cp)
                gpl = torch.where(shade, gpl, 0.0)
            if n_fp:
                # the field-parameter terms of pLight's and the MIS light
                # strategy's transmittances
                dI_pl = fp_dI(xs, wlight, dist_ls)
                for f in range(n_fp):
                    gk = z
                    for i in range(3):
                        gk = gk + wl[i] * (
                            ldp[i] * trs * (-sigma_t * dI_pl[f]) * inv_ps
                            + misp["dk"][f][i]) * tp[i] * inv_cp
                    acc[("g_fp", f)] = acc[("g_fp", f)] + torch.where(
                        shade, gk, 0.0)
            for e in em:
                m = shade & (lid == e)
                for i in range(3):
                    g = torch.where(m, wl[i] * ldp_coef[i] * trs * inv_ps
                                    * tp[i] * inv_cp, 0.0)
                    if e in misp["drad"]:
                        g = g + torch.where(
                            shade, wl[i] * misp["drad"][e][i] * tp[i] * inv_cp,
                            0.0)
                    g = g + torch.where(
                        shade & (misp["sid2"] == e),
                        wl[i] * misp["dle"][i] * tp[i] * inv_cp, 0.0)
                    acc[("rad", e, i)] = acc[("rad", e, i)] + g
            for s in dp.alb_ids:
                m = shade & (at["sid"] == s)
                for i in range(3):
                    acc[("alb", s, i)] = acc[("alb", s, i)] + torch.where(
                        m, wl[i] * (ldp_lam[i] * trs * inv_ps
                                    + misp["dalb"][i]) * tp[i] * inv_cp, 0.0)

        fs, wi_s, pdf_b = pr.sample_bsdf(rng, at, d, nrm)
        cosine = pr.dot3(nrm, wi_s)
        wscale = cosine * inv_cp / torch.clamp_min(pdf_b, 1e-20)
        tp_surface = [tp[i] * fs[i] * wscale for i in range(3)]

        u_p1, u_p2 = rng(), rng()
        if traced_g:
            wi_m = pr.hg_dir_traced(d, gph, u_p1, u_p2)
        elif dp.hg_mode == HG_BAKED:
            wi_m = pr.hg_dir(pk, d, u_p1, u_p2)
        else:
            wi_m = pr.uniform_sphere(u_p1, u_p2)
        med_scale = ar_cp
        med_dsig = -inv_st
        ld_med, w_med, att_nee, dlogp_nee, wl_nee, t_nee = medium_nee(
            rng, d, xt, lc, lrad, lr, lid)
        adds = [torch.where(medium, ld_med[i] * inv_ps * tp[i] * med_scale,
                            0.0) for i in range(3)]
        for i in range(3):
            L[i] = L[i] + adds[i]
            Lps[i] = Lps[i] + adds[i]
        if grads:
            gs = z
            gx = z
            for i in range(3):
                gs = gs + wl[i] * adds[i] * (-att_nee + med_dsig)
                gx = gx + wl[i] * adds[i]
            acc["g_st"] = acc["g_st"] + gs
            acc["g_ssx"] = acc["g_ssx"] + gx * inv_ss
            if two_phase:
                # the pathwise voxel terms of the NEE transmittances: pLight
                # (shade) and medium NEE (medium), one merged march, and
                # the MIS light-strategy rays
                pr.grid_march_scatter(
                    fc, pr.sel3(shade, xs, xt), pr.sel3(shade, wlight, wl_nee),
                    (-sigma_t) * (gpl + gx), torch.where(shade, dist_ls, t_nee),
                    z, z, gg, gabs)
                for w_e, wc_e, dist_e in misp["scat"]:
                    pr.grid_march_scatter(
                        fc, xs, wc_e, torch.where(shade, -sigma_t * w_e, 0.0),
                        dist_e, z, z, gg, gabs)
            if n_fp:
                # the medium-NEE transmittance's field-parameter term, the
                # inputs gated on medium (an escaped lane's xt is at BIG)
                t_nee_g = torch.where(medium, t_nee, 0.0)
                xt_g = [torch.where(medium, xt[j], 0.0) for j in range(3)]
                dI_nee = fp_dI(xt_g, wl_nee, t_nee_g)
                for f in range(n_fp):
                    acc[("g_fp", f)] = acc[("g_fp", f)] + torch.where(
                        medium, gx * (-sigma_t * dI_nee[f]), 0.0)
            if traced_g:
                # the NEE value's phase(cos_nee | g) factor
                acc["g_g"] = acc["g_g"] + torch.where(
                    medium, gx * dlogp_nee, 0.0)
            for e in em:
                m = medium & (lid == e)
                for i in range(3):
                    acc[("rad", e, i)] = acc[("rad", e, i)] + torch.where(
                        m, wl[i] * w_med * inv_ps * tp[i] * med_scale, 0.0)
        tp_medium = [tp[i] * med_scale for i in range(3)]

        if grads:
            # deferred log-throughput factors vs the L-prefix after this
            # bounce's emissions
            wL1 = _wdot(wl, Lps)
            k_med_st = torch.where(medium, med_dsig, 0.0)
            k_med_ssx = torch.where(medium, inv_ss, 0.0)
            acc["A_st"] = acc["A_st"] + k_med_st
            acc["B_st"] = acc["B_st"] + k_med_st * wL1
            acc["A_ssx"] = acc["A_ssx"] + k_med_ssx
            acc["B_ssx"] = acc["B_ssx"] + k_med_ssx * wL1
            if traced_g:
                # the phase draw's score, deferred against later
                # contributions
                k_g = torch.where(medium,
                                  pr.dlog_hg_dg(pr.dot3(d, wi_m), gph), 0.0)
                acc["A_g"] = acc["A_g"] + k_g
                acc["B_g"] = acc["B_g"] + k_g * wL1
            for s in dp.lam_ids:
                m = shade & (at["sid"] == s)
                for i in range(3):
                    a_si = alb[s, i]
                    inv_a = torch.where(a_si > 0.0, 1.0 / a_si, 0.0)
                    k = torch.where(m, wl[i] * inv_a, 0.0)
                    acc[("A_alb", s, i)] = acc[("A_alb", s, i)] + k
                    acc[("B_alb", s, i)] = acc[("B_alb", s, i)] + k * Lps[i]

        if stats is not None:
            counts[1] += shade.sum()
            counts[2] += medium.sum()
            if fc is not None:
                # K2's field optical depths: pLight and the MIS lights on
                # shading lanes, medium NEE on medium lanes
                counts[3] += (shade.sum() * (1 + len(pk.mis_lights))
                              + medium.sum())
        o = pr.sel3(shade, xs, pr.sel3(medium, xt, o))
        d = pr.sel3(shade, wi_s, pr.sel3(medium, wi_m, d))
        tp = pr.sel3(shade, tp_surface, pr.sel3(medium, tp_medium, tp))
        alive2 = (shade | medium) & (depth + 1 < pk.max_bounces)
        depth = torch.where(alive2, depth + 1, depth)
        finished = was_alive & ~alive2
        if two_phase:
            # phase A ends: the sample's weighted total with the raw
            # cotangent, then its replay; phase B ends the sample
            finA = finished & ~phase
            finB = finished & phase
            acc["wLtot"] = torch.where(finA, _wdot(wt, Lps), acc["wLtot"])
            phase = (phase | finA) & ~finB
            samples = samples + finB.to(torch.int64)
        else:
            samples = samples + finished.to(torch.int64)
        if grads:
            # fold the deferred pairs: A * L_total - B at path death
            WL = _wdot(wl, Lps)
            for g, a, b in (("g_st", "A_st", "B_st"),
                            ("g_ssx", "A_ssx", "B_ssx"),
                            *((("g_g", "A_g", "B_g"),) if traced_g else ()),
                            *((("g_fp", f), ("A_fp", f), ("B_fp", f))
                              for f in range(n_fp))):
                acc[g] = acc[g] + torch.where(
                    finished, acc[a] * WL - acc[b], 0.0)
                acc[a] = torch.where(finished, 0.0, acc[a])
                acc[b] = torch.where(finished, 0.0, acc[b])
            for s in dp.lam_ids:
                for i in range(3):
                    a = acc[("A_alb", s, i)]
                    b = acc[("B_alb", s, i)]
                    acc[("alb", s, i)] = acc[("alb", s, i)] + torch.where(
                        finished, a * Lps[i] - b, 0.0)
                    acc[("A_alb", s, i)] = torch.where(finished, 0.0, a)
                    acc[("B_alb", s, i)] = torch.where(finished, 0.0, b)
            Lps = [torch.where(finished, 0.0, Lps[i]) for i in range(3)]
        alive = alive2
        it += 1

    if stats is not None:
        keys = ("thread_iters", "shade", "medium", "taus", "null_steps")
        for k, v in zip(keys, counts.tolist()):
            stats[k] = stats.get(k, 0) + v
    if not grads:
        return torch.stack(L, dim=-1) / scalar(float(spp))
    # lanes cut by the iteration cap fold with their partial prefix
    wt_sum = _wdot(wt, Lps)
    g_st = acc["g_st"] + acc["A_st"] * wt_sum - acc["B_st"]
    g_ssx = acc["g_ssx"] + acc["A_ssx"] * wt_sum - acc["B_ssx"]
    for s in dp.lam_ids:
        for i in range(3):
            acc[("alb", s, i)] = acc[("alb", s, i)] + (
                acc[("A_alb", s, i)] * Lps[i] - acc[("B_alb", s, i)])
    G = torch.zeros((N, dp.P), dtype=torch.float32, device=dev)
    G[:, 0] = g_st
    G[:, 1] = g_st + g_ssx
    if traced_g:
        G[:, dp.IG] = acc["g_g"] + acc["A_g"] * wt_sum - acc["B_g"]
    for f in range(n_fp):
        G[:, IK + f] = (acc[("g_fp", f)] + acc[("A_fp", f)] * wt_sum
                        - acc[("B_fp", f)])
    for s in dp.alb_ids:
        for i in range(3):
            G[:, 2 + 3 * s + i] = acc[("alb", s, i)]
    for e in em:
        for i in range(3):
            G[:, 2 + 3 * S + 3 * e + i] = acc[("rad", e, i)]
    if two_phase:
        return (G, gg.reshape(pk.grid.dims).to(torch.float32),
                gabs.reshape(pk.grid.dims).to(torch.float32))
    return G


def diff_fwd_plain(dp: DiffPacked, pvec: torch.Tensor, seed: torch.Tensor,
                   stats: dict | None = None,
                   tab: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch K2 on pvec.device: (npix, 3) float32 radiance / spp.
    `stats`, if given, gains the lockstep loop's thread-iterations and its
    shading and medium events. tab: a grid's packed table (default: the
    scene's)."""
    with torch.no_grad():
        return _diff_body(dp, pvec, seed, stats=stats, tab=tab)


def diff_bwd_plain(dp: DiffPacked, pvec: torch.Tensor, seed: torch.Tensor,
                   gbar: torch.Tensor, per_lane: bool = False,
                   stats: dict | None = None,
                   tab: torch.Tensor | None = None, voxel_abs: bool = False):
    """Plain torch K3: the packed gradient (P,) of sum(image * gbar), or,
    with per_lane=True, each pixel's contribution (npix, P) before the
    sum. With diff_grid: (that, the voxel gradient in the grid's shape),
    and with voxel_abs=True the sum of its terms' absolute values per
    voxel third (the scale its sum-order rounding is held to)."""
    with torch.no_grad():
        out = _diff_body(dp, pvec, seed, gbar.to(torch.float32), stats=stats,
                         tab=tab)
    if not dp.diff_grid:
        return out if per_lane else out.sum(0)
    G, gg, gabs = out
    G = G if per_lane else G.sum(0)
    return (G, gg, gabs) if voxel_abs else (G, gg)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(dp: DiffPacked, pvec: torch.Tensor, seed: torch.Tensor):
    if pvec.dtype != torch.float32 or tuple(pvec.shape) != (dp.P,) \
            or not pvec.is_contiguous():
        raise ValueError(f"pvec must be a contiguous float32 tensor of shape "
                         f"({dp.P},)")
    if seed.dtype != torch.int32 or tuple(seed.shape) != (1,) \
            or not seed.is_contiguous():
        raise ValueError("seed must be a contiguous int32 tensor of shape (1,)")
    if pvec.device != seed.device:
        raise ValueError(f"pvec on {pvec.device}, seed on {seed.device}")
    if seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no diff kernel for device {seed.device}")


def _launch(name: str, dp: DiffPacked, dev: torch.device, *ptrs) -> None:
    from . import _build

    lib = _build.load()
    words = np.ascontiguousarray(dp.words())
    if words.size != lib.vpt_diff_params_words():
        raise RuntimeError(
            f"DiffParams layout mismatch: python packs {words.size} words, "
            f"the kernel expects {lib.vpt_diff_params_words()}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(words.ctypes.data, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_build.error_string(err)} ({err})")


def _grid_tab(dp: DiffPacked, dev, tab):
    """A grid's table argument for a launch: the given one or the
    scene's, on dev; () without a grid."""
    if dp.pk.grid is None:
        return ()
    tab = dp.pk.table(dev) if tab is None else tab
    if tab.dtype != torch.int32 or tab.device != dev or not tab.is_contiguous() \
            or tab.numel() != int(np.prod(dp.pk.grid.dims)):
        raise ValueError(f"the grid's table must be a contiguous int32 "
                         f"tensor of {int(np.prod(dp.pk.grid.dims))} words "
                         f"on {dev}")
    return (tab.data_ptr(),)


def diff_fwd(dp: DiffPacked, pvec: torch.Tensor, seed: torch.Tensor,
             tab: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on pvec.device: (npix, 3) float32 radiance / spp. A CUDA tensor
    launches csrc/diff.cu on the current stream without synchronising; a
    CPU tensor runs diff_fwd_plain. tab: a grid's packed table
    (prims.grid_table; default: the scene's)."""
    _check_inputs(dp, pvec, seed)
    if pvec.device.type == "cpu":
        return diff_fwd_plain(dp, pvec, seed, tab=tab)
    out = torch.empty((dp.npix, 3), dtype=torch.float32, device=pvec.device)
    _launch(dp.entries[0], dp, pvec.device, pvec.data_ptr(),
            seed.data_ptr(), out.data_ptr(),
            *_grid_tab(dp, pvec.device, tab))
    LAUNCHES_BY[dp.entries[0]] = LAUNCHES_BY.get(dp.entries[0], 0) + 1
    return out


def diff_bwd(dp: DiffPacked, pvec: torch.Tensor, seed: torch.Tensor,
             gbar: torch.Tensor, per_lane: bool = False,
             tab: torch.Tensor | None = None):
    """K3 on pvec.device: the packed gradient (P,) of sum(image * gbar).
    The kernel writes one deterministic partial P-vector per block; they
    are summed here. per_lane=True returns each pixel's own vector (npix,
    P) instead, as diff_bwd_plain does (for checks: the kernel then also
    writes them out). With diff_grid: (that, the voxel gradient in the
    grid's shape), added by the kernel with atomics. A CPU tensor runs
    diff_bwd_plain. tab: a grid's packed table (default: the scene's)."""
    _check_inputs(dp, pvec, seed)
    gbar = gbar.contiguous()        # mean()'s cotangent is an expanded view
    if gbar.dtype != torch.float32 or tuple(gbar.shape) != (dp.npix, 3) \
            or gbar.device != pvec.device:
        raise ValueError(f"gbar must be float32 ({dp.npix}, 3) on "
                         f"{pvec.device}")
    if pvec.device.type == "cpu":
        return diff_bwd_plain(dp, pvec, seed, gbar, per_lane=per_lane,
                              tab=tab)
    from . import _build

    threads = _build.load().vpt_diff_block_threads()
    partials = torch.empty((-(-dp.npix // threads), dp.P),
                           dtype=torch.float32, device=pvec.device)
    lanes = (torch.empty((dp.npix, dp.P), dtype=torch.float32,
                         device=pvec.device) if per_lane else None)
    grid_args = ()
    if dp.pk.grid is not None:
        gg = (torch.zeros(dp.pk.grid.dims, dtype=torch.float32,
                          device=pvec.device) if dp.diff_grid else None)
        grid_args = (*_grid_tab(dp, pvec.device, tab),
                     None if gg is None else gg.data_ptr())
    _launch(dp.entries[1], dp, pvec.device, pvec.data_ptr(),
            seed.data_ptr(), gbar.data_ptr(), partials.data_ptr(),
            lanes.data_ptr() if per_lane else None, *grid_args)
    LAUNCHES_BY[dp.entries[1]] = LAUNCHES_BY.get(dp.entries[1], 0) + 1
    G = lanes if per_lane else partials.sum(0)
    return (G, gg) if dp.diff_grid else G


class _DiffRender(torch.autograd.Function):
    """image = K2(pvec, seed); d(image . gbar)/d(pvec) = K3(pvec, seed,
    gbar), a replay of the same paths (vpt's custom VJP). With diff_grid
    the voxel values are a second input: their table is rebuilt on their
    device at each call, and K3 returns their gradient."""

    @staticmethod
    def forward(ctx, pvec, seed, dp, values=None):
        tab = None if values is None else pr.grid_table(values)
        ctx.save_for_backward(pvec, seed, tab)
        ctx.dp = dp
        return diff_fwd(dp, pvec, seed, tab)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        pvec, seed, tab = ctx.saved_tensors
        if not ctx.dp.diff_grid:
            return diff_bwd(ctx.dp, pvec, seed, gbar), None, None, None
        gvec, ggrid = diff_bwd(ctx.dp, pvec, seed, gbar, tab=tab)
        return gvec, None, None, ggrid


def make_diff_renderer(scene: Scene, camera: Camera, width: int, height: int,
                       spp: int, *, nee: bool = True, distance: str = "free",
                       continue_prob: float = 0.6, max_bounces: int = 32,
                       jitter: bool = True, sampler: str = "random",
                       physical: bool = False, diff_g: bool = False,
                       diff_field: bool = False, diff_blobs: bool = False,
                       diff_grid: bool = False, device="cuda"):
    """Build render(params, seed) -> (npix, 3) on `device`, differentiable
    with respect to params (pack_params; with_g=True for diff_g,
    with_field=True for diff_field, with_blobs=True for diff_blobs,
    with_grid=True for diff_grid) through torch autograd. "cuda" runs K2/K3
    (their field instantiations in an analytic density field, their grid
    ones in a voxel grid, their HG ones at a g != 0 or with diff_g) or
    raises; "cpu" runs their plain versions."""
    if distance != "free":
        raise _todo(f"distance={distance!r}" + (" (with diff_grid)"
                                                 if diff_grid else ""), "4.4")
    if physical or not nee:
        raise _todo("the physical and implicit estimators", "4.4")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_diff_renderer(device='cuda'): "
                           "torch.cuda.is_available() is False")
    dp = pack_diff(scene, camera, width, height, spp,
                   continue_prob=continue_prob, max_bounces=max_bounces,
                   sampler=sampler, jitter=jitter, diff_g=diff_g,
                   diff_field=diff_field, diff_blobs=diff_blobs,
                   diff_grid=diff_grid)
    S = dp.pk.S
    traced = {"g": diff_g, "fog_k": diff_field, "blobs": diff_blobs,
              "grid": diff_grid}

    def render(params: dict, seed) -> torch.Tensor:
        for leaf, flag in traced.items():
            if (leaf in params) != flag:
                raise ValueError(
                    f"params must contain a {leaf!r} leaf iff the renderer "
                    f"traces it: build them with pack_params(scene, "
                    f"with_{'field' if leaf == 'fog_k' else leaf}=...)")
        pvec = _flatten(params, S).to(dev)
        if isinstance(seed, torch.Tensor):
            seed_t = seed.to(device=dev, dtype=torch.int32).reshape(1)
        else:
            seed_t = torch.tensor([int(seed)], dtype=torch.int32, device=dev)
        if diff_grid:
            vals = params["grid"]
            if tuple(vals.shape) != dp.pk.grid.dims:
                raise ValueError(f"a 'grid' leaf of shape {tuple(vals.shape)}"
                                 f"; the scene's grid is {dp.pk.grid.dims}")
            return _DiffRender.apply(pvec, seed_t, dp, vals.to(dev))
        return _DiffRender.apply(pvec, seed_t, dp)

    def make_shard(n_tiles: int):
        raise _todo("the shard-range variant of the pair (make_shard)", "8")

    render.make_shard = make_shard
    render.npix = dp.npix
    render.packed = dp
    return render
