"""vpt_torch.kernels.wavefront against vpt's fused render kernel.

The plain version (render_tile_plain) is held pixel by pixel against
vpt.kernels.wavefront.build_tile_renderer in interpret mode, at the same
seed, on scenes carried across with scene_to_dict -> scene_from_dict.

Criterion (tests/test_geom_kernel.py:79-83): rel = |a-b| / max(1, |ref|max)
and quantile(rel, 0.99) < 1e-4. The two round the same f32 operations in
the same order; XLA's and torch's transcendentals differ by an ulp on some
inputs, and a rare path flips a discrete event, which the quantile keeps
out of the bulk.

The vpt reference runs in a subprocess with XLA's CPU code generation
capped at AVX (no FMA instructions). The port, like its CUDA kernel
(nvcc --fmad=false), rounds every product and sum; XLA:CPU jit on an
FMA-capable host contracts a*b+c into FMA inside the interpret-mode
kernel. That moves pLight's visibility test against the radius-1e5 walls,
whose quadratic cancels to an error comparable to the 1.2e-4 visibility
slack, for ~4% of pixels (measured: q99 rel 1.7e-3 with FMA, 1.1e-7
without, 32x16x4 "random"). Nothing in vpt changes for it.

The subprocess also runs with XLA's Eigen thread pool off
(--xla_cpu_multi_thread_eigen=false): the differentiable pair's reference
of tests/test_torch_hetero_diff.py came out bit for bit the same with it
and took 26 % less CPU time (241 s against 326 s), CPU that the other
test files share. It runs with XLA:CPU's fusion emitters off
(--xla_cpu_use_fusion_emitters=false) too: every reference of the port's
test files came out with the same kernel outputs bit for bit (images,
gradient vectors, tangent planes, voxel gradients, updated parameters),
and only the means XLA reduces outside the kernels (a train step's loss,
an FD step's probe losses) moved, by an ulp (1.0e-7 relative for
tests/test_torch_diff.py's loss); its compiles took 35-60 % less CPU time
(the "random" pair 205 -> 134 CPU-s, tests/test_torch_geom.py's K4 315 ->
125 CPU-s, a field K4 96 -> 39 CPU-s of XLA compile).
tests/torch_reference_flags.py re-checks it: it runs each reference
without and with the flag and compares their outputs.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import vpt
from vpt.kernels.wavefront import _scene_consts
from vpt.scene.io import scene_to_dict

import vpt_torch
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q99_TOL = 1e-4

# The plain versions run thousands of small torch ops per iteration. Beside
# other pytest-xdist workers, torch's intra-op thread pool oversubscribes
# the CPU and its threads spin: on an 8-core host one plain scatter render
# took 11 s with 8 threads alone, 294 s with six such processes at once,
# and 2.9 s with one thread either way. The port's test modules run torch
# on one thread.
torch.set_num_threads(1)

# renders vpt's kernel for a list of jobs (JSON) into an .npz
_JAX_REF = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
from vpt.api.config import RenderConfig
from vpt.kernels.wavefront import build_tile_renderer, render_pallas
from vpt.scene.io import scene_from_dict
with open(sys.argv[1]) as f:
    jobs = json.load(f)
out = {}
for i, job in enumerate(jobs):
    kind = job.pop("kind", None)
    scene, cam = scene_from_dict(job.pop("scene"))
    if kind == "adaptive":
        from vpt.api.adaptive import render_adaptive
        img = render_adaptive(scene, cam, RenderConfig(**job.pop("cfg")),
                              interpret=True, **job)
    elif kind == "noise":
        from vpt.api.noise import render_to_noise
        img, spp, se = render_to_noise(scene, cam,
                                       RenderConfig(**job.pop("cfg")),
                                       interpret=True, **job)
        out[f"{i}_meta"] = np.asarray([spp, se], np.float64)
    elif "cfg" in job:
        img = render_pallas(scene, cam, RenderConfig(**job["cfg"]),
                            interpret=True)
    else:
        seed = job.pop("seed")
        img = build_tile_renderer(scene, cam, tile_rows=8, interpret=True,
                                  **job)(seed)
    out[str(i)] = np.asarray(img)
np.savez(sys.argv[2], **out)
"""


def lowest_priority() -> None:
    """preexec_fn of the port tests' vpt reference subprocesses and host
    builds: the lowest CPU priority, so that under pytest-xdist they run in
    the gaps the other workers' tests leave rather than stretch the longest
    of them (vpt's tests/test_diff_kernel.py). A process at this priority
    can wait long for a core, so its wall-clock limit is the suite's
    (REFERENCE_TIMEOUT_S), not a guess at its own time."""
    os.nice(19)


# the wall-clock limit of a reference subprocess or host build at
# lowest_priority: the tier-1 suite's own limit
REFERENCE_TIMEOUT_S = 1470


def reference_env() -> dict:
    """The environment of a vpt reference subprocess (see the module
    docstring): XLA:CPU, code generation capped at AVX, no Eigen pool, no
    fusion emitters."""
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX"
                           + " --xla_cpu_multi_thread_eigen=false"
                           + " --xla_cpu_use_fusion_emitters=false").strip())


def jax_reference(jobs, full=False):
    """Run vpt's render kernel (interpret mode, XLA:CPU without FMA) for
    each job in a subprocess; returns the list of numpy outputs (full: the
    dict of every array, with the noise jobs' "<i>_meta" [spp, SE])."""
    with tempfile.TemporaryDirectory() as tmp:
        spec, out = os.path.join(tmp, "jobs.json"), os.path.join(tmp, "o.npz")
        with open(spec, "w") as f:
            json.dump(jobs, f)
        res = subprocess.run([sys.executable, "-c", _JAX_REF, spec, out],
                             cwd=REPO, env=reference_env(), capture_output=True,
                             text=True, timeout=REFERENCE_TIMEOUT_S,
                             preexec_fn=lowest_priority)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(out) as z:
            if full:
                return {k: z[k] for k in z.files}
            return [z[str(i)] for i in range(len(jobs))]


def q99_rel(a, ref):
    rel = np.abs(np.asarray(a) - ref) / max(1.0, float(np.abs(ref).max()))
    return float(np.quantile(rel, 0.99))


W, H, SPP, MB, SEED = 32, 16, 4, 8, 3
# (scene, sampler, jitter): the main-path scene under both samplers, an open
# scene (rays that miss everything, point lights only, no MIS lights) and
# cornell_vpt with a glass sphere (no built-in scene has a dielectric)
CASES = [("cornell_vpt", "random", True), ("cornell_vpt", "ld", True),
         ("one_primitive_infinite", "ld", False),
         ("cornell_glass", "random", True)]


def _scene_dict(name):
    if name == "cornell_glass":
        d = scene_to_dict(vpt.cornell_vpt(), vpt.default_camera())
        d["spheres"][6]["material"] = 2        # the blue sphere -> glass
        return d
    return scene_to_dict(vpt.SCENES[name](), vpt.default_camera())


@pytest.fixture(scope="module")
def vpt_images():
    jobs = [dict(scene=_scene_dict(name), width=W, height=H, spp=SPP,
                 max_bounces=MB, sampler=sampler, jitter=jitter, seed=SEED)
            for name, sampler, jitter in CASES]
    return dict(zip(CASES, jax_reference(jobs)))


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_plain_matches_vpt_kernel(vpt_images, case):
    name, sampler, jitter = case
    ref = vpt_images[case]
    pk = wf.pack_scene(*scene_from_dict(_scene_dict(name)), W, H, SPP,
                       max_bounces=MB, sampler=sampler, jitter=jitter)
    out = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    assert out.shape == (W * H, 3) and out.dtype == torch.float32
    out = out.numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    assert ref.shape == out.shape
    assert q99_rel(out, ref) < Q99_TOL, q99_rel(out, ref)


HOMOGENEOUS = ["cornell_vpt", "sigma_comparison", "light_near_camera",
               "near_point_area_sources", "one_primitive_infinite",
               "simple_cornell"]


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_pack_scene_matches_scene_consts(name):
    """pack_scene holds the values vpt bakes into its kernel
    (_scene_consts), rounded to f32, and folds r*r and the intersection
    epsilon in float64 as vpt's sphere_first_t does."""
    sc = _scene_consts(vpt.SCENES[name]())
    pk = wf.pack_scene(*scene_from_dict(_scene_dict(name)), 8, 4, 2)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    for key in ("r", "c", "alb", "rad", "eta", "kap", "alpha"):
        assert np.array_equal(f32(getattr(pk, key)), f32(sc[key])), key
    assert pk.mat == sc["mat"]
    assert pk.emitters == sc["emitters"]
    assert pk.mis_lights == sc["mis_lights"]
    assert sc["vol"] == pk.vol == () and sc["field"] is None
    assert sc["g"] == pk.g == 0.0
    assert (pk.sigma_a, pk.sigma_s) == (float(f32(sc["sigma_a"])),
                                        float(f32(sc["sigma_s"])))
    r = np.asarray(sc["r"], np.float64)
    assert np.array_equal(f32(pk.r2), f32(r * r))
    assert np.array_equal(f32(pk.eps), f32(1e-4 + 16.0 * 2.0**-23 * r))
    sigma_t = sc["sigma_a"] + sc["sigma_s"]
    assert pk.inv_sigma_t == float(f32(1.0 / sigma_t))
    words = pk.words()
    # 411 words of scene, camera and estimator, then csrc/path.cuh's
    # FieldParams (184 words) and GridParams (21 words), zero in a
    # homogeneous medium
    assert words.dtype == np.int32 and words.size == 411 + 184 + 21
    assert not words[411:].any()
    assert list(words[:5]) == [8, 4, 2, 32, 2 * 32 + 64]


def test_pack_scene_refuses_what_the_kernel_lacks():
    """What pack_scene refuses now that the kernel renders material-3
    shells and HG g (both pack, as vpt bakes them: the shell list, g
    snapped to 0 at |g| <= 1e-3 and the HG constants folded in float64)."""
    with pytest.raises(ValueError, match="sampler"):
        wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                      8, 4, 2, sampler="sobol")
    with pytest.raises(ValueError, match="distance"):
        wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                      8, 4, 2, distance="delta")
    many = vpt_torch.make_scene(
        list(vpt_torch.scene.scene.CORNELL_VPT_SPHERES) * 2)
    with pytest.raises(ValueError, match="at most"):
        wf.pack_scene(many, vpt_torch.default_camera(), 8, 4, 2)
    shell = wf.pack_scene(vpt_torch.scene.scene.medium_shell(),
                          vpt_torch.default_camera(), 8, 4, 2)
    assert shell.vol == _scene_consts(vpt.SCENES["medium_shell"]())["vol"]
    assert shell.vol and shell.words().size == 411 + 184 + 21
    for g in (0.5, -0.3, 5e-4):
        d = _scene_dict("cornell_vpt")
        d["g"] = g
        pk = wf.pack_scene(*scene_from_dict(d), 8, 4, 2)
        g_vpt = _scene_consts(vpt.scene.io.scene_from_dict(d)[0])["g"]
        assert pk.g == float(np.float32(g_vpt))
        if g_vpt == 0.0:
            assert pk.hg_2g == pk.hg_inv2g == 0.0
            continue
        want = (1.0 + g_vpt * g_vpt, 2.0 * g_vpt,
                (1.0 / (4.0 * np.pi)) * (1.0 - g_vpt * g_vpt),
                1.0 - g_vpt * g_vpt, 1.0 - g_vpt, 1.0 / (2.0 * g_vpt))
        got = (pk.hg_1pg2, pk.hg_2g, pk.hg_phase, pk.hg_1mg2, pk.hg_1mg,
               pk.hg_inv2g)
        assert got == tuple(float(np.float32(w)) for w in want)


def test_plain_deterministic_and_seed_sensitive():
    pk = wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                       16, 8, 4, max_bounces=6)
    a = wf.render_tile_plain(pk, torch.tensor([3], dtype=torch.int32))
    b = wf.render_tile_plain(pk, torch.tensor([3], dtype=torch.int32))
    c = wf.render_tile_plain(pk, torch.tensor([4], dtype=torch.int32))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_render_tile_on_cpu_runs_the_plain_version():
    pk = wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                       8, 4, 2, max_bounces=4, sampler="ld")
    seed = torch.tensor([5], dtype=torch.int32)
    before = wf.LAUNCHES
    out = wf.render_tile(pk, seed)
    assert wf.LAUNCHES == before          # no kernel launch on the CPU
    assert torch.equal(out, wf.render_tile_plain(pk, seed))
    for bad in (torch.tensor([5]), torch.tensor([[5]], dtype=torch.int32),
                torch.tensor([5, 6], dtype=torch.int32)):
        with pytest.raises(ValueError, match="seed"):
            wf.render_tile(pk, bad)
