"""vpt_torch's public API against vpt's: render, the CLI, scene files,
camera and config, and what the port refuses.

render(device="cpu") is held against vpt's render_pallas (interpret mode)
with the criterion and the FMA-free reference run of
tests/test_torch_wavefront.py: quantile(|a-b| / max(1, |ref|max), 0.99)
< 1e-4.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vpt
import vpt.io.ppm as vpt_ppm
import vpt.kernels.wavefront as vpt_wf
import vpt.media.density as vpt_density
from vpt.core.vecmath import to_display_value as vpt_to_display_value
from vpt.scene.io import scene_from_dict as vpt_scene_from_dict
from vpt.scene.io import scene_to_dict as vpt_scene_to_dict

import vpt_torch
import vpt_torch.io.ppm as torch_ppm
from vpt_torch import cli
from vpt_torch.core.vecmath import to_display_value
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene import scene as tscene
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

from test_torch_wavefront import jax_reference, q99_rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOMOGENEOUS = ["cornell_vpt", "sigma_comparison", "light_near_camera",
               "near_point_area_sources", "one_primitive_infinite",
               "simple_cornell", "medium_shell"]


def test_render_cpu_matches_vpt_render_pallas():
    fields = dict(width=24, height=16, spp=4, max_bounces=6, sampler="ld",
                  seed=5, integrator="iterative_vpt_free")
    (ref,) = jax_reference([dict(
        scene=vpt_scene_to_dict(vpt.cornell_vpt(), vpt.default_camera()),
        cfg=fields)])
    img = vpt_torch.render(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                           vpt_torch.RenderConfig(**fields), device="cpu")
    assert img.shape == (16, 24, 3) == ref.shape
    assert img.dtype == torch.float32 and img.device.type == "cpu"
    img = img.numpy()
    assert q99_rel(img, ref) < 1e-4, q99_rel(img, ref)
    # the criterion sees orientation: the image flipped upside down fails it
    assert q99_rel(img[::-1], ref) > 1e-2


def test_cli_writes_the_ppm_vpt_writes(tmp_path):
    args = ["--width", "16", "--height", "8", "--spp", "2", "--max-bounces",
            "4", "--sampler", "ld", "--seed", "7", "--device", "cpu"]
    out = tmp_path / "cli.ppm"
    assert cli.main(args + ["-o", str(out)]) == 0
    cfg = vpt_torch.RenderConfig(width=16, height=8, spp=2, max_bounces=4,
                                 sampler="ld", seed=7)
    img = vpt_torch.render(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                           cfg, device="cpu").numpy()
    ref = tmp_path / "vpt.ppm"
    vpt_ppm.write_ppm(str(ref), img)
    assert out.read_bytes() == ref.read_bytes()
    assert np.array_equal(torch_ppm.read_ppm(str(out)),
                          vpt_ppm.read_ppm(str(ref)))
    # a dumped scene file renders the same image
    scene_file = tmp_path / "scene.json"
    assert cli.main(["--dump-scene", str(scene_file)]) == 0
    out2 = tmp_path / "file.ppm"
    assert cli.main(args + ["--scene-file", str(scene_file),
                            "-o", str(out2)]) == 0
    assert out2.read_bytes() == out.read_bytes()


def test_cli_takes_vpt_chunk_pixels(tmp_path, monkeypatch):
    """A vpt command line with --chunk-pixels parses as vpt's does, reaches
    RenderConfig.chunk_pixels, and renders the image it renders without
    the flag (the kernel ignores it)."""
    import vpt.cli as vpt_cli

    argv = ["4", "--width", "16", "--height", "8", "--max-bounces", "4",
            "--seed", "7", "--chunk-pixels", "4096"]
    theirs = vpt_cli.build_parser().parse_args(argv)
    ours = cli.build_parser().parse_args(argv)
    assert ours.chunk_pixels == theirs.chunk_pixels == 4096
    seen = []
    real = vpt_torch.render

    def spy(scene, camera, cfg, **kw):
        seen.append(cfg)
        return real(scene, camera, cfg, **kw)

    monkeypatch.setattr(vpt_torch, "render", spy)
    out, plain = tmp_path / "chunk.ppm", tmp_path / "plain.ppm"
    assert cli.main(argv + ["--device", "cpu", "-o", str(out)]) == 0
    assert cli.main(argv[:-2] + ["--device", "cpu", "-o", str(plain)]) == 0
    assert [c.chunk_pixels for c in seen] == [4096, 65536]
    assert out.read_bytes() == plain.read_bytes()


def test_cli_equiangular_hg_writes_the_ppm_vpt_writes(tmp_path):
    args = ["--width", "16", "--height", "8", "--spp", "2", "--max-bounces",
            "4", "--seed", "5", "--integrator", "explicit_equiangular",
            "--hg-g", "0.5", "--device", "cpu"]
    out = tmp_path / "ea.ppm"
    assert cli.main(args + ["-o", str(out)]) == 0
    scene = vpt_torch.make_scene(list(tscene.CORNELL_VPT_SPHERES), g=0.5)
    cfg = vpt_torch.RenderConfig(width=16, height=8, spp=2, max_bounces=4,
                                 seed=5, integrator="explicit_equiangular")
    img = vpt_torch.render(scene, vpt_torch.default_camera(), cfg,
                           device="cpu").numpy()
    ref = tmp_path / "vpt.ppm"
    vpt_ppm.write_ppm(str(ref), img)
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("name", ["foggy_cornell", "blob_cloud"])
def test_cli_renders_a_density_scene(tmp_path, name):
    """--scene foggy_cornell / blob_cloud keep their field through the
    CLI's medium flags and write the PPM vpt_torch.render gives (K1's
    field instantiation on a card, its plain version here)."""
    args = ["--scene", name, "--width", "12", "--height", "8", "--spp",
            "2", "--max-bounces", "4", "--seed", "3", "--device", "cpu"]
    out = tmp_path / "cli.ppm"
    assert cli.main(args + ["-o", str(out)]) == 0
    scene = vpt_torch.SCENES[name]()
    cfg = vpt_torch.RenderConfig(width=12, height=8, spp=2, max_bounces=4,
                                 seed=3)
    img = vpt_torch.render(scene, vpt_torch.default_camera(), cfg,
                           device="cpu").numpy()
    ref = tmp_path / "ref.ppm"
    vpt_ppm.write_ppm(str(ref), img)
    assert out.read_bytes() == ref.read_bytes()
    pk = wf.pack_config(scene, vpt_torch.default_camera(), cfg)
    assert pk.field is not None and pk.field.kind == \
        scene.medium.density.kind


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_scene_dict_round_trip(name):
    """vpt's scene_to_dict -> the port's scene_from_dict rebuilds the same
    f32 values, the port's built-in scenes equal vpt's, and the port's
    dicts read back into vpt unchanged."""
    d_vpt = vpt_scene_to_dict(vpt.SCENES[name](), vpt.default_camera())
    scene, cam = scene_from_dict(d_vpt)
    assert scene_to_dict(scene, cam) == d_vpt
    assert scene_to_dict(vpt_torch.SCENES[name](),
                         vpt_torch.default_camera()) == d_vpt
    s2, c2 = vpt_scene_from_dict(scene_to_dict(scene, cam))
    assert vpt_scene_to_dict(s2, c2) == d_vpt
    assert scene.emitter_idx == s2.emitter_idx
    assert scene.mis_light_idx == s2.mis_light_idx
    assert scene.point_idx == s2.point_idx


def test_default_camera_and_config_match_vpt():
    a, b = vpt_torch.default_camera(), vpt.default_camera()
    for f in ("origin", "direction", "fov_scale"):
        assert np.array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    ours = {f.name: f.default for f in dataclasses.fields(vpt_torch.RenderConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(vpt.RenderConfig)}
    assert ours == theirs
    assert vpt_torch.RenderConfig(renderer="pallas").renderer == "kernel"
    x = torch.linspace(-0.5, 2.0, 101)
    assert np.array_equal(to_display_value(x).numpy(),
                          np.asarray(vpt_to_display_value(x.numpy())))


def test_render_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "covers the kernel")
    cfg = vpt_torch.RenderConfig(width=8, height=4, spp=1)
    with pytest.raises(RuntimeError, match="cuda"):
        vpt_torch.render(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                         cfg, device="cuda")


def _render(scene=None, **cfg):
    return vpt_torch.render(scene or vpt_torch.cornell_vpt(),
                            vpt_torch.default_camera(),
                            vpt_torch.RenderConfig(width=8, height=4, spp=1,
                                                   **cfg), device="cpu")


# vpt's reason for refusing K4's tangent planes in a voxel grid
GRID_DUAL = "the geometric DUAL planes would need dual trilinear gathers"


UNSUPPORTED = {
    "engine_integrator": lambda: _render(integrator="vpt3"),
    "engine_equiangular_physical": lambda: _render(
        integrator="implicit_equiangular_physical"),
    "adaptive_engine_integrator": lambda: vpt_torch.render_adaptive(
        vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
        vpt_torch.RenderConfig(width=8, height=4, spp=2,
                               integrator="surface_pt"), device="cpu"),
    "noise_engine_integrator": lambda: vpt_torch.render_to_noise(
        vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
        vpt_torch.RenderConfig(width=8, height=4, spp=2,
                               integrator="vpt3"), device="cpu"),
    # --sharded renders on the kernel (tests/test_torch_dist.py); vpt's
    # engine integrators stay refused on it
    "cli_sharded": lambda: cli.main(["--sharded", "--device", "cpu",
                                     "--integrator", "vpt3"]),
    "cli_checkpoint": lambda: cli.main(["--checkpoint", "ck.npz",
                                        "--device", "cpu"]),
    "float64": lambda: _render(dtype="float64"),
    "renderer_persistent": lambda: vpt_torch.RenderConfig(renderer="persistent"),
    "renderer_scan": lambda: vpt_torch.RenderConfig(renderer="scan"),
    # the density fields render in K1 (tests/test_torch_hetero.py,
    # test_torch_grid.py) and in the dual kernel (test_torch_geom_field.py),
    # a voxel grid there only in the primal_only mode: packing the dual
    # kernel with a tangent plane in a grid is refused with vpt's reason, on
    # foggy_cornell's and blob_cloud's spheres and for a grid loaded from
    # vpt's scene file
    "foggy_cornell": (lambda: gm.pack_geom(
        _in_grid(tscene.foggy_cornell()), vpt_torch.default_camera(), 8, 4,
        1, sphere=8), GRID_DUAL),
    "blob_cloud": (lambda: gm.pack_geom(
        _in_grid(tscene.blob_cloud()), vpt_torch.default_camera(), 8, 4, 1,
        sphere=2, cam_grads=False), GRID_DUAL),
    "density_file": (lambda: gm.pack_geom(scene_from_dict(vpt_scene_to_dict(
        dataclasses.replace(vpt.cornell_vpt(), medium=dataclasses.replace(
            vpt.cornell_vpt().medium, density=vpt_density.grid(
                np.ones((2, 2, 2)), (0, 0, 0), (1, 1, 1))))))[0],
        vpt_torch.default_camera(), 8, 4, 1, sphere=None), GRID_DUAL),
}


def _in_grid(scene):
    """The scene in a 2^3 voxel grid."""
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, density=vpt_torch.media.density.grid(
            np.ones((2, 2, 2)), (0, 0, 0), (1, 1, 1))))


@pytest.mark.parametrize("integrator", sorted(wf.KERNEL_INTEGRATORS))
def test_render_dispatches_every_kernel_integrator(integrator):
    """render(device="cpu") is the plain kernel with vpt's
    PALLAS_INTEGRATORS flags for the name; the names are vpt's."""
    assert wf.KERNEL_INTEGRATORS == vpt_wf.PALLAS_INTEGRATORS
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    scene = vpt_torch.make_scene(list(tscene.CORNELL_VPT_SPHERES), g=0.4)
    img = _render(scene, integrator=integrator, max_bounces=5, seed=2,
                  sampler="ld")
    pk = wf.pack_scene(scene, vpt_torch.default_camera(), 8, 4, 1,
                       max_bounces=5, sampler="ld", nee=nee,
                       distance=distance, physical=physical)
    want = wf.render_tile_plain(pk, torch.tensor([2], dtype=torch.int32))
    assert torch.equal(img, want.reshape(4, 8, 3))


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_raises_not_implemented(case):
    make, match = (UNSUPPORTED[case] if isinstance(UNSUPPORTED[case], tuple)
                   else (UNSUPPORTED[case], "ROADMAP Queue 1 item"))
    with pytest.raises(NotImplementedError, match=match):
        make()


def test_port_imports_no_jax():
    code = ("import sys, vpt_torch, vpt_torch.cli, vpt_torch.kernels._build, "
            "vpt_torch.api.adaptive, vpt_torch.api.noise, "
            "vpt_torch.kernels.wavefront, vpt_torch.kernels.diff, "
            "vpt_torch.kernels.dual, vpt_torch.kernels.geom, "
            "vpt_torch.dist, vpt_torch.dist.train_fast, vpt_torch.io.ppm, "
            "vpt_torch.core.vecmath, vpt_torch.media, "
            "vpt_torch.media.density; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'vpt' not in sys.modules, 'vpt imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
