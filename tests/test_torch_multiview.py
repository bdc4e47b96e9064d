"""The pair's HG phase and the multi-view trainer on their own: no vpt
kernel is compiled here (the traced pair against vpt is
tests/test_torch_hg_diff.py; the multi-view step is V such pairs).

  - the pair at a baked g = 0.5 against the render kernel's plain version
    at that g, and the traced g against the baked one: within 1e-5 of the
    image's scale (vpt's K2-vs-K1 bound; the traced form's f32 operations
    and true division against the folded constants are not bit-equal);
  - fixed-seed central differences (vpt's tests/test_hg.py:207-239, rtol
    3e-2): albedo and radiance under both HG modes; the g slot at
    max_bounces = 1, where a path ends at its first scatter, so the phase
    draw's score (exact only in expectation) folds to zero and dL/dg is
    the NEE phase value's pathwise term, exact per seed;
  - adam()'s per-leaf groups and schedules against optax.multi_transform
    and exponential_decay, fit_kernel taking a schedule;
  - _to_log / _from_log and the projection against vpt's on numpy inputs;
  - make_multiview_train_step: one view is make_kernel_train_step (vpt's
    test_single_view_step_is_kernel_step); two views average the per-view
    A/B losses at seeds seed * 2V + 2v and + 1;
  - fit_multiview: its relMSE weights, the Polyak tail, and a filter that
    frees only the medium.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vpt.dist.train as vpt_train
import vpt.dist.train_fast as vpt_tf

import vpt_torch
from vpt_torch.dist import train_fast as tf
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.camera import look_at

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

CAM = vpt_torch.default_camera()
CAM2 = look_at((35.0, 25.0, 190.0), (0.0, 0.0, -20.0))
W, H, SPP, MB, SEED = 16, 8, 4, 6, 3


def with_g(scene, g):
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))


HG = with_g(vpt_torch.cornell_vpt(), 0.5)
FOG = with_g(vpt_torch.SCENES["foggy_cornell"](), 0.5)


def _seed(s=SEED):
    return torch.tensor([s], dtype=torch.int32)


def _pvec(scene, **kw):
    return df._flatten(df.pack_params(scene, **kw), scene.count)


# ---- the HG pair ------------------------------------------------------------

@pytest.mark.parametrize("name,sampler", [("cornell_vpt", "random"),
                                          ("cornell_vpt", "ld"),
                                          ("foggy_cornell", "ld")])
def test_baked_g_pair_matches_render_kernel(name, sampler):
    scene = HG if name == "cornell_vpt" else FOG
    dp = df.pack_diff(scene, CAM, W, H, SPP, max_bounces=MB, sampler=sampler)
    assert dp.hg_mode == df.HG_BAKED and dp.entries[0].endswith("_hg")
    img = df.diff_fwd_plain(dp, _pvec(scene), _seed())
    ref = wf.render_tile_plain(dp.pk, _seed())
    iso = wf.render_tile_plain(df.pack_diff(
        with_g(scene, 0.0), CAM, W, H, SPP, max_bounces=MB,
        sampler=sampler).pk, _seed())
    scale = max(1.0, float(ref.abs().max()))
    assert torch.isfinite(img).all()
    assert float((img - ref).abs().max()) < 1e-5 * scale
    # the phase changes the image: not the isotropic one
    assert float((ref - iso).abs().max()) > 1e-3 * scale


@pytest.mark.parametrize("scene_name", ["cornell_vpt", "foggy_cornell"])
def test_traced_g_matches_baked_g(scene_name):
    scene = HG if scene_name == "cornell_vpt" else FOG
    baked = df.pack_diff(scene, CAM, W, H, SPP, max_bounces=MB, sampler="ld")
    traced = df.pack_diff(scene, CAM, W, H, SPP, max_bounces=MB,
                          sampler="ld", diff_g=True)
    assert traced.hg_mode == df.HG_TRACED and traced.P == baked.P + 1
    a = df.diff_fwd_plain(baked, _pvec(scene), _seed())
    b = df.diff_fwd_plain(traced, _pvec(scene, with_g=True), _seed())
    assert float((a - b).abs().max()) < 1e-5 * max(1.0, float(
        a.abs().max()))
    # the traced K3 adds the g slot and leaves the others within the same
    # bound of the baked K3's
    gbar = torch.full((baked.npix, 3), 1.0 / (3 * baked.npix))
    ga = df.diff_bwd_plain(baked, _pvec(scene), _seed(), gbar)
    gb = df.diff_bwd_plain(traced, _pvec(scene, with_g=True), _seed(), gbar)
    keep = [k for k in range(traced.P) if k != traced.IG]
    assert float((ga - gb[keep]).abs().max()) < 1e-5 * max(
        1.0, float(ga.abs().max()))
    assert float(gb[traced.IG]) != 0.0


def _fd_check(scene, dp, with_g_leaf, leaf, index, eps):
    params = df.pack_params(scene, with_g=with_g_leaf)
    S = scene.count
    gbar = torch.full((dp.npix, 3), 1.0 / (3 * dp.npix))
    g = df.unpack_params(df.diff_bwd_plain(dp, df._flatten(params, S),
                                           _seed(), gbar), S,
                         with_g=with_g_leaf)[leaf][index]

    def loss(e):
        p = {k: v.clone() for k, v in params.items()}
        p[leaf][index] += e
        img = df.diff_fwd_plain(dp, df._flatten(p, S), _seed())
        return float(img.double().mean())

    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    assert np.isfinite(float(g)) and np.isfinite(fd)
    assert np.isclose(float(g), fd, rtol=3e-2, atol=1e-7), (float(g), fd)
    return float(g)


@pytest.mark.parametrize("diff_g", [False, True], ids=["baked", "traced"])
@pytest.mark.parametrize("leaf,index,eps", [("radiance", (9, 1), 1e-2),
                                            ("albedo", (0, 0), 1e-3)])
def test_albedo_radiance_grads_exact_per_seed_with_hg(diff_g, leaf, index,
                                                      eps):
    dp = df.pack_diff(HG, CAM, W, H, 2, max_bounces=MB, sampler="random",
                      diff_g=diff_g)
    _fd_check(HG, dp, diff_g, leaf, index, eps)


@pytest.mark.parametrize("name,g", [("cornell_vpt", 0.5),
                                    ("cornell_vpt", -0.3),
                                    ("foggy_cornell", 0.5)])
def test_g_slot_exact_per_seed_at_one_bounce(name, g):
    scene = with_g(vpt_torch.SCENES[name](), g)
    dp = df.pack_diff(scene, CAM, W, H, SPP, max_bounces=1, sampler="ld",
                      diff_g=True)
    assert _fd_check(scene, dp, True, "g", (), 1e-2) != 0.0


# ---- the optimizer ----------------------------------------------------------

def _recover_all_rates():
    """examples/recover_all.py's material block (its round 0): sigma at a
    decaying rate, albedo at 2.5e-2, radiance frozen."""
    sched = tf.exponential_decay(1.5e-3, 25, 0.7)
    ours = {"sigma_a": sched, "sigma_s": sched, "albedo": 2.5e-2}
    labels = {"sigma_a": "sig", "sigma_s": "sig", "albedo": "alb",
              "radiance": "frozen"}
    theirs = optax.multi_transform(
        {"sig": optax.adam(optax.exponential_decay(1.5e-3, 25, 0.7)),
         "alb": optax.adam(2.5e-2), "frozen": optax.set_to_zero()}, labels)
    return ours, theirs


def test_per_leaf_adam_matches_optax_multi_transform():
    """60 updates on fixed random gradients: each group's rate follows its
    schedule, each leaf moves as optax moves it, the frozen leaf not at
    all."""
    ours_rates, opt = _recover_all_rates()
    start = df.pack_params(vpt_torch.cornell_vpt())
    params = {k: v.clone().requires_grad_() for k, v in start.items()}
    adam = tf.adam(params, ours_rates)
    assert len(adam.param_groups) == 3
    jp = {k: jnp.asarray(v.numpy()) for k, v in start.items()}
    state = opt.init(jp)
    rng = np.random.default_rng(0)
    sched = optax.exponential_decay(1.5e-3, 25, 0.7)
    for i in range(60):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in start.items()}
        for k, v in params.items():
            v.grad = torch.from_numpy(grads[k])
        tf._optimizer_step(adam)
        upd, state = opt.update({k: jnp.asarray(g) for k, g in grads.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        sig = adam.param_groups[0]
        assert sig["count"] == i + 1
        assert np.isclose(sig["lr"], float(sched(i)), rtol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert torch.equal(params["radiance"].detach(), start["radiance"])
    assert float((params["albedo"].detach() - start["albedo"]).abs().max()) \
        > 0.1


def test_adam_refuses_unknown_or_no_leaves():
    params = df.pack_params(vpt_torch.cornell_vpt())
    with pytest.raises(ValueError, match="leaves"):
        tf.adam(params, {"g": 1e-3})
    with pytest.raises(ValueError, match="frozen"):
        tf.adam(params, {"sigma_a": None})


def test_fit_kernel_follows_a_schedule():
    """fit_kernel takes an optax-style schedule (the port's torch.optim.Adam
    once raised on one): its steps are make_kernel_train_step's under
    adam(schedule), each update at the schedule's rate for its count."""
    scene = vpt_torch.cornell_vpt()
    pk = wf.pack_scene(scene, CAM, 8, 8, 16, max_bounces=4)
    target = wf.render_tile_plain(pk, _seed(99))
    sched = tf.exponential_decay(4e-3, 1, 0.25)
    wrong = dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, sigma_s=scene.medium.sigma_s * 2.78))
    fitted, losses = vpt_torch.dist.fit_kernel(
        wrong, CAM, target.reshape(8, 8, 3), steps=3, spp=4, max_bounces=4,
        learning_rate=sched, device="cpu")
    params = {k: v.requires_grad_() for k, v in df.pack_params(wrong).items()}
    adam = tf.adam(params, sched)
    step = tf.make_kernel_train_step(wrong, CAM, 8, 8, 4, adam,
                                     max_bounces=4, device="cpu")
    moved = []
    for i in range(3):
        before = float(params["sigma_s"].detach())
        assert float(step(params, target, i)) == losses[i]
        assert adam.param_groups[0]["lr"] == sched(i)
        moved.append(abs(float(params["sigma_s"].detach()) - before))
    for k, v in params.items():
        assert torch.equal(v.detach(), fitted[k]), k
    # Adam moves each entry by about its rate: 4e-3, then 1e-3, 2.5e-4
    assert moved[0] > 3 * moved[1] > 9 * moved[2] > 0


# ---- the multi-view trainer -------------------------------------------------

def test_log_leaves_and_projection_match_vpt():
    rng = np.random.default_rng(1)
    vals = {"sigma_a": np.float32(2e-9), "sigma_s": np.float32(0.036),
            "fog_k": np.float32(-1.0), "g": np.float32(0.99),
            "albedo": rng.uniform(-0.5, 1.5, (10, 3)).astype(np.float32),
            "radiance": rng.uniform(-2, 2, (10, 3)).astype(np.float32)}
    assert tf._LOG_LEAVES == vpt_tf._LOG_LEAVES
    ours = tf._to_log({k: torch.tensor(v) for k, v in vals.items()})
    theirs = vpt_tf._to_log({k: jnp.asarray(v) for k, v in vals.items()})
    for k in vals:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6, err_msg=k)
    back = tf._from_log(ours)
    back_v = vpt_tf._from_log(theirs)
    proj = tf.project_params({k: v.clone() for k, v in back.items()})
    proj_v = vpt_train.project_params(back_v)
    for k in vals:
        np.testing.assert_allclose(back[k].numpy(), np.asarray(back_v[k]),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(proj[k].numpy(), np.asarray(proj_v[k]),
                                   rtol=1e-6, err_msg=k)
    # the 1e-8 floor of the logs, and the projection's domain
    assert float(back["fog_k"]) == pytest.approx(1e-8, rel=1e-6)
    assert float(proj["g"]) == np.float32(0.95)


def _target(scene, cam, seed, spp=8):
    pk = wf.pack_scene(scene, cam, W, H, spp, max_bounces=MB)
    return wf.render_tile_plain(pk, _seed(seed))


def test_single_view_step_is_kernel_step():
    scene = vpt_torch.cornell_vpt()
    target = _target(scene, CAM, 40)
    p1 = {k: v.requires_grad_() for k, v in df.pack_params(scene).items()}
    pv = {k: v.detach().clone().requires_grad_() for k, v in p1.items()}
    s1 = tf.make_kernel_train_step(scene, CAM, W, H, SPP, tf.adam(p1, 1e-2),
                                   max_bounces=MB, device="cpu")
    sv = tf.make_multiview_train_step(scene, [CAM], W, H, SPP,
                                      tf.adam(pv, 1e-2), max_bounces=MB,
                                      device="cpu")
    for seed in (5, 6):
        assert float(s1(p1, target, seed)) == float(
            sv(pv, target[None], None, seed))
        for k in p1:
            assert torch.equal(p1[k].detach(), pv[k].detach()), k


def _view_losses(scene, cams, targets, params, seed, weights=None):
    """The A/B losses of each view at seeds seed * 2V + 2v and + 1, from
    the port's renderers."""
    V = len(cams)
    tot = 0.0
    for v, cam in enumerate(cams):
        r = df.make_diff_renderer(scene, cam, W, H, SPP // 2, max_bounces=MB,
                                  diff_g="g" in params,
                                  diff_field="fog_k" in params, device="cpu")
        with torch.no_grad():
            a = r(params, seed * 2 * V + 2 * v)
            b = r(params, seed * 2 * V + 2 * v + 1)
        e = (a - targets[v]) * (b - targets[v])
        if weights is not None:
            e = e * weights[v]
        tot = tot + torch.mean(e)
    return float(tot / V)


def test_two_view_loss_is_the_mean_of_the_view_losses():
    scene = vpt_torch.cornell_vpt()
    cams = [CAM, CAM2]
    targets = torch.stack([_target(scene, c, 40 + i)
                           for i, c in enumerate(cams)])
    params = {k: v.requires_grad_() for k, v in df.pack_params(scene).items()}
    expect = _view_losses(scene, cams, targets, params, 7)
    step = tf.make_multiview_train_step(scene, cams, W, H, SPP,
                                        tf.adam(params, 1e-3),
                                        max_bounces=MB, device="cpu")
    assert float(step(params, targets, None, 7)) == expect


def test_fit_multiview_weights_tail_and_filter():
    """fit_multiview on the fog at g = 0.5 with diff_g + diff_field and the
    materials frozen (examples/recover_fog_multiview.py at a toy size): the
    first loss is the relMSE-weighted mean of the view losses at the
    log-space round trip of the start; the tail is the mean of the last
    iterates; the filter keeps albedo and radiance; the medium moves."""
    cams = [CAM, CAM2]
    targets = [_target(FOG, c, 50 + i).reshape(H, W, 3)
               for i, c in enumerate(cams)]
    wrong = dataclasses.replace(FOG, medium=dataclasses.replace(
        FOG.medium, sigma_a=torch.tensor(0.010), sigma_s=torch.tensor(0.020),
        g=torch.tensor(0.0)))
    init = df.pack_params(wrong, with_g=True, with_field=True)
    seen = []

    def freeze_materials(p, p0):
        out = dict(p)
        for k in ("albedo", "radiance"):
            out[k] = p0[k]
        seen.append({k: v.clone() for k, v in out.items()})
        return out

    steps, tail = 3, 2
    params, losses = vpt_torch.dist.fit_multiview(
        wrong, cams, targets, steps=steps, spp=SPP, learning_rate=2.5e-3,
        max_bounces=MB, diff_g=True, diff_field=True, seed=3,
        param_filter=freeze_materials, polyak_tail=tail, device="cpu")
    assert len(losses) == steps and np.isfinite(losses).all()
    flat = torch.stack([t.reshape(-1, 3) for t in targets])
    weights = 1.0 / (flat.mean(-1, keepdim=True) + 0.05) ** 2
    start = tf._from_log(tf._to_log(init))
    assert losses[0] == pytest.approx(
        _view_losses(wrong, cams, flat, start, 3, weights), rel=1e-6)
    for k in ("albedo", "radiance"):
        assert torch.equal(params[k], init[k]), k
    for k in ("sigma_a", "sigma_s", "g", "fog_k"):
        assert float(params[k]) != float(init[k]), k
    # the tail: the mean of the last raw iterates, each the log round trip
    # of what the filter returned
    last = [tf._from_log(tf._to_log(s)) for s in seen[-tail:]]
    for k in params:
        assert torch.equal(params[k], sum(s[k] for s in last) / tail), k


def test_multiview_refuses_a_target_per_camera_mismatch():
    with pytest.raises(ValueError, match="one target image per camera"):
        vpt_torch.dist.fit_multiview(
            vpt_torch.cornell_vpt(), [CAM, CAM2], [np.zeros((H, W, 3))],
            steps=1, device="cpu")


@pytest.mark.parametrize("diff_g,with_g", [(True, False), (False, True)])
def test_renderer_checks_the_g_leaf(diff_g, with_g):
    """A params dict and a renderer that disagree on the traced g raise
    (vpt's "'g' leaf" ValueError): the g slot would shift every field
    slot after it."""
    render = df.make_diff_renderer(HG, CAM, 8, 4, 1, max_bounces=2,
                                   diff_g=diff_g, device="cpu")
    with pytest.raises(ValueError, match="'g' leaf"):
        render(df.pack_params(HG, with_g=with_g), 0)


def test_multiview_trainer_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "covers the kernels")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        tf.make_multiview_train_step(vpt_torch.cornell_vpt(), [CAM], W, H,
                                     SPP, None, device="cuda")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        vpt_torch.dist.fit_multiview(vpt_torch.cornell_vpt(), [CAM],
                                     [np.zeros((H, W, 3))], steps=1)
