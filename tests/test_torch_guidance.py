"""The guided slice of the port against lvd_tpu on the CPU.

Inputs come from numpy seeds (fp32). The energy's pieces (the top-k means
and ``ca_energy_for_key`` under every knob) are held to lvd_tpu in value and
gradient within 1e-5 of max|ref|; the guidance pack exactly; the
certificate's metrics within 1e-5; the tiny UNet's captured maps and one
guided update (energy and d/dlatents) within 1e-4; the seeded initial noise
to jax.random.normal within 1e-6 (absolute). Each lvd_tpu reference is
compiled once: where two port variants compute the same function
(``capture_only``, ``energy_remat``) both are held to it. The whole guided
pipeline is in test_torch_guided_pipeline.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.diffusion import guidance as jg
from lvd_tpu.layout import rasterize as jr
from lvd_tpu_torch.diffusion import guidance as tg
from lvd_tpu_torch.layout import rasterize as tr

KEYS = tuple(tuple(k) for k in tg.OVERALL_GUIDANCE_ATTN_KEYS)
FLAGSHIP = dict(loss_scale=2.5, loss_threshold=350.0, max_iter=1, max_index_step=10,
                fg_top_p=0.25, bg_top_p=0.25, fg_weight=1.0, bg_weight=2.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_rel(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def _moving_boxes(frames, n_obj=2):
    move = lambda f: 0.5 * f / max(frames - 1, 1)
    boxes = [[[0.05 + move(f), 0.25, 0.4 + move(f), 0.8] for f in range(frames)]]
    if n_obj > 1:
        boxes.append([[0.55, 0.1, 0.95, 0.6] if f != 1 else [0.0, 0.0, 0.0, 0.0]
                      for f in range(frames)])
    return boxes


def test_seeded_noise_matches_jax_random_normal():
    from lvd_tpu_torch.utils import prng

    for seed, shape in [(0, (1, 24, 40, 72, 4)), (1, (1, 8, 8, 12, 4)), (123456, (3, 7)),
                        (2 ** 31 - 1, (5,))]:
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
        got = prng.normal(seed, shape)
        assert got.dtype == np.float32 and got.shape == shape
        assert np.abs(got - want).max() <= 1e-6
        np.testing.assert_array_equal(
            prng.random_bits(prng.prng_key(seed), shape),
            np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)))


def test_pipeline_draws_its_noise_like_lvd_tpu(tiny, monkeypatch):
    """Without ``latents``, the pipeline starts from lvd_tpu's noise."""
    from lvd_tpu_torch.diffusion import sampler as t_sampler
    from lvd_tpu_torch.models.loader import params_from_numpy
    from lvd_tpu_torch.pipeline import PipelineModels, TextToVideoPipeline
    from lvd_tpu_torch.text.tokenizer import load_tokenizer

    jm = tiny["jm"]
    bridge = lambda t: params_from_numpy(jax.device_get(t), "cpu")
    pipe = TextToVideoPipeline(PipelineModels(tiny_preset(jm), tiny["tparams"],
                                              bridge(jm.clip_params), bridge(jm.vae_params),
                                              load_tokenizer(None)),
                               dtype=torch.float32, device="cpu")
    seen = []
    monkeypatch.setattr(t_sampler, "sample_video",
                        lambda params, cfg, latents, *a, **k: seen.append(latents) or latents)
    for seed in (0, 7):
        pipe("a red ball", num_frames=4, num_inference_steps=2, seed=seed,
             output_type="latent")
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, 8, 12, 4)))
        assert np.abs(seen[-1].numpy() - want).max() <= 1e-6


# ---------------------------------------------------------------------------
# The energy's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_max", [9, None])
def test_topk_means_value_and_grad(k_max):
    rng = np.random.default_rng(3)
    vals = rng.random((3, 4, 20)).astype(np.float32)
    vals[0, 0, :5] = 0.0  # ties at zero, as masked products have
    k = rng.integers(1, 9, size=(3, 4)).astype(np.int32)
    ct = rng.standard_normal((3, 4)).astype(np.float32)
    for jfn, tfn in [
        (lambda v: jg._topk_mean_desc(v, jnp.asarray(k), k_max),
         lambda v: tg._topk_mean_desc(v, torch.from_numpy(k), k_max)),
        (lambda v: jg._topk_mean_via_log(jnp.clip(v, 0.05, None), jnp.asarray(k), 0.05, k_max),
         lambda v: tg._topk_mean_via_log(torch.clamp(v, min=0.05), torch.from_numpy(k), 0.05,
                                         k_max)),
    ]:
        out_j, vjp = jax.vjp(jfn, jnp.asarray(vals))
        (g_j,) = vjp(jnp.asarray(ct))
        v_t = torch.from_numpy(vals).requires_grad_(True)
        out_t = tfn(v_t)
        out_t.backward(torch.from_numpy(ct))
        _close_rel(out_t.detach().numpy(), out_j, 1e-5)
        _close_rel(v_t.grad.numpy(), g_j, 1e-5)


def test_make_guidance_pack_is_exact():
    for up in (1, 2):
        args = (_moving_boxes(6), [[2, 3], [5]], KEYS, (40, 72))
        want = jr.make_guidance_pack(*args, fg_top_p=0.25, bg_top_p=0.3, upsample_scale=up)
        got = tr.make_guidance_pack(*args, fg_top_p=0.25, bg_top_p=0.3, upsample_scale=up)
        for field in ("masks", "k_fg", "k_bg"):
            for key in KEYS:
                np.testing.assert_array_equal(getattr(got, field)[key],
                                              getattr(want, field)[key])
        np.testing.assert_array_equal(got.token_indices, want.token_indices)
        np.testing.assert_array_equal(got.token_mask, want.token_mask)
        assert got.num_objects == want.num_objects
    assert tr.resolution_of_key(("up", 1, 0, 0), (40, 72)) == (10, 18)
    assert tr.scale_proportion([0.1, 0.2, 0.55, 0.9], 40, 72) == jr.scale_proportion(
        [0.1, 0.2, 0.55, 0.9], 40, 72)
    np.testing.assert_array_equal(tr.boxes_to_masks(_moving_boxes(3), 5, 9),
                                  jr.boxes_to_masks(_moving_boxes(3), 5, 9))


ENERGY_KNOBS = {
    "max_based": {},
    "flagship": FLAGSHIP,
    "ratio": {"use_ratio_based_loss": True},
    "ce_nll": {"use_max_based_loss": False},
    "attn_sync": {"attn_sync_weight": 0.7},
    "boxdiff": {"boxdiff_loss_scale": 0.5},
    "boxdiff_L2_unnormed": {"boxdiff_loss_scale": 0.5, "boxdiff_L": 2, "boxdiff_normed": False},
    "com": {"com_loss_scale": 0.3},
    "attn_renorm": {"attn_renorm": True, "renorm_num_tokens": 7},
    "upsample_bilinear": {"upsample_scale": 2},
    "upsample_nearest": {"upsample_scale": 2, "upsample_mode": "nearest"},
    "smooth_attn": {"smooth_attn": True},
    "everything": {"attn_sync_weight": 0.2, "boxdiff_loss_scale": 0.3, "com_loss_scale": 0.1,
                   "attn_renorm": True, "renorm_num_tokens": 9, "smooth_attn": True,
                   "upsample_scale": 2},
}


@pytest.mark.parametrize("knob", sorted(ENERGY_KNOBS))
def test_ca_energy_for_key_value_and_grad(knob):
    overrides = ENERGY_KNOBS[knob]
    rng = np.random.default_rng(sorted(ENERGY_KNOBS).index(knob))
    f, heads, hh, ww, n_l = 5, 2, 6, 8, 16
    logits = rng.standard_normal((f, heads, hh * ww, n_l)).astype(np.float32) * 2.0
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    up = overrides.get("upsample_scale", 1)
    fg_p = overrides.get("fg_top_p", 0.75)
    pack = tr.make_guidance_pack(_moving_boxes(f), [[2, 3], [5]], [("down", 1, 0, 0)],
                                 (2 * hh, 2 * ww), fg_top_p=fg_p, bg_top_p=fg_p,
                                 upsample_scale=up)
    key = ("down", 1, 0, 0)
    cfg_j = dataclasses.replace(jg.GuidanceConfig(), **overrides)
    cfg_t = dataclasses.replace(tg.GuidanceConfig(), **overrides)
    inputs = (pack.masks[key], pack.token_indices, pack.token_mask, pack.k_fg[key],
              pack.k_bg[key])
    val_j, grad_j = jax.value_and_grad(
        lambda a: jg.ca_energy_for_key(a, *map(jnp.asarray, inputs), cfg_j))(jnp.asarray(attn))
    a_t = torch.from_numpy(attn).requires_grad_(True)
    t_in = [torch.from_numpy(np.asarray(x)) for x in inputs]
    t_in[1] = t_in[1].long()
    val_t = tg.ca_energy_for_key(a_t, *t_in, cfg_t)
    val_t.backward()
    _close_rel(val_t.detach().numpy(), val_j, 1e-5)
    _close_rel(a_t.grad.numpy(), grad_j, 1e-5)


# ---------------------------------------------------------------------------
# The tiny UNet, one guided update, the certificate and the pipeline
# ---------------------------------------------------------------------------


def tiny_preset(jm):
    from lvd_tpu_torch import config as tcfg

    p = jm.preset
    return tcfg.ModelPreset(
        name="tiny", unet=tcfg.tiny_unet_config(), clip=tcfg.tiny_clip_config(),
        vae=tcfg.tiny_vae_config(), scheduler=tcfg.SchedulerConfig(), height=p.height,
        width=p.width, default_num_frames=p.default_num_frames, base_attn_dim=p.base_attn_dim)


@pytest.fixture(scope="module")
def tiny():
    from lvd_tpu import config as jcfg
    from lvd_tpu.diffusion import dpm_solver as jdpm
    from lvd_tpu.models.loader import tiny_pipeline_models
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.diffusion import sampler as t_sampler
    from lvd_tpu_torch.models.loader import params_from_numpy

    jm = tiny_pipeline_models()
    rng = np.random.default_rng(5)
    frames = 4
    lat = rng.standard_normal((1, frames, 8, 12, 4)).astype(np.float32)
    text = (rng.standard_normal((1, 16, 64)) * 0.3).astype(np.float32)
    pack = tr.make_guidance_pack(_moving_boxes(frames, 1), [[2]], KEYS, (8, 12), 0.25, 0.25)
    coeffs = jdpm.make_coeffs(jcfg.SchedulerConfig(), 6)
    return {
        "jm": jm, "jcfg": jcfg.tiny_unet_config(), "tcfg": tcfg.tiny_unet_config(),
        "tparams": params_from_numpy(jax.device_get(jm.unet_params), "cpu"),
        "lat": lat, "text": text, "pack": pack, "t": int(coeffs.timestep[0]),
        "s1ma": float(coeffs.sqrt_one_minus_abar[0]),
        "tpack": t_sampler.pack_to_tensors(pack, "cpu"),
    }


@pytest.fixture(scope="module")
def jax_capture(tiny):
    from lvd_tpu.models.unet3d import apply_unet3d as junet

    fn = jax.jit(lambda p, s, c: junet(p, tiny["jcfg"], s, tiny["t"], c, capture_keys=KEYS))
    return fn(tiny["jm"].unet_params, jnp.asarray(tiny["lat"]), jnp.asarray(tiny["text"]))


@pytest.mark.parametrize("capture_only", [False, True])
def test_unet_capture_matches(tiny, jax_capture, capture_only):
    """The maps of the full walk; ``capture_only`` ends the walk after the
    last captured site with the same maps."""
    from lvd_tpu_torch.models.unet3d import apply_unet3d as tunet

    out_j, aux_j = jax_capture
    out_t, aux_t = tunet(tiny["tparams"], tiny["tcfg"], torch.from_numpy(tiny["lat"]), tiny["t"],
                         torch.from_numpy(tiny["text"]), capture_keys=KEYS,
                         capture_only=capture_only)
    assert set(aux_t) == set(aux_j) == set(KEYS)
    for key in KEYS:
        assert aux_t[key].dtype == torch.float32
        _close_rel(aux_t[key].numpy(), aux_j[key], 1e-4)
    if capture_only:
        assert out_t is None
    else:
        _close_rel(out_t.numpy(), out_j, 1e-4)


@pytest.fixture(scope="module")
def jax_energy_grad(tiny):
    from lvd_tpu.diffusion.guidance import compute_ca_energy as j_energy
    from lvd_tpu.models.unet3d import apply_unet3d as junet

    cfg = jg.GuidanceConfig(**FLAGSHIP)

    def energy(lat, params, text):
        _, aux = junet(params, tiny["jcfg"], lat, tiny["t"], text, capture_keys=KEYS,
                       capture_only=True)
        return j_energy(aux, tiny["pack"], KEYS, cfg) * cfg.loss_scale

    return jax.jit(jax.value_and_grad(energy))(
        jnp.asarray(tiny["lat"]), tiny["jm"].unet_params, jnp.asarray(tiny["text"]))


@pytest.mark.parametrize("remat", ["none", "selective"])
def test_one_guided_update_matches_value_and_grad(tiny, jax_energy_grad, remat):
    """The loss-scaled energy and its gradient with respect to the latents;
    checkpointing the walk (``selective``) changes neither."""
    from lvd_tpu_torch.diffusion.sampler import energy_and_grad

    val_j, grad_j = jax_energy_grad
    val_t, grad_t = energy_and_grad(tiny["tparams"], tiny["tcfg"], torch.from_numpy(tiny["lat"]),
                                    tiny["t"], torch.from_numpy(tiny["text"]), tiny["tpack"],
                                    KEYS, tg.GuidanceConfig(**FLAGSHIP, energy_remat=remat),
                                    torch.float32)
    _close_rel(val_t.numpy(), val_j, 1e-4)
    _close_rel(grad_t.numpy(), grad_j, 1e-4)


def test_certificate_metrics_match():
    from lvd_tpu.diffusion.certify import _key_metrics as j_metrics
    from lvd_tpu_torch.diffusion.certify import _key_metrics as t_metrics

    rng = np.random.default_rng(9)
    logits = rng.standard_normal((5, 2, 48, 16)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    pack = tr.make_guidance_pack(_moving_boxes(5), [[2, 3], [5]], [("down", 1, 0, 0)], (12, 16),
                                 0.25, 0.25)
    masks = pack.masks[("down", 1, 0, 0)]
    want = j_metrics(*map(jnp.asarray, (attn, masks, pack.token_indices, pack.token_mask)))
    got = t_metrics(torch.from_numpy(attn), torch.from_numpy(masks),
                    torch.from_numpy(pack.token_indices).long(),
                    torch.from_numpy(pack.token_mask))
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w, 1e-5)


def test_guidance_effect_moves_attention_into_the_box(tiny):
    """lvd_tpu's own check of its certificate (tests/test_diffusion.py),
    on the port: the guided updates raise the in-box attention share."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.diffusion.certify import guidance_effect

    eff = guidance_effect(tiny["tparams"], tiny["tcfg"], tcfg.SchedulerConfig(),
                          torch.from_numpy(tiny["lat"]), torch.from_numpy(tiny["text"]),
                          tiny["tpack"], KEYS, tg.GuidanceConfig(**FLAGSHIP),
                          num_inference_steps=6, n_iters=3)
    assert set(eff) == {"inbox_before", "inbox_after", "gain", "com_dist_before",
                        "com_dist_after", "n_iters"}
    assert 0.0 < eff["inbox_before"] < 1.0
    assert eff["gain"] > 1.0 and eff["inbox_after"] > eff["inbox_before"], eff
