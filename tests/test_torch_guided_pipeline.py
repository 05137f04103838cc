"""The tiny guided pipeline of the port against lvd_tpu on the CPU.

3 DPM-Solver++ steps with CFG, guidance on the first 2 (``max_index_step``)
with up to 2 updates a step (``max_iter``), the flagship energy otherwise,
tiny weights shared through the weight bridge, fp32. The port runs its
entry point, ``TextToVideoPipeline(...)(..., backward_guidance=...)``, from
a seed; the reference is lvd_tpu's sampler fed exactly what lvd_tpu's
pipeline feeds it (its prompt encoding, its seeded noise, its guidance
pack), compiled once with the loss threshold as an argument so both guard
regimes share the compile. The final latents are held within 1e-4 of
max|ref| in both regimes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.diffusion import guidance as jg
from lvd_tpu_torch.diffusion import guidance as tg

KEYS = tuple(tuple(k) for k in tg.OVERALL_GUIDANCE_ATTN_KEYS)
GUIDED = dict(loss_scale=2.5, max_iter=2, max_index_step=2, fg_top_p=0.25, bg_top_p=0.25,
              fg_weight=1.0, bg_weight=2.0)
PROMPT, FRAMES, STEPS, SEED = "a red ball", 4, 3, 3
BOXES = [[[0.05 + 0.15 * f, 0.25, 0.4 + 0.15 * f, 0.8] for f in range(FRAMES)]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_rel(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


@pytest.fixture(scope="module")
def pipelines():
    from lvd_tpu.diffusion import dpm_solver as jdpm
    from lvd_tpu.diffusion import sampler as jsampler
    from lvd_tpu.layout.rasterize import make_guidance_pack
    from lvd_tpu.models.loader import tiny_pipeline_models
    from lvd_tpu.pipeline import TextToVideoPipeline as JPipe
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.loader import params_from_numpy
    from lvd_tpu_torch.pipeline import PipelineModels
    from lvd_tpu_torch.pipeline import TextToVideoPipeline as TPipe
    from lvd_tpu_torch.text.tokenizer import load_tokenizer

    jm = tiny_pipeline_models()
    p = jm.preset
    jpipe = JPipe(jm, dtype=jnp.float32)
    h_lat, w_lat = p.height // p.vae.scale_factor, p.width // p.vae.scale_factor

    # What lvd_tpu/pipeline.py:350-380 hands its sampler.
    text_pair = jpipe.encode_prompt(PROMPT, "").astype(jnp.float32)
    latents = jax.random.normal(jax.random.PRNGKey(SEED), (1, FRAMES, h_lat, w_lat, 4),
                                jnp.float32) * jdpm.INIT_NOISE_SIGMA
    coeffs = jdpm.make_coeffs(p.scheduler, STEPS)
    pack = make_guidance_pack(BOXES, [[2]], KEYS, (h_lat, w_lat), fg_top_p=0.25, bg_top_p=0.25)

    @jax.jit
    def reference(params, threshold):
        cfg = jg.GuidanceConfig(**GUIDED, loss_threshold=threshold)
        return jsampler.sample_video(params, p.unet, latents, text_pair, coeffs, 9.0,
                                     guidance=jsampler.pack_to_arrays(pack), guidance_cfg=cfg,
                                     guidance_attn_keys=KEYS)

    bridge = lambda t: params_from_numpy(jax.device_get(t), "cpu")
    preset = tcfg.ModelPreset(
        name="tiny", unet=tcfg.tiny_unet_config(), clip=tcfg.tiny_clip_config(),
        vae=tcfg.tiny_vae_config(), scheduler=tcfg.SchedulerConfig(), height=p.height,
        width=p.width, default_num_frames=p.default_num_frames, base_attn_dim=p.base_attn_dim)
    tpipe = TPipe(PipelineModels(preset, bridge(jm.unet_params), bridge(jm.clip_params),
                                 bridge(jm.vae_params), load_tokenizer(None)),
                  dtype=torch.float32, device="cpu")
    return lambda threshold: np.asarray(reference(jm.unet_params, threshold)), tpipe


@pytest.mark.parametrize("threshold,updates", [(0.0, 4), (1e6, 1)])
def test_tiny_guided_pipeline_matches(pipelines, threshold, updates, monkeypatch):
    """Threshold 0 always guides (4 updates); 1e6 lets the loss carried from
    the first update stop the loop for the rest of step 0 and all of step 1."""
    from lvd_tpu_torch.diffusion import sampler as t_sampler

    reference, tpipe = pipelines
    calls = []
    real = t_sampler.energy_and_grad
    monkeypatch.setattr(t_sampler, "energy_and_grad", lambda *a: calls.append(1) or real(*a))
    guide = {"boxes": BOXES, "object_positions": [[2]], "attn_keys": KEYS,
             "config": tg.GuidanceConfig(**GUIDED, loss_threshold=threshold)}
    kw = dict(num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0, seed=SEED,
              output_type="latent")
    got = tpipe(PROMPT, **kw, backward_guidance=guide)
    assert len(calls) == updates
    assert len(tpipe.timings["guided"]) == 2 and len(tpipe.timings["steps"]) == STEPS
    _close_rel(got.numpy(), reference(threshold))
    unguided = tpipe(PROMPT, **kw)
    assert np.abs(unguided.numpy() - got.numpy()).max() > 1e-3
