"""Parity of the port's models and unguided pipeline with lvd_tpu on the CPU.

lvd_tpu's random params (tiny configs) go through the weight bridge
``params_from_numpy``, so both packages run the same weights on the same
numpy inputs, fp32. CLIP, the tiny UNet and the VAE decode are held within
1e-4 of max|ref|; the whole unguided tiny pipeline (same token ids, same
initial latents) within 1e-3 on the float video.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu import config as jcfg
from lvd_tpu.models.loader import tiny_pipeline_models
from lvd_tpu_torch import config as tcfg
from lvd_tpu_torch.models.loader import params_from_numpy

TOL = 1e-4


def _close_rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def _bridge(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


@pytest.fixture(scope="module")
def jax_models():
    return tiny_pipeline_models()


def test_configs_are_copies():
    for name, preset in jcfg.PRESETS.items():
        assert repr(tcfg.PRESETS[name]) == repr(preset)
    assert repr(tcfg.tiny_unet_config()) == repr(jcfg.tiny_unet_config())
    assert repr(tcfg.tiny_clip_config()) == repr(jcfg.tiny_clip_config())
    assert repr(tcfg.tiny_vae_config()) == repr(jcfg.tiny_vae_config())


def test_tokenizer_copy_matches():
    from lvd_tpu.text.tokenizer import load_tokenizer as jtok
    from lvd_tpu_torch.text.tokenizer import load_tokenizer as ttok

    for text in ("a brown bear walking in a forest", "dull, gray, unrealistic", ""):
        assert ttok(None).encode_padded(text) == jtok(None).encode_padded(text)


def test_params_from_numpy_flat_nested_and_npz(jax_models, tmp_path):
    from lvd_tpu.models.loader import flatten_pytree, save_params
    from lvd_tpu_torch.models.loader import load_params_npz

    nested = _bridge(jax_models.vae_params)
    flat = params_from_numpy(flatten_pytree(jax.device_get(jax_models.vae_params)), "cpu")
    assert nested["decoder"]["up_blocks"][1]["resnets"][0]["conv1"]["w"].shape == (3, 3, 32, 32)
    torch.testing.assert_close(flat["decoder"]["conv_in"]["w"], nested["decoder"]["conv_in"]["w"])
    save_params(str(tmp_path / "vae.npz"), jax_models.vae_params)
    read = load_params_npz(str(tmp_path / "vae.npz"), "cpu", torch.bfloat16)
    assert read["decoder"]["conv_out"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(read["decoder"]["mid"]["attn"]["to_q"]["w"],
                               nested["decoder"]["mid"]["attn"]["to_q"]["w"].bfloat16())


def test_clip_matches(jax_models):
    from lvd_tpu.models.clip import apply_clip_text as jclip
    from lvd_tpu_torch.models.clip import apply_clip_text as tclip

    cfg = jcfg.tiny_clip_config()
    tok = jax_models.tokenizer
    ids = np.stack([np.asarray(tok.encode_padded(t), np.int32)
                    for t in ("a red ball", "a brown bear walking in a forest")])
    ref = jax.jit(lambda p, i: jclip(p, cfg, i))(jax_models.clip_params, jnp.asarray(ids))
    got = tclip(_bridge(jax_models.clip_params), tcfg.tiny_clip_config(),
                torch.from_numpy(ids.astype(np.int64)))
    _close_rel(got["last_hidden_state"].numpy(), ref["last_hidden_state"])
    _close_rel(got["pooler_output"].numpy(), ref["pooler_output"])


def test_unet_matches(jax_models):
    from lvd_tpu.models.unet3d import apply_unet3d as junet
    from lvd_tpu_torch.models.unet3d import apply_unet3d as tunet

    cfg = jcfg.tiny_unet_config()
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((1, 4, 16, 24, 4)).astype(np.float32)
    text = rng.standard_normal((1, 77, cfg.cross_attention_dim)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, t, c: junet(p, cfg, s, t, c))(
        jax_models.unet_params, jnp.asarray(sample), jnp.array(500), jnp.asarray(text))
    got = tunet(_bridge(jax_models.unet_params), tcfg.tiny_unet_config(),
                torch.from_numpy(sample), 500, torch.from_numpy(text))
    _close_rel(got.numpy(), ref)


def test_vae_decode_matches(jax_models):
    from lvd_tpu.models.vae import decode as jdecode
    from lvd_tpu_torch.models.vae import decode as tdecode

    cfg = jcfg.tiny_vae_config()
    lat = np.random.default_rng(1).standard_normal((2, 8, 12, 4)).astype(np.float32)
    ref = jax.jit(lambda p, x: jdecode(p, cfg, x))(jax_models.vae_params, jnp.asarray(lat))
    got = tdecode(_bridge(jax_models.vae_params), tcfg.tiny_vae_config(), torch.from_numpy(lat))
    _close_rel(got.numpy(), ref)


@pytest.mark.parametrize("steps", [3, 40])
def test_dpm_solver_matches(steps):
    from lvd_tpu.diffusion import dpm_solver as jdpm
    from lvd_tpu_torch.diffusion import dpm_solver as tdpm

    jc = jdpm.make_coeffs(jcfg.SchedulerConfig(), steps)
    tc = tdpm.make_coeffs(tcfg.SchedulerConfig(), steps)
    for name in tdpm.SolverCoeffs._fields:
        np.testing.assert_allclose(getattr(tc, name), np.asarray(getattr(jc, name)), rtol=1e-6)
    rng = np.random.default_rng(steps)
    x, eps, prev = (rng.standard_normal((1, 2, 3, 4, 4)).astype(np.float32) for _ in range(3))
    state = jdpm.SolverState(prev_x0=jnp.asarray(prev))
    for i in (0, 1, steps - 1):
        ci = jdpm.SolverCoeffs(*[a[i] for a in jc])
        j_state, j_x = jdpm.step(state, ci, jnp.asarray(x), jnp.asarray(eps))
        t_x0, t_x = tdpm.step(torch.from_numpy(prev), tc.at(i), torch.from_numpy(x),
                              torch.from_numpy(eps))
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_x0.numpy(), np.asarray(j_state.prev_x0), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def tiny_pipelines(jax_models):
    from lvd_tpu.pipeline import TextToVideoPipeline as JPipe
    from lvd_tpu_torch.pipeline import PipelineModels
    from lvd_tpu_torch.pipeline import TextToVideoPipeline as TPipe
    from lvd_tpu_torch.text.tokenizer import load_tokenizer

    p = jax_models.preset
    preset = tcfg.ModelPreset(
        name="tiny", unet=tcfg.tiny_unet_config(), clip=tcfg.tiny_clip_config(),
        vae=tcfg.tiny_vae_config(), scheduler=tcfg.SchedulerConfig(), height=p.height,
        width=p.width, default_num_frames=p.default_num_frames, base_attn_dim=p.base_attn_dim)
    tmodels = PipelineModels(preset, _bridge(jax_models.unet_params),
                             _bridge(jax_models.clip_params), _bridge(jax_models.vae_params),
                             load_tokenizer(None))
    jpipe = JPipe(jax_models, dtype=jnp.float32)  # fp32 cast: same values
    return jpipe, TPipe(tmodels, dtype=torch.float32, device="cpu")


def test_tiny_pipeline_matches(tiny_pipelines):
    """The whole unguided slice: encode, 3 CFG DPM-Solver++ steps, decode."""
    from lvd_tpu.models.vae import decode as jdecode
    from lvd_tpu_torch.models.vae import decode as tdecode

    jpipe, tpipe = tiny_pipelines
    lat = np.random.default_rng(3).standard_normal((1, 8, 8, 12, 4)).astype(np.float32)
    kw = dict(num_frames=8, num_inference_steps=3, guidance_scale=9.0, seed=0)
    j_final = np.asarray(jpipe("a red ball", **kw, latents=jnp.asarray(lat),
                               output_type="latent"))
    t_final = tpipe("a red ball", **kw, latents=torch.from_numpy(lat), output_type="latent")
    _close_rel(t_final.numpy(), j_final)

    # The float video each package decodes from its own latents.
    scale = jpipe.preset.vae.scaling_factor
    j_video = np.clip(np.asarray(jdecode(jpipe.vae_params, jpipe.preset.vae,
                                         jnp.asarray(j_final[0]) / scale)) / 2 + 0.5, 0, 1)
    t_video = torch.clamp(tdecode(tpipe.vae_params, tpipe.preset.vae, t_final[0] / scale)
                          / 2 + 0.5, 0, 1).numpy()
    np.testing.assert_allclose(t_video, j_video, atol=1e-3)

    # The pipelines' own uint8-rounded outputs differ by at most one level.
    t_out = tpipe("a red ball", **kw, latents=torch.from_numpy(lat))
    assert t_out.shape == (1, 8, 64, 96, 3) and np.isfinite(t_out).all()
    j_out = np.asarray(jpipe("a red ball", **kw, latents=jnp.asarray(lat)))
    assert np.abs(t_out - j_out).max() <= 1.0 / 255 + 1e-6
