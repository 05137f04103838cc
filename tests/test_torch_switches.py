"""lvd_tpu's five kernel switches in the port, on the CPU.

``LVD_DISABLE_FLASH`` and ``LVD_FUSED_LINEAR`` are read at import (patched
here through each package's module attribute), ``LVD_DISABLE_FUSED_FF``,
``LVD_DISABLE_FUSED_TC`` and ``LVD_ENABLE_FUSED_SC`` per call (set with
monkeypatch.setenv). Each switch is checked on and off at its site: the path
taken (a spy on the kernel wrapper: on the CPU a wrapper runs its plain
version and counts no launch) and the values against lvd_tpu at 1e-4 of
max|ref|. The tiny guided pipeline then runs with both opt-ins on, and with
all three kill switches on, against lvd_tpu's tiny guided latents. lvd_tpu's
CPU route ignores the opt-ins (their predicates test the backend), so one
module-scoped lvd_tpu reference, compiled once, serves both.

Also here: the pipeline's default type against lvd_tpu's (fp32), and the
public sdpa() with long keys (kernels A and E with one head on the card,
their plain versions here) against lvd_tpu's ``attention_bh``.
"""

import inspect
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.diffusion import guidance as jg
from lvd_tpu.models import unet3d as j_unet
from lvd_tpu.ops import attention as j_attn
from lvd_tpu.ops import basic as jb
from lvd_tpu.ops import pallas_attention as j_pa
from lvd_tpu_torch.diffusion import guidance as tg
from lvd_tpu_torch.models import unet3d as t_unet
from lvd_tpu_torch.ops import attention as t_attn
from lvd_tpu_torch.ops import basic as tb
from lvd_tpu_torch.ops import geglu_fused, linear_fused, packed_attention
from lvd_tpu_torch.ops import spatial_conv_fused, temp_conv_fused

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _spy(monkeypatch, module, name):
    """Counts the calls of ``module.name`` (its callers look it up there)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _attn_params(rng, c, c_enc=None):
    lin = lambda din, dout, bias: {"w": _normal(rng, (din, dout), din ** -0.5),
                                   **({"b": _normal(rng, (dout,), 0.1)} if bias else {})}
    c_enc = c_enc or c
    return {"to_q": lin(c, c, False), "to_k": lin(c_enc, c, False), "to_v": lin(c_enc, c, False),
            "to_out": lin(c, c, True)}


@pytest.mark.parametrize("disabled", [False, True])
def test_disable_flash(monkeypatch, disabled):
    """LVD_DISABLE_FLASH sends attention() and the long-key sdpa() to the
    materializing einsum path."""
    monkeypatch.setattr(t_attn, "_DISABLE_FUSED", disabled)
    monkeypatch.setattr(j_attn, "_DISABLE_FUSED", disabled)
    packed = _spy(monkeypatch, packed_attention, "attention_packed")
    rng = np.random.default_rng(0)
    jp, tp = _both(_attn_params(rng, 128))
    jx, tx = _both(_normal(rng, (1, 300, 128)))
    got = t_attn.attention(tp, tx, None, 2)[0]
    _close_rel(got.numpy(), j_attn.attention(jp, jx, None, 2)[0])
    assert len(packed) == (0 if disabled else 1)
    jq, tq = _both(_normal(rng, (1, 2, 300, 64)))
    got = t_attn.sdpa(tq, tq, tq)[0]
    _close_rel(got.numpy(), j_attn.sdpa(jq, jq, jq)[0])
    assert len(packed) == (0 if disabled else 2)


@pytest.mark.parametrize("on", [False, True])
def test_fused_linear(monkeypatch, on):
    """LVD_FUSED_LINEAR routes the q/k/v/out projections of the fused path
    (k/v by their own weight) through kernel H's wrapper; never the
    captured sites, never a weight the predicate rejects."""
    monkeypatch.setattr(t_attn, "_FUSED_LINEAR", on)
    monkeypatch.setattr(j_attn, "_FUSED_LINEAR", on)
    rows = _spy(monkeypatch, linear_fused, "linear_rows")
    rng = np.random.default_rng(1)
    jp, tp = _both(_attn_params(rng, 128, c_enc=192))
    jx, tx = _both(_normal(rng, (1, 300, 128)))
    jc, tc = _both(_normal(rng, (1, 300, 192)))
    got = t_attn.attention(tp, tx, tc, 2)[0]
    _close_rel(got.numpy(), j_attn.attention(jp, jx, jc, 2)[0])
    assert len(rows) == (2 if on else 0)  # q and out; k/v: 192 % 128 != 0
    jp, tp = _both(_attn_params(rng, 128, c_enc=256))
    jc, tc = _both(_normal(rng, (1, 300, 256)))
    got = t_attn.attention(tp, tx, tc, 2)[0]
    _close_rel(got.numpy(), j_attn.attention(jp, jx, jc, 2)[0])
    assert len(rows) == (6 if on else 0)
    got, probs = t_attn.attention(tp, tx, tc, 2, return_probs=True)
    want, jprobs = j_attn.attention(jp, jx, jc, 2, return_probs=True)
    _close_rel(got.numpy(), want)
    _close_rel(probs.numpy(), jprobs)
    assert len(rows) == (6 if on else 0)


@pytest.mark.parametrize("disabled", [False, True])
def test_disable_fused_ff(monkeypatch, disabled):
    if disabled:
        monkeypatch.setenv("LVD_DISABLE_FUSED_FF", "1")
    else:
        monkeypatch.delenv("LVD_DISABLE_FUSED_FF", raising=False)
    fused = _spy(monkeypatch, geglu_fused, "geglu_mlp")
    rng = np.random.default_rng(2)
    lin = lambda din, dout: {"w": _normal(rng, (din, dout), din ** -0.5),
                             "b": _normal(rng, (dout,), 0.1)}
    jp, tp = _both({"proj": lin(128, 1024), "out": lin(512, 128)})
    jx, tx = _both(_normal(rng, (2048, 128)))
    _close_rel(tb.feed_forward(tp, tx).numpy(), jb.feed_forward(jp, jx))
    assert len(fused) == (0 if disabled else 1)


def _gn_cfg():
    return types.SimpleNamespace(norm_num_groups=4, norm_eps=1e-5)


@pytest.mark.parametrize("disabled", [False, True])
def test_disable_fused_tc(monkeypatch, disabled):
    if disabled:
        monkeypatch.setenv("LVD_DISABLE_FUSED_TC", "1")
    else:
        monkeypatch.delenv("LVD_DISABLE_FUSED_TC", raising=False)
    fused = _spy(monkeypatch, temp_conv_fused, "norm_silu_temporal_conv")
    rng = np.random.default_rng(3)
    c = 64
    norm = lambda: {"scale": 1.0 + _normal(rng, (c,), 0.1), "bias": _normal(rng, (c,), 0.1)}
    p = {f"conv{i}": {"norm": norm(), "conv": {"w": _normal(rng, (3, 1, 1, c, c), 0.05),
                                                 "b": _normal(rng, (c,), 0.1)}}
         for i in range(1, 5)}
    jp, tp = _both(p)
    jx, tx = _both(_normal(rng, (2 * 4, 3, 5, c)))
    got = t_unet._temp_conv(tp, tx, 4, _gn_cfg())
    _close_rel(got.numpy(), j_unet._temp_conv(jp, jx, 4, _gn_cfg()))
    assert len(fused) == (0 if disabled else 4)


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_enable_fused_sc(monkeypatch, enabled, bias):
    """LVD_ENABLE_FUSED_SC routes GroupNorm -> SiLU -> 3x3 conv to kernel I's
    wrapper, with zero bias for a biasless conv, as lvd_tpu does."""
    if enabled:
        monkeypatch.setenv("LVD_ENABLE_FUSED_SC", "1")
    else:
        monkeypatch.delenv("LVD_ENABLE_FUSED_SC", raising=False)
    fused = _spy(monkeypatch, spatial_conv_fused, "norm_silu_conv2d")
    rng = np.random.default_rng(4)
    norm = {"scale": 1.0 + _normal(rng, (32,), 0.2), "bias": _normal(rng, (32,), 0.1)}
    conv = {"w": _normal(rng, (3, 3, 32, 24), (9 * 32) ** -0.5)}
    if bias:
        conv["b"] = _normal(rng, (24,), 0.1)
    (jn, tn), (jc, tc) = _both(norm), _both(conv)
    jx, tx = _both(_normal(rng, (2, 5, 9, 32)))
    got = t_unet._gn_silu_conv(tn, tc, tx, _gn_cfg())
    _close_rel(got.numpy(), j_unet._gn_silu_conv(jn, jc, jx, _gn_cfg()))
    assert len(fused) == (1 if enabled else 0)


def test_pipeline_default_dtype_matches_lvd_tpu():
    from lvd_tpu.pipeline import TextToVideoPipeline as JPipe
    from lvd_tpu_torch.pipeline import TextToVideoPipeline as TPipe

    default = lambda cls: inspect.signature(cls.__init__).parameters["dtype"].default
    assert default(JPipe) == jnp.float32
    assert default(TPipe) == torch.float32


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_sdpa_long_keys_matches_attention_bh(d):
    """The port's sdpa() with 300 keys (kernel A and E with one head on the
    card; D = 192 and 256 in their wide form) against lvd_tpu's
    attention_bh (its _chunked_sdpa on the CPU), forward and gradient."""
    rng = np.random.default_rng(5)
    q, k, v, ct = (_normal(rng, (2, 2, 300, d)) for _ in range(4))
    ref, vjp = jax.vjp(lambda a, b, c: j_pa.attention_bh(a, b, c, d ** -0.5),
                       *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out, probs = t_attn.sdpa(*leaves)
    assert probs is None
    _close_rel(out.detach().numpy(), ref)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for got, want in zip(grads, vjp(jnp.asarray(ct))):
        _close_rel(got.numpy(), want)


# --- the tiny guided pipeline under the switches ---------------------------

KEYS = tuple(tuple(k) for k in tg.OVERALL_GUIDANCE_ATTN_KEYS)
GUIDED = dict(loss_scale=2.5, max_iter=2, max_index_step=2, fg_top_p=0.25, bg_top_p=0.25,
              fg_weight=1.0, bg_weight=2.0)
PROMPT, FRAMES, STEPS, SEED = "a red ball", 4, 3, 3
BOXES = [[[0.05 + 0.15 * f, 0.25, 0.4 + 0.15 * f, 0.8] for f in range(FRAMES)]]


@pytest.fixture(scope="module")
def pipelines():
    """lvd_tpu's tiny guided latents (its sampler fed what its pipeline feeds
    it, guidance always on: threshold 0) and the port's tiny pipeline on the
    same weights, as tests/test_torch_guided_pipeline.py builds them."""
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
    return np.asarray(reference(jm.unet_params, 0.0)), tpipe


def _guided_latents(tpipe):
    guide = {"boxes": BOXES, "object_positions": [[2]], "attn_keys": KEYS,
             "config": tg.GuidanceConfig(**GUIDED, loss_threshold=0.0)}
    return tpipe(PROMPT, num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=9.0,
                 seed=SEED, output_type="latent", backward_guidance=guide).numpy()


def test_tiny_guided_pipeline_with_opt_ins(pipelines, monkeypatch):
    reference, tpipe = pipelines
    monkeypatch.setenv("LVD_ENABLE_FUSED_SC", "1")
    monkeypatch.setattr(t_attn, "_FUSED_LINEAR", True)
    convs = _spy(monkeypatch, spatial_conv_fused, "norm_silu_conv2d")
    _close_rel(_guided_latents(tpipe), reference)
    assert convs  # the resnet convs took kernel I's wrapper


def test_tiny_guided_pipeline_with_kill_switches(pipelines, monkeypatch):
    reference, tpipe = pipelines
    monkeypatch.setenv("LVD_DISABLE_FUSED_FF", "1")
    monkeypatch.setenv("LVD_DISABLE_FUSED_TC", "1")
    monkeypatch.setattr(t_attn, "_DISABLE_FUSED", True)
    spies = [_spy(monkeypatch, packed_attention, "attention_packed"),
             _spy(monkeypatch, geglu_fused, "geglu_mlp"),
             _spy(monkeypatch, temp_conv_fused, "norm_silu_temporal_conv")]
    _close_rel(_guided_latents(tpipe), reference)
    assert not any(spies)  # every switched site took stock ops
