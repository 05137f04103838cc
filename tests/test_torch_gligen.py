"""The port's GLIGEN modules and the lvd-plus path against lvd_tpu's on the
CPU.

The tiny gated parameters (lvd_tpu's tree and init recipe, drawn from a
seed), with every fuser's gates opened (tanh of a seeded value in [0.3,
0.9]), the PositionNet's null features set to seeded non-zero values and
the gated spatial transformers' 1e-5-scaled proj_out given normal weights,
so that nothing of GLIGEN is multiplied away, go to lvd_tpu as numpy and
to the port through the weight bridge ``params_from_numpy``; every input is drawn with
numpy from a seed, fp32: ``fourier_embed`` within 1e-6, the PositionNet
(some masks off) and the gated fuser within 1e-5, the tiny gated UNet
forward with grounding inputs within 1e-4 of max|ref|. On the port alone:
with the gates shut the gated UNet gives the ungated UNet's output bit for
bit, and the port's key-order ``init_unet3d`` gives a gated tree with
lvd_tpu's keys and shapes.
Then lvd-plus (guidance on 2 of 4 steps, the fuser to step 3): the tiny
pipeline's latents within 1e-4 and the lvd_plus runner's files and frames,
through the helpers tests/test_torch_runners.py shares.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu import config as jcfg
from lvd_tpu.models import gligen as jg
from lvd_tpu_torch import config as tcfg
from lvd_tpu_torch.models import gligen as tgl
from lvd_tpu_torch.models.loader import params_from_numpy

M = 30  # grounding slots per frame (MAX_GLIGEN_OBJS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_rel(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def open_gates(tree, seed=0):
    """lvd_tpu's tree as numpy, each fuser's alphas drawn in [0.3, 0.9], the
    PositionNet's null features normal, and each spatial transformer's
    1e-5-scaled proj_out a normal * fan_in^-1/2 weight (else the fuser's
    branch is multiplied away before the output), from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.array, jax.device_get(tree))

    def walk(node):
        if isinstance(node, dict):
            if "alpha_attn" in node:
                for k in ("alpha_attn", "alpha_dense"):
                    node[k] = np.float32(rng.uniform(0.3, 0.9))
            if "blocks" in node and "fuser" in node["blocks"][0]:
                w = node["proj_out"]["w"]
                node["proj_out"]["w"] = (rng.standard_normal(w.shape)
                                         * w.shape[0] ** -0.5).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(tree)
    pn = tree["position_net"]
    for k in ("null_positive_feature", "null_position_feature"):
        pn[k] = rng.standard_normal(pn[k].shape).astype(np.float32)
    return tree


def _key_order_unet(cfg, seed=0):
    """The port's ``init_unet3d``: lvd_tpu's tree drawn in its JAX key order
    from PRNGKey(seed), on the CPU."""
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.utils import prng

    return init_unet3d(prng.prng_key(seed), cfg, device="cpu")


def tiny_gated_tree(seed=0):
    """The tiny gated UNet as numpy, lvd_tpu's ``init_unet3d`` tree in its
    key order through the port's own draw, which
    test_random_gated_tree_has_lvd_tpus_keys_and_shapes holds key for key
    against lvd_tpu's. (lvd_tpu's own draw of it compiles for ~150 s on the
    CPU.)"""
    tree = _key_order_unet(tcfg.tiny_unet_config("gated"), seed)
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def gated_params():
    return open_gates(tiny_gated_tree())


def grounding_inputs(rng, n, positive_len):
    """(n, M) grounding slots: boxes in [0, 1], about a third of the masks off."""
    x0 = rng.uniform(0, 0.6, (n, M, 2))
    boxes = np.concatenate([x0, x0 + rng.uniform(0.05, 0.4, (n, M, 2))], -1).astype(np.float32)
    masks = (rng.uniform(size=(n, M)) > 0.35).astype(np.float32)
    masks[:, 0] = 1.0
    masks[0, :] = 0.0  # one row entirely padded
    embs = rng.standard_normal((n, M, positive_len)).astype(np.float32)
    return {"boxes": boxes, "masks": masks, "positive_embeddings": embs}


def test_fourier_embed_matches():
    boxes = np.random.default_rng(0).uniform(0, 1, (3, M, 4)).astype(np.float32)
    ref = np.asarray(jg.fourier_embed(jnp.asarray(boxes)))
    got = tgl.fourier_embed(torch.from_numpy(boxes)).numpy()
    assert got.shape == ref.shape == (3, M, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_position_net_matches(gated_params):
    cfg = jcfg.tiny_unet_config("gated")
    g = grounding_inputs(np.random.default_rng(1), 4, cfg.gligen_positive_len)
    pn = gated_params["position_net"]
    ref = jax.jit(jg.apply_position_net)(pn, *(jnp.asarray(g[k]) for k in g))
    got = tgl.apply_position_net(params_from_numpy(pn, "cpu"),
                                 *(torch.from_numpy(g[k]) for k in g))
    assert got.shape == (4, M, cfg.cross_attention_dim)
    _close_rel(got.numpy(), ref, 1e-5)


def test_gated_fuser_matches(gated_params):
    cfg = jcfg.tiny_unet_config("gated")
    fuser = gated_params["down_blocks"][1]["layers"][0]["attn"]["blocks"][0]["fuser"]
    c = fuser["linear"]["w"].shape[1]
    heads = cfg.num_heads(c)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 24, c)).astype(np.float32)
    objs = rng.standard_normal((4, M, cfg.cross_attention_dim)).astype(np.float32)
    ref = jax.jit(jg.apply_gated_self_attention, static_argnums=3)(
        fuser, jnp.asarray(x), jnp.asarray(objs), heads)
    got = tgl.apply_gated_self_attention(params_from_numpy(fuser, "cpu"), torch.from_numpy(x),
                                         torch.from_numpy(objs), heads)
    assert got.shape == x.shape
    _close_rel(got.numpy(), ref, 1e-5)
    # the gates are open: the fuser moves x
    assert np.abs(got.numpy() - x).max() > 1e-2


def test_gated_unet_forward_matches(gated_params):
    from lvd_tpu.models.unet3d import apply_unet3d as junet
    from lvd_tpu_torch.models.unet3d import apply_unet3d as tunet

    cfg = jcfg.tiny_unet_config("gated")
    rng = np.random.default_rng(3)
    sample = rng.standard_normal((1, 4, 16, 24, 4)).astype(np.float32)
    text = rng.standard_normal((1, 77, cfg.cross_attention_dim)).astype(np.float32)
    g = grounding_inputs(rng, 4, cfg.gligen_positive_len)
    ref, _ = jax.jit(lambda p, s, c, gl: junet(p, cfg, s, 500, c, gligen=gl))(
        gated_params, jnp.asarray(sample), jnp.asarray(text),
        {k: jnp.asarray(v) for k, v in g.items()})
    params = params_from_numpy(gated_params, "cpu")
    got = tunet(params, tcfg.tiny_unet_config("gated"), torch.from_numpy(sample), 500,
                torch.from_numpy(text), gligen={k: torch.from_numpy(v) for k, v in g.items()})
    _close_rel(got.numpy(), ref, 1e-4)
    plain = tunet(params, tcfg.tiny_unet_config("gated"), torch.from_numpy(sample), 500,
                  torch.from_numpy(text))
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-3  # the fuser reached the output


def test_closed_gates_give_the_ungated_unet_bit_for_bit():
    from lvd_tpu_torch.models.unet3d import apply_unet3d

    cfg = tcfg.tiny_unet_config("gated")
    gated = _key_order_unet(cfg)

    rng = np.random.default_rng(4)
    sample = torch.from_numpy(rng.standard_normal((1, 4, 16, 24, 4)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((1, 77, 64)).astype(np.float32))
    g = {k: torch.from_numpy(v) for k, v in grounding_inputs(rng, 4, 64).items()}
    with torch.no_grad():
        got = apply_unet3d(gated, cfg, sample, 500, text, gligen=g)
        ref = apply_unet3d(strip_gligen(gated), tcfg.tiny_unet_config(), sample, 500, text)
    assert torch.equal(got, ref)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}{k}/"))
    return out


def test_random_gated_tree_has_lvd_tpus_keys_and_shapes(gated_params):
    from lvd_tpu.models.unet3d import init_unet3d

    ref = _shapes(jax.eval_shape(lambda k: init_unet3d(k, jcfg.tiny_unet_config("gated")),
                                 jax.random.PRNGKey(0)))
    got = _key_order_unet(tcfg.tiny_unet_config("gated"))
    assert _shapes(got) == _shapes(gated_params) == ref
    n_fusers = sum(k.endswith("fuser/alpha_attn") for k in ref)
    assert n_fusers == 16 and ref["position_net/linears_0/w"] == (64 + 64, 512)
    # the 0-d gates cross the weight bridge as 0-d tensors with their values
    bridged = params_from_numpy(gated_params, "cpu")
    fuser = bridged["mid_block"]["layers"][0]["attn"]["blocks"][0]["fuser"]
    assert fuser["alpha_attn"].shape == () and fuser["alpha_attn"].item() == pytest.approx(
        float(gated_params["mid_block"]["layers"][0]["attn"]["blocks"][0]["fuser"]["alpha_attn"]))


# ---- Tiny pipelines, shared with tests/test_torch_runners.py ----

FRAMES = 4
# A parsed layout whose second object leaves after layout frame 3, so its
# boxes are absent (zero) in the last video frames.
LAYOUT = {
    "Prompt": "a red ball rolls right",
    **{f"Frame {i + 1}": [{"id": 0, "name": "red ball", "box": [40 + 60 * i, 200, 120, 120]}]
       + ([{"id": 1, "name": "blue cube", "box": [300, 60, 90, 90]}] if i < 3 else [])
       for i in range(6)},
    "Background keyword": "grass",
}


def strip_gligen(node):
    """The tree without its fusers and PositionNet: an ungated tree."""
    if isinstance(node, dict):
        return {k: strip_gligen(v) for k, v in node.items() if k not in ("fuser", "position_net")}
    if isinstance(node, list):
        return [strip_gligen(v) for v in node]
    return node


def tiny_pipelines(gated_unet, kinds=("default", "gated")):
    """{kind: (lvd_tpu pipeline, port pipeline)}, fp32, the port's on the
    CPU: "gated" runs ``gated_unet`` (lvd_tpu's tiny gated UNet as numpy),
    "default" the same tree without its fusers and PositionNet, each with
    lvd_tpu's tiny CLIP and VAE."""
    from lvd_tpu.models.clip import init_clip_text
    from lvd_tpu.models.vae import init_vae
    from lvd_tpu.pipeline import PipelineModels as JModels
    from lvd_tpu.pipeline import TextToVideoPipeline as JPipe
    from lvd_tpu.text.tokenizer import load_tokenizer as jtokenizer
    from lvd_tpu_torch.pipeline import PipelineModels, TextToVideoPipeline
    from lvd_tpu_torch.text.tokenizer import load_tokenizer

    k = jax.random.split(jax.random.PRNGKey(1), 2)
    clip = jax.device_get(init_clip_text(k[0], jcfg.tiny_clip_config()))
    vae = jax.device_get(init_vae(k[1], jcfg.tiny_vae_config()))
    bridge = lambda t: params_from_numpy(t, "cpu")
    pipes = {}
    for kind in kinds:
        unet = gated_unet if kind == "gated" else strip_gligen(gated_unet)
        jpreset = jcfg.ModelPreset(
            name="tiny", unet=jcfg.tiny_unet_config(kind), clip=jcfg.tiny_clip_config(),
            vae=jcfg.tiny_vae_config(), scheduler=jcfg.SchedulerConfig(), height=64, width=96,
            default_num_frames=FRAMES, base_attn_dim=(8, 12))
        preset = tcfg.ModelPreset(
            name="tiny", unet=tcfg.tiny_unet_config(kind), clip=tcfg.tiny_clip_config(),
            vae=tcfg.tiny_vae_config(), scheduler=tcfg.SchedulerConfig(), height=64, width=96,
            default_num_frames=FRAMES, base_attn_dim=(8, 12))
        pipes[kind] = (
            JPipe(JModels(jpreset, unet, clip, vae, jtokenizer(None)), dtype=jnp.float32),
            TextToVideoPipeline(PipelineModels(preset, bridge(unet), bridge(clip), bridge(vae),
                                               load_tokenizer(None)), device="cpu"))
    return pipes


def grounding(jpipe):
    """LAYOUT as the runners see it at FRAMES frames: the condition and its
    per-frame gligen boxes and phrases (the cube is absent in the last
    frames)."""
    from lvd_tpu.layout.condition import parsed_layout_to_condition
    from lvd_tpu.runners.base import gligen_per_frame_inputs

    cond = parsed_layout_to_condition(LAYOUT, height=512, width=512, tokenizer=jpipe.m.tokenizer,
                                      num_condition_frames=FRAMES)
    return cond, *gligen_per_frame_inputs(cond, FRAMES)


def check_gligen_pipeline(pipes, beta, guided):
    """The tiny GLIGEN pipeline's latents, 4 steps at ``beta``, both packages
    within 1e-4 of max|ref|; with ``guided``, also guidance on steps 0-1
    with the inputs and the GuidanceConfig lvd_plus.run gives the pipeline
    at max_iter=1, max_index_step=2 (its other defaults are
    GuidanceConfig's). The same call without grounding inputs must differ."""
    from lvd_tpu.diffusion.guidance import GuidanceConfig as JConfig
    from lvd_tpu.runners.base import OVERALL_GUIDANCE_ATTN_KEYS as JKEYS
    from lvd_tpu_torch.diffusion.guidance import OVERALL_GUIDANCE_ATTN_KEYS, GuidanceConfig

    jpipe, tpipe = pipes
    cond, boxes, phrases = grounding(jpipe)
    kw = dict(num_frames=FRAMES, num_inference_steps=4, seed=3, output_type="latent",
              gligen_boxes=boxes, gligen_phrases=phrases, gligen_scheduled_sampling_beta=beta)
    jkw, tkw = dict(kw), dict(kw)
    if guided:
        for d, config, keys in ((jkw, JConfig, JKEYS),
                                (tkw, GuidanceConfig, OVERALL_GUIDANCE_ATTN_KEYS)):
            d["backward_guidance"] = {
                "boxes": cond.boxes, "object_positions": cond.object_positions,
                "config": config(max_iter=1, max_index_step=2), "attn_keys": keys}
    ref = np.asarray(jpipe(cond.prompt, **jkw))
    got = tpipe(cond.prompt, **tkw)
    assert len(tpipe.timings["guided"]) == (2 if guided else 0)
    _close_rel(got.numpy(), ref, 1e-4)
    ungrounded = tpipe(cond.prompt, **{k: v for k, v in tkw.items() if "gligen" not in k})
    assert np.abs(ungrounded.numpy() - got.numpy()).max() > 1e-3  # the fuser ran


def check_runner(pipes, name, hparams, out_dir, monkeypatch):
    """Both packages' ``runners.<name>.run`` on LAYOUT, seed 0, each with a
    RunnerState holding its tiny pipeline: the same files, joblib frames
    within one uint8 level, and a second call that skips."""
    import importlib

    import joblib

    written = {}
    for package, pipe in zip(("lvd_tpu", "lvd_tpu_torch"), pipes):
        base = importlib.import_module(f"{package}.runners.base")
        runner = importlib.import_module(f"{package}.runners.{name}")
        state = base.RunnerState()
        state.pipe, state.H, state.W = pipe, pipe.preset.height, pipe.preset.width
        monkeypatch.setattr(runner, "_state", state)
        out = out_dir / package
        monkeypatch.setattr(base, "img_dir", str(out))
        runner.run(LAYOUT, seed=0, num_frames=FRAMES, **hparams)
        written[package] = sorted(os.listdir(out))
        mtime = os.path.getmtime(out / "video_seed0.gif")
        runner.run(LAYOUT, seed=0, num_frames=FRAMES, **hparams)  # exists: skipped
        assert os.path.getmtime(out / "video_seed0.gif") == mtime
    want = ["video_seed0.gif", "video_seed0.joblib"]
    if hparams.get("save_annotated_videos"):
        want.append("video_seed0_seed0_with_box.gif")
    assert written["lvd_tpu_torch"] == written["lvd_tpu"] == want
    got, ref = (joblib.load(out_dir / p / "video_seed0.joblib")
                for p in ("lvd_tpu_torch", "lvd_tpu"))
    assert got.shape == ref.shape == (FRAMES, 64, 96, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


# ---- lvd-plus (guidance and GLIGEN), here beside the module tests so that
# its compile and test_torch_runners.py's run in separate workers ----

LVD_PLUS = dict(num_inference_steps=4, max_index_step=2, max_iter=1,
                gligen_scheduled_sampling_beta=0.75)


@pytest.fixture(scope="module")
def gated_pipes(gated_params):
    return tiny_pipelines(gated_params, ("gated",))["gated"]


def test_lvd_plus_pipeline_matches(gated_pipes):
    """Guidance on steps 0-1, the fuser to step 2 (beta 0.75), 4 steps."""
    check_gligen_pipeline(gated_pipes, 0.75, guided=True)


def test_lvd_plus_runner_matches(gated_pipes, tmp_path, monkeypatch):
    """The lvd_plus runner with the flags of test_lvd_plus_pipeline_matches,
    so lvd_tpu's sampler compiles once."""
    check_runner(gated_pipes, "lvd_plus", LVD_PLUS, tmp_path, monkeypatch)
