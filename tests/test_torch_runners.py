"""The port's GLIGEN pipeline, layout modules and runners against lvd_tpu's on
the CPU.

Both packages run the same tiny weights, the port's through the weight
bridge, fp32, 4 frames: the gated UNet of tests/test_torch_gligen.py
(lvd_tpu's tree, drawn from a seed) with its fusers' gates open and the
same tree without its fusers and PositionNet, and lvd_tpu's tiny CLIP and
VAE. Each package's pipelines are built once a module and
shared, so each lvd_tpu sampler compiles once: the unguided runners share a
2-step compile, the lvd runner has a guided 2-step one, and the GLIGEN
pipeline (beta 0.5 of 4 steps: the fuser in steps 0-1, not in 2-3) shares
its compile with the lvd_gligen runner, which takes the same flags (the
lvd-plus pipeline and runner are in tests/test_torch_gligen.py). Latents
are held within 1e-4 of max|ref|, the GLIGEN inputs' embeddings within
1e-5, the runners' joblib frames within one uint8 level, with the same
files written.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_gligen import (FRAMES, LAYOUT, _close_rel, check_gligen_pipeline, check_runner,
                               grounding, one_torch_thread, open_gates, tiny_gated_tree,  # noqa: F401
                               tiny_pipelines)


@pytest.fixture(scope="module")
def pipes():
    """{"default" | "gated": (lvd_tpu pipeline, port pipeline)}: the tiny
    gated UNet with its gates open, and the same tree without its fusers
    and PositionNet (an ungated tree)."""
    return tiny_pipelines(open_gates(tiny_gated_tree()))


def test_segment_boundaries_match(monkeypatch):
    """The port's sampler decides step by step which of guidance and GLIGEN
    run; the steps where that set changes must be lvd_tpu's scan segments
    (``segment_boundaries``) in the cases of tests/test_runners.py. The UNet
    and the energy are stubbed: each call records its step's mechanisms."""
    from lvd_tpu.diffusion.sampler import segment_boundaries
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion import sampler
    from lvd_tpu_torch.diffusion.guidance import GuidanceConfig

    guided, grounded = set(), []

    def unet(params, cfg, lat_in, timestep, text, gligen=None, spmd_axis=None):
        grounded.append(gligen is not None)
        return torch.zeros_like(lat_in)

    def energy(params, cfg, lat32, timestep, *args):
        guided.add(len(grounded))
        return torch.tensor(1e10), torch.zeros_like(lat32)

    monkeypatch.setattr(sampler, "apply_unet3d", unet)
    monkeypatch.setattr(sampler, "energy_and_grad", energy)
    cases = {(40, 10, 16): [0, 10, 16, 40], (40, 10, 10): [0, 10, 40], (40, 10, 0): [0, 10, 40],
             (40, 0, 0): [0, 40], (8, 2, 8): [0, 2, 8]}
    for (n, g_end, gl_end), want in cases.items():
        guided.clear(), grounded.clear()
        sampler.sample_video(None, None, torch.zeros(1, 2, 2, 2, 4), torch.zeros(2, 3, 8),
                             dpm.make_coeffs(tcfg.SchedulerConfig(), n), guidance=object(),
                             guidance_cfg=GuidanceConfig(max_index_step=g_end, max_iter=1),
                             gligen_pair=object(), num_grounding_steps=gl_end)
        modes = [(i in guided, grounded[i]) for i in range(n)]
        got = [0] + [i for i in range(1, n) if modes[i] != modes[i - 1]] + [n]
        assert got == segment_boundaries(n, g_end, gl_end) == want


def test_prepare_gligen_inputs_matches(pipes):
    jpipe, tpipe = pipes["gated"]
    _, boxes, phrases = grounding(jpipe)
    assert [len(b) for b in boxes] == [2, 2, 1, 1]
    ref = jpipe.prepare_gligen_inputs(boxes, phrases, FRAMES)
    got = tpipe.prepare_gligen_inputs(boxes, phrases, FRAMES)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == ref[k].shape
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(ref["boxes"]))
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(ref["masks"]))
    assert got["masks"][:FRAMES].sum() == 0 and got["masks"][FRAMES:].sum() == 6
    _close_rel(got["positive_embeddings"].numpy(), ref["positive_embeddings"], 1e-5)


def test_condition_and_per_frame_inputs_match(pipes):
    from lvd_tpu.layout.condition import parsed_layout_to_condition as jcond
    from lvd_tpu.runners.base import gligen_per_frame_inputs as jframes
    from lvd_tpu_torch.layout.condition import parsed_layout_to_condition
    from lvd_tpu_torch.runners.base import gligen_per_frame_inputs

    jpipe, tpipe = pipes["default"]
    kw = dict(height=512, width=512, num_condition_frames=6)
    ref = jcond(LAYOUT, tokenizer=jpipe.m.tokenizer, **kw)
    got = parsed_layout_to_condition(LAYOUT, tokenizer=tpipe.m.tokenizer, **kw)
    assert got._asdict() == ref._asdict()
    assert got.boxes[1][-1] == [0.0, 0.0, 0.0, 0.0]  # the cube has left
    assert gligen_per_frame_inputs(got, 6) == jframes(ref, 6)


def test_gligen_pipeline_matches(pipes):
    """GLIGEN at beta 0.5 of 4 steps: the fuser in steps 0-1, not in 2-3."""
    check_gligen_pipeline(pipes["gated"], 0.5, guided=False)


def test_gated_tree_without_boxes_equals_ungated(pipes):
    kw = dict(num_frames=FRAMES, num_inference_steps=2, seed=5, output_type="latent")
    got = pipes["gated"][1]("a red ball", **kw, gligen_boxes=None)
    assert torch.equal(got, pipes["default"][1]("a red ball", **kw))


# (runner, tree, run() arguments): the unguided runners share a 2-step
# compile; lvd_gligen takes the flags of test_gligen_pipeline_matches, and
# lvd_plus is held in tests/test_torch_gligen.py.
RUNNERS = {
    "zeroscope_dpm": ("default", dict(num_inference_steps=2)),
    "modelscope_dpm": ("default", dict(num_inference_steps=2)),
    "lvd": ("default", dict(num_inference_steps=2, max_iter=1)),
    "lvd_gligen": ("gated", dict(num_inference_steps=4, gligen_scheduled_sampling_beta=0.5,
                                 save_annotated_videos=True)),
}


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_matches(pipes, name, tmp_path, monkeypatch):
    tree, hparams = RUNNERS[name]
    check_runner(pipes[tree], name, hparams, tmp_path, monkeypatch)


def test_load_pipeline_models_reads_a_converted_checkpoint(pipes, tmp_path, monkeypatch):
    """``$LVD_CHECKPOINT_ROOT/<checkpoint, / as -->/{unet,clip,vae}.npz`` as
    lvd_tpu's save_params writes them (here the tiny gated trees) come back
    as the same tensors, 0-d gates included; without a checkpoint and
    without LVD_ALLOW_RANDOM_WEIGHTS=1 it raises."""
    from lvd_tpu.models.loader import save_params
    from lvd_tpu_torch.models.loader import load_pipeline_models

    jpipe, tpipe = pipes["gated"]
    ckpt = tmp_path / "longlian--text-to-video-lvd-zs"
    for name, tree in (("unet", jpipe.unet_params), ("clip", jpipe.clip_params),
                       ("vae", jpipe.vae_params)):
        save_params(str(ckpt / f"{name}.npz"), tree)
    monkeypatch.setenv("LVD_CHECKPOINT_ROOT", str(tmp_path))
    monkeypatch.delenv("LVD_ALLOW_RANDOM_WEIGHTS", raising=False)
    models = load_pipeline_models("lvd-gligen_zeroscope", device="cpu")
    assert models.preset.unet.attention_type == "gated"
    fuser = lambda t: t["up_blocks"][1]["layers"][2]["attn"]["blocks"][0]["fuser"]
    got, want = fuser(models.unet_params), fuser(tpipe.unet_params)
    assert got["alpha_dense"].shape == () and torch.equal(got["alpha_dense"], want["alpha_dense"])
    assert torch.equal(got["attn"]["to_q"]["w"], want["attn"]["to_q"]["w"])
    assert torch.equal(models.vae_params["post_quant_conv"]["w"],
                       tpipe.vae_params["post_quant_conv"]["w"])
    with pytest.raises(FileNotFoundError, match="LVD_ALLOW_RANDOM_WEIGHTS"):
        load_pipeline_models("zeroscope", device="cpu")


@pytest.mark.parametrize("preset", ["lvd-gligen_zeroscope", "modelscope256"])
def test_tiny_mode_builds_lvd_tpus_tiny_models(preset, monkeypatch):
    """``LVD_TINY=1``: lvd_tpu's tiny models in fp32 (gated for the
    lvd-gligen presets), lvd_tpu's preset and trees (traced, not compiled);
    ``LVD_PLATFORM=cpu`` puts them on the CPU."""
    from test_torch_prng_init import _lvd_tpu_tiny, _shapes

    from lvd_tpu_torch.runners import base

    monkeypatch.setenv("LVD_TINY", "1")
    monkeypatch.setenv("LVD_PLATFORM", "cpu")
    state = base.init_pipeline(preset)
    ref = _lvd_tpu_tiny("gated" if preset.startswith("lvd-gligen") else "default", monkeypatch)
    pipe = state.pipe
    assert pipe.dtype == torch.float32 and pipe.device.type == "cpu"
    assert (state.H, state.W) == (ref.preset.height, ref.preset.width) == (64, 96)
    assert dataclasses.asdict(pipe.preset) == dataclasses.asdict(ref.preset)
    for got, want in ((pipe.unet_params, ref.unet_params), (pipe.clip_params, ref.clip_params),
                      (pipe.vae_params, ref.vae_params)):
        assert _shapes(got) == _shapes(want)
        assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(got))
