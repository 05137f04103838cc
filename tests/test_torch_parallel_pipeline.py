"""``TextToVideoPipeline(..., mesh=make_mesh(4))`` on 4 gloo ranks of the
CPU against lvd_tpu's single-device pipeline at tests/test_parallel.py's
calls: lvd_tpu's tiny models, fp32, "a red ball", 8 frames, 3 steps, seed 0.

- unguided: every rank's video within 1.5 / 255 of lvd_tpu's (lvd_tpu's
  gate in tests/test_parallel.py: the uint8 decode can flip a level);
- guided, with both of tests/test_parallel.py's GuidanceConfigs (the
  default energy; CoM 0.03 with attn-sync 0.1), one moving object and one
  that appears at frame 4, a shard boundary: every rank's final latents
  within rtol 5e-3 / atol 5e-4 of lvd_tpu's, which must differ from the
  unguided latents;
- GLIGEN: the tiny gated pipeline with its fusers' gates open, grounding on
  the first of 3 steps, against the port's unsharded call (max|d| within
  1e-4 of max|ref| of the latents; tests/test_torch_gligen.py and
  test_torch_runners.py hold that call to lvd_tpu's at 4 frames), and the
  call without grounding, which must differ; its
  uint8_device frames equal on every rank.

lvd_tpu's pipelines are the very calls tests/test_parallel.py makes without
a mesh, so they share its entries in the suite's compile cache. The ranks
import neither jax nor lvd_tpu (tests/_torch_parallel_ranks.py).
"""

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks

N = 4
CALL = dict(prompt="a red ball", num_frames=8, num_inference_steps=3, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from lvd_tpu_torch.parallel.launch import RankPool

    with RankPool(N, str(tmp_path_factory.mktemp("ranks")), timeout=600) as p:
        yield p


@pytest.fixture(scope="module")
def lvd_tpu_pipeline():
    """lvd_tpu's single-device tiny pipeline in fp32, as tests/test_parallel.py
    builds it."""
    import jax.numpy as jnp
    from lvd_tpu.models.loader import tiny_pipeline_models
    from lvd_tpu.pipeline import TextToVideoPipeline

    pipe = TextToVideoPipeline(tiny_pipeline_models(), dtype=jnp.float32)
    return lambda **call: np.asarray(pipe(**call))


def _same_on_every_rank(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


def test_mesh_pipeline_unguided_matches_lvd_tpu(pool, lvd_tpu_pipeline):
    want = lvd_tpu_pipeline(**CALL)
    got = _same_on_every_rank(pool.run(ranks.pipeline, CALL))
    assert got.shape == want.shape == (1, 8, 64, 96, 3)
    np.testing.assert_allclose(got, want, atol=1.5 / 255)


BOXES = [[[0.05 + 0.05 * f, 0.1, 0.35 + 0.05 * f, 0.6] for f in range(8)],
         [[0.0, 0.0, 0.0, 0.0]] * 4 + [[0.5, 0.5, 0.9, 0.9]] * 4]
CONFIGS = {
    "default": dict(max_index_step=2, max_iter=1, loss_scale=2.0, loss_threshold=1e-6),
    "frame_coupled": dict(max_index_step=2, max_iter=1, loss_scale=2.0, loss_threshold=1e-6,
                          com_loss_scale=0.03, attn_sync_weight=0.1),
}


def _guide(config_cls, name):
    return {"boxes": BOXES, "object_positions": [[2], [3]],
            "config": config_cls(**CONFIGS[name]),
            "attn_keys": (("down", 1, 0, 0), ("up", 1, 0, 0))}


@pytest.fixture(scope="module")
def unguided_latents():
    return ranks.pipeline(dict(CALL, output_type="latent"), use_mesh=False)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_pipeline_guided_matches_lvd_tpu(pool, lvd_tpu_pipeline, unguided_latents, name):
    from lvd_tpu.diffusion.guidance import GuidanceConfig as JConfig
    from lvd_tpu_torch.diffusion.guidance import GuidanceConfig

    want = lvd_tpu_pipeline(**CALL, backward_guidance=_guide(JConfig, name),
                            output_type="latent")
    call = dict(CALL, backward_guidance=_guide(GuidanceConfig, name), output_type="latent")
    got = _same_on_every_rank(pool.run(ranks.pipeline, call))
    assert got.shape == want.shape == (1, 8, 8, 12, 4)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    assert np.abs(want - unguided_latents).max() > 1e-3  # the guidance moved the latents


def test_mesh_pipeline_gligen_matches_unsharded(pool):
    phrases = [["ball"]] * 8
    boxes = [[[0.1 + 0.05 * f, 0.2, 0.5 + 0.05 * f, 0.7]] for f in range(8)]
    grounded = dict(CALL, gligen_boxes=boxes, gligen_phrases=phrases,
                    gligen_scheduled_sampling_beta=0.34, output_type="latent")
    got = _same_on_every_rank(pool.run(ranks.pipeline, grounded, True))
    want = ranks.pipeline(grounded, gated=True, use_mesh=False)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    plain = ranks.pipeline(dict(CALL, output_type="latent"), gated=True, use_mesh=False)
    assert np.abs(want - plain).max() > 1e-3  # the open fusers move the latents
    frames = _same_on_every_rank(pool.run(ranks.pipeline,
                                          dict(grounded, output_type="uint8_device"), True))
    assert frames.shape == (8, 64, 96, 3) and frames.dtype == np.uint8
