"""The 2D image path of the port (pipeline2d.py, layout/latents.py,
models/encode.py) against lvd_tpu's on the CPU, fp32, on
tests/test_image_path.py's tiny UNet2D and shapes.

- ``generate_semantic_guidance`` in one call with guidance (two updates
  on each of the first two steps), GLIGEN (a gated tiny UNet2D, its gates
  open at 0.5, grounding on the first three steps), ``save_all_latents``
  and a fast schedule (6 steps, fast after 3, rate 2: 4 steps): the final
  latents and the (5, 1, 16, 24, 4) history at 1e-4 of max|ref|; and
  unguided without GLIGEN, its final latents at 1e-4;
- every function of ``layout/latents.py``: masks, centers, shifts, box
  masks and composition exactly, the blend and the seeded latents at 1e-6
  of max|ref| (the noise is lvd_tpu's draw, bit for bit);
- ``encode_prompts`` (both uncond forms) at 1e-4, ``process_input_embeddings``
  and ``attn_list_to_tensor`` exactly;
- ``build_image_guidance``: every array of the pack equal;
- ``decode_images`` on the tiny VAE at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvd_tpu import config as jcfg
from lvd_tpu.diffusion.guidance import GuidanceConfig as JGuidanceConfig
from lvd_tpu.layout import latents as jlat
from lvd_tpu.models.unet2d import tiny_unet2d_config as j_tiny2d
from lvd_tpu_torch import config as tcfg
from lvd_tpu_torch import pipeline2d as tp2d
from lvd_tpu_torch.diffusion.guidance import GuidanceConfig
from lvd_tpu_torch.layout import latents as tlat
from lvd_tpu_torch.models import encode as tenc
from lvd_tpu_torch.models.unet2d import init_unet2d, tiny_unet2d_config
from lvd_tpu_torch.utils import prng

KEYS = (("down", 1, 0, 0), ("up", 1, 0, 0))
TOL = 1e-4
G_CFG = dict(max_index_step=2, max_iter=2, loss_scale=2.0, loss_threshold=0.0)


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


def _open_gates(tree):
    if isinstance(tree, list):
        return [_open_gates(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: torch.full_like(v, 0.5) if k in ("alpha_attn", "alpha_dense")
            else _open_gates(v) for k, v in tree.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def gated2d():
    """The port's draw of lvd_tpu's gated tiny UNet2D (PRNGKey(0)), gates
    open, in both packages' trees."""
    params = _open_gates(init_unet2d(prng.prng_key(0), tiny_unet2d_config("gated"),
                                     device="cpu"))
    return params, _np_tree(params)


def _inputs():
    rng = np.random.default_rng(3)
    latents = rng.standard_normal((1, 16, 24, 4)).astype(np.float32)
    text = rng.standard_normal((2, 77, 64)).astype(np.float32)
    gligen = {"boxes": rng.random((1, 3, 4)).astype(np.float32),
              "masks": np.array([[1.0, 1.0, 0.0]], np.float32),
              "positive_embeddings": rng.standard_normal((1, 3, 64)).astype(np.float32)}
    return latents, text, gligen


def test_generate_semantic_guidance_matches_lvd_tpu(gated2d):
    from lvd_tpu.pipeline2d import build_image_guidance as j_build
    from lvd_tpu.pipeline2d import generate_semantic_guidance as j_generate

    params, jparams = gated2d
    latents, text, gligen = _inputs()
    boxes, positions = [[0.1, 0.1, 0.5, 0.6], [0.5, 0.3, 0.9, 0.9]], [[2], [4]]
    j_cfg, t_cfg = JGuidanceConfig(**G_CFG), GuidanceConfig(**G_CFG)
    j_guide = j_build(boxes, positions, KEYS, (16, 24), j_cfg)
    t_guide = tp2d.build_image_guidance(boxes, positions, KEYS, (16, 24), t_cfg, device="cpu")
    kw = dict(num_inference_steps=6, guidance_attn_keys=KEYS, num_grounding_steps=3,
              save_all_latents=True, fast_after_steps=3, fast_rate=2)
    ref_final, ref_all = jax.jit(lambda p, l, t, g, gl: j_generate(
        p, j_tiny2d("gated"), l, t, jcfg.SchedulerConfig(), guidance=g, guidance_cfg=j_cfg,
        gligen=gl, **kw))(jparams, latents, text, j_guide, gligen)
    final, history = tp2d.generate_semantic_guidance(
        params, tiny_unet2d_config("gated"), torch.from_numpy(latents), torch.from_numpy(text),
        tcfg.SchedulerConfig(), guidance=t_guide, guidance_cfg=t_cfg,
        gligen={k: torch.from_numpy(v) for k, v in gligen.items()}, **kw)
    assert tuple(history.shape) == ref_all.shape == (5, 1, 16, 24, 4)
    _close_rel(final.numpy(), ref_final)
    _close_rel(history.numpy(), ref_all)
    np.testing.assert_array_equal(history[0].numpy(), latents)
    # the guidance and the fuser both moved the latents
    plain = tp2d.generate_semantic_guidance(
        params, tiny_unet2d_config("gated"), torch.from_numpy(latents), torch.from_numpy(text),
        tcfg.SchedulerConfig(), num_inference_steps=6, fast_after_steps=3)
    assert (plain - final).abs().max() > 10 * TOL * final.abs().max()


def test_unguided_generation_matches_lvd_tpu(gated2d):
    from lvd_tpu.pipeline2d import generate_semantic_guidance as j_generate

    params, jparams = gated2d
    latents, text, _ = _inputs()
    ref = jax.jit(lambda p, l, t: j_generate(p, j_tiny2d("gated"), l, t, jcfg.SchedulerConfig(),
                                             num_inference_steps=3))(jparams, latents, text)
    got = tp2d.generate_semantic_guidance(params, tiny_unet2d_config("gated"),
                                          torch.from_numpy(latents), torch.from_numpy(text),
                                          tcfg.SchedulerConfig(), num_inference_steps=3)
    _close_rel(got.numpy(), ref)


def test_build_image_guidance_is_lvd_tpus():
    from lvd_tpu.pipeline2d import build_image_guidance as j_build

    cfg = dict(fg_top_p=0.3, bg_top_p=0.6)
    boxes, positions = [[0.1, 0.1, 0.5, 0.6], [0.4, 0.2, 1.0, 0.7]], [[2, 3], [5]]
    ref = j_build(boxes, positions, KEYS, (16, 24), JGuidanceConfig(**cfg))
    got = tp2d.build_image_guidance(boxes, positions, KEYS, (16, 24), GuidanceConfig(**cfg),
                                    device="cpu")
    for field in ("masks", "k_fg", "k_bg"):
        r, g = getattr(ref, field), getattr(got, field)
        assert set(r) == set(g)
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
    for field in ("token_indices", "token_mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))


def test_decode_images_matches_lvd_tpu():
    from lvd_tpu.pipeline2d import decode_images as j_decode
    from lvd_tpu_torch.models.vae import init_vae

    params = init_vae(prng.prng_key(1), tcfg.tiny_vae_config(), device="cpu")
    lat = np.random.default_rng(4).standard_normal((2, 8, 12, 4)).astype(np.float32)
    ref = j_decode(_np_tree(params), jcfg.tiny_vae_config(), lat)
    got = tp2d.decode_images(params, tcfg.tiny_vae_config(), torch.from_numpy(lat))
    assert tuple(got.shape) == ref.shape == (2, 64, 96, 3)
    _close_rel(got.numpy(), ref)


# ---- layout/latents.py --------------------------------------------------------------------


def test_masks_centers_and_box_masks_are_lvd_tpus():
    for box, hw in (([0.25, 0.25, 0.75, 0.75], (8, 12)), ([0.0, 0.1, 0.33, 1.0], (16, 24)),
                    ([0.5, 0.5, 1.0, 1.0], (7, 9))):
        want = np.asarray(jlat.proportion_to_mask(box, *hw))
        got = tlat.proportion_to_mask(box, *hw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(8)
    for mask in ((rng.random((8, 12)) > 0.7).astype(np.float32), np.zeros((5, 6), np.float32)):
        np.testing.assert_array_equal(tlat.binary_mask_to_box_mask(torch.from_numpy(mask))
                                      .numpy(), np.asarray(jlat.binary_mask_to_box_mask(mask)))
        for norm in (True, False):
            assert tlat.binary_mask_to_center(torch.from_numpy(mask), norm) == \
                jlat.binary_mask_to_center(mask, norm)


@pytest.mark.parametrize("offset", [(0.25, -0.125), (-0.5, 0.3), (1.2, 0.0), (3.0, -2.0, False)])
def test_shifts_are_lvd_tpus(offset):
    x = np.random.default_rng(2).standard_normal((2, 1, 8, 12, 4)).astype(np.float32)
    want = np.asarray(jlat.shift_tensor(jnp.asarray(x), *offset))
    np.testing.assert_array_equal(tlat.shift_tensor(torch.from_numpy(x), *offset).numpy(), want)
    m = (x[0, 0, :, :, 0] > 0).astype(np.float32)
    np.testing.assert_array_equal(tlat.shift_mask(torch.from_numpy(m), *offset[:2]).numpy(),
                                  np.asarray(jlat.shift_mask(jnp.asarray(m), *offset[:2])))


def test_seeded_latents_and_blend_are_lvd_tpus():
    want = jlat.get_unscaled_latents(jax.random.PRNGKey(7), 2, 4, 64, 96)
    got = tlat.get_unscaled_latents(prng.prng_key(7), 2, 4, 64, 96, device="cpu")
    _close_rel(got.numpy(), want, 1e-6)
    boxes = [[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]
    for ratio, start in ((0.1, 100), ([0.2, 0.05], [11, 13])):
        ref_out, ref_bg = jlat.get_input_latents_list(4, 0, start, ratio, 64, 96, boxes,
                                                      init_noise_sigma=1.5)
        out, bg = tlat.get_input_latents_list(4, 0, start, ratio, 64, 96, boxes,
                                              init_noise_sigma=1.5, device="cpu")
        _close_rel(bg.numpy(), ref_bg, 1e-6)
        assert len(out) == len(ref_out) == 2
        for g, r in zip(out, ref_out):
            _close_rel(g.numpy(), r, 1e-6)
    with pytest.raises(ValueError, match="must differ"):
        tlat.get_input_latents_list(4, 3, 3, 0.1, 64, 96, boxes, device="cpu")


def test_composition_and_alignment_are_lvd_tpus():
    rng = np.random.default_rng(9)
    hists = [rng.standard_normal((4, 1, 8, 12, 4)).astype(np.float32) for _ in range(2)]
    masks = [np.array(jlat.proportion_to_mask(b, 8, 12))
             for b in ([0.0, 0.0, 0.5, 1.0], [0.5, 0.4, 1.0, 1.0])]
    bg = rng.standard_normal((1, 8, 12, 4)).astype(np.float32)
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    for box_to_bg in (True, False):
        ref, ref_idx = jlat.compose_latents(hists, masks, bg, compose_box_to_bg=box_to_bg)
        got, idx = tlat.compose_latents(t(hists), t(masks), torch.from_numpy(bg),
                                        compose_box_to_bg=box_to_bg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    overall = [[[0.6, 0.1, 0.9, 0.5]], [0.05, 0.5, 0.45, 0.95]]
    assert tlat.expand_overall_bboxes(overall) == jlat.expand_overall_bboxes(overall)
    for align, horizontal in ((True, False), (True, True), (False, False)):
        ref = jlat.compose_latents_with_alignment(hists, masks, bg, align, overall, horizontal)
        got = tlat.compose_latents_with_alignment(t(hists), t(masks), torch.from_numpy(bg),
                                                  align, overall, horizontal)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert got[2] == ref[2]
    ref = jlat.align_with_bboxes(hists, masks, jlat.expand_overall_bboxes(overall))
    got = tlat.align_with_bboxes(t(hists), t(masks), tlat.expand_overall_bboxes(overall))
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2] == ref[2]
    blended = tlat.blend_latents(torch.from_numpy(bg), torch.from_numpy(hists[0][0]),
                                 torch.from_numpy(masks[0]), 0.3)
    _close_rel(blended.numpy(), jlat.blend_latents(bg, hists[0][0], masks[0], 0.3), 1e-6)


# ---- models/encode.py ---------------------------------------------------------------------


@pytest.mark.parametrize("one_uncond", [False, True])
def test_encode_prompts_matches_lvd_tpu(one_uncond):
    from lvd_tpu.models.encode import encode_prompts as j_encode
    from lvd_tpu.text.tokenizer import load_tokenizer as j_tokenizer
    from lvd_tpu_torch.models.clip import init_clip_text
    from lvd_tpu_torch.text.tokenizer import load_tokenizer

    params = init_clip_text(prng.prng_key(2), tcfg.tiny_clip_config(), device="cpu")
    prompts = ["a cat on a mat", "two dogs in a park", "a red car"]
    ref = j_encode(_np_tree(params), jcfg.tiny_clip_config(), j_tokenizer(None), prompts,
                   "blurry", one_uncond_input_only=one_uncond)
    got = tenc.encode_prompts(params, tcfg.tiny_clip_config(), load_tokenizer(None), prompts,
                              "blurry", one_uncond_input_only=one_uncond)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        _close_rel(g.numpy(), r)
    text, uncond, cond = tenc.process_input_embeddings(got[0])
    assert torch.equal(uncond, got[1]) and torch.equal(cond, got[2]) and text is got[0]
    assert tenc.process_input_embeddings(got) == got
    with pytest.raises(ValueError, match="pair"):
        tenc.process_input_embeddings(got[0][:5])


def test_attn_list_to_tensor_is_lvd_tpus():
    from lvd_tpu.models.encode import attn_list_to_tensor as j_stack

    rng = np.random.default_rng(1)
    nested = [[rng.random((2, 3)).astype(np.float32) for _ in range(2)] for _ in range(3)]
    want = j_stack(nested)
    got = tenc.attn_list_to_tensor([[torch.from_numpy(a) for a in row] for row in nested])
    np.testing.assert_array_equal(got, want)
