"""The port's UNet2D, CLIP's penultimate state and projection, and the SDXL
refiner against lvd_tpu's on the CPU.

- ``init_unet2d`` walks lvd_tpu's ``split(key, 256)`` tree: held leaf for
  leaf against lvd_tpu's init on the same key (its body run eagerly, which
  compiles per shape in seconds where the jitted init takes ~30 s a config)
  at ``tiny_unet2d_config()``, its gated form and the upsample CLI's tiny
  SDXL refiner (depth 2, text_time): the same paths and shapes, zeros and
  ones equal, every drawn leaf within 1e-6 of max|ref| (the normals' erfinv
  log1p is torch's); the random bits of the sampled leaves are equal;
- a depth-1 spatial transformer draws what it drew before depth existed
  (keys 0-2 of ``split(key, 3)``), and depth 2 takes keys 2 and 3 of
  ``split(key, 4)``, as lvd_tpu's ``_init_spatial_transformer``;
- ``apply_unet2d`` on the gated tiny tree (gates open, proj_out drawn) with
  GLIGEN inputs and three capture keys, at an odd size whose upsample
  overshoots (the nearest resize), against lvd_tpu's jitted apply: noise
  and captured probabilities within 1e-4 of max|ref|;
- ``apply_clip_text(..., return_penultimate=True)`` with a projection: the
  penultimate state, the final state and ``text_embeds`` within 1e-4;
- the tiny ``SDXLRefinerPipeline`` (the CLI's tiny refiner) on one 64x96
  frame, 4 steps at strength 0.5 (2 tail steps of CFG 7.5), against
  lvd_tpu's: the image within 1e-4 of max|ref|.

CPU, fp32, one torch thread; each lvd_tpu function compiles once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvd_tpu.models import unet2d as j_u2
from lvd_tpu.models import unet3d as j_u3
from lvd_tpu_torch.cli.upsample import tiny_sdxl_configs
from lvd_tpu_torch.models import unet2d as t_u2
from lvd_tpu_torch.models import unet3d as t_u3
from lvd_tpu_torch.models.loader import params_from_numpy
from lvd_tpu_torch.utils import prng

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the whole module, its module fixtures' draws
    included (autouse fixtures of a scope are set up before the others):
    the suite runs six workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _close_rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max|d|/max|ref| = {err:.3g} > {tol}"


def _lvd_tpu_config(cfg):
    """lvd_tpu's UNet2DConfig with the port's config's fields."""
    import dataclasses

    return j_u2.UNet2DConfig(**dataclasses.asdict(cfg))


CONFIGS = {"tiny": lambda: t_u2.tiny_unet2d_config(),
           "tiny_gated": lambda: t_u2.tiny_unet2d_config("gated"),
           "tiny_sdxl": lambda: tiny_sdxl_configs()[0]}


@pytest.fixture(scope="module")
def lvd_tpu_draws():
    """{name: lvd_tpu's init_unet2d on fold_in(PRNGKey(5), 2) as numpy},
    its body run eagerly."""
    raw = j_u2._init_unet2d_jit.__wrapped__
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    return {name: jax.tree_util.tree_map(np.array, jax.device_get(
        raw(key, _lvd_tpu_config(cfg())))) for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_unet2d_draws_lvd_tpus_weights(lvd_tpu_draws, name):
    cfg = CONFIGS[name]()
    key = prng.fold_in(prng.prng_key(5), 2)
    leaves = _flat(t_u2.unet2d_leaves(key, cfg))
    got = _flat(t_u2.init_unet2d(key, cfg, "cpu"))
    ref = _flat(lvd_tpu_draws[name])
    assert sorted(got) == sorted(ref) == sorted(leaves)
    drawn = 0
    for path, r in ref.items():
        g = got[path].numpy()
        assert g.shape == r.shape and g.dtype == np.float32, path
        if np.all(r == r.flat[0]) and r.flat[0] in (0.0, 1.0):
            np.testing.assert_array_equal(g, r, err_msg=path)
        else:
            drawn += 1
            assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), path
    assert drawn > 0
    # The random bits of sampled leaves, against jax.random.bits on the
    # leaf's key: conv_in, the first attention's to_q, the last conv.
    attn = next(p for p in leaves if p.endswith("attn1/to_q/w"))
    for path in ("conv_in/w", attn, "conv_out/w"):
        leaf = leaves[path]
        jkey = jnp.asarray(np.asarray(leaf.key, np.uint32))
        want = np.asarray(jax.random.bits(jkey, leaf.shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits(leaf.key, leaf.shape).numpy(), want)
    if name == "tiny_sdxl":
        assert len(got) > 0 and "add_embedding/linear_1/w" in got
        assert len(lvd_tpu_draws[name]["down_blocks"][1]["layers"][0]["attn"]["blocks"]) == 2


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer_depth_draw(depth):
    key = prng.fold_in(prng.prng_key(9), 4)
    got = t_u3._spatial_transformer_leaves(key, 32, 24, False, depth)
    ref = jax.device_get(j_u3._init_spatial_transformer(
        jax.random.fold_in(jax.random.PRNGKey(9), 4), 32, 24, gated=False, depth=depth))
    assert len(got["blocks"]) == depth
    gf, rf = _flat(got), _flat(ref)
    assert sorted(gf) == sorted(rf)
    for path, leaf in gf.items():
        if hasattr(leaf, "key"):
            r = np.asarray(rf[path])
            g = prng.normal_key(leaf.key, leaf.shape).numpy() * leaf.scale
            assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), path
    if depth == 1:  # the draw before depth existed: split(key, 3), block from key 2
        k = prng.split(key, 3)
        assert got["proj_in"]["w"].key == k[0] and got["proj_out"]["w"].key == k[1]
        assert got == t_u3._spatial_transformer_leaves(key, 32, 24, False)
        assert got["blocks"][0] == t_u3._btb_leaves(k[2], 32, 24)


def _open(tree, rng):
    """Each fuser's gates at 0.5 and each spatial transformer's proj_out a
    normal * fan_in^-1/2 weight, so the fuser's branch reaches the output;
    the PositionNet's null features drawn."""
    if isinstance(tree, list):
        return [_open(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("alpha_attn", "alpha_dense"):
            out[k] = np.float32(0.5)
        elif k in ("null_positive_feature", "null_position_feature"):
            out[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif k == "proj_out":
            w = v["w"]
            out[k] = {**v, "w": (rng.standard_normal(w.shape) * w.shape[0] ** -0.5)
                      .astype(np.float32)}
        else:
            out[k] = _open(v, rng)
    return out


def test_apply_unet2d_matches_lvd_tpu(lvd_tpu_draws):
    cfg = CONFIGS["tiny_gated"]()
    jcfg = _lvd_tpu_config(cfg)
    rng = np.random.default_rng(3)
    tree = _open(lvd_tpu_draws["tiny_gated"], rng)
    x = rng.standard_normal((2, 18, 22, 4)).astype(np.float32)  # 18 -> 9 -> 5 -> 3 -> 6 != 5
    text = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    gligen = {"boxes": rng.uniform(0, 1, (2, 3, 4)).astype(np.float32),
              "masks": np.array([[1, 1, 0], [1, 0, 0]], np.float32),
              "positive_embeddings": rng.standard_normal(
                  (2, 3, cfg.gligen_positive_len)).astype(np.float32)}
    keys = (("down", 1, 0, 0), ("mid", 0, 0, 0), ("up", 1, 2, 0))
    ref, ref_aux = jax.jit(lambda p, x, c, g: j_u2.apply_unet2d(
        p, jcfg, x, 400, c, gligen=g, capture_keys=keys))(tree, x, text, gligen)
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        got, aux = t_u2.apply_unet2d(params_from_numpy(tree, "cpu"), cfg, t(x), 400, t(text),
                                     gligen={k: t(v) for k, v in gligen.items()},
                                     capture_keys=keys)
    _close_rel(got.numpy(), ref)
    assert sorted(aux) == sorted(ref_aux) == sorted(keys)
    for k in keys:
        _close_rel(aux[k].numpy(), ref_aux[k])
    # The fuser matters here: the same walk without grounding moves the output.
    with torch.no_grad():
        plain, _ = t_u2.apply_unet2d(params_from_numpy(tree, "cpu"), cfg, t(x), 400, t(text))
    assert np.abs(plain.numpy() - ref).max() > 1e-3 * np.abs(ref).max()


def test_clip_penultimate_and_projection_match_lvd_tpu():
    from lvd_tpu.config import CLIPTextConfig as JConfig
    from lvd_tpu.models.clip import apply_clip_text as j_apply
    from lvd_tpu.models.clip import init_clip_text as j_init
    from lvd_tpu_torch.config import CLIPTextConfig
    from lvd_tpu_torch.models.clip import apply_clip_text

    kw = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
              projection_dim=16)
    params = jax.tree_util.tree_map(np.array, jax.device_get(
        j_init(jax.random.PRNGKey(0), JConfig(**kw), with_projection=True)))
    ids = np.random.default_rng(0).integers(0, 1000, (2, 12))
    ids[:, -3] = 49407
    ref = j_apply(params, JConfig(**kw), jnp.asarray(ids, jnp.int32), return_penultimate=True)
    got = apply_clip_text(params_from_numpy(params, "cpu"), CLIPTextConfig(**kw),
                          torch.from_numpy(ids), return_penultimate=True)
    assert sorted(got) == sorted(ref) == ["last_hidden_state", "penultimate_hidden_state",
                                          "pooler_output", "text_embeds"]
    for k in got:
        _close_rel(got[k].numpy(), ref[k])
    assert got["text_embeds"].shape == (2, 16)
    assert "penultimate_hidden_state" not in apply_clip_text(
        params_from_numpy(params, "cpu"), CLIPTextConfig(**kw), torch.from_numpy(ids))


def sdxl_pipelines():
    """(lvd_tpu's tiny SDXLRefinerPipeline, the port's), fp32, on the same
    weights: the upsample CLI's tiny refiner drawn by the port in lvd_tpu's
    key order (``split(PRNGKey(0), 3)``), bridged to lvd_tpu as numpy."""
    import dataclasses

    from lvd_tpu.config import CLIPTextConfig as JClip
    from lvd_tpu.config import SchedulerConfig as JSched
    from lvd_tpu.config import VAEConfig as JVae
    from lvd_tpu.pipeline_sdxl import SDXLRefinerModels as JModels
    from lvd_tpu.pipeline_sdxl import SDXLRefinerPipeline as JPipe
    from lvd_tpu.text.tokenizer import load_tokenizer as jtokenizer
    from lvd_tpu_torch import pipeline_sdxl as ps

    unet_cfg, clip_cfg, vae_cfg = tiny_sdxl_configs()
    models = ps.drawn_refiner_models(unet_cfg, clip_cfg, vae_cfg, seed=0, device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(lambda v: v.numpy(), t)
    jmodels = JModels(
        unet_cfg=_lvd_tpu_config(unet_cfg), clip_cfg=JClip(**dataclasses.asdict(clip_cfg)),
        vae_cfg=JVae(**dataclasses.asdict(vae_cfg)), scheduler=JSched(),
        unet_params=np_tree(models.unet_params), clip_params=np_tree(models.clip_params),
        vae_params=np_tree(models.vae_params), tokenizer=jtokenizer(None))
    return (JPipe(jmodels, dtype=jnp.float32),
            ps.SDXLRefinerPipeline(models, dtype=torch.float32, device="cpu"))


def test_sdxl_refiner_pipeline_matches_lvd_tpu():
    jpipe, pipe = sdxl_pipelines()
    image = np.random.default_rng(4).random((64, 96, 3)).astype(np.float32)
    kw = dict(strength=0.5, num_inference_steps=4, seed=2)
    ref = jpipe("a bear in a forest", image, **kw)
    got = pipe("a bear in a forest", image, **kw)
    assert got.shape == ref.shape == (64, 96, 3)
    _close_rel(got, ref)
    assert len(pipe.timings["steps"]) == 2
