"""The port's JAX PRNG and lvd_tpu's random weights in its key order.

``split``, ``fold_in`` and the random bits are held bit-exact against
``jax.random``; the normals within 1e-6 (their erfinv's log1p is torch's,
not XLA's: they differ by an ulp or two). Each ``init_*`` of the port walks
lvd_tpu's split tree and is held leaf for leaf against lvd_tpu's on the same
key: the same key paths and shapes, zeros and ones equal, every drawn leaf
within 1e-6 of its max|ref|. The UNet runs on ``dryrun_unet_config``
(lvd_tpu's jitted ``init_unet3d`` compiles ~25 s there, ~150 s on the tiny
config, whose tree the same code builds). CPU, fp32, one torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvd_tpu_torch.utils import prng


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEEDS = [0, 1, 123456, 2 ** 31 - 1]


def _key(jkey):
    return tuple(int(v) for v in np.asarray(jkey))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_are_bit_exact(seed):
    jk, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert _key(jk) == k
    for num in (1, 2, 3, 7, 16 + 8 * 2):
        assert [_key(r) for r in jax.random.split(jk, num)] == prng.split(k, num)
    for data in (0, 1, 5, 65535, 65536, 70001, 2 ** 31 + 3, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(jk, data)) == prng.fold_in(k, data)
    # a key of a key: the second level of lvd_tpu's trees
    sub = jax.random.split(jax.random.fold_in(jk, 70001), 4)[3]
    assert _key(sub) == prng.split(prng.fold_in(k, 70001), 4)[3]


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 3, 3), (3, 70001)])
def test_random_bits_are_bit_exact_and_normals_close(shape):
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        k = prng.fold_in(prng.prng_key(seed), 3)
        bits = prng.random_bits(k, shape)
        assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
        np.testing.assert_array_equal(bits.numpy(),
                                      np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
        got = prng.normal_key(k, shape)
        want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert np.abs(got.numpy() - want).max() <= 1e-6
        # the bits of elements taken alone are the draw's
        idx = torch.arange(bits.numel())[::7]
        assert torch.equal(prng.random_bits_at(k, idx), bits.reshape(-1)[idx])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def assert_same_draw(got, ref):
    """Same key paths and shapes; lvd_tpu's zeros and ones exactly, every
    drawn leaf within 1e-6 of its max|ref|."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    drawn = 0
    for path, r in ref.items():
        g, r = np.asarray(got[path]), np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32, path
        if np.all(r == r.flat[0]) and r.flat[0] in (0.0, 1.0):
            np.testing.assert_array_equal(g, r, err_msg=path)
        else:
            drawn += 1
            assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max(), path
    assert drawn > 0


def _inits():
    from lvd_tpu import config as jcfg
    from lvd_tpu.models import clip as jclip
    from lvd_tpu.models import gligen as jgligen
    from lvd_tpu.models import unet3d as junet
    from lvd_tpu.models import vae as jvae
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models import clip, gligen, unet3d, vae

    return {
        "unet_default": (lambda k: junet.init_unet3d(k, jcfg.dryrun_unet_config("default")),
                         lambda k: unet3d.init_unet3d(k, tcfg.dryrun_unet_config("default"), "cpu")),
        "unet_gated": (lambda k: junet.init_unet3d(k, jcfg.dryrun_unet_config("gated")),
                       lambda k: unet3d.init_unet3d(k, tcfg.dryrun_unet_config("gated"), "cpu")),
        "clip": (lambda k: jclip.init_clip_text(k, jcfg.tiny_clip_config()),
                 lambda k: clip.init_clip_text(k, tcfg.tiny_clip_config(), device="cpu")),
        "clip_projection": (
            lambda k: jclip.init_clip_text(k, jcfg.tiny_clip_config(), with_projection=True),
            lambda k: clip.init_clip_text(k, tcfg.tiny_clip_config(), True, device="cpu")),
        "vae": (lambda k: jvae.init_vae(k, jcfg.tiny_vae_config()),
                lambda k: vae.init_vae(k, tcfg.tiny_vae_config(), device="cpu")),
        "position_net": (lambda k: jgligen.init_position_net(k, 96, 64, 8),
                         lambda k: gligen.init_position_net(k, 96, 64, 8, device="cpu")),
    }


@pytest.mark.parametrize("name", ["unet_default", "unet_gated", "clip", "clip_projection",
                                  "vae", "position_net"])
def test_init_draws_lvd_tpus_weights(name):
    ref_fn, got_fn = _inits()[name]
    seed = 3
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    ref = jax.device_get(ref_fn(key))
    got = got_fn(prng.fold_in(prng.prng_key(seed), 11))
    assert_same_draw(got, ref)
    if name == "vae":  # the encoder is drawn too, before the decoder
        assert "encoder" in got and "quant_conv" in got


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


def _lvd_tpu_tiny(attention_type, monkeypatch):
    """lvd_tpu's tiny preset and the shapes of its trees, by tracing its init
    functions only (``jax.eval_shape``), never compiling them."""
    from lvd_tpu.models import loader as jloader

    for mod, name in ((jloader.unet_mod, "init_unet3d"), (jloader.clip_mod, "init_clip_text"),
                      (jloader.vae_mod, "init_vae")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda k, cfg, real=real: jax.eval_shape(
            lambda kk: real(kk, cfg), k))
    return jloader.tiny_pipeline_models(attention_type=attention_type)


@pytest.mark.parametrize("attention_type", ["default", "gated"])
def test_tiny_pipeline_models_are_lvd_tpus(attention_type, monkeypatch):
    """lvd_tpu's preset and trees; the UNet, CLIP and VAE of
    ``split(PRNGKey(0), 3)``, as lvd_tpu draws them."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models import clip, unet3d, vae
    from lvd_tpu_torch.models.loader import tiny_pipeline_models

    ref = _lvd_tpu_tiny(attention_type, monkeypatch)
    got = tiny_pipeline_models(attention_type=attention_type, device="cpu")
    assert dataclasses.asdict(got.preset) == dataclasses.asdict(ref.preset)
    for name in ("unet_params", "clip_params", "vae_params"):
        assert _shapes(getattr(got, name)) == _shapes(getattr(ref, name))
    k = prng.split(prng.prng_key(0), 3)
    want = {"unet_params": unet3d.init_unet3d(k[0], tcfg.tiny_unet_config(attention_type), "cpu"),
            "clip_params": clip.init_clip_text(k[1], tcfg.tiny_clip_config(), device="cpu"),
            "vae_params": vae.init_vae(k[2], tcfg.tiny_vae_config(), "cpu")}
    for name, tree in want.items():
        flat = _flat(getattr(got, name))
        assert all(torch.equal(flat[p], v) for p, v in _flat(tree).items())
    assert type(got.tokenizer).__name__ == type(ref.tokenizer).__name__
