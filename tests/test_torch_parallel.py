"""The port's frame-sharded UNet, sampler and guided update on 4 gloo ranks
of the CPU, against lvd_tpu (tests/test_parallel.py's shapes and seeds).

- the building blocks, forward and VJP through torch.autograd, against
  lvd_tpu's under shard_map / jax.vjp over 4 devices (1e-5): the
  frames <-> pixels all_to_all pair with P % 4 != 0 around a frame mix,
  the halo (3,1,1) conv, the psummed GroupNorm with ``count_override``;
- the tiny UNet forward (1, 8, 16, 24) against lvd_tpu's single-device
  forward (rtol 5e-4, atol 5e-5, lvd_tpu's own gate);
- 4 steps of unguided sampling (1, 8, 8, 8) against lvd_tpu's (2e-3 / 2e-4);
- the guided update's energy and gradient with the frame-coupled terms
  (CoM 0.03, attn-sync 0.1, an object appearing at a shard boundary)
  against ``jax.grad`` of lvd_tpu's single-device energy (1e-4 of
  max|ref|): a psum whose backward counted the replicated energy once per
  rank would be 4x off;
- ``param_spec`` on every leaf of the tiny default and gated trees against
  lvd_tpu's, exactly;
- the census of the tiny frame-sharded CFG forward at n = 8 against
  lvd_tpu's ``audit_collectives`` of the lowered shard_map, per kind, count
  and resident bytes exactly;
- a frame count the ranks do not divide is refused.

The ranks are one module-scoped pool (parallel/launch.RankPool, a FileStore
under the test's temporary directory), one torch thread each; they import
neither jax nor lvd_tpu (tests/_torch_parallel_ranks.py).
"""

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from lvd_tpu_torch.utils import prng

N = 4
KEYS = (("down", 1, 0, 0), ("up", 1, 0, 0))


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


def jax_mesh(n=N):
    from lvd_tpu.parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(n, model_parallel=1)


def _sharded(fn, in_specs, out_specs, n=N):
    import jax
    from jax import shard_map

    return jax.jit(shard_map(fn, mesh=jax_mesh(n), in_specs=in_specs, out_specs=out_specs))


def _ops_inputs(rng):
    y = rng.standard_normal((1, 8, 13, 16)).astype(np.float32)
    ct = rng.standard_normal(y.shape).astype(np.float32)
    w = (rng.standard_normal((3, 1, 1, 16, 16)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    return y, ct, w, b


@pytest.mark.parametrize("kind", ["a2a", "halo", "group_norm"])
def test_building_blocks_and_their_vjps_match_shard_map(pool, kind):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from lvd_tpu.models import unet3d as ju
    from lvd_tpu.ops.basic import group_norm

    y, ct, w, b = _ops_inputs(np.random.default_rng(3))
    count = None
    if kind == "group_norm":
        y[:, 6:] = 0.0  # two frames of zero padding, left out of the count
        count = 6 * 13 * 16 // 4
    frames = P(None, "data")

    def fn(x):
        if kind == "a2a":
            z, p = ju._a2a_frames_to_pixels(x, "data")
            return ju._a2a_pixels_to_frames(jnp.cumsum(z, axis=1) * 0.5, "data", p)
        if kind == "halo":
            return ju._halo_conv3d_frames({"w": jnp.asarray(w), "b": jnp.asarray(b)}, x, "data")
        c = x.shape[-1]
        p = {"scale": jnp.linspace(0.5, 1.5, c), "bias": jnp.linspace(-0.2, 0.2, c)}
        return group_norm(p, x, 4, 1e-5, axis_name="data", count_override=count)

    sharded = _sharded(fn, (frames,), frames)
    want, vjp = jax.vjp(sharded, jnp.asarray(y))
    (want_grad,) = vjp(jnp.asarray(ct))
    outs = pool.run(ranks.ops_case, kind, y, ct, count if kind == "group_norm" else w, b)
    got = np.concatenate([o for o, _ in outs], axis=1)
    got_grad = np.concatenate([g for _, g in outs], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), rtol=1e-5, atol=1e-5)


def _tiny_params_jax():
    import jax.numpy as jnp

    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import init_unet3d

    params = init_unet3d((0, 0), tcfg.tiny_unet_config(), device="cpu")
    import jax

    return params, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)


def test_sharded_unet_forward_matches_lvd_tpu(pool):
    import jax
    import jax.numpy as jnp

    from lvd_tpu.config import tiny_unet_config
    from lvd_tpu.models.unet3d import apply_unet3d

    cfg = tiny_unet_config()
    _, params = _tiny_params_jax()
    sample = prng.normal(1, (1, 8, 16, 24, 4))
    text = prng.normal(2, (1, 77, cfg.cross_attention_dim))
    ref, _ = jax.jit(lambda p, s, c: apply_unet3d(p, cfg, s, jnp.int32(500), c))(
        params, jnp.asarray(sample), jnp.asarray(text))
    got = np.concatenate(pool.run(ranks.unet_forward, sample, text), axis=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-4, atol=5e-5)


def test_sharded_sampling_matches_lvd_tpu(pool):
    import jax
    import jax.numpy as jnp

    from lvd_tpu.config import SchedulerConfig, tiny_unet_config
    from lvd_tpu.diffusion import dpm_solver as dpm
    from lvd_tpu.diffusion.sampler import sample_video

    cfg = tiny_unet_config()
    _, params = _tiny_params_jax()
    latents = prng.normal(1, (1, 8, 8, 8, 4))
    text = prng.normal(2, (2, 77, cfg.cross_attention_dim))
    coeffs = dpm.make_coeffs(SchedulerConfig(), 4)
    ref = jax.jit(lambda p, l, t, c: sample_video(p, cfg, l, t, c, guidance_scale=7.5))(
        params, jnp.asarray(latents), jnp.asarray(text), coeffs)
    got = np.concatenate(pool.run(ranks.sampling, latents, text, 4), axis=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=2e-4)


# tests/test_parallel.py's frame-coupled guidance: one moving object and one
# that appears at frame 4, a shard boundary of 4 ranks.
BOXES = [[[0.05 + 0.05 * f, 0.1, 0.35 + 0.05 * f, 0.6] for f in range(8)],
         [[0.0, 0.0, 0.0, 0.0]] * 4 + [[0.5, 0.5, 0.9, 0.9]] * 4]
COUPLED = dict(max_index_step=2, max_iter=1, loss_scale=2.0, loss_threshold=1e-6,
               com_loss_scale=0.03, attn_sync_weight=0.1)


def test_sharded_guided_update_gradient_matches_jax_grad(pool):
    """The psum trap: the energy is replicated on every rank, and its
    gradient must not come out 4x."""
    import jax
    import jax.numpy as jnp

    from lvd_tpu.config import tiny_unet_config
    from lvd_tpu.diffusion.guidance import GuidanceConfig, compute_ca_energy
    from lvd_tpu.diffusion.sampler import pack_to_arrays
    from lvd_tpu.layout.rasterize import make_guidance_pack
    from lvd_tpu.models.unet3d import apply_unet3d
    from lvd_tpu_torch.utils.tree import flatten

    cfg = tiny_unet_config()
    tparams, params = _tiny_params_jax()
    lat = prng.normal(5, (1, 8, 8, 12, 4))
    cond = prng.normal(6, (1, 77, cfg.cross_attention_dim))
    pack = make_guidance_pack(BOXES, [[2], [3]], KEYS, (8, 12))
    g_cfg = GuidanceConfig(**COUPLED)

    def energy(p, x):
        _, aux = apply_unet3d(p, cfg, x, 601, jnp.asarray(cond), capture_keys=KEYS,
                              capture_only=True)
        return compute_ca_energy(aux, pack_to_arrays(pack), KEYS, g_cfg) * g_cfg.loss_scale

    want_e, want_g = jax.jit(jax.value_and_grad(energy, argnums=1))(params, jnp.asarray(lat))
    arrays = {"masks": dict(pack.masks), "token_indices": np.asarray(pack.token_indices),
              "token_mask": np.asarray(pack.token_mask), "k_fg": dict(pack.k_fg),
              "k_bg": dict(pack.k_bg)}
    flat = {k: v.numpy() for k, v in flatten(tparams).items()}
    outs = pool.run(ranks.guided_update, flat, lat, cond, arrays, KEYS, COUPLED, 601)
    energies = [e for e, _ in outs]
    assert len(set(energies)) == 1, energies  # every rank reads the all-reduced energy
    np.testing.assert_allclose(energies[0], float(want_e), rtol=1e-4)
    got = np.concatenate([g for _, g in outs], axis=1)
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    err = np.abs(got - want_g).max() / np.abs(want_g).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("attention_type", ["default", "gated"])
def test_param_spec_matches_lvd_tpu_on_every_leaf(attention_type):
    import jax

    from lvd_tpu.config import tiny_unet_config
    from lvd_tpu.models.unet3d import init_unet3d as j_init
    from lvd_tpu.parallel import mesh as jmesh
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.parallel import mesh as tmesh
    from lvd_tpu_torch.utils.tree import flatten

    shapes = jax.eval_shape(lambda k: j_init(k, tiny_unet_config(attention_type)),
                            jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path):
            tuple(jmesh.param_spec(path, leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    leaves = flatten(init_unet3d((0, 0), tcfg.tiny_unet_config(attention_type), device="cpu"))
    got = {p: tmesh.param_spec(p, t) for p, t in leaves.items()}
    assert got == want
    assert set(got.values()) == {(), (None, "model"), ("model", None)}


def test_census_matches_lvd_tpu_audit():
    """One frame-sharded CFG forward of the tiny UNet at n = 8: the port's
    recorded collectives against those in lvd_tpu's lowered module."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from lvd_tpu.config import tiny_unet_config
    from lvd_tpu.models.unet3d import apply_unet3d, init_unet3d as j_init
    from lvd_tpu.parallel.audit import audit_collectives as j_audit
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.parallel import audit

    n, f, h, w = 8, 8, 16, 24
    cfg = tiny_unet_config()
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, jnp.bfloat16),
                                    jax.eval_shape(lambda k: j_init(k, cfg), jax.random.PRNGKey(0)))

    def fwd(p_, lat, txt):
        eps, _ = apply_unet3d(p_, cfg, jnp.concatenate([lat, lat]), 500, txt, spmd_axis="data")
        return eps

    from jax import shard_map

    sharded = shard_map(fwd, mesh=jax_mesh(n), in_specs=(P(), P(None, "data"), P()),
                        out_specs=P(None, "data"))
    want = j_audit(sharded, params, jnp.zeros((1, f, h, w, 4), jnp.bfloat16),
                   jnp.zeros((2, 77, cfg.cross_attention_dim), jnp.bfloat16), n_devices=n)
    tc = tcfg.tiny_unet_config()
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    got = audit.audit_collectives(audit.cfg_forward, audit.meta_params(tc), tc,
                                  meta(1, f // n, h, w, 4), meta(2, 77, tc.cross_attention_dim),
                                  n_devices=n)
    assert set(got) == set(want) == {"all_reduce", "all_to_all", "collective_permute", "total"}
    for kind in want:
        assert got[kind] == want[kind], (kind, got[kind], want[kind])


def test_frames_the_ranks_do_not_divide_are_refused():
    """As shard_map refuses them: the pipeline's split of the noise, and
    the trainer's split of the batch, raise before any collective."""
    from lvd_tpu_torch.models.loader import tiny_pipeline_models
    from lvd_tpu_torch.parallel import comm
    from lvd_tpu_torch.parallel.mesh import Mesh
    from lvd_tpu_torch.pipeline import TextToVideoPipeline
    from lvd_tpu_torch.training.train import shard_batch

    mesh = Mesh(comm.Group.recording("data", 4), comm.Group.recording("model", 1))
    pipe = TextToVideoPipeline(tiny_pipeline_models(device="cpu"), device="cpu", mesh=mesh)
    comm.reset_census()
    with pytest.raises(ValueError, match="does not divide over the 4 ranks"):
        pipe("a red ball", num_frames=6, num_inference_steps=2, seed=0)
    with pytest.raises(ValueError, match="does not divide over the 4 ranks"):
        shard_batch(mesh, {"latents": torch.zeros(3, 2, 8, 8, 4)})
    assert comm.read_census() == {}
