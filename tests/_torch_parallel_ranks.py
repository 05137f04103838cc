"""What each gloo rank of tests/test_torch_parallel*.py runs, in processes of
torch's spawn context (lvd_tpu_torch/parallel/launch.RankPool). This module
imports neither jax nor lvd_tpu; inputs come in and results go out as
numpy arrays."""

import numpy as np
import torch

_MESHES = {}


def mesh(model_parallel=1):
    """The rank's mesh, made once a world (every rank makes its groups in
    the same order)."""
    from lvd_tpu_torch.parallel.mesh import make_mesh

    if model_parallel not in _MESHES:
        _MESHES[model_parallel] = make_mesh(model_parallel=model_parallel)
    return _MESHES[model_parallel]


def _t(a):
    return torch.from_numpy(np.array(a))


def ops_case(kind, y, ct, w=None, b=None):
    """One building block of the sharded UNet on this rank's frames of y:
    its output block and the VJP of ``ct`` (the cotangent's block) in y."""
    from lvd_tpu_torch.models import unet3d
    from lvd_tpu_torch.ops.basic import group_norm
    from lvd_tpu_torch.parallel.mesh import block

    axis = mesh().data
    x = block(_t(y), axis, 1).clone().requires_grad_(True)
    if kind == "a2a":
        z, p = unet3d._a2a_frames_to_pixels(x, axis)
        out = unet3d._a2a_pixels_to_frames(torch.cumsum(z, dim=1) * 0.5, axis, p)
    elif kind == "halo":
        out = unet3d._halo_conv3d_frames({"w": _t(w), "b": _t(b)}, x, axis)
    else:  # GroupNorm over the frames of every rank, the padded frames uncounted
        c = y.shape[-1]
        p = {"scale": torch.linspace(0.5, 1.5, c), "bias": torch.linspace(-0.2, 0.2, c)}
        out = group_norm(p, x, 4, 1e-5, axis_name=axis, count_override=int(w))
    (grad,) = torch.autograd.grad(out, x, grad_outputs=block(_t(ct), axis, 1))
    return out.detach().numpy(), grad.numpy()


def unet_forward(sample, text):
    """The tiny UNet (lvd_tpu's key order from key 0) on this rank's frames."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import apply_unet3d, init_unet3d
    from lvd_tpu_torch.parallel.mesh import block

    cfg = tcfg.tiny_unet_config()
    params = init_unet3d((0, 0), cfg, device="cpu")
    axis = mesh().data
    with torch.no_grad():
        out = apply_unet3d(params, cfg, block(_t(sample), axis, 1), 500, _t(text),
                           spmd_axis=axis)
    return out.numpy()


def sampling(latents, text, steps):
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.diffusion import dpm_solver as dpm
    from lvd_tpu_torch.diffusion.sampler import sample_video
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.parallel.mesh import block

    cfg = tcfg.tiny_unet_config()
    params = init_unet3d((0, 0), cfg, device="cpu")
    axis = mesh().data
    with torch.no_grad():
        out = sample_video(params, cfg, block(_t(latents), axis, 1), _t(text),
                           dpm.make_coeffs(tcfg.SchedulerConfig(), steps), guidance_scale=7.5,
                           spmd_axis=axis)
    return out.numpy()


def guided_update(params_flat, lat, cond, pack, keys, cfg_kwargs, timestep):
    """The loss-scaled energy and d(energy)/d(latents) of this rank's frames."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.diffusion.guidance import GuidanceConfig
    from lvd_tpu_torch.diffusion.sampler import GuidanceTensors, energy_and_grad
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.parallel.mesh import block
    from lvd_tpu_torch.utils.tree import flatten, unflatten_like

    cfg = tcfg.tiny_unet_config()
    template = init_unet3d((0, 0), cfg, device="cpu")
    params = unflatten_like(template, {k: _t(v) for k, v in params_flat.items()})
    axis = mesh().data
    frames = lambda a: block(_t(a), axis, 1)
    guide = GuidanceTensors(masks={k: frames(v) for k, v in pack["masks"].items()},
                            token_indices=_t(pack["token_indices"]).long(),
                            token_mask=_t(pack["token_mask"]),
                            k_fg={k: frames(v) for k, v in pack["k_fg"].items()},
                            k_bg={k: frames(v) for k, v in pack["k_bg"].items()})
    energy, grad = energy_and_grad(params, cfg, frames(lat), timestep, _t(cond), guide, keys,
                                   GuidanceConfig(**cfg_kwargs), torch.float32, spmd_axis=axis)
    return float(energy), grad.numpy()


def open_gates(tree, value=0.5):
    """The GLIGEN fusers' gates opened (lvd_tpu's init leaves them shut)."""
    if isinstance(tree, list):
        return [open_gates(v, value) for v in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: torch.full_like(v, value) if k in ("alpha_attn", "alpha_dense")
            else open_gates(v, value) for k, v in tree.items()}


def pipeline(call, gated=False, use_mesh=True):
    """The tiny pipeline's ``__call__(**call)`` (lvd_tpu's tiny models, fp32,
    on the CPU), frame-sharded over the ranks with ``use_mesh``."""
    from lvd_tpu_torch.models.loader import tiny_pipeline_models
    from lvd_tpu_torch.pipeline import TextToVideoPipeline

    models = tiny_pipeline_models(attention_type="gated" if gated else "default", device="cpu")
    if gated:
        models.unet_params = open_gates(models.unet_params)
    pipe = TextToVideoPipeline(models, dtype=torch.float32, device="cpu",
                               mesh=mesh() if use_mesh else None)
    out = pipe(**call)
    return out.numpy() if torch.is_tensor(out) else out


def _trainer(cfg, lr, adapter_only, params, m):
    from lvd_tpu_torch.training import train

    trainer = train.Trainer(unet_cfg=cfg, learning_rate=lr, adapter_only=adapter_only)
    return trainer, trainer.init(params, mesh=m), trainer.make_step(mesh=m)


def _full_params(state, m):
    """Every leaf of the state, gathered whole (as save_train_state does)."""
    from lvd_tpu_torch.parallel.mesh import full_leaf
    from lvd_tpu_torch.utils.tree import flatten

    return {p: full_leaf(m, p, t).numpy().copy() for p, t in flatten(state.params).items()}


def train_step(gated, lr, adapter_only, batch, key_seed, model_parallel):
    """One mesh Trainer step from the tiny UNet (key 0): the global loss,
    the full params after it, and this rank's block sizes of a column- and
    a row-sharded leaf."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.training import train
    from lvd_tpu_torch.utils import prng
    from lvd_tpu_torch.utils.tree import flatten

    cfg = tcfg.tiny_unet_config("gated" if gated else "default")
    m = mesh(model_parallel)
    _, state, step = _trainer(cfg, lr, adapter_only, init_unet3d((0, 0), cfg, device="cpu"), m)
    local = flatten(state.params)
    blocks = {p: tuple(local[p].shape) for p in local
              if p.endswith(("attn1/to_q/w", "attn1/to_out/w", "ff/proj/w"))}
    tree = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else _t(v))
            for k, v in batch.items()}
    state, loss = step(state, train.shard_batch(m, tree), prng.prng_key(key_seed))
    moments = {p: tuple(t.shape) for p, t in state.opt_state["mu"].items()}
    return float(loss), _full_params(state, m), blocks, moments


def checkpoint_round_trip(batch, path, model_parallel):
    """A state saved under the mesh after one step and restored into a fresh
    mesh init continues like the state that never stopped: (losses, equal
    params, equal moments)."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.training import train
    from lvd_tpu_torch.utils import prng
    from lvd_tpu_torch.utils.tree import flatten

    cfg = tcfg.tiny_unet_config()
    m = mesh(model_parallel)
    tree = train.shard_batch(m, {k: _t(v) for k, v in batch.items()})
    _, state, step = _trainer(cfg, 1e-3, False, init_unet3d((0, 0), cfg, device="cpu"), m)
    state, _ = step(state, tree, prng.prng_key(0))
    train.save_train_state(path, state, mesh=m)
    _, fresh, _ = _trainer(cfg, 1e-3, False, init_unet3d((9, 9), cfg, device="cpu"), m)
    restored = train.restore_train_state(path, fresh, mesh=m)
    a, loss_a = step(state, tree, prng.prng_key(1))
    b, loss_b = step(restored, tree, prng.prng_key(1))
    same = lambda x, y: all(torch.equal(x[k], y[k]) for k in x) and x.keys() == y.keys()
    return (restored.step, float(loss_a), float(loss_b),
            same(flatten(a.params), flatten(b.params)),
            all(same(a.opt_state[k], b.opt_state[k]) for k in ("mu", "nu")))


def comm_on_card(dtype_name, device="cuda"):
    """Every collective of parallel/comm.py on this rank's CUDA block of one
    seeded (ranks, 4, 6, 8) tensor, over gloo through the host: each
    result, and the gradient of 0.5 * |result|^2 with respect to the block,
    as fp32 numpy, with the device each came back on."""
    from lvd_tpu_torch.parallel import comm

    axis = mesh().data
    n = axis.size
    full = torch.randn(n, 4, 6, 8, generator=torch.Generator().manual_seed(0))
    calls = {"psum": lambda x: comm.psum(x, axis),
             "all_to_all": lambda x: comm.all_to_all(x, axis, 0, 1),
             "ppermute": lambda x: comm.ppermute(x, axis, [(i, i + 1) for i in range(n - 1)]),
             "all_gather": lambda x: comm.all_gather(x, axis, 0)}
    out = {}
    for name, fn in calls.items():
        x = full[axis.rank].to(device, getattr(torch, dtype_name)).requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad(0.5 * (y.float() ** 2).sum(), x)
        out[name] = (y.detach().float().cpu().numpy(), g.float().cpu().numpy(),
                     y.device.type, g.device.type)
    return full.numpy(), out
