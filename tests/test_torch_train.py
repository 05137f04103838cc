"""The port's training step (lvd_tpu_torch/training/train.py) against
lvd_tpu's on the CPU, fp32.

- ``prng.randint`` against ``jax.random.randint``, bit for bit, at several
  shapes, ranges and keys;
- one AdamW update and one adapter-only update of the port's optimizer
  against optax's ``adamw`` and its ``multi_transform`` with
  ``set_to_zero`` on a small tree: the frozen leaves untouched and without
  moments, the trained ones within 1e-5 relative (1e-7 absolute);
- 3 steps of ``Trainer(tiny_unet_config())`` from the same parameters (the
  port's draw of lvd_tpu's key order), batch and keys as lvd_tpu's
  ``Trainer``: each loss within 1e-5 relative, the parameters after step 3
  within ``PARAM_TOL`` (see below), and the update of every leaf within
  ``UPDATE_L2_TOL`` (L2) of lvd_tpu's;
- the checkpoint round trip: a state saved after one step and restored
  into a fresh ``Trainer.init`` continues bit for bit like the state that
  never stopped;
- a mesh is refused with an error naming ROADMAP A5.

lvd_tpu's step is compiled once a module, for tests/test_parallel.py's
batch shapes and learning rate (the compile cache holds that executable).
The adapter-only step is held to lvd_tpu's in
tests/test_torch_train_adapter.py; the weight gradients through the pair's
and the GEGLU's Functions, which the tiny UNet routes neither of, in
tests/test_torch_weight_grads.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lvd_tpu_torch import config as tcfg
from lvd_tpu_torch.models.unet3d import init_unet3d
from lvd_tpu_torch.training import train as ttrain
from lvd_tpu_torch.utils import prng
from lvd_tpu_torch.utils.tree import flatten, unflatten_like

STEPS = 3
LR = 1e-3  # tests/test_parallel.py's single-device trainer
# Adam's first steps move each element by about lr, whatever the size of
# its gradient, so an element whose gradient is a rounding residue (~1e-9)
# in one package and exactly 0, or of the other sign, in the other can differ
# by up to 2 lr a step. The bound on max|p_port - p_lvd| after STEPS steps:
PARAM_TOL = 2 * STEPS * LR
UPDATE_L2_TOL = 1e-2  # |d_port - d_lvd| / |d_lvd| of each leaf's update, L2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the whole module, its module fixtures' draws
    included: the suite runs six workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_batch(b, f=2, hw=8, d=64, gligen_slots=0, seed=0):
    """tests/test_parallel.py's ``_tiny_batch`` (and its grounding inputs)
    as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"latents": rng.standard_normal((b, f, hw, hw, 4)).astype(np.float32),
             "text": rng.standard_normal((b, 77, d)).astype(np.float32)}
    if gligen_slots:
        m = gligen_slots
        batch["gligen"] = {"boxes": rng.random((b * f, m, 4)).astype(np.float32),
                           "masks": np.ones((b * f, m), np.float32),
                           "positive_embeddings": rng.standard_normal((b * f, m, d))
                           .astype(np.float32)}
    return batch


def to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(np.asarray(t)), tree)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def clone_tree(params):
    """A copy of the port's param tree, in its key order: the step updates
    the state it is given in place."""
    return unflatten_like(params, {k: v.clone() for k, v in flatten(params).items()})


def run_lvd_tpu(cfg, params, batch, lr, adapter_only, steps):
    """lvd_tpu's Trainer from these params: (params after each step as flat
    numpy, losses)."""
    from lvd_tpu.training.train import Trainer

    trainer = Trainer(unet_cfg=cfg, learning_rate=lr, adapter_only=adapter_only)
    state = trainer.init(to_jax(params))
    step = trainer.make_step(donate=False)
    trees, losses = [], []
    for i in range(steps):
        state, loss = step(state, to_jax(batch), jax.random.PRNGKey(i))
        trees.append({k: np.asarray(v) for k, v in flatten(
            jax.tree_util.tree_map(np.asarray, state.params)).items()})
        losses.append(float(loss))
    return trees, losses


def run_port(cfg, params, batch, lr, adapter_only, steps):
    trainer = ttrain.Trainer(unet_cfg=cfg, learning_rate=lr, adapter_only=adapter_only)
    state = trainer.init(clone_tree(params))
    step = trainer.make_step()
    trees, losses = [], []
    for i in range(steps):
        state, loss = step(state, to_torch(batch), prng.prng_key(i))
        trees.append({k: v.numpy().copy() for k, v in flatten(state.params).items()})
        losses.append(float(loss))
    return trees, losses, state


def check_against_lvd_tpu(params, ref, got):
    """Losses within 1e-5 relative; every leaf after the last step within
    PARAM_TOL, its update within UPDATE_L2_TOL (L2) of lvd_tpu's."""
    (ref_trees, ref_losses), (got_trees, got_losses) = ref, got
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-5)
    start = {k: v.numpy() for k, v in flatten(params).items()}
    assert set(got_trees[-1]) == set(ref_trees[-1]) == set(start)
    worst = {}
    for path, p0 in start.items():
        got_p, ref_p = got_trees[-1][path], ref_trees[-1][path]
        assert np.abs(got_p - ref_p).max() <= PARAM_TOL, path
        d_ref, d_got = ref_p - p0, got_p - p0
        scale = np.linalg.norm(d_ref)
        err = np.linalg.norm(d_got - d_ref) / scale if scale else np.linalg.norm(d_got)
        worst[path] = err
    assert max(worst.values()) <= UPDATE_L2_TOL, sorted(worst.items(), key=lambda x: -x[1])[:5]


@pytest.fixture(scope="module")
def full_runs():
    """3 steps of each package's full finetune from the port's draw of
    lvd_tpu's tiny UNet (PRNGKey(0)), tests/test_parallel.py's batch."""
    from lvd_tpu.config import tiny_unet_config

    params = init_unet3d(prng.prng_key(0), tcfg.tiny_unet_config(), device="cpu")
    batch = tiny_batch(b=2)
    ref = run_lvd_tpu(tiny_unet_config(), params, batch, LR, False, STEPS)
    got = run_port(tcfg.tiny_unet_config(), params, batch, LR, False, STEPS)
    return params, batch, ref, got


@pytest.mark.parametrize("shape,lo,hi", [
    ((5,), 0, 1000), ((3, 4), -7, 13), ((17,), 0, 1), ((9,), 5, 3), ((33,), 0, 997),
    ((8,), -2 ** 31, 2 ** 31 - 1), ((6,), 0, 2 ** 31 - 1), ((1000,), 0, 70000),
    ((2, 3, 5), -2 ** 31, 0)])
def test_randint_matches_jax(shape, lo, hi):
    for seed in (0, 1, 12345, 2 ** 31 - 5):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
        got = prng.randint(prng.prng_key(seed), shape, lo, hi)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


def _small_tree(rng):
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"conv_in": {"w": n(3, 3, 2, 4), "b": n(4)},
            "blocks": [{"fuser": {"linear": {"w": n(4, 6), "b": np.zeros(6, np.float32)}},
                        "norm": {"scale": n(6)}}],
            "position_net": {"null": n(5)}}


@pytest.mark.parametrize("adapter_only", [False, True])
def test_adamw_matches_optax(adapter_only):
    """Two updates of the port's optimizer against optax's (``adamw``, or
    ``multi_transform`` with ``set_to_zero`` under adapter-only)."""
    from lvd_tpu.training.train import make_optimizer as j_make_optimizer

    rng = np.random.default_rng(5)
    params = _small_tree(rng)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32)
                                    * 1e-2, params) for _ in range(2)]
    tx = j_make_optimizer(1e-2, adapter_only=adapter_only, params=params)
    j_params, j_state = to_jax(params), tx.init(to_jax(params))
    port = ttrain.make_optimizer(1e-2, adapter_only=adapter_only, params=params)
    t_params = flatten(to_torch(params))
    t_state = port.init(to_torch(params))
    assert set(t_state["mu"]) == {p for p in t_params
                                  if not adapter_only or "fuser" in p or "position_net" in p}
    for g in grads:
        updates, j_state = tx.update(to_jax(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        flat_g = {k: v for k, v in flatten(to_torch(g)).items() if port.trains(k)}
        t_state = port.update(flat_g, t_state, t_params)
    want = flatten(jax.tree_util.tree_map(np.asarray, j_params))
    for path, p0 in flatten(params).items():
        got = t_params[path].numpy()
        if port.trains(path):
            np.testing.assert_allclose(got, want[path], rtol=1e-5, atol=1e-7, err_msg=path)
            assert not np.array_equal(got, p0) or not p0.any(), path
        else:
            np.testing.assert_array_equal(got, p0)
            np.testing.assert_array_equal(want[path], p0)
    assert t_state["count"] == 2


def test_trainer_matches_lvd_tpu(full_runs):
    params, _, ref, got = full_runs
    check_against_lvd_tpu(params, ref, got[:2])
    assert got[2].step == STEPS and got[2].opt_state["count"] == STEPS
    assert got[1][-1] < got[1][0]  # the same key-0 batch is learnable


def test_checkpoint_round_trip_continues_bit_for_bit(full_runs, tmp_path):
    params, batch, _, _ = full_runs
    trainer = ttrain.Trainer(unet_cfg=tcfg.tiny_unet_config(), learning_rate=LR)
    step = trainer.make_step()
    state, _ = step(trainer.init(clone_tree(params)), to_torch(batch), prng.prng_key(0))
    ttrain.save_train_state(str(tmp_path / "ckpt"), state)
    restored = ttrain.restore_train_state(str(tmp_path / "ckpt"),
                                          trainer.init(init_unet3d(prng.prng_key(9),
                                                                   tcfg.tiny_unet_config(),
                                                                   device="cpu")))
    assert restored.step == 1
    a, loss_a = step(state, to_torch(batch), prng.prng_key(1))
    b, loss_b = step(restored, to_torch(batch), prng.prng_key(1))
    assert torch.equal(loss_a, loss_b)
    for (ka, va), (kb, vb) in zip(flatten(a.params).items(),
                                  flatten(b.params).items()):
        assert ka == kb and torch.equal(va, vb), ka
    for m in ("mu", "nu"):
        assert all(torch.equal(a.opt_state[m][k], b.opt_state[m][k]) for k in a.opt_state[m])


def test_step_updates_the_state_in_place(full_runs):
    """The step writes the new params and moments into the state's own
    tensors (lvd_tpu donates the state), and its first step from a clone
    of the fixture's params is the one ``run_port`` recorded."""
    params, batch, _, got = full_runs
    trainer = ttrain.Trainer(unet_cfg=tcfg.tiny_unet_config(), learning_rate=LR)
    state = trainer.init(clone_tree(params))
    before = {p: t.data_ptr() for p, t in flatten(state.params).items()}
    mu = {p: t.data_ptr() for p, t in state.opt_state["mu"].items()}
    new, loss = trainer.make_step()(state, to_torch(batch), prng.prng_key(0))
    assert float(loss) == got[1][0]
    assert {p: t.data_ptr() for p, t in flatten(new.params).items()} == before
    assert {p: t.data_ptr() for p, t in new.opt_state["mu"].items()} == mu
    for path, v in flatten(new.params).items():
        np.testing.assert_array_equal(v.numpy(), got[0][0][path])


def test_mesh_is_refused_until_roadmap_a5():
    trainer = ttrain.Trainer(unet_cfg=tcfg.tiny_unet_config())
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        trainer.init({}, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        trainer.make_step(mesh=object())
