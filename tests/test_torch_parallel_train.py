"""The port's mesh trainer on 4 gloo ranks of the CPU as a 2 x 2 ("data",
"model") mesh, against the port's single-device step from the same params,
batch and key, at the configurations where tests/test_torch_train.py and
test_torch_train_adapter.py hold that step to lvd_tpu's (tests/
test_parallel.py's trainers):

- full finetuning: the tiny UNet, lr 1e-3, batch 2 (a row a data rank),
  key 0;
- adapter-only: the tiny gated UNet, lr 1e-2, batch 2 with 3 grounding
  slots a frame, key 0; and the same at batch 4 on a 4 x 1 mesh, where no
  leaf is cut;
each held to the single-device step: the loss within rtol 1e-4 / atol
1e-5, every leaf's update within 1e-2 (L2), frozen leaves bit-unchanged;
on two "data" ranks the loss and every leaf bit for bit (the step takes
one sample at a time, and a sum of two is the same in either order).
Every rank stores only its model block of each column- and row-sharded
leaf and of its AdamW moments.
- a mesh checkpoint round trip: the state saved after one step (the blocks
  gathered) and restored into a fresh mesh init (cut again) continues bit
  for bit like the state that never stopped, and a single device restores
  the file.

lvd_tpu's jitted steps take 65-150 s each here to lower and load or
compile, which the suite's time limit cannot take beside those two files'. The
ranks import neither jax nor lvd_tpu (tests/_torch_parallel_ranks.py).
"""

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks

N = 4
UPDATE_L2_TOL = 1e-2


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


def tiny_batch(b, f=2, gligen_slots=0):
    """tests/test_parallel.py's ``_tiny_batch`` (and its grounding inputs)."""
    rng = np.random.default_rng(0)
    batch = {"latents": rng.standard_normal((b, f, 8, 8, 4)).astype(np.float32),
             "text": rng.standard_normal((b, 77, 64)).astype(np.float32)}
    if gligen_slots:
        m = gligen_slots
        batch["gligen"] = {"boxes": rng.random((b * f, m, 4)).astype(np.float32),
                           "masks": np.ones((b * f, m), np.float32),
                           "positive_embeddings": rng.standard_normal((b * f, m, 64))
                           .astype(np.float32)}
    return batch


def single_device_step(gated, lr, adapter_only, batch, key_seed):
    """The port's single-device step from the tiny UNet (key 0): (loss, flat
    params before, flat params after) as numpy."""
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.training import train
    from lvd_tpu_torch.utils import prng
    from lvd_tpu_torch.utils.tree import flatten

    cfg = tcfg.tiny_unet_config("gated" if gated else "default")
    params = init_unet3d((0, 0), cfg, device="cpu")
    start = {k: v.numpy().copy() for k, v in flatten(params).items()}
    trainer = train.Trainer(unet_cfg=cfg, learning_rate=lr, adapter_only=adapter_only)
    tree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in batch.items()}
    state, loss = trainer.make_step()(trainer.init(params), tree, prng.prng_key(key_seed))
    return float(loss), start, {k: v.numpy() for k, v in flatten(state.params).items()}


CASES = {
    "full": dict(gated=False, lr=1e-3, adapter_only=False, b=2, slots=0, key=0, model=2),
    "adapter_only": dict(gated=True, lr=1e-2, adapter_only=True, b=2, slots=3, key=0, model=2),
    # data 4 x model 1: no leaf is cut, the gradients only averaged over "data"
    "adapter_only_data_4": dict(gated=True, lr=1e-2, adapter_only=True, b=4, slots=3, key=0,
                                model=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_trainer_matches_single_device(pool, name):
    c = CASES[name]
    batch = tiny_batch(c["b"], gligen_slots=c["slots"])
    want_loss, start, want = single_device_step(c["gated"], c["lr"], c["adapter_only"], batch,
                                                c["key"])
    outs = pool.run(ranks.train_step, c["gated"], c["lr"], c["adapter_only"], batch, c["key"],
                    c["model"])
    losses = [o[0] for o in outs]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], want_loss, rtol=1e-4, atol=1e-5)
    for _, got, _, _ in outs[1:]:
        assert all(np.array_equal(got[p], outs[0][1][p]) for p in got)
    got = outs[0][1]
    assert set(got) == set(want) == set(start)
    worst = {}
    for path, p0 in start.items():
        d_ref, d_got = want[path] - p0, got[path] - p0
        scale = np.linalg.norm(d_ref)
        worst[path] = np.linalg.norm(d_got - d_ref) / scale if scale else np.linalg.norm(d_got)
        if c["adapter_only"] and "fuser" not in path and "position_net" not in path:
            assert not d_got.any(), path
    assert max(worst.values()) <= UPDATE_L2_TOL, sorted(worst.items(), key=lambda x: -x[1])[:5]
    if N // c["model"] == 2:
        assert losses[0] == want_loss
        assert [p for p in start if not np.array_equal(got[p], want[p])] == []
    # Each rank stores its 1 / model of every sharded leaf, and its moments.
    _, _, blocks, moments = outs[0]
    assert blocks
    for path, shape in blocks.items():
        full = start[path].shape
        axis = 0 if path.endswith("to_out/w") else 1
        assert shape[axis] * c["model"] == full[axis] and shape[1 - axis] == full[1 - axis], path
        if path in moments:
            assert moments[path] == shape, path


def test_mesh_checkpoint_round_trip_continues_bit_for_bit(pool, tmp_path):
    batch = tiny_batch(4)
    outs = pool.run(ranks.checkpoint_round_trip, {k: batch[k] for k in ("latents", "text")},
                    str(tmp_path / "ckpt"), 2)
    for step, loss_a, loss_b, same_params, same_moments in outs:
        assert step == 1 and loss_a == loss_b and same_params and same_moments
    # The file holds the whole leaves: a single device restores it.
    from lvd_tpu_torch import config as tcfg
    from lvd_tpu_torch.models.unet3d import init_unet3d
    from lvd_tpu_torch.training import train
    from lvd_tpu_torch.utils.tree import flatten

    cfg = tcfg.tiny_unet_config()
    params = init_unet3d((0, 0), cfg, device="cpu")
    restored = train.restore_train_state(str(tmp_path / "ckpt"),
                                         train.Trainer(cfg).init(params))
    for path, t in flatten(restored.params).items():
        assert t.shape == flatten(params)[path].shape, path
