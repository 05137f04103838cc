"""Adapter-only training (GLIGEN's fuser and position_net, the way
lvd-gligen checkpoints are made) of the port against lvd_tpu's, on the
gated tiny UNet, CPU, fp32: 3 steps of each package's
``Trainer(tiny_unet_config("gated"), adapter_only=True)`` from the same
parameters, batch (three grounding boxes per frame) and keys. Every frozen
leaf is bit-unchanged in the port, every fuser leaf has moved, and the
losses and the trained leaves are held to lvd_tpu's as
tests/test_torch_train.py holds the full finetune (its tolerances).
lvd_tpu's step is compiled once, for tests/test_parallel.py's adapter-only
batch shapes and learning rate.
"""

import numpy as np
import pytest
import torch

from lvd_tpu_torch import config as tcfg
from lvd_tpu_torch.models.unet3d import init_unet3d
from lvd_tpu_torch.training import train as ttrain
from lvd_tpu_torch.utils import prng
from lvd_tpu_torch.utils.tree import flatten
from test_torch_train import STEPS, check_against_lvd_tpu, run_lvd_tpu, run_port, tiny_batch

LR = 1e-2  # tests/test_parallel.py's adapter-only trainer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def adapter_runs():
    from lvd_tpu.config import tiny_unet_config

    params = init_unet3d(prng.prng_key(0), tcfg.tiny_unet_config("gated"), device="cpu")
    batch = tiny_batch(b=2, gligen_slots=3)
    ref = run_lvd_tpu(tiny_unet_config("gated"), params, batch, LR, True, STEPS)
    got = run_port(tcfg.tiny_unet_config("gated"), params, batch, LR, True, STEPS)
    return params, ref, got


def _adapter(path):
    return "fuser" in path.split("/") or "position_net" in path.split("/")


def test_adapter_mask_marks_fuser_and_position_net():
    params = init_unet3d(prng.prng_key(0), tcfg.tiny_unet_config("gated"), device="cpu")
    mask = ttrain._adapter_only_mask(params)
    assert {p for p, m in mask.items() if m} == {p for p in mask if _adapter(p)}
    assert any("fuser" in p for p in mask) and any(p.startswith("position_net") for p in mask)
    assert sum(mask.values()) < len(mask)


def test_adapter_only_freezes_the_base_and_moves_the_fuser(adapter_runs):
    params, _, (trees, losses, state) = adapter_runs
    start = flatten(params)
    assert np.isfinite(losses).all()
    assert set(state.opt_state["mu"]) == {p for p in start if _adapter(p)}
    for path, p0 in start.items():
        if _adapter(path):
            if "fuser" in path.split("/"):
                assert not np.array_equal(trees[-1][path], p0.numpy()), path
        else:
            np.testing.assert_array_equal(trees[-1][path], p0.numpy(), err_msg=path)


def test_adapter_only_matches_lvd_tpu(adapter_runs):
    params, ref, got = adapter_runs
    check_against_lvd_tpu(params, ref, got[:2])
