"""Weight gradients through the autograd Functions of kernels B (the
temporal pair) and C / J (the GEGLU feed-forward) on the CPU, fp32, against
``jax.grad`` of lvd_tpu's at 1e-4: the pair in both layouts, inside a
temporal transformer block that also holds its FF (whose leaves the pair
leaves alone), and the feed-forward in both GELU forms where lvd_tpu routes
its resident kernel (dx on kernel G's route) and past the resident budget
through the public ``geglu_mlp`` (kernel J's forward, dx on the stock
route). lvd_tpu's custom VJPs give these gradients from a stock recompute
of the unfused formulation; the port's Functions do the same, beside dx
from their kernel routes. The tiny UNet of tests/test_torch_train.py routes
neither kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvd_tpu_torch.utils.tree import flatten
from test_torch_train import to_jax, to_torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf_close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("frames_major", [True, False])
def test_pair_weight_gradients_through_the_function_match_lvd_tpu(frames_major):
    """A temporal transformer block's pair (its FF and norm3 beside it in
    the params) with every leaf requiring grad goes through TemporalPair
    (kernel B's Function; on the CPU its plain versions), and each leaf's
    gradient and y's match ``jax.grad`` of lvd_tpu's pair at 1e-4."""
    from lvd_tpu.ops import temporal_attention as j_ta
    from lvd_tpu_torch.ops import temporal_attention as t_ta

    rng = np.random.default_rng(17)
    c = 128
    n = lambda *sh, s=1.0: (rng.standard_normal(sh) * s).astype(np.float32)
    lin = lambda bias: {"w": n(c, c, s=c ** -0.5), **({"b": n(c, s=0.1)} if bias else {})}
    attn = lambda: {"to_q": lin(False), "to_k": lin(False), "to_v": lin(False),
                    "to_out": lin(True)}
    norm = lambda: {"scale": 1 + n(c, s=0.1), "bias": n(c, s=0.1)}
    block = {"norm1": norm(), "attn1": attn(), "norm2": norm(), "attn2": attn(),
             "norm3": norm(), "ff": {"proj": lin(True), "out": lin(True)}}
    shape = (1, 5, 16, c) if frames_major else (1, 16, 5, c)
    y, ct = n(*shape), n(*shape)
    pair = lambda pp, yy: j_ta.temporal_attention_pair(pp, yy, 2, 1e-5, frames_major)
    want_p, want_y = jax.grad(lambda pp, yy: jnp.sum(pair(pp, yy) * ct), argnums=(0, 1))(
        to_jax(block), jnp.asarray(y))
    tb = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), to_torch(block))
    ty = torch.from_numpy(y).requires_grad_(True)
    out = t_ta.temporal_attention_pair(tb, ty, 2, 1e-5, frames_major)
    assert type(out.grad_fn).__name__ == "TemporalPairBackward"
    (out * torch.from_numpy(ct)).sum().backward()
    _leaf_close(ty.grad.numpy(), want_y)
    got = flatten(jax.tree_util.tree_map(lambda t: t.grad, tb))
    for path, w in flatten(jax.tree_util.tree_map(np.asarray, want_p)).items():
        if path.split("/")[0] in ("norm3", "ff"):
            assert got[path] is None, path
        else:
            _leaf_close(got[path].numpy(), w)


@pytest.mark.parametrize("form,c,inner", [("tanh", 64, 256), ("exact", 64, 256),
                                          ("tanh", 512, 2048)])
def test_geglu_weight_gradients_through_the_function_match_lvd_tpu(form, c, inner, monkeypatch):
    """With its weights requiring grad, the feed-forward goes through Geglu
    (kernel C's Function, dx on G's route) at 2048 rows, lvd_tpu's floor
    for its kernel, and the public ``geglu_mlp`` past the resident budget
    (C = 512: kernel J's forward, dx on the stock route); w1, b1, w2, b2
    and x match ``jax.grad`` of lvd_tpu's (of its ``_unfused`` there) at
    1e-4."""
    from lvd_tpu.ops import basic as j_basic
    from lvd_tpu.ops import geglu_fused as j_geglu
    from lvd_tpu_torch.ops import basic as t_basic
    from lvd_tpu_torch.ops import geglu_fused as t_geglu

    monkeypatch.setattr(j_geglu, "GELU_FORM", form)
    monkeypatch.setattr(t_geglu, "GELU_FORM", form)
    rng = np.random.default_rng(23)
    resident = t_geglu.dx_route(c, inner, torch.float32) == "G"
    n = lambda *sh, s=1.0: (rng.standard_normal(sh) * s).astype(np.float32)
    p = {"proj": {"w": n(c, 2 * inner, s=c ** -0.5), "b": n(2 * inner, s=0.1)},
         "out": {"w": n(inner, c, s=inner ** -0.5), "b": n(c, s=0.1)}}
    shape = (2, 1024, c) if resident else (3, 40, c)
    x, ct = n(*shape), n(*shape)
    # lvd_tpu's streaming form needs the TPU (Pallas); its custom VJP's
    # weight gradients are those of ``_unfused``, which runs here.
    unfused = lambda pp, xx: j_geglu._unfused(xx, pp["proj"]["w"], pp["proj"]["b"],
                                              pp["out"]["w"], pp["out"]["b"])
    j_ff, t_ff = (j_basic.feed_forward, t_basic.feed_forward) if resident else \
        (unfused, t_geglu.geglu_mlp)
    want_p, want_x = jax.grad(lambda pp, xx: jnp.sum(j_ff(pp, xx) * ct),
                              argnums=(0, 1))(to_jax(p), jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), to_torch(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = t_ff(tp, tx)
    assert type(out.grad_fn).__name__ == "GegluBackward"
    (out * torch.from_numpy(ct)).sum().backward()
    _leaf_close(tx.grad.numpy(), want_x)
    got = flatten(jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp))
    for path, w in flatten(jax.tree_util.tree_map(np.asarray, want_p)).items():
        _leaf_close(got[path], w)
