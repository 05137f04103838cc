"""The log-sum-exp that kernel A writes and kernel E reads, on the CPU.

Kernel A writes, when autograd will need it, each query row's base-2
log-sum-exp of the scaled logits, and kernel E recomputes P from it instead
of from a statistics launch. Their plain versions mirror that interface:
``attention_packed_plain(..., return_lse=True)`` and
``attention_packed_bwd_plain(..., lse=...)``. Inputs come from numpy seeds
and go to both packages in fp32 at ragged sizes (45 queries against 77 text
keys, 180 against 180). The log-sum-exp is held to ``jax.nn.logsumexp`` of
lvd_tpu's scaled logits within 1e-5 of max|ref| (after the change of base);
the gradients from it to ``jax.vjp`` of lvd_tpu's ``attention_packed``
within 1e-4 of max|ref| each.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import pallas_attention as j_pa
from lvd_tpu_torch.ops import packed_attention as t_pa

SCALE = 0.125
CASES = [(2, 45, 77, 2), (2, 180, 180, 1)]  # (batch, S_q, S_k, heads), D = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(b, s_q, s_k, heads):
    rng = np.random.default_rng(s_q * 1000 + s_k)
    c = 64 * heads
    q, k, v = (rng.standard_normal((b, s, c)).astype(np.float32) for s in (s_q, s_k, s_k))
    do = rng.standard_normal((b, s_q, c)).astype(np.float32)
    return q, k, v, do


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("b,s_q,s_k,heads", CASES)
def test_plain_lse_matches_jax_logsumexp(b, s_q, s_k, heads):
    q, k, v, _ = _case(b, s_q, s_k, heads)
    out, lse = t_pa.attention_packed_plain(*map(torch.from_numpy, (q, k, v)), SCALE, heads,
                                           return_lse=True)
    split = lambda t: jnp.asarray(t).reshape(b, t.shape[1], heads, 64).transpose(0, 2, 1, 3)
    logits = jnp.einsum("bhqd,bhkd->bhqk", split(q), split(k)) * SCALE
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(b * heads, s_q)
    assert tuple(lse.shape) == (b * heads, s_q) and lse.dtype == torch.float32
    assert _rel(lse.numpy() * np.log(2.0), want) <= 1e-5  # base 2 -> natural log
    assert _rel(out.numpy(), j_pa.attention_packed(*map(jnp.asarray, (q, k, v)), SCALE,
                                                   heads)) <= 1e-5
    # Without the flag the plain forward returns the output alone, unchanged.
    alone = t_pa.attention_packed_plain(*map(torch.from_numpy, (q, k, v)), SCALE, heads)
    assert torch.equal(alone, out)


@pytest.mark.parametrize("b,s_q,s_k,heads", CASES)
def test_plain_bwd_from_lse_matches_jax_vjp(b, s_q, s_k, heads):
    q, k, v, do = _case(b, s_q, s_k, heads)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = t_pa.attention_packed_plain(tq, tk, tv, SCALE, heads, return_lse=True)
    got = t_pa.attention_packed_bwd_plain(tq, tk, tv, o, tdo, SCALE, heads, lse=lse)
    _, vjp = jax.vjp(lambda a, b_, c: j_pa.attention_packed(a, b_, c, SCALE, heads),
                     *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        assert _rel(g.numpy(), w) <= 1e-4


def test_autograd_keeps_lse_only_when_recorded():
    """The autograd Function asks the forward for its log-sum-exp only when
    autograd records it, and the backward from that log-sum-exp gives
    lvd_tpu's gradients."""
    b, s_q, s_k, heads = CASES[0]
    q, k, v, do = _case(b, s_q, s_k, heads)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    saved = []
    hook = lambda t: saved.append(t) or t
    with torch.autograd.graph.saved_tensors_hooks(hook, lambda t: t):
        out = t_pa.attention_packed(*leaves, SCALE, heads)
    lse = [t for t in saved if t is not None and t.shape == (b * heads, s_q)]
    assert len(lse) == 1 and lse[0].dtype == torch.float32
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b_, c: j_pa.attention_packed(a, b_, c, SCALE, heads),
                     *map(jnp.asarray, (q, k, v)))
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        assert _rel(g.numpy(), w) <= 1e-4
    saved.clear()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(hook, lambda t: t):
        t_pa.attention_packed(*leaves, SCALE, heads)
    assert saved == []
