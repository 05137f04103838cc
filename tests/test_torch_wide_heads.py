"""Kernels A and E at head dims 192 and 256, on the CPU.

The public sdpa() takes any head dim D % 64 == 0 to kernels A and E (one
head, lvd_tpu's row-1 kernel ``_pallas_attention`` and its backward
``_pallas_attention_bwd``), and the packed attention() takes them wherever
``kernel_ok`` holds. At D = 192 and 256 the kernels run their ``wide`` form
(``launch_plan``); on the CPU the wrappers run the plain versions, which
these tests hold to lvd_tpu at those head dims:

- sdpa() at (1, 2, 300, D), forward and gradient through autograd, against
  lvd_tpu's ``attention_bh`` and ``jax.vjp`` of it;
- ``attention_packed_bwd_plain`` with one head at (2, 200, D) against
  ``_pallas_attention_bwd`` (row 3's kernel) in interpret mode, and with 3
  heads at D = 192 (C = 576) against ``_pallas_attention_bwd_heads``;
- the log-sum-exp the forward returns against numpy's, in base-2 units;
- the form plan, D -> form and code, at 64 to 512.

Inputs come from numpy seeds, in fp32; tolerance 1e-4 of max|ref|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvd_tpu.ops import pallas_attention as j_pa
from lvd_tpu_torch.ops import packed_attention as t_pa
from lvd_tpu_torch.ops.attention import sdpa

TOL = 1e-4
WIDE = (192, 256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def attention_bh_vjp():
    """lvd_tpu's attention_bh forward and VJP, jitted once a module."""
    def fwd_vjp(q, k, v, ct):
        d = q.shape[-1]
        out, vjp = jax.vjp(lambda a, b, c: j_pa.attention_bh(a, b, c, d ** -0.5), q, k, v)
        return out, vjp(ct)

    return jax.jit(fwd_vjp)


@pytest.mark.parametrize("d", WIDE)
def test_sdpa_matches_attention_bh(attention_bh_vjp, d):
    rng = np.random.default_rng(d)
    q, k, v, ct = (_normal(rng, (1, 2, 300, d)) for _ in range(4))
    ref, ref_grads = attention_bh_vjp(*map(jnp.asarray, (q, k, v, ct)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out, probs = sdpa(*leaves)
    assert probs is None
    assert _rel(out.detach().numpy(), ref) <= TOL
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for got, want in zip(grads, ref_grads):
        assert _rel(got.numpy(), want) <= TOL


def _bwd_case(seed, b, s, c):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_normal(rng, (b, s, c)) for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("d", WIDE)
def test_bwd_plain_matches_row3_kernel(d):
    """One head: the packed layout is lvd_tpu's (BH, S, D) layout."""
    q, k, v, do = _bwd_case(d + 1, 2, 200, d)
    scale = d ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = t_pa.attention_packed_plain(tq, tk, tv, scale, 1, return_lse=True)
    want = j_pa._pallas_attention_bwd(*map(jnp.asarray, (q, k, v, o.numpy(), do)), scale,
                                      interpret=True)
    got = t_pa.attention_packed_bwd_plain(tq, tk, tv, o, tdo, scale, 1, lse=lse)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL


def test_bwd_plain_matches_heads_kernel_at_three_heads():
    """Three heads of 192 (C = 576), an odd head count, 200 queries: two
    query tiles of the TPU kernel, the second ragged."""
    q, k, v, do = _bwd_case(576, 2, 200, 576)
    scale = 192 ** -0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = t_pa.attention_packed_plain(tq, tk, tv, scale, 3, return_lse=True)
    want = j_pa._pallas_attention_bwd_heads(*map(jnp.asarray, (q, k, v, o.numpy(), do)), scale,
                                            num_heads=3, interpret=True)
    got = t_pa.attention_packed_bwd_plain(tq, tk, tv, o, tdo, scale, 3, lse=lse)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL
    assert _rel(o.numpy(), j_pa.attention_packed(*map(jnp.asarray, (q, k, v)), scale, 3)) <= TOL


@pytest.mark.parametrize("heads,d", [(1, 192), (1, 256), (3, 192)])
def test_lse_is_the_base2_logsumexp(heads, d):
    """The statistic every form of kernel A writes and kernel E reads:
    log2 of sum_k exp(scale q.k) per (batch*head, query), against numpy's in
    float64."""
    q, k, v, _ = _bwd_case(heads * d, 2, 150, heads * d)
    scale = d ** -0.5
    _, lse = t_pa.attention_packed_plain(*map(torch.from_numpy, (q, k, v)), scale, heads,
                                         return_lse=True)
    split = lambda t: t.astype(np.float64).reshape(2, -1, heads, d).transpose(0, 2, 1, 3)
    logits = np.einsum("bhqd,bhkd->bhqk", split(q), split(k)) * scale
    top = logits.max(-1, keepdims=True)
    want = (np.log(np.exp(logits - top).sum(-1)) + top[..., 0]) / np.log(2.0)
    assert tuple(lse.shape) == (2 * heads, 150) and lse.dtype == torch.float32
    assert _rel(lse.numpy(), want.reshape(2 * heads, 150)) <= 1e-5


def test_form_plan():
    """D = 64 and 128 keep their own forms, 192 and 256 take the wide form,
    every other D % 64 == 0 the D-sliced one; a named form overrides, and a
    name the kernels do not know raises."""
    plan = {d: t_pa.launch_plan(d) for d in (64, 128, 192, 256, 320, 512)}
    assert {d: p["form"] for d, p in plan.items()} == {
        64: "D64", 128: "D128", 192: "wide", 256: "wide", 320: "sliced", 512: "sliced"}
    assert {d: p["code"] for d, p in plan.items()} == {
        64: 1, 128: 2, 192: 3, 256: 3, 320: 0, 512: 0}
    assert t_pa.launch_plan(192, "sliced") == {"form": "sliced", "code": 0}
    assert t_pa.attention_packed.launches_by_form.keys() == set(t_pa.FORMS)
    assert t_pa.attention_packed_bwd.launches_by_form.keys() == set(t_pa.FORMS)
    with pytest.raises(KeyError):
        t_pa.launch_plan(192, "wmma")
