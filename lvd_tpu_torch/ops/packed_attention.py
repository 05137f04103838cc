"""Head-packed attention: kernel A (forward), kernel E (backward) and their
plain versions (counterpart of lvd_tpu/ops/pallas_attention.py).

``attention_packed`` takes q (B, S_q, C) and k, v (B, S_k, C) with
C = heads * D packed, as lvd_tpu's ``attention_packed`` does, and returns
(B, S_q, C). It is a ``torch.autograd.Function``: on CUDA tensors the forward
launches kernel A (csrc/packed_attention.cu, replacing
``_pallas_attention_heads`` and ``_pallas_attention_shortkey``, and with one
head ``_pallas_attention``, the public sdpa()'s kernel) and the backward
kernel E (csrc/packed_attention_bwd.cu, replacing ``_pallas_attention_bwd``
and ``_pallas_attention_bwd_heads``); on CPU tensors both run their plain
versions. The kernels take bf16 or fp32 and any head dim D % 64 == 0, as
lvd_tpu's predicates do (D of 64 and 128 in their own kernels, every other
D in a D-sliced form). A raw launch on a tensor that requires grad raises
(``_build.refuse_grad``).

The backward recomputes P from the base-2 log-sum-exp of each query row
(``lse``, (B*H, S_q) fp32, in units of log2(e) * scale * q.k), which the
forward writes only when autograd will need it: ``attention_packed`` asks
for it when grad mode is on and an input requires grad, so the UNet's
no-grad CFG forward passes a null pointer and pays nothing.
``attention_packed.lse_launches`` counts the launches of A that wrote one.
"""

from __future__ import annotations

import torch

from . import _build

LOG2E = 1.4426950408889634


def _split(t, num_heads):
    b, s, c = t.shape
    return t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def _merge(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def attention_packed_plain(q, k, v, scale: float, num_heads: int, block_q: int = 512,
                           return_lse: bool = False):
    """Exact softmax attention, query blocks of ``block_q`` so the (S, S)
    logits never exist at once: fp32 logits, probabilities cast to v's type,
    fp32 PV accumulation (lvd_tpu's ``_heads_chunked``). With ``return_lse``
    also the base-2 log-sum-exp of the scaled logits, (B*H, S_q) fp32, as
    kernel A writes it: returns (out, lse)."""
    qh, kh, vh = (_split(t, num_heads) for t in (q, k, v))
    kt = kh.float().transpose(-1, -2)
    vf = vh.float()
    blocks, lse = [], []
    for i in range(0, q.shape[1], block_q):
        logits = torch.matmul(qh[:, :, i:i + block_q].float(), kt)
        probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        blocks.append(torch.matmul(probs.float(), vf).to(v.dtype))
        if return_lse:
            lse.append(torch.logsumexp(logits * scale, dim=-1) * LOG2E)
    out = _merge(torch.cat(blocks, dim=2))
    if not return_lse:
        return out
    return out, torch.cat(lse, dim=2).reshape(-1, q.shape[1])


def attention_packed_bwd_plain(q, k, v, o, do, scale: float, num_heads: int,
                               block_q: int = 512, lse=None):
    """(dq, dk, dv) of ``attention_packed`` for the cotangent ``do``: the math
    of lvd_tpu's ``_attn_bwd_kernel`` in query blocks. P is recomputed in
    fp32 (a softmax of the logits, or exp2(logits * scale * log2(e) - lse)
    from the forward's base-2 log-sum-exp ``lse``, (B*H, S_q), as kernel E
    does); delta = rowsum(dO * O); dV += P^T dO (P in v's type);
    dS = P * (dO V^T - delta) * scale, cast to q's type; dQ = dS K;
    dK += dS^T Q; fp32 accumulation."""
    qh, kh, vh, oh, doh = (_split(t, num_heads) for t in (q, k, v, o, do))
    kf, vf = kh.float(), vh.float()
    if lse is not None:
        lse = lse.float().reshape(qh.shape[:3])
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq_blocks = []
    for i in range(0, q.shape[1], block_q):
        qb = qh[:, :, i:i + block_q].float()
        dob = doh[:, :, i:i + block_q].float()
        logits = torch.matmul(qb, kf.transpose(-1, -2))
        if lse is None:
            p = torch.softmax(logits * scale, dim=-1)
        else:
            p = torch.exp2(logits * (scale * LOG2E) - lse[:, :, i:i + block_q, None])
        delta = (dob * oh[:, :, i:i + block_q].float()).sum(-1, keepdim=True)
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dob)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = (p * (dp - delta) * scale).to(q.dtype).float()
        dq_blocks.append(torch.matmul(ds, kf).to(q.dtype))
        dk += torch.matmul(ds.transpose(-1, -2), qb)
    return _merge(torch.cat(dq_blocks, dim=2)), _merge(dk).to(k.dtype), _merge(dv).to(v.dtype)


def _check_shapes(name, q, k, v, num_heads):
    b, s_q, c = q.shape
    s_k = k.shape[1]
    if c % num_heads or k.shape != (b, s_k, c) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"with {num_heads} heads")
    if (c // num_heads) % 64:
        raise ValueError(f"{name}: head dim {c // num_heads}; the kernels take D % 64 == 0")


def _launch_forward(q, k, v, scale, num_heads, want_lse: bool):
    """Kernel A on CUDA tensors: (out, lse), lse None unless ``want_lse``."""
    _build.refuse_grad("attention_packed", q, k, v)
    code = _build.dtype_code(q, "attention_packed")
    q, k, v = (_build.kernel_input(t, q.dtype, f"attention_packed {n}")
               for t, n in ((q, "q"), (k, "k"), (v, "v")))
    _check_shapes("attention_packed", q, k, v, num_heads)
    b, s_q, c = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b * num_heads, s_q), dtype=torch.float32, device=q.device)
           if want_lse else None)
    err = _build.lib().lvd_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, num_heads, s_q, k.shape[1], c, float(scale), code, _build.stream_of(q))
    _build.check(err, "attention_packed")
    attention_packed.launches += 1
    attention_packed.lse_launches += lse is not None
    return out, lse


def attention_packed_with_lse(q, k, v, scale: float, num_heads: int):
    """(out, lse) of kernel A (the plain version on CPU tensors), outside
    autograd: the forward whose log-sum-exp a direct call of
    ``attention_packed_bwd`` takes."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, scale, num_heads, return_lse=True)
    return _launch_forward(q, k, v, scale, num_heads, True)


def attention_packed_bwd(q, k, v, o, do, scale: float, num_heads: int, need_dkdv: bool = True,
                         lse=None):
    """(dq, dk, dv): kernel E on CUDA tensors, the plain version on CPU
    tensors. ``lse`` is the base-2 log-sum-exp kernel A wrote for these q, k
    ((B*H, S_q) fp32); kernel E requires it (it recomputes no statistics),
    and a call without one raises. With ``need_dkdv`` False (keys and values
    need no gradient, as at the text cross-attention) dk and dv are None."""
    if q.device.type == "cpu":
        dq, dk, dv = attention_packed_bwd_plain(q, k, v, o, do, scale, num_heads, lse=lse)
        return (dq, dk, dv) if need_dkdv else (dq, None, None)
    _build.refuse_grad("attention_packed_bwd", q, k, v, o, do)
    code = _build.dtype_code(q, "attention_packed_bwd")
    q, k, v, o, do = (_build.kernel_input(t, q.dtype, f"attention_packed_bwd {n}")
                      for t, n in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")))
    _check_shapes("attention_packed_bwd", q, k, v, num_heads)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"attention_packed_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} "
                         f"for q {tuple(q.shape)}")
    b, s_q, c = q.shape
    if lse is None:
        raise RuntimeError("attention_packed_bwd: kernel E needs the log-sum-exp that kernel A "
                           "wrote in the forward (attention_packed under autograd, or "
                           "attention_packed_with_lse)")
    lse = _build.kernel_input(lse, torch.float32, "attention_packed_bwd lse")
    if lse.shape != (b * num_heads, s_q):
        raise ValueError(f"attention_packed_bwd: lse {tuple(lse.shape)} for "
                         f"{(b * num_heads, s_q)}")
    s_k = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k) if need_dkdv else None
    dv = torch.empty_like(v) if need_dkdv else None
    delta = torch.empty((b * num_heads, s_q), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().lvd_attention_packed_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), ptr(dk), ptr(dv), lse.data_ptr(), delta.data_ptr(),
        b, num_heads, s_q, s_k, c, float(scale), code, _build.stream_of(q))
    _build.check(err, "attention_packed_bwd")
    attention_packed_bwd.launches += 1
    return dq, dk, dv


class PackedAttention(torch.autograd.Function):
    """Forward kernel A, backward kernel E (plain versions on the CPU). The
    forward keeps the log-sum-exp for the backward when ``want_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads, want_lse):
        if q.device.type == "cpu":
            if want_lse:
                out, lse = attention_packed_plain(q, k, v, scale, num_heads, return_lse=True)
            else:
                out, lse = attention_packed_plain(q, k, v, scale, num_heads), None
        else:
            out, lse = _launch_forward(q, k, v, scale, num_heads, want_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = attention_packed_bwd(q, k, v, o, do, ctx.scale, ctx.num_heads, need_kv,
                                          lse=lse)
        return dq, dk, dv, None, None, None


def attention_packed(q, k, v, scale: float, num_heads: int):
    # Only a forward autograd records needs the log-sum-exp (Function.forward
    # runs with grad mode off, so the mode is read here).
    want_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return PackedAttention.apply(q, k, v, float(scale), int(num_heads), want_lse)


attention_packed.launches = 0
attention_packed.lse_launches = 0
attention_packed_bwd.launches = 0
