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
lvd_tpu's predicates do (D of 64 and 128 in their own instantiations, every
other D in a D-sliced form). A raw launch on a tensor that requires grad
raises (``_build.refuse_grad``).
"""

from __future__ import annotations

import torch

from . import _build

def _split(t, num_heads):
    b, s, c = t.shape
    return t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def _merge(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def attention_packed_plain(q, k, v, scale: float, num_heads: int, block_q: int = 512):
    """Exact softmax attention, query blocks of ``block_q`` so the (S, S)
    logits never exist at once: fp32 logits, probabilities cast to v's type,
    fp32 PV accumulation (lvd_tpu's ``_heads_chunked``)."""
    qh, kh, vh = (_split(t, num_heads) for t in (q, k, v))
    kt = kh.float().transpose(-1, -2)
    vf = vh.float()
    blocks = []
    for i in range(0, q.shape[1], block_q):
        logits = torch.matmul(qh[:, :, i:i + block_q].float(), kt)
        probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        blocks.append(torch.matmul(probs.float(), vf).to(v.dtype))
    return _merge(torch.cat(blocks, dim=2))


def attention_packed_bwd_plain(q, k, v, o, do, scale: float, num_heads: int,
                               block_q: int = 512):
    """(dq, dk, dv) of ``attention_packed`` for the cotangent ``do``: the math
    of lvd_tpu's ``_attn_bwd_kernel`` in query blocks. P is recomputed in
    fp32; delta = rowsum(dO * O); dV += P^T dO (P in v's type);
    dS = P * (dO V^T - delta) * scale, cast to q's type; dQ = dS K;
    dK += dS^T Q; fp32 accumulation."""
    qh, kh, vh, oh, doh = (_split(t, num_heads) for t in (q, k, v, o, do))
    kf, vf = kh.float(), vh.float()
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq_blocks = []
    for i in range(0, q.shape[1], block_q):
        qb = qh[:, :, i:i + block_q].float()
        dob = doh[:, :, i:i + block_q].float()
        p = torch.softmax(torch.matmul(qb, kf.transpose(-1, -2)) * scale, dim=-1)
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


def _launch_forward(q, k, v, scale, num_heads):
    """Kernel A on CUDA tensors."""
    _build.refuse_grad("attention_packed", q, k, v)
    code = _build.dtype_code(q, "attention_packed")
    q, k, v = (_build.kernel_input(t, q.dtype, f"attention_packed {n}")
               for t, n in ((q, "q"), (k, "k"), (v, "v")))
    _check_shapes("attention_packed", q, k, v, num_heads)
    b, s_q, c = q.shape
    out = torch.empty_like(q)
    err = _build.lib().lvd_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, s_q, k.shape[1], c, float(scale), code, _build.stream_of(q))
    _build.check(err, "attention_packed")
    attention_packed.launches += 1
    return out


def attention_packed_bwd(q, k, v, o, do, scale: float, num_heads: int, need_dkdv: bool = True):
    """(dq, dk, dv): kernel E on CUDA tensors, the plain version on CPU
    tensors. With ``need_dkdv`` False (keys and values need no gradient, as
    at the text cross-attention) dk and dv are None."""
    if q.device.type == "cpu":
        dq, dk, dv = attention_packed_bwd_plain(q, k, v, o, do, scale, num_heads)
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
    s_k = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k) if need_dkdv else None
    dv = torch.empty_like(v) if need_dkdv else None
    stats = torch.empty((2, b * num_heads * s_q), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().lvd_attention_packed_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), ptr(dk), ptr(dv), stats[0].data_ptr(), stats[1].data_ptr(),
        b, num_heads, s_q, s_k, c, float(scale), code, _build.stream_of(q))
    _build.check(err, "attention_packed_bwd")
    attention_packed_bwd.launches += 1
    return dq, dk, dv


class PackedAttention(torch.autograd.Function):
    """Forward kernel A, backward kernel E (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        if q.device.type == "cpu":
            out = attention_packed_plain(q, k, v, scale, num_heads)
        else:
            out = _launch_forward(q, k, v, scale, num_heads)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = attention_packed_bwd(q, k, v, o, do, ctx.scale, ctx.num_heads, need_kv)
        return dq, dk, dv, None, None


def attention_packed(q, k, v, scale: float, num_heads: int):
    return PackedAttention.apply(q, k, v, float(scale), int(num_heads))


attention_packed.launches = 0
attention_packed_bwd.launches = 0
