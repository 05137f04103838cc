"""Head-packed attention: kernel A and its plain version (counterpart of
lvd_tpu/ops/pallas_attention.py).

``attention_packed`` takes q (B, S_q, C) and k, v (B, S_k, C) with
C = heads * 64 packed, as lvd_tpu's ``attention_packed`` does, and returns
(B, S_q, C). On a CUDA tensor it launches kernel A
(csrc/packed_attention.cu, replacing ``_pallas_attention_heads`` and
``_pallas_attention_shortkey``); on a CPU tensor it runs the plain version,
which computes what lvd_tpu's ``_heads_chunked`` computes.
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 64


def attention_packed_plain(q, k, v, scale: float, num_heads: int, block_q: int = 512):
    """Exact softmax attention, query blocks of ``block_q`` so the (S, S)
    logits never exist at once: fp32 logits, probabilities cast to v's type,
    fp32 PV accumulation."""
    b, s_q, c = q.shape
    s_k = k.shape[1]
    d = c // num_heads
    qh = q.reshape(b, s_q, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, s_k, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, s_k, num_heads, d).transpose(1, 2)
    kt = kh.float().transpose(-1, -2)
    vf = vh.float()
    out = torch.empty_like(qh)
    for i in range(0, s_q, block_q):
        logits = torch.matmul(qh[:, :, i:i + block_q].float(), kt)
        probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
        out[:, :, i:i + block_q] = torch.matmul(probs.float(), vf).to(v.dtype)
    return out.transpose(1, 2).reshape(b, s_q, c)


def attention_packed(q, k, v, scale: float, num_heads: int):
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, scale, num_heads)
    q = _build.kernel_input(q, torch.bfloat16, "attention_packed q")
    k = _build.kernel_input(k, torch.bfloat16, "attention_packed k")
    v = _build.kernel_input(v, torch.bfloat16, "attention_packed v")
    b, s_q, c = q.shape
    s_k = k.shape[1]
    if c != num_heads * HEAD_DIM or k.shape != (b, s_k, c) or v.shape != k.shape:
        raise ValueError(
            f"attention_packed: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            f"with {num_heads} heads of {HEAD_DIM}")
    out = torch.empty_like(q)
    err = _build.lib().lvd_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, s_q, s_k, c, float(scale), _build.stream_of(q))
    _build.check(err, "attention_packed")
    attention_packed.launches += 1
    return out


attention_packed.launches = 0
