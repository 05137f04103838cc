"""Cross-attention energy guidance (counterpart of
lvd_tpu/diffusion/guidance.py:194-443).

The energy of one video is a tensor expression per instrumented attention
site: box masks come pre-rasterized (layout/rasterize.make_guidance_pack),
token gathers are a one-hot product over a padded (O, P) index matrix, and
"mean of the top-k with a per-(object, frame) k" is a top-k to a static bound
with a rank < k weight. Its gradient with respect to the latents comes from
autograd through the UNet's captured attention maps (diffusion/sampler.py).

Variants, with the same knobs as lvd_tpu: max-based (default), ratio-based,
CE/NLL, attn-sync temporal consistency, BoxDiff corners (``boxdiff_L``),
center-of-mass position and velocity, ``attn_renorm``, ``upsample_scale``
(bilinear or nearest) and ``smooth_attn``. lvd_tpu's known deviations from
the torch reference (ADVICE.md) are kept: corner bands are derived from the
rasterized masks with half-width ``boxdiff_L``, and smoothing blurs each
token map spatially after the renorm. Frame-sharded (``axis_name``, a
parallel/comm.Group over which the frames are split in order): the
per-frame terms sum on each rank and the energy is psummed; the
frame-coupled terms (attn-sync, the CoM velocity) take the boundary frame
of the next rank by ppermute, and the video's last frame is the one
without a successor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm

# The 6 instrumented cross-attention sites of the flagship runs (a copy of
# lvd_tpu/runners/base.py:26-33).
OVERALL_GUIDANCE_ATTN_KEYS = (
    ("down", 1, 0, 0),
    ("down", 2, 0, 0),
    ("down", 2, 1, 0),
    ("up", 1, 0, 0),
    ("up", 1, 1, 0),
    ("up", 2, 2, 0),
)


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Hyperparameters of the energy (every field of lvd_tpu's, same
    defaults)."""

    loss_scale: float = 5.0
    loss_threshold: float = 200.0
    max_iter: int = 5
    max_index_step: int = 10
    fg_top_p: float = 0.75
    bg_top_p: float = 0.75
    fg_weight: float = 1.0
    bg_weight: float = 4.0
    use_ratio_based_loss: bool = False
    use_max_based_loss: bool = True
    attn_sync_weight: float = 0.0
    boxdiff_loss_scale: float = 0.0
    boxdiff_normed: bool = True
    boxdiff_L: int = 1
    com_loss_scale: float = 0.0
    eps: float = 1e-2
    attn_renorm: bool = False
    renorm_scale: float = 2.0
    renorm_num_tokens: int = 0
    upsample_scale: int = 1
    upsample_mode: str = "bilinear"
    smooth_attn: bool = False
    smooth_kernel_size: int = 3
    smooth_sigma: float = 0.5
    # "selective": checkpoint each UNet layer below the deepest width in the
    # energy walk (torch.utils.checkpoint); "none" keeps every activation.
    energy_remat: str = "none"


def _rank_weights(k, k_max: int, device):
    """(..., k_max) weight 1/k on ranks < k, 0 elsewhere."""
    ranks = torch.arange(k_max, device=device, dtype=torch.float32)
    kf = k.float()[..., None]
    return (ranks < kf).float() / torch.clamp(kf, min=1.0)


class TopkMean(torch.autograd.Function):
    """Mean of the top-k entries of the last axis, k per slice. The backward
    is lvd_tpu's threshold rule (``_topk_mean_core_bwd``): the gradient
    [value >= k-th largest] / k, an elementwise compare instead of a scatter
    through the top-k indices."""

    @staticmethod
    def forward(ctx, values, kf, k_max: int):
        top = torch.topk(values, k_max, dim=-1).values
        out = (top * _rank_weights(kf, k_max, values.device)).sum(-1)
        idx = torch.clamp(kf.long() - 1, 0, k_max - 1)
        thresh = torch.gather(top, -1, idx[..., None])[..., 0]
        ctx.save_for_backward(values, kf, thresh)
        return out

    @staticmethod
    def backward(ctx, g):
        values, kf, thresh = ctx.saved_tensors
        sel = (values >= thresh[..., None]).float()
        kk = kf[..., None]
        dv = g[..., None] * sel / torch.clamp(kk, min=1.0) * (kk > 0).float()
        return dv, None, None


def _topk_mean_desc(values, k, k_max: int = None):
    """Mean of the top-k entries along the last axis; k broadcastable
    against values[..., 0]; ``k_max`` a static bound on every k."""
    n = values.shape[-1]
    k_max = n if k_max is None else min(int(k_max), n)
    kf = torch.broadcast_to(k.float(), values.shape[:-1]).contiguous()
    return TopkMean.apply(values, kf, k_max)


def _topk_mean_via_log(values, k, eps, k_max: int = None):
    """Mean of -log of the top-k values (the CE variant); autograd through
    the top-k selection."""
    n = values.shape[-1]
    k_max = n if k_max is None else min(int(k_max), n)
    if k_max < n:
        top = torch.topk(values, k_max, dim=-1).values
    else:
        top = torch.sort(values, dim=-1, descending=True).values
    w = _rank_weights(k, k_max, values.device)
    return (-torch.log(torch.clamp(top, min=eps)) * w).sum(-1)


def _roll_next_frames(x, frame_axis: int, axis_name=None):
    """x at frame f+1 along ``frame_axis``; the last slot repeats the last
    frame, or sharded holds the next rank's first frame (zeros on the last
    rank); callers weight the video's last frame out with
    ``_frame_validity``."""
    n = x.shape[frame_axis]
    rest = x.narrow(frame_axis, 1, n - 1)
    if axis_name is None:
        last = x.narrow(frame_axis, n - 1, 1)
    else:
        size = comm.axis_size(axis_name)
        last = comm.ppermute(x.narrow(frame_axis, 0, 1), axis_name,
                             [(i + 1, i) for i in range(size - 1)])
    return torch.cat([rest, last], dim=frame_axis)


def _frame_validity(n_f: int, device, axis_name=None):
    """(F_local,) 1.0 for frames that have a successor in the video."""
    idx = torch.arange(n_f, device=device)
    total = n_f
    if axis_name is not None:
        idx = idx + comm.axis_index(axis_name) * n_f
        total = n_f * comm.axis_size(axis_name)
    return (idx < total - 1).float()


def _center_of_mass(x):
    """x: (..., H, W) nonnegative -> (com_h, com_w) each (...,)."""
    h, w = x.shape[-2], x.shape[-1]
    total = x.sum((-1, -2)) + 1e-12
    hr = torch.arange(h, dtype=torch.float32, device=x.device)
    wr = torch.arange(w, dtype=torch.float32, device=x.device)
    return (x.sum(-1) * hr).sum(-1) / total, (x.sum(-2) * wr).sum(-1) / total


def _corner_bands(masks, band: int = 1):
    """Per-(object, frame) indicator bands of half-width ``band`` around the
    box x/y extents, derived from the rasterized masks."""

    def band_of(proj):
        padded = F.pad(proj, (1, 1))
        edges = torch.abs(padded[..., 1:] - padded[..., :-1])
        out = torch.maximum(edges[..., :-1], edges[..., 1:])
        for _ in range(band):
            out = torch.maximum(out, torch.maximum(F.pad(out[..., 1:], (0, 1)),
                                                   F.pad(out[..., :-1], (1, 0))))
        return out

    return band_of(masks.amax(-2)), band_of(masks.amax(-1))


def gather_token_maps(attn, token_indices):
    """(F, heads, HW, L) probabilities -> (O, P, F, heads, HW) maps of each
    object's tokens, as a one-hot product (an out-of-range index gives a zero
    map)."""
    n_f, n_heads, hw, n_l = attn.shape
    n_obj, n_p = token_indices.shape
    onehot = (token_indices.reshape(-1)[None, :]
              == torch.arange(n_l, device=attn.device)[:, None]).to(attn.dtype)
    gathered = (attn @ onehot).reshape(n_f, n_heads, hw, n_obj, n_p)
    return gathered.permute(3, 4, 0, 1, 2)


def ca_energy_for_key(attn, masks, token_indices, token_mask, k_fg, k_bg, cfg: GuidanceConfig,
                      axis_name=None):
    """Energy of one instrumented site: attn (F, heads, HW, L) fp32
    probabilities (cond-only), masks (O, F, Hk, Wk), token_indices (O, P)
    int, token_mask (O, P), k_fg / k_bg (O, F) int; sharded, F is this
    rank's frames of ``axis_name``. Returns the sum over objects of
    per-object losses, each divided by its valid token count."""
    n_f, n_heads, hw, _ = attn.shape
    n_obj, n_p = token_indices.shape
    hk, wk = masks.shape[2], masks.shape[3]
    s_up = int(cfg.upsample_scale)
    if s_up != 1:
        assert hk % s_up == 0 and wk % s_up == 0 and (hk // s_up) * (wk // s_up) == hw, (
            f"mask grid {hk}x{wk} not {s_up}x the attn dim {hw}")
    else:
        assert hk * wk == hw, f"mask grid {hk}x{wk} != attn dim {hw}"

    attn = attn.float()
    if cfg.attn_renorm:
        nt = int(cfg.renorm_num_tokens)
        assert nt > 2, "attn_renorm needs renorm_num_tokens (prompt length)"
        attn = torch.softmax(attn[..., 1:nt - 1] * cfg.renorm_scale, dim=-1)
        token_indices = token_indices - 1
    a = gather_token_maps(attn, token_indices)          # (O, P, F, h, HW)
    if s_up != 1:
        mode = {"bilinear": "bilinear", "nearest": "nearest"}[cfg.upsample_mode]
        small = a.reshape(-1, 1, hk // s_up, wk // s_up)
        kw = {"align_corners": False} if mode == "bilinear" else {}
        a = F.interpolate(small, size=(hk, wk), mode=mode, **kw)
        a = a.reshape(n_obj, n_p, n_f, n_heads, hk * wk)
        hw = hk * wk
    if cfg.smooth_attn:
        from ..ops.smoothing import smooth_attn_maps

        a = smooth_attn_maps(a.reshape(n_obj, n_p, n_f, n_heads, hk, wk),
                             cfg.smooth_kernel_size, cfg.smooth_sigma)
        a = a.reshape(n_obj, n_p, n_f, n_heads, hw)

    m = masks.reshape(n_obj, 1, n_f, 1, hw)
    obj_loss = torch.zeros((n_obj, n_p, n_f), dtype=torch.float32, device=attn.device)
    kf_max = int(hw * cfg.fg_top_p) + 1
    kb_max = int(hw * cfg.bg_top_p) + 1
    lead = a.shape[:-1]
    kf = torch.broadcast_to(k_fg[:, None, :, None], lead)
    kb = torch.broadcast_to(k_bg[:, None, :, None], lead)

    if cfg.use_ratio_based_loss:
        ratio = (a * m).sum(-1) / (a.sum(-1) + cfg.eps)
        obj_loss = obj_loss + ((1.0 - ratio) ** 2).mean(-1)
    elif cfg.use_max_based_loss:
        fg_mean = _topk_mean_desc(a * m, kf, kf_max)
        bg_mean = _topk_mean_desc(a * (1.0 - m), kb, kb_max)
        obj_loss = obj_loss + cfg.fg_weight * (1.0 - fg_mean).sum(-1)
        obj_loss = obj_loss + cfg.bg_weight * bg_mean.sum(-1)
    else:
        a_c = torch.clamp(a, cfg.eps, 1.0 - cfg.eps)
        fg = _topk_mean_via_log(a_c * m, kf, cfg.eps, kf_max)
        bg_mean = _topk_mean_desc(a_c * (1.0 - m), kb, kb_max)
        obj_loss = obj_loss + cfg.fg_weight * fg.sum(-1)
        obj_loss = obj_loss + cfg.bg_weight * (-torch.log(1.0 - bg_mean)).sum(-1)

    if cfg.attn_sync_weight != 0.0:
        a_next = _roll_next_frames(a, 2, axis_name)
        area = m.sum(-1) + 1e-6
        sync = ((((a - a_next) ** 2) * m).sum(-1) / area).sum(-1)
        obj_loss = obj_loss + cfg.attn_sync_weight * sync * _frame_validity(n_f, a.device,
                                                                              axis_name)

    if cfg.boxdiff_loss_scale > 0.0 or cfg.com_loss_scale > 0.0:
        a2d = a.reshape(n_obj, n_p, n_f, n_heads, hk, wk)
        m2d = masks[:, None, :, None]

    if cfg.boxdiff_loss_scale > 0.0:
        corner_x, corner_y = _corner_bands(masks, band=int(cfg.boxdiff_L))
        dx = torch.abs(a2d.amax(-2) - m2d.amax(-2)) * corner_x[:, None, :, None]
        dy = torch.abs(a2d.amax(-1) - m2d.amax(-1)) * corner_y[:, None, :, None]
        if cfg.boxdiff_normed:
            cc = dx.mean((-1, -2)) + dy.mean((-1, -2))
        else:
            cc = dx.sum((-1, -2)) + dy.sum((-1, -2))
        obj_loss = obj_loss + cfg.boxdiff_loss_scale * cc

    if cfg.com_loss_scale > 0.0:
        present = (masks.sum((-1, -2)) > 0).float()          # (O, F)
        com_a_h, com_a_w = _center_of_mass(a2d)              # (O, P, F, h)
        com_m_h, com_m_w = _center_of_mass(masks)            # (O, F)
        pos = ((com_a_h - com_m_h[:, None, :, None]) ** 2
               + (com_a_w - com_m_w[:, None, :, None]) ** 2)
        obj_loss = obj_loss + cfg.com_loss_scale * pos.mean(-1) * present[:, None, :]
        nxt = lambda x: _roll_next_frames(x, 2, axis_name)
        nxt_m = lambda x: _roll_next_frames(x, 1, axis_name)
        v_a_h, v_a_w = nxt(com_a_h) - com_a_h, nxt(com_a_w) - com_a_w
        v_m_h, v_m_w = nxt_m(com_m_h) - com_m_h, nxt_m(com_m_w) - com_m_w
        both = present * nxt_m(present) * _frame_validity(n_f, masks.device, axis_name)
        vel = ((v_a_h - v_m_h[:, None, :, None]) ** 2
               + (v_a_w - v_m_w[:, None, :, None]) ** 2)
        obj_loss = obj_loss + cfg.com_loss_scale * vel.mean(-1) * both[:, None, :]

    per_obj = (obj_loss.sum(-1) * token_mask).sum(-1)
    counts = torch.clamp(token_mask.sum(-1), min=1.0)
    return (per_obj / counts).sum()


def compute_ca_energy(aux: Dict[Tuple, torch.Tensor], pack, guidance_attn_keys: Sequence[Tuple],
                      cfg: GuidanceConfig, axis_name=None):
    """Total energy over the instrumented sites: the per-site energies summed
    and divided by (num_objects * num_keys). ``pack`` holds the guidance
    tensors (diffusion/sampler.GuidanceTensors) on the maps' device, its
    masks and k values this rank's frames where ``axis_name`` shards them;
    the energy is then psummed over the ranks."""
    keys = [tuple(k) for k in guidance_attn_keys]
    num_objects = pack.token_indices.shape[0]
    device = next(iter(aux.values())).device if aux else pack.token_mask.device
    if num_objects == 0 or not keys:
        return torch.zeros((), dtype=torch.float32, device=device)
    loss = torch.zeros((), dtype=torch.float32, device=device)
    for key in keys:
        loss = loss + ca_energy_for_key(aux[key], pack.masks[key], pack.token_indices,
                                        pack.token_mask, pack.k_fg[key], pack.k_bg[key], cfg,
                                        axis_name)
    if axis_name is not None:
        loss = comm.psum(loss, axis_name)
    return loss / (num_objects * len(keys))
