"""Recurrent sequence mixers, ported from ``repro.models.ssm``: Mamba2
(SSD) and xLSTM's mLSTM and sLSTM.

The linear-recurrent mixers share one chunked-parallel core:

    S_t = a_t * S_{t-1} + k_t v_t^T          (state: dk x dv per head)
    y_t = q_t . S_t

The reference scans over the chunks, computing each chunk's intra-chunk
term inside the scan. That term does not depend on the state, so the port
computes it for every chunk in one batched einsum, and each chunk's own
contribution to the state likewise; only the state recurrence across the
chunks (one multiply-add a chunk) is a Python loop. Mamba2 folds dt into v
and uses (C, B) as (q, k); mLSTM folds the exponential input gate into k
and appends a normalizer column to v. sLSTM is a true per-token recurrence
and stays a loop over the tokens.

Every state is float32 with the batch axis first. The sLSTM state is the
reference's ``(c, n, h, m)`` tuple as a dict of those four names, so that
a serving loop can index every state the same way.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .params import ParamMeta

State = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# shared chunked gated linear attention
# ---------------------------------------------------------------------------


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, state: Optional[torch.Tensor] = None,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, L, H, dk); v (B, L, H, dv); log_a (B, L, H) log-decay
    (<= 0); state (B, H, dk, dv) carried in, zeros when None.

    Returns y (B, L, H, dv) and the final state (B, H, dk, dv), float32.
    ``chunk`` shrinks to the largest divisor of L not above it, as in the
    reference.
    """
    b, l, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, l)
    while l % chunk:
        chunk -= 1
    nc = l // chunk

    qc = q.reshape(b, nc, chunk, h, dk).float()
    kc = k.reshape(b, nc, chunk, h, dk).float()
    vc = v.reshape(b, nc, chunk, h, dv).float()
    cl = log_a.reshape(b, nc, chunk, h).float().cumsum(2)      # inclusive

    # intra-chunk: pairwise decay exp(cl_i - cl_j), causal
    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    dec = cl[:, :, :, None, :] - cl[:, :, None, :, :]          # (B,N,Q,Q,H)
    dec = dec.masked_fill(~causal, -math.inf)
    att = torch.einsum("bnihd,bnjhd->bnijh", qc, kc) * torch.exp(dec)
    y = torch.einsum("bnijh,bnjhv->bnihv", att, vc)

    # each chunk's own state term sum_j exp(cl_last - cl_j) k_j v_j, then
    # S_c = exp(cl_last) S_{c-1} + that term across the chunks
    w = torch.exp(cl[:, :, -1:, :] - cl)                       # (B,N,Q,H)
    own = torch.einsum("bnjhd,bnjhv->bnhdv", kc * w[..., None], vc)
    decay = torch.exp(cl[:, :, -1])                            # (B,N,H)
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    carried = []
    for c in range(nc):
        carried.append(s)
        s = s * decay[:, c, :, None, None] + own[:, c]
    # carry-in: q_i . S_prev decayed by exp(cl_i)
    y = y + torch.einsum("bnihd,bnhdv->bnihv", qc * torch.exp(cl)[..., None],
                         torch.stack(carried, 1))
    return y.reshape(b, l, h, dv), s


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    a: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token state update. q, k (B, H, dk); v (B, H, dv); a (B, H)
    decay; state (B, H, dk, dv)."""
    state = state * a[..., None, None] + torch.einsum("bhd,bhv->bhdv", k, v)
    y = torch.einsum("bhd,bhdv->bhv", q, state)
    return y, state


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nheads = di // cfg.ssm_head_dim
    return di, nheads, cfg.ssm_state


def mamba2_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    di, nh, n = mamba2_dims(cfg)
    kc = cfg.conv_kernel
    return {
        "in_proj": ParamMeta((d, 2 * di + 2 * n + nh), ("fsdp", "tp")),
        "conv_w": ParamMeta((di + 2 * n, kc), ("tp", None), scale=0.5),
        "a_log": ParamMeta((nh,), ("tp",), init="zeros"),
        "dt_bias": ParamMeta((nh,), ("tp",), init="zeros"),
        "d_skip": ParamMeta((nh,), ("tp",), init="ones"),
        "norm": ParamMeta((di,), (None,), init="ones"),
        "out_proj": ParamMeta((di, d), ("tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along axis 1. x (B, L, C); w (C, K); state
    (B, K-1, C), the last K-1 inputs, for one decode token (L == 1).
    Returns (y (B, L, C), the new state: the last K-1 rows of the
    zero-padded input)."""
    k = w.shape[-1]
    if state is not None:                                       # decode
        window = torch.cat([state, x], dim=1)                   # (B, K, C)
        y = torch.einsum("bkc,ck->bc", window, w)[:, None, :]
        return y, window[:, 1:]
    pad = F.pad(x, (0, 0, k - 1, 0))
    # windows: y_t = sum_i x_{t-K+1+i} * w[:, i]
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + pad[:, i:i + x.shape[1], :] * w[:, i]
    return y, pad[:, -(k - 1):, :]


def mamba2_fwd(p, cfg: ArchConfig, x: torch.Tensor,
               state: Optional[State] = None, chunk: int = 128,
               return_state: bool = False
               ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, L, d). state: {"conv": (B, K-1, C), "ssd": (B, H, N, P)} for
    one decode token. Returns (output, the new state, or None when neither
    a state was given nor ``return_state`` asked)."""
    b, l, d = x.shape
    di, nh, n = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x.dtype

    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xin, bc, dt_pre = torch.split(zxbcdt, [di, di, 2 * n, nh], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)                      # (B,L,di+2n)
    conv_out, new_conv = _causal_conv(
        conv_in.float(), p["conv_w"].float(),
        None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus(dt_pre.float() + p["dt_bias"].float())     # (B,L,H)
    a = -torch.exp(p["a_log"].float())                          # (H,)
    log_decay = a * dt                                          # <= 0

    xh = xc.reshape(b, l, nh, hd)
    v = xh * dt[..., None]                                      # fold dt
    k = bmat[:, :, None, :].expand(b, l, nh, n)                 # shared B
    q = cmat[:, :, None, :].expand(b, l, nh, n)

    if state is None:
        y, ssd_state = chunked_gla(q, k, v, log_decay, chunk=chunk)
        new_state = ({"conv": new_conv, "ssd": ssd_state}
                     if return_state else None)
    else:
        yq, ssd_state = gla_decode_step(
            q[:, 0], k[:, 0], v[:, 0], torch.exp(log_decay[:, 0]),
            state["ssd"])
        y = yq[:, None]
        new_state = {"conv": new_conv, "ssd": ssd_state}

    y = y + xh * p["d_skip"].float()[:, None]
    y = y.reshape(b, l, di)
    # gated RMSNorm (Mamba2)
    y = y * F.silu(z.float())
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * p["norm"].float()
    return y.to(dt_) @ p["out_proj"].to(dt_), new_state


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None) -> State:
    di, nh, n = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * n),
                            dtype=torch.float32, device=device),
        "ssd": torch.zeros((batch, nh, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------


def mlstm_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    """xLSTM mLSTM block, projection factor 2. q/k are per-head
    (block-diagonal) projections of the up-projected branch and v is that
    branch. ``bf`` is ones: the ``ones`` rule ignores its scale of 3, as
    the reference's does."""
    d = cfg.d_model
    du = 2 * d                                                  # proj factor 2
    h = cfg.num_heads
    dh = du // h
    return {
        "w_up": ParamMeta((d, du), ("fsdp", "tp")),
        "w_gate": ParamMeta((d, du), ("fsdp", "tp")),
        "wq": ParamMeta((h, dh, dh), ("tp", None, None)),
        "wk": ParamMeta((h, dh, dh), ("tp", None, None)),
        "wi": ParamMeta((d, h), ("fsdp", "tp"), scale=0.01),
        "wf": ParamMeta((d, h), ("fsdp", "tp"), scale=0.01),
        "bi": ParamMeta((h,), ("tp",), init="zeros"),
        "bf": ParamMeta((h,), ("tp",), init="ones", scale=3.0),
        "norm": ParamMeta((du,), (None,), init="ones"),
        "w_down": ParamMeta((du, d), ("tp", "fsdp")),
    }


def mlstm_fwd(p, cfg: ArchConfig, x: torch.Tensor,
              state: Optional[State] = None, chunk: int = 128,
              return_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """Chunked-parallel mLSTM: the exponential input gate (its exponent
    capped at 8) folded into k, the sigmoid forget gate as the decay, the
    normalizer as an extra value column. state: {"mlstm": (B, H, dh,
    dh + 1)} for one decode token."""
    b, l, d = x.shape
    h = cfg.num_heads
    du = 2 * d
    dh = du // h
    dt_ = x.dtype

    u = x @ p["w_up"].to(dt_)
    gate = x @ p["w_gate"].to(dt_)
    ur = u.reshape(b, l, h, dh)
    q = torch.einsum("bshd,hde->bshe", ur, p["wq"].to(dt_)) / math.sqrt(dh)
    k = torch.einsum("bshd,hde->bshe", ur, p["wk"].to(dt_))

    xf = x.float()
    ig = xf @ p["wi"].float() + p["bi"].float()
    fg = xf @ p["wf"].float() + p["bf"].float()
    log_f = F.logsigmoid(fg)                                    # (B,L,H)
    i_gate = torch.exp(ig.clamp(max=8.0))                       # bounded

    kf = k.float() * i_gate[..., None]
    v_aug = torch.cat([ur.float(), ur.new_ones((b, l, h, 1),
                                               dtype=torch.float32)], -1)

    if state is None:
        y_aug, s_new = chunked_gla(q.float(), kf, v_aug, log_f, chunk=chunk)
        new_state = {"mlstm": s_new} if return_state else None
    else:
        y1, s_new = gla_decode_step(q[:, 0].float(), kf[:, 0], v_aug[:, 0],
                                    torch.exp(log_f[:, 0]), state["mlstm"])
        y_aug = y1[:, None]
        new_state = {"mlstm": s_new}

    y = y_aug[..., :dh] / y_aug[..., dh:].abs().clamp(min=1.0)
    y = y.reshape(b, l, du)
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * p["norm"].float()
    y = y.to(dt_) * F.silu(gate)
    return y @ p["w_down"].to(dt_), new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> State:
    h = cfg.num_heads
    dh = 2 * cfg.d_model // h
    return {"mlstm": torch.zeros((batch, h, dh, dh + 1), dtype=torch.float32,
                                 device=device)}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory, true recurrence)
# ---------------------------------------------------------------------------


SLSTM_STATE = ("c", "n", "h", "m")


def slstm_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    h = cfg.slstm_heads
    dh = d // h
    return {
        "w_gates": ParamMeta((d, 4, h, dh), ("fsdp", None, "tp", None)),
        "r_gates": ParamMeta((4, h, dh, dh), (None, "tp", None, None),
                             scale=0.01),
        "b_gates": ParamMeta((4, h, dh), (None, "tp", None), init="zeros"),
        "w_out": ParamMeta((d, d), ("fsdp", "tp")),
    }


def _slstm_cell(r_gates: torch.Tensor, b_gates: torch.Tensor,
                wx_t: torch.Tensor, carry: Tuple) -> Tuple:
    """wx_t (B, 4, H, dh) precomputed input contributions; r_gates (4, H,
    dh, dh) and b_gates (4, H, dh) float32; carry (c, n, h, m)."""
    c, n, hprev, m = carry
    rec = torch.einsum("bhd,ghde->bghe", hprev, r_gates)
    pre = wx_t + rec + b_gates
    zt = torch.tanh(pre[:, 0])
    it = pre[:, 1]
    ft = pre[:, 2]
    ot = torch.sigmoid(pre[:, 3])
    # stabilized exponential gating (xLSTM eq. 15-17)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / n_new.abs().clamp(min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_fwd(p, cfg: ArchConfig, x: torch.Tensor,
              state: Optional[State] = None, return_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """A scan over the tokens from ``state`` ({"c", "n", "h", "m"}, each
    (B, H, dh); the initial state when None). Returns (output, the final
    state, or None when neither a state was given nor ``return_state``
    asked)."""
    b, l, d = x.shape
    dt_ = x.dtype
    wx = torch.einsum("bsd,dghe->bsghe", x.float(),
                      p["w_gates"].float())                     # (B,L,4,H,dh)
    given = state
    if state is None:
        state = slstm_init_state(cfg, b, x.device)
    carry = tuple(state[name] for name in SLSTM_STATE)
    r_gates, b_gates = p["r_gates"].float(), p["b_gates"].float()
    hs = []
    for t in range(l):
        carry = _slstm_cell(r_gates, b_gates, wx[:, t], carry)
        hs.append(carry[2])
    y = torch.stack(hs, 1).reshape(b, l, d)
    out = y.to(dt_) @ p["w_out"].to(dt_)
    if given is None and not return_state:
        return out, None
    return out, dict(zip(SLSTM_STATE, carry))


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> State:
    h = cfg.slstm_heads
    dh = cfg.d_model // h
    state = {name: torch.zeros((batch, h, dh), dtype=torch.float32,
                               device=device) for name in "cnh"}
    state["m"] = torch.full((batch, h, dh), -1e30, dtype=torch.float32,
                            device=device)
    return state


# the mixer of each recurrent layer kind: (meta, forward, initial state)
MIXERS = {
    "mamba2": (mamba2_meta, mamba2_fwd, mamba2_init_state),
    "mlstm": (mlstm_meta, mlstm_fwd, mlstm_init_state),
    "slstm": (slstm_meta, slstm_fwd, slstm_init_state),
}
