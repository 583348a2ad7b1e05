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

Tensor parallelism over ``model`` (``tp``, a ``blocks.TensorParallel``)
cuts each mixer by heads (``mixer_runs``: the layout of every weight): a
rank holds its heads' columns of the input projections and their rows of
the output one, runs its heads' recurrence and state, and the partial
outputs are summed over ``model``. The norms over the whole inner width
(Mamba2's gated RMSNorm, mLSTM's) all-reduce each rank's float32 sum of
squares. Mamba2's B and C (one group) stand whole on every rank inside
the cut ``in_proj`` and ``conv_w``, their gradients summed over
``model``. Where ``model`` does not divide the heads (``mixer_cut``) the
mixer runs whole on every rank and its forward is given no ``tp``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .blocks import Runs, TensorParallel, _reduce_pe
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


def mamba2_runs(cfg: ArchConfig) -> Dict[str, Runs]:
    """Each weight's layout over ``model``: a rank's heads' z, x and dt
    columns of ``in_proj`` and rows of ``conv_w`` (B and C whole), its
    heads' decay, dt bias and skip, its channels of the norm and its rows
    of ``out_proj``. The reference's rules cut ``in_proj``'s columns
    contiguously, which would give a rank nothing but z."""
    di, nh, n = mamba2_dims(cfg)
    heads = Runs.cut(0, nh)
    return {"in_proj": Runs(1, ((di, True), (di, True), (2 * n, False),
                                (nh, True))),
            "conv_w": Runs(0, ((di, True), (2 * n, False))),
            "a_log": heads, "dt_bias": heads, "d_skip": heads,
            "norm": Runs.cut(0, di), "out_proj": Runs.cut(0, di)}


def _gated_norm(y: torch.Tensor, width: int,
                tp: Optional[TensorParallel]) -> torch.Tensor:
    """``y`` times rsqrt(its mean square over the ``width`` channels +
    1e-6): with ``tp`` this rank's block of them, the sum of squares
    all-reduced over ``model``."""
    if tp is not None:
        var = tp.sum_squares(y) / width
    else:
        var = y.square().mean(-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6)


def mamba2_fwd(p, cfg: ArchConfig, x: torch.Tensor,
               state: Optional[State] = None, chunk: int = 128,
               return_state: bool = False,
               tp: Optional[TensorParallel] = None
               ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, L, d). state: {"conv": (B, K-1, C), "ssd": (B, H, N, P)} for
    one decode token. Returns (output, the new state, or None when neither
    a state was given nor ``return_state`` asked). With ``tp`` (the mixer
    cut, ``p`` a block of the heads: ``mamba2_runs``) H is this rank's
    heads and C its channels plus B and C."""
    b, l, d = x.shape
    di, _, n = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x.dtype
    nh_l = p["a_log"].shape[0]
    di_l = nh_l * hd
    w_in, conv_w = p["in_proj"], p["conv_w"]
    if tp is not None:
        runs = mamba2_runs(cfg)
        x = tp.copy(x)
        w_in = tp.sync(w_in, runs["in_proj"])
        conv_w = tp.sync(conv_w, runs["conv_w"])

    zxbcdt = x @ w_in.to(dt_)
    z, xin, bc, dt_pre = torch.split(zxbcdt, [di_l, di_l, 2 * n, nh_l],
                                     dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)                      # (B,L,C)
    conv_out, new_conv = _causal_conv(
        conv_in.float(), conv_w.float(),
        None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [di_l, n, n], dim=-1)

    dt = F.softplus(dt_pre.float() + p["dt_bias"].float())     # (B,L,H)
    a = -torch.exp(p["a_log"].float())                          # (H,)
    log_decay = a * dt                                          # <= 0

    xh = xc.reshape(b, l, nh_l, hd)
    v = xh * dt[..., None]                                      # fold dt
    k = bmat[:, :, None, :].expand(b, l, nh_l, n)               # shared B
    q = cmat[:, :, None, :].expand(b, l, nh_l, n)

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
    y = y.reshape(b, l, di_l)
    # gated RMSNorm (Mamba2)
    y = y * F.silu(z.float())
    y = _gated_norm(y, di, tp) * p["norm"].float()
    out = y.to(dt_) @ p["out_proj"].to(dt_)
    if tp is not None:
        out = tp.reduce(out, _reduce_pe(cfg))
    return out, new_state


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None,
                      parts: int = 1) -> State:
    """The zero state; ``parts``: the ranks the heads are cut over."""
    di, nh, n = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di // parts + 2 * n),
                            dtype=torch.float32, device=device),
        "ssd": torch.zeros((batch, nh // parts, n, cfg.ssm_head_dim),
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


def mlstm_runs(cfg: ArchConfig) -> Dict[str, Runs]:
    """Each weight's layout over ``model``: a rank's heads' columns of
    ``w_up``, ``w_gate``, ``wi`` and ``wf``, their ``wq``, ``wk``, ``bi``
    and ``bf``, its channels of the norm and its rows of ``w_down``."""
    h, du = cfg.num_heads, 2 * cfg.d_model
    heads, cols = Runs.cut(0, h), Runs.cut(1, du)
    return {"w_up": cols, "w_gate": cols, "wq": heads, "wk": heads,
            "wi": Runs.cut(1, h), "wf": Runs.cut(1, h), "bi": heads,
            "bf": heads, "norm": Runs.cut(0, du), "w_down": Runs.cut(0, du)}


def mlstm_fwd(p, cfg: ArchConfig, x: torch.Tensor,
              state: Optional[State] = None, chunk: int = 128,
              return_state: bool = False,
              tp: Optional[TensorParallel] = None
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """Chunked-parallel mLSTM: the exponential input gate (its exponent
    capped at 8) folded into k, the sigmoid forget gate as the decay, the
    normalizer as an extra value column. state: {"mlstm": (B, H, dh,
    dh + 1)} for one decode token (with ``tp``, the mixer cut and ``p`` a
    block of the heads, ``mlstm_runs``: H this rank's heads)."""
    b, l, d = x.shape
    du = 2 * d
    dh = du // cfg.num_heads
    h = p["wq"].shape[0]
    dt_ = x.dtype
    if tp is not None:
        x = tp.copy(x)

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
    y = y.reshape(b, l, h * dh)
    y = _gated_norm(y, du, tp) * p["norm"].float()
    y = y.to(dt_) * F.silu(gate)
    out = y @ p["w_down"].to(dt_)
    if tp is not None:
        out = tp.reduce(out, _reduce_pe(cfg))
    return out, new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None,
                     parts: int = 1) -> State:
    """The zero state; ``parts``: the ranks the heads are cut over."""
    h = cfg.num_heads
    dh = 2 * cfg.d_model // h
    return {"mlstm": torch.zeros((batch, h // parts, dh, dh + 1),
                                 dtype=torch.float32, device=device)}


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


def slstm_runs(cfg: ArchConfig) -> Dict[str, Runs]:
    """Each weight's layout over ``model``: a rank's heads of ``w_gates``,
    ``r_gates`` (block-diagonal by head: the recurrence needs no
    collective) and ``b_gates``, and the rows of ``w_out`` that its heads'
    outputs meet. The reference's rules cut ``w_out``'s columns instead."""
    h = cfg.slstm_heads
    return {"w_gates": Runs.cut(2, h), "r_gates": Runs.cut(1, h),
            "b_gates": Runs.cut(1, h), "w_out": Runs.cut(0, cfg.d_model)}


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
              state: Optional[State] = None, return_state: bool = False,
              tp: Optional[TensorParallel] = None
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """A scan over the tokens from ``state`` ({"c", "n", "h", "m"}, each
    (B, H, dh); the initial state when None). Returns (output, the final
    state, or None when neither a state was given nor ``return_state``
    asked). With ``tp`` (the mixer cut, ``p`` a block of the heads:
    ``slstm_runs``) H is this rank's heads, and the partial outputs are
    summed over ``model`` once, after the scan."""
    b, l, d = x.shape
    dt_ = x.dtype
    parts = 1 if tp is None else tp.size
    if tp is not None:
        x = tp.copy(x)
    wx = torch.einsum("bsd,dghe->bsghe", x.float(),
                      p["w_gates"].float())                     # (B,L,4,H,dh)
    given = state
    if state is None:
        state = slstm_init_state(cfg, b, x.device, parts)
    carry = tuple(state[name] for name in SLSTM_STATE)
    r_gates, b_gates = p["r_gates"].float(), p["b_gates"].float()
    hs = []
    for t in range(l):
        carry = _slstm_cell(r_gates, b_gates, wx[:, t], carry)
        hs.append(carry[2])
    y = torch.stack(hs, 1).reshape(b, l, d // parts)
    out = y.to(dt_) @ p["w_out"].to(dt_)
    if tp is not None:
        out = tp.reduce(out, _reduce_pe(cfg))
    if given is None and not return_state:
        return out, None
    return out, dict(zip(SLSTM_STATE, carry))


def slstm_init_state(cfg: ArchConfig, batch: int, device=None,
                     parts: int = 1) -> State:
    """The initial state; ``parts``: the ranks the heads are cut over."""
    h = cfg.slstm_heads // parts
    dh = cfg.d_model // cfg.slstm_heads
    state = {name: torch.zeros((batch, h, dh), dtype=torch.float32,
                               device=device) for name in "cnh"}
    state["m"] = torch.full((batch, h, dh), -1e30, dtype=torch.float32,
                            device=device)
    return state


class Mixer(NamedTuple):
    """A recurrent layer kind's mixer: its parameters' meta, its forward,
    its initial state (``parts``: the ranks its heads are cut over), each
    weight's layout over ``model`` when cut, and its head count."""
    meta: Callable
    fwd: Callable
    init_state: Callable
    runs: Callable
    heads: Callable


MIXERS = {
    "mamba2": Mixer(mamba2_meta, mamba2_fwd, mamba2_init_state, mamba2_runs,
                    lambda cfg: mamba2_dims(cfg)[1]),
    "mlstm": Mixer(mlstm_meta, mlstm_fwd, mlstm_init_state, mlstm_runs,
                   lambda cfg: cfg.num_heads),
    "slstm": Mixer(slstm_meta, slstm_fwd, slstm_init_state, slstm_runs,
                   lambda cfg: cfg.slstm_heads),
}


def mixer_cut(kind: str, cfg: ArchConfig, size: int) -> bool:
    """Whether a ``kind`` mixer is cut by heads over a ``model`` axis of
    ``size`` (else it runs whole on every rank)."""
    return size > 1 and MIXERS[kind].heads(cfg) % size == 0


def mixer_runs(kind: str, cfg: ArchConfig,
               size: int) -> Dict[str, Optional[Runs]]:
    """The layout over a ``model`` axis of ``size`` of each weight of a
    ``kind`` mixer: cut by heads, or (``mixer_cut`` false) None
    everywhere."""
    runs = MIXERS[kind].runs(cfg)
    return runs if mixer_cut(kind, cfg, size) else dict.fromkeys(runs)
