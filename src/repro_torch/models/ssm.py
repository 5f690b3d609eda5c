"""Recurrent blocks of the port (the reference's ``models/ssm.py``): mLSTM
and sLSTM (xLSTM) and mamba (hymba's parallel branch).

The reference runs its scans in plain JAX (``lax.scan``,
``associative_scan``), with no Pallas kernel; the port keeps their
structure as host loops of torch operations:

* sLSTM is sequential (``h`` feeds the gates through ``R``): one step a
  token, the four recurrent matrices stacked into one ``[H, dh, 4 dh]``
  batched product a step;
* mLSTM prefill is chunkwise (matrix products within a chunk of 128, a
  loop over chunks carrying the state); decode, and a length that is not a
  multiple of the chunk, take the exact sequential recurrence;
* mamba's prefill is a log-depth (Hillis-Steele) doubling scan within a
  chunk of up to 128 steps with the reference's ``combine``, a sequential
  carry between chunks; one token takes the single step.

Every state is float32 and O(1) in the sequence length.  The primitives
(``mlstm_sequential``, ``mlstm_chunkwise``, ``causal_conv1d``) return
their new state, as the reference's do; the blocks take a cache slice
(``serve.cache``) as ``state`` and write the new state into it in place,
since the model stack keeps the caller's buffers.  Weights are cast to the
activation dtype at use, as in the reference, except ``A_log`` and the
sLSTM ``r*`` matrices, read in float32 (``layers.FLOAT32_LEAVES``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import Init, rms_norm

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# mLSTM prefill's chunk (the reference's ``mlstm_block`` default)
MLSTM_CHUNK = 128
# mamba's largest scan chunk (the reference's ``chunk = min(128, T)``)
MAMBA_CHUNK = 128

# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def _fresh_cell(B: int, H: int, dk: int, dv: int, device) -> State:
    return (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((B, H, dk), dtype=torch.float32, device=device),
            torch.full((B, H), -math.inf, dtype=torch.float32,
                       device=device))


def mlstm_sequential(q, k, v, i_raw, lf, state: Optional[State] = None
                     ) -> Tuple[torch.Tensor, State]:
    """Exact stabilized mLSTM recurrence (decode step, and prefill at a
    length that is not a multiple of the chunk).

    q, k [B, T, H, dk]; v [B, T, H, dv]; i_raw, lf [B, T, H] (lf =
    logsigmoid of the forget gate).  state: (C [B, H, dk, dv], n [B, H,
    dk], m [B, H]); ``None`` starts m at -inf.  Returns (h [B, T, H, dv]
    float32, new state)."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    C, n, m = state if state is not None else _fresh_cell(B, H, dk, dv,
                                                          q.device)
    qf = q.float() / math.sqrt(dk)
    kf, vf = k.float(), v.float()
    i_raw, lf = i_raw.float(), lf.float()
    # the stabilizer's chain depends on the gates alone: step it first,
    # then every step's gate weights at once (m, fp and ip: the reference's
    # operations element by element; C and n then take ip k as one factor)
    m_old, ms = m, []
    for t in range(T):
        m = torch.maximum(lf[:, t] + m, i_raw[:, t])
        ms.append(m)
    m_new = torch.stack(ms, 1)                                  # [B, T, H]
    m_prev = torch.cat([m_old[:, None], m_new[:, :-1]], 1)
    fresh = torch.isneginf(m_prev)                     # first step guard
    fp = torch.exp(lf + torch.where(fresh, m_new, m_prev) - m_new) * ~fresh
    ipk = torch.exp(i_raw - m_new)[..., None] * kf              # ip k
    floor = torch.exp(-m_new)
    hs = []
    for t in range(T):
        ft, qt = fp[:, t], qf[:, t, :, None, :]                 # [B, H, 1, dk]
        C = torch.addcmul(ft[..., None, None] * C, ipk[:, t, :, :, None],
                          vf[:, t, :, None, :])
        n = torch.addcmul(ipk[:, t], ft[..., None], n)
        num = (qt @ C)[..., 0, :]                                # [B, H, dv]
        den = torch.abs((qt @ n[..., None])[..., 0, 0])
        hs.append(num / torch.maximum(den, floor[:, t])[..., None])
    return torch.stack(hs, 1), (C, n, m)


def mlstm_chunkwise(q, k, v, i_raw, lf, state: Optional[State] = None,
                    chunk: int = MLSTM_CHUNK) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel stabilized mLSTM (prefill): within a chunk the
    intra-chunk decay matrix and matrix products, a loop over chunks
    carrying (C, n, m).  T must be a multiple of ``chunk``."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    nc = max(1, T // chunk)
    if nc * chunk != T:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"chunk {chunk}")
    C, n, m = state if state is not None else _fresh_cell(B, H, dk, dv,
                                                          q.device)

    def resh(x, d):                                   # -> [nc, B, H, Lc, d]
        return x.float().reshape(B, nc, chunk, H, d).permute(1, 0, 3, 2, 4)

    qc = resh(q, dk) / math.sqrt(dk)
    kc, vc = resh(k, dk), resh(v, dv)
    ic = i_raw.float().reshape(B, nc, chunk, H).permute(1, 0, 3, 2)
    fc = lf.float().reshape(B, nc, chunk, H).permute(1, 0, 3, 2)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    ninf = torch.tensor(-math.inf, device=q.device)
    hs = []
    for j in range(nc):
        qj, kj, vj, ij, fj = qc[j], kc[j], vc[j], ic[j], fc[j]
        b = torch.cumsum(fj, -1)                    # cumulative log-decay
        btot = b[..., -1]
        have_state = ~torch.isneginf(m)
        m_fin = torch.where(have_state, m, 0.0)
        # intra-chunk log weights: w[t, s] = b_t - b_s + i_s  (s <= t)
        wl = torch.where(tri, b[..., :, None] - b[..., None, :]
                         + ij[..., None, :], ninf)
        m_intra = wl.amax(-1)                                  # [B, H, Lc]
        m_inter = b + m_fin[..., None]
        m_row = torch.maximum(m_intra, torch.where(have_state[..., None],
                                                   m_inter, ninf))
        m_row = torch.where(torch.isneginf(m_row), 0.0, m_row)
        P = torch.where(tri, torch.exp(wl - m_row[..., None]), 0.0)
        sp = (qj @ kj.transpose(-1, -2)) * P                # scores * P
        num_intra = sp @ vj
        den_intra = sp.sum(-1)
        inter_w = torch.exp(m_inter - m_row) * have_state[..., None]
        num_inter = inter_w[..., None] * (qj @ C)
        den_inter = inter_w * (qj @ n[..., None])[..., 0]
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_row))
        hs.append((num_intra + num_inter) / den[..., None])
        # the state at the end of the chunk
        g = btot[..., None] - b + ij
        m_state = torch.maximum(g.amax(-1), torch.where(
            have_state, btot + m_fin, ninf))
        sw = torch.exp(g - m_state[..., None])
        carry_w = torch.exp(btot + m_fin - m_state) * have_state
        swk = sw[..., None] * kj                                # [B,H,Lc,dk]
        C = carry_w[..., None, None] * C + swk.transpose(-1, -2) @ vj
        n = carry_w[..., None] * n + swk.sum(-2)
        m = m_state
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, T, H, dv)
    return h, (C, n, m)


def init_mlstm_block(ini: Init, cfg: ArchConfig) -> None:
    D = cfg.d_model
    Din = cfg.ssm_expand * D
    H = cfg.n_heads
    dqk = Din // H // 2
    ini.mk("norm", (D,), (None,), mode="zeros")
    ini.mk("up_l", (D, Din), ("fsdp", "tp"))
    ini.mk("up_r", (D, Din), ("fsdp", "tp"))
    ini.mk("conv_w", (cfg.conv_kernel, Din), (None, "tp"), scale=0.3)
    ini.mk("wq", (Din, H * dqk), ("fsdp", "tp"))
    ini.mk("wk", (Din, H * dqk), ("fsdp", "tp"))
    ini.mk("wv", (Din, Din), ("fsdp", "tp"))
    ini.mk("w_gates", (Din, 2 * H), ("fsdp", None), scale=0.02)
    ini.mk("b_gates", (2 * H,), (None,), mode="zeros")
    ini.mk("out_norm", (Din,), (None,), mode="zeros")
    ini.mk("down", (Din, D), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(Din * 2 * cfg.n_layers))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution; x [B, T, C], w [K, C], state [B, K-1,
    C] (the last K-1 inputs; ``None``: zeros).  Returns (y [B, T, C] in
    x's dtype, new state: the last K-1 inputs, in x's dtype)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], 1)
    wx = w.to(x.dtype)
    y = xp[:, 0:T] * wx[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * wx[i]
    return y, xp[:, xp.shape[1] - (K - 1):]


def _store(state: Dict, new: Dict) -> None:
    """Write a block's new state into its cache slice, in place (leaves
    matched by key, tuples by position)."""
    for key, val in new.items():
        dst = state[key]
        if isinstance(dst, tuple):
            for d, s in zip(dst, val):
                d.copy_(s)
        else:
            dst.copy_(val)


def mlstm_block(params, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict] = None) -> torch.Tensor:
    """The mLSTM block's delta (the caller adds x).  state: {"conv" [B,
    K-1, Din], "cell": (C, n, m)}, updated in place."""
    B, T, D = x.shape
    Din = cfg.ssm_expand * D
    H = cfg.n_heads
    dqk = Din // H // 2
    w = lambda name: params[name].to(x.dtype)
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    xl = h @ w("up_l")
    xr = h @ w("up_r")
    c, conv_new = causal_conv1d(xl, params["conv_w"],
                                None if state is None else state["conv"])
    c = F.silu(c)
    q = (c @ w("wq")).reshape(B, T, H, dqk)
    k = (c @ w("wk")).reshape(B, T, H, dqk)
    v = (xl @ w("wv")).reshape(B, T, H, -1)
    gates = c @ w("w_gates") + w("b_gates")
    i_raw = gates[..., :H].float()
    lf = F.logsigmoid(gates[..., H:].float())
    cell = None if state is None else state["cell"]
    if T == 1 or T % MLSTM_CHUNK:
        hout, cell_new = mlstm_sequential(q, k, v, i_raw, lf, cell)
    else:
        hout, cell_new = mlstm_chunkwise(q, k, v, i_raw, lf, cell)
    if state is not None:
        _store(state, dict(conv=conv_new, cell=cell_new))
    hout = rms_norm(hout.reshape(B, T, Din).to(x.dtype), params["out_norm"],
                    cfg.norm_eps)
    return (hout * F.silu(xr)) @ w("down")


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SLSTM_GATES = ("z", "i", "f", "o")


def init_slstm_block(ini: Init, cfg: ArchConfig) -> None:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    ini.mk("norm", (D,), (None,), mode="zeros")
    for g in SLSTM_GATES:
        ini.mk(f"w{g}", (D, D), ("fsdp", "tp"))
        ini.mk(f"r{g}", (H, dh, dh), (None, None, None),
               scale=1.0 / math.sqrt(dh))
        ini.mk(f"b{g}", (D,), (None,), mode="zeros")
    ini.mk("out_norm", (D,), (None,), mode="zeros")
    ini.mk("down", (D, D), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(D * 2 * cfg.n_layers))
    # small FFN (factor 4/3, GeGLU) as in the xLSTM paper's sLSTM block
    dff = int(4 * D / 3 / 64) * 64 or 64
    ini.mk("ffn_gate", (D, dff), ("fsdp", "tp"))
    ini.mk("ffn_up", (D, dff), ("fsdp", "tp"))
    ini.mk("ffn_down", (dff, D), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(dff * 2 * cfg.n_layers))
    ini.mk("ffn_norm", (D,), (None,), mode="zeros")


def slstm_block(params, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict] = None) -> torch.Tensor:
    """The sLSTM block's delta (the caller adds x).  state: {"h", "c",
    "n", "m"} each [B, H, dh], updated in place; ``None`` starts m at
    -inf."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    w = lambda name: params[name].to(x.dtype)
    xin = rms_norm(x, params["norm"], cfg.norm_eps)
    # the four gates' pre-activations, step-major: [T, H, B, 4 dh]
    pre = torch.stack([(xin @ w(f"w{g}") + w(f"b{g}")).float()
                       .reshape(B, T, H, dh) for g in SLSTM_GATES], 3)
    pre = pre.permute(1, 2, 0, 3, 4).reshape(T, H, B, 4 * dh)
    # R_g stacked: [H, dh, 4 dh], one batched product a step
    R = torch.cat([params[f"r{g}"].float() for g in SLSTM_GATES], -1)
    if state is None:
        h = torch.zeros((H, B, dh), dtype=torch.float32, device=x.device)
        c, n = torch.zeros_like(h), torch.zeros_like(h)
        m = torch.full_like(h, -math.inf)
    else:
        h, c, n, m = (state[key].transpose(0, 1) for key in "hcnm")
    hs = []
    for t in range(T):
        gt = torch.baddbmm(pre[t], h, R)                   # [H, B, 4 dh]
        z = torch.tanh(gt[..., :dh])
        it = gt[..., dh:2 * dh]
        ft = F.logsigmoid(gt[..., 2 * dh:3 * dh])
        o = torch.sigmoid(gt[..., 3 * dh:])
        m_new = torch.maximum(ft + m, it)
        if t == 0:      # the guard: m is -inf in a fresh state, and only
            fresh = torch.isneginf(m)       # before the first step
            fp = torch.exp(ft + torch.where(fresh, m_new, m) - m_new) \
                * ~fresh
        else:
            fp = torch.exp(ft + m - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    if state is not None:
        _store(state, {key: t.transpose(0, 1)
                       for key, t in zip("hcnm", (h, c, n, m))})
    hout = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, T, D).to(x.dtype)
    hout = rms_norm(hout, params["out_norm"], cfg.norm_eps)
    y = x + hout @ w("down")
    # FFN sub-block (jax.nn.gelu's default: the tanh approximation)
    f = rms_norm(y, params["ffn_norm"], cfg.norm_eps)
    f = F.gelu(f @ w("ffn_gate"), approximate="tanh") * (f @ w("ffn_up"))
    y = y + f @ w("ffn_down")
    return y - x


# ---------------------------------------------------------------------------
# Mamba (selective diagonal SSM), hymba's parallel branch
# ---------------------------------------------------------------------------


def init_mamba(ini: Init, cfg: ArchConfig, prefix: str = "") -> None:
    D = cfg.d_model
    Din = cfg.ssm_expand * D
    St = cfg.ssm_state
    dt_rank = max(1, math.ceil(D / 16))
    ini.mk(prefix + "in_proj", (D, 2 * Din), ("fsdp", "tp"))
    ini.mk(prefix + "conv_w", (cfg.conv_kernel, Din), (None, "tp"), scale=0.3)
    ini.mk(prefix + "x_proj", (Din, dt_rank + 2 * St), ("tp", None),
           scale=0.02)
    ini.mk(prefix + "dt_proj", (dt_rank, Din), (None, "tp"), scale=0.1)
    ini.mk(prefix + "dt_bias", (Din,), (None,), mode="zeros")
    ini.mk(prefix + "A_log", (Din, St), ("tp", None), mode="ones")
    ini.mk(prefix + "D_skip", (Din,), (None,), mode="ones")
    ini.mk(prefix + "out_proj", (Din, D), ("tp", "fsdp"),
           scale=1.0 / math.sqrt(Din * 2 * cfg.n_layers))


def mamba_chunk(T: int) -> int:
    """The scan's chunk at T steps: the largest divisor of T up to
    ``MAMBA_CHUNK`` (the reference's rule: 128 at T = 1024, 93 at 1023)."""
    chunk = min(MAMBA_CHUNK, T)
    while T % chunk:
        chunk -= 1
    return chunk


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0),
    by log-depth doubling (Hillis-Steele) with the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``.  Returns every h_t.
    Serving overwrites a and b level by level (b then holds the result);
    under grad, where autograd keeps the slices a level reads, each level
    is a new tensor (the same combine, the same numbers)."""
    L = a.shape[1]
    in_place = not (torch.is_grad_enabled()
                    and (a.requires_grad or b.requires_grad))
    d = 1
    while d < L:        # (the dels: two level temporaries alive at most)
        tail_b = torch.addcmul(b[:, d:], a[:, d:], b[:, :L - d])
        if 2 * d < L:           # the last level needs no a
            tail_a = a[:, d:] * a[:, :L - d]
            if in_place:
                a[:, d:] = tail_a
            else:
                a = torch.cat([a[:, :d], tail_a], 1)
            del tail_a
        if in_place:
            b[:, d:] = tail_b
        else:
            b = torch.cat([b[:, :d], tail_b], 1)
        del tail_b
        d *= 2
    return b


def mamba(params, x: torch.Tensor, cfg: ArchConfig,
          state: Optional[Dict] = None, prefix: str = "") -> torch.Tensor:
    """Mamba branch x [B, T, D] -> [B, T, D].  state: {"conv" [B, K-1,
    Din], "h" [B, Din, St]}, updated in place; ``None``: zeros."""
    B, T, D = x.shape
    Din = cfg.ssm_expand * D
    St = cfg.ssm_state
    dt_rank = max(1, math.ceil(D / 16))
    w = lambda name: params[prefix + name].to(x.dtype)
    xz = x @ w("in_proj")
    xs, z = xz[..., :Din], xz[..., Din:]
    xs, conv_new = causal_conv1d(xs, params[prefix + "conv_w"],
                                 None if state is None else state["conv"])
    xs = F.silu(xs)
    proj = xs @ w("x_proj")
    dt = F.softplus(proj[..., :dt_rank] @ w("dt_proj")
                    + w("dt_bias")).float()                      # [B, T, Din]
    Bc = proj[..., dt_rank:dt_rank + St].float()                 # [B, T, St]
    Cc = proj[..., dt_rank + St:].float()
    A = -torch.exp(params[prefix + "A_log"].float())             # [Din, St]
    xs32 = xs.float()
    h = (torch.zeros((B, Din, St), dtype=torch.float32, device=x.device)
         if state is None else state["h"])
    if T == 1:
        a = torch.exp(dt[:, 0, :, None] * A)
        bx = (dt[:, 0] * xs32[:, 0])[..., None] * Bc[:, 0, None, :]
        h = a * h + bx
        y = (h @ Cc[:, 0, :, None])[..., 0][:, None]              # [B, 1, Din]
    else:
        # chunked parallel scan: the [B, chunk, Din, St] tensors are built
        # one chunk at a time, never for the whole T (~210 MB a tensor at
        # hymba's width and chunk 128, B = 8)
        chunk = mamba_chunk(T)
        ys = []
        for s in range(0, T, chunk):
            dtj, xsj = dt[:, s:s + chunk], xs32[:, s:s + chunk]
            aj = torch.exp(dtj[..., None] * A)
            bj = (dtj * xsj)[..., None] * Bc[:, s:s + chunk, None, :]
            bj[:, 0] += aj[:, 0] * h
            h_all = _doubling_scan(aj, bj)
            del aj
            ys.append((h_all @ Cc[:, s:s + chunk, :, None])[..., 0])
            h = h_all[:, -1].clone()
            del h_all, bj
        y = torch.cat(ys, 1)
    if state is not None:
        _store(state, dict(conv=conv_new, h=h))
    y = y + params[prefix + "D_skip"].float() * xs32
    y = y.to(x.dtype) * F.silu(z)
    return y @ w("out_proj")
