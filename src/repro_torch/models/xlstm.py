"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM
[arXiv:2405.04517].

Port of ``repro.models.xlstm``:

- **mLSTM** (matrix memory): C_t = f_t C_{t-1} + i_t v_t k_tᵀ,
  h_t = (q_t·C_t) / max(|q_t·n_t|, 1), computed chunkwise like the SSD
  scan (decay matrices from cumulative log-f gates, state carried across
  chunks by a loop over chunks); gates are log-sigmoid-stabilized.
- **sLSTM** (scalar memory, inherently sequential): a loop over positions
  with block-diagonal (per-head) recurrent weights and the paper's
  m-state exponential stabilization.

The xLSTM-1.3b config uses d_ff = 0: mLSTM blocks pre-up-project 2×,
sLSTM blocks carry a 4/3 gated MLP.

The reference's ``shard`` annotations (hd_v-sharded v, z and down
projection) sit where it has them; the port's ``shard`` records the
layout under an active mesh and returns its input unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.models.layers import dense_init, einsum32, einsum_lp, normal, zeros


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def mlstm_init(gen, device, cfg, lead: tuple = ()) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    d_inner = 2 * d
    hd = d_inner // nh
    return {
        "up_x": dense_init(gen, device, d, d_inner, lead=lead),
        "up_z": dense_init(gen, device, d, (nh, hd), lead=lead),
        "wq": dense_init(gen, device, d_inner, (nh, hd), lead=lead),
        "wk": dense_init(gen, device, d_inner, (nh, hd), lead=lead),
        "wv": dense_init(gen, device, d_inner, (nh, hd), lead=lead),
        "wi": dense_init(gen, device, d_inner, nh, scale=0.01, lead=lead),
        "wf": dense_init(gen, device, d_inner, nh, scale=0.01, lead=lead),
        "bf": zeros(device, (nh,), lead).fill_(3.0),  # forget-gate bias → long memory at init
        "out_norm": zeros(device, (nh, hd), lead),     # per-head norm
        "down_proj": normal(gen, device, (*lead, nh, hd, d)).div_(d_inner ** 0.5),
    }


def mlstm_chunk_scan(q, k, v, logf, logi, chunk: int, state=None):
    """Chunkwise mLSTM.

    q,k,v: [B,S,nh,hd]; logf,logi: [B,S,nh] (log-sigmoid forget, log input).
    Returns (h [B,S,nh,hd], (C [B,nh,hd,hd], n [B,nh,hd])).
    """
    B, S, nh, hd = q.shape
    L = min(chunk, S)
    assert S % L == 0
    scale = hd ** -0.5
    dev = q.device
    if state is None:
        C = torch.zeros((B, nh, hd, v.shape[-1]), dtype=torch.float32, device=dev)
        n = torch.zeros((B, nh, hd), dtype=torch.float32, device=dev)
    else:
        C, n = state
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None, :, :, None]
    hs = []
    for c in range(S // L):
        qk, kk, vk, fk, ik = (t[:, c * L:(c + 1) * L] for t in (q, k, v, logf, logi))
        cum = torch.cumsum(fk, dim=1)                         # [B,L,nh]
        # stabilized intra-chunk weights: w[t,s] = exp(cum_t - cum_s + i_s - m_t)
        logw = cum[:, :, None, :] - cum[:, None, :, :] + ik[:, None, :, :]  # [B,t,s,nh]
        logw = torch.where(tri, logw, -torch.inf)
        m_intra = logw.amax(dim=2)                            # [B,t,nh]
        # maximum, not clamp: at a tie its gradient splits, as jnp.maximum's does
        m = torch.maximum(torch.maximum(m_intra, cum), m_intra.new_zeros(()))
        w = torch.exp(logw - m[:, :, None, :])                # [B,t,s,nh]
        scores = torch.einsum("bthd,bshd->btsh", qk, kk) * scale
        num_intra = torch.einsum("btsh,btsh,bshd->bthd", scores, w, vk)
        n_intra = torch.einsum("btsh,bshd->bthd", w, kk)      # running key sum
        den_intra = torch.einsum("bthd,bthd->bth", qk, n_intra) * scale
        state_w = torch.exp(cum - m)                          # [B,L,nh]
        num_state = torch.einsum("bthd,bhde->bthe", qk * state_w[..., None], C) * scale
        den_state = torch.einsum("bthd,bhd->bth", qk * state_w[..., None], n) * scale
        h = (num_intra + num_state) / torch.maximum(
            torch.abs(den_intra + den_state), torch.exp(-m) + 1e-6
        )[..., None]
        # state update (unnormalized, log-stabilized at chunk granularity)
        tot = cum[:, -1]                                      # [B,nh]
        rel = torch.exp(tot[:, None] - cum + ik)              # [B,L,nh]
        C = C * torch.exp(tot)[:, :, None, None] + torch.einsum(
            "blhd,blhe->bhde", kk * rel[..., None], vk
        )
        n = n * torch.exp(tot)[:, :, None] + torch.einsum("blhd,blh->bhd", kk, rel)
        hs.append(h.to(q.dtype))
    return torch.cat(hs, dim=1), (C, n)


def mlstm_inputs(p, x, dtype):
    """The mLSTM's projections of x [B,S,D]: ``(z, q, k, v, log i, log f)``
    (z and v [B,S,nh,hd_v] on the columns of ``up_z`` / ``wv`` given)."""
    xi = einsum_lp("bsd,de->bse", x, shard(p["up_x"], "embed", None), dtype)
    z = einsum_lp("bsd,dhk->bshk", x, shard(p["up_z"], "embed", None, "mlp"), dtype)
    q = einsum32("bse,ehd->bshd", xi, p["wq"], dtype=dtype)
    k = einsum32("bse,ehd->bshd", xi, p["wk"], dtype=dtype)
    v = shard(einsum32("bse,ehd->bshd", xi, p["wv"], dtype=dtype), "batch", "seq", None, "mlp_act")
    logi = einsum32("bse,eh->bsh", xi, p["wi"], dtype=dtype)
    logf = F.logsigmoid(einsum32("bse,eh->bsh", xi, p["wf"], dtype=dtype) + p["bf"])
    return z, q, k, v, logi, logf


def mlstm_output(p, h, z, var, dtype):
    """The per-head norm (xLSTM's MultiHeadLayerNorm) of h [B,S,nh,hd] by
    its mean square ``var`` [B,S,nh], gated by z, down-projected."""
    hn = (h.float() * torch.rsqrt(var[..., None] + 1e-6) * (1.0 + p["out_norm"])).to(h.dtype)
    hn = hn * F.silu(z.float()).to(dtype)
    return einsum_lp("bshk,hkd->bsd", hn, shard(p["down_proj"], None, "mlp", "embed"), dtype)


def mlstm_apply(p, x, cfg, dtype, chunk: int = 256, state=None):
    z, q, k, v, logi, logf = mlstm_inputs(p, x, dtype)
    h, new_state = mlstm_chunk_scan(q, k, v, logf, logi, chunk, state)
    return mlstm_output(p, h, z, torch.square(h.float()).mean(-1), dtype), new_state


def mlstm_init_state(cfg, batch: int, device):
    nh = cfg.n_heads
    hd = 2 * cfg.d_model // nh
    return (
        torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
    )


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_init(gen, device, cfg, lead: tuple = ()) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    return {
        "w_gates": dense_init(gen, device, d, (4, nh, hd), lead=lead),     # i f z o from x
        "r_gates": normal(gen, device, (*lead, 4, nh, hd, hd)).div_(hd**0.5),  # block-diag recurrents
        "b_gates": zeros(device, (4, nh, hd), lead),
        "up1": dense_init(gen, device, d, (4 * d) // 3, lead=lead),
        "up2": dense_init(gen, device, d, (4 * d) // 3, lead=lead),
        "down": dense_init(gen, device, (4 * d) // 3, d, lead=lead),
    }


def slstm_cells(gates_x, R, b, state, out_dtype):
    """The sLSTM recurrence over the gates' input part gates_x
    [B,S,4,nh,hd] with block-diagonal recurrent weights R [4,nh,hd,hd] and
    biases b [4,nh,hd]: ``(y [B,S,nh*hd], (c, n, h, m))``, each state
    [B,nh,hd] (``state`` None: the initial one)."""
    B, S, _, nh, hd = gates_x.shape
    if state is None:
        zero = torch.zeros((B, nh, hd), dtype=torch.float32, device=gates_x.device)
        state = (zero, zero, zero, zero - 10.0)
    c, n, h, m = state
    hs = []
    for t in range(S):
        gx = gates_x[:, t]
        rec = torch.einsum("bhe,ghef->bghf", h, R)            # [B,4,nh,hd]
        it, ft, zt, ot = [gx[:, g] + rec[:, g] + b[g] for g in range(4)]
        # exponential-gate stabilization (xLSTM eq. 15-17)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * torch.tanh(zt)
        n = f_s * n + i_s
        h = torch.sigmoid(ot) * c / torch.maximum(n, n.new_ones(()))  # n is 1.0 at t=0: a tie
        m = m_new
        hs.append(h.to(out_dtype))
    return torch.stack(hs, dim=1).reshape(B, S, nh * hd), (c, n, h, m)


def slstm_mlp(p, y, dtype):
    """The sLSTM block's post-up gated MLP (4/3 factor); jax.nn.gelu is the
    tanh approximation."""
    g = einsum32("bsd,de->bse", y, p["up1"], dtype=dtype)
    u = einsum32("bsd,de->bse", y, p["up2"], dtype=dtype)
    hm = (F.gelu(g, approximate="tanh") * u).to(dtype)
    return einsum_lp("bse,ed->bsd", hm, p["down"], dtype)


def slstm_apply(p, x, cfg, dtype, state=None):
    """x: [B,S,D] → (y, state).  state = (c, n, h, m) each [B,nh,hd]."""
    gates_x = einsum32("bsd,dghe->bsghe", x, p["w_gates"], dtype=dtype)  # [B,S,4,nh,hd]
    y, state = slstm_cells(gates_x, p["r_gates"], p["b_gates"], state, x.dtype)
    return slstm_mlp(p, y, dtype), state


def slstm_init_state(cfg, batch: int, device):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    def z():
        return torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)

    return (z(), z(), z(), z() - 10.0)  # distinct tensors: decode writes them in place
