"""Mamba block (jamba's SSM layer) in the chunked SSD formulation.

Port of ``repro.models.mamba``: per-head scalar decay, intra-chunk
attention-like L×L products, and the inter-chunk state carried by a loop
over chunks (the reference's ``lax.scan``).  The causal conv reads
``[t-3, t]`` and the scan carries a [heads, N, P] state, so decode is the
same function over one token with the carried (conv, h) state.

The reference's ``shard`` annotations of the projections sit where it has
them; the port's ``shard`` records the layout under an active mesh and
returns the weight unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.models.layers import dense_init, einsum32, einsum_lp, normal, zeros

HEAD_P = 64  # channels per SSD head


def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // HEAD_P
    return d_inner, n_heads


def mamba_init(gen, device, cfg, lead: tuple = ()) -> dict:
    d = cfg.d_model
    d_inner, nh = mamba_dims(cfg)
    N = cfg.ssm_state_dim

    def const(t):
        return t.to(device).expand(*lead, *t.shape).clone()

    return {
        "in_proj": dense_init(gen, device, d, 2 * d_inner, lead=lead),     # x and gate z
        "conv_w": normal(gen, device, (*lead, cfg.ssm_conv_width, d_inner)).mul_(0.2),
        "conv_b": zeros(device, (d_inner,), lead),
        "dt_proj": dense_init(gen, device, d, nh, lead=lead),
        "dt_bias": const(torch.log(torch.expm1(torch.full((nh,), 0.01)))),  # softplus⁻¹
        "B_proj": dense_init(gen, device, d, N, lead=lead),
        "C_proj": dense_init(gen, device, d, N, lead=lead),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": const(torch.ones((nh,))),
        "out_proj": dense_init(gen, device, d_inner, d, lead=lead),
    }


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq.  x: [B,S,C]; w: [K,C].

    ``state`` ([B,K-1,C], previous inputs) enables decode/chunk stitching;
    returns (y, new_state).
    """
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xx = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xx[:, i: i + x.shape[1], :] * w[i][None, None, :] for i in range(K))
    new_state = xx[:, -(K - 1):, :] if K > 1 else state
    return y + b[None, None, :], new_state


def _segsum_decay(a):
    """a: [..., L] per-step log-decays → [..., L, L] lower-tri decay matrix
    exp(cum[t]-cum[s]) for s<=t, 0 above the diagonal."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # [t, s]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(tri, torch.exp(diff), 0.0)


def mamba_ssd_scan(x, dt, B, C, A, chunk: int, h0=None):
    """Chunked selective scan.

    x:  [Bt, S, nh, P]   inputs per head
    dt: [Bt, S, nh]      positive step sizes
    B:  [Bt, S, N], C: [Bt, S, N]
    A:  [nh]             negative per-head decay rates
    Returns (y [Bt,S,nh,P], h_final [Bt,nh,N,P]).
    """
    Bt, S, nh, P = x.shape
    N = B.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    h = h0 if h0 is not None else torch.zeros((Bt, nh, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // L):
        xk, dtk, Bk, Ck = (t[:, c * L:(c + 1) * L] for t in (x, dt, B, C))
        a = dtk * A[None, None, :]                        # [Bt,L,nh] (<=0)
        decay = _segsum_decay(a.transpose(1, 2))          # [Bt,nh,L,L]
        cum = torch.cumsum(a, dim=1)                      # [Bt,L,nh]
        # intra-chunk: scores[t,s] = (C_t·B_s) decay[t,s] dt_s
        cb = torch.einsum("btn,bsn->bts", Ck, Bk)         # [Bt,L,L]
        scores = cb[:, None] * decay * dtk.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhts,bshp->bthp", scores, xk)
        # contribution of the incoming state
        y_state = torch.einsum("btn,bhnp->bthp", Ck, h) * torch.exp(cum)[..., None]
        # state update
        chunk_decay = torch.exp(cum[:, -1])               # [Bt,nh]
        rel = torch.exp(cum[:, -1][:, None] - cum)        # [Bt,L,nh]
        dB = (dtk * rel)[..., None] * Bk[:, :, None, :]   # [Bt,L,nh,N]
        h = h * chunk_decay[..., None, None] + torch.einsum("blhn,blhp->bhnp", dB, xk)
        ys.append((y_intra + y_state).to(x.dtype))
    return torch.cat(ys, dim=1), h


def mamba_channels(p, x, xr, z, dtype, chunk: int = 256, conv_state=None, h0=None,
                   h_first: int = 0, n_h: Optional[int] = None):
    """The conv, the scan, the gate and ``out_proj`` over channels xr / z
    [B,S,n_ch] of the heads ``h_first`` .. ``h_first + n_h`` (all by
    default), ``n_ch // n_h`` channels a head; ``p``'s ``conv_w``,
    ``conv_b`` and ``out_proj`` hold those channels, its per-head leaves
    every head.  Returns ``(y [B,S,D], new conv state, h [B,n_h,N,P])``."""
    B_, S, n_ch = xr.shape
    n_h = p["A_log"].shape[0] if n_h is None else n_h
    xr, new_conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    xr = F.silu(xr)
    # jax.nn.softplus is logaddexp(x, 0), with no threshold
    dt_in = einsum32("bsd,dh->bsh", x, p["dt_proj"], dtype=dtype) + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))[..., h_first:h_first + n_h]
    Bm = einsum32("bsd,dn->bsn", x, p["B_proj"], dtype=dtype)
    Cm = einsum32("bsd,dn->bsn", x, p["C_proj"], dtype=dtype)
    A = -torch.exp(p["A_log"][h_first:h_first + n_h])
    xh = xr.reshape(B_, S, n_h, n_ch // n_h)
    y, h = mamba_ssd_scan(xh, dt, Bm, Cm, A, chunk=chunk, h0=h0)
    y = y + xh * p["D"][h_first:h_first + n_h][None, None, :, None]
    y = y.reshape(B_, S, n_ch) * F.silu(z)
    out = einsum_lp("bse,ed->bsd", y, shard(p["out_proj"], "mlp", "embed"), dtype)
    return out, new_conv_state.to(dtype), h


def mamba_apply(p, x, cfg, dtype, chunk: int = 256, state=None):
    """x: [B,S,D] → (y [B,S,D], new_state) — train/prefill path.

    ``state``: optional (conv_state [B,K-1,d_inner], h [B,nh,N,P]).
    """
    xz = einsum32("bsd,de->bse", x, shard(p["in_proj"], "embed", "mlp"), dtype=dtype)
    xr, z = xz.chunk(2, dim=-1)
    conv_state, h0 = state if state is not None else (None, None)
    out, conv, h = mamba_channels(p, x, xr, z, dtype, chunk, conv_state, h0)
    return out, (conv, h)


def mamba_decode_step(p, x, cfg, dtype, state):
    """Single-token decode: x [B,1,D], state (conv [B,K-1,di], h [B,nh,N,P])."""
    return mamba_apply(p, x, cfg, dtype, chunk=1, state=state)


def mamba_init_state(cfg, batch: int, dtype, device):
    d_inner, nh = mamba_dims(cfg)
    return (
        torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner), dtype=dtype, device=device),
        torch.zeros((batch, nh, cfg.ssm_state_dim, HEAD_P), dtype=torch.float32, device=device),
    )
