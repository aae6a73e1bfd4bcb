"""Mamba-2 (SSD) block (mirrors :mod:`repro.models.ssm`): the chunked
state-space-duality form for the full sequence and the prefill, the
constant-size recurrence for decode.

The chunked form (chunk length Q): an intra-chunk quadratic term (C Bᵀ
masked by the decay matrix L) plus inter-chunk state passing (a loop over
the chunks in place of the reference's ``lax.scan``). ``apply_mamba2``
routes a full sequence with no incoming state through the hand-written
kernel (:func:`repro_torch.kernels.mamba2_scan.mamba2_scan`) under
``impl="mamba_kernel"``, exactly where the reference takes its Pallas
kernel; everything else runs :func:`ssd_chunked`.

Decode is the O(1) recurrence:  h <- exp(dt*A) h + dt * B ⊗ x,  y = C·h + D x.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan import mamba2_scan
from repro_torch.models.common import Builder, einsum, rms_norm


def init_mamba2(gen: torch.Generator, d_model: int, d_state: int,
                head_dim: int = 64, expand: int = 2, d_conv: int = 4,
                dtype=torch.float32, device=None) -> Tuple[dict, dict]:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    b = Builder(gen, dtype, device)
    # fused input projection: [z | x | B | C | dt]
    d_proj = 2 * d_inner + 2 * d_state + n_heads
    b.dense("w_in", (d_model, d_proj), ("embed", "mlp"))
    b.dense("conv_w", (d_conv, d_inner + 2 * d_state), (None, "mlp"))
    b.dense("conv_b", (d_inner + 2 * d_state,), ("mlp",), zero=True)
    b.dense("a_log", (n_heads,), ("heads",), scale=1.0)
    b.dense("dt_bias", (n_heads,), ("heads",), zero=True)
    b.dense("d_skip", (n_heads,), ("heads",), scale=1.0)
    b.ones("norm", (d_inner,), ("mlp",))
    b.dense("w_out", (d_inner, d_model), ("mlp", "embed"))
    return b.done()


def _split_proj(proj, d_inner, d_state, n_heads):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * d_state]
    dt = proj[..., -n_heads:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. xbc: [B, S, C]; w: [K, C].
    Returns (out [B,S,C], new_state [B,K-1,C])."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                       # [B, S+K-1, C]
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return F.silu(out + bias), new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """SSD scan. x: [B,S,H,P]; dt: [B,S,H] (>0); A: [H] (<0);
    Bm, Cm: [B,S,N]. Returns (y [B,S,H,P], h_last [B,H,P,N]), f32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    # the state math runs in f32: decay exponentials underflow in bf16
    x, dt, Bm, Cm = (a.float() for a in (x, dt, Bm, Cm))
    A = A.float()
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        zf = lambda a: F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
        x, dt, Bm, Cm = zf(x), zf(dt), zf(Bm), zf(Cm)
    # into chunks: [B, nc, Q, ...]
    rs = lambda a: a.reshape(Bsz, nc, chunk, *a.shape[2:])
    xc, dtc, Bc, Cc = rs(x), rs(dt), rs(Bm), rs(Cm)

    dA = dtc * A[None, None, None, :]                          # [B,nc,Q,H] (<=0)
    cum = torch.cumsum(dA, dim=2)                              # within-chunk
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) * dt_j  for i >= j. The
    # exponent is masked BEFORE exp (double where): for j > i the difference
    # is positive and can overflow to inf.
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    zero = torch.zeros((), dtype=diff.dtype, device=x.device)
    Li = torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # [B,nc,Q,Q]
    M = scores[..., None] * Li * dtc[:, :, None, :, :]         # [B,nc,i,j,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk-boundary states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,nc,Q,H]
    state_c = torch.einsum("bcjn,bcjh,bcjhp->bchpn",
                           Bc, decay_to_end * dtc, xc)         # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B,nc,H]

    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # [B,nc,H,P,N]

    # inter-chunk contribution: y_i += C_i · (exp(cum_i) * h_prev)
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cum),
                           h_prev)
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, H, P)
    return y[:, :S], h


def apply_mamba2(p: dict, x: torch.Tensor, *, d_state: int,
                 head_dim: int = 64, chunk: int = 128,
                 state: Optional[dict] = None, impl: str = "xla"):
    """x: [B, S, D]. ``state`` (cached mode): {"conv": [B,K-1,C],
    "ssm": [B,H,P,N]}. Returns (y, new_state); the new state's ``ssm`` is
    f32."""
    B, S, D = x.shape
    d_inner = p["w_out"].shape[0]
    n_heads = p["a_log"].shape[0]
    P = head_dim

    proj = einsum("bsd,dp->bsp", x, p["w_in"])
    z, xbc, dt = _split_proj(proj, d_inner, d_state, n_heads)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xi = xbc[..., :d_inner].reshape(B, S, n_heads, P)
    Bm = xbc[..., d_inner:d_inner + d_state]
    Cm = xbc[..., d_inner + d_state:]
    dt = F.softplus(dt + p["dt_bias"][None, None])             # [B,S,H]
    A = -torch.exp(p["a_log"].float())                         # [H] < 0

    if S > 1:
        h0 = None if state is None else state["ssm"]
        if impl == "mamba_kernel" and h0 is None:
            # the kernel reads packed [B, S, H, P] / [B, S, N] rows
            y, h_last = mamba2_scan(xi.contiguous(), dt.contiguous(), A,
                                    Bm.contiguous(), Cm.contiguous(),
                                    chunk=chunk)
        else:
            y, h_last = ssd_chunked(xi, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    else:
        # single-token recurrent step (decode)
        h = (torch.zeros((B, n_heads, P, d_state), dtype=torch.float32,
                         device=x.device)
             if state is None else state["ssm"].float())
        ys = []
        for t in range(S):
            dtt = dt[:, t].float()
            dec = torch.exp(dtt * A[None, :])                  # [B,H]
            h = h * dec[:, :, None, None] + torch.einsum(
                "bhp,bn,bh->bhpn", xi[:, t].float(), Bm[:, t].float(), dtt)
            ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].float()))
        y = torch.stack(ys, dim=1)
        h_last = h

    y = y.to(x.dtype) + xi * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = einsum("bsi,id->bsd", y, p["w_out"]).to(x.dtype)
    return out, {"conv": new_conv, "ssm": h_last.float()}
