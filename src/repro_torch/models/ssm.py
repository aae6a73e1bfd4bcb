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
from repro_torch.parallel import sharding as Sh


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


def _local_columns(x, w_in, conv_w, conv_b, conv_state, mg, heads, P,
                   d_state):
    """The split mixer's input side from the whole ``w_in`` and conv leaves
    (the same on every rank of ``mg``): this rank's heads' columns of ``z``,
    ``x`` and ``dt`` and every ``B``/``C`` column, projected, and the conv
    on those channels; the whole new conv state from the last ``K - 1``
    tokens' inputs of every channel. Returns ``(z, xi [B, S, h, P], Bm,
    Cm, dt, conv_state)``."""
    B, S, _ = x.shape
    d_inner = mg.size * (heads.stop - heads.start) * P
    own = torch.arange(heads.start * P, heads.stop * P, device=x.device)
    bc = torch.arange(2 * d_inner, 2 * d_inner + 2 * d_state,
                      device=x.device)
    cols = torch.cat([own, d_inner + own, bc, 2 * d_inner + 2 * d_state
                      + torch.arange(heads.start, heads.stop,
                                     device=x.device)])
    chans = torch.cat([own, bc - d_inner])
    # each rank uses its own columns: the gradients are summed over 'model'
    w, cw = Sh.to_model(w_in, mg), Sh.to_model(conv_w, mg)
    proj = einsum("bsd,dp->bsp", Sh.to_model(x, mg), w[:, cols])
    n = own.numel()
    xbc, _ = _causal_conv(proj[..., n:2 * n + 2 * d_state], cw[:, chans],
                          Sh.to_model(conv_b, mg)[chans],
                          None if conv_state is None
                          else conv_state[..., chans])
    K = conv_w.shape[0]
    tail = einsum("bsd,dp->bsp", x[:, -min(S, K - 1):],
                  w_in[:, d_inner:2 * d_inner + 2 * d_state])
    pad = (torch.zeros((B, K - 1, tail.shape[2]), dtype=tail.dtype,
                       device=x.device) if conv_state is None
           else conv_state.to(tail.dtype))
    new_conv = torch.cat([pad, tail], dim=1)[:, -(K - 1):]
    return (proj[..., :n], xbc[..., :n].reshape(B, S, n // P, P),
            xbc[..., n:n + d_state], xbc[..., n + d_state:],
            proj[..., 2 * n + 2 * d_state:], new_conv)


def apply_mamba2(p: dict, x: torch.Tensor, *, d_state: int,
                 head_dim: int = 64, chunk: int = 128,
                 state: Optional[dict] = None, impl: str = "xla",
                 n_heads: Optional[int] = None):
    """x: [B, S, D]. ``state`` (cached mode): {"conv": [B,K-1,C],
    "ssm": [B,H,P,N]}; an entry ``None`` is a zero state (a fresh cache's:
    a full sequence with no SSM state takes the kernel under
    ``impl="mamba_kernel"``). Returns (y, new_state); the new state's
    ``ssm`` is f32.

    ``n_heads``: the global head count (default: the weights'). Where
    ``a_log`` holds this rank's 'model' block of the heads
    (:func:`~repro_torch.parallel.sharding.layer_group`) the mixer runs on
    those heads. The reference splits ``w_in``'s fused ``[z | x | B | C |
    dt]`` columns and ``conv_w``/``conv_b``'s ``[x | B | C]`` channels in
    contiguous blocks that are not head blocks, so a rank's block does not
    hold its heads' columns. Whichever moves fewer bytes is all-gathered.
    At decode and wherever ``B S <= d_model``, the projection computed on
    this rank's block of columns (``[B, S, d_proj]``); the conv then runs
    on every channel. To train and at long prefills, ``w_in``'s block
    (``[d_model, d_proj]``); this rank then projects only its columns and
    convolves only its channels (:func:`_local_columns`). The two small
    conv leaves are all-gathered in one call. Either way every rank writes
    the same whole conv state.
    Then this rank's heads take their columns of ``z``, ``x`` and ``dt``
    and the whole ``B``/``C`` (``mamba2_scan`` or the recurrence on ``H/m``
    heads, the SSM state their block), the gated norm sums its squares
    over 'model', and ``w_out``, whose ``mlp`` rows are the heads' blocks,
    is row-parallel. A leaf the reference keeps whole is used whole."""
    B, S, D = x.shape
    P = head_dim
    h_loc = p["a_log"].shape[0]
    H = n_heads or h_loc
    d_inner = H * P
    mg = Sh.layer_group(h_loc, H)
    pg = Sh.layer_group(p["w_in"].shape[1], 2 * d_inner + 2 * d_state + H)
    cg = Sh.layer_group(p["conv_w"].shape[1], d_inner + 2 * d_state)

    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if cg is not None:
        # the two small conv leaves in one gather
        wb = Sh.gather_model(torch.cat([conv_w, conv_b[None]]), cg, -1)
        conv_w, conv_b = wb[:-1], wb[-1]
    conv_state = None if state is None else state["conv"]
    heads = slice(None) if mg is None else mg.block(H)
    # more tokens than d_model: w_in's block is the smaller gather
    wide = pg is not None and B * S > D
    if wide and mg is not None:
        z, xi, Bm, Cm, dt, new_conv = _local_columns(
            x, Sh.gather_model(p["w_in"], pg, -1), conv_w, conv_b,
            conv_state, mg, heads, P, d_state)
    else:
        if wide:
            proj = einsum("bsd,dp->bsp", x, Sh.gather_model(p["w_in"], pg,
                                                             -1))
        else:
            proj = Sh.gather_model(einsum("bsd,dp->bsp", Sh.to_model(x, pg),
                                          p["w_in"]), pg, -1)
        z, xbc, dt = _split_proj(proj, d_inner, d_state, H)
        xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
        if mg is not None:
            # the same on every rank so far; this rank's heads from here on
            z, xbc, dt = (Sh.to_model(t, mg) for t in (z, xbc, dt))
            z = z[..., heads.start * P:heads.stop * P]
        xi = xbc[..., :d_inner].reshape(B, S, H, P)[:, :, heads]
        Bm = xbc[..., d_inner:d_inner + d_state]
        Cm = xbc[..., d_inner + d_state:]
        dt = dt[..., heads]
    dt = F.softplus(dt + p["dt_bias"][None, None])             # [B,S,h]
    A = -torch.exp(p["a_log"].float())                         # [h] < 0

    h0 = None if state is None else state["ssm"]
    if S > 1:
        if impl == "mamba_kernel" and h0 is None:
            # the kernel reads packed [B, S, H, P] / [B, S, N] rows
            y, h_last = mamba2_scan(xi.contiguous(), dt.contiguous(), A,
                                    Bm.contiguous(), Cm.contiguous(),
                                    chunk=chunk)
        else:
            y, h_last = ssd_chunked(xi, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    else:
        # single-token recurrent step (decode)
        h = (torch.zeros((B, h_loc, P, d_state), dtype=torch.float32,
                         device=x.device)
             if h0 is None else h0.float())
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
    y = y.reshape(B, S, h_loc * P) * F.silu(z)
    og = Sh.layer_group(p["w_out"].shape[0], d_inner)
    if mg is not None:
        # this rank's heads are its block of the norm's and w_out's rows
        y = rms_norm(y, p["norm"], mg=mg, width=d_inner)
    else:
        y = rms_norm(y, Sh.gather_model(
            p["norm"], Sh.layer_group(p["norm"].shape[0], d_inner), -1))
        if og is not None:
            y = Sh.to_model(y, og)[..., og.block(d_inner)]
    out = einsum("bsi,id->bsd", y, p["w_out"]).to(x.dtype)
    return Sh.from_model(out, og), {"conv": new_conv, "ssm": h_last.float()}
