"""xLSTM blocks (mirrors :mod:`repro.models.xlstm`): the mLSTM (matrix
memory, exponential gating) and the sLSTM (scalar memory, recurrent
weights), interleaved 1:1 in the xLSTM-125M configuration.

The mLSTM runs its full sequence with no incoming state in the chunkwise
form: within a chunk of Q tokens the stabilised quadratic (gate-matrix)
form, between chunks the matrix state ``(C, n, m)`` passed on. With a state
(a prefill or a decode) it runs the step recurrence over every token, as
the reference does. The sLSTM has no parallel form: every call runs its
recurrence token by token. A Python loop takes the place of the
reference's ``lax.scan`` over chunks and tokens; each step dispatches the
same operations on the same shapes, so a step's cost is independent of
where it falls in the sequence (:mod:`repro_torch.launch.dryrun` relies on
it).

Dtypes follow the reference: the chunkwise form works in f32 and casts its
final ``C``, ``n`` to the input's dtype; the step recurrence keeps ``C``,
``n`` in the input's dtype (the gates are cast to it before they multiply)
and ``m`` in f32; the sLSTM's state is f32 throughout.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Builder, einsum, rms_norm
from repro_torch.parallel import sharding as Sh

_NEG = -1e30     # the stabiliser's start: no token seen yet


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int, dtype,
               device=None) -> Tuple[dict, dict]:
    hd = d_model // n_heads
    b = Builder(gen, dtype, device)
    b.dense("wq", (d_model, n_heads, hd), ("embed", "heads", "head_dim"))
    b.dense("wk", (d_model, n_heads, hd), ("embed", "heads", "head_dim"))
    b.dense("wv", (d_model, n_heads, hd), ("embed", "heads", "head_dim"))
    b.dense("wi", (d_model, n_heads), ("embed", "heads"))
    b.dense("wf", (d_model, n_heads), ("embed", "heads"))
    b.dense("bi", (n_heads,), ("heads",), zero=True)
    b.dense("bf", (n_heads,), ("heads",), scale=1.0)
    b.dense("wo_gate", (d_model, d_model), ("embed", "embed"))
    b.dense("wo", (n_heads, hd, d_model), ("heads", "head_dim", "embed"))
    b.ones("norm", (d_model,), ("embed",))
    return b.done()


def mlstm_chunk(S: int, q_chunk: int = -1) -> int:
    """The chunk length of the chunkwise form at sequence length ``S``:
    ``q_chunk < 0`` means ``S`` up to 512 tokens and 128 beyond; ``0``, or
    a length that does not divide ``S``, means ``S``."""
    if q_chunk < 0:
        q_chunk = S if S <= 512 else 128
    if q_chunk == 0 or S % q_chunk != 0:
        q_chunk = S
    return q_chunk


def _mlstm_chunkwise(q, k, v, logi, logf, q_chunk: int):
    """The chunkwise form in f32: ``(h [B, S, H, hd] f32, (C, n, m))``."""
    B, S, H, hd = q.shape
    Q = mlstm_chunk(S, q_chunk)
    dev = q.device
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m0 = torch.full((B, H), _NEG, dtype=torch.float32, device=dev)
    hs = []
    # split, not sliced per chunk: the backward joins the chunks' gradients
    # once, where a slice's backward writes a zero tensor of the whole
    chunks = zip(*(a.split(Q, dim=1) for a in (q, k, v, logi, logf)))
    for qc, kc, vc, lic, lfc in chunks:
        qc, kc, vc = qc.float(), kc.float(), vc.float()      # [B, Q, H, hd]
        Fc = torch.cumsum(lfc, dim=1)
        a = m0[:, None, :] + Fc                               # inter scale
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + lic[:, None, :, :]
        D = torch.where(tri[None, :, :, None], D, -math.inf)  # [B, Q, Q, H]
        m_t = torch.maximum(a, D.amax(dim=2))                 # [B, Q, H]
        W = torch.exp(D - m_t[:, :, None, :])
        inter = torch.exp(a - m_t)
        scores = torch.einsum("bihk,bjhk->bijh", qc, kc)
        numer = torch.einsum("bijh,bjhk->bihk", W * scores, vc) \
            + inter[..., None] * torch.einsum("bhkv,bihk->bihv", C0, qc)
        dsum = torch.einsum("bijh,bijh->bih", W, scores) \
            + inter * torch.einsum("bhk,bihk->bih", n0, qc)
        denom = torch.maximum(dsum.abs(), torch.exp(-m_t))
        hs.append(numer / denom[..., None])
        # the state handed to the next chunk
        g = Fc[:, -1, :]                                      # [B, H]
        w_end = g[:, None, :] - Fc + lic                      # [B, Q, H]
        m1 = torch.maximum(m0 + g, w_end.amax(dim=1))
        sc = torch.exp(w_end - m1[:, None, :])
        decay = torch.exp(m0 + g - m1)
        C0 = decay[:, :, None, None] * C0 + torch.einsum(
            "bjhk,bjhv,bjh->bhkv", kc, vc, sc)
        n0 = decay[:, :, None] * n0 + torch.einsum("bjhk,bjh->bhk", kc, sc)
        m0 = m1
    return torch.cat(hs, dim=1), (C0, n0, m0)


def _mlstm_steps(q, k, v, logi, logf, C, n, mm):
    """The step recurrence over every token: ``(h [B, S, H, hd] in q's
    dtype, (C, n, m))``. The outer product ``k vᵀ`` is one product per
    element, as the reference's contraction-free einsum; ``C q`` and
    ``n·q`` are batched matrix products (no ``einsum`` per token: its
    planning costs more host time than the step's kernels)."""
    dt = q.dtype
    hs = []
    for qt, kt, vt, li, lf in zip(*(a.unbind(1)
                                    for a in (q, k, v, logi, logf))):
        lf_m = lf + mm
        m_new = torch.maximum(lf_m, li)                       # [B, H]
        fg = torch.exp(lf_m - m_new).to(dt)[:, :, None]
        ig = torch.exp(li - m_new).to(dt)[:, :, None]
        C = C * fg[..., None] + (kt[..., :, None] * vt[..., None, :]) \
            * ig[..., None]
        n = n * fg + kt * ig
        qr = qt[..., None, :]                                 # [B, H, 1, hd]
        num = (qr @ C)[..., 0, :]
        den = torch.maximum((qr @ n[..., :, None])[..., 0, 0].abs(),
                            torch.exp(-m_new).to(dt))
        hs.append(num / den[:, :, None])
        mm = m_new
    return torch.stack(hs, dim=1), (C, n, mm)


def apply_mlstm(p: dict, x: torch.Tensor, state: Optional[dict] = None,
                q_chunk: int = -1, n_heads: Optional[int] = None):
    """x: [B, S, D] -> (y, state); state: ``C [B, H, hd, hd]``, ``n [B, H,
    hd]`` in x's dtype (the chunkwise form's cast to it), ``m [B, H]`` f32.
    A full sequence with no state (``S > 1``) runs the chunkwise form at
    :func:`mlstm_chunk`'s length; anything else the step recurrence.

    ``n_heads``: the global head count (default: the weights'). Where
    ``wi`` holds this rank's 'model' block of the heads
    (:func:`~repro_torch.parallel.sharding.layer_group`), the heads run
    split: q/k/v and the gates column-parallel, the state this rank's
    heads, the whole ``wo_gate`` and ``norm`` taken at this rank's columns
    (their gradients summed over the group), the norm over ``d_model``
    summing its squares over 'model', and ``wo`` row-parallel."""
    B, S, D = x.shape
    h_loc = p["wi"].shape[1]
    H = n_heads or h_loc
    hd = D // H
    mg = Sh.layer_group(h_loc, H)
    xm = Sh.to_model(x, mg)
    # the reference divides by a weakly typed scalar: √hd rounded to x's
    # dtype, here a 0-d tensor filled on x's device (no host-to-device
    # copy; CUDA would multiply by a Python scalar's reciprocal)
    scale = float(torch.tensor(math.sqrt(float(hd)),
                               dtype=torch.float32).to(x.dtype))
    q = einsum("bsd,dhk->bshk", xm, p["wq"]) / x.new_full((), scale)
    k = einsum("bsd,dhk->bshk", xm, p["wk"])
    v = einsum("bsd,dhk->bshk", xm, p["wv"])
    logi = (einsum("bsd,dh->bsh", xm, p["wi"]) + p["bi"]).float()
    logf = F.logsigmoid((einsum("bsd,dh->bsh", xm, p["wf"])
                         + p["bf"]).float())

    if state is None and S > 1:
        h, (C, n, mm) = _mlstm_chunkwise(q, k, v, logi, logf, q_chunk)
        h = h.to(x.dtype)
        new_state = {"C": C.to(x.dtype), "n": n.to(x.dtype), "m": mm}
    else:
        if state is None:
            C = torch.zeros((B, h_loc, hd, hd), dtype=x.dtype,
                            device=x.device)
            n = torch.zeros((B, h_loc, hd), dtype=x.dtype, device=x.device)
            mm = torch.full((B, h_loc), _NEG, dtype=torch.float32,
                            device=x.device)
        else:
            C, n, mm = state["C"], state["n"], state["m"]
        h, (C, n, mm) = _mlstm_steps(q, k, v, logi, logf, C, n, mm)
        new_state = {"C": C, "n": n, "m": mm}

    y = h.reshape(B, S, h_loc * hd)
    if mg is None:
        og = torch.sigmoid(einsum("bsd,de->bse", x, p["wo_gate"]))
        y = rms_norm(y * og, p["norm"])
    else:
        cols = slice(mg.index * h_loc * hd, (mg.index + 1) * h_loc * hd)
        og = torch.sigmoid(einsum("bsd,de->bse", xm, Sh.to_model(
            p["wo_gate"], mg)[:, cols]))
        y = rms_norm(y * og, Sh.to_model(p["norm"], mg)[cols], mg=mg,
                     width=D)
    out = einsum("bshk,hkd->bsd", y.reshape(B, S, h_loc, hd), p["wo"])
    return Sh.from_model(out, mg), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("i", "f", "z", "o")


def init_slstm(gen: torch.Generator, d_model: int, n_heads: int, dtype,
               device=None) -> Tuple[dict, dict]:
    hd = d_model // n_heads
    b = Builder(gen, dtype, device)
    for g in _GATES:
        b.dense(f"w{g}", (d_model, n_heads, hd), ("embed", "heads", "head_dim"))
        b.dense(f"r{g}", (n_heads, hd, hd), ("heads", "head_dim", "head_dim"))
        b.dense(f"b{g}", (n_heads, hd), ("heads", "head_dim"),
                zero=(g != "f"), scale=1.0)
    b.ones("norm", (d_model,), ("embed",))
    b.dense("w_out", (d_model, d_model), ("embed", "embed"))
    return b.done()


def slstm_init_state(B: int, H: int, hd: int, device) -> dict:
    """c 0, n 1e-6, h 0, m -1e30, each ``[B, H, hd]`` f32."""
    z = torch.zeros((B, H, hd), dtype=torch.float32, device=device)
    return {"c": z, "n": z + 1e-6, "h": z, "m": z + _NEG}


def apply_slstm(p: dict, x: torch.Tensor, state: Optional[dict] = None,
                n_heads: Optional[int] = None):
    """The recurrence over every token. state: ``{"c", "n", "h", "m"}``,
    each ``[B, H, hd]`` f32. The four gates run side by side (``[.., 4
    hd]``, i f z o): one input projection, and per step one recurrent
    product (``r`` stacked ``[H, hd, 4 hd]``) and one add, each gate's
    columns the same dot products and sums as its own matrix's. The loop
    keeps its tensors head-major (``[H, B, ..]``), so the per-head product
    is a plain ``bmm``.

    ``n_heads``: the global head count (default: the weights'). Where the
    gates hold this rank's 'model' block of the heads, the recurrence runs
    on those heads (its state their block) and their ``h`` is all-gathered
    over 'model' before the whole ``norm`` and ``w_out``, which every rank
    then runs alike."""
    B, S, D = x.shape
    h_loc = p["wi"].shape[1]
    H = n_heads or h_loc
    hd = D // H
    mg = Sh.layer_group(h_loc, H)
    w = torch.cat([p[f"w{g}"] for g in _GATES], dim=-1)     # [D, H, 4hd]
    bias = torch.cat([p[f"b{g}"] for g in _GATES], dim=-1)  # [H, 4hd]
    # [S, H, B, 4hd], unbound into its steps (contiguous slices; the
    # backward stacks the steps' gradients once)
    pre = (einsum("bsd,dhk->shbk", Sh.to_model(x, mg), w)
           + bias[:, None, :]).contiguous().unbind(0)
    if state is None:
        state = slstm_init_state(B, h_loc, hd, x.device)
    c, n, h, m = (state[k].transpose(0, 1) for k in ("c", "n", "h", "m"))
    # in the state's f32, as JAX promotes h @ r; cast once
    r = torch.cat([p[f"r{g}"] for g in _GATES], dim=-1).to(h.dtype)
    hs = []
    for pre_t in pre:
        a = (pre_t + torch.bmm(h, r)).float()                 # [H, B, 4hd]
        li, af, az, ao = a.split(hd, dim=-1)
        lf_m = F.logsigmoid(af) + m
        m_new = torch.maximum(lf_m, li)
        ig = torch.exp(li - m_new)
        fg = torch.exp(lf_m - m_new)
        z = torch.tanh(az)
        o = torch.sigmoid(ao)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    # [H, B, S, hd] -> [B, S, H, hd], every head's
    y = Sh.gather_model(torch.stack(hs, dim=2).permute(1, 2, 0, 3), mg, 2) \
        .reshape(B, S, D).to(x.dtype)
    y = rms_norm(y, p["norm"])
    out = einsum("bsd,de->bse", y, p["w_out"])
    return out, {k: v.transpose(0, 1) for k, v in
                 (("c", c), ("n", n), ("h", h), ("m", m))}
