"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, with ordinary tensor ops.
The kernel wrappers run them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

# pairs held in one [R, rows, N] comparison block: bounds the plain
# admission's temporaries (a few bool tensors of this many elements) at
# any N, so the on-card check runs at N = 17000 too
_PAIR_BLOCK = 1 << 25


def admission_mask_dense(res_q: torch.Tensor, pkey: torch.Tensor,
                         enq_wave: torch.Tensor,
                         free: torch.Tensor) -> torch.Tensor:
    """One admission round of the wave loop: the ``[R, N]`` bool admitted
    mask, by a pairwise seat count (:func:`repro.core.vdes.
    admission_mask_dense` with a replica axis written out).

    ``res_q [R, N]`` i32 is each job's resource, with the sentinel ``nres``
    for rows that are not queued; ``pkey [R, N]`` f32 the policy key;
    ``enq_wave [R, N]`` i32 the enqueue wave; ``free [R, nres]`` i32 the
    free slots per resource (negative after a capacity decrease). A job's
    seat is the count of same-resource jobs with a lex-smaller
    ``(pkey, enq_wave, id)`` key — its position under the stable sort — and

        admitted_i  =  res_i < nres  &  seat_i < free[res_i]

    Comparisons and integer counts only, so the mask is exact. Rows are
    compared in blocks so the ``[R, rows, N]`` temporaries stay bounded."""
    R, N = res_q.shape
    nres = free.shape[1]
    ids = torch.arange(N, dtype=torch.int32, device=res_q.device)
    rj, pj, wj = res_q[:, None, :], pkey[:, None, :], enq_wave[:, None, :]
    seat = torch.empty((R, N), dtype=torch.int32, device=res_q.device)
    step = max(1, _PAIR_BLOCK // max(R * N, 1))
    for i0 in range(0, N, step):
        sl = slice(i0, min(N, i0 + step))
        ri, pi, wi = res_q[:, sl, None], pkey[:, sl, None], enq_wave[:, sl, None]
        id_lt = ids[None, None, :] < ids[None, sl, None]
        lt = (pj < pi) | ((pj == pi) & ((wj < wi) | ((wj == wi) & id_lt)))
        seat[:, sl] = ((rj == ri) & lt).sum(dim=2, dtype=torch.int32)
    # free[res] by a select over the (tiny) resource count; sentinel rows
    # keep 0 and never admit
    free_q = torch.zeros_like(res_q)
    for r in range(nres):
        free_q = torch.where(res_q == r, free[:, r:r + 1], free_q)
    return (res_q < nres) & (seat < free_q)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        head_dim: int = None) -> torch.Tensor:
    """Grouped-query attention, ``[B, S, H, D]`` out in q's dtype
    (:func:`repro.kernels.ref.flash_attention_ref`).

    ``q [B, S, H, D]``, ``k``/``v [B, S, Hkv, D]`` with ``H % Hkv == 0``;
    query head ``h`` reads KV head ``h // (H // Hkv)``. Scores in f32 scaled
    by ``1/sqrt(D)``, ``-1e30`` above the diagonal when causal, softmax over
    the keys, the product with v in f32, and one cast at the end.
    ``head_dim`` replaces D in the scale (inputs zero-padded along D keep
    their true head dim's scale)."""
    D = q.shape[3]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / torch.sqrt(torch.tensor(head_dim or D,
                                          dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(
        q.device)
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


_LOG2PI = 1.8378770664093453


def gmm_logpdf_ref(x: torch.Tensor, means: torch.Tensor,
                   inv_chol: torch.Tensor,
                   log_w: torch.Tensor) -> torch.Tensor:
    """Per-component GMM log densities plus log weights, ``[N, K]`` f32
    (:func:`repro.kernels.ref.gmm_logpdf_ref`).

    ``x [N, D]``, ``means [K, D]``, ``inv_chol [K, D, D]`` (the inverse of
    each component's lower Cholesky factor), ``log_w [K]``:

        out[n, k] = log_w[k] - 0.5 (||inv_chol[k] (x[n] - means[k])||^2
                                    + D log 2 pi) - logdet[k],
        logdet[k] = -sum_i log |inv_chol[k, i, i]|

    The full ``D x D`` product, as the reference's kernel computes it."""
    x = x.float()
    diff = x[:, None, :] - means.float()[None]                   # [N, K, D]
    y = torch.einsum("kij,nkj->nki", inv_chol.float(), diff)
    maha = torch.sum(y * y, dim=-1)
    logdet = -torch.sum(torch.log(torch.abs(
        torch.diagonal(inv_chol.float(), dim1=-2, dim2=-1))), dim=-1)
    d = x.shape[-1]
    return (log_w.float()[None] - 0.5 * (maha + d * _LOG2PI)
            - logdet[None])


def mamba2_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *,
                    chunk: int = 128):
    """The Mamba-2 SSD scan from a zero state, in f32: the model's chunked
    form (:func:`repro.kernels.ref.mamba2_scan_ref`, which delegates the
    same way). ``x [B, S, H, P]``, ``dt [B, S, H]``, ``A [H]``,
    ``Bm``/``Cm [B, S, N]`` -> ``(y [B, S, H, P], h_last [B, H, P, N])``,
    both f32."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x.float(), dt.float(), A.float(), Bm.float(),
                       Cm.float(), chunk=chunk)


def mamba2_recurrent_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor):
    """The O(S) step-by-step recurrence, the ground truth of the SSD
    semantics (:func:`repro.kernels.ref.mamba2_recurrent_ref`):

        h <- exp(dt_t A) h + dt_t x_t B_tᵀ,   y_t = h C_t

    with ``h [B, H, P, N]`` from zero, all in f32."""
    Bsz, S, H, P = x.shape
    x, dt, A, Bm, Cm = (a.float() for a in (x, dt, A, Bm, Cm))
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * A[None, :])                   # [B, H]
        h = h * dec[:, :, None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", x[:, t], Bm[:, t], dt[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def queue_scan_ref(ready: torch.Tensor, service: torch.Tensor, *,
                   capacity: int):
    """Exact c-server FIFO stations, one per row
    (:func:`repro.kernels.ref.queue_scan_ref`): ``ready``/``service
    [R, N]``, each row sorted by ready time, -> ``(start, finish) [R, N]``
    f32. One step per job, over all rows at once: the earliest free slot
    ``k = argmin(slots)``, ``start = max(ready, slots[k])``, ``finish =
    start + service``, ``slots[k] = finish``. Comparisons and one f32 add
    per job, so the result is exact."""
    ready, service = ready.float(), service.float()
    R, N = ready.shape
    slots = torch.zeros((R, capacity), dtype=torch.float32,
                        device=ready.device)
    start = torch.empty_like(ready)
    finish = torch.empty_like(ready)
    for j in range(N):
        k = slots.argmin(dim=1, keepdim=True)
        s = torch.maximum(ready[:, j:j + 1], slots.gather(1, k))
        f = s + service[:, j:j + 1]
        slots.scatter_(1, k, f)
        start[:, j:j + 1] = s
        finish[:, j:j + 1] = f
    return start, finish
