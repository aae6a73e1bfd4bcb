"""Serving engine: prefill and decode steps with a KV cache, and batched
generation (mirrors :mod:`repro.serving.engine`), on one device or on a
mesh.

The reference jits the two steps and shards the caches over a mesh; here
they run eagerly and the cache is updated in place. On a mesh (a
``DeviceMesh``, :mod:`repro_torch.launch.mesh`) the caches are placed by
the reference's ``cache_shardings``: batch over the DP axes, the sequence
over 'model' (a leaf with no sequence dim, such as an SSM or xLSTM state
or a cross-attention cache, takes 'model' on a head dim instead). Each
rank holds only its block of each leaf (``NamedSharding.block``) and
computes on plain local tensors, the design of the sharded training step
(:mod:`repro_torch.train.trainer`):

- the rank runs its DP rows of the batch;
- every parameter the reference's rules split over 'model' stays in its
  'model' block, and its layer computes on it (attention, MLA and
  cross-attention on this rank's heads, the Mamba mixer and the xLSTM
  cells on its heads, the MLPs on its mlp block, the vocabulary, the
  experts or their width; :func:`~repro_torch.models.transformer.
  model_parallel_leaf`, :func:`~repro_torch.parallel.sharding.
  local_params`); the layers combine their shares over 'model', and the
  logits' vocabulary blocks are all-gathered for the sampling (the last
  position only);
- parameters placed by FSDP (DTensors whose blocks the DP axes split)
  stay this rank's blocks: each step installs a
  :class:`~repro_torch.parallel.sharding.DPGather`, which gathers a
  block over the DP axes where the model reads it, one layer at a time
  (parameters placed without FSDP, or whole, gather nothing);
- a sequence-sharded leaf stays in its block: the attention writes the new
  entries that fall in it (the fresh K/V of every head, all-gathered over
  'model' where the KV heads split, or MLA's latents) and decode attends
  every head over the block and combines the blocks' partial softmaxes
  across 'model' (:class:`~repro_torch.parallel.sharding.CacheBlock`);
- a head-split state (the Mamba and xLSTM states, a cross-attention
  cache) is computed in the block 'model' gives it at rest, so it does not
  move: the model builds those leaves at this rank's share of the heads
  (:func:`~repro_torch.parallel.sharding.local_count`), and a leaf that the
  reference's rule places otherwise (a dim that happens to match a head
  count) is moved into that layout for the step and back after it;
- the moves and the gathers of rows are c10d all-gathers
  (``all_gather_into_tensor``) over a mesh dim's group, then slicing: no
  DTensor collective is on the serving path;
- a MoE layer routes the global batch, as the reference's does
  (:class:`~repro_torch.parallel.sharding.TokenGroup`).

With a 'model' axis of size 1 nothing is split, and the path is the
meshless one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import Replicate

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ModelConfig, get_model,
                                            head_width, model_parallel_leaf)
from repro_torch.parallel import sharding as Sh


@dataclasses.dataclass
class ServeConfig:
    batch: int
    max_len: int
    temperature: float = 0.0   # 0 -> greedy


def _grown_dims(small, large) -> Optional[dict]:
    """``{id(leaf of small): dim}``: the one dim in which each leaf of
    ``small`` differs from its twin in ``large`` (grown or shrunk), else
    no entry."""
    out = {}

    def one(a, b):
        diff = [d for d, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) == 1:
            out[id(a)] = diff[0]
        return a

    Sh._map(one, small, large)
    return out


class MeshServe:
    """What a serving step on a mesh needs: the cache's shardings at rest
    (the reference's ``cache_shardings`` of ``init_cache(batch,
    max_len)`` with ``head_candidates``) and the tokens' sharding; on a
    ``DeviceMesh`` also this rank's coordinate, rows, the layout each leaf
    is computed in and the :class:`~repro_torch.parallel.sharding.
    CacheBlock`. A :class:`~repro_torch.parallel.sharding.MeshShape`
    gives the shardings (a planner's layout) and no step."""

    def __init__(self, model, mesh, batch: int, max_len: int,
                 head_candidates):
        self.model, self.mesh = model, mesh
        self.batch, self.max_len = batch, max_len
        self.meta = model.init_cache(batch, max_len, device="meta")
        self.shardings = Sh.cache_shardings(
            self.meta, mesh, batch=batch, seq=max_len,
            head_candidates=head_candidates)
        self.tokens = Sh.batch_shardings(
            {"t": torch.empty((batch, 1), dtype=torch.int32,
                              device="meta")}, mesh)["t"]
        self._bound = False

    def bind(self) -> "MeshServe":
        """Reads this rank's place on the mesh (once)."""
        if self._bound:
            return self
        if not hasattr(self.mesh, "get_coordinate"):
            raise ValueError("a MeshShape gives the shardings; running a "
                             "step needs a DeviceMesh")
        mesh, B, L = self.mesh, self.batch, self.max_len
        self.coord = tuple(mesh.get_coordinate())
        sizes = Sh.mesh_shape(mesh).shape
        dp = Sh.dp_axes(mesh)
        tp = sizes["model"]
        n_dp = int(np.prod([sizes[a] for a in dp]))
        rows_split = B % n_dp == 0
        blockwise = tp > 1 and L % tp == 0
        self.row_block = self.tokens.block((B, 1), self.coord)[0]
        self.group = (Sh.token_group_of(mesh, self.coord, dp)
                      if rows_split else None)
        if blockwise:
            i = Sh.mesh_shape(mesh).axis_names.index("model")
            n = L // tp
            self.block = Sh.CacheBlock(self.coord[i] * n,
                                       (self.coord[i] + 1) * n,
                                       mesh.get_group("model"))
        else:
            self.block = None
        self.mg = Sh.model_group_of(mesh, self.coord)
        # the batch and sequence dim of each leaf: those that grow with
        # the batch and with max_len; the head dim the layer splits: the
        # one that shrinks under this rank's 'model' group
        bdim = _grown_dims(self.meta, self.model.init_cache(B + 1, L,
                                                            device="meta"))
        sdim = _grown_dims(self.meta, self.model.init_cache(B, L + 1,
                                                            device="meta"))
        with Sh.model_parallel(self.mg):
            heads = _grown_dims(self.meta, self.model.init_cache(
                B, L, device="meta"))
        dp_entry = dp if len(dp) > 1 else dp[0]
        one = [n == 1 for n in Sh.mesh_shape(mesh).sizes]

        def placements(spec):
            # a block over a mesh dim of size 1 is the whole: Replicate
            return [Replicate() if o else p for o, p in
                    zip(one, Sh.NamedSharding(mesh, tuple(spec)).placements)]

        def layout(leaf, sh):
            spec = [None] * leaf.dim()
            if rows_split and id(leaf) in bdim:
                spec[bdim[id(leaf)]] = dp_entry
            if blockwise and id(leaf) in sdim:
                spec[sdim[id(leaf)]] = "model"
            if id(leaf) in heads:
                spec[heads[id(leaf)]] = "model"
            return tuple(leaf.shape), placements(sh.spec), placements(spec)

        self.layout = Sh._map(layout, self.meta, self.shardings)
        # each mesh dim's group, for the moves and the rows' gather
        self.axes = [Sh.AxisGroup(self.coord[i], sizes[n], mesh.get_group(n))
                     for i, n in enumerate(Sh.mesh_shape(mesh).axis_names)]
        self.n_dp = n_dp
        self.gather = Sh.DPGather()
        # the parameters' meta shapes and shardings without FSDP (a whole
        # leaf is cut to its 'model' block of them)
        shapes, axes = self.model.init(0, device="meta", with_axes=True)
        self.param_specs = (shapes, Sh.param_shardings(axes, shapes, mesh))
        self._bound = True
        return self

    # ---------------- the parameters
    def local_params(self, params):
        """The parameters this rank holds
        (:func:`~repro_torch.parallel.sharding.local_params`, no
        communication): a DTensor leaf's block, which the step's
        :attr:`gather` gathers over the DP axes that split it (registered
        here); a whole leaf the reference splits over 'model' cut to its
        'model' block, any other leaf whole."""
        model = self.model
        size = 1 if self.mg is None else self.mg.size
        shapes, shardings = self.param_specs
        local = Sh.local_params(
            params, lambda path: model_parallel_leaf(model, path, size),
            shardings=shardings, shapes=shapes, group=self.mg)
        self.gather.register(params, local, Sh.dp_axes(self.mesh), self.mesh)
        return local

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The logits of every vocabulary column: this rank's block
        all-gathered over 'model' where the head runs split."""
        if self.mg is None or logits.shape[-1] == head_width(self.model.cfg):
            return logits
        return self.mg.all_gather(logits, -1)

    # ---------------- rows and leaves
    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, a global ``[batch, ...]`` tensor."""
        return x[self.row_block]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global ``[batch, ...]`` tensor of every rank's rows ``x``,
        all-gathered over the DP axes (the inner one first: the rows nest
        in mesh order)."""
        if self.n_dp == 1 or x.shape[0] == self.batch:
            return x
        for p, g in reversed(list(zip(self.tokens.placements, self.axes))):
            if p.is_shard() and g.size > 1:
                x = g.all_gather(x, 0)
        return x

    def _move(self, t, shape, src, dst):
        """``t``, this rank's local tensor of a ``shape`` leaf placed by
        ``src``, as placed by ``dst``: itself where they agree, else a
        tensor of its own (never a view into a whole leaf). Each mesh dim
        whose placement differs is undone by an all-gather over its group,
        the inner one first, then the new placements are cut, the outer one
        first (a tensor dim split over several mesh dims nests them in mesh
        order; a move that would leave an inner one split under a changed
        outer one raises ``ValueError``)."""
        if src == dst:
            return t
        changed = [i for i, (a, b) in enumerate(zip(src, dst)) if a != b]
        for pl, order, cut in ((src, reversed(changed), False),
                               (dst, changed, True)):
            for i in order:
                if not pl[i].is_shard():
                    continue
                d = pl[i].dim
                if any(j > i and j not in changed and pl[j] == pl[i]
                       for j in range(len(pl))):
                    raise ValueError(f"a leaf of {shape} placed {src} "
                                     f"cannot move to {dst} dim by dim")
                g = self.axes[i]
                t = t[(slice(None),) * d + (g.block(t.shape[d]),)] if cut \
                    else g.all_gather(t, d)
        return t.clone() if t._base is not None or not t.is_contiguous() \
            else t

    def to_compute(self, cache):
        """Each cache block in the layout its step computes in: this rank's
        rows, its sequence block and, where its layer splits the leaf's
        heads, its block of those heads. A leaf the reference's sharding
        places otherwise is moved there (:meth:`_move`: all-gathered over
        each mesh dim whose placement differs, then cut)."""
        return Sh._map(lambda t, lay: self._move(t, lay[0], lay[1], lay[2]),
                       cache, self.layout)

    def to_rest(self, cache):
        """The computed leaves cut back to this rank's blocks."""
        return Sh._map(lambda t, lay: self._move(t, lay[0], lay[2], lay[1]),
                       cache, self.layout)

    def block_len(self) -> int:
        """The length of this rank's sequence block of each cache leaf."""
        return (self.block.stop - self.block.start if self.block is not None
                else self.max_len)

    @contextlib.contextmanager
    def context(self):
        """The reference's constraint points, this rank's cache block, its
        DP ranks' token group, its 'model' group and the DP gather of its
        parameters' blocks."""
        with Sh.activation_mesh(self.mesh), Sh.cache_block(self.block), \
                Sh.token_group(self.group), Sh.model_parallel(self.mg), \
                Sh.dp_gather(self.gather):
            yield

    # ---------------- the steps on this rank's rows
    def prefill(self, params, tokens, ctx=None):
        """``(logits, cache)`` of this rank's rows ``tokens`` (and
        ``ctx``): the cache is built at its block's length (the model's
        ``max_len`` is read only there), written through the block and cut
        back to this rank's blocks. A ``ctx`` must hold the config's
        ``n_ctx`` entries, which the shardings were built with."""
        cfg = self.model.cfg
        if ctx is not None and cfg.family in ("vlm", "audio") \
                and ctx.shape[1] != cfg.n_ctx:
            raise ValueError(f"{cfg.name}: on a mesh the cross cache is "
                             f"sharded for n_ctx={cfg.n_ctx} entries; ctx "
                             f"has {ctx.shape[1]}")
        with self.context():
            logits, cache = self.model.prefill(params, tokens,
                                               max_len=self.block_len(),
                                               ctx=ctx)
        return self.full_logits(logits), self.to_rest(cache)

    def decode(self, params, tokens, cache, pos: int):
        """``(logits, cache)`` of one token of this rank's rows at
        ``pos``, on this rank's cache blocks."""
        comp = self.to_compute(cache)
        with self.context():
            logits, comp = self.model.decode_step(params, tokens, comp, pos)
        return self.full_logits(logits), self.to_rest(comp)


def engine_head_candidates(cfg: ModelConfig) -> tuple:
    """The reference engine's head candidates: KV heads, heads and the SSM
    heads."""
    return (cfg.n_kv_heads, cfg.n_heads,
            (cfg.ssm_expand * cfg.d_model) // max(cfg.ssm_head_dim, 1)
            if cfg.ssm_head_dim else 0)


def step_head_candidates(cfg: ModelConfig) -> tuple:
    """The reference step factories' head candidates: KV heads and
    heads."""
    return (cfg.n_kv_heads, cfg.n_heads)


class ServingEngine:
    """``params`` live on ``device`` (``None``: the card, raising without
    one). With a ``mesh`` (a ``DeviceMesh``; a ``MeshShape`` gives
    ``cache_shardings`` only) ``prefill`` and ``decode`` take the global
    batch on every rank and return this rank's rows' logits and its cache
    blocks; ``generate`` returns the global tokens on every rank.
    ``params`` whole tensors (cut to this rank's 'model' blocks on a
    mesh) or DTensors: on a mesh each rank keeps its blocks, and a block
    the DP axes split (FSDP) is gathered at each use; without a mesh a
    DTensor leaf is gathered whole once, here (c10d)."""

    def __init__(self, cfg: ModelConfig, serve_cfg: ServeConfig, params=None,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.model = get_model(cfg)
        self.mesh = mesh
        self.last_stats: dict = {}
        if mesh is not None:
            self._mesh = MeshServe(self.model, mesh, serve_cfg.batch,
                                   serve_cfg.max_len,
                                   engine_head_candidates(cfg))
            self.cache_shardings = self._mesh.shardings
        else:
            self._mesh = None
            self.cache_shardings = None
        if params is None or mesh is None \
                or not hasattr(mesh, "get_coordinate"):
            self.params = None if params is None \
                else Sh.full_tensors(params)
        else:
            self.params = self._mesh.bind().local_params(params)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (all of it without a
        mesh)."""
        return x if self._mesh is None else self._mesh.bind().rows(x)

    def prefill(self, tokens: torch.Tensor, ctx=None):
        """``ctx``: the VLM's patches or the encoder-decoder's frames, moved
        to the engine's device (other models ignore it)."""
        if ctx is not None:
            ctx = self.rows(ctx.to(self.device))
        return self._prefill_rows(self.rows(tokens), ctx)

    def decode(self, tokens: torch.Tensor, cache, pos: int):
        return self._decode_rows(self.rows(tokens), cache, pos)

    def _prefill_rows(self, tokens, ctx):
        if self._mesh is None:
            return self.model.prefill(self.params, tokens,
                                      max_len=self.scfg.max_len, ctx=ctx)
        return self._mesh.bind().prefill(self.params, tokens, ctx)

    def _decode_rows(self, tokens, cache, pos):
        if self._mesh is None:
            return self.model.decode_step(self.params, tokens, cache, pos)
        return self._mesh.bind().decode(self.params, tokens, cache, pos)

    def generate(self, prompt_tokens: torch.Tensor, n_new: int, ctx=None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy (or, with a temperature and a ``generator``, sampled)
        generation for a full batch: ``[B, n_new]`` int32 tokens; ``ctx``
        goes to the prefill. On a mesh every rank takes the global batch,
        generates its DP rows and returns every row's tokens, gathered
        over the DP axes.

        ``last_stats`` then holds ``prefill_s`` (prompt in to the first
        token on the host: the time to first token), ``decode_s`` (the
        remaining ``n_new - 1`` tokens, up to their arrival on the host)
        and ``logits_finite`` (every sampled-from logit is finite; on a
        mesh, this rank's)."""
        prompt_tokens = self.rows(prompt_tokens.to(self.device))
        if ctx is not None:
            ctx = self.rows(ctx.to(self.device))
        S = prompt_tokens.shape[1]
        t0 = time.perf_counter()
        logits, cache = self._prefill_rows(prompt_tokens, ctx)
        finite = torch.isfinite(logits).all()
        tok = self._sample(logits, generator)
        first = tok.cpu()
        t1 = time.perf_counter()
        outs = [tok]
        for i in range(1, n_new):
            logits, cache = self._decode_rows(tok, cache, S + i - 1)
            finite &= torch.isfinite(logits).all()
            tok = self._sample(logits, generator)
            outs.append(tok)
        rest = torch.cat(outs[1:], dim=1).cpu() if n_new > 1 else first[:, :0]
        t2 = time.perf_counter()
        self.last_stats = dict(prefill_s=t1 - t0, decode_s=t2 - t1,
                               logits_finite=bool(finite))
        out = torch.cat([first, rest], dim=1)
        if self._mesh is not None:
            out = self._mesh.gather_rows(torch.cat(outs, dim=1)).cpu()
        return out.numpy()

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        last = logits[:, -1].float()
        if self.scfg.temperature <= 0.0 or generator is None:
            return last.argmax(-1)[:, None].to(torch.int32)
        probs = torch.softmax(last / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(
            torch.int32)


def make_serve_step(cfg: ModelConfig, batch: int, max_len: int,
                    device=None, mesh=None):
    """The one-token decode step of the decode cells, ``serve_step(params,
    tokens [batch, 1], cache, pos) -> (logits, cache)`` at ``pos <
    max_len``, with ``cache`` from ``init_cache(batch, max_len)`` on
    ``device`` (``None``: the card), written in place. With no mesh the
    step comes alone, where the reference returns it with the cache's and
    the tokens' shardings.

    With a ``mesh`` it returns the reference's triple ``(serve_step,
    cache_sh, tok_sh)`` (head candidates: KV heads and heads, as the
    reference's factory takes them). ``tokens`` is then the global batch
    on every rank, ``cache`` this rank's blocks of ``cache_sh``, and
    ``params`` whole tensors, DTensors or this rank's blocks, made in the
    step into what this rank computes on (``MeshServe.local_params``); it
    returns this rank's rows' logits and cache blocks. A ``MeshShape``
    gives the shardings; the step needs a ``DeviceMesh``."""
    resolve_device(device)
    model = get_model(cfg)

    def check(tokens, pos):
        if tuple(tokens.shape) != (batch, 1) or not 0 <= pos < max_len:
            raise ValueError(f"serve_step takes [{batch}, 1] tokens at a "
                             f"position below {max_len}, got "
                             f"{list(tokens.shape)} at {pos}")

    if mesh is None:
        def serve_step(params, tokens, cache, pos: int):
            check(tokens, pos)
            return model.decode_step(params, tokens, cache, pos)

        return serve_step

    ms = MeshServe(model, mesh, batch, max_len, step_head_candidates(cfg))

    def mesh_serve_step(params, tokens, cache, pos: int):
        check(tokens, pos)
        ms.bind()
        return ms.decode(ms.local_params(params), ms.rows(tokens), cache,
                         pos)

    mesh_serve_step.mesh_serve = ms
    return mesh_serve_step, ms.shardings, ms.tokens


def make_prefill_step(cfg: ModelConfig, batch: int, seq: int, device=None,
                      mesh=None):
    """The prefill step of the prefill cells, ``prefill_step(params, tokens
    [batch, <= seq], ctx=None) -> (logits, cache)``, its cache of ``seq``
    entries built on the tokens' device (``device`` is checked as the other
    entry points check it: ``None`` means the card); ``ctx`` is the VLM's
    patches or the encoder-decoder's frames. With no mesh the step comes
    alone, without the reference's cache shardings; with a ``mesh`` it
    returns ``(prefill_step, cache_sh)``, and the step takes the global
    batch (and ``ctx``) on every rank and returns this rank's rows'
    logits and cache blocks, as :func:`make_serve_step`'s."""
    resolve_device(device)
    model = get_model(cfg)

    def check(tokens):
        if tokens.shape[0] != batch or tokens.shape[1] > seq:
            raise ValueError(f"prefill_step takes {batch} rows of at most "
                             f"{seq} tokens, got {list(tokens.shape)}")

    if mesh is None:
        def prefill_step(params, tokens, ctx=None):
            check(tokens)
            return model.prefill(params, tokens, max_len=seq, ctx=ctx)

        return prefill_step

    ms = MeshServe(model, mesh, batch, seq, step_head_candidates(cfg))

    def mesh_prefill_step(params, tokens, ctx=None):
        check(tokens)
        ms.bind()
        return ms.prefill(ms.local_params(params), ms.rows(tokens),
                          None if ctx is None else ms.rows(ctx))

    mesh_prefill_step.mesh_serve = ms
    return mesh_prefill_step, ms.shardings
