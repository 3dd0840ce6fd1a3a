"""The decoder LM: a loop over stacked layers of a per-arch layer pattern.

Port of `repro.models.lm`. Parameters are a nested dict of
tensors with the reference's keys and shapes: each pattern position's
parameters are stacked along a leading layer axis
(``params["blocks"]["pos0_dense"]["attn"]["wq"]`` is (n_superblocks, D,
q_dim)), and the reference's ``jax.lax.scan`` over that axis becomes a
Python loop. Pattern-remainder layers run unstacked after the loop: e.g.
recurrentgemma-2b's 26 layers are 8 x (rec, rec, local_attn) and then
(rec, rec); rwkv6-7b is 32 x (rwkv,).

API (functions over a params dict, like the reference's):
  init(generator, dtype)          -> params
  forward(params, batch, remat)   -> (B, S, V) float32 logits
  loss(params, batch, remat)      -> scalar (next-token CE, float32 logits)
  init_cache(batch, s_max)        -> decode cache (bf16 K/V by default)
  prefill(params, batch, s_max)   -> (last_logits, cache, lengths)
  decode_step(params, batch, cache, lengths) -> (logits, cache, lengths + 1)

The decode cache is updated in place (the reference returns a new one):
each block kind writes its entries into the cache tensors it is handed,
views of the stacked buffers (K/V at their slot, the local ring at
``len % w``, the rec block's ``h`` and ``conv``, the rwkv block's ``S``,
``shift`` and ``shift_c`` over their old values).

A batch holds ``tokens`` (B, S), or ``embeds`` (B, S, D) where the arch
takes its inputs as embeddings (musicgen's frontend stub), and, for an
arch with cross layers (the VLM), ``images`` (B, n_img, D), the patch
embeddings' stub: every cross layer of ``forward``, ``loss`` and
``prefill`` attends to them, and ``prefill`` leaves their K/V in the cross
layers' cache, which ``decode_step`` reads.

Training differentiates ``hidden_states`` with respect to the parameters.
With ``remat`` each superblock runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: only its
input is kept, and the backward recomputes it (the reference's
``jax.checkpoint(nothing_saveable)`` around its scan body); the remainder
layers run outside it, as in the reference. Sharding constraints have no
counterpart but one: a rank computes on its own rows. Under
`repro_torch.distributed.sharding.activation_ctx` (a rank of a mesh),
``loss`` divides the rank's masked CE sum by the count over the global
batch (all-reduced over the batch axes), so the ranks' losses add up to
the reference's mean over the global batch, whatever each shard's mask.

Where the mesh's ``model`` axis is larger than 1 (tensor parallelism,
`repro_torch.distributed.tensor_parallel`), a rank holds its shards of
the parameters and caches as `spec_for` gives them: the embedding lookup
is vocab-parallel, the logits that ``forward``, ``prefill`` and
``decode_step`` return are this rank's vocab columns
(`tensor_parallel.vocab_whole` gathers them), ``loss`` takes the
vocab-parallel cross-entropy, and ``init_cache`` allocates this rank's
shard of the cache (the sequence of a K/V cache split over ``model``
where its KV heads are not: `blocks.SeqShard`; ``decode_step`` then takes
``s_max`` to place it).

The one constraint that changes what a rank holds is the reference's
``("batch", "act_seq", "act_embed")`` on the residual stream: under rules
that map ``act_seq`` to ``model`` and a sequence that the axis's size M
divides (`sharding.seq_split`), `hidden_states` keeps only this rank's
piece (B, S / M, D) of the stream from the embedding to the final norm
(Megatron-style sequence parallelism: ``remat`` then saves a piece per
superblock), and gathers the normed stream whole once for the logits.
The positions stay the whole sequence's, which tells the blocks that
they have a piece. `prefill` keeps the stream whole, as the reference
constrains none of it, and decode's one position never splits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed import sharding, tensor_parallel
from . import blocks
from .layers import Param, init_params, rms_norm, stack_specs, tree_map


@dataclasses.dataclass
class LM:
    cfg: ArchConfig

    # The leaves that meet the residual stream itself: under act_seq a
    # rank's gradient of each is the part of its piece of the sequence.
    STREAM_NORMS = ("norm_attn", "norm_ffn", "norm_mix", "final_norm")

    # ------------------------------------------------------------- params

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        D, V = cfg.d_model, cfg.vocab_size
        specs: Dict[str, Any] = {}
        # sigma = D^-0.5 keeps tied-head logits at unit variance.
        specs["embed"] = Param((V, D), ("vocab", "embed"), scale=D**-0.5)
        specs["blocks"] = {
            f"pos{i}_{kind}": stack_specs(blocks.block_specs(kind, cfg), cfg.n_superblocks)
            for i, kind in enumerate(cfg.pattern)
        }
        for j, kind in enumerate(cfg.remainder):
            specs[f"rem{j}_{kind}"] = blocks.block_specs(kind, cfg)
        specs["final_norm"] = Param((D,), ("embed",), init="zeros")
        if not cfg.tie_embeddings:
            specs["head"] = Param((D, V), ("embed", "vocab"))
        return specs

    def init(self, generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        """Random parameters on the generator's device (bf16 by default)."""
        return init_params(self.param_specs(), generator, dtype or torch.bfloat16)

    # ------------------------------------------------------------- forward

    def seq_len(self, batch) -> int:
        """The length of the batch's sequences."""
        return batch["embeds" if self.cfg.embed_inputs else "tokens"].shape[1]

    def _embed(self, params, batch, sp=None):
        """The stream's input (B, S, D); with ``sp`` (a `TensorParallel`
        with ``seq``) this rank's piece of its sequence."""
        if self.cfg.embed_inputs:
            x = batch["embeds"]  # (B, S, D) frontend stub
        else:
            table = params["embed"]
            tp = tensor_parallel.split(table, self.cfg.vocab_size, 0, seq=sp is not None)
            if tp is not None:
                return tp.lookup(table, batch["tokens"])
            x = table[batch["tokens"]]
        return x if sp is None else sp.piece(x)

    def _logits(self, params, x):
        """Float32 logits: this rank's vocab columns where ``model`` splits
        the head."""
        head = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        tp = tensor_parallel.split(head, self.cfg.vocab_size)
        if tp is not None:
            return tp.column(x, head).float()
        return (x @ head).float()

    def _layers(self, params):
        """Each superblock's parameters, {pattern key: block params}: views
        from one ``unbind`` of each stacked tensor, whose backward stacks the
        layers' gradients once."""
        per_layer = tree_map(lambda t: t.unbind(0), params["blocks"])
        for l in range(self.cfg.n_superblocks):
            yield tree_map(lambda ts: ts[l], per_layer)

    def _images(self, batch):
        """``batch["images"]``, required where the arch has cross layers."""
        img = batch.get("images")
        if img is None and "cross" in self.cfg.pattern + self.cfg.remainder:
            raise ValueError(f"{self.cfg.name} has cross-attention layers: the batch needs "
                             f'batch["images"], (B, n_img, d_model) image embeddings')
        return img

    def _superblock(self, x, layer_p, positions, img):
        for i, kind in enumerate(self.cfg.pattern):
            x, _ = blocks.apply_block_seq(kind, self.cfg, layer_p[f"pos{i}_{kind}"], x, positions,
                                          img)
        return x

    def hidden_states(self, params, batch, remat: bool = False):
        """(B, S) tokens (+ images) -> (B, S, D) after the final norm (the
        stream a piece of the sequence on each rank between the embedding
        and the gather after the norm, where `sharding.seq_split` says)."""
        cfg = self.cfg
        S = self.seq_len(batch)
        sp = tensor_parallel.current(seq=True) if sharding.seq_split(S) > 1 else None
        x = self._embed(params, batch, sp)
        img = self._images(batch)
        B = x.shape[0]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for layer_p in self._layers(params):
            if remat:
                x = checkpoint(self._superblock, x, layer_p, positions, img, use_reentrant=False)
            else:
                x = self._superblock(x, layer_p, positions, img)
        for j, kind in enumerate(cfg.remainder):
            x, _ = blocks.apply_block_seq(kind, cfg, params[f"rem{j}_{kind}"], x, positions, img)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        # Each rank's cotangent of the whole is whole (the logits' column
        # product sums it over model, or each rank computes the same
        # loss): the gather's backward keeps this rank's piece.
        return x if sp is None else sp.whole(x)

    def forward(self, params, batch, remat: bool = False):
        """(B, S) tokens (+ images) -> (B, S, V) float32 logits."""
        return self._logits(params, self.hidden_states(params, batch, remat=remat))

    LOSS_CHUNK = 2048  # sequence chunk of the CE block (memory bound)

    def loss(self, params, batch, remat: bool = False):
        """Mean next-token cross-entropy (float32 log-softmax).

        The CE block runs over sequence chunks of ``LOSS_CHUNK`` (the whole
        sequence where it is shorter or not a multiple), each chunk under
        checkpoint when there are several: the (B, S, V) float32 logits
        are never all live. The gold logit is a gather: the reference's
        one-hot contraction gives the same value, every other term of its
        sum being an exact zero, without a (B, C, V) one-hot.
        """
        h = self.hidden_states(params, batch, remat=remat)  # (B, S, D)
        targets = batch["targets"] if "targets" in batch else batch["tokens"]
        B, S, D = h.shape
        # next-token shift with the final position masked out
        tgt_next = torch.cat([targets[:, 1:], targets[:, :1]], dim=1).long()
        # Materialised at (B, S), as the reference's NOTE requires: a (1, S)
        # mask would count S - 1 positions instead of B * (S - 1).
        pos_mask = (torch.arange(S, device=h.device) < S - 1)[None, :].expand(B, S)
        mask = batch.get("mask")
        if mask is not None:
            pos_mask = torch.logical_and(pos_mask, mask.bool())

        def ce_chunk(h_c, tgt_c, m_c):
            logits = self._logits(params, h_c)  # (B, C, V) float32
            tp = tensor_parallel.split(logits, self.cfg.vocab_size)
            if tp is not None:
                per = tp.cross_entropy(logits, tgt_c)  # vocab-parallel
            else:
                logz = torch.logsumexp(logits, dim=-1)
                per = logz - logits.gather(-1, tgt_c[..., None])[..., 0]
            m = m_c.float()
            return (per * m).sum(), m.sum()

        chunk = min(self.LOSS_CHUNK, S)
        if S % chunk:
            chunk = S
        if chunk == S:
            total, count = ce_chunk(h, tgt_next, pos_mask)
        else:
            total = count = 0.0
            for c in range(0, S, chunk):
                t, n = checkpoint(ce_chunk, h[:, c : c + chunk], tgt_next[:, c : c + chunk],
                                  pos_mask[:, c : c + chunk], use_reentrant=False)
                total, count = total + t, count + n
        ctx = sharding.current()
        if ctx is not None:
            # One rank's rows of a global batch: its share of the global
            # mean, over the global count (the ranks' shares then add up).
            comm, rules = ctx
            count = comm.all_reduce(count.detach(), sharding.batch_axes(comm.mesh, rules))
        return total / torch.clamp(count, min=1.0)

    # ------------------------------------------------------------- decode

    def init_cache(self, batch: int, s_max: int, dtype: Optional[torch.dtype] = None,
                   device="cuda"):
        """Zeroed decode cache. ``dtype`` overrides the bf16 defaults (tests
        use float32 for exact prefill -> decode equivalence)."""
        device = resolve_device(device)

        def zeros(shape, dt):
            dt = dtype if (dtype is not None and dt == torch.bfloat16) else dt
            return torch.zeros(shape, dtype=dt, device=device)

        return self._cache_tree(batch, s_max, zeros, local=True)

    def cache_spec_tree(self, batch: int, s_max: int):
        """Meta tensors shaped as `init_cache`'s on one device (nothing is
        allocated)."""
        return self._cache_tree(batch, s_max,
                                lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"))

    def _cache_tree(self, batch: int, s_max: int, make, local: bool = False):
        """The cache's structure, each entry ``make(shape, dtype)``; with
        ``local`` and a ``model`` axis, this rank's shard of each entry
        (its rows of ``batch`` being already this rank's)."""
        cfg = self.cfg
        cache: Dict[str, Any] = {"blocks": {}}
        for i, kind in enumerate(cfg.pattern):
            spec = blocks.cache_spec(kind, cfg, batch, s_max)
            cache["blocks"][f"pos{i}_{kind}"] = {
                k: ((cfg.n_superblocks,) + shape, dt) for k, (shape, dt) in spec.items()
            }
        for j, kind in enumerate(cfg.remainder):
            spec = blocks.cache_spec(kind, cfg, batch, s_max)
            cache[f"rem{j}_{kind}"] = dict(spec)
        if local and tensor_parallel.current() is not None:
            comm, rules = sharding.current()
            rules = {**rules, "batch": None}  # the rows are this rank's already
            axes = sharding.cache_axes_tree(
                tree_map(lambda sd: torch.empty(sd[0], device="meta"), cache))

            def shard(sd, ax):
                spec = sharding.spec_for(tuple(ax), sd[0], comm.mesh, rules)
                ix = sharding.shard_index(spec, sd[0], comm.mesh, comm.coords)
                return tuple(i.stop - i.start for i in ix), sd[1]

            cache = tree_map(shard, cache, axes)
        return tree_map(lambda sd: make(*sd), cache)

    def _kv_seq(self, kind: str, shape, s_max: Optional[int]) -> Optional[blocks.SeqShard]:
        """Where a rank's K/V cache entry of ``shape`` (.., KVH, S, Dh) sits
        in the whole one: None off a ``model`` axis or where it splits the
        KV heads. The whole length is the image count (cross), else from
        ``s_max``: a shard's own length does not tell a replicated cache
        from one of ``model`` shards."""
        tp = tensor_parallel.current()
        if tp is None or shape[-3] < self.cfg.n_kv_heads:
            return None
        if kind == "cross":
            whole = self.cfg.n_image_tokens
        elif s_max is None:
            raise ValueError(f"a {kind} cache whose KV heads do not split over model = "
                             f"{tp.size}: pass s_max to place its shard")
        else:
            whole = min(self.cfg.local_window, s_max) if kind == "local_attn" else s_max
        local = shape[-2]
        return blocks.SeqShard(tp.index * local if local < whole else 0, whole)

    def decode_step(self, params, batch, cache, lengths, s_max: Optional[int] = None):
        """One new token for every sequence in the batch.

        batch: {"tokens": (B, 1)} or {"embeds": (B, 1, D)}; cross layers read
        the image K/V that ``prefill`` cached. Returns (logits (B, V), cache,
        lengths + 1);
        every block writes its cache entries in place, so the blocks'
        returned dicts are the cache's own tensors and are not read.
        ``s_max`` (the cache's length, as given to ``prefill``) places a
        rank's shard of a cache whose KV heads do not split over ``model``
        (`_kv_seq`); it is read nowhere else.
        """
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = lengths[:, None]  # (B, 1)
        seqs = {key: self._kv_seq(key.split("_", 1)[1], c["k"].shape, s_max)
                for key, c in self._cache_entries(cache) if "k" in c}
        for l, layer_p in enumerate(self._layers(params)):
            for i, kind in enumerate(cfg.pattern):
                key = f"pos{i}_{kind}"
                layer_c = {name: t[l] for name, t in cache["blocks"][key].items()}
                x, _ = blocks.apply_block_decode(
                    kind, cfg, layer_p[key], x, positions, layer_c, lengths, seqs.get(key)
                )
        for j, kind in enumerate(cfg.remainder):
            key = f"rem{j}_{kind}"
            x, _ = blocks.apply_block_decode(
                kind, cfg, params[key], x, positions, cache[key], lengths, seqs.get(key)
            )
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)[:, 0]
        return logits, cache, lengths + 1

    def _put(self, buf, got, kind: str, name: str, s_max: int) -> None:
        """`_place` a prefill entry, at its shard's positions for K/V."""
        _place(buf, got, self._kv_seq(kind, buf.shape, s_max) if name in ("k", "v") else None)

    def _cache_entries(self, cache):
        """(key, {name: tensor}) of every pattern position and remainder layer."""
        yield from cache["blocks"].items()
        for j, kind in enumerate(self.cfg.remainder):
            yield f"rem{j}_{kind}", cache[f"rem{j}_{kind}"]

    def prefill(self, params, batch, s_max: int, cache_dtype: Optional[torch.dtype] = None):
        """Run the prompt through the model, building a decode cache.

        Attention runs on the prompt's own K/V in the parameters' dtype; the
        cache receives them cast to its dtype afterwards, as in the
        reference. Only the last position's logits are formed.
        """
        cfg = self.cfg
        x = self._embed(params, batch)
        img = self._images(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        cache = self.init_cache(B, s_max, dtype=cache_dtype, device=x.device)
        for l, layer_p in enumerate(self._layers(params)):
            for i, kind in enumerate(cfg.pattern):
                key = f"pos{i}_{kind}"
                x, got = blocks.apply_block_seq(kind, cfg, layer_p[key], x, positions, img)
                for name, t in got.items():
                    self._put(cache["blocks"][key][name][l], t, kind, name, s_max)
        for j, kind in enumerate(cfg.remainder):
            key = f"rem{j}_{kind}"
            x, got = blocks.apply_block_seq(kind, cfg, params[key], x, positions, img)
            for name, t in got.items():
                self._put(cache[key][name], t, kind, name, s_max)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)[:, 0]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, cache, lengths


def _place(buf: torch.Tensor, got: torch.Tensor,
           seq: Optional[blocks.SeqShard] = None) -> torch.Tensor:
    """Write a prefill cache entry into the preallocated decode buffer, in
    place and cast to the buffer's dtype: K/V (.., KVH, S, Dh) into
    (.., KVH, S_max, Dh) at offset 0; an entry of the buffer's own shape
    (a recurrent state, a full local ring, the image K/V) over all of it.
    A rank's shard of a sequence-split cache (``seq``) takes the positions
    it holds."""
    if seq is not None:
        got = got[..., seq.offset:seq.offset + buf.shape[-2], :]
    buf[tuple(slice(0, n) for n in got.shape)].copy_(got)
    return buf
