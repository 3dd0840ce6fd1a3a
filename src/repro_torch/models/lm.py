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
counterpart: a rank computes on its own rows. Under
`repro_torch.distributed.sharding.activation_ctx` (a rank of a mesh),
``loss`` divides the rank's masked CE sum by the count over the global
batch (all-reduced over the batch axes), so the ranks' losses add up to
the reference's mean over the global batch, whatever each shard's mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed import sharding
from . import blocks
from .layers import Param, init_params, rms_norm, stack_specs, tree_map


@dataclasses.dataclass
class LM:
    cfg: ArchConfig

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

    def _embed(self, params, batch):
        if self.cfg.embed_inputs:
            return batch["embeds"]  # (B, S, D) frontend stub
        return params["embed"][batch["tokens"]]

    def _logits(self, params, x):
        head = params["embed"].T if self.cfg.tie_embeddings else params["head"]
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
        """(B, S) tokens (+ images) -> (B, S, D) after the final norm."""
        cfg = self.cfg
        x = self._embed(params, batch)
        img = self._images(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for layer_p in self._layers(params):
            if remat:
                x = checkpoint(self._superblock, x, layer_p, positions, img, use_reentrant=False)
            else:
                x = self._superblock(x, layer_p, positions, img)
        for j, kind in enumerate(cfg.remainder):
            x, _ = blocks.apply_block_seq(kind, cfg, params[f"rem{j}_{kind}"], x, positions, img)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

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
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, tgt_c[..., None])[..., 0]
            m = m_c.float()
            return ((logz - gold) * m).sum(), m.sum()

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

        return self._cache_tree(batch, s_max, zeros)

    def cache_spec_tree(self, batch: int, s_max: int):
        """Meta tensors shaped as `init_cache`'s (nothing is allocated)."""
        return self._cache_tree(batch, s_max,
                                lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"))

    def _cache_tree(self, batch: int, s_max: int, make):
        """The cache's structure, each entry ``make(shape, dtype)``."""
        cfg = self.cfg
        cache: Dict[str, Any] = {"blocks": {}}
        for i, kind in enumerate(cfg.pattern):
            spec = blocks.cache_spec(kind, cfg, batch, s_max)
            cache["blocks"][f"pos{i}_{kind}"] = {
                k: make((cfg.n_superblocks,) + shape, dt) for k, (shape, dt) in spec.items()
            }
        for j, kind in enumerate(cfg.remainder):
            spec = blocks.cache_spec(kind, cfg, batch, s_max)
            cache[f"rem{j}_{kind}"] = {k: make(shape, dt) for k, (shape, dt) in spec.items()}
        return cache

    def decode_step(self, params, batch, cache, lengths):
        """One new token for every sequence in the batch.

        batch: {"tokens": (B, 1)} or {"embeds": (B, 1, D)}; cross layers read
        the image K/V that ``prefill`` cached. Returns (logits (B, V), cache,
        lengths + 1);
        every block writes its cache entries in place, so the blocks'
        returned dicts are the cache's own tensors and are not read.
        """
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = lengths[:, None]  # (B, 1)
        for l, layer_p in enumerate(self._layers(params)):
            for i, kind in enumerate(cfg.pattern):
                key = f"pos{i}_{kind}"
                layer_c = {name: t[l] for name, t in cache["blocks"][key].items()}
                x, _ = blocks.apply_block_decode(
                    kind, cfg, layer_p[key], x, positions, layer_c, lengths
                )
        for j, kind in enumerate(cfg.remainder):
            key = f"rem{j}_{kind}"
            x, _ = blocks.apply_block_decode(
                kind, cfg, params[key], x, positions, cache[key], lengths
            )
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)[:, 0]
        return logits, cache, lengths + 1

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
                    _place(cache["blocks"][key][name][l], t)
        for j, kind in enumerate(cfg.remainder):
            key = f"rem{j}_{kind}"
            x, got = blocks.apply_block_seq(kind, cfg, params[key], x, positions, img)
            for name, t in got.items():
                _place(cache[key][name], t)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)[:, 0]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, cache, lengths


def _place(buf: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """Write a prefill cache entry into the preallocated decode buffer, in
    place and cast to the buffer's dtype: K/V (.., KVH, S, Dh) into
    (.., KVH, S_max, Dh) at offset 0; an entry of the buffer's own shape
    (a recurrent state, a full local ring, the image K/V) over all of it."""
    buf[tuple(slice(0, n) for n in got.shape)].copy_(got)
    return buf
