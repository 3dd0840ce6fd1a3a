"""Serving entry point: batched prefill + decode of a batch of requests.

Port of `repro.launch.serve` on one device: batched prefill, then one
batched decode step per generated token against the preallocated cache
(written in place: K/V, and the recurrent state of recurrentgemma-2b's rec
blocks and rwkv6-7b's rwkv blocks), with greedy or temperature sampling.
``--arch`` takes any architecture at any ``--reduce`` (the MoE ones,
dbrx-132b and llama4-scout-17b-a16e, included) but the VLM: its cross
layers need image embeddings, which ``serve_batch``, as the reference's,
does not take; serve it through ``LM.prefill`` with ``batch["images"]``
and ``LM.decode_step``. Parameters are float32 and
the cache bf16 (recurrent states float32), as the reference's ``main`` and
``prefill`` have them. Float32 matrix products run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default;
``main`` sets it).

``--mesh DxM`` spawns D x M ranks (`repro_torch.distributed.comm`): the
requests' rows split over the D ``data`` ranks, and the M ``model`` ranks
that serve the same rows split the weights and the cache by tensor
parallelism, each holding its shards as `serve_rules` gives them
(`repro_torch.distributed.tensor_parallel`), through the train package's
`build_prefill_step` / `build_decode_step`; the greedy token is the
vocab-parallel argmax, and the tokens are gathered in request order;
rank 0 prints. ``--dist-backend`` names the transport: ``nccl`` (the
default) needs a card per rank, ``gloo`` stages each exchange through
host memory (so several ranks can share one card).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduce 8 \
      --requests 4 --prompt-len 32 --gen 16 [--mesh 2x2 --dist-backend gloo]

Without ``--device cpu`` it runs on the card and raises if there is none.
The weights are drawn from seed 0 on the CPU whatever the device, so the
card and the CPU serve the same model (any ``--reduce``: the card's
attention kernels take every head_dim the reduction gives).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import configs, kernels
from ..device import resolve_device
from ..distributed import comm as dist_comm
from ..distributed import sharding, tensor_parallel
from ..models import LM
from ..models.layers import tree_map
from ..train import steps as train_steps
from .mesh import parse_mesh


def reduce_config(cfg, factor: int):
    """Scale a config down by ~factor in width/depth (CPU-runnable).

    A copy of `repro.launch.train.reduce_config`, kept here so that serving
    does not import the training launcher; `repro_torch.launch.train`
    imports it.
    """
    if factor <= 1:
        return cfg
    pat = len(cfg.pattern)
    n_layers = max(pat, (cfg.n_layers // factor) // pat * pat) + len(cfg.remainder)
    d_model = max(64, cfg.d_model // factor)
    rwkv_head_dim = min(cfg.rwkv_head_dim, 32)
    n_heads = max(2, cfg.n_heads // factor)
    n_kv_heads = max(1, min(cfg.n_kv_heads, n_heads))
    if "rwkv" in cfg.pattern:
        # RWKV projections are (D, D): heads must tile d_model exactly.
        n_heads = max(1, d_model // rwkv_head_dim)
        n_kv_heads = n_heads
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=max(16, cfg.head_dim // factor),
        d_ff=max(128, cfg.d_ff // factor),
        vocab_size=min(cfg.vocab_size, 4096),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        rnn_width=max(64, cfg.rnn_width // factor) if cfg.rnn_width else 0,
        local_window=min(cfg.local_window, 128) if cfg.local_window else 0,
        n_image_tokens=min(cfg.n_image_tokens, 16) if cfg.n_image_tokens else 0,
        rwkv_head_dim=rwkv_head_dim,
    )


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens: argmax at temperature 0, else a
    draw from softmax(logits / temperature) with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def serve_batch(
    lm: LM,
    params,
    prompts: np.ndarray,  # (B, P) token prompts
    gen_tokens: int,
    *,
    temperature: float = 0.0,
    seed: int = 0,
    timings: Optional[dict] = None,
    return_logits: bool = False,
    comm=None,
):
    """Prefill + decode ``gen_tokens`` for a batch on the parameters' device;
    returns (B, gen) int32 tokens (and, with ``return_logits``, the (B, gen,
    V) float32 logits each token was drawn from).

    With a ``timings`` dict, the device is synchronised after the prefill
    and after the last step, and ``prefill_s``, ``decode_s`` and
    ``decode_steps`` are written into it (host clock).

    With ``comm`` (a rank of a mesh, the reference's ``mesh``), the rank
    serves its rows of ``prompts`` (split over the batch axes, as
    ``batch_spec_tree`` shards them) with its shards of ``params``
    (`param_shardings` under `serve_rules`: whole where ``model`` is 1)
    through `build_prefill_step` and `build_decode_step`, as the
    reference's ``serve_batch`` does, and the outputs are all-gathered in
    request order. Where the rows do not divide, the reference's batch
    spec falls back to replication: every rank serves every request, and
    nothing is gathered. Where ``model`` splits the vocab, the greedy
    token is the vocab-parallel argmax and the logits kept for the record
    are all-gathered once per step.
    """
    prompts = np.asarray(prompts)
    s_max = prompts.shape[1] + gen_tokens
    kw = dict(temperature=temperature, seed=seed, timings=timings, return_logits=return_logits)
    if comm is None:
        return _generate(lambda p, b: lm.prefill(p, b, s_max=s_max), lm.decode_step, params,
                         prompts, gen_tokens, **kw)
    rules = sharding.serve_rules("pod" in comm.mesh.shape)
    baxes = sharding.batch_axes(comm.mesh, rules)
    split = prompts.shape[0] % comm.axis_size(baxes) == 0
    if not split:
        rules = {**rules, "batch": None}  # replicated rows: every rank serves them all
    prefill, _ = train_steps.build_prefill_step(lm, comm, rules, s_max=s_max,
                                                batch_size=prompts.shape[0])
    step, _ = train_steps.build_decode_step(lm, comm, rules)
    decode = lambda p, b, c, n: step(p, b, c, n, s_max=s_max)  # noqa: E731
    with sharding.activation_ctx(comm, rules):
        tp = tensor_parallel.split(params["embed"], lm.cfg.vocab_size, 0)
    rows = dist_comm.rank_rows(prompts.shape[0], comm, baxes) if split else slice(None)
    out = _generate(prefill, decode, params, prompts[rows], gen_tokens, vocab=tp, **kw)
    if not split:
        return out
    outs = out if return_logits else (out,)
    gathered = tuple(comm.all_gather(torch.from_numpy(np.ascontiguousarray(o)), baxes).numpy()
                     for o in outs)
    return gathered if return_logits else gathered[0]


def _generate(prefill, decode, params, prompts, gen_tokens, *, temperature, seed, timings,
              return_logits, vocab=None):
    """`serve_batch`'s loop: ``prefill(params, batch)`` and ``decode(params,
    batch, cache, lengths)``, each returning (logits, cache, lengths).
    ``vocab``: the `TensorParallel` whose ranks hold the logits' vocab
    columns, or None where they are whole."""
    device = params["embed"].device
    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(seed)

    def whole(logits):
        return logits if vocab is None else vocab.gather(logits, -1)

    def pick(logits):
        if vocab is not None and temperature <= 0.0:
            return vocab.argmax(logits).to(torch.int32)
        return sample(whole(logits), generator, temperature)

    def sync():
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=device)
    logits, cache, lengths = prefill(params, {"tokens": tokens})
    tok = pick(logits)
    out = [tok]
    seen = [whole(logits)] if return_logits else []
    sync()
    t1 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache, lengths = decode(params, {"tokens": tok[:, None].long()}, cache, lengths)
        tok = pick(logits)
        out.append(tok)
        if return_logits:
            seen.append(whole(logits))
    sync()
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                       decode_steps=gen_tokens - 1)
    tokens_out = torch.stack(out, dim=1).cpu().numpy()
    if return_logits:
        return tokens_out, torch.stack(seen, dim=1).float().cpu().numpy()
    return tokens_out


def _serve_rank(comm, args, record: bool):
    """One rank of ``main``'s ``--mesh`` run: the weights from seed 0 drawn
    on the CPU (every rank the same), its shards of them on its device,
    its rows served."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_config(configs.get_config(args.arch), args.reduce)
    lm = LM(cfg)
    specs = train_steps.param_shardings(lm, comm.mesh, sharding.serve_rules(False))
    params = sharding.shard_tree(lm.init(torch.Generator().manual_seed(0), dtype=torch.float32),
                                 specs, comm.mesh, comm.coords, comm.device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(args.requests, args.prompt_len))
    timings, logits = {}, None
    if record:
        # Timed runs start warm (libraries, allocator): a short serve first,
        # its kernel launches not counted.
        serve_batch(lm, params, prompts[:, :min(64, args.prompt_len)], 4, comm=comm)
        kernels.reset_launch_counts()
    t0 = time.time()
    out = serve_batch(lm, params, prompts, args.gen, temperature=args.temperature,
                      timings=timings if record else None, return_logits=record, comm=comm)
    dt = time.time() - t0
    tokens, logits = out if record else (out, None)
    if comm.rank == 0:
        total = args.requests * args.gen
        print(f"[serve] arch={cfg.name} mesh={comm.mesh.shape} device={comm.device} generated "
              f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s)", flush=True)
        for r in range(min(2, args.requests)):
            print(f"[serve] req{r}: {tokens[r].tolist()}", flush=True)
    # Every rank holds the gathered logits; rank 0's are returned.
    return {"tokens": tokens, "timings": timings, "s": dt,
            "logits": logits if comm.rank == 0 else None}


def main(argv=None, *, record: Optional[dict] = None):
    """Serves the requests; returns the (requests, gen) tokens. With
    ``--mesh`` other than 1x1 and a ``record`` dict, each rank first serves
    a short warm-up, and ``record["ranks"]`` receives each rank's timings
    (prefill and decode seconds, device synchronised), seconds, kernel
    launches (the timed serve's), peak memory and bytes moved, and
    ``record["transport"]`` the transport. On any mesh, a ``record`` dict
    also receives ``record["logits"]``: the (requests, gen, V) float32
    logits the tokens were drawn from."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: DATA ranks split the requests, MODEL ranks the weights")
    ap.add_argument("--dist-backend", default="nccl", choices=dist_comm.BACKENDS,
                    help="transport between the ranks of a --mesh run")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh)
    if mesh.size > 1:
        recs = dist_comm.run_ranks(_serve_rank, mesh, args, record is not None,
                                   backend=args.dist_backend, device=args.device)
        if record is not None:
            record["transport"] = dist_comm.transport_name(args.dist_backend, args.device,
                                                           mesh.size)
            record["ranks"] = [{"timings": r["result"]["timings"], "s": r["result"]["s"],
                                **{k: r[k] for k in ("launches", "decode_lse_launches",
                                                     "max_memory_allocated", "comm_bytes")}}
                               for r in recs]
            record["logits"] = recs[0]["result"]["logits"]
        return recs[0]["result"]["tokens"]

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 projections stay f32
    cfg = reduce_config(configs.get_config(args.arch), args.reduce)
    lm = LM(cfg)
    # Drawn on the CPU and moved, so that every device serves the same weights.
    params = tree_map(lambda t: t.to(device),
                      lm.init(torch.Generator().manual_seed(0), dtype=torch.float32))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.requests, args.prompt_len))

    t0 = time.time()
    tokens = serve_batch(lm, params, prompts, args.gen, temperature=args.temperature,
                         return_logits=record is not None)
    dt = time.time() - t0
    if record is not None:
        tokens, record["logits"] = tokens
    total = args.requests * args.gen
    print(f"[serve] arch={cfg.name} device={device} generated {total} tokens in "
          f"{dt:.2f}s ({total/dt:.1f} tok/s)")
    for r in range(min(2, args.requests)):
        print(f"[serve] req{r}: {tokens[r].tolist()}")
    return tokens


if __name__ == "__main__":
    main()
