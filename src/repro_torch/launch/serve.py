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
``main`` sets it). Multi-device serving (the reference's ``--mesh``) is a
ROADMAP item.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduce 8 \
      --requests 4 --prompt-len 32 --gen 16

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

from .. import configs
from ..device import resolve_device
from ..models import LM
from ..models.layers import tree_map


def reduce_config(cfg, factor: int):
    """Scale a config down by ~factor in width/depth (CPU-runnable).

    A copy of `repro.launch.train.reduce_config`, kept here so that serving
    pulls in no training module; `repro_torch.launch.train` imports it.
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
):
    """Prefill + decode ``gen_tokens`` for a batch on the parameters' device;
    returns (B, gen) int32 tokens (and, with ``return_logits``, the (B, gen,
    V) float32 logits each token was drawn from).

    With a ``timings`` dict, the device is synchronised after the prefill
    and after the last step, and ``prefill_s``, ``decode_s`` and
    ``decode_steps`` are written into it (host clock).
    """
    device = params["embed"].device
    B, P = prompts.shape
    s_max = P + gen_tokens
    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(seed)

    def sync():
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=device)
    logits, cache, lengths = lm.prefill(params, {"tokens": tokens}, s_max=s_max)
    tok = sample(logits, generator, temperature)
    out = [tok]
    seen = [logits] if return_logits else []
    sync()
    t1 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache, lengths = lm.decode_step(
            params, {"tokens": tok[:, None].long()}, cache, lengths
        )
        tok = sample(logits, generator, temperature)
        out.append(tok)
        if return_logits:
            seen.append(logits)
    sync()
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                       decode_steps=gen_tokens - 1)
    tokens_out = torch.stack(out, dim=1).cpu().numpy()
    if return_logits:
        return tokens_out, torch.stack(seen, dim=1).float().cpu().numpy()
    return tokens_out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

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
    tokens = serve_batch(lm, params, prompts, args.gen, temperature=args.temperature)
    dt = time.time() - t0
    total = args.requests * args.gen
    print(f"[serve] arch={cfg.name} device={device} generated {total} tokens in "
          f"{dt:.2f}s ({total/dt:.1f} tok/s)")
    for r in range(min(2, args.requests)):
        print(f"[serve] req{r}: {tokens[r].tolist()}")
    return tokens


if __name__ == "__main__":
    main()
