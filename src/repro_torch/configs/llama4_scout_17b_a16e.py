"""llama4-scout-17b-a16e [moe]: 48L d5120 40H (GQA kv=8) expert_ff8192
V202048, MoE 16 experts top-1 + shared expert, every layer MoE.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        head_dim=128,
        pattern=("moe",),
        n_experts=16,
        experts_per_token=1,
        shared_expert=True,
        rope_theta=5e5,
    )
)
