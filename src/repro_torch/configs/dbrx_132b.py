"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) expert_ff10752 V100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        head_dim=128,
        pattern=("moe",),
        n_experts=16,
        experts_per_token=4,
        rope_theta=5e5,
    )
)
