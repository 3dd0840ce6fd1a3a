"""rwkv6-7b [ssm]: 32L d4096 (attention-free) ff14336 V65536.
Finch: data-dependent decay linear recurrence. [arXiv:2404.05892; hf]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,  # 4096 / rwkv_head_dim
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        head_dim=64,
        rwkv_head_dim=64,
        pattern=("rwkv",),
        subquadratic=True,  # O(1) state per token => long_500k runs
    )
)
