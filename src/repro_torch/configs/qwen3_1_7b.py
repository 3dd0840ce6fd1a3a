"""qwen3-1.7b [dense]: 28L d2048 16H (GQA kv=8) ff6144 V151936.
qk_norm, GQA, head_dim 128 (Qwen3 family). [hf:Qwen/Qwen3-8B; hf]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
        pattern=("dense",),
        rope_theta=1e6,
    )
)
