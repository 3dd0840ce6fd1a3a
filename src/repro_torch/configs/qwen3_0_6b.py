"""qwen3-0.6b [dense]: 28L d1024 16H (GQA kv=8) ff3072 V151936.
qk_norm, GQA, head_dim 128 (Qwen3 family). [hf:Qwen/Qwen3-8B; hf]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
        pattern=("dense",),
        rope_theta=1e6,
        tie_embeddings=True,
    )
)
