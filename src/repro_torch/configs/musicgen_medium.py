"""musicgen-medium [audio]: 48L d1536 24H (MHA kv=24) ff6144 V2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
input_specs provide precomputed frame embeddings. [arXiv:2306.05284; hf]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        head_dim=64,
        activation="gelu",
        pattern=("dense",),
        embed_inputs=True,  # frontend stub: (B, S, d_model) frame embeddings
    )
)
