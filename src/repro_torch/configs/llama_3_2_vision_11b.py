"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) ff14336 V128256.
Cross-attention image layers every 5th layer; the vision tower is a STUB —
input_specs provide precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        head_dim=128,
        pattern=("dense", "dense", "dense", "cross", "dense"),
        n_image_tokens=1601,  # 1 tile x (40x40 patches + cls), stubbed
        rope_theta=5e5,
    )
)
