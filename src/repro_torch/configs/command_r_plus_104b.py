"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) ff33792 V256000.
GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        head_dim=128,
        pattern=("dense",),
    )
)
