"""granite-20b [dense]: 52L d6144 48H (MQA kv=1) ff24576 V49152.
llama-arch, code model. [arXiv:2405.04324; hf]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        head_dim=128,
        activation="gelu",  # granite-20b-code uses gpt-bigcode-style MLP
        pattern=("dense",),
    )
)
