"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680 V256000.
RG-LRU + local attention, 1 attn : 2 recurrent; window 2048; head_dim 256.
[arXiv:2402.19427; hf]"""

from . import register
from .base import ArchConfig

CONFIG = register(
    ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,  # 8 x (rec, rec, local_attn) + (rec, rec)
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        pattern=("rec", "rec", "local_attn"),
        rnn_width=2560,
        conv_width=4,
        local_window=2048,
        activation="gelu",
        subquadratic=True,  # bounded window + O(1) recurrent state
        tie_embeddings=True,
    )
)
