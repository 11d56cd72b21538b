"""musicgen-medium [audio]: decoder-only over EnCodec tokens.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec frontend is a STUB per the assignment: EnCodec tokens ARE the
vocabulary (2048 codes); sinusoidal positions, LayerNorm, GELU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_kind="gelu",
    pos_kind="sinusoidal",
    norm_kind="layernorm",
    tie_embeddings=False,
    modality="audio",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, max_seq=128, flash_q_block=16, flash_kv_block=16,
    dtype="float32",
)
