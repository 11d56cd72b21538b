"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427; hf].
Pattern (rglru, rglru, local) x 8 + (rglru, rglru) tail; window 2048;
GeGLU MLP; gemma-style sqrt(d) embedding scaling.  Sub-quadratic (bounded
attention range) => runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    rnn_width=2560,
    mlp_kind="geglu",
    pos_kind="rope",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    emb_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    rnn_width=64, vocab_size=512, window=16, max_seq=128, flash_q_block=16,
    flash_kv_block=16, dtype="float32",
)
