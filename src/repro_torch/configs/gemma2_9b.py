"""gemma2-9b [dense]: alternating local(4096)/global attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) head_dim=256 d_ff=14336 vocab=256000
[arXiv:2408.00118; hf].  Attention softcap 50, final softcap 30, sandwich
norms, sqrt(d) embedding scale, query scale (d_model/n_heads)^-0.5.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_logit_scale=(3584 / 16) ** -0.5,
    mlp_kind="geglu",
    pos_kind="rope",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    post_norm=True,
    emb_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, window=16, attn_logit_scale=None, max_seq=128,
    flash_q_block=16, flash_kv_block=16, dtype="float32",
)
