"""internvl2-2b [vlm]: InternViT frontend (stub) + InternLM2-1.8B decoder.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821; hf].
The ViT is a modality STUB per the assignment: input_specs() provides
precomputed patch embeddings (batch, 256, d_model) scattered over the first
positions of the sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    pattern=("attn",),
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=False,
    modality="vlm",
    prefix_len=256,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, prefix_len=8, max_seq=128, flash_q_block=16,
    flash_kv_block=16, dtype="float32",
)
