"""Gemma3-12B — dense, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt (family card, 12B point in the series)]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

_PATTERN = (LK("local", "mlp"),) * 5 + (LK("attn", "mlp"),)

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=240,
    d_ff=15360,
    vocab_size=262144,
    stages=(Stage(_PATTERN, repeats=8),),  # 48 layers
    window=1024,
    act="geglu",
    norm="rms",
    pos="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    sparse_attn=SparseAttnConfig(),  # applied to the global layers for long ctx
    source="hf:google/gemma-3-1b-pt",
))
