"""Llama-3.2-1B — small llama3 dense model. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    stages=(Stage((LK("attn", "mlp"),), repeats=16),),
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=500_000.0,
    tie_embeddings=True,
    sparse_attn=SparseAttnConfig(),
    source="hf:meta-llama/Llama-3.2-1B",
))
