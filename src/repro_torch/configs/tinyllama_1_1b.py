"""TinyLlama-1.1B — llama2-arch small dense model. [arXiv:2401.02385]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    stages=(Stage((LK("attn", "mlp"),), repeats=22),),
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=10_000.0,
    # Paper technique: block-sparse attention variant available → long_500k legal.
    sparse_attn=SparseAttnConfig(),
    source="arXiv:2401.02385",
))
