"""DeepSeek-67B — llama-arch large dense model. [arXiv:2401.02954]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    stages=(Stage((LK("attn", "mlp"),), repeats=95),),
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=10_000.0,
    sparse_attn=SparseAttnConfig(),
    source="arXiv:2401.02954",
))
