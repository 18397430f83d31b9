"""GPT-2 small — the paper's own PFIT policy model. [Radford et al. 2019]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="gpt2-small",
    family="dense",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50257,
    stages=(Stage((LK("attn", "mlp"),), repeats=12),),
    act="gelu",
    norm="ln",
    pos="learned",
    max_position=1024,
    tie_embeddings=True,
    # paper: 40% sparse attention during PFIT
    sparse_attn=SparseAttnConfig(head_sparsity=0.4),
    source="Radford et al., 2019 (GPT-2)",
))
