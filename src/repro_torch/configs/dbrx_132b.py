"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import LK, MoEConfig, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,          # per-expert hidden width
    vocab_size=100352,
    stages=(Stage((LK("attn", "moe"),), repeats=40),),
    act="swiglu",
    norm="ln",
    pos="rope",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752),
    sparse_attn=SparseAttnConfig(),
    source="hf:databricks/dbrx-base",
))
