"""Jamba-v0.1-52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]

Deviation note: Jamba v0.1 uses the Mamba-1 selective scan; the mamba
layers here are the Mamba-2 SSD formulation (matmul form), as in the JAX
package.
"""
from repro_torch.configs.base import LK, MoEConfig, ModelConfig, SSMConfig, SparseAttnConfig, Stage, register

# 8-layer repeating block: attention at position 0, mamba elsewhere; MoE on
# odd positions (every other layer → 16 MoE layers over 32).
_PATTERN = (
    LK("attn", "mlp"),
    LK("mamba", "moe"),
    LK("mamba", "mlp"),
    LK("mamba", "moe"),
    LK("mamba", "mlp"),
    LK("mamba", "moe"),
    LK("mamba", "mlp"),
    LK("mamba", "moe"),
)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    stages=(Stage(_PATTERN, repeats=4),),  # 32 layers
    act="swiglu",
    norm="rms",
    pos="rope",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336),
    ssm=SSMConfig(state=64, headdim=64, expand=2, chunk=256, conv_width=4),
    sparse_attn=SparseAttnConfig(),
    source="arXiv:2403.19887",
))
