"""Mamba2-1.3B — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060]"""
from repro_torch.configs.base import LK, ModelConfig, SSMConfig, Stage, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=0,            # attention-free
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,               # mamba2 blocks have no separate MLP
    vocab_size=50280,
    stages=(Stage((LK("mamba", "none"),), repeats=48),),
    norm="rms",
    pos="rope",           # unused by the mamba mixer
    tie_embeddings=True,
    ssm=SSMConfig(state=128, headdim=64, expand=2, chunk=256, conv_width=4),
    source="arXiv:2405.21060",
))
