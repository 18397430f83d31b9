"""InternVL2-26B — VLM: InternViT-6B (STUB) + InternLM2-20B language decoder.
input_specs provides 256 patch embeddings at ViT width 3200; the trainable
projector maps them to d_model.  [arXiv:2404.16821]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    stages=(Stage((LK("attn", "mlp"),), repeats=48),),
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=1_000_000.0,
    n_prefix_tokens=256,
    prefix_dim=3200,
    sparse_attn=SparseAttnConfig(),
    source="arXiv:2404.16821",
))
