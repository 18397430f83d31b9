"""RoBERTa-base — the paper's own PFTT backbone (encoder-only classifier,
AG-News 4 classes). [arXiv:1907.11692]"""
from repro_torch.configs.base import LK, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="roberta-base",
    family="encoder",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50265,
    stages=(Stage((LK("enc", "mlp"),), repeats=12, stream="encoder"),),
    act="gelu",
    norm="ln",
    pos="learned",
    max_position=514,
    n_classes=4,  # AG-News
    source="arXiv:1907.11692",
))
