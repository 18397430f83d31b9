"""Whisper-base — encoder-decoder; conv/mel frontend is a STUB (input_specs
provides post-conv frame embeddings).  6 encoder + 6 decoder layers.
[arXiv:2212.04356]"""
from repro_torch.configs.base import LK, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    stages=(
        Stage((LK("enc", "mlp"),), repeats=6, stream="encoder"),
        Stage((LK("dec", "mlp"),), repeats=6, stream="decoder"),
    ),
    act="gelu",
    norm="ln",
    pos="learned",
    max_position=524_288 + 8,  # stress shapes exceed whisper's native 448
    encoder_seq=1500,          # post-conv frames for 30s audio
    sparse_attn=SparseAttnConfig(),
    source="arXiv:2212.04356",
))
