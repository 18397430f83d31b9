"""DeepSeek-V2-236B — MLA (kv_lora=512) + fine-grained MoE, 2 shared + 160
routed experts top-6.  First layer uses a dense FF (separate prologue stage).
[arXiv:2405.04434]"""
from repro_torch.configs.base import LK, MLAConfig, MoEConfig, ModelConfig, SparseAttnConfig, Stage, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA: effectively MHA over the compressed cache
    head_dim=128,
    d_ff=12288,           # dense FF width for the first (non-MoE) layer
    vocab_size=102400,
    stages=(
        Stage((LK("mla", "mlp"),), repeats=1),
        Stage((LK("mla", "moe"),), repeats=59),
    ),
    act="swiglu",
    norm="rms",
    pos="rope",
    moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536, n_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    sparse_attn=SparseAttnConfig(),
    source="arXiv:2405.04434",
))
