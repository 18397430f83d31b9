"""Plain PyTorch version of the block-sparse attention kernel."""
from repro_torch.models.attention import block_sparse_attention


def block_sparse_ref(q, k, v, cfg, *, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) → (B, Sq, H, hd): causal
    attention over the active kv blocks of ``cfg``'s static pattern."""
    return block_sparse_attention(q, k, v, cfg, q_offset=q_offset)
