"""Plain PyTorch version of the block-sparse attention kernel."""
from repro_torch.models.attention import block_sparse_attention


def block_sparse_ref(q, k, v, cfg, *, q_offset: int = 0, scale=None):
    """q: (B, Sq, H, dk); k: (B, Sk, K, dk); v: (B, Sk, K, dv) → (B, Sq, H,
    dv): causal attention over the active kv blocks of ``cfg``'s static
    pattern; ``scale`` defaults to dk^-1/2."""
    return block_sparse_attention(q, k, v, cfg, q_offset=q_offset, scale=scale)
