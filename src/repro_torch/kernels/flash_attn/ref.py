"""Plain PyTorch version of the flash attention kernel."""
from repro_torch.models.attention import dense_attention


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: (B, Sq, H, dk); k: (B, Sk, K, dk); v: (B, Sk, K, dv) → (B, Sq, H,
    dv); query position i sits at key position i (no offset), as in the
    kernel; ``scale`` defaults to dk^-1/2."""
    return dense_attention(q, k, v, causal=causal, window=window, scale=scale)
