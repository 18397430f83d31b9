"""Plain PyTorch version of the flash attention kernel."""
from repro_torch.models.attention import dense_attention


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) → (B, Sq, H, hd); query
    position i sits at key position i (no offset), as in the kernel."""
    return dense_attention(q, k, v, causal=causal, window=window)
