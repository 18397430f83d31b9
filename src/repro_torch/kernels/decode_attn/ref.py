"""Plain PyTorch version of the flash-decode kernel."""
from repro_torch.models.attention import decode_attention


def decode_ref(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
               sparse=None):
    """q: (B,1,H,hd); caches (B,Sc,K,hd); positions < cache_len are valid
    (and, with ``sparse``, in an active block)."""
    return decode_attention(q, k_cache, v_cache, cache_len, window=window,
                            sparse=sparse)
