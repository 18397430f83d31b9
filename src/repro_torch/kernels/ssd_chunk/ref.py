"""Plain PyTorch version of the SSD chunked-scan kernel."""
from repro_torch.models import ssm  # a module import: ssm imports this package too


def ssd_ref(x, dt, a_coef, bmat, cmat, *, chunk: int, h0=None):
    """Model layout: x (B,S,H,P); dt (B,S,H); a_coef (H,); b/c (B,S,H,N);
    h0 (B,H,P,N) or None → (y (B,S,H,P), h_final (B,H,P,N) f32)."""
    return ssm.ssd_chunk_scan(x, dt, a_coef, bmat, cmat, chunk, h0=h0)
