"""Plain PyTorch versions of the SSD chunked-scan kernel: ``ssd_ref``, the
function itself, and ``ssd_state_passing_ref``, the kernel's decomposition
into chunk states, a state pass and outputs (used by tests only)."""
import torch
import torch.nn.functional as F

from repro_torch.models import ssm  # a module import: ssm imports this package too


def ssd_ref(x, dt, a_coef, bmat, cmat, *, chunk: int, h0=None):
    """Model layout: x (B,S,H,P); dt (B,S,H); a_coef (H,); b/c (B,S,H,N);
    h0 (B,H,P,N) or None → (y (B,S,H,P), h_final (B,H,P,N) f32)."""
    return ssm.ssd_chunk_scan(x, dt, a_coef, bmat, cmat, chunk, h0=h0)


def ssd_state_passing_ref(x, dt, a_coef, bmat, cmat, *, chunk: int, h0=None,
                          shared_cb: bool = False):
    """``ssd_ref`` computed as ``csrc/ssd_chunk.cu`` splits it, in f32.  For
    every chunk at once, cs is the prefix sum of dt·a and the chunk's own
    end state is s_c = Σ_m x_mᵀ (B_m dt_m exp(cs_L − cs_m)); the pass
    h_c = exp(cs_L) h_{c−1} + s_c from h0 (or zero) keeps each chunk's
    starting state; then y_l = exp(cs_l) C_l·h_startᵀ + Σ_{m≤l} G_lm
    exp(cs_l − cs_m) dt_m x_m with G = C·Bᵀ, formed once per (batch, chunk)
    from head 0's B and C when ``shared_cb`` (B and C the same for every
    head), else per head.  Positions past S act as dt = 0."""
    b, s, h, p = x.shape
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    f32, out_dtype = torch.float32, x.dtype
    x, dt, bmat, cmat = (t.to(f32) for t in (x, dt, bmat, cmat))
    if pad:
        x, bmat, cmat = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bmat, cmat))
        dt = F.pad(dt, (0, 0, 0, pad))
    xc = x.reshape(b, nc, chunk, h, p)
    bc, cc = (t.reshape(b, nc, chunk, h, -1) for t in (bmat, cmat))
    dtc = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)             # (b, nc, h, L)
    cs = torch.cumsum(dtc * a_coef.to(f32)[None, None, :, None], -1)   # (b, nc, h, L)
    total = cs[..., -1]                                                 # (b, nc, h)
    # chunk states
    w = dtc * torch.exp(total[..., None] - cs)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", bc, w, xc)
    # state passing
    hcur = (torch.zeros(b, h, p, bmat.shape[-1], dtype=f32, device=x.device) if h0 is None
            else h0.to(f32))
    starts = []
    for c in range(nc):
        starts.append(hcur)
        hcur = torch.exp(total[:, c])[..., None, None] * hcur + states[:, c]
    hstart = torch.stack(starts, 1)                                     # (b, nc, h, p, n)
    # outputs
    if shared_cb:
        g = torch.einsum("bcln,bcmn->bclm", cc[:, :, :, 0], bc[:, :, :, 0])[:, :, None]
    else:
        g = torch.einsum("bclhn,bcmhn->bchlm", cc, bc)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal, torch.exp(cs[..., :, None] - cs[..., None, :]),
                        torch.zeros((), dtype=f32, device=x.device))
    scores = g * decay * dtc[..., None, :]
    y = (torch.einsum("bclhn,bchpn,bchl->bclhp", cc, hstart, torch.exp(cs))
         + torch.einsum("bchlm,bcmhp->bclhp", scores, xc))
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(out_dtype), hcur
