"""Mamba-2 SSD (state-space duality) mixer — the port of
``repro.models.ssm``.

Sequence mode is the chunked SSD scan: ``ssd_chunk_scan`` here is its plain
PyTorch version (the oracle and the CPU path); the model's hot path runs the
hand-written kernel behind ``repro_torch.kernels.ssd_chunk.ops.ssd_scan``.
Decode is the O(1) recurrent update ``ssd_decode_step`` in plain PyTorch.

Factored LoRA: ``mamba_seq`` and ``mamba_decode`` take an optional
``lora`` subtree with ``{'a','b','mask'}`` factors on ``in_proj`` and/or
``out_proj`` and run those projections through ``peft.lora_proj`` (the
fused LoRA kernel), so the shared base is never merged per client.

``mamba_seq_sp`` is the sequence-parallel mixer of a (data, model) mesh's
training step (the ``mamba_sp`` option).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models.norms import rmsnorm
from repro_torch.models.peft import lora_proj
from repro_torch.sharding import copy_to, gather, scatter


def _lf(lora, key):
    """One leaf's factor dict from the mixer side channel (None-safe)."""
    return None if lora is None else lora.get(key)


def segsum(a):
    """a: (..., L) → (..., L, L) with out[i,j] = sum_{k=j+1..i} a_k (i ≥ j),
    -inf above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunk_scan(x, dt, a_coef, b_mat, c_mat, chunk: int, h0=None):
    """Chunked SSD scan, f32 arithmetic.

    x:     (B, S, H, P)   per-head inputs
    dt:    (B, S, H)      post-softplus step sizes
    a_coef:(H,)           negative decay coefficients (= -exp(A_log))
    b_mat: (B, S, H, N)   input projections (groups already broadcast)
    c_mat: (B, S, H, N)   output projections
    h0:    (B, H, P, N)   initial state (zero when None)
    Returns y (B, S, H, P) in x's dtype and h_final (B, H, P, N) f32.  A
    length that is not a multiple of the chunk is padded with dt = 0
    positions: decay exp(0) = 1 and no input, so the state passes through
    and the padded outputs are dropped.
    """
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    s_orig, out_dtype = s, x.dtype
    f32 = torch.float32
    x, dt, b_mat, c_mat = (t.to(f32) for t in (x, dt, b_mat, c_mat))
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // chunk

    def resh(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = resh(x), resh(dt), resh(b_mat), resh(c_mat)
    hprev = (torch.zeros(b, h, p, n, dtype=f32, device=x.device) if h0 is None
             else h0.to(f32))
    a = a_coef.to(f32)
    ys = []
    for j in range(nc):
        xk, dtk, bk, ck = xc[:, j], dtc[:, j], bc[:, j], cc[:, j]   # (b, L, h, ...)
        adt = (dtk * a[None, None, :]).transpose(1, 2)              # (b, h, L)
        cs = torch.cumsum(adt, -1)
        # intra-chunk (masked attention-like term)
        ss = torch.exp(segsum(adt))                                  # (b, h, L, L)
        scores = torch.einsum("blhn,bmhn->bhlm", ck, bk)
        scores = scores * ss * dtk.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhlm,bmhp->blhp", scores, xk)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("blhn,bhpn,bhl->blhp", ck, hprev, torch.exp(cs))
        # state update
        total = cs[..., -1]                                          # (b, h)
        decay_out = torch.exp(total[..., None] - cs)                 # (b, h, L)
        contrib = bk * (dtk * decay_out.transpose(1, 2))[..., None]  # (b, L, h, n)
        hprev = (torch.exp(total)[..., None, None] * hprev
                 + torch.einsum("blhn,blhp->bhpn", contrib, xk))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, s, h, p)[:, :s_orig]
    return y.to(out_dtype), hprev


def ssd_decode_step(xt, dtt, a_coef, bt, ct, hprev):
    """Single-token recurrence.  xt: (B,H,P); dtt: (B,H); bt/ct: (B,H,N);
    hprev: (B,H,P,N) f32 → (y (B,H,P) in xt's dtype, hnew f32)."""
    dtf = dtt.float()
    ad = torch.exp(dtf * a_coef.float()[None, :])                       # (B,H)
    hnew = (ad[..., None, None] * hprev
            + torch.einsum("bhp,bhn,bh->bhpn", xt.float(), bt.float(), dtf))
    y = torch.einsum("bhpn,bhn->bhp", hnew, ct.float())
    return y.to(xt.dtype), hnew


# ---------------------------------------------------------------------------
# Full mamba2 mixer (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------


def init_mamba(normal, d_model: int, cfg, dtype, device, lead=()):
    """The mixer params at the JAX package's shapes and scales, each leaf
    with the leading axes ``lead`` (a layer stack's repeats);
    ``normal(shape, std)`` draws the random leaves.  ``a_log``, ``d_skip``
    and ``dt_bias`` stay f32 whatever the model dtype, as in the JAX
    package."""
    d_in = cfg.expand * d_model
    h = d_in // cfg.headdim
    conv_dim = d_in + 2 * cfg.n_groups * cfg.state
    proj_out = 2 * d_in + 2 * cfg.n_groups * cfg.state + h

    def const(fill, shape, dt):
        return torch.full((*lead, *shape), fill, dtype=dt, device=device)

    return {
        "in_proj": normal((*lead, d_model, proj_out), d_model ** -0.5),
        "conv_w": normal((*lead, cfg.conv_width, conv_dim), cfg.conv_width ** -0.5),
        "conv_b": const(0.0, (conv_dim,), dtype),
        "a_log": const(0.0, (h,), torch.float32),
        "d_skip": const(1.0, (h,), torch.float32),
        "dt_bias": const(0.0, (h,), torch.float32),
        "gate_norm": {"scale": const(0.0, (d_in,), dtype)},
        "out_proj": normal((*lead, d_in, d_model), d_in ** -0.5),
    }


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv as shifted sums.  xbc: (B,S,C); w: (W,C).
    (``F.conv1d`` would go through cuDNN, which runs f32 as TF32 by
    default.)"""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None]
              for i in range(width))
    return out + bias[None, None]


def _split_proj(zxbcdt, d_in, g_n, h):
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * g_n]
    dt_raw = zxbcdt[..., -h:]
    return z, xbc, dt_raw


def _heads(t, groups: int, h: int):
    """(…, G·N) → (…, H, N), head h reading group h // (H/G).  With one
    group this is a stride-0 view, not a copy."""
    *lead, gn = t.shape
    n = gn // groups
    t = t.reshape(*lead, groups, 1, n).expand(*lead, groups, h // groups, n)
    return t.reshape(*lead, h, n)


def _gate_out(y, z, p, eps, lora, scale, dtype):
    """Gated RMS norm and the output projection."""
    y = rmsnorm((y.float() * F.silu(z.float())).to(dtype),
                p["gate_norm"]["scale"], eps)
    return lora_proj(y, p["out_proj"], _lf(lora, "out_proj"), scale=scale)


def mamba_seq(x, p, cfg, d_model: int, eps: float, h0=None, conv0=None,
              lora=None, scale: float = 1.0):
    """Full-sequence mamba2 mixer.  x (B, S, d) → (y, (h_final, conv_state)):
    the SSM state (B, H, P, N) f32 and the last W-1 conv inputs (B, W-1, C)
    that seed a decode cache."""
    b, s, _ = x.shape
    d_in = cfg.expand * d_model
    h = d_in // cfg.headdim
    g_n = cfg.n_groups * cfg.state
    zxbcdt = lora_proj(x, p["in_proj"], _lf(lora, "in_proj"), scale=scale)
    z, xbc, dt_raw = _split_proj(zxbcdt, d_in, g_n, h)
    if conv0 is not None:
        xbc_ext = torch.cat([conv0, xbc], 1)
        conv_out = _causal_conv(xbc_ext, p["conv_w"], p["conv_b"])[:, conv0.shape[1]:]
    else:
        conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    w1 = cfg.conv_width - 1
    conv_state = torch.cat([xbc.new_zeros(b, w1, xbc.shape[-1]), xbc], 1)[:, s:s + w1]
    xbc = F.silu(conv_out)
    xs = xbc[..., :d_in].reshape(b, s, h, cfg.headdim)
    bmat = _heads(xbc[..., d_in:d_in + g_n], cfg.n_groups, h)
    cmat = _heads(xbc[..., d_in + g_n:], cfg.n_groups, h)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
    a_coef = -torch.exp(p["a_log"])
    y, h_final = ssd_ops.ssd_scan(xs, dt, a_coef, bmat, cmat, chunk=cfg.chunk,
                                  h0=h0)
    y = y + (p["d_skip"][None, None, :, None] * xs.float()).to(y.dtype)
    y = _gate_out(y.reshape(b, s, d_in), z, p, eps, lora, scale, x.dtype)
    return y, (h_final, conv_state)


def mamba_decode(x, p, cfg, d_model: int, eps: float, h_state, conv_state,
                 lora=None, scale: float = 1.0):
    """Single-token mamba2 step.  x: (B,1,d) → (y (B,1,d), (h, conv)): the
    new state and the new last W-1 conv inputs."""
    b = x.shape[0]
    d_in = cfg.expand * d_model
    h = d_in // cfg.headdim
    g_n = cfg.n_groups * cfg.state
    zxbcdt = lora_proj(x[:, 0], p["in_proj"], _lf(lora, "in_proj"), scale=scale)
    z, xbc_t, dt_raw = _split_proj(zxbcdt, d_in, g_n, h)
    # conv ring: conv_state holds the previous (W-1) inputs
    window = torch.cat([conv_state, xbc_t[:, None]], 1)             # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv_out)
    xs = xbc[..., :d_in].reshape(b, h, cfg.headdim)
    bmat = _heads(xbc[..., d_in:d_in + g_n], cfg.n_groups, h)
    cmat = _heads(xbc[..., d_in + g_n:], cfg.n_groups, h)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None])
    a_coef = -torch.exp(p["a_log"])
    y, hnew = ssd_decode_step(xs, dt, a_coef, bmat, cmat, h_state)
    y = y + (p["d_skip"][None, :, None] * xs.float()).to(y.dtype)
    y = _gate_out(y.reshape(b, d_in), z, p, eps, lora, scale, x.dtype)
    return y[:, None], (hnew, window[:, 1:])


# ---------------------------------------------------------------------------
# Sequence-parallel SSD (the JAX package's ``mamba_seq_sp``)
# ---------------------------------------------------------------------------


def mamba_seq_sp(x, p, cfg, d_model: int, eps: float, mc):
    """The mamba2 mixer with the sequence split over the model axis of
    ``mc`` (a ``sharding.MeshCtx``): x (B, S, d) replicated over the model
    ranks, ``p`` the whole weights.  Each rank scans its block of S from
    state 0 (``ssd_scan``: the ``ssd_chunk`` kernel), its causal conv
    reading the previous rank's last W-1 inputs (a summed zero buffer); the
    ranks' (decay, end state) pairs are gathered, an exclusive prefix over
    ranks gives this rank's incoming state, and its linear correction is
    added.  → y (B, S, d) replicated again.  Falls back to ``mamba_seq``
    where JAX's does (no model axis, S not dividing it)."""
    m, n_dev = mc.model_axis, mc.model_size
    if n_dev <= 1 or x.shape[1] % n_dev:
        return mamba_seq(x, p, cfg, d_model, eps)[0]
    # every rank's gradient of the (replicated) weights covers its block only
    p = {k: ({kk: copy_to(vv, mc, m) for kk, vv in v.items()} if isinstance(v, dict)
             else copy_to(v, mc, m)) for k, v in p.items()}
    xs = scatter(x, mc, m, 1)
    b, s, _ = xs.shape
    d_in = cfg.expand * d_model
    h = d_in // cfg.headdim
    g_n = cfg.n_groups * cfg.state
    w1 = cfg.conv_width - 1
    z, xbc, dt_raw = _split_proj(xs @ p["in_proj"], d_in, g_n, h)
    idx = mc.coord(m)
    # every rank's graph holds every gathered entry, so that each runs the
    # gathers' backward all_reduces (rank 0 reads no halo, and no state)
    halos = gather(xbc[None, :, -w1:], mc, m, 0)                     # (M, B, W-1, C)
    prev = torch.cat([torch.zeros_like(halos[:1]), halos[:-1]])[idx]
    conv_out = _causal_conv(torch.cat([prev, xbc], 1), p["conv_w"], p["conv_b"])[:, w1:]
    xbc = F.silu(conv_out)
    xh = xbc[..., :d_in].reshape(b, s, h, cfg.headdim)
    bmat = _heads(xbc[..., d_in:d_in + g_n], cfg.n_groups, h)
    cmat = _heads(xbc[..., d_in + g_n:], cfg.n_groups, h)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
    a_coef = -torch.exp(p["a_log"])
    y, s_dev = ssd_ops.ssd_scan(xh, dt, a_coef, bmat, cmat, chunk=cfg.chunk)
    cs = torch.cumsum(dt * a_coef[None, None, :], 1)                  # (B, S_loc, H)
    d_all = gather(torch.exp(cs[:, -1])[None], mc, m, 0)              # (M, B, H)
    s_all = gather(s_dev.float()[None], mc, m, 0)                     # (M, B, H, P, N)
    carry, prefix = torch.zeros_like(s_all[0]), []
    for j in range(n_dev):                                # exclusive prefix over ranks
        prefix.append(carry)
        carry = d_all[j][..., None, None] * carry + s_all[j]
    h_in = torch.stack(prefix + [carry])[idx]
    y_corr = torch.einsum("blhn,bhpn,blh->blhp", cmat.float(), h_in, torch.exp(cs))
    y = y.float() + y_corr + p["d_skip"][None, None, :, None] * xh.float()
    y = _gate_out(y.reshape(b, s, d_in).to(x.dtype), z, p, eps, None, 1.0, x.dtype)
    return gather(y, mc, m, 1, sum_grad=False)
