"""The plain PyTorch versions of the Mamba-2 SSD scan, in f32 math.

* :func:`ssd_step` / :func:`ssd_ref` — the port of the JAX package's
  sequential oracle (``repro/kernels/ssd_scan/ref.py``): one recurrence
  step, and the scan over the sequence, which returns y in x's dtype and
  the final state in f32: the tests' reference;
* :func:`ssd_scan_plain` — the chunk algebra of the TPU kernel
  (``repro/kernels/ssd_scan/kernel.py:10-16, 43-67``) as a loop over
  chunks of torch ops: the same function as the CUDA kernel
  ``csrc/ssd_scan.cu``.  :mod:`.ops` runs it for CPU tensors and
  differentiates it for the backward, and ``chip_smoke.py`` holds the
  kernel against it on the card;
* :func:`ssd_scan_passes` — the same function split as the CUDA kernel
  splits it, into chunk-parallel passes (below), returning what each pass
  leaves in device memory; every product goes through ``mm``, so
  :func:`split_tf32_mm` (the kernel's split-TF32 tensor-core products,
  emulated) or :func:`split_bf16_mm` (the same split into bf16 parts, the
  fastest arithmetic known to hold the bar) can take the place of the f32
  one.

Per chunk of L rows (head h, f32)::

    cum   = cumsum(dt * a_h)                                      [L]
    y     = ((C B^T) o exp(cum_i - cum_j) o (i >= j) o dt_j) x    (intra)
          + (C o exp(cum)_i) state                                (inter)
    state = exp(cum_L) state + (B o exp(cum_L - cum) dt)^T x

The passes (Mamba-2's chunked form, arXiv:2405.21060 section 6), for
chunk k of head h (group g)::

    A  cum_k  = cumsum(dt * a_h)                  once per (b, k, h)
       cb_k   = C B^T (j <= i)                    once per (b, k, g)
       S_k    = (B o exp(cum_L - cum) dt)^T x     the chunk's own state
    B  h_0 = 0;  h_{k+1} = exp(cum_L,k) h_k + S_k  (h_k enters chunk k;
       h_nc is the final state)                   a short chain over k
    C  y_k    = exp(cum_i) (C h_k)
              + (cb_k o exp(cum_i - cum_j) o (j <= i) o dt_j) x

A ragged tail (S not a multiple of L) is masked: rows at or past S take
x = 0 and dt = 0, so they add nothing and decay nothing, and y there is
not returned.  The TPU kernel reads past the end instead (ROADMAP C); both
versions here are held against :func:`ssd_ref` at a ragged S.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ssd_step", "ssd_ref", "ssd_scan_plain", "SSDPasses",
           "ssd_scan_passes", "tf32_round", "split_tf32_mm",
           "split_bf16_mm"]


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             a: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step.  state [H, N, P]; x_t [H, P]; dt_t [H];
    a [H]; b_t/c_t [G, N].  Returns (state', y_t [H, P])."""
    hg = x_t.shape[0] // b_t.shape[0]
    bh = b_t.repeat_interleave(hg, dim=0)              # [H, N]
    ch = c_t.repeat_interleave(hg, dim=0)
    decay = torch.exp(dt_t * a)                        # [H]
    upd = torch.einsum("hn,hp->hnp", bh, x_t * dt_t[:, None])
    state = decay[:, None, None] * state + upd
    y = torch.einsum("hn,hnp->hp", ch, state)
    return state, y


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N] ->
    (y [B,S,H,P] in x's dtype, final_state [B,H,N,P] f32): the
    recurrence, one position at a time, batched over B."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    af = a.float()
    step = torch.vmap(ssd_step, in_dims=(0, 0, 0, None, 0, 0))
    st = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        st, y = step(st, xf[:, t], dtf[:, t], af, bf[:, t], cf[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), st


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan: x [B,S,H,P], dt [B,S,H] (f32), a [H] (f32),
    b/c [B,S,G,N] -> (y [B,S,H,P] in x's dtype, final_state [B,H,N,P]
    f32); chunk length ``L = min(chunk, S)``, the ragged tail masked."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    hg = H // G

    def chunks(t):
        # zero rows past S (x = 0, dt = 0: no update, no decay), then
        # [B, nc, L, ...]
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(B, nc, L, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)
    bc = chunks(b).repeat_interleave(hg, dim=3)        # [B,nc,L,H,N]
    cc = chunks(c).repeat_interleave(hg, dim=3)
    af = a.float()
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for k in range(nc):
        xk, dtk, bk, ck = xc[:, k], dtc[:, k], bc[:, k], cc[:, k]
        cum = torch.cumsum(dtk * af, dim=1).transpose(1, 2)   # [B,H,L]
        cb = torch.einsum("bihn,bjhn->bhij", ck, bk)
        # masked before the exponent: entries j > i are 0, never exp(+x)
        seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        m = cb * torch.exp(seg) * dtk.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", m, xk)
        y = y + torch.einsum("bihn,bhnp->bihp", ck, state) \
            * torch.exp(cum).transpose(1, 2)[..., None]
        cl = cum[..., -1]                                   # [B,H]
        w = torch.exp(cl[..., None] - cum) * dtk.transpose(1, 2)  # [B,H,L]
        state = torch.exp(cl)[..., None, None] * state + torch.einsum(
            "bjhn,bhj,bjhp->bhnp", bk, w, xk)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nc * L, H, P)[:, :S]
    return y.to(x.dtype), state


class SSDPasses(NamedTuple):
    """What the passes of :func:`ssd_scan_passes` leave, f32 but y."""
    cum: torch.Tensor           # [B, H, nc, L] cumsum(dt * a_h) a chunk
    cb: torch.Tensor            # [B, nc, G, L, L] C B^T, zero above i = j
    states: torch.Tensor        # [B, nc, H, N, P] the state entering chunk k
    y: torch.Tensor             # [B, S, H, P] in x's dtype
    final_state: torch.Tensor   # [B, H, N, P]


def ssd_scan_passes(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
                    mm: Callable = torch.matmul) -> SSDPasses:
    """The chunked scan as the CUDA kernel's passes (module docstring):
    the same inputs and outputs as :func:`ssd_scan_plain`, plus the
    passes' intermediates.  All chunks of a pass at once; the four
    products (C B^T, B^T (x o w), C h_k, M x) through ``mm``."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    hg = H // G

    def chunks(t):
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(B, nc, L, *t.shape[2:])

    xc = chunks(x).permute(0, 1, 3, 2, 4)             # [B,nc,H,L,P]
    dtc = chunks(dt).permute(0, 1, 3, 2)              # [B,nc,H,L]
    bc = chunks(b).permute(0, 1, 3, 2, 4)             # [B,nc,G,L,N]
    cc = chunks(c).permute(0, 1, 3, 2, 4)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()

    # pass A
    cum = torch.cumsum(dtc * a.float()[:, None], dim=-1)   # [B,nc,H,L]
    cb = mm(cc, bc.transpose(-1, -2)).masked_fill(~causal, 0.0)
    cum_l = cum[..., -1:]
    w = torch.exp(cum_l - cum) * dtc
    b_h = bc.repeat_interleave(hg, dim=2)              # [B,nc,H,L,N]
    c_h = cc.repeat_interleave(hg, dim=2)
    own = mm(b_h.transpose(-1, -2), xc * w[..., None])  # [B,nc,H,N,P]

    # pass B
    decay = torch.exp(cum_l[..., 0])                    # [B,nc,H]
    h = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(h)
        h = decay[:, k, :, None, None] * h + own[:, k]
    states = torch.stack(entering, dim=1)

    # pass C, masked before the exponent
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    m = cb.repeat_interleave(hg, dim=2) * torch.exp(seg) * dtc[..., None, :]
    y = mm(m, xc) + torch.exp(cum)[..., None] * mm(c_h, states)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * L, H, P)[:, :S]
    return SSDPasses(cum.permute(0, 2, 1, 3), cb, states, y.to(x.dtype), h)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 as ``cvt.rna.tf32.f32`` rounds: to the nearest value
    with 10 mantissa bits, ties away from zero, on the integer view (the
    13 low bits cleared after adding half of them)."""
    u = t.float().contiguous().view(torch.int32).to(torch.int64)
    u = ((u & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def split_tf32_mm(a: torch.Tensor, b: torch.Tensor, *, products: int = 3
                  ) -> torch.Tensor:
    """a @ b as the kernel's tensor cores take it: each f32 operand split
    into hi = rna(v) and lo = rna(v - hi), then lo_a hi_b + hi_a lo_b +
    hi_a hi_b (``products=3``), or hi_a hi_b alone (``products=1``: one
    TF32 product).  TF32 products are exact in f32, so an f32 matmul of
    the parts sums them as the tensor cores do, in another order."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if products == 3:
        out = (tf32_round(a - a_hi) @ b_hi + a_hi @ tf32_round(b - b_hi)
               + out)
    elif products != 1:
        raise ValueError(f"split_tf32_mm takes 1 or 3 products, not "
                         f"{products}")
    return out


def split_bf16_mm(a: torch.Tensor, b: torch.Tensor, *, products: int = 3
                  ) -> torch.Tensor:
    """a @ b as bf16 tensor cores would take it: each f32 operand split
    into hi = bf16(v) and lo = bf16(v - hi), rounded to nearest even as
    ``cvt.rn.bf16.f32`` rounds, then lo_a hi_b + hi_a lo_b + hi_a hi_b
    (``products=3``), or hi_a hi_b alone (``products=1``).  An operand
    that is bf16 already has lo = 0, so its pair needs 2 products (1 if
    both are).  Products of bf16 parts are exact in f32."""
    def bf16(t):
        return t.float().to(torch.bfloat16).float()
    a_hi, b_hi = bf16(a), bf16(b)
    out = a_hi @ b_hi
    if products == 3:
        out = bf16(a - a_hi) @ b_hi + a_hi @ bf16(b - b_hi) + out
    elif products != 1:
        raise ValueError(f"split_bf16_mm takes 1 or 3 products, not "
                         f"{products}")
    return out
