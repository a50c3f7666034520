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
  kernel against it on the card.

Per chunk of L rows (head h, f32)::

    cum   = cumsum(dt * a_h)                                      [L]
    y     = ((C B^T) o exp(cum_i - cum_j) o (i >= j) o dt_j) x    (intra)
          + (C o exp(cum)_i) state                                (inter)
    state = exp(cum_L) state + (B o exp(cum_L - cum) dt)^T x

A ragged tail (S not a multiple of L) is masked: rows at or past S take
x = 0 and dt = 0, so they add nothing and decay nothing, and y there is
not returned.  The TPU kernel reads past the end instead (ROADMAP C); both
versions here are held against :func:`ssd_ref` at a ragged S.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["ssd_step", "ssd_ref", "ssd_scan_plain"]


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
