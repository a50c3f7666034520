"""Mamba-2 (SSD) mixer: chunked-scan prefill, recurrent decode.

The port of ``repro.models.mamba``.  Prefill evaluates the SSD chunk
algebra (O(S L) in sequence length with chunk length L) one of two ways:

* ``impl="kernel"`` — :func:`repro_torch.kernels.ssd_scan.ops.ssd`: the
  hand-written CUDA kernel for a CUDA tensor (it launches or raises), its
  plain version ``ssd_scan_plain`` for a CPU tensor.  The port's blocks
  take this path (:mod:`repro_torch.models.blocks`);
* ``impl="chunked"`` — :func:`_ssd_chunked`, the JAX package's default:
  a loop over chunks of batched einsums (cuBLAS on the card).

Decode is the O(1)-per-token recurrence on the [H, N, P] state plus the
width-4 depthwise-convolution ring buffer; :func:`mamba_decode_step`
updates the cache in place and returns it.

Dtypes are the JAX package's: the vectors ``conv_b``, ``norm_w``,
``d_skip``, ``a_log`` and ``dt_bias`` stay f32 under the compute-dtype
cast, so ``silu(conv + conv_b)`` promotes a bf16 model's ``xbc`` to f32,
and the scan receives f32 x, b and c.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.errors import LPFFatalError
from ..kernels.ssd_scan import ops as ssd_ops
from .common import dense_init, rms_norm

__all__ = ["MambaConfig", "mamba_params", "mamba_apply", "mamba_decode_step",
           "mamba_init_cache"]

CONV_W = 4


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128          # N
    expand: int = 2
    head_dim: int = 64          # P
    n_groups: int = 1           # G
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_params(gen: Optional[torch.Generator], cfg: MambaConfig,
                 dtype=torch.float32, device=None) -> dict:
    """Per-component input projections (z, x, B, C, dt), as the JAX
    package lays them out, drawn from ``gen`` on ``device`` (``None`` on
    the meta device)."""
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    init = lambda shape, **kw: dense_init(gen, shape, dtype=dtype,
                                          device=device, **kw)
    return {
        "in_z": init((cfg.d_model, di)),
        "in_x": init((cfg.d_model, di)),
        "in_b": init((cfg.d_model, g * n)),
        "in_c": init((cfg.d_model, g * n)),
        "in_dt": init((cfg.d_model, h)),
        "conv_w": init((CONV_W, cfg.conv_dim), scale=1.0),
        "conv_b": torch.zeros(cfg.conv_dim, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=device),
        "d_skip": torch.ones(h, dtype=dtype, device=device),
        "norm_w": torch.ones(di, dtype=dtype, device=device),
        "out_proj": init((di, cfg.d_model)),
    }


def _project(params, x_in):
    return (x_in @ params["in_z"], x_in @ params["in_x"],
            x_in @ params["in_b"], x_in @ params["in_c"],
            x_in @ params["in_dt"])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv, width CONV_W.  xbc [B, S, C]."""
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, CONV_W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :]
              for i in range(CONV_W))
    return F.silu(out + b[None, None, :])


def _ssd_chunked(x, dt, a, bmat, cmat, cfg: MambaConfig):
    """Chunk-parallel SSD (the kernel's algebra) as a loop over chunks of
    batched einsums.  x [B,S,H,P]; dt [B,S,H]; a [H]; b/c [B,S,G,N].
    Returns (y f32, final_state [B,H,N,P]).  S must be a multiple of the
    chunk length, as in the JAX package."""
    B, S, H, P = x.shape
    G, N = bmat.shape[2], bmat.shape[3]
    L = min(cfg.chunk, S)
    if S % L:
        raise LPFFatalError(f"_ssd_chunked: S = {S} is not a multiple of "
                            f"the chunk length {L}")
    nc = S // L
    hg = H // G
    xf = x.float().reshape(B, nc, L, H, P)
    dtf = dt.float().reshape(B, nc, L, H)
    bf = bmat.float().reshape(B, nc, L, G, N).repeat_interleave(hg, dim=3)
    cf = cmat.float().reshape(B, nc, L, G, N).repeat_interleave(hg, dim=3)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for k in range(nc):
        xc, dtc, bc, cc = xf[:, k], dtf[:, k], bf[:, k], cf[:, k]
        cum = torch.cumsum(dtc * a[None, None, :], dim=1)    # [B,L,H]
        cb = torch.einsum("bihn,bjhn->bhij", cc, bc)
        cumt = cum.transpose(1, 2)                            # [B,H,L]
        seg = cumt[:, :, :, None] - cumt[:, :, None, :]       # [B,H,i,j]
        # the non-causal (positive) segment sums are clamped before exp
        seg = torch.where(causal[None, None], seg,
                          torch.tensor(-1e30, device=x.device))
        m = cb * torch.exp(seg) * dtc.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", m, xc)
        y = y + torch.einsum("bihn,bhnp,bih->bihp", cc, state,
                             torch.exp(cum))
        cl = cum[:, -1, :]                                    # [B,H]
        decay_end = torch.exp(cl[:, None, :] - cum) * dtc     # [B,L,H]
        state = torch.exp(cl)[:, :, None, None] * state + torch.einsum(
            "bjhn,bjhp->bhnp", bc * decay_end[..., None], xc)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, P), state


def mamba_apply(params: dict, x_in: torch.Tensor, cfg: MambaConfig, *,
                impl: str = "chunked") -> torch.Tensor:
    """Full Mamba-2 block (minus the outer residual): x [B, S, D]."""
    B, S, _ = x_in.shape
    h, p, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xr, b, c, dt = _project(params, x_in)
    xbc = torch.cat([xr, b, c], dim=-1)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    # views of xbc: the kernel reads them through their strides
    xr = xbc[..., :cfg.d_inner]
    b = xbc[..., cfg.d_inner:cfg.d_inner + g * n]
    c = xbc[..., cfg.d_inner + g * n:]

    dt_v = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])                            # [H]
    xh = xr.reshape(B, S, h, p)
    bg = b.reshape(B, S, g, n)
    cg = c.reshape(B, S, g, n)

    if impl == "kernel":
        y = ssd_ops.ssd(xh, dt_v, a, bg, cg, chunk=cfg.chunk)
    elif impl == "chunked":
        y, _ = _ssd_chunked(xh, dt_v, a, bg, cg, cfg)
    else:
        raise LPFFatalError(f"mamba_apply: impl={impl!r}; expected kernel "
                            f"or chunked")
    cdt = x_in.dtype
    y = y.to(cdt) + xh.to(cdt) * params["d_skip"].to(cdt)[None, None, :,
                                                           None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    return y @ params["out_proj"]


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def mamba_init_cache(batch: int, cfg: MambaConfig, dtype=torch.float32,
                     device=None) -> dict:
    return {
        "ssm": torch.zeros(batch, cfg.n_heads, cfg.d_state, cfg.head_dim,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, CONV_W - 1, cfg.conv_dim, dtype=dtype,
                            device=device),
    }


def mamba_decode_step(params: dict, x_t: torch.Tensor, cache: dict,
                      cfg: MambaConfig) -> Tuple[torch.Tensor, dict]:
    """x_t [B, D] one token.  Returns (y [B, D], cache), the cache's
    ``ssm`` and ``conv`` updated in place (the JAX package returns new
    ones; the values are the same)."""
    B, _ = x_t.shape
    h, p, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xr, b, c, dt = _project(params, x_t)
    xbc = torch.cat([xr, b, c], dim=-1)                        # [B, conv]
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv = sum(window[:, i, :] * params["conv_w"][i][None, :]
               for i in range(CONV_W))
    xbc = F.silu(conv + params["conv_b"][None, :])
    xr = xbc[:, :cfg.d_inner]
    b = xbc[:, cfg.d_inner:cfg.d_inner + g * n].reshape(B, g, n)
    c = xbc[:, cfg.d_inner + g * n:].reshape(B, g, n)

    dt_v = F.softplus(dt.float() + params["dt_bias"][None, :])   # [B, H]
    a = -torch.exp(params["a_log"])
    xh = xr.reshape(B, h, p).float()
    hg = h // g
    bh = b.repeat_interleave(hg, dim=1).float()                # [B, H, N]
    ch = c.repeat_interleave(hg, dim=1).float()

    decay = torch.exp(dt_v * a[None, :])                       # [B, H]
    upd = torch.einsum("bhn,bhp->bhnp", bh, xh * dt_v[..., None])
    ssm = decay[:, :, None, None] * cache["ssm"] + upd
    y = torch.einsum("bhn,bhnp->bhp", ch, ssm)
    cdt = x_t.dtype
    y = y.to(cdt) + xh.to(cdt) * params["d_skip"].to(cdt)[None, :, None]
    y = y.reshape(B, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    out = (y @ params["out_proj"]).to(cdt)
    cache["ssm"].copy_(ssm)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
