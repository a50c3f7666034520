"""The plain reference of a decoder-only transformer with sparse experts
(granite-moe-3b-a800m as the port runs it), in float32, written from the
configuration file's sizes alone; the weights, AdamW and the check's
steps are ``reference/training.py``'s.

The model: token embedding (tied to the head); per layer a pre-norm
residual attention block (RMSNorm with a ``1 + w`` scale, eps 1e-6; GQA
with RoPE, half-split, on every head; causal softmax attention) and a
pre-norm residual expert block (f32 router, top-k experts with softmax
gates over the chosen logits, each expert taking at most ``cap`` tokens,
those with the largest gates; SwiGLU experts); a final RMSNorm; logits
over the vocabulary; the mean next-token cross-entropy.  The embedding
table holds the vocabulary padded to a multiple of 256, as the port
stores it; the padded rows take part in nothing but weight decay.

Under the control (``low="fp8"``) every product the configuration
computes in bfloat16 (the projections, the experts, the attention scores
and their weighted sum, the logits) is rounded; the router stays in
float32, as the configuration states."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .training import Spec, mm as _mm

RMS_EPS = 1e-6
#: query rows of one attention block (each block checkpointed alone)
Q_BLOCK = 1024


# --------------------------------------------------------------------------
# the weights
# --------------------------------------------------------------------------

def vocab_padded(vocab: int) -> int:
    return -(-vocab // 256) * 256


def param_specs(m: dict) -> List[Spec]:
    """``(name, shape, fan_in)`` of every leaf, named and laid out as the
    port's tree (weights ``[in, out]``, layers stacked first); a norm
    weight has ``fan_in`` None and starts at 0."""
    D, L = m["hidden_size"], m["num_hidden_layers"]
    H, Hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    E, Fh = m["num_local_experts"], m["intermediate_size"]
    b = "dec_body.b0."
    return [
        ("embed", (vocab_padded(m["vocab_size"]), D), D),
        ("final_norm.w", (D,), None),
        (b + "attn.wq", (L, D, H * hd), D),
        (b + "attn.wk", (L, D, Hkv * hd), D),
        (b + "attn.wv", (L, D, Hkv * hd), D),
        (b + "attn.wo", (L, H * hd, D), H * hd),
        (b + "ln1.w", (L, D), None),
        (b + "moe.router", (L, D, E), D),
        (b + "moe.w_gate", (L, E, D, Fh), D),
        (b + "moe.w_up", (L, E, D, Fh), D),
        (b + "moe.w_down", (L, E, Fh, D), Fh),
        (b + "ln2.w", (L, D), None),
    ]


def port_sizes(cfg) -> dict:
    """The port's model config ``cfg`` read back under the configuration
    file's keys (its published sizes and ``run_as``), for the check that
    the program and this reference run one model."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv, "head_dim": cfg.hd,
            "intermediate_size": cfg.moe.d_ff,
            "num_local_experts": cfg.moe.padded_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "vocab_size": cfg.vocab, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "capacity_factor": cfg.moe.capacity_factor}


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _rms(x, w):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS)
    return x * (1.0 + w)


def _rope(x, cos, sin):
    """x [B, S, h, d], half-split pairs (i, i + d/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_tables(S: int, hd: int, theta: float, device):
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]


def _attn_block(q, k, v, start, low):
    """Causal attention of the query rows ``[start, start + qb)``:
    q [B, H, qb, d], k, v [B, H, S, d]."""
    qb, S = q.shape[2], k.shape[2]
    s = _mm(q, k.transpose(-1, -2), low) / math.sqrt(q.shape[-1])
    rows = start + torch.arange(qb, device=q.device)[:, None]
    s = s.masked_fill(torch.arange(S, device=q.device)[None, :] > rows,
                      float("-inf"))
    return _mm(torch.softmax(s, dim=-1), v, low)


def _attention(q, k, v, low):
    """q [B, S, H, d], k, v [B, S, Hkv, d] -> [B, S, H * d]."""
    B, S, H, d = q.shape
    group = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.transpose(1, 2).repeat_interleave(group, dim=1)
    v = v.transpose(1, 2).repeat_interleave(group, dim=1)
    outs = []
    for start in range(0, S, Q_BLOCK):
        qb = q[:, :, start:start + Q_BLOCK]
        if torch.is_grad_enabled():
            outs.append(_ckpt.checkpoint(_attn_block, qb, k, v, start, low,
                                         use_reentrant=False))
        else:
            outs.append(_attn_block(qb, k, v, start, low))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * d)


def capacity(T: int, E: int, m: dict) -> int:
    """Tokens one expert takes in a call of ``T`` tokens."""
    k, cf = m["num_experts_per_tok"], m["capacity_factor"]
    return max(1, min(T, max(8, int(cf * k * T / E))))


def _experts(h, router, wg, wu, wd, m, low):
    """h [B, S, D] -> [B, S, D]: each expert's tokens (those routed to it
    with the ``cap`` largest gates) through its SwiGLU, weighted by their
    gates and summed."""
    B, S, D = h.shape
    T, E = B * S, router.shape[-1]
    xt = h.reshape(T, D)
    top_v, top_i = torch.topk(xt @ router, m["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    cap = capacity(T, E, m)
    out = torch.zeros(T, D, dtype=h.dtype, device=h.device)
    for e in range(E):
        hit = top_i == e
        rows = hit.any(-1).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        w = (gates * hit).sum(-1)[rows]
        if rows.numel() > cap:
            keep = torch.topk(w, cap).indices
            rows, w = rows[keep], w[keep]
        xe = xt[rows]
        ye = _mm(F.silu(_mm(xe, wg[e], low)) * _mm(xe, wu[e], low),
                 wd[e], low)
        out = out.index_add(0, rows, ye * w[:, None])
    return out.reshape(B, S, D)


def _layer(x, cos, sin, m, low, wq, wk, wv, wo, ln1, router, wg, wu, wd,
           ln2):
    B, S, D = x.shape
    H, Hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    h = _rms(x, ln1)
    q = _rope(_mm(h, wq, low).reshape(B, S, H, hd), cos, sin)
    k = _rope(_mm(h, wk, low).reshape(B, S, Hkv, hd), cos, sin)
    v = _mm(h, wv, low).reshape(B, S, Hkv, hd)
    x = x + _mm(_attention(q, k, v, low), wo, low)
    return x + _experts(_rms(x, ln2), router, wg, wu, wd, m, low)


LAYER_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ln1.w",
                "moe.router", "moe.w_gate", "moe.w_up", "moe.w_down",
                "ln2.w")


def loss(params: Dict[str, torch.Tensor], tokens, labels, m: dict,
         low: Optional[str] = None) -> torch.Tensor:
    """The mean next-token cross-entropy of ``tokens`` [B, S] against
    ``labels`` [B, S] (every label a token), each layer checkpointed."""
    V = m["vocab_size"]
    S = tokens.shape[1]
    cos, sin = _rope_tables(S, m["head_dim"], m["rope_theta"],
                            tokens.device)
    x = params["embed"][tokens.long()]
    stacked = [params["dec_body.b0." + k] for k in LAYER_LEAVES]
    for l in range(m["num_hidden_layers"]):
        ws = [t[l] for t in stacked]
        if torch.is_grad_enabled():
            x = _ckpt.checkpoint(_layer, x, cos, sin, m, low, *ws,
                                 use_reentrant=False)
        else:
            x = _layer(x, cos, sin, m, low, *ws)
    h = _rms(x, params["final_norm.w"])
    logits = _mm(h, params["embed"][:V].T, low)
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1).long())


