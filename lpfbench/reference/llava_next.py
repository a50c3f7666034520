"""The plain reference of LLaVA-NeXT-Mistral-7B as the port runs it: the
CLIP ViT tower, the projector, anyres packing and the Mistral decoder,
in float32, written from the configuration file's sizes alone; the
weights, AdamW and the check's steps are ``reference/training.py``'s
(with :func:`make_params` and :func:`start_leaf` for the leaves that
start at 1).

The tower (``vision_config``): each tile [3, s, s] cut into p x p
patches (``F.unfold``, each patch's values ordered channel, row,
column), a product with ``vision.patch_embed`` (the stride-p
convolution's weight, flattened, as ``[3 p^2, d]``), the class token
first, learned positions added, LayerNorm (``pre_layrnorm``, eps 1e-5);
then ``num_hidden_layers + 1 + vision_feature_layer`` pre-LayerNorm
encoder layers (attention over all of the tile's positions with biases
on q, k, v and out, scale 1/sqrt(head size); MLP with biases and
``quick_gelu`` x sigmoid(1.702 x)); the class position dropped.  The
projector: Linear with bias, exact GELU, Linear with bias.  Anyres
packing (the pinpoint ``run_as.image_pinpoint``, a grid of tiles after
the base tile): the base tile's vectors, then the grid's as one map,
row by row, with ``vision.newline`` after each row.  The decoder
(Mistral): token embedding; per layer RMSNorm (a ``1 + w`` scale, eps
1e-6), GQA with half-split RoPE on every head, causal softmax attention,
RMSNorm, SwiGLU; a final RMSNorm; an untied head.  The image positions
come first; the loss is the mean next-token cross-entropy over the text
positions.

Under the control (``low="fp8"``) every product the configuration
computes in bfloat16 is rounded (``training.mm``): the patch embedding,
the tower's and the decoder's projections and MLPs, the attention
scores and their weighted sum, the projector, the logits."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from . import training
from .granite import _attention, _rms, _rope, _rope_tables, vocab_padded
from .training import Spec, mm as _mm

LN_EPS = 1e-5
#: the tower's tiles whose attention is computed at once
TILE_BLOCK = 4


# --------------------------------------------------------------------------
# sizes
# --------------------------------------------------------------------------

def tower_layers(m: dict) -> int:
    """The tower's layers whose output is read (the rest are not held)."""
    return m["vision_config"]["num_hidden_layers"] + 1 \
        + m["vision_feature_layer"]


def image_layout(m: dict) -> dict:
    """An image at the configuration's pinpoint: its tiles (the base and
    the grid's), the grid (rows, columns), the patches along a tile's
    side, a tile's patches and the image's packed positions."""
    v = m["vision_config"]
    s = v["image_size"] // v["patch_size"]
    rows, cols = (px // v["image_size"] for px in m["image_pinpoint"])
    return {"tiles": 1 + rows * cols, "grid": (rows, cols), "side": s,
            "patches": s * s,
            "positions": s * s + rows * s * (cols * s + 1)}


# --------------------------------------------------------------------------
# the weights
# --------------------------------------------------------------------------

def param_specs(m: dict) -> List[Spec]:
    """``(name, shape, fan_in)`` of every leaf, named and laid out as the
    port's tree (weights ``[in, out]``, layers stacked first); a norm
    weight or a bias has ``fan_in`` None and starts at 0 (a LayerNorm
    scale at 1: :func:`make_params`)."""
    D, L = m["hidden_size"], m["num_hidden_layers"]
    H, Hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    Fh, V = m["intermediate_size"], vocab_padded(m["vocab_size"])
    v = m["vision_config"]
    d, f, Lv = v["hidden_size"], v["intermediate_size"], tower_layers(m)
    p = v["patch_size"]
    b, t = "dec_body.b0.", "vision.layers.b0."
    return [
        ("embed", (V, D), D),
        ("final_norm.w", (D,), None),
        ("head", (D, V), D),
        (b + "attn.wq", (L, D, H * hd), D),
        (b + "attn.wk", (L, D, Hkv * hd), D),
        (b + "attn.wv", (L, D, Hkv * hd), D),
        (b + "attn.wo", (L, H * hd, D), H * hd),
        (b + "ln1.w", (L, D), None),
        (b + "mlp.w_gate", (L, D, Fh), D),
        (b + "mlp.w_up", (L, D, Fh), D),
        (b + "mlp.w_down", (L, Fh, D), Fh),
        (b + "ln2.w", (L, D), None),
        ("vision.patch_embed", (3 * p * p, d), 3 * p * p),
        ("vision.class_embed", (d,), d),
        ("vision.pos_embed", (1 + image_layout(m)["patches"], d), d),
        ("vision.pre_norm.w", (d,), None),
        ("vision.pre_norm.b", (d,), None),
        ("vision.proj.w_in", (d, D), d),
        ("vision.proj.b_in", (D,), None),
        ("vision.proj.w_out", (D, D), D),
        ("vision.proj.b_out", (D,), None),
        ("vision.newline", (D,), D),
        (t + "attn.wq", (Lv, d, d), d),
        (t + "attn.wk", (Lv, d, d), d),
        (t + "attn.wv", (Lv, d, d), d),
        (t + "attn.wo", (Lv, d, d), d),
        (t + "attn.bq", (Lv, d), None),
        (t + "attn.bk", (Lv, d), None),
        (t + "attn.bv", (Lv, d), None),
        (t + "attn.bo", (Lv, d), None),
        (t + "ln1.w", (Lv, d), None),
        (t + "ln1.b", (Lv, d), None),
        (t + "mlp.w_in", (Lv, d, f), d),
        (t + "mlp.b_in", (Lv, f), None),
        (t + "mlp.w_out", (Lv, f, d), f),
        (t + "mlp.b_out", (Lv, d), None),
        (t + "ln2.w", (Lv, d), None),
        (t + "ln2.b", (Lv, d), None),
    ]


#: the leaves that start at 1 (the tower's LayerNorm scales); every other
#: leaf is ``training.make_leaf``'s
ONES = ("vision.pre_norm.w", "vision.layers.b0.ln1.w",
        "vision.layers.b0.ln2.w")


def start_leaf(seed: int, index: int, spec: Spec, device) -> torch.Tensor:
    """Leaf ``index`` of the weights of ``seed`` as both sides start."""
    t = training.make_leaf(seed, index, spec, device)
    return t.add_(1.0) if spec[0] in ONES else t


def make_params(seed: int, specs: List[Spec],
                device) -> Dict[str, torch.Tensor]:
    return {s[0]: start_leaf(seed, i, s, device)
            for i, s in enumerate(specs)}


def port_sizes(cfg) -> dict:
    """The port's model config ``cfg`` read back under the configuration
    file's keys (its published sizes and ``run_as``), for the check that
    the program and this reference run one model."""
    v = cfg.vision
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv, "head_dim": cfg.hd,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
            "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "vision_config": {
                "hidden_size": v.d_model, "intermediate_size": v.d_ff,
                "num_hidden_layers": v.n_layers,
                "num_attention_heads": v.n_heads,
                "image_size": v.image_size, "patch_size": v.patch_size,
                "hidden_act": v.act, "layer_norm_eps": LN_EPS},
            "vision_feature_layer": v.feature_layer,
            "projector_hidden_act": v.projector_act,
            "image_pinpoint": [g * v.image_size for g in v.grid]}


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _ln(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * w + b


def _tower_layer(x, heads, low, wq, wk, wv, wo, bq, bk, bv, bo, ln1w, ln1b,
                 w_in, b_in, w_out, b_out, ln2w, ln2b):
    """One CLIP encoder layer over x [N, P, d], every position seeing
    every other of its tile, ``TILE_BLOCK`` tiles' scores at a time."""
    N, P, d = x.shape
    hd = d // heads
    h = _ln(x, ln1w, ln1b)
    q, k, v = ((_mm(h, w, low) + b).reshape(N, P, heads, hd).transpose(1, 2)
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    outs = []
    for i in range(0, N, TILE_BLOCK):
        s = _mm(q[i:i + TILE_BLOCK], k[i:i + TILE_BLOCK].transpose(-1, -2),
                low) / math.sqrt(hd)
        outs.append(_mm(torch.softmax(s, dim=-1), v[i:i + TILE_BLOCK], low))
    o = torch.cat(outs).transpose(1, 2).reshape(N, P, d)
    x = x + _mm(o, wo, low) + bo
    h = _ln(x, ln2w, ln2b)
    h = _mm(h, w_in, low) + b_in
    h = h * torch.sigmoid(1.702 * h)
    return x + _mm(h, w_out, low) + b_out


TOWER_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "attn.bq",
                "attn.bk", "attn.bv", "attn.bo", "ln1.w", "ln1.b",
                "mlp.w_in", "mlp.b_in", "mlp.w_out", "mlp.b_out", "ln2.w",
                "ln2.b")


def image_positions(params: Dict[str, torch.Tensor], pixels, m: dict,
                    low: Optional[str] = None) -> torch.Tensor:
    """pixels [B, tiles, 3, s, s] -> the packed images [B, positions, D]."""
    v, lay = m["vision_config"], image_layout(m)
    B, T = pixels.shape[:2]
    p, s = v["patch_size"], lay["side"]
    tiles = pixels.reshape(B * T, 3, v["image_size"], v["image_size"])
    patches = F.unfold(tiles, kernel_size=p, stride=p).transpose(1, 2)
    x = _mm(patches, params["vision.patch_embed"], low)
    cls = params["vision.class_embed"].expand(B * T, 1, -1)
    x = torch.cat([cls, x], dim=1) + params["vision.pos_embed"]
    x = _ln(x, params["vision.pre_norm.w"], params["vision.pre_norm.b"])
    stacked = [params["vision.layers.b0." + k].unbind(0)
               for k in TOWER_LEAVES]
    for l in range(tower_layers(m)):
        ws = [t[l] for t in stacked]
        if torch.is_grad_enabled():
            x = _ckpt.checkpoint(_tower_layer, x, v["num_attention_heads"],
                                 low, *ws, use_reentrant=False)
        else:
            x = _tower_layer(x, v["num_attention_heads"], low, *ws)
    h = _mm(x[:, 1:], params["vision.proj.w_in"], low) \
        + params["vision.proj.b_in"]
    f = _mm(F.gelu(h), params["vision.proj.w_out"], low) \
        + params["vision.proj.b_out"]
    D = f.shape[-1]
    f = f.reshape(B, T, s * s, D)
    rows, cols = lay["grid"]
    packed = []
    for b in range(B):
        lines = []
        for r in range(rows * s):
            tr, pr = divmod(r, s)
            for c in range(cols):
                tile = 1 + tr * cols + c
                lines.append(f[b, tile, pr * s:(pr + 1) * s])
            lines.append(params["vision.newline"][None])
        packed.append(torch.cat([f[b, 0]] + lines))
    return torch.stack(packed)


def _layer(x, cos, sin, m, low, wq, wk, wv, wo, ln1, wg, wu, wd, ln2):
    B, S, D = x.shape
    H, Hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    h = _rms(x, ln1)
    q = _rope(_mm(h, wq, low).reshape(B, S, H, hd), cos, sin)
    k = _rope(_mm(h, wk, low).reshape(B, S, Hkv, hd), cos, sin)
    v = _mm(h, wv, low).reshape(B, S, Hkv, hd)
    x = x + _mm(_attention(q, k, v, low), wo, low)
    h = _rms(x, ln2)
    return x + _mm(F.silu(_mm(h, wg, low)) * _mm(h, wu, low), wd, low)


LAYER_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ln1.w",
                "mlp.w_gate", "mlp.w_up", "mlp.w_down", "ln2.w")


def logits(params: Dict[str, torch.Tensor], inputs: dict, m: dict,
           low: Optional[str] = None) -> torch.Tensor:
    """The logits [B, S_text, V] of ``inputs`` (``tokens`` [B, S_text],
    ``pixels`` [B, tiles, 3, s, s]), each layer checkpointed."""
    tokens = inputs["tokens"]
    img = image_positions(params, inputs["pixels"], m, low)
    x = torch.cat([img, params["embed"][tokens.long()]], dim=1)
    S = x.shape[1]
    cos, sin = _rope_tables(S, m["head_dim"], m["rope_theta"], x.device)
    stacked = [params["dec_body.b0." + k].unbind(0) for k in LAYER_LEAVES]
    for l in range(m["num_hidden_layers"]):
        ws = [t[l] for t in stacked]
        if torch.is_grad_enabled():
            x = _ckpt.checkpoint(_layer, x, cos, sin, m, low, *ws,
                                 use_reentrant=False)
        else:
            x = _layer(x, cos, sin, m, low, *ws)
    h = _rms(x[:, img.shape[1]:], params["final_norm.w"])
    return _mm(h, params["head"][:, :m["vocab_size"]], low)


def loss(params: Dict[str, torch.Tensor], tokens: dict, labels, m: dict,
         low: Optional[str] = None) -> torch.Tensor:
    """The mean next-token cross-entropy of the text positions against
    ``labels`` [B, S_text] (every label a token); ``tokens`` holds the
    ids and the pixels together (:func:`logits`' ``inputs``), so that
    ``training.adamw_steps``' ``(tokens, labels)`` carries both."""
    out = logits(params, tokens, m, low)
    V = m["vocab_size"]
    return F.cross_entropy(out.reshape(-1, V), labels.reshape(-1).long())
