"""Parameter counts and useful training operations of a vision-language
model (LLaVA-NeXT: a CLIP tower, a projector and a dense decoder), from
a configuration file's published sizes alone, and the shapes of its
attention launches.  The rule of ``counts.model``, 6 N per position a
part of the model sees: the decoder's N but its head over every decoder
position, the head's over the text positions alone (no logits are taken
at the image's), the tower's over each tile's positions (class token and
patches), the projector's over each tile's patches.  Attention scores
and the remat recompute are not counted."""

from __future__ import annotations

from .model import param_counts, vocab_padded


def _vision(m: dict) -> tuple:
    v = m["vision_config"]
    side = v["image_size"] // v["patch_size"]
    layers = v["num_hidden_layers"] + 1 + m["vision_feature_layer"]
    return v, side * side, layers


def vlm_param_counts(m: dict) -> dict:
    """``{"decoder", "head", "tower", "projector"}``: the decoder's
    parameters (embedding and head included), its untied head's alone (0
    where the head is the embedding), the tower's (patch embedding, class
    token, positions, ``pre_layrnorm`` and the layers whose output is
    read) and the projector's."""
    v, patches, layers = _vision(m)
    d, f, D = v["hidden_size"], v["intermediate_size"], m["hidden_size"]
    layer = 4 * d * d + 4 * d + 2 * d * f + f + d + 4 * d
    tower = 3 * v["patch_size"] ** 2 * d + d + (1 + patches) * d + 2 * d \
        + layers * layer
    head = 0 if m["tie_word_embeddings"] else vocab_padded(
        m["vocab_size"]) * D
    return {"decoder": param_counts(m)["total"], "head": head,
            "tower": tower, "projector": d * D + D + D * D + D}


def vlm_train_flops(m: dict, positions: int, text: int,
                    tiles: int) -> float:
    """6 N D over ``positions`` decoder positions, ``text`` of them text
    (where the head is applied), and ``tiles`` tiles."""
    n = vlm_param_counts(m)
    _, patches, _ = _vision(m)
    return 6.0 * ((n["decoder"] - n["head"]) * positions + n["head"] * text
                  + (n["tower"] * (1 + patches)
                     + n["projector"] * patches) * tiles)


def attention_shapes(m: dict, batch: int, seq: int, tiles: int) -> dict:
    """``(B, H, Hkv, S, D, causal)`` of one attention launch:
    ``decoder`` (causal over ``seq``), ``tower`` (every position of
    ``tiles`` tiles over its tile's)."""
    v, patches, _ = _vision(m)
    heads = v["num_attention_heads"]
    return {"decoder": (batch, m["num_attention_heads"],
                        m["num_key_value_heads"], seq, m["head_dim"], True),
            "tower": (tiles, heads, heads, 1 + patches,
                      v["hidden_size"] // heads, False)}
