"""Parameter counts and useful training operations of a decoder-only
transformer with a dense or a sparse-expert block, from a configuration
file's published sizes alone (the rule of the port's ``count_params``
and ``model_flops``: every expert leaf counted at top_k / n_experts,
6 N_active per trained position; attention scores and the remat
recompute are not counted)."""

from __future__ import annotations


def vocab_padded(vocab: int) -> int:
    """The embedding table's rows: the vocabulary padded to a multiple
    of 256, as the port stores it."""
    return -(-vocab // 256) * 256


def param_counts(m: dict) -> dict:
    """``{"total": ..., "active": ...}`` of the model ``m`` (a
    configuration file's ``model`` object): the stored parameters, padded
    embedding rows included, and those one token uses."""
    D, L = m["hidden_size"], m["num_hidden_layers"]
    hd = m["head_dim"]
    attn = D * m["num_attention_heads"] * hd * 2 \
        + D * m["num_key_value_heads"] * hd * 2
    norms = 2 * D
    embed = vocab_padded(m["vocab_size"]) * D
    head = 0 if m["tie_word_embeddings"] else embed
    F = m["intermediate_size"]
    E = m.get("num_local_experts", 0)
    if E:           # sparse experts of width F, and their router
        k = m["num_experts_per_tok"]
        experts, router = E * 3 * D * F, D * E
        layer_total = attn + norms + experts + router
        layer_active = attn + norms + router + experts * k / E
    else:           # a dense SwiGLU block of width F
        layer_total = layer_active = attn + norms + 3 * D * F
    total = L * layer_total + embed + head + D
    active = L * layer_active + embed + head + D
    return {"total": int(total), "active": int(active)}


def train_flops(m: dict, tokens: int) -> float:
    """6 N_active D: useful training operations over ``tokens``
    positions."""
    return 6.0 * param_counts(m)["active"] * tokens
