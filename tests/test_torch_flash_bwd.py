"""Parity of the port's flash-attention backward with the JAX reference on
the CPU.

* ``flash_attention_bwd_ref`` (what ``ops.flash_attention``'s backward runs
  for a CPU tensor, and what ``chip_smoke.py`` holds the CUDA kernels
  against on the card) against the JAX kernels ``flash_attention_bwd`` in
  Pallas interpret mode, at the JAX backward test's sweep
  (``tests/test_kernels.py``: ``SWEEP[:5]``), the ragged S = 192 entry, a
  bf16 entry and two head-dim-256 entries in f32 (the second with a window,
  a soft-cap and a ragged S).  Bars, as max |port - jax| / max |jax| per gradient: the
  JAX test's 5e-4 in f32; 2^-6 in bf16, two bf16 ulps of the largest
  gradient (both sides round their f32 sums to bf16 once, so a value at a
  rounding boundary may land one ulp apart);
* the gradients of ``ops.flash_attention`` (the ``torch.autograd.Function``)
  on CPU tensors against ``jax.grad`` through the JAX ``flash_attention``
  custom VJP (interpret mode) and against torch autograd through
  ``attention_ref``, at the 5e-4 bar in f32;
* a CPU call launches no kernel, forward or backward;
* the backward wrapper's refusals, shown without a card.

The CUDA kernels themselves are held against the plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.core import LPFFatalError
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

SWEEP = [
    # B, H, Hkv, S,   D,  causal, window, softcap, dtype
    (1, 2, 2, 128, 64, True, None, None, "float32"),
    (2, 4, 2, 256, 64, True, None, None, "float32"),
    (1, 4, 1, 128, 128, False, None, None, "float32"),
    (1, 2, 2, 256, 64, True, 64, None, "float32"),
    (1, 2, 2, 128, 64, True, None, 30.0, "float32"),
    (1, 2, 1, 192, 64, True, None, None, "float32"),   # ragged S vs block
    (1, 2, 1, 128, 256, True, None, None, "float32"),  # gemma2-9b's D
    (1, 2, 2, 192, 256, True, 64, 50.0, "float32"),   # ... local layer
    (2, 4, 2, 128, 64, True, None, None, "bfloat16"),
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BARS = {"float32": 5e-4, "bfloat16": 2.0 ** -6}


def inputs(seed, B, H, Hkv, S, D):
    """q, k, v, dO as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                      (B, H, S, D))]


def rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype", SWEEP)
def test_plain_backward_matches_jax_kernels(B, H, Hkv, S, D, causal, window,
                                            softcap, dtype):
    arrays = inputs(S * D + H, B, H, Hkv, S, D)
    jq, jk, jv, jdo = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jo, jlse = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
    want = jax_flash_bwd(jq, jk, jv, jo, jdo, jlse, interpret=True, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TORCH_DTYPES[dtype])
                       for a in arrays)
    # the same forward residuals as the JAX side
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tq.dtype)
    tlse = torch.from_numpy(np.array(jlse))
    got = fa_ref.flash_attention_bwd_ref(tq, tk, tv, to, tdo, tlse, **kw)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert rel(g.float().numpy(), w.astype(jnp.float32)) < BARS[dtype], \
            name
    # round_p rounds P and dS to q's dtype: a no-op in f32
    if dtype == "float32":
        rounded = fa_ref.flash_attention_bwd_ref(tq, tk, tv, to, tdo, tlse,
                                                 round_p=True, **kw)
        for a, b in zip(rounded, got):
            assert torch.equal(a, b)


def _zero_launches():
    fa_kernel.flash_attention_fwd.launches = 0
    fa_kernel.flash_attention_bwd_dkv.launches = 0
    fa_kernel.flash_attention_bwd_dq.launches = 0


def _launches():
    return (fa_kernel.flash_attention_fwd.launches,
            fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches)


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype",
                         [SWEEP[1], SWEEP[3], SWEEP[4], SWEEP[5]])
def test_ops_gradients_match_jax_custom_vjp_and_autograd(
        B, H, Hkv, S, D, causal, window, softcap, dtype):
    q, k, v, w = inputs(7 + S, B, H, Hkv, S, D)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, interpret=True, **kw)
                       * jnp.asarray(w))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = []
    _zero_launches()
    for fn in (fa_ops.flash_attention, fa_ref.attention_ref):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*xs, **kw) * torch.from_numpy(w)).sum().backward()
        grads.append([x.grad for x in xs])
    # a CPU call takes the plain versions and launches nothing
    assert _launches() == (0, 0, 0)
    got, autograd = grads
    for name, g, a, j in zip(("dq", "dk", "dv"), got, autograd, want):
        assert rel(g.numpy(), j) < 5e-4, name
        assert rel(g.numpy(), a.numpy()) < 5e-4, name


def test_cpu_forward_without_grad_and_serving_dtype():
    """Without a gradient, ops is the plain forward itself (bf16 too)."""
    arrays = inputs(3, 1, 4, 2, 40, 32)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays[:3])
    _zero_launches()
    with torch.no_grad():
        o = fa_ops.flash_attention(q, k, v, window=9)
    want, _ = fa_ref.flash_attention_fwd_ref(q, k, v, window=9)
    assert torch.equal(o, want) and _launches() == (0, 0, 0)


def test_backward_wrapper_refuses_what_it_does_not_take():
    arrays = inputs(4, 1, 2, 2, 32, 64)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = fa_ref.flash_attention_fwd_ref(q, k, v)
    delta = (do * o).sum(-1)
    with pytest.raises(LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd(q, k, v, o, do, lse)
    with pytest.raises(LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    with pytest.raises(LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    with pytest.raises(LPFFatalError, match="contiguous"):
        fa_kernel.flash_attention_bwd(q, k, v, o, do.transpose(1, 2)
                                      .contiguous().transpose(1, 2), lse)
    with pytest.raises(LPFFatalError, match="of one dtype"):
        fa_kernel.flash_attention_bwd(q, k, v, o, do.bfloat16(), lse)
    with pytest.raises(LPFFatalError, match="shaped like q"):
        fa_kernel.flash_attention_bwd(q, k, v, o[:, :1].contiguous(), do,
                                      lse)
    with pytest.raises(LPFFatalError, match="lse must be float32"):
        fa_kernel.flash_attention_bwd(q, k, v, o, do, lse[..., 0])
    with pytest.raises(LPFFatalError, match="delta must be float32"):
        fa_kernel.flash_attention_bwd_dq(q, k, v, do, lse, delta.double())
    q48, k48, v48, do48 = (torch.from_numpy(a)
                           for a in inputs(4, 1, 2, 2, 32, 48))
    o48, lse48 = fa_ref.flash_attention_fwd_ref(q48, k48, v48)
    with pytest.raises(LPFFatalError, match="head dims"):
        fa_kernel.flash_attention_bwd(q48, k48, v48, o48, do48, lse48)
    with pytest.raises(LPFFatalError, match="window must be >= 1"):
        fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, window=0)
    assert (fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (0, 0)
