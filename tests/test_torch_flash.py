"""Parity of the port's flash attention with the JAX reference on the CPU.

* ``flash_attention_fwd_ref`` (what ``ops.flash_attention`` runs for a CPU
  tensor, and what ``chip_smoke.py`` holds the CUDA kernel against on the
  card) against the JAX kernel ``flash_attention_fwd`` in Pallas interpret
  mode, o and lse, at the JAX kernel tests' sweep (``tests/test_kernels.py``)
  and two head-dim-256 entries (gemma2-9b's D; the second with a window
  and gemma2-9b's soft-cap 50, at a ragged S), at the JAX bars: o within
  2e-5 in f32 and 2e-2 in bf16, lse within 1e-5;
* ``attention_ref`` against the JAX ``attention_ref``;
* the dispatch: a CPU tensor takes the plain version and launches nothing;
  the CUDA wrapper refuses a CPU tensor, a strided view, an unsupported
  head dim or dtype; an input that requires a gradient gets one from the
  plain backward (``tests/test_torch_flash_bwd.py`` holds it to JAX).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash_fwd
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
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
    (1, 2, 2, 128, 64, True, None, None, "bfloat16"),
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def both(arrays, dtype):
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays])


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,softcap,dtype", SWEEP)
def test_plain_version_matches_jax_kernel(B, H, Hkv, S, D, causal, window,
                                          softcap, dtype):
    (jq, jk, jv), (tq, tk, tv) = both(inputs(S * D + B, B, H, Hkv, S, D),
                                      dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jo, jlse = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
    o, lse = fa_ref.flash_attention_fwd_ref(tq, tk, tv, **kw)
    assert o.dtype == TORCH_DTYPES[dtype] and o.shape == (B, H, S, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S, 1)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert np.abs(o.float().numpy() - np.asarray(jo, np.float32)).max() < tol
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() < 1e-5
    # ops on a CPU tensor is the plain version, and launches nothing
    before = fa_kernel.flash_attention_fwd.launches
    assert torch.equal(fa_ops.flash_attention(tq, tk, tv, **kw), o)
    assert fa_kernel.flash_attention_fwd.launches == before


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None), (True, 5, None),
    (True, None, 10.0)])
def test_attention_ref_matches_jax(causal, window, softcap):
    (jq, jk, jv), (tq, tk, tv) = both(inputs(3, 2, 4, 2, 24, 32), "float32")
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(jax_attn_ref(jq, jk, jv, **kw))
    got = fa_ref.attention_ref(tq, tk, tv, **kw)
    assert np.abs(got.numpy() - want).max() < 1e-5


def test_cuda_wrapper_refuses_what_it_does_not_take():
    _, (q, k, v) = both(inputs(4, 1, 2, 2, 32, 64), "float32")
    with pytest.raises(LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_fwd(q, k, v)
    with pytest.raises(LPFFatalError, match="contiguous"):
        fa_kernel.flash_attention_fwd(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    _, (q48, k48, v48) = both(inputs(4, 1, 2, 2, 32, 48), "float32")
    with pytest.raises(LPFFatalError, match="head dims"):
        fa_kernel.flash_attention_fwd(q48, k48, v48)
    with pytest.raises(LPFFatalError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(LPFFatalError, match="Hkv dividing H"):
        fa_kernel.flash_attention_fwd(q, k[:, :1].repeat(1, 3, 1, 1),
                                      v[:, :1].repeat(1, 3, 1, 1))
    # an input that requires a gradient gets one from the plain backward
    # on the CPU, and no kernel launches; the backward wrapper refuses CPU
    # tensors
    fa_kernel.flash_attention_bwd_dkv.launches = 0
    fa_kernel.flash_attention_bwd_dq.launches = 0
    qg = q.clone().requires_grad_()
    fa_ops.flash_attention(qg, k, v).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())
    assert (fa_kernel.flash_attention_bwd_dkv.launches,
            fa_kernel.flash_attention_bwd_dq.launches) == (0, 0)
    o, lse = fa_ref.flash_attention_fwd_ref(q, k, v)
    with pytest.raises(LPFFatalError, match="CUDA tensors"):
        fa_kernel.flash_attention_bwd(q, k, v, o, o, lse)
