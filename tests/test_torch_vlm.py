"""The VLM architecture (internvl2-2b: the InternLM2 decoder with
precomputed patch embeddings in place of the first ``prefix_len`` token
embeddings) in the port against the JAX package, on the CPU, on its SMOKE
config in float32 with the JAX parameters carried over by
``repro_torch.convert``.

Tolerances: ``forward`` / ``prefill`` logits and caches with and without
``prefix_embeds``, allclose(rtol=1e-5, atol=1e-5).  The serve engines (text
only, as in the reference, which never passes ``prefix_embeds``): greedy
tokens and counters identical to the JAX engine's on digital; on frozen
imc_bitserial one request's tokens identical to the JAX package's up to
checked knife edges, its logits within ``EDGE_DEV_CAP``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as j_forward
from repro.models import prefill as j_prefill
from repro_torch.launch import serve as t_serve
from repro_torch.models import forward as t_forward
from repro_torch.models import prefill as t_prefill
from torch_zoo import (
    assert_bitserial_tokens,
    counters,
    jax_engine,
    run_engine,
    setup,
)
from torch_threads import two_threads  # noqa: F401  (autouse)

ARCH = "internvl2-2b"
TOL = dict(rtol=1e-5, atol=1e-5)
LENS, MAX_NEW = [5, 9, 3, 12], 6


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("with_prefix", [True, False])
def test_forward_and_prefill_take_prefix_embeds(with_prefix):
    cfg_j, cfg_t, params_j, params_t = setup(ARCH)
    rnp = np.random.default_rng(4)
    toks = rnp.integers(0, cfg_j.vocab_size, (2, 24))
    pe = (rnp.normal(size=(2, cfg_t.prefix_len, cfg_t.d_model))
          .astype(np.float32) if with_prefix else None)
    pj = None if pe is None else jnp.asarray(pe)
    pt = None if pe is None else torch.tensor(pe)
    lj, _ = jax.jit(lambda t, e: j_forward(params_j, cfg_j, t, e))(
        jnp.asarray(toks, jnp.int32), pj)
    lf, _ = t_forward(params_t, cfg_t, torch.tensor(toks), pt)
    np.testing.assert_allclose(lf.numpy(), _np(lj), **TOL)
    lj, cj = jax.jit(lambda t, e: j_prefill(params_j, cfg_j, t, 32,
                                            prefix_embeds=e))(
        jnp.asarray(toks, jnp.int32), pj)
    lt, ct = t_prefill(params_t, cfg_t, torch.tensor(toks), 32,
                       prefix_embeds=pt)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"]["p0"][kv].numpy(),
                                   _np(cj["blocks"]["p0"][kv]), **TOL)
    if with_prefix:  # the prefix replaced the first token embeddings
        plain, _ = t_forward(params_t, cfg_t, torch.tensor(toks))
        assert not torch.allclose(plain, lf)


def test_engine_matches_reference_engine():
    _, cfg_t, _, params_t = setup(ARCH)
    out_j, cnt_j = jax_engine(ARCH, "digital", LENS, MAX_NEW)
    out_t, eng = run_engine(t_serve, cfg_t, params_t, LENS, MAX_NEW)
    assert eng.bucketable and eng.has_paged
    assert counters(eng) == cnt_j
    assert out_t == out_j


def test_engine_bitserial_matches_reference():
    """Frozen imc_bitserial with ``rng=None``, one request's prefill (the
    decode path is phi3-mini's, held on bit-serial by
    ``tests/test_torch_archs_serve.py``): the JAX package's run, its logits
    and tokens up to checked knife edges."""
    _, cfg_t, _, params_t = setup(ARCH, "imc_bitserial")
    out_t, eng = run_engine(t_serve, cfg_t, params_t, [6], 1, slots=1)
    assert counters(eng) == (1, 1, 0, 0)
    assert_bitserial_tokens(ARCH, out_t, [6], 1)
