"""The port's transformer against the JAX package's flax model.

The JAX model is initialised with its own seed; its params tree goes
through ``params_from_flax`` into the port, and the same numpy tokens
go through both forwards.  fp32 logits agree to 1e-5 for MHA and GQA,
with and without a sliding window.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import (
    Transformer, TransformerConfig, init_params, params_from_flax,
)
from horovod_tpu_torch.models import transformer as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is enough, and the suite runs
    several workers side by side on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8,
             max_seq_len=64)


def _pair(num_kv_heads=None, window=None, attention_impl="dot"):
    jc = jt.TransformerConfig(dtype=jnp.float32, num_kv_heads=num_kv_heads,
                              window=window, **SHAPE)
    tc = TransformerConfig(dtype=torch.float32, num_kv_heads=num_kv_heads,
                           window=window, attention_impl=attention_impl,
                           **SHAPE)
    model = jt.Transformer(jc)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    return model, params, tc


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("window", [None, 5])
def test_logits_match_flax(num_kv_heads, window):
    model, params, tc = _pair(num_kv_heads, window)
    toks = np.random.RandomState(0).randint(0, 97, (2, 13)).astype(np.int32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(toks),
                                 train=False))
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    port = Transformer(tc, params=sd)
    with torch.inference_mode():
        out = port(torch.from_numpy(toks).long()).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_rope_and_dot_attention_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 4, 16).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(30, 39)]).astype(np.int32)
    np.testing.assert_allclose(
        tt.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jt.rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5, rtol=0)
    k = rs.randn(2, 9, 2, 16).astype(np.float32)
    v = rs.randn(2, 9, 2, 16).astype(np.float32)
    for causal, window in ((True, None), (True, 3), (False, 4)):
        np.testing.assert_allclose(
            tt.causal_dot_attention(
                torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(v),
                causal=causal, window=window).numpy(),
            np.asarray(jt.causal_dot_attention(
                jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                causal=causal, window=window)),
            atol=1e-5, rtol=0)


def test_state_dict_keeps_flax_names_and_bridge_checks_shapes():
    _, params, tc = _pair(2)
    flat = jax.tree.map(np.asarray, params)
    sd = params_from_flax(flat, tc, device="cpu")
    assert "layer_1.attn.q.kernel" in sd and "embed.embedding" in sd
    assert set(Transformer(tc, params=sd).state_dict()) == set(sd)
    bad = dict(flat)
    bad["ln_f"] = {"scale": np.ones((3,), np.float32)}
    with pytest.raises(ValueError, match="ln_f.scale"):
        params_from_flax(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_flax({"embed": flat["embed"]}, tc, device="cpu")


def test_non_paged_flash_forward_is_not_ported_yet():
    _, params, tc = _pair(attention_impl="flash")
    port = Transformer(tc, params=params_from_flax(
        jax.tree.map(np.asarray, params), tc, device="cpu"))
    with pytest.raises(NotImplementedError, match="training slice"):
        port(torch.zeros((1, 4), dtype=torch.long))


def test_init_params_follow_flax_scales():
    """init_params draws at flax's scales: the stds of a flax init and a
    port init of the same config agree leaf by leaf."""
    _, params, _ = _pair(2)
    tc = TransformerConfig(dtype=torch.float32, num_kv_heads=2,
                           **dict(SHAPE, vocab_size=2000))
    jc = jt.TransformerConfig(dtype=jnp.float32, num_kv_heads=2,
                              **dict(SHAPE, vocab_size=2000))
    jp = jt.Transformer(jc).init(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 4), jnp.int32),
                                 train=False)["params"]
    flat = params_from_flax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    mine = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert set(mine) == set(flat)
    for key, t in mine.items():
        assert t.shape == flat[key].shape and t.dtype == flat[key].dtype
        if key.endswith(".scale"):
            assert bool((t == 1).all())
        else:
            ref = float(flat[key].std())
            assert abs(float(t.std()) - ref) < 0.15 * ref, key
    again = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(again[k], mine[k]) for k in mine)
