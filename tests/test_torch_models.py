"""The port's model zoo (dense decoders) against the reference on the CPU.

The kernels' plain versions against the reference's oracles and Pallas
kernels (interpret mode): RMSNorm against ``rmsnorm_ref`` and ``rmsnorm``;
attention against ``flash_attention_ref``, ``flash_attention``,
``attention_bshd`` (grouped kv heads) and the models' ``chunked_attention``
(any S).  The layers (``rms_norm``, ``apply_rope``, ``swiglu``,
``decode_attention``) against the reference's.  The reduced forwards of the
four dense architectures, over the reference's own weights carried across
by ``interop``, within 1e-4 of the reference's logits, and the port's
decode against its own forward past the rolling window.  Float32 inputs
are made from a seed with numpy and handed to both packages.

Tolerances: float32 results within 1e-5 where one layer or kernel is
compared (sums in another order), 1e-4 on a whole forward's logits (the
reference's own decode-versus-forward test allows 2e-4); bf16 results within
rtol 2^-7 (one to two bf16 ulps) and atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import flash_attention_ref, rmsnorm_ref
from repro.kernels.rmsnorm import rmsnorm as ref_rmsnorm
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models.decoder import layer_plan as ref_layer_plan
from repro_torch.configs import ARCHS, NOT_PORTED, VARIANTS, get_config
from repro_torch.interop import model_params_from_reference
from repro_torch.kernels import (
    LAUNCHES,
    attention_bshd,
    attention_plain,
    rmsnorm,
    rmsnorm_nd,
    rmsnorm_plain,
)
from repro_torch.models import attention, build_model, layers
from repro_torch.models.decoder import layer_kinds, layer_plan

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
FORWARD_ATOL = 1e-4
DENSE = ["gemma3-27b", "codeqwen1.5-7b", "internlm2-20b", "llama3-405b",
         "llama3-405b-swa"]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------ RMSNorm


@pytest.mark.parametrize("n,d", [(64, 128), (5, 100), (4, 256), (128, 5376)])
def test_rmsnorm_plain_matches_reference_float32(n, d):
    x, w = _rand(n, n, d, scale=3.0), _rand(d, d, scale=0.1)
    got = rmsnorm(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, _np(rmsnorm_ref(jnp.asarray(x),
                                                    jnp.asarray(w))),
                               rtol=F32_TOL, atol=F32_TOL)
    block = 16 if n % 16 == 0 else n     # the Pallas kernel needs N % block
    pallas = ref_rmsnorm(jnp.asarray(x), jnp.asarray(w), block_rows=block)
    np.testing.assert_allclose(got, _np(pallas), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n,d", [(64, 128), (4, 5376)])
def test_rmsnorm_plain_matches_reference_bf16(n, d):
    x, w = _rand(n, n, d, scale=3.0), _rand(d, d, scale=0.1)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    got = rmsnorm(_t(x, torch.bfloat16), _t(w, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    for want in (rmsnorm_ref(xj, wj), ref_rmsnorm(xj, wj, block_rows=n)):
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


def test_rmsnorm_nd_takes_any_batch_shape_and_launches_nothing_on_cpu():
    x, w = _rand(0, 2, 3, 64), _rand(1, 64)
    before = dict(LAUNCHES)
    got = rmsnorm_nd(_t(x), _t(w))
    assert got.shape == (2, 3, 64)
    np.testing.assert_array_equal(
        got.numpy(), rmsnorm_plain(_t(x).reshape(6, 64), _t(w)).reshape(
            2, 3, 64).numpy())
    assert LAUNCHES == before


def test_rmsnorm_rejects_bad_inputs():
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(3, 4), torch.zeros(5))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros(3, 4, dtype=torch.float64), torch.zeros(4))


# ---------------------------------------------------------- attention


def _qkv(seed, B, S, H, Hkv, Dh):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, S, h, Dh)).astype(np.float32)
                 for h in (H, Hkv, Hkv))


def _bhsd(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


# (B, S, H, Hkv, Dh): narrow heads, and recurrentgemma-9b's Dh = 256; the
# explicit ids keep the narrow cases' names stable across added widths
NARROW, WIDE = (2, 64, 3, 3, 64), (1, 64, 2, 2, 256)


@pytest.mark.parametrize("causal,window,dims", [
    pytest.param(True, 0, NARROW, id="True-0"),
    pytest.param(True, 8, NARROW, id="True-8"),
    pytest.param(True, 16, NARROW, id="True-16"),
    pytest.param(False, 0, NARROW, id="False-0"),
    pytest.param(True, 0, WIDE, id="True-0-Dh256"),
    pytest.param(True, 16, WIDE, id="True-16-Dh256"),
])
def test_attention_plain_matches_flash_reference(causal, window, dims):
    """Head-major oracle and the Pallas kernel (interpret mode), S = 64 in
    tiles of 16; the port reads the model's (B, S, H, Dh) layout."""
    q, k, v = _qkv(window + causal, *dims)
    got = attention_bshd(_t(q), _t(k), _t(v), causal=causal, window=window)
    got = got.numpy().transpose(0, 2, 1, 3)
    args = (_bhsd(q), _bhsd(k), _bhsd(v))
    np.testing.assert_allclose(
        got, _np(flash_attention_ref(*args, causal=causal, window=window)),
        rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        got, _np(ref_flash(*args, causal=causal, window=window, block_q=16,
                           block_k=16)), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("window,dims", [
    pytest.param(0, (1, 48, 4, 2, 64), id="0"),
    pytest.param(16, (1, 48, 4, 2, 64), id="16"),
    pytest.param(16, (1, 48, 4, 1, 256), id="16-mqa-Dh256"),
])
def test_attention_plain_matches_attention_bshd_with_gqa(window, dims):
    """Grouped kv heads: the reference repeats them before its kernel; the
    port's kernel and plain version read kv head h // (H / Hkv).  One kv
    head at Dh = 256 is recurrentgemma-9b's attention."""
    q, k, v = _qkv(7 + window, *dims)
    got = attention_bshd(_t(q), _t(k), _t(v), window=window).numpy()
    want = ref_ops.attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window,
                                  block_q=16, block_k=16)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S,Hkv,window", [(37, 4, 0), (37, 2, 0), (37, 2, 16),
                                          (50, 1, 16), (64, 2, 16)])
def test_chunked_attention_matches_reference(S, Hkv, window):
    """The models' prefill attention at any S (the reference pads to its
    chunk), with and without grouped kv heads and the window."""
    q, k, v = _qkv(S + Hkv + window, 2, S, 4, Hkv, 64)
    got = attention.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                      window=window or None, q_chunk=16,
                                      kv_chunk=16).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = ref_attention.chunked_attention(jq, jk, jv, causal=True,
                                           window=window or None,
                                           q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)
    oracle = ref_attention.reference_attention(jq, jk, jv, causal=True,
                                               window=window or None)
    np.testing.assert_allclose(got, _np(oracle), rtol=F32_TOL, atol=F32_TOL)


def test_reference_attention_with_query_offset():
    """The oracle's q_offset (queries at the end of a longer key run)."""
    q, _, _ = _qkv(1, 1, 5, 4, 2, 64)
    _, k, v = _qkv(2, 1, 20, 4, 2, 64)
    got = attention.reference_attention(_t(q), _t(k), _t(v), window=8,
                                        q_offset=15).numpy()
    want = ref_attention.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=8, q_offset=15)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)


def test_attention_plain_bf16_matches_reference():
    q, k, v = _qkv(3, 1, 40, 4, 2, 128)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    got = attention_plain(tq, tk, tv, window=16)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = ref_attention.reference_attention(jq, jk, jv, window=16)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError):
        attention_bshd(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(TypeError):
        attention_bshd(q, q.double(), q.double())


# ------------------------------------------------------------- layers


def test_rms_norm_apply_rope_swiglu_match_reference():
    x = _rand(0, 2, 9, 4, 64, scale=2.0)
    pos = np.broadcast_to(np.arange(3, 12), (2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        got = layers.apply_rope(_t(x), torch.from_numpy(pos.copy()), theta)
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    h, w = _rand(1, 2, 5, 32), _rand(2, 32, scale=0.1)
    np.testing.assert_allclose(
        layers.rms_norm(_t(h), _t(w)).numpy(),
        _np(ref_layers.rms_norm(jnp.asarray(h), jnp.asarray(w))),
        rtol=F32_TOL, atol=F32_TOL)
    wg, wu, wd = _rand(3, 32, 48), _rand(4, 32, 48), _rand(5, 48, 32)
    np.testing.assert_allclose(
        layers.swiglu(_t(h), _t(wg), _t(wu), _t(wd)).numpy(),
        _np(ref_layers.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd)))),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("cache_len,window", [(7, None), (20, None), (20, 6)])
def test_decode_attention_matches_reference(cache_len, window):
    r = np.random.default_rng(cache_len)
    q = r.standard_normal((2, 4, 64)).astype(np.float32)
    kc = r.standard_normal((2, 20, 2, 64)).astype(np.float32)
    vc = r.standard_normal((2, 20, 2, 64)).astype(np.float32)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), cache_len,
                                     window=window).numpy()
    want = ref_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), cache_len,
        window=window)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------ configs


def test_configs_are_the_reference_ones():
    for name in DENSE:
        cfg, ref = get_config(name), ref_get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert (cfg.padded_vocab, cfg.resolved_head_dim) == \
            (ref.padded_vocab, ref.resolved_head_dim)
        assert layer_plan(cfg) == ref_layer_plan(ref)
    assert sorted(ARCHS) + sorted(VARIANTS) == sorted(DENSE[:4]) + [DENSE[4]]
    assert layer_plan(get_config("gemma3-27b")) == ("LLLLLG", 10, "LL")


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_archs_raise_naming_the_roadmap_item(arch):
    ref_get_config(arch)                     # the reference has it
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        layer_kinds(ref_get_config(arch))


def test_loss_fn_raises_naming_the_training_slice():
    model = build_model(get_config("gemma3-27b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 items 14-15"):
        model.loss_fn(None, {})


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("gemma3-27b").reduced())


# -------------------------------------------------------- whole models


def _ref_model(cfg, seed=0):
    model = ref_build_model(cfg)
    return model, model.init(jax.random.PRNGKey(seed))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _gemma_gqa():
    return dataclasses.replace(ref_get_config("gemma3-27b").reduced(),
                               num_kv_heads=2)


@pytest.mark.parametrize("arch", DENSE + ["gemma3-gqa"])
def test_reduced_forward_matches_reference(arch):
    """float32, (2, 37): S no multiple of the reference's chunk of 16 and
    past gemma3's window of 16; 'gemma3-gqa' has 2 kv heads for 4 query
    heads (every reduced dense config has as many kv heads as heads)."""
    cfg = _gemma_gqa() if arch == "gemma3-gqa" else \
        ref_get_config(arch).reduced()
    ref_model, params = _ref_model(cfg)
    toks = _tokens(cfg, 2, 37, 1)
    want, _ = ref_model.forward(params, jnp.asarray(toks, jnp.int32))
    model = build_model(cfg, device="cpu")
    got, aux = model.forward(model_params_from_reference(params, cfg,
                                                         device="cpu"),
                             torch.from_numpy(toks))
    assert got.shape == (2, 37, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=FORWARD_ATOL)


def test_interop_carries_every_layer_in_the_scans_order():
    cfg = ref_get_config("gemma3-27b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=14)     # 2 repeats + 2 tail
    _, params = _ref_model(cfg, seed=2)
    port = model_params_from_reference(params, cfg, device="cpu")
    unit, reps, tail = layer_plan(cfg)
    assert (unit, reps, tail) == ("LLLLLG", 2, "LL")
    assert [b.kind for b in port.layers] == list(unit * reps + tail)
    for r in range(reps):
        for j in range(len(unit)):
            got = port.layers[r * len(unit) + j].attn.wq.numpy()
            np.testing.assert_array_equal(
                got, _np(params["unit"][f"b{j}"]["attn"]["wq"][r]))
    np.testing.assert_array_equal(
        port.layers[13].mlp.w_down.numpy(),
        _np(params["tail"]["b1"]["mlp"]["w_down"]))
    assert build_model(cfg, device="cpu").param_count(port) == sum(
        int(np.size(a)) for a in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("arch", ["gemma3-27b", "gemma3-gqa", "llama3-405b"])
def test_decode_matches_forward_past_the_window(arch):
    """Token-by-token decode against the port's own forward: 24 tokens
    with max_len 32 and gemma3's reduced window of 16, so the rolling
    cache's slot wraps (the reference's test stops at 12 tokens)."""
    cfg = _gemma_gqa() if arch == "gemma3-gqa" else \
        get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(4)
    toks = torch.from_numpy(_tokens(cfg, 2, 24, 5))
    fwd, _ = model.forward(params, toks)
    cache = model.init_cache(2, 32)
    if cfg.window:
        assert cache[0]["k"].shape[1] == cfg.window == 16
    for t in range(24):
        lg, cache = model.decode_step(params, cache, toks[:, t], t)
        err = float((lg - fwd[:, t]).abs().max())
        assert err < 2e-4, (t, err)


def test_init_is_seeded_and_bf16_at_the_published_dtype():
    cfg = dataclasses.replace(get_config("gemma3-27b").reduced(),
                              dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    a, b, c = model.init(0), model.init(0), model.init(1)
    assert a.embed.dtype == torch.bfloat16
    assert torch.equal(a.lm_head, b.lm_head)
    assert not torch.equal(a.lm_head, c.lm_head)
    std = float(a.layers[0].mlp.w_up.float().std())
    assert abs(std - 0.02) < 1e-3
    assert float(a.final_norm.abs().sum()) == 0.0
    logits, _ = model.forward(a, torch.zeros(1, 5, dtype=torch.long))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
