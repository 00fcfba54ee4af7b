"""The port's serving path against the reference on the CPU.

The greedy loop (prefill token by token through ``decode_step``, then
greedy decode) against the reference's ``decode_step`` loop of
``launch/serve.py`` on reduced gemma3, over the reference's weights and the
same prompts: equal tokens, logits within 1e-4 (past the rolling window of
16).  The identity broadcast's bits against the reference's
``TreeChannel(DOWNLINK, None)``.  ``TokenStream`` in distribution (the
port draws from a ``torch.Generator``, so its tokens are not the
reference's).  The CLI at ``--preset smoke``; what is not ported raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import DOWNLINK, TreeChannel
from repro.configs import get_config as ref_get_config
from repro.data.synthetic import TokenStream as RefTokenStream
from repro.launch.serve import broadcast_params as ref_broadcast_params
from repro.models import build_model as ref_build_model
from repro.telemetry.core import _percentile as ref_percentile
from repro_torch.comm import WireLedger
from repro_torch.data import TokenStream
from repro_torch.interop import model_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import build_model

torch.set_num_threads(1)

LOGITS_ATOL = 1e-4


def _reference(arch="gemma3-27b", seed=0):
    cfg = ref_get_config(arch).reduced()
    model = ref_build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


def _ref_greedy(model, params, prompts, gen):
    """The reference's serving loop (``launch/serve.py:79-103``), keeping
    the logits each emitted token is the argmax of."""
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen)
    step = jax.jit(model.decode_step)
    logits = None
    for t in range(P):
        logits, cache = step(params, cache, prompts[:, t], jnp.int32(t))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, out_logits = [], []
    for t in range(P, P + gen):
        toks.append(tok)
        out_logits.append(logits)
        logits, cache = step(params, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.asarray(jnp.stack(toks, 1)), np.asarray(jnp.stack(out_logits, 1))


@pytest.mark.parametrize("prompt_len,gen", [(6, 6), (14, 10)])
def test_greedy_loop_matches_reference(prompt_len, gen):
    """The second case runs 24 positions through a window of 16: the rolling
    cache's slot wraps in both packages."""
    cfg, ref_model, params = _reference()
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (3, prompt_len)).astype(np.int32)
    want_toks, want_logits = _ref_greedy(ref_model, params,
                                         jnp.asarray(prompts), gen)
    model = build_model(cfg, device="cpu")
    port = model_params_from_reference(params, cfg, device="cpu")
    out = serve.greedy_generate(model, port, torch.from_numpy(prompts), gen)
    np.testing.assert_array_equal(out["tokens"].numpy(), want_toks)
    np.testing.assert_allclose(out["logits"].numpy(), want_logits, rtol=0,
                               atol=LOGITS_ATOL)
    assert len(out["decode_step_s"]) == gen


def test_broadcast_bits_match_the_reference_tree_channel():
    cfg, _, params = _reference()
    want = TreeChannel(DOWNLINK, None).bits_per_round(params)
    port = model_params_from_reference(params, cfg, device="cpu")
    ledger = WireLedger()
    received, info = serve.broadcast_params(port, None, ledger=ledger)
    assert received is port
    assert info["downlink_bits"] == info["full_precision_bits"] == want
    assert (ledger.downlink_bits, ledger.uplink_bits, ledger.rounds) == \
        (want, 0, 1)
    _, ref_info = ref_broadcast_params(params, None)
    assert info == ref_info


def test_int8_broadcast_and_unported_archs_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 items 13 and 15"):
        serve.main(["--preset", "smoke", "--device", "cpu", "--downlink",
                    "int8"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        serve.run_serving(arch="mamba2-780m", device="cpu")
    with pytest.raises(KeyError):
        serve.run_serving(arch="no-such-arch", device="cpu")


def test_percentile_is_the_reference_one():
    for vals in ([], [3.0], [0.5, 0.1, 0.9, 0.2], list(range(33))):
        vals = sorted(vals)
        for q in (0, 50, 90, 99, 100):
            assert serve._percentile(vals, q) == ref_percentile(vals, q)


def test_token_stream_follows_the_reference_law():
    """The bigram rule on every odd position, the reference's shift and
    working vocabulary, determinism per (seed, step), and the Zipf law on
    even positions: the ten most likely ids' frequencies within 5 standard
    errors of their probabilities, in the port's draws as in the
    reference's."""
    vocab, seed, B, S = 512, 3, 64, 256
    stream, ref = TokenStream(vocab, seed, device="cpu"), RefTokenStream(
        vocab, seed)
    assert (stream.active, stream._shift) == (ref.active, int(ref._shift))
    toks, targets = stream.batch(0, B, S)
    assert toks.shape == targets.shape == (B, S)
    assert torch.equal(toks[:, 1:], targets[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < stream.active
    odd = torch.arange(1, S, 2)
    assert torch.equal(toks[:, odd], (toks[:, odd - 1] + stream._shift)
                       % stream.active)
    again, _ = stream.batch(0, B, S)
    other, _ = stream.batch(1, B, S)
    assert torch.equal(toks, again) and not torch.equal(toks, other)

    p = stream._probs.double().numpy()
    np.testing.assert_allclose(p, np.asarray(ref._probs, np.float64),
                               rtol=1e-6)
    ref_toks = np.asarray(ref.batch(0, B, S)[0])
    n = B * (S // 2)
    se = np.sqrt(p[:10] * (1 - p[:10]) / n)
    for sample in (toks.numpy(), ref_toks):
        even = sample[:, ::2].reshape(-1)
        freq = np.bincount(even, minlength=stream.active)[:10] / n
        assert (np.abs(freq - p[:10]) <= 5 * se).all(), (freq, p[:10])


def test_cli_serves_the_smoke_preset_on_the_cpu(capsys):
    res = serve.main(["--preset", "smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    printed = capsys.readouterr().out
    assert "[serve] downlink=identity broadcast_bits=" in printed
    assert "[serve] arch=gemma3-27b-smoke batch=2 prefill=8tok" in printed
    assert "decode latency p50=" in printed and "over 4 steps" in printed
    assert res["tokens"].shape == (2, 4)
    assert res["wire"]["downlink_bits"] == 32 * res["param_count"]
    assert res["device"].type == "cpu"
