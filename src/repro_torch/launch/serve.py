"""Serving entry point: prefill and greedy decode through the KV-cache path
(the port of the reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \\
        --preset full --batch 4 --prompt-len 32 --gen 32

The parameter broadcast from the center to a replica is billed into a
:class:`~repro_torch.comm.WireLedger` as the reference's identity downlink
bills it: 32 bits a parameter.  The compressed broadcast
(``--downlink int8``) rides the reference's ``TreeChannel``, which comes
with the mesh slice.  The prompts are token by token through the decode
path, as in the reference (exactness over speed); the batched prefill is
``Model.forward``.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..api.errors import not_ported
from ..comm.ledger import WireLedger
from ..configs import get_config
from ..data.synthetic import TokenStream
from ..models import build_model


def _percentile(sorted_vals, q: float):
    """Nearest-rank percentile on a pre-sorted list (q in [0, 100]); a copy
    of the reference's ``telemetry/core.py::_percentile``."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _check_downlink(downlink) -> None:
    if downlink is not None:
        raise not_ported(f"the {downlink!r} parameter broadcast (TreeChannel)",
                         "Queue 1 items 13 and 15, the mesh slice")


def broadcast_params(params, downlink=None, *, ledger=None):
    """Distribute a parameter tree from the center to a replica.

    Returns ``(params_as_received, info)``, ``info`` carrying the exact
    ledger bits of the one broadcast round and the full-precision bits it
    replaced.  Only the identity wire (``downlink=None``, 32 bits a
    coordinate) is ported.
    """
    _check_downlink(downlink)
    ledger = ledger if ledger is not None else WireLedger()
    full_bits = 32 * sum(p.numel() for p in params.parameters())
    ledger.record(downlink=full_bits, rounds=1)
    return params, {
        "downlink_bits": ledger.downlink_bits,
        "full_precision_bits": full_bits,
        "saving": full_bits / max(ledger.downlink_bits, 1),
    }


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def greedy_generate(model, params, prompts, gen: int) -> dict:
    """Prefill ``prompts`` (B, P) token by token through ``decode_step``,
    then decode ``gen`` tokens greedily, as the reference's serving loop
    does.  Returns ``tokens`` (B, gen), ``logits`` (B, gen, V) -- the logits
    each emitted token is the argmax of -- and the host-clock seconds of
    the prefill, the decode and each decode step (each step ends in a
    synchronise)."""
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen)
    logits = None
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = model.decode_step(params, cache, prompts[:, t], t)
        _sync(logits)
    t_prefill = time.perf_counter() - t0

    out_tokens, out_logits, step_s = [], [], []
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    for t in range(P, P + gen):
        out_tokens.append(tok)
        out_logits.append(logits)
        tt0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = torch.argmax(logits, -1)
        _sync(tok)
        step_s.append(time.perf_counter() - tt0)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.stack(out_tokens, 1),
            "logits": torch.stack(out_logits, 1),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_step_s": step_s}


def run_serving(arch="gemma3-27b", preset="smoke", batch=4, prompt_len=32,
                gen=32, seed=0, downlink=None, device=None) -> dict:
    """Build ``arch`` (``preset`` "smoke": the reduced config; "full": the
    published one) with random weights from ``seed``, broadcast them, and
    serve ``batch`` prompts of ``prompt_len`` synthetic tokens for ``gen``
    greedy tokens.  Prints the reference's ``[serve]`` lines and returns
    the tokens, the broadcast's bits and the timings."""
    _check_downlink(downlink)   # before any weight is made
    cfg = get_config(arch)
    if preset == "smoke":
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    params = model.init(seed)
    params, wire = broadcast_params(params, downlink)
    print(f"[serve] downlink={downlink or 'identity'} "
          f"broadcast_bits={wire['downlink_bits']} "
          f"(full-precision {wire['full_precision_bits']}, "
          f"{wire['saving']:.2f}x saving)")

    stream = TokenStream(cfg.vocab_size, seed, device=model.device)
    prompts, _ = stream.batch(0, batch, prompt_len)
    out = greedy_generate(model, params, prompts, gen)
    t_prefill, t_dec = out["prefill_s"], out["decode_s"]
    tok_s = batch * gen / max(t_dec, 1e-9)
    print(f"[serve] arch={cfg.name} batch={batch} prefill={prompt_len}tok "
          f"({t_prefill:.2f}s) decode={gen}tok ({t_dec:.2f}s, "
          f"{tok_s:.1f} tok/s)")
    lat = sorted(out["decode_step_s"])
    p50, p99 = _percentile(lat, 50), _percentile(lat, 99)
    if lat:
        print(f"[serve] decode latency p50={p50 * 1e3:.1f}ms "
              f"p99={p99 * 1e3:.1f}ms over {len(lat)} steps")
    return {"tokens": out["tokens"], "wire": wire, "cfg": cfg,
            "param_count": model.param_count(params),
            "prefill_s": t_prefill, "decode_s": t_dec, "tok_per_s": tok_s,
            "p50_s": p50, "p99_s": p99, "device": model.device}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--downlink", default=None,
                    help="compress the parameter broadcast (not ported: "
                         "only the identity wire runs)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_serving(args.arch, args.preset, args.batch, args.prompt_len,
                       args.gen, downlink=args.downlink, device=args.device)


if __name__ == "__main__":
    main()
