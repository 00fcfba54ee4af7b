"""Synthetic data generators: twins of the reference's
``data/synthetic.py`` of the same shapes, drawn from a seeded
``torch.Generator`` (the reference draws from JAX's threefry, which cannot
be replayed, so the values differ; tests hand the reference's arrays over
through :mod:`repro_torch.interop` instead).

* LIBSVM twins (paper experiments): binary classification matched to the
  published a9a / w8a shapes, from a ground-truth separator + label noise.
* Robust-regression data with heavy-tailed outliers (the target of the
  paper's non-convex loss, Eq. (9)).
* Token streams for the LM architectures (Zipf-distributed with a bigram
  rule, :class:`TokenStream`).

Every generator draws on ``generator``'s device, so the data are made in
bulk where they are used.  The draws depend on that device as well as the
seed: PyTorch's CPU and CUDA generators give different numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device


def _normal(shape, generator):
    return torch.randn(shape, generator=generator, device=generator.device)


def _uniform(shape, generator):
    return torch.rand(shape, generator=generator, device=generator.device)


def make_classification(generator, n, d, *, label_noise=0.05, margin=1.0):
    """Linear-separator binary data: X (n,d), y∈{0,1} (n,), w_star (d,)."""
    X = _normal((n, d), generator)
    w_star = margin * _normal((d,), generator) / math.sqrt(d)
    p = torch.sigmoid(X @ w_star / 0.5)
    y = (_uniform((n,), generator) < p).to(torch.float32)
    flip = _uniform((n,), generator) < label_noise
    y = torch.where(flip, 1.0 - y, y)
    return X, y, w_star


def make_regression(generator, n, d, *, noise=0.1, outlier_frac=0.1,
                    outlier_scale=10.0):
    """Linear data with heavy-tailed outliers (robust-regression target)."""
    X = _normal((n, d), generator)
    w_star = _normal((d,), generator) / math.sqrt(d)
    y = X @ w_star + noise * _normal((n,), generator)
    out_mask = _uniform((n,), generator) < outlier_frac
    y = torch.where(out_mask, y + outlier_scale * _normal((n,), generator), y)
    return X, y, w_star


def shard_to_workers(X, y, m):
    """Split pooled (n, …) data into m worker shards: (m, n/m, …)."""
    n = (X.shape[0] // m) * m
    return (
        X[:n].reshape(m, n // m, *X.shape[1:]),
        y[:n].reshape(m, n // m, *y.shape[1:]),
    )


def paper_dataset(workload, seed=0, device=None):
    """Build the train/test twin of a paper workload (see configs) on
    ``device`` (default the card; raises when none is present unless
    ``device="cpu"``), from ``seed``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))
    if workload.problem == "logistic":
        Xtr, ytr, w_star = make_classification(gen, workload.n_train,
                                               workload.dim)
        Xte, yte, _ = make_classification(gen, workload.n_test, workload.dim)
        # re-label test with the same separator for a consistent task
        p = torch.sigmoid(Xte @ w_star / 0.5)
        yte = (p > 0.5).to(torch.float32)
    else:
        Xtr, ytr, w_star = make_regression(gen, workload.n_train, workload.dim)
        Xte, yte, _ = make_regression(gen, workload.n_test, workload.dim,
                                      outlier_frac=0.0)
    Xm, ym = shard_to_workers(Xtr, ytr, workload.m_workers)
    return {
        "X_workers": Xm,
        "y_workers": ym,
        "X_train": Xtr,
        "y_train": ytr,
        "X_test": Xte,
        "y_test": yte,
        "w_star": w_star,
    }


# ----------------------------- LM token streams ---------------------------


class TokenStream:
    """Zipf + bigram synthetic token source, deterministic per (seed, step),
    on ``device`` (the card unless ``device="cpu"``).

    The law is the reference's: tokens are drawn from the first
    ``min(vocab_size, 4096)`` ids with probability ∝ rank^(-zipf_a), and
    every odd position holds the previous token plus a fixed shift (drawn
    from numpy's generator as the reference draws it, so the shift is the
    reference's).  The draws come from a ``torch.Generator``, so the tokens
    follow the reference's distribution but are not its tokens.
    """

    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2,
                 device=None):
        self.vocab = vocab_size
        self.seed = seed
        self.device = resolve_device(device)
        # a modest working vocabulary, so the bigram structure is learnable
        self.active = min(vocab_size, 4096)
        rng = np.random.default_rng(seed)
        self._shift = int(rng.integers(1, self.active - 1))
        ranks = np.arange(1, self.active + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._probs = torch.tensor(p / p.sum(), dtype=torch.float32,
                                   device=self.device)

    def batch(self, step: int, batch_size: int, seq_len: int):
        """tokens, targets: (batch, seq) int64."""
        state = np.random.SeedSequence([self.seed, step]).generate_state(2)
        gen = torch.Generator(device=self.device).manual_seed(
            int(state[0]) << 32 | int(state[1]))
        base = torch.multinomial(self._probs, batch_size * (seq_len + 1),
                                 replacement=True, generator=gen)
        base = base.reshape(batch_size, seq_len + 1)
        # the bigram: odd positions hold the shifted copy of the token before
        odd = torch.arange(seq_len + 1, device=self.device) % 2 == 1
        shifted = (torch.roll(base, 1, dims=1) + self._shift) % self.active
        toks = torch.where(odd[None, :], shifted, base)
        return toks[:, :-1], toks[:, 1:]
