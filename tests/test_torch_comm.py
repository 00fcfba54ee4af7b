"""The port's wire: exact ledger integers pinned to the reference's
committed numbers, channel parity with the reference's VectorChannel, and
the device rule of the entry points and kernel wrappers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import VectorChannel as JaxVectorChannel
from repro_torch import interop
from repro_torch.api import ExperimentSpec, Problem, logistic_loss, make_problem
from repro_torch.comm import VectorChannel, WireLedger
from repro_torch.configs import PAPER_WORKLOADS
from repro_torch.core import DistributedCubicNewton, NewtonConfig
from repro_torch.data import paper_dataset
from repro_torch.kernels import LAUNCHES, cubic_solve, cubic_solve_plain

torch.set_num_threads(1)

# benchmarks/baselines/BENCH_table1_compression.json (a9a, m = 20) and the
# w8a specs, as the reference computes them
PINNED = [
    ("a9a-logistic", None, 78720, 3936),
    ("a9a-logistic", "topk:0.1", 9360, 3936),
    ("a9a-logistic", "topk_kernel:0.1", 9360, 3936),
    ("w8a-logistic", "topk:0.1", 24600, 9600),
    ("w8a-logistic", "topk_kernel:0.1", 24600, 9600),
    ("a9a-logistic", "signnorm", 3100, 3936),
    ("a9a-logistic", "int8", 20320, 3936),
    ("w8a-logistic", "signnorm", 6640, 9600),
    ("w8a-logistic", "int8", 49920, 9600),
    ("w8a-logistic", "randk:0.1", 19840, 9600),
]
# the baseline's 4-round a9a totals (its "<spec>.uplink_bits" and
# "<spec>.downlink_bits")
TABLE1_TOTALS = {"signnorm": (12400, 15744), "int8": (81280, 15744)}


@pytest.mark.parametrize("problem,compressor,up,down", PINNED)
def test_bits_per_round_pinned_to_reference_integers(problem, compressor,
                                                     up, down):
    spec = ExperimentSpec(problem=problem, m_workers=20,
                          compressor=compressor)
    cfg = spec.to_newton_config()
    algo = DistributedCubicNewton(None, cfg, spec.to_attack_config(),
                                  device="cpu")
    d = 123 if problem.startswith("a9a") else 300
    algo._ensure_channels(d, 20)
    bits = algo.bits_per_step()
    assert bits == {"uplink": up, "downlink": down}
    assert all(type(v) is int for v in bits.values())


@pytest.mark.parametrize("compressor", sorted(TABLE1_TOTALS))
def test_table1_compression_run_matches_reference(compressor):
    """``benchmarks/table1_communication.py``'s compression spec on a9a
    (robust regression, m = 20, norm_trim at β = 0.1, EF21, no attack),
    4 rounds to its gradient tolerance, in both packages over the
    reference's arrays: the loss trajectory within rtol 1e-5 (float32 sums
    in another order) and the ledger's integers exactly, the baseline's."""
    from repro.api import ExperimentSpec as JaxSpec

    jspec = JaxSpec(problem="a9a-robust", M=10.0, eta=1.0,
                    aggregator="norm_trim:0.1", attack="none", alpha=0.0,
                    compressor=compressor, downlink_compressor=None, seed=0)
    jexp = jspec.build()
    jw, jhist = jexp.run(4, grad_tol=0.02)
    exp = ExperimentSpec.from_dict(jspec.to_dict()).build(
        device="cpu",
        problem=interop.problem_from_reference(jexp.problem, device="cpu"))
    tw, thist = exp.run(4, grad_tol=0.02)
    assert thist["rounds"] == jhist["rounds"] == 4
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    for key in ("uplink_bits", "downlink_bits", "total_bits",
                "bits_cumulative"):
        assert thist[key] == jhist[key], key
    assert (thist["uplink_bits"], thist["downlink_bits"]) == \
        TABLE1_TOTALS[compressor]


def test_none_compressor_spec_bills_full_precision():
    ch = VectorChannel("uplink", "none", 123, 20)
    assert ch.bits_per_round() == 78720
    ledger = WireLedger()
    for _ in range(4):
        ledger.record(uplink=ch.bits_per_round())
    assert ledger.snapshot() == {"uplink_bits": 4 * 78720, "downlink_bits": 0,
                                 "total_bits": 4 * 78720, "rounds": 4}


@pytest.mark.parametrize("ef", ["none", "ef", "ef21"])
def test_channel_transmit_matches_reference(ef):
    """Two rounds of δ-compression with memory over a stack of senders:
    the reconstruction, the memory and the measured δ̂ agree."""
    m, d = 6, 50
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((m, d)).astype(np.float32) for _ in range(2)]
    ref = JaxVectorChannel("uplink", "topk:0.2", d, m, error_feedback=ef,
                           damping=0.75)
    out = VectorChannel("uplink", "topk_kernel:0.2", d, m, error_feedback=ef,
                        damping=0.75)
    rs, os_ = ref.init_state(), out.init_state("cpu")
    assert tuple(os_.shape) == tuple(rs.shape)
    for x in xs:
        rx, rs, rdelta = ref.transmit(jnp.asarray(x), rs,
                                      key=jax.random.PRNGKey(0), measure=True)
        ox, os_, odelta = out.transmit(torch.from_numpy(x), os_, measure=True)
        np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(os_.numpy(), np.asarray(rs), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(odelta), float(rdelta), rtol=1e-5)
    assert out.bits_per_round() == ref.bits_per_round()


def test_sparse_receive_matches_reference_payloads():
    m, d = 5, 40
    x = np.random.default_rng(4).standard_normal((m, d)).astype(np.float32)
    ref = JaxVectorChannel("uplink", "topk:0.25", d, m)
    out = VectorChannel("uplink", "topk_kernel:0.25", d, m)
    assert out.supports_sparse_receive and ref.supports_sparse_receive
    (rv, ri), _, rdelta, rw = ref.transmit_sparse(
        jnp.asarray(x), ref.init_state(), measure=True, per_sender=True)
    (ov, oi), _, odelta, ow = out.transmit_sparse(
        torch.from_numpy(x), out.init_state("cpu"), measure=True, per_sender=True)
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(float(odelta), float(rdelta), rtol=1e-5)
    np.testing.assert_allclose(ow.numpy(), np.asarray(rw), rtol=1e-5)
    assert not VectorChannel("uplink", "topk:0.25", d, m,
                             error_feedback="ef21").supports_sparse_receive


def test_build_without_a_card_raises(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExperimentSpec(problem="synthetic-logistic:200:8", m_workers=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedCubicNewton(None)
    assert spec.build(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: make_problem("synthetic-logistic:200:8", 4),
    lambda: paper_dataset(PAPER_WORKLOADS["a9a-logistic"]),
    lambda: Problem.from_numpy("p", "logistic", X_workers=np.zeros((2, 3, 4)),
                               y_workers=np.zeros((2, 3))),
    lambda: interop.to_tensor(np.zeros(3)),
    lambda: VectorChannel("uplink", "topk:0.5", 8, 4).init_state(),
], ids=["make_problem", "paper_dataset", "from_numpy", "interop",
        "init_state"])
def test_data_entry_points_default_to_the_card(monkeypatch, make):
    """Data made with no device named goes to the card, or raises without
    one -- it never lands on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_algorithm_on_the_card_refuses_cpu_data(monkeypatch):
    """An algorithm built for the card fed CPU tensors raises, in ``step``
    and in ``run``, rather than run the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    p = make_problem("synthetic-logistic:200:8", 4, device="cpu")
    for cfg in (NewtonConfig(compressor="topk_kernel:0.25"),
                NewtonConfig(compressor="topk_kernel:0.25",
                             error_feedback="none")):
        algo = DistributedCubicNewton(logistic_loss, cfg, device="cuda:0")
        with pytest.raises(ValueError, match="lives on cpu"):
            algo.step(p.w0, p.X_workers, p.y_workers)
        with pytest.raises(ValueError, match="lives on cpu"):
            algo.run(p.w0, p.X_workers, p.y_workers, 1)


def test_kernel_wrapper_takes_the_plain_version_on_a_cpu_tensor():
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((3, 10)).astype(np.float32))
    A = torch.from_numpy(rng.standard_normal((3, 10, 10)).astype(np.float32))
    H = A @ A.transpose(1, 2) / 10
    lr = torch.full((3,), 0.05)
    before = dict(LAUNCHES)
    s, it = cubic_solve(g, H, torch.zeros_like(g), lr, max_iters=40)
    ps, pit = cubic_solve_plain(g, H, torch.zeros_like(g), lr, M=10.0,
                                gamma=1.0, tol=1e-6, max_iters=40)
    assert torch.equal(s, ps) and torch.equal(it, pit)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        cubic_solve(g.to("meta"), H.to("meta"), torch.zeros_like(g, device="meta"),
                    lr.to("meta"))
