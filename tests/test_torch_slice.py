"""The slice as a whole: Algorithm 1 in the port against the reference,
built from the same spec over the same arrays (carried across through
``repro_torch.interop``), on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro_torch import interop
from repro_torch.api import ExperimentSpec, SpecError

torch.set_num_threads(1)

BASE = dict(problem="synthetic-logistic:1600:40", m_workers=8,
            compressor="topk_kernel:0.25", aggregator="norm_trim:0.4",
            attack="negative:0.9", alpha=0.25)
VARIANTS = {
    "ef21-negative": {},
    "sparse-center-flipped": {"error_feedback": "none",
                              "attack": "flipped_label"},
    # Remark 5 (a compressed gradient round), momentum, compressed downlink
    "remark5-momentum": {"exact_gradient": True, "grad_compressor": "topk:0.5",
                         "momentum": 0.5, "downlink_compressor": "topk:0.5"},
}
# the comparison rules: EF21 under the negative attack, and with no error
# feedback under flipped labels, where the uplink could hand over payloads
# but these rules keep the dense center
for _agg in ("krum_kernel:2", "trimmed_mean_kernel:0.375",
             "coordinate_median"):
    _name = _agg.partition(":")[0]
    VARIANTS[f"{_name}-negative"] = {"aggregator": _agg}
    VARIANTS[f"{_name}-flipped"] = {"aggregator": _agg,
                                    "attack": "flipped_label",
                                    "error_feedback": "none"}
# the coordinate-wise rules' soft keep is the fraction of coordinates each
# worker contributed to; float rounding may flip the rank of one near-equal
# coordinate between the two runs, which moves that fraction by 1/d
SOFT_KEEP = ("trimmed_mean", "coordinate_median")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_rounds_match_reference(variant):
    jspec = JaxSpec(**BASE).replace(**VARIANTS[variant])
    jexp = jspec.build()
    jw, jhist = jexp.run(3)
    # the reference's per-round keep masks, stepping its own runtime
    jalgo, jp = jexp.algo, jexp.problem
    w, v, st = jp.w0, jnp.zeros_like(jp.w0), jalgo.init_comm_state()
    key, jkeeps = jax.random.PRNGKey(0), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        w, v, st, info = jalgo.step(w, jp.X_workers, jp.y_workers, sub, v, st)
        jkeeps.append(np.asarray(info["keep"]))

    spec = ExperimentSpec.from_dict(jspec.to_dict())
    exp = spec.build(device="cpu",
                     problem=interop.problem_from_reference(jp, device="cpu"))
    tw, thist = exp.run(3)
    sparse = variant.startswith("sparse")
    keep_atol = (1.0 / jp.dim if variant.startswith(SOFT_KEEP) else 0.0)
    assert exp.algo._use_sparse_center is sparse
    assert jalgo._use_sparse_center is sparse
    assert exp.algo.bits_per_step() == jalgo.bits_per_step()
    assert exp.algo.center_bytes_per_round() == jalgo.center_bytes_per_round()

    assert set(thist) == set(jhist)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    for key_ in ("uplink_bits", "downlink_bits", "total_bits", "rounds",
                 "bits_cumulative"):
        assert thist[key_] == jhist[key_], key_

    # the same rounds stepped one by one from the reference's state
    algo = exp.algo
    w, v = interop.iterate_from_reference(jp.w0, device="cpu")
    st = interop.state_from_reference(jalgo.init_comm_state(),
                                      device="cpu")
    for r in range(3):
        w, v, st, info = algo.step(w, exp.problem.X_workers,
                                   exp.problem.y_workers, None, v, st)
        np.testing.assert_allclose(info["keep"].numpy(), jkeeps[r],
                                   rtol=0, atol=keep_atol)


def test_spec_round_trips_and_validates():
    spec = ExperimentSpec(problem="w8a-logistic", m_workers=20,
                          compressor="topk_kernel:0.1",
                          aggregator="norm_trim:0.3", attack="negative:0.9",
                          alpha=0.2)
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert spec.to_dict() == JaxSpec(**spec.to_dict()).to_dict()
    cfg = spec.to_newton_config()
    assert (cfg.error_feedback, cfg.ef_damping, cfg.solver_iters) == \
        ("ef21", 0.75, 500)
    with pytest.raises(SpecError, match="β > α"):
        spec.replace(aggregator="norm_trim:0.2").validate()
    with pytest.raises(SpecError, match="tracks a compressor"):
        spec.replace(compressor=None, error_feedback="ef21").validate()
    with pytest.raises(SpecError):
        spec.replace(compressor="topk:abc").validate()
    with pytest.raises(SpecError):
        spec.replace(m_workers=8).validate()
    with pytest.raises(SpecError):
        ExperimentSpec.from_dict({"no_such_field": 1})


@pytest.mark.parametrize("override", [
    {"runtime": "async"}, {"runtime": "mesh"},
    {"solver": "byzantine_pgd"}, {"compressor": "randk:0.1"},
    {"compressor": "signnorm"}, {"compressor": "int8"},
    {"problem": "matrix-factor:10:2", "m_workers": 4},
    {"compressor": "randk:32"},
])
def test_specs_outside_the_slice_name_their_roadmap_item(override):
    spec = ExperimentSpec(problem="a9a-logistic", m_workers=20,
                          compressor="topk_kernel:0.1").replace(**override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        spec.validate()


@pytest.mark.parametrize("override", [
    {"compressor": "adaptive_topk:0.05:0.5"},
    {"problem": "synthetic-logistic:8000:2000", "m_workers": 4},
])
def test_specs_this_slice_ports_validate_and_build(override):
    """Adaptive top-k and the top-k kernel past d = 1408 raised in the
    earlier slices; both now validate and build."""
    spec = ExperimentSpec(problem="a9a-logistic", m_workers=20,
                          compressor="topk_kernel:0.1").replace(**override)
    exp = spec.validate().build(device="cpu")
    exp.algo._ensure_channels(exp.problem.dim, exp.problem.m_workers)
    comp = exp.algo.uplink.compressor
    assert comp.use_kernel is (spec.compressor == "topk_kernel:0.1")
    assert comp.k == max(1, round(
        (0.05 if "adaptive" in spec.compressor else 0.1) * exp.problem.dim))
