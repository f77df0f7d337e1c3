"""The task form's numpy core in the port vs the JAX package's, bit for bit.

``repro_torch`` keeps its own copies of the reference's numpy modules (the
reference's package import pulls in jax).  Every copy must give the same
bits on the same seeds: PRNG derivation, service-time models, Algorithm 1
and the other allocators (with the committed golden fixture), the LT and
Gaussian plans, the host encode (rewritten with a bounded gather buffer),
the batch-arrival algebra, the adaptive engines (with their golden
fixture) and the streaming decoders.
"""
import json
import os

import numpy as np
import pytest

from repro.core import adaptive as ref_adaptive
from repro.core import allocation as ref_allocation
from repro.core import decoding as ref_decoding
from repro.core import distributions as ref_distributions
from repro.core import encoding as ref_encoding
from repro.core import simulator as ref_simulator
from repro.cluster import profiles as ref_profiles
from repro.cluster import straggler as ref_straggler
from repro.utils import prng as ref_prng
from repro_torch.cluster import profiles, straggler
from repro_torch.core import adaptive, allocation, decoding, distributions, encoding, simulator
from repro_torch.utils import prng

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _same(x, y) -> bool:
    """Bit-equal numpy values (NaN == NaN), lists, tuples, dicts or scalars."""
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
    if isinstance(x, float) and np.isnan(x):
        return isinstance(y, float) and np.isnan(y)
    return x == y


def _alloc_same(a, b) -> bool:
    return all(_same(getattr(a, f), getattr(b, f))
               for f in ("loads", "batches", "tau", "lams", "scheme", "coded"))


# --------------------------------------------------------------------------
# PRNG and service-time models
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 2])
def test_prng_copies_bit_equal(seed):
    tags = ("rate", seed % 7, "x")
    assert prng.derive(seed, *tags) == ref_prng.derive(seed, *tags)
    assert np.array_equal(prng.rng(seed).standard_normal(6), ref_prng.rng(seed).standard_normal(6))
    assert np.array_equal(prng.rng_scratch(seed).exponential(size=5),
                          ref_prng.rng_scratch(seed).exponential(size=5))
    seeds = np.array([prng.derive(seed, "t", t) for t in range(9)])
    got = [g.uniform(size=3) for g in prng.rng_scratch_iter(seeds)]
    want = [g.uniform(size=3) for g in ref_prng.rng_scratch_iter(seeds)]
    assert _same(got, want)


def test_service_time_models_bit_equal():
    got = distributions.sample_heterogeneous_cluster(12, seed=4)
    want = ref_distributions.sample_heterogeneous_cluster(12, seed=4)
    assert [(w.mu, w.alpha) for w in got] == [(w.mu, w.alpha) for w in want]
    for port_m, ref_m in [
        (distributions.ShiftedExp(mu=9.4e4, alpha=1.7e-4),
         ref_distributions.ShiftedExp(mu=9.4e4, alpha=1.7e-4)),
        (distributions.Weibull(k=1.5, scale=2e-3, shift=1e-4),
         ref_distributions.Weibull(k=1.5, scale=2e-3, shift=1e-4)),
        (distributions.Pareto(xm=3e-4, a=2.5), ref_distributions.Pareto(xm=3e-4, a=2.5)),
    ]:
        assert np.array_equal(port_m.sample_task_rate(11, 7), ref_m.sample_task_rate(11, 7))
        assert port_m.mean_time(400) == ref_m.mean_time(400)
        s_port, s_ref = distributions.as_shifted_exp(port_m), ref_distributions.as_shifted_exp(ref_m)
        assert (s_port.mu, s_port.alpha) == (s_ref.mu, s_ref.alpha)
    times = ref_distributions.ShiftedExp(mu=30.0, alpha=0.02).sample_task_rate(3, 200) * 50
    est, ref_est = (distributions.estimate_parameters(times, 50),
                    ref_distributions.estimate_parameters(times, 50))
    assert (est.mu, est.alpha) == (ref_est.mu, ref_est.alpha)


def test_profiles_and_straggler_policies_bit_equal():
    for idx in (1, 2, 3, 4):
        r, w = profiles.ec2_scenario(idx)
        r_ref, w_ref = ref_profiles.ec2_scenario(idx)
        assert r == r_ref and [(x.name, x.mu, x.alpha) for x in w] == [
            (x.name, x.mu, x.alpha) for x in w_ref]
        r, w = profiles.paper_sim_scenario(idx, seed=2)
        r_ref, w_ref = ref_profiles.paper_sim_scenario(idx, seed=2)
        assert r == r_ref and [(x.mu, x.alpha) for x in w] == [(x.mu, x.alpha) for x in w_ref]
    assert np.array_equal(straggler.StragglerPolicy(prob=0.3).draw(9, 5),
                          ref_straggler.StragglerPolicy(prob=0.3).draw(9, 5))
    got = straggler.ChurnPolicy(drift_prob=0.6, drift_mag=4.0, death_prob=0.2).sample(8, 2.0, 3)
    want = ref_straggler.ChurnPolicy(drift_prob=0.6, drift_mag=4.0, death_prob=0.2).sample(8, 2.0, 3)
    assert [(e.t, e.worker, e.kind, e.factor) for e in got.events] == [
        (e.t, e.worker, e.kind, e.factor) for e in want.events]
    _, _, alloc, churn = profiles.late_join_scenario(1, seed=1)
    _, _, alloc_ref, churn_ref = ref_profiles.late_join_scenario(1, seed=1)
    assert _alloc_same(alloc, alloc_ref)
    assert [(e.t, e.worker, e.kind) for e in churn.events] == [
        (e.t, e.worker, e.kind) for e in churn_ref.events]


# --------------------------------------------------------------------------
# Algorithm 1 and the other allocators
# --------------------------------------------------------------------------
def test_golden_allocation_fixture_applies_unchanged():
    with open(os.path.join(FIXTURES, "golden_allocation.json")) as f:
        golden = json.load(f)
    cluster = distributions.sample_heterogeneous_cluster(10, seed=0)
    assert [(w.mu, w.alpha) for w in cluster] == [(w["mu"], w["alpha"]) for w in golden["workers"]]
    workers = [distributions.ShiftedExp(**w) for w in golden["workers"]]
    r = golden["r"]
    for cell in golden["grid"]:
        alloc = allocation.bpcc_allocation(r, workers, p=cell["p"])
        assert alloc.tau == pytest.approx(cell["tau"], rel=1e-9)
        assert np.array_equal(alloc.loads, cell["loads"])
        assert np.array_equal(alloc.batches, cell["batches"])
        assert np.allclose(alloc.lams, cell["lams"], rtol=1e-9)
    assert allocation.tau_star_supremum(r, workers) == pytest.approx(golden["tau_supremum"], rel=1e-9)
    assert allocation.tau_star_infimum(r, workers) == pytest.approx(golden["tau_infimum"], rel=1e-9)


@pytest.mark.parametrize("scheme", ["uniform", "load_balanced", "hcmm", "bpcc"])
@pytest.mark.parametrize("scenario", [1, 2])
def test_allocators_bit_equal(scheme, scenario):
    _, workers = profiles.ec2_scenario(scenario)
    _, workers_ref = ref_profiles.ec2_scenario(scenario)
    models = [w.model for w in workers]
    models_ref = [w.model for w in workers_ref]
    for r in (400, 5650):
        for kw in ({}, {"p": 3}) if scheme == "bpcc" else ({},):
            got = allocation.allocate(scheme, r, models, **kw)
            want = ref_allocation.allocate(scheme, r, models_ref, **kw)
            assert _alloc_same(got, want), (scheme, r, kw)
    got = allocation.infimum_allocation(5000, models)
    want = ref_allocation.infimum_allocation(5000, models_ref)
    assert _alloc_same(got, want)


# --------------------------------------------------------------------------
# Codes and the host encode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("r,q", [(1, 3), (40, 30), (400, 700)])
def test_plans_bit_equal(r, q):
    codes = [(encoding.LTCode(r, seed=5), ref_encoding.LTCode(r, seed=5)),
             (encoding.GaussianCode(r, seed=5), ref_encoding.GaussianCode(r, seed=5))]
    if q >= r:  # without the systematic prefix an LT plan needs q >= r
        codes.append((encoding.LTCode(r, seed=5, systematic_prefix=False),
                      ref_encoding.LTCode(r, seed=5, systematic_prefix=False)))
    for port_code, ref_code in codes:
        got, want = port_code.plan(q), ref_code.plan(q)
        assert (got.kind, got.r, got.q) == (want.kind, want.r, want.q)
        assert _same(got.indices, want.indices) and _same(got.coeffs, want.coeffs)
        assert _same(got.dense_generator(), want.dense_generator())
    assert _same(encoding.robust_soliton(r), ref_encoding.robust_soliton(r))
    for kind in ("lt", "gaussian"):
        assert encoding.required_rows(r, kind) == ref_encoding.required_rows(r, kind)


def _zeros_mid_row_plan(mod, r, q, seed):
    g = np.random.default_rng(seed)
    idx = g.integers(0, r, (q, 9)).astype(np.int32)
    cof = g.standard_normal((q, 9)).astype(np.float32)
    cof[g.random((q, 9)) < 0.4] = 0.0
    cof[0] = 0.0  # a degree-0 row
    return mod.EncodePlan(indices=idx, coeffs=cof, r=r, q=q, kind="lt")


# (r, q, m, dtype, max_bytes): the default bound, then bounds small enough
# to cut the groups into single rows and the rows into 1024-column pieces
ENCODE_CASES = [
    (400, 700, 64, np.float32, None),
    (50, 60, 1, np.float32, None),
    (50, 60, 3, np.float64, 4096),
    (400, 500, 129, np.float32, 4096),
    (50, 80, 2500, np.float32, 64),
    (7, 60, 2500, np.float64, 64),
]


@pytest.mark.parametrize("r,q,m,dtype,max_bytes", ENCODE_CASES)
@pytest.mark.parametrize("code", ["lt", "gaussian", "zeros mid-row"])
def test_bounded_encode_matrix_equals_reference(r, q, m, dtype, max_bytes, code):
    a = np.random.default_rng(r + q + m).standard_normal((r, m)).astype(dtype)
    if code == "lt":
        plan, plan_ref = encoding.LTCode(r, seed=q).plan(q), ref_encoding.LTCode(r, seed=q).plan(q)
    elif code == "gaussian":
        plan = encoding.GaussianCode(r, seed=q).plan(q)
        plan_ref = ref_encoding.GaussianCode(r, seed=q).plan(q)
    else:
        plan, plan_ref = _zeros_mid_row_plan(encoding, r, q, q), _zeros_mid_row_plan(ref_encoding, r, q, q)
    kw = {} if max_bytes is None else {"max_bytes": max_bytes}
    got = encoding.encode_matrix(a, plan, **kw)
    want = ref_encoding.encode_matrix(a, plan_ref)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --------------------------------------------------------------------------
# Batch-arrival algebra and the Monte-Carlo engines
# --------------------------------------------------------------------------
def test_batch_arrival_schedule_and_completion_bit_equal():
    _, workers = profiles.ec2_scenario(2)
    models = [w.model for w in workers]
    _, workers_ref = ref_profiles.ec2_scenario(2)
    models_ref = [w.model for w in workers_ref]
    for scheme in ("uniform", "load_balanced", "hcmm", "bpcc"):
        alloc = allocation.allocate(scheme, 500, models)
        alloc_ref = ref_allocation.allocate(scheme, 500, models_ref)
        rates = simulator.sample_rates(models, 17, 0.3)
        assert np.array_equal(rates, ref_simulator.sample_rates(models_ref, 17, 0.3))
        assert _same(simulator.batch_arrival_schedule(alloc, rates),
                     ref_simulator.batch_arrival_schedule(alloc_ref, rates))
        assert simulator.completion_time(alloc, rates, 520) == ref_simulator.completion_time(
            alloc_ref, rates, 520)


@pytest.mark.parametrize("scheme", ["hcmm", "bpcc"])
def test_simulate_scheme_bit_equal(scheme):
    workers = distributions.sample_heterogeneous_cluster(8, seed=3)
    workers_ref = ref_distributions.sample_heterogeneous_cluster(8, seed=3)
    got = simulator.simulate_scheme(scheme, 2000, workers, n_trials=30, seed=7, straggler_prob=0.2)
    want = ref_simulator.simulate_scheme(scheme, 2000, workers_ref, n_trials=30, seed=7,
                                         straggler_prob=0.2)
    assert np.array_equal(got.times, want.times)
    t = np.linspace(0.0, float(want.times.max()), 9)
    alloc = allocation.allocate(scheme, 2000, workers)
    alloc_ref = ref_allocation.allocate(scheme, 2000, workers_ref)
    assert np.array_equal(simulator.accumulation_curve(alloc, workers, t, n_trials=5, seed=1),
                          ref_simulator.accumulation_curve(alloc_ref, workers_ref, t,
                                                           n_trials=5, seed=1))


def test_simulate_adaptive_bit_equal():
    _, workers = profiles.ec2_scenario(1)
    _, workers_ref = ref_profiles.ec2_scenario(1)
    models, models_ref = [w.model for w in workers], [w.model for w in workers_ref]
    alloc = allocation.allocate("bpcc", 452, models)
    alloc_ref = ref_allocation.allocate("bpcc", 452, models_ref)
    rates = simulator.sample_rates(models, 9)

    def churn(mod):
        return mod.ChurnSchedule((mod.ChurnEvent(t=0.01, worker=0, kind="death"),
                                  mod.ChurnEvent(t=0.008, worker=1, kind="rate", factor=5.0)))

    reserve = int(np.ceil(0.5 * alloc.total_rows))
    margin = adaptive.control_margin(adaptive.ReallocationPolicy(), "lt", 0.13)
    assert margin == ref_adaptive.control_margin(ref_adaptive.ReallocationPolicy(), "lt", 0.13)
    got = adaptive.simulate_adaptive(
        alloc, models, rates, required=452, capacity=alloc.total_rows + reserve,
        churn=churn(adaptive), policy=adaptive.ReallocationPolicy(), required_margin=margin)
    want = ref_adaptive.simulate_adaptive(
        alloc_ref, models_ref, rates, required=452, capacity=alloc_ref.total_rows + reserve,
        churn=churn(ref_adaptive), policy=ref_adaptive.ReallocationPolicy(),
        required_margin=margin)
    assert got.events == want.events
    assert got.reallocations == want.reallocations
    assert got.capacity_used == want.capacity_used and got.t_complete == want.t_complete
    assert len(got.reallocations) > 0


def test_golden_adaptive_fixture_applies_unchanged():
    with open(os.path.join(FIXTURES, "golden_adaptive.json")) as f:
        g = json.load(f)
    workers = [distributions.ShiftedExp(**w) for w in g["workers"]]
    res = simulator.simulate_adaptive_scheme(
        "bpcc", g["r"], workers, churn=straggler.ChurnPolicy(**g["churn_policy"]),
        policy=adaptive.ReallocationPolicy(), p=g["p"], n_trials=g["n_trials"],
        seed=g["seed"], engine="batch",
    )
    assert res.topup_rows.tolist() == g["topup_rows"]
    for name in ("times_static", "times_adaptive", "times_oracle"):
        got = getattr(res, name)
        want = np.array([np.inf if v is None else v for v in g[name]])
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), name
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, err_msg=name)


@pytest.mark.parametrize("engine", ["batch", "scalar"])
def test_simulate_adaptive_scheme_bit_equal(engine):
    workers = distributions.sample_heterogeneous_cluster(6, seed=2)
    workers_ref = ref_distributions.sample_heterogeneous_cluster(6, seed=2)
    kw = dict(p=8, n_trials=6, seed=5, engine=engine)
    got = simulator.simulate_adaptive_scheme(
        "bpcc", 900, workers, churn=straggler.ChurnPolicy(drift_prob=0.5, drift_mag=3.0,
                                                           death_prob=0.2),
        policy=adaptive.ReallocationPolicy(), **kw)
    want = ref_simulator.simulate_adaptive_scheme(
        "bpcc", 900, workers_ref, churn=ref_straggler.ChurnPolicy(drift_prob=0.5, drift_mag=3.0,
                                                                  death_prob=0.2),
        policy=ref_adaptive.ReallocationPolicy(), **kw)
    for name in ("times_static", "times_adaptive", "times_oracle", "topup_rows"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_serving_controllers_bit_equal():
    lat = np.random.default_rng(3).exponential(1.0, (40, 16))
    lat[:, 4] *= 30.0
    pc, pc_ref = adaptive.ParityController(16, decay=0.6), ref_adaptive.ParityController(16, decay=0.6)
    dp = adaptive.DeadlineAwareParity(adaptive.ParityController(16))
    dp_ref = ref_adaptive.DeadlineAwareParity(ref_adaptive.ParityController(16))
    rc, rc_ref = adaptive.ReplicationController(8), ref_adaptive.ReplicationController(8)
    for i, row in enumerate(lat):
        for c, c_ref in ((pc, pc_ref), (dp, dp_ref), (rc, rc_ref)):
            c.observe(row[:8] if c is rc else row)
            c_ref.observe(row[:8] if c is rc else row)
        assert pc.parity_level(4) == pc_ref.parity_level(4)
        assert dp.level(4, slack_steps=float(i % 7)) == dp_ref.level(4, slack_steps=float(i % 7))
        assert rc.replication(range(4)) == rc_ref.replication(range(4))
    assert np.array_equal(pc.posterior, pc_ref.posterior)
    assert np.array_equal(rc.mult, rc_ref.mult)


# --------------------------------------------------------------------------
# Streaming decoders
# --------------------------------------------------------------------------
@pytest.mark.parametrize("code", ["lt", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_decoders_bit_equal(code, seed):
    rng = np.random.default_rng(seed)
    r = 60
    a = rng.standard_normal((r, 3))
    cls, cls_ref = ((encoding.LTCode, ref_encoding.LTCode) if code == "lt"
                    else (encoding.GaussianCode, ref_encoding.GaussianCode))
    q = encoding.required_rows(r, "lt") + 30 if code == "lt" else r + 10
    plan, plan_ref = cls(r, seed=seed).plan(q), cls_ref(r, seed=seed).plan(q)
    coded = ref_encoding.encode_matrix(a, plan_ref)
    order = rng.permutation(q)
    dec = decoding.StreamingDecoder.for_plan(plan, 3)
    dec_ref = ref_decoding.StreamingDecoder.for_plan(plan_ref, 3)
    pos = 0
    while pos < q:
        k = int(rng.integers(1, 9))
        ids = order[pos:pos + k]
        dec.ingest(ids, coded[ids])
        dec_ref.ingest(ids, coded[ids])
        assert dec.decodable == dec_ref.decodable
        pos += k
    assert _same(dec.finalize(), dec_ref.finalize())
    if code == "lt":
        got = decoding.peel_decode_np(coded[order], plan.indices[order], plan.coeffs[order], r)
        want = ref_decoding.peel_decode_np(coded[order], plan.indices[order],
                                           plan.coeffs[order], r)
    else:
        g = plan.dense_generator()[order]
        got, want = decoding.ls_decode_np(g, coded[order]), ref_decoding.ls_decode_np(g, coded[order])
    assert _same(got, want)
    assert got[1] and np.allclose(got[0], a, atol=1e-6)
