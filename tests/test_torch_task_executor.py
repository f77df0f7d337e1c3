"""The port's task form (``ClusterEmulator.run_task``) vs the JAX package's.

With ``encode_mode=None`` the task is all numpy in both packages, so every
payload field — ``y``, the masks and row counts, the arrival order, the
reallocation records — must be bit-equal on the same seed, for every scheme,
both codes, adaptive top-ups under churn, and a real-process backend.  With a
device encode the port encodes all of Â, static rows and reserve, through
its kernels' plain PyTorch versions on the CPU (``encode_mode="off"`` or
``"device"``, ``device="cpu"``), against the reference's device mode (its
static rows on the host, its reserve through the Pallas kernels in interpret
mode): the coded rows then come from other summation orders, so the
trajectory and ``t_complete`` must be equal and ``y`` within the reference's
own bound.
"""
import numpy as np
import pytest
import torch

from repro.cluster import ClusterEmulator as RefEmulator
from repro.cluster import TaskSpec as RefSpec
from repro.cluster import ec2_scenario as ref_ec2_scenario
from repro.core import adaptive as ref_adaptive
from repro_torch.cluster import ClusterEmulator, ProcessBackend, TaskSpec, ec2_scenario
from repro_torch.core import adaptive

TS = 0.02  # model -> wall seconds: each paced run takes well under a second


@pytest.fixture(scope="module")
def small_task():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((400, 64)).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    return a, x


def _churn(mod):
    return mod.ChurnSchedule((
        mod.ChurnEvent(t=0.01, worker=0, kind="death"),
        mod.ChurnEvent(t=0.008, worker=1, kind="rate", factor=5.0),
    ))


def _pair(a, x, seed=9, *, backend=None, **spec):
    """The same task through the port (on the CPU) and the reference; the
    host encode (``encode_mode=None``) unless another mode is named."""
    _, workers = ec2_scenario(1)
    _, workers_ref = ref_ec2_scenario(1)
    spec.setdefault("encode_mode", None)
    ref_spec = dict(spec)
    if spec.get("adaptive"):
        spec["adaptive"], ref_spec["adaptive"] = (adaptive.ReallocationPolicy(),
                                                  ref_adaptive.ReallocationPolicy())
    if spec.get("churn"):
        spec["churn"], ref_spec["churn"] = _churn(adaptive), _churn(ref_adaptive)
    if ref_spec.get("encode_mode") in ("off", "device"):
        ref_spec["encode_mode"] = "interpret"  # the Pallas kernels, run on the CPU
    em = ClusterEmulator(workers, time_scale=TS, seed=seed, device="cpu")
    got = em.run_task(a, x, TaskSpec(**spec), backend=backend)
    want = RefEmulator(workers_ref, time_scale=TS, seed=seed).run_task(a, x, RefSpec(**ref_spec))
    return got, want, em


def assert_payload_equal(got, want):
    for name in got.PAYLOAD_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        else:
            assert g == w, name
    assert got.arrival_order() == want.arrival_order()
    assert got.arrivals == want.arrivals  # model seconds: bit-equal too
    assert got.reallocations == want.reallocations
    assert got.t_complete == want.t_complete


@pytest.mark.parametrize("scheme", ["uniform", "load_balanced", "hcmm", "bpcc"])
@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_static_task_payload_bit_equal(small_task, scheme, code):
    a, x = small_task
    got, want, em = _pair(a, x, scheme=scheme, code=code)
    assert got.ok
    assert_payload_equal(got, want)
    assert em.last_encode is None  # no device encode was asked for


@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_terminal_decode_payload_bit_equal(small_task, code):
    a, x = small_task
    got, want, _ = _pair(a, x, seed=4, code=code, streaming=False)
    assert_payload_equal(got, want)


@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_adaptive_churn_payload_bit_equal(small_task, code):
    a, x = small_task
    got, want, _ = _pair(a, x, code=code, adaptive=True, churn=True)
    assert got.ok and len(got.reallocations) > 0
    assert_payload_equal(got, want)


@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_device_encode_off_vs_reference_interpret(small_task, code):
    """All of Â through the port's plain kernels (CPU), against the
    reference's static rows on the host and reserve through its Pallas
    kernels (interpret): same trajectory, y within the reference's bound of
    its own device-encode test."""
    a, x = small_task
    got, want, em = _pair(a, x, code=code, adaptive=True, churn=True, encode_mode="off")
    assert got.ok and want.ok
    assert got.arrivals == want.arrivals
    assert got.reallocations == want.reallocations
    assert got.rows_assigned == want.rows_assigned > 0
    ref = a.astype(np.float64) @ x
    assert np.abs(got.y - ref).max() / np.abs(ref).max() < 2e-3
    assert np.abs(got.y - want.y).max() / np.abs(ref).max() < 2e-3
    enc = em.last_encode
    assert enc["device"] == "cpu" and enc["mode"] == "off"
    assert enc["rows"] == enc["plan"].q == got.rows_assigned
    assert enc["static_rows"] + enc["reserve_rows"] == enc["rows"]
    assert enc["reserve_rows"] > 0 and enc["static_rows"] > 0
    assert enc["nonzeros"] == int(np.count_nonzero(enc["plan"].coeffs))
    # and the host-encode run of the same seed follows the same trajectory
    host, _, _ = _pair(a, x, code=code, adaptive=True, churn=True)
    assert host.arrivals == got.arrivals and host.reallocations == got.reallocations


@pytest.mark.parametrize("mode", ["device", "off"])
@pytest.mark.parametrize("scheme", ["hcmm", "bpcc"])
@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_static_task_encodes_all_rows_on_the_device(small_task, mode, scheme, code):
    """The paper's static task (no adaptive policy) with a device encode:
    every row of Â through the plain kernels on the named CPU, in one
    encode; the reference's trajectory and t_complete bit for bit (its
    device mode encodes a static task on the host), y within 2e-3 of A·x
    and of the reference's y."""
    a, x = small_task
    got, want, em = _pair(a, x, scheme=scheme, code=code, encode_mode=mode)
    assert got.ok and want.ok
    assert got.arrivals == want.arrivals and got.t_complete == want.t_complete
    assert got.reallocations == want.reallocations == []
    assert np.array_equal(got.rows_mask, want.rows_mask)
    assert got.rows_received == want.rows_received
    enc = em.last_encode
    assert enc["mode"] == mode and enc["device"] == "cpu" and enc["kind"].endswith(code)
    assert enc["rows"] == enc["static_rows"] == got.rows_assigned == want.rows_assigned
    assert enc["reserve_rows"] == 0 and enc["plan"].q == enc["rows"]
    assert min(enc["h2d_s"], enc["encode_s"], enc["d2h_s"]) >= 0.0
    ref = a.astype(np.float64) @ x
    assert np.abs(got.y - ref).max() / np.abs(ref).max() < 2e-3
    assert np.abs(got.y - want.y).max() / np.abs(ref).max() < 2e-3


@pytest.mark.parametrize("scheme", ["uniform", "load_balanced"])
def test_uncoded_task_encodes_nothing(small_task, scheme):
    """An uncoded scheme sends A itself: no encode in any mode, and the
    payload stays the reference's bit for bit."""
    a, x = small_task
    got, want, em = _pair(a, x, scheme=scheme, encode_mode="device")
    assert em.last_encode is None
    assert_payload_equal(got, want)


def test_process_backend_payload_bit_equal(small_task):
    """Real OS-process workers (spawned, numpy rows only) against the
    reference's model-time oracle."""
    a, x = small_task
    got, want, _ = _pair(a, x, backend=ProcessBackend(tier="process"), code="lt")
    assert got.backend == "process" and np.isfinite(got.t_wall)
    for name in got.PAYLOAD_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert np.array_equal(g, w) if isinstance(w, np.ndarray) else g == w, name
    assert got.arrival_order() == want.arrival_order()


def test_encode_modes():
    assert TaskSpec().encode_mode == "device"  # by the emulator's device
    assert TaskSpec(encode_mode=None).encode_mode is None
    assert TaskSpec(encode_mode="cuda").encode_mode == "cuda"
    assert TaskSpec(encode_mode="compile").encode_mode == "compile"
    assert TaskSpec(encode_mode="auto").encode_mode == "auto"  # per-shape dispatch
    with pytest.raises(ValueError, match="encode_mode"):
        TaskSpec(encode_mode="triton")


def test_device_encode_without_cuda_needs_a_named_device(small_task, monkeypatch):
    """A device encode with no device named — the default spec's included —
    runs on the card, and raises where there is none; the kernel mode on a
    named CPU raises too, since nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, x = small_task
    _, workers = ec2_scenario(1)
    for mode in ("device", "off"):
        for spec in (TaskSpec(code="lt", adaptive=adaptive.ReallocationPolicy(),
                              churn=_churn(adaptive), encode_mode=mode),
                     TaskSpec(code="lt", encode_mode=mode)):  # static: all of Â
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ClusterEmulator(workers, time_scale=TS, seed=9).run_task(a, x, spec)
    with pytest.raises(ValueError, match="CUDA"):
        ClusterEmulator(workers, time_scale=TS, seed=9, device="cpu").run_task(
            a, x, TaskSpec(code="lt", adaptive=adaptive.ReallocationPolicy(),
                           churn=_churn(adaptive), encode_mode="cuda"))


@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_default_encode_runs_on_the_named_device(small_task, code):
    """The default spec encodes all of Â on the emulator's device (here the
    named CPU, so the plain versions): the host run's trajectory, y within
    the reference's bound; a later static task on the same emulator encodes
    all of its Â there too, and an uncoded one reports no encode."""
    a, x = small_task
    _, workers = ec2_scenario(1)
    em = ClusterEmulator(workers, time_scale=TS, seed=9, device="cpu")
    got = em.run_task(a, x, TaskSpec(code=code, adaptive=adaptive.ReallocationPolicy(),
                                     churn=_churn(adaptive)))
    enc = em.last_encode
    assert enc["mode"] == "device" and enc["device"] == "cpu"
    assert enc["rows"] == got.rows_assigned and enc["reserve_rows"] > 0
    assert enc["static_rows"] + enc["reserve_rows"] == enc["rows"]
    host, _, _ = _pair(a, x, code=code, adaptive=True, churn=True)
    assert got.ok and got.arrivals == host.arrivals
    assert got.reallocations == host.reallocations
    ref = a.astype(np.float64) @ x
    assert np.abs(got.y - ref).max() / np.abs(ref).max() < 2e-3
    static = em.run_task(a, x, TaskSpec(code=code))  # static: all of Â on the device
    enc = em.last_encode
    assert enc["mode"] == "device" and enc["device"] == "cpu"
    assert enc["rows"] == enc["static_rows"] == static.rows_assigned > 0
    assert enc["reserve_rows"] == 0
    em.run_task(a, x, TaskSpec(scheme="uniform", code=code))  # uncoded: no encode
    assert em.last_encode is None
