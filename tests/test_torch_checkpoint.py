"""Port checkpoints and elastic re-gridding (``repro_torch.runtime``) vs the JAX reference.

* Cross-package: a whole train state (fp32 params, int8 ``QTensor`` or
  bf16 moments, the int32 step, the compression residual) saved by the
  reference restores in the port bit for bit, and the other way round; the
  manifests name the same leaves with the same shapes and dtypes.
* ``plan_mesh_shape``: equal to the reference's over a grid of inputs.
* The reference's ``tests/test_runtime.py`` contracts, mirrored in the
  port: round trip, latest step and retention, atomicity, async saves and
  their errors, shape checks; and a run of 10 steps equals 5 steps, a
  save, a restore and 5 more, bit for bit.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamW
from repro.runtime import checkpoint as jck
from repro.runtime.elastic import plan_mesh_shape as jax_plan
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import init_train_state as jax_init_state
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, QTensor
from repro_torch.runtime import (
    gc_checkpoints,
    latest_step,
    plan_mesh_shape,
    restore_checkpoint,
    save_checkpoint,
    shrink_mesh,
)
from repro_torch.runtime.checkpoint import wait_for_saves
from repro_torch.runtime.elastic import LogicalMesh, make_mesh_from_devices
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves
from repro_torch.weights import train_state_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree():
    return {
        "a": torch.arange(12.0).reshape(3, 4),
        "b": {"c": torch.ones(5, dtype=torch.int32), "d": torch.zeros((2, 2), dtype=torch.bfloat16)},
    }


def _equal_trees(x, y):
    lx, ly = tree_leaves(x), tree_leaves(y)
    assert len(lx) == len(ly)
    for a, b in zip(lx, ly):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path, tree):
    save_checkpoint(str(tmp_path), 7, tree)
    step, restored = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    _equal_trees(tree, restored)


def test_checkpoint_latest_and_gc(tmp_path, tree):
    for s in (5, 10, 15, 20):
        save_checkpoint(str(tmp_path), s, tree)
    assert latest_step(str(tmp_path)) == 20
    assert gc_checkpoints(str(tmp_path), keep=2) == [5, 10]
    assert latest_step(str(tmp_path)) == 20


def test_checkpoint_atomicity(tmp_path, tree):
    save_checkpoint(str(tmp_path), 3, tree)
    os.makedirs(tmp_path / ".tmp-9")
    (tmp_path / ".tmp-9" / "leaf-00000.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 3
    assert restore_checkpoint(str(tmp_path), tree)[0] == 3


def test_checkpoint_async(tmp_path, tree):
    save_checkpoint(str(tmp_path), 42, tree, blocking=False)
    wait_for_saves()
    assert latest_step(str(tmp_path)) == 42


def test_gc_ignores_incomplete_and_sweeps_tmp(tmp_path, tree):
    for s in (5, 10, 15):
        save_checkpoint(str(tmp_path), s, tree)
    os.makedirs(tmp_path / "step_00000020")
    (tmp_path / "step_00000020" / "leaf-00000.npy").write_bytes(b"partial")
    os.makedirs(tmp_path / ".tmp-7-0")
    assert gc_checkpoints(str(tmp_path), keep=2) == [5]
    assert sorted(os.listdir(tmp_path)) == ["step_00000010", "step_00000015"]
    assert latest_step(str(tmp_path)) == 15


def test_async_save_error_reraised(tmp_path, tree, monkeypatch):
    import repro_torch.runtime.checkpoint as ck

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", boom)
    save_checkpoint(str(tmp_path), 9, tree, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        wait_for_saves()
    monkeypatch.undo()
    wait_for_saves()
    assert latest_step(str(tmp_path)) is None


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), dict(tree, a=torch.zeros(4, 4)))
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), dict(tree, z=torch.zeros(1)))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


# ---- cross-package ------------------------------------------------------------
def _ref_state(moment_dtype, compression):
    jc = jax_config("zamba2-1.2b", smoke=True)
    tcfg = JaxTrainConfig(microbatches=2, gradient_coding="cyclic" if compression else None,
                          compression=compression)
    js = jax_init_state(jax_build(jc), jax.random.key(1), JaxAdamW(moment_dtype=moment_dtype),
                        tcfg)
    # make every leaf non-trivial: the moments from a draw, a step count
    rng = np.random.default_rng(0)

    def fill(x):
        if isinstance(x, jax.Array) and x.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, x.shape).astype(np.int8))
        if isinstance(x, jax.Array) and x.ndim > 0:
            return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)
        return x

    js = {**js, "opt": {**jax.tree.map(fill, {k: js["opt"][k] for k in ("m", "v")}),
                        "step": jnp.asarray(13, jnp.int32)}}
    if "err" in js:
        js["err"] = jax.tree.map(fill, js["err"])
    return js


@pytest.mark.parametrize("moment_dtype,compression", [("int8", "int8"), ("bfloat16", None),
                                                      ("float32", None)])
def test_checkpoints_cross_between_packages(tmp_path, moment_dtype, compression):
    js = _ref_state(moment_dtype, compression)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    # reference -> port
    jck.save_checkpoint(str(tmp_path / "ref"), 13, js)
    template = init_train_state(
        build_model(get_config("zamba2-1.2b", smoke=True)), None,
        AdamWConfig(moment_dtype=moment_dtype),
        TrainConfig(microbatches=2, gradient_coding="cyclic" if compression else None,
                    compression=compression), device="cpu")
    step, got = restore_checkpoint(str(tmp_path / "ref"), template)
    assert step == 13
    _equal_trees(got, ts)
    if moment_dtype == "int8":
        q = got["opt"]["m"]["embed"]
        assert isinstance(q, QTensor) and q.pow == 4 and q.shape == tuple(q.q.shape)
    # port -> reference
    save_checkpoint(str(tmp_path / "port"), 14, got)
    jstep, back = jck.restore_checkpoint(str(tmp_path / "port"), js)
    assert jstep == 14
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # same manifests, leaf for leaf
    with open(tmp_path / "ref" / "step_00000013" / "manifest.json") as f:
        mref = json.load(f)["leaves"]
    with open(tmp_path / "port" / "step_00000014" / "manifest.json") as f:
        mport = json.load(f)["leaves"]
    assert mref == mport


# ---- elastic ------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 3, 8, 15, 16, 240, 256, 512])
@pytest.mark.parametrize("model", [1, 4, 16])
def test_plan_mesh_shape_matches_reference(n, model):
    assert plan_mesh_shape(n, model=model) == jax_plan(n, model=model)
    if n >= 2 * model:
        assert plan_mesh_shape(n, model=model, pod=2) == jax_plan(n, model=model, pod=2)
    with pytest.raises(ValueError):
        plan_mesh_shape(n, model=model, pod=n + 1)


def test_shrink_mesh_drops_the_dead_dp_slice():
    mesh = make_mesh_from_devices(range(8), (2, 4), ("data", "model"))
    assert isinstance(mesh, LogicalMesh) and mesh.shape == {"data": 2, "model": 4}
    new = shrink_mesh(mesh, {int(d) for d in mesh.devices[1]})
    assert new.shape == {"data": 1, "model": 4}
    assert new.devices.tolist() == [[0, 1, 2, 3]]
    # a TP shrink when too few survive
    assert shrink_mesh(mesh, {0, 1, 2, 3, 4}).shape == {"data": 1, "model": 2}


# ---- restart -----------------------------------------------------------------
def test_train_restart_reproduces(tmp_path):
    """10 steps straight == 5 steps, save, restore into a fresh state, 5
    more — bit for bit, int8 moments and compression residuals included."""
    cfg = get_config("mamba2-130m", smoke=True).scaled(dtype="float32")
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-2, moment_dtype="int8")
    tc = TrainConfig(microbatches=2, gradient_coding="frc", compression="int8")
    step = make_train_step(model, opt, tc)
    pipe = make_pipeline(cfg, seq=16, global_batch=4)

    def fresh():
        return init_train_state(model, torch.Generator().manual_seed(0), opt, tc, device="cpu")

    st = fresh()
    for i in range(10):
        st, _ = step(st, pipe.batch(i))
    st2 = fresh()
    for i in range(5):
        st2, _ = step(st2, pipe.batch(i))
    save_checkpoint(str(tmp_path), 5, st2)
    other = init_train_state(model, torch.Generator().manual_seed(9), opt, tc, device="cpu")
    k, st3 = restore_checkpoint(str(tmp_path), other)
    assert k == 5
    for i in range(5, 10):
        st3, _ = step(st3, pipe.batch(i))
    _equal_trees(st, st3)
