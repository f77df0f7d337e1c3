"""The port's sharding policy and logical mesh against the JAX reference.

``repro_torch.sharding.policy.ShardingPolicy`` is the reference's
``repro.sharding.policy.ShardingPolicy`` rule for rule, its specs tuples
(``Spec``) where the reference's are ``PartitionSpec``s.  Held here: every
case of the reference's ``tests/test_policy.py``; every leaf's spec of all
ten configs on the 16 x 16 and 2 x 16 x 16 meshes (params, int8 optimizer
state with its ``QTensor`` children, batches, caches), equal as tuples to
the reference's; and ``device_bytes`` against a hand count.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.sharding.policy import _path_str
from repro.sharding.policy import make_policy as jax_make_policy
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import (
    LogicalMesh,
    dp_axes,
    make_mesh,
    make_production_mesh,
    model_axis_size,
)
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding.policy import Spec, device_bytes, make_policy, param_specs
from repro_torch.utils.tree import tree_flatten_with_path

MESH = make_mesh((16, 16), ("data", "model"))
MESH3 = make_mesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"1pod": MESH, "2pod": MESH3}


class FakeMesh:
    """The reference tests' duck-typed mesh: .shape mapping + .axis_names."""

    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


def _ref_mesh(mesh: LogicalMesh) -> FakeMesh:
    return FakeMesh(dict(mesh.shape))


# --------------------------------------------------------------------------
# the logical mesh (repro/launch/mesh.py)
# --------------------------------------------------------------------------
def test_production_mesh_is_logical_and_shaped_as_the_reference():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.axis_names == ("data", "model")
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.axis_names == ("pod", "data", "model")
    assert (one.size, two.size) == (256, 512)
    assert not hasattr(one, "devices")
    assert dp_axes(one) == ("data",) and dp_axes(two) == ("pod", "data")
    assert model_axis_size(one) == 16 and model_axis_size(make_mesh((4,), ("data",))) == 1
    assert one == make_production_mesh() and one != two
    with pytest.raises(ValueError):
        make_mesh((2, 0), ("data", "model"))


# --------------------------------------------------------------------------
# tests/test_policy.py, held against the port (and the reference's answer)
# --------------------------------------------------------------------------
def _both(method, *args, mesh=MESH, **kw):
    mine = getattr(make_policy(mesh, **kw), method)(*args)
    ref = getattr(jax_make_policy(_ref_mesh(mesh), **kw), method)(*args)
    assert isinstance(mine, Spec) and mine == tuple(ref), (method, args, mine, ref)
    return mine


def test_fit_drops_nondivisible():
    assert _both("fit", ("model",), (32,)) == ("model",)
    assert _both("fit", ("model",), (40,)) == (None,)       # 40 % 16 != 0
    assert _both("fit", ("data", "model"), (40, 64)) == (None, "model")
    assert _both("fit", (("data", "model"),), (512,)) == (("data", "model"),)
    assert _both("fit", (("data", "model"),), (40,)) == (None,)


def test_attention_head_fallback():
    # divisible heads: shard heads over model
    assert _both("param_spec", "blocks/attn_0/w_q", (40, 4096, 32, 128)) == \
        (None, "data", "model", None)
    # 40 heads (llama4): contraction-shard d_model over (data, model)
    assert _both("param_spec", "blocks/attn_0/w_q", (24, 5120, 40, 128)) == \
        (None, ("data", "model"), None, None)
    # kv=2 (glm4): same fallback
    assert _both("param_spec", "blocks/attn_0/w_k", (40, 4096, 2, 128)) == \
        (None, ("data", "model"), None, None)


def test_vocab_fallback():
    assert _both("param_spec", "embed", (151552, 4096)) == ("model", "data")
    assert _both("param_spec", "embed", (50280, 768)) == (None, "data")  # 50280%16!=0
    assert _both("param_spec", "lm_head", (4096, 151552)) == ("data", "model")
    assert _both("param_spec", "lm_head", (1024, 256206)) == ("data", None)


def test_moe_expert_parallel():
    assert _both("param_spec", "blocks/moe_1/w_up", (24, 128, 5120, 8192)) == \
        (None, "model", "data", None)
    assert _both("param_spec", "blocks/moe_1/w_down", (24, 128, 8192, 5120)) == \
        (None, "model", None, "data")
    # shared expert inside moe block = dense rules
    assert _both("param_spec", "blocks/moe_1/shared/w_up", (24, 5120, 8192)) == \
        (None, "data", "model")


def test_cache_specs_head_vs_seq():
    # kv=32 divisible: heads over model, batch over dp
    assert _both("cache_spec", "blocks/attn_0/k", (32, 128, 32768, 32, 96)) == \
        (None, "data", None, "model", None)
    # kv=8 NOT divisible: sequence over model (flash-decode style)
    assert _both("cache_spec", "blocks/attn_0/k", (48, 128, 32768, 8, 128)) == \
        (None, "data", "model", None, None)
    # long_500k: batch=1 -> sequence over data(+model)
    assert _both("cache_spec", "shared_attn/k", (6, 1, 524288, 32, 64),
                 shard_cache_seq=True) == (None, None, "data", "model", None)


def test_opt_state_specs_inherit_param_specs():
    cfg = get_config("glm4-9b", smoke=True)
    shapes = build_model(cfg).param_shapes()
    opt = init_opt_state(shapes, AdamWConfig(moment_dtype="int8"))
    pol = make_policy(make_mesh((2, 2), ("data", "model")))
    ospecs = pol.opt_specs(opt)
    got_m = dict(tree_flatten_with_path(ospecs["m"], is_leaf=lambda x: isinstance(x, Spec)))
    assert len(got_m) > 0
    # the int8 q tensor of each moment matches its parameter spec
    embed_spec = pol.param_spec("embed", (512, 64))
    assert got_m["embed/0"] == embed_spec
    assert got_m["embed/1"] == pol.fit(tuple(embed_spec)[:-1] + (None,), (512, 1))


def test_multipod_dp_axes():
    pol = make_policy(MESH3)
    assert pol.dp_axes == ("pod", "data")
    assert _both("batch_spec", "tokens", (256, 4096), mesh=MESH3) == (("pod", "data"), None)
    # batch=1 cannot shard over dp -> dropped
    assert _both("batch_spec", "tokens", (1,), mesh=MESH3) == (None,)


def test_hints_are_the_references_specs():
    """The reference's hints are NamedShardings of a device mesh (256 or 512
    devices, which the test process does not have): held to the
    PartitionSpecs its ``hints`` builds them from."""
    for mesh in MESHES.values():
        dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
        for vocab in (0, 151552, 50280):
            cfg = get_config("glm4-9b").scaled(vocab=vocab) if vocab else None
            mine = make_policy(mesh, cfg).hints()
            want = {"act_bsd": P(dp, None, None), "act_bshp": P(dp, None, "model", None),
                    "moe_ecd": P("model", None, None)}
            if vocab and vocab % 16 == 0:
                want["logits_bsv"] = P(dp, None, "model")
            assert {k: tuple(v) for k, v in want.items()} == mine


# --------------------------------------------------------------------------
# every leaf of all ten configs, both meshes
# --------------------------------------------------------------------------
def _ref_leaves(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(path): tuple(s) for path, s in flat}


def _my_leaves(specs) -> dict:
    return dict(tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, Spec)))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    model = jax_build(jax_config(arch))
    params = model.param_shapes()
    opt = jax.eval_shape(lambda: jax_init_opt_state(params,
                                                    JaxAdamWConfig(moment_dtype="int8")))
    return params, opt, model


@functools.lru_cache(maxsize=None)
def _my_shapes(arch: str):
    model = build_model(get_config(arch))
    params = model.param_shapes()
    return params, init_opt_state(params, AdamWConfig(moment_dtype="int8")), model


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_leaf_spec_equals_the_references(arch, mesh_name):
    mesh = MESHES[mesh_name]
    rmesh = _ref_mesh(mesh)
    jp, jo, jmodel = _ref_shapes(arch)
    mp, mo, mmodel = _my_shapes(arch)
    cfg = get_config(arch)
    pol = make_policy(mesh, cfg)
    rpol = jax_make_policy(rmesh, jax_config(arch))
    assert _my_leaves(pol.param_specs(mp)) == _ref_leaves(rpol.param_specs(jp))
    assert _my_leaves(pol.opt_specs(mo)) == _ref_leaves(rpol.opt_specs(jo))
    assert (_my_leaves(pol.state_specs({"params": mp, "opt": mo}))
            == _ref_leaves(rpol.state_specs({"params": jp, "opt": jo})))
    for shape, wl in JAX_SHAPES.items():
        small = wl.batch < mesh.shape["data"]
        for seq_cache in {False, small}:
            p2 = make_policy(mesh, cfg, shard_cache_seq=seq_cache)
            r2 = jax_make_policy(rmesh, jax_config(arch), shard_cache_seq=seq_cache)
            kind = "decode" if wl.kind == "decode" else wl.kind
            assert (_my_leaves(p2.batch_specs(mmodel.input_specs(kind, wl.batch, wl.seq)))
                    == _ref_leaves(r2.batch_specs(jmodel.input_specs(kind, wl.batch, wl.seq))))
            if wl.kind == "decode":
                mine = _my_leaves(p2.cache_specs(mmodel.cache_shapes(wl.batch, wl.seq)))
                ref = _ref_leaves(r2.cache_specs(jmodel.cache_shapes(wl.batch, wl.seq)))
                assert mine == ref, shape


def test_param_specs_function_is_the_policys():
    params = _my_shapes("dbrx-132b")[0]
    assert (_my_leaves(param_specs(params, MESH))
            == _my_leaves(make_policy(MESH).param_specs(params)))


# --------------------------------------------------------------------------
# per-device bytes under the specs
# --------------------------------------------------------------------------
def test_device_bytes_is_a_hand_count():
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    tree = {"embed": meta(151552, 4096), "blocks": [{"w": meta(64, 48, dt=torch.bfloat16)}],
            "step": meta(dt=torch.int32)}
    specs = {"embed": Spec("model", "data"), "blocks": [{"w": Spec(("data", "model"), None)}],
             "step": Spec()}
    want = 151552 * 4096 * 4 // 256 + 64 * 48 * 2 // 256 + 4
    assert device_bytes(tree, specs, MESH) == want
    # on the 2-pod mesh only the named axes divide: 'pod' shards nothing here
    assert device_bytes(tree, specs, MESH3) == want
    assert device_bytes(tree, {"embed": Spec(None, None), "blocks": [{"w": Spec(None, None)}],
                               "step": Spec()}, MESH) == 151552 * 4096 * 4 + 64 * 48 * 2 + 4
    with pytest.raises(ValueError):
        device_bytes(tree, {"embed": Spec(None, None)}, MESH)
    # the policy's own specs of a whole config: each leaf's share, summed
    params = _my_shapes("glm4-9b")[0]
    specs = make_policy(MESH).param_specs(params)
    total = sum(x.numel() * x.element_size() for _, x in tree_flatten_with_path(params))
    got = device_bytes(params, specs, MESH)
    assert total / 256 <= got < total / 16
