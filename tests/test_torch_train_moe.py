"""Training of the moe family in the port against the JAX reference.

dbrx-132b (every layer routed, top-2 of 4 at the smoke size) and
llama4-maverick (period 2: a dense-FFN layer, then a top-1 MoE layer with
an always-on shared expert), SMOKE configs in float32.  Before the loss and
its gradient are compared, the routing ids: at every MoE layer's real input
the port's stable-sort top-k picks what ``lax.top_k`` picks.  Then
``Model.loss`` (0.01 x the Switch aux loss included) and each gradient leaf,
the router's among them, with remat on and off (remat recomputes the
routing in the backward); the whole train step (plain over 4 microbatches,
FRC and cyclic under one straggler, FRC under an undecodable mask); a
checkpoint of each package restored by the other; the launcher.  The
shared cases and tolerances are in ``tests/torch_train_families.py``.
"""
import pytest
import torch

import torch_train_families as fam
from repro_torch.models.moe import moe_apply, route

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(fam.one_torch_thread)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_reference(arch, remat):
    fam.check_routing_ids(arch)
    grads = fam.check_loss_and_grad(arch, remat)
    _, tc = fam.cfgs(arch)
    params = fam.params_from_numpy(fam.jax.tree.map(fam.np.asarray, fam.jax_params(arch)), "cpu")
    names = [path for path, _ in fam.tree_flatten_with_path(params)]
    router = [g for n, g in zip(names, grads) if n.endswith("/router")]
    assert len(router) == 1 and float(router[0].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradient_bits(arch):
    """Under remat the backward recomputes each group, routing included: it
    must pick the same slots, so the gradient has the bits it has without
    remat."""
    _, _, on = fam.torch_loss_and_grad(arch, remat=True)
    _, _, off = fam.torch_loss_and_grad(arch, remat=False)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_moe_gradient_paths():
    """The router's gradient reaches the probabilities only through the
    top-k gates and the aux loss's mean; a dropped assignment passes no
    gradient to the expert weights or to its token."""
    g = torch.Generator().manual_seed(0)
    d, f, e = 16, 32, 4
    p = {"router": torch.randn(d, e, generator=g).requires_grad_(True),
         "w_up": (torch.randn(e, d, f, generator=g) * 0.2).requires_grad_(True),
         "w_gate": (torch.randn(e, d, f, generator=g) * 0.2).requires_grad_(True),
         "w_down": (torch.randn(e, f, d, generator=g) * 0.2).requires_grad_(True)}
    x = torch.randn(1, 12, d, generator=g).requires_grad_(True)
    kw = dict(top_k=2, capacity_factor=0.5, kind="swiglu")
    r = route(p, x.reshape(12, d), top_k=2, capacity_factor=0.5)
    assert not bool(r.keep.all())          # capacity 1: some assignments dropped
    gx, = torch.autograd.grad(moe_apply(p, x, **kw)[0].sum(), x)
    tokens_all_dropped = ~r.keep.reshape(12, 2).any(dim=1)
    assert bool(tokens_all_dropped.any())
    assert float(gx[0, tokens_all_dropped].abs().max()) == 0.0
    # an expert that keeps no assignment gets no gradient
    kept_experts = set(r.ids.reshape(-1)[r.keep].tolist())
    gw, = torch.autograd.grad(moe_apply(p, x, **kw)[0].sum(), p["w_up"])
    for ex in range(e):
        assert (float(gw[ex].abs().max()) > 0) == (ex in kept_experts)
    # aux: its router gradient is E * d/dθ sum_e f_e mean_t(p_e), f held fixed
    ga, = torch.autograd.grad(moe_apply(p, x, **kw)[1], p["router"])
    f_e = torch.nn.functional.one_hot(r.ids[:, 0], e).float().mean(0)
    probs = torch.softmax(x.reshape(12, d).detach() @ p["router"], -1)
    want, = torch.autograd.grad(e * torch.sum(f_e * probs.mean(0)), p["router"])
    assert torch.allclose(ga, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", list(fam.STEP_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, case):
    fam.check_train_step(arch, case)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    fam.check_forward(arch)


def test_checkpoints_cross_between_packages(tmp_path):
    manifest = fam.check_checkpoints_cross("dbrx-132b", tmp_path)
    assert any(path.endswith("moe_0/router") for path in manifest)


def test_launcher_trains_the_moe_smoke():
    rec = fam.run_launcher("dbrx-132b")
    assert {"router"} <= set(rec["state"]["params"]["blocks"]["moe_0"])
