"""Training of the vlm family in the port against the JAX reference.

llama-3.2-vision-11b's SMOKE config in float32 (period 2: a self-attention
layer, then one with a tanh-gated cross-attention over the batch's seeded
image embeddings).  The loss takes the image (``batch["img_embed"]``), as
the reference's does:

* at the init gate of 0 the loss is the same with or without the image,
  but the gate's gradient, d/dgate tanh(gate)·y = y at 0, is not: the
  port's equals the reference's nonzero one;
* at gate 0.5 the loss equals the reference's and differs from the loss
  with the image left out, and every leaf's gradient, the cross weights'
  among them, equals the reference's (remat on and off).

Then the whole train step at gate 0.5 (plain over 4 microbatches, FRC and
cyclic under one straggler, FRC under an undecodable mask),
``Model.forward`` with ``img``, checkpoints across the packages, and the
launcher (whose ``--layers`` must be a whole number of groups).  Shared
cases and tolerances: ``tests/torch_train_families.py``.
"""
import numpy as np
import pytest
import torch

import torch_train_families as fam
from repro_torch.launch import train as launcher

ARCH = "llama-3.2-vision-11b"
GATE = fam.GATE

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(fam.one_torch_thread)


def _named_grads(grads):
    params = fam.params_from_numpy(fam.jax.tree.map(np.asarray, fam.jax_params(ARCH)), "cpu")
    return dict(zip((path for path, _ in fam.tree_flatten_with_path(params)), grads))


def test_gate_gradient_at_init_matches_reference():
    """The regression of a loss that left out the image: at gate 0 the image
    reaches no loss value, only the gate's gradient; a loss that drops the
    image gives a zero there."""
    jloss, _, jgrads, _, _ = fam.jax_loss_and_grad(ARCH, 0.0)
    tloss, _, tgrads = fam.torch_loss_and_grad(ARCH, gate=0.0)
    fam.close_rel(tloss, jloss)
    want = {path: np.asarray(g) for path, g in zip(
        (p for p, _ in fam.tree_flatten_with_path(_named_grads(tgrads))),
        fam.jax.tree.leaves(jgrads))}
    got = _named_grads(tgrads)
    gate_paths = [p for p in got if p.endswith("/gate")]
    assert gate_paths == ["blocks/xattn_1/gate"]
    for path in gate_paths:
        assert np.abs(want[path]).max() > 0
        np.testing.assert_allclose(got[path].numpy(), want[path], rtol=0,
                                   atol=fam.GRAD_TOL * np.abs(want[path]).max())
    fam.grads_close(tgrads, fam.jax.tree.leaves(jgrads))


def test_loss_at_gate_half_takes_the_image():
    jloss, _, _, _, _ = fam.jax_loss_and_grad(ARCH, GATE)
    tloss, _, _ = fam.torch_loss_and_grad(ARCH, gate=GATE)
    blind, _, _ = fam.torch_loss_and_grad(ARCH, gate=GATE, with_image=False)
    jblind, _, _, _, _ = fam.jax_loss_and_grad(ARCH, GATE, with_image=False)
    fam.close_rel(tloss, jloss)
    fam.close_rel(blind, jblind)
    # the image moves the loss by several times the tolerance it is held to
    moved = abs(float(tloss.detach()) - float(blind.detach()))
    assert moved > 5 * fam.LOSS_RTOL * abs(float(jloss))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grad_match_reference(remat):
    grads = _named_grads(fam.check_loss_and_grad(ARCH, remat, gate=GATE))
    cross = {p: g for p, g in grads.items() if p.startswith("blocks/xattn_")}
    assert set(cross) == {f"blocks/xattn_1/{k}" for k in ("gate", "w_q", "w_k", "w_v", "w_o")}
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in cross.values())


def test_remat_gives_the_same_gradient_bits():
    _, _, on = fam.torch_loss_and_grad(ARCH, remat=True, gate=GATE)
    _, _, off = fam.torch_loss_and_grad(ARCH, remat=False, gate=GATE)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.parametrize("case", list(fam.STEP_CASES))
def test_train_step_matches_reference(case):
    fam.check_train_step(ARCH, case, gate=GATE)


def test_forward_with_img_matches_reference():
    with_img = fam.check_forward(ARCH, gate=GATE)
    _, tc = fam.cfgs(ARCH)
    params = fam.set_gates(fam.params_from_numpy(
        fam.jax.tree.map(np.asarray, fam.jax_params(ARCH)), "cpu"), GATE)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, tc.vocab, (2, 24)))
    with torch.no_grad():
        without = fam.build_model(tc).forward(params, tokens).numpy()
    assert np.abs(with_img - without).max() > 1e-3 * np.abs(with_img).max()


def test_checkpoints_cross_between_packages(tmp_path):
    manifest = fam.check_checkpoints_cross(ARCH, tmp_path)
    assert "params/blocks/xattn_1/gate" in manifest
    assert manifest["params/blocks/xattn_1/gate"]["shape"] == [2]


def test_launcher_trains_the_vlm_smoke():
    rec = fam.run_launcher(ARCH)
    assert rec["state"]["params"]["blocks"]["xattn_1"]["gate"].shape == (2,)


@pytest.mark.parametrize("smoke,layers", [(True, 3), (False, 3), (False, 12), (True, 0)])
def test_launcher_refuses_a_cut_inside_a_group(smoke, layers):
    argv = ["--arch", ARCH, "--layers", str(layers), "--dry-run"] + (["--smoke"] if smoke else [])
    with pytest.raises(ValueError, match="multiple of"):
        launcher.main(argv)


def test_launcher_takes_whole_groups(capsys):
    assert launcher.main(["--arch", ARCH, "--layers", "5", "--dry-run"]) is None
    assert "layers=5" in capsys.readouterr().out
