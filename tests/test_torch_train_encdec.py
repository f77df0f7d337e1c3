"""Training of the encdec family in the port against the JAX reference.

seamless-m4t-large-v2's SMOKE config in float32 (2 encoder + 2 decoder
layers): ``Model.loss`` (the reference's ``encdec_loss``: chunked CE over
``encdec_forward`` with the plain ``lm_head``, aux 0) on a batch with the
pipeline's seeded frames, and each gradient leaf, with per-layer remat on
and off; the whole train step (plain over 4 microbatches, FRC and cyclic
under one straggler, FRC under an undecodable mask); ``Model.forward`` with
``frames``; checkpoints across the packages; the launcher.  Shared cases and
tolerances: ``tests/torch_train_families.py``.
"""
import pytest
import torch

import torch_train_families as fam
from repro_torch.models import encdec

ARCH = "seamless-m4t-large-v2"

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(fam.one_torch_thread)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grad_match_reference(remat):
    grads = fam.check_loss_and_grad(ARCH, remat)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_remat_checkpoints_every_layer_and_keeps_the_gradient_bits(monkeypatch):
    """With remat each of the encoder's and the decoder's layers runs once
    under ``torch.utils.checkpoint`` in the forward (and again in the
    backward), and the gradient has the bits it has without remat."""
    calls = []
    real = encdec._remat

    def counted(cfg, fn, *args):
        calls.append(fn.func.__name__)
        return real(cfg, fn, *args)

    monkeypatch.setattr(encdec, "_remat", counted)
    _, _, on = fam.torch_loss_and_grad(ARCH, remat=True)
    _, tc = fam.cfgs(ARCH)
    assert calls == ["_enc_layer"] * tc.enc_layers + ["_dec_layer"] * tc.n_layers
    _, _, off = fam.torch_loss_and_grad(ARCH, remat=False)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.parametrize("case", list(fam.STEP_CASES))
def test_train_step_matches_reference(case):
    fam.check_train_step(ARCH, case)


def test_forward_with_frames_matches_reference():
    fam.check_forward(ARCH)


def test_checkpoints_cross_between_packages(tmp_path):
    manifest = fam.check_checkpoints_cross(ARCH, tmp_path)
    assert {"params/enc_blocks/attn/w_q", "params/dec_blocks/xattn/w_k"} <= set(manifest)


def test_launcher_trains_the_encdec_smoke(capsys):
    fam.run_launcher(ARCH, "--layers", "1")
    assert "layers=1 (decoder; encoder 2)" in capsys.readouterr().out
