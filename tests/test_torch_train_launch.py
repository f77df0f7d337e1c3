"""The port's train launcher (``python -m repro_torch.launch.train``) on the CPU, in-process.

``--dry-run``; a plain run; a coded run with int8 compression, adaptive s
and Markov stragglers; and the device-death drill (FRC at s = 0 on a grid
of 8 logical devices, TP 4: the last DP slice holds workers 1 and 3, whole
groups, so their steps cannot decode): the steps after the kill skip, the
grid shrinks 2 -> 1 DP slices, the run resumes from the last checkpoint,
and its losses after the restore equal those of a run started fresh from
that checkpoint, bit for bit.  With s = 1 the same death is absorbed by the
code (no skip, no re-grid), as in the reference.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BASE = ["--smoke", "--device", "cpu", "--batch", "8", "--seq", "16", "--microbatches", "4",
        "--log-every", "5"]


def test_dry_run_prints_the_config(capsys):
    assert train.main(BASE + ["--dry-run", "--gradient-coding", "frc", "--layers", "3"]) is None
    out = capsys.readouterr().out
    assert "--dry-run resolved config" in out and "layers=3" in out
    assert "gradient_coding=frc" in out and "microbatches=4" in out


def test_plain_run_trains(capsys):
    rec = train.main(BASE + ["--steps", "12", "--arch", "mamba2-130m", "--lr", "1e-2"])
    losses = [loss for _, loss, _, _, _ in rec["steps"]]
    assert len(losses) == 12 and rec["skipped"] == 0
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert "done in" in capsys.readouterr().out


def test_coded_compressed_adaptive_run(capsys):
    rec = train.main(BASE + ["--steps", "10", "--arch", "zamba2-1.2b", "--gradient-coding",
                             "cyclic", "--compress", "int8", "--adaptive-s",
                             "--straggler-prob", "0.2", "--straggler-slowdown", "3"])
    assert len(rec["steps"]) == 10 and rec["skipped"] == 0
    assert all(ok == 1.0 for _, _, ok, _, _ in rec["steps"])
    assert {lvl for _, _, _, lvl, _ in rec["steps"]} <= {0, 1}
    assert "err" in rec["state"]


def _drill(ckpt, s):
    return BASE + ["--steps", "16", "--logical-devices", "8", "--mesh-model", "4",
                   "--gradient-coding", "frc", "--gc-stragglers", str(s), "--ckpt-dir",
                   str(ckpt), "--ckpt-every", "5", "--kill-at", "12", "--detect-steps", "2"]


def test_elastic_drill_end_to_end(tmp_path, capsys):
    rec = train.main(_drill(tmp_path / "ck", 0))
    out = capsys.readouterr().out
    assert "drill: DP slice 1 died at step 12" in out
    assert "2 unrecoverable steps -> elastic recovery" in out
    assert "re-meshed 2->1 DP slices; resumed from checkpoint step 10" in out
    assert "skipped=2" in out
    assert rec["events"] == [{"at": 14, "dp_before": 2, "dp_after": 1, "restored_step": 10}]
    assert rec["mesh"] == {"data": 1, "model": 4}
    steps = rec["steps"]
    assert [s for s, _, _, _, _ in steps] == list(range(1, 15)) + list(range(11, 17))
    assert [ok for _, _, ok, _, _ in steps[:14]] == [1.0] * 12 + [0.0, 0.0]
    # a run started fresh from the same checkpoint gives the same losses
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    shutil.copytree(tmp_path / "ck" / "step_00000010", fresh / "step_00000010")
    rec2 = train.main(BASE + ["--steps", "16", "--gradient-coding", "frc", "--gc-stragglers",
                              "0", "--ckpt-dir", str(fresh), "--ckpt-every", "100"])
    assert "resumed from step 10" in capsys.readouterr().out
    after = [(s, loss) for s, loss, _, _, _ in steps[-6:]]
    assert [s for s, _ in after] == list(range(11, 17))
    assert after == [(s, loss) for s, loss, _, _, _ in rec2["steps"]]


def test_drill_absorbed_by_the_code_at_s1(tmp_path, capsys):
    rec = train.main(_drill(tmp_path, 1))
    out = capsys.readouterr().out
    assert "died at step 12" in out and "elastic recovery" not in out
    assert rec["skipped"] == 0 and rec["events"] == []


def test_launcher_argument_checks():
    with pytest.raises(SystemExit):
        train.main(BASE + ["--kill-at", "3", "--gradient-coding", "frc"])
    with pytest.raises(SystemExit):
        train.main(BASE + ["--kill-at", "3", "--ckpt-dir", "/nonexistent"])
