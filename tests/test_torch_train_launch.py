"""The port's training launcher (``repro_torch.launch.train``) and its two
training examples, run in-process on the CPU (``--device cpu``) at SMOKE
sizes: one arch of each family and ``--arch lemur``, a restart that resumes
at the saved step, every printed line in the JAX launcher's form, and
every entry point refusing to run without a card unless asked for the CPU.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from _torch_lm_parity import one_torch_thread  # noqa: F401 (fixture)

from repro_torch.examples import multi_arch_smoke, train_retrieval_e2e
from repro_torch.launch import train

DONE = re.compile(r"^\[train\] done: step (\d+), loss (\S+), retries=0 nan_skips=0 "
                  r"stragglers=\d+$", re.M)


@pytest.mark.parametrize("arch", ["gemma-7b", "meshgraphnet", "deepfm", "bst"])
def test_launcher_trains_and_resumes(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--steps", "4", "--checkpoint-every", "2", "--batch", "2",
            "--seq", "16", "--checkpoint-dir", str(tmp_path), "--device", "cpu"]
    out = train.main(argv)
    assert out["final_step"] == 4 and out["restores"] == 0 and len(out["history"]) == 4
    assert np.isfinite(out["loss"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
    again = train.main(argv[:3] + ["6"] + argv[4:])        # resumes at the saved step
    assert again["restores"] == 1 and again["final_step"] == 6 and len(again["history"]) == 2
    lines = DONE.findall(capsys.readouterr().out)
    assert [int(s) for s, _ in lines] == [4, 6]
    assert float(lines[0][1]) == pytest.approx(out["loss"], abs=1e-4)


def test_launcher_lemur_prints_recall(capsys):
    out = train.main(["--arch", "lemur", "--device", "cpu"])
    text = capsys.readouterr().out
    m = re.search(r"^\[lemur\] backend=ivf recall@10 = (\d\.\d{3})$", text, re.M)
    assert m and float(m.group(1)) == pytest.approx(out["recall"], abs=5e-4)
    assert out["recall"] > 0.05


def test_multi_arch_smoke_runs_every_arch(capsys):
    out = multi_arch_smoke.main(["--device", "cpu"])
    assert len(out) == 10 and "lemur" not in out
    for arch, m in out.items():
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0, arch
    assert multi_arch_smoke.run_one("lemur", "cpu") is None


def test_train_retrieval_e2e_on_the_cpu(capsys):
    out = train_retrieval_e2e.main(["--steps", "2", "--batch", "4", "--docs", "300",
                                    "--device", "cpu"])
    assert np.isfinite(out["loss"]) and 0 <= out["recall"] <= 1
    assert "LEMUR over trained encoder: recall@10=" in capsys.readouterr().out


@pytest.mark.parametrize("call", [
    lambda: train.main(["--arch", "deepfm", "--steps", "1"]),
    lambda: train.main(["--arch", "lemur"]),
    lambda: multi_arch_smoke.main([]),
    lambda: train_retrieval_e2e.main(["--steps", "1"]),
], ids=["launcher", "launcher_lemur", "multi_arch_smoke", "train_retrieval_e2e"])
def test_entry_points_default_to_the_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
