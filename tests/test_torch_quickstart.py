"""The port's quickstart example (``src/repro_torch/examples/
quickstart.py``) on the CPU at a shrunk size: a run with snapshots, then
``--resume`` of the same directory, which finds both runs complete and
returns them as they stand; without ``--device cpu`` and no card it
refuses to run."""
import pytest
import torch

from repro_torch.examples import quickstart


def test_quickstart_runs_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--rounds", "2", "--samples", "600",
            "--checkpoint-dir", str(tmp_path)]
    first = quickstart.main(args)
    assert set(first) == {"fedavg", "feddf"}
    assert [l.round for l in first["feddf"].result.logs] == [1, 2]
    assert all(l.bank == "bank" for l in first["feddf"].result.logs)
    assert (tmp_path / "feddf" / "rounds" / "00002" / "logs.json").exists()
    again = quickstart.main(args + ["--resume"])
    for name in first:
        assert again[name].result.logs == first[name].result.logs
    assert "feddf   best=" in capsys.readouterr().out


def test_quickstart_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--rounds", "1", "--samples", "600"])
    with pytest.raises(SystemExit):
        quickstart.main(["--device", "cpu", "--resume"])
