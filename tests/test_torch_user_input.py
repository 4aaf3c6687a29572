"""`--user-input-delta` in the PyTorch port's driver, on the CPU: every N
steps the chunk ends, the queued work drains and `code.interact` opens
with `state` and `engine`, as the JAX driver does. With stdin closed the
prompt returns at once, and the run writes the same study and eval files
as the run without the flag, byte for byte."""

import os

from byzantinemomentum_tpu_torch.cli import attack as driver

from tests.torch_threads import one_torch_thread  # noqa: F401

ARGV = ["--device", "cpu", "--seed", "2", "--model", "simples-full",
        "--dataset", "mnist", "--nb-workers", "7", "--nb-decl-byz", "2",
        "--nb-real-byz", "2", "--attack", "empire", "--attack-args",
        "factor:1.1", "--gar", "median", "--batch-size", "8",
        "--batch-size-test", "16", "--batch-size-test-reps", "2",
        "--evaluation-delta", "4", "--nb-for-study", "1",
        "--nb-for-study-past", "2", "--nb-steps", "6"]


def test_user_input_with_closed_stdin_writes_the_same_files(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "200")
    monkeypatch.setenv("BMT_SYNTH_TEST", "64")
    plain = driver.run([*ARGV, "--result-directory", str(tmp_path / "plain")])
    with open(os.devnull) as closed:
        monkeypatch.setattr("sys.stdin", closed)
        prompted = driver.run([*ARGV, "--user-input-delta", "3",
                               "--result-directory", str(tmp_path / "prompt")])
    err = capsys.readouterr().err
    # Prompts at steps 0, 3 and 6 (the chunks [3, 1, 2] against [4, 2])
    assert [f"Interactive prompt (step {s})" in err for s in range(7)] == [
        s % 3 == 0 for s in range(7)]
    assert prompted["steps"] == plain["steps"] == 6
    for name in ("study", "eval"):
        assert ((tmp_path / "prompt" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes())
