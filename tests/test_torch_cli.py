"""``python -m repro_torch.federated.run`` end to end on the CPU (tiny width).

The first test runs the module in a subprocess; the others call its
``main`` in this process, which shares torch's start-up with the other
tests: the paper models' runs, PVI / federated EP with strategy kwargs,
``--list-models``, ``--dump-spec`` → ``--spec`` with ``--ckpt-dir`` /
``--ckpt-every`` → ``--resume`` (bit-exact against the uninterrupted
run's checkpoint files) and ``--sweep``.
"""
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

from repro_torch.federated import run as cli

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--model", "hier_bnn", "--model-kwargs",
        '{"in_dim":16,"hidden":8}', "--silos", "3", "--rounds", "2", "--local-steps", "2"]


def _run(*extra):
    cmd = [sys.executable, "-m", "repro_torch.federated.run", *TINY, *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _elbos(stdout):
    return [float(m) for m in re.findall(r"elbo=\s*(-?[\d.]+(?:e[+-]?\d+)?)", stdout)]


def test_cli_both_algorithms_default_fused_wire():
    out = _run("--algo", "both")
    assert "== SFVI: hier_bnn" in out and "== SFVI-Avg: hier_bnn" in out
    assert out.count("wire=fused") == 2
    elbos = _elbos(out)
    assert len(elbos) == 4 and all(math.isfinite(e) for e in elbos)
    assert "bytes/round: SFVI=" in out


def test_cli_dp_int8_trimmed_partial_reports_epsilon(capsys):
    assert cli.main([*TINY, "--algo", "sfvi_avg", "--compress", "int8",
                     "--aggregator", "trimmed", "--trim-frac", "0.34", "--dp-noise",
                     "0.3", "--dp-clip", "0.3", "--participation", "0.67",
                     "--wire", "flat"]) == 0
    out = capsys.readouterr().out
    elbos = _elbos(out)
    assert len(elbos) == 2 and all(math.isfinite(e) for e in elbos)
    assert len(re.findall(r"eps=\s*[\d.]+", out)) == 2
    assert "active=2/3" in out and "-DP after 2 exchanges" in out


_EVAL_LINE = re.compile(r"^  [a-z_]+: -?\d+\.\d{3}$", re.M)


def test_cli_glmm_cholesky_prints_no_eval_line(capsys):
    """glmm has no eval hook (``eval_fn=None``): the run ends without one."""
    assert cli.main(["--device", "cpu", "--model", "glmm", "--global-family", "cholesky",
                     "--model-kwargs", '{"num_children": 24}', "--silos", "3",
                     "--rounds", "1", "--local-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "== SFVI: glmm" in out and "== SFVI-Avg: glmm" in out
    elbos = _elbos(out)
    assert len(elbos) == 2 and all(math.isfinite(e) for e in elbos)
    assert not _EVAL_LINE.search(out)
    # eta_G = (L_packed 10, log_sigma 5, mu 5) is 80 B a silo each way:
    # SFVI 2 steps x 3 silos x (80 up + 80 down), SFVI-Avg 3 x (80 + 80)
    assert "bytes/round: SFVI=960  SFVI-Avg=480" in out


def test_cli_toy_lowrank_family_flags_and_eval_line(capsys):
    assert cli.main(["--device", "cpu", "--model", "toy", "--silos", "3", "--rounds", "1",
                     "--local-steps", "2", "--algo", "sfvi_avg", "--global-family",
                     "lowrank", "--global-family-kwargs", '{"rank": 1}',
                     "--eta-mode", "param"]) == 0
    out = capsys.readouterr().out
    assert len(_EVAL_LINE.findall(out)) == 1 and "abs_error_vs_exact:" in out


def test_cli_prodlda_and_multinomial_print_their_eval_lines(capsys):
    """The paper's §4.2 and S3.2 models come from the registry: ProdLDA prints
    its coherence, multinomial its accuracies; θ ≠ ∅ ships 2 more floats."""
    assert cli.main(["--device", "cpu", "--model", "prodlda", "--model-kwargs",
                     '{"vocab_size": 30, "num_topics": 4, "docs_per_silo": 6}',
                     "--silos", "2", "--rounds", "1", "--local-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "== SFVI: prodlda" in out and "== SFVI-Avg: prodlda" in out
    assert len(re.findall(r"^  coherence_median: -?\d+\.\d{3}$", out, re.M)) == 2
    assert len(re.findall(r"^  coherence_mean: -?\d+\.\d{3}$", out, re.M)) == 2
    # P = 2 x 120 + 2 floats: SFVI 2 steps x 2 silos x (968 up + 968 down)
    assert "bytes/round: SFVI=7,744  SFVI-Avg=3,872" in out
    assert cli.main(["--device", "cpu", "--model", "multinomial", "--model-kwargs",
                     '{"n_per": 10, "in_dim": 16}', "--silos", "3", "--rounds", "1",
                     "--local-steps", "2", "--algo", "sfvi_avg"]) == 0
    out = capsys.readouterr().out
    assert len(_EVAL_LINE.findall(out)) == 2
    assert "train_acc:" in out and "test_acc:" in out


def test_cli_pvi_and_strategy_kwargs(capsys):
    """--algo pvi and --strategy fed_ep with hyperparameters; PVI ships the
    natural-parameter delta, P = 2 x 1 floats for toy: 8 B a silo each way."""
    base = ["--device", "cpu", "--model", "toy", "--silos", "3", "--rounds", "2",
            "--local-steps", "2"]
    assert cli.main([*base, "--algo", "pvi"]) == 0
    out = capsys.readouterr().out
    assert "== PVI: toy, J=3" in out and "total: 96 B in 2 rounds (48 B/round)" in out
    assert cli.main([*base, "--strategy", "fed_ep", "--strategy-kwargs",
                     '{"damping": 0.5}', "--dump-spec"]) == 0
    spec = json.loads(capsys.readouterr().out)
    assert spec["strategy"] == {"name": "fed_ep", "kwargs": {"damping": 0.5}}
    assert spec["scenario"]["algorithm"] == "fed_ep" and spec["runtime"]["wire"] == "fused"
    assert cli.main([*base, "--strategy", "fed_ep", "--strategy-kwargs",
                     '{"damping": 0.5}', "--eval-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "== FEDEP" not in out and "== FedEP: toy" in out
    assert len(_elbos(out)) == 2


def test_cli_list_models(capsys):
    assert cli.main(["--list-models"]) == 0
    out = capsys.readouterr().out
    for name in ("toy", "hier_bnn", "glmm", "multinomial", "hetero_mn", "prodlda"):
        assert re.search(rf"^{name}\s+\S", out, re.M)


def test_cli_spec_checkpoint_and_resume_are_bit_exact(tmp_path, capsys):
    """--dump-spec -> --spec with --ckpt-dir/--ckpt-every (mid-run saves,
    never at the last round) -> --resume of the mid-run step in a fresh
    call: the resumed final checkpoint is the uninterrupted one, byte for byte."""
    argv = ["--device", "cpu", "--model", "hier_bnn", "--model-kwargs",
            '{"in_dim":16,"hidden":8}', "--silos", "3", "--rounds", "4", "--local-steps",
            "2", "--algo", "sfvi_avg", "--compress", "int8", "--aggregator", "trimmed",
            "--dp-noise", "0.3", "--dp-clip", "0.3"]
    assert cli.main([*argv, "--dump-spec"]) == 0
    spec = tmp_path / "exp.json"
    spec.write_text(capsys.readouterr().out)
    full, part = tmp_path / "full", tmp_path / "part"
    assert cli.main(["--device", "cpu", "--spec", str(spec), "--ckpt-dir", str(full),
                     "--ckpt-every", "2"]) == 0
    capsys.readouterr()
    steps = sorted({f.split(".")[0] for f in os.listdir(full) if f.startswith("step_")})
    assert steps == ["step_00000002", "step_00000004"]
    part.mkdir()
    for f in os.listdir(full):
        if not f.startswith("step_00000004"):
            (part / f).write_bytes((full / f).read_bytes())
    assert cli.main(["--device", "cpu", "--resume", str(part)]) == 0
    out = capsys.readouterr().out
    assert "at round 2/4 (2 remaining), wire=fused" in out and len(_elbos(out)) == 2
    assert "-DP after 4 exchanges" in out
    for f in sorted(os.listdir(full)):
        if f.startswith("step_00000004"):
            assert (part / f).read_bytes() == (full / f).read_bytes(), f
    # --rounds extends the budget of a finished run.
    assert cli.main(["--device", "cpu", "--resume", str(part), "--rounds", "5"]) == 0
    out = capsys.readouterr().out
    assert "at round 4/5 (1 remaining)" in out and len(_elbos(out)) == 1


def test_cli_sweep_prints_the_scenario_table(capsys):
    assert cli.main(["--device", "cpu", "--model", "toy", "--silos", "2", "--rounds", "1",
                     "--local-steps", "1", "--algo", "sfvi_avg", "--sweep",
                     "--sweep-participation", "1.0", "--sweep-dropout", "0.0",
                     "--sweep-compress", "none,int8", "--sweep-dp-noise", "0.0,1.0"]) == 0
    out = capsys.readouterr().out
    assert "4 scenarios x 1 rounds" in out
    for label in ("SFVI-Avg ", "SFVI-Avg int8 ", "SFVI-Avg dp(z=1,C=1) ",
                  "SFVI-Avg int8 dp(z=1,C=1) "):
        assert re.search(rf"^  {re.escape(label)}\s+-?\d", out, re.M), label
