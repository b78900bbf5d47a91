"""``python -m repro_torch.federated.run`` end to end on the CPU (tiny width).

The first test runs the module in a subprocess; the second calls its
``main`` in this process, which shares torch's start-up with the other
tests.
"""
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
