"""The PyTorch port stands alone: no JAX, no ``repro``, card by default.

* ``import repro_torch`` and every submodule works with ``jax`` blocked
  (a subprocess with ``sys.modules["jax"] = None``);
* an AST scan of ``src/repro_torch`` and ``chip_smoke.py`` finds no
  ``import jax`` / ``from jax`` and no import of the ``repro`` package;
* the entry points default to ``cuda`` and raise on a machine without
  CUDA instead of carrying on on the CPU.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_with_jax_blocked():
    mods = _port_modules()
    for name in ("federated.runtime", "kernels.wire", "kernels.reparam", "kernels.build",
                 "models.paper.glmm", "core.barycenter", "data.synthetic",
                 "kernels.attention", "kernels.gla", "kernels.rmsnorm",
                 "models.backbone.transformer", "launch.serve_backbone"):
        assert f"repro_torch.{name}" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(" + repr(mods) + "))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root != "jax", f"{path} imports {name}"
        assert root != "repro", f"{path} imports {name} (the JAX package)"


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.federated.runtime import Server
    from repro_torch.models.paper.registry import get_model
    from repro_torch.optim import adam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("hier_bnn").build(0, 2, in_dim=4, hidden=2, train_per_silo=4)
    bundle = get_model("hier_bnn").build(0, 2, device="cpu", in_dim=4, hidden=2,
                                         train_per_silo=4)
    eta_G = {"mu": torch.zeros(bundle.problem.model.global_dim),
             "log_sigma": torch.zeros(bundle.problem.model.global_dim)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(bundle.problem, bundle.datas, {}, eta_G, server_opt=adam(1e-2),
               local_opt=adam(1e-2))
    srv = Server(bundle.problem, bundle.datas, {}, eta_G, server_opt=adam(1e-2),
                 local_opt=adam(1e-2), device="cpu")
    assert srv.wire == "fused" and srv.device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels import wire

    y = torch.zeros((1, 3, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wire.newton_schulz_step(y, y)
    x = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wire.fused_upload(x, mask=torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        wire.fused_combine(x, torch.ones(2, device="meta"))

    from repro_torch.kernels import attention, gla, rmsnorm

    q = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gla.gla(q, q, q, torch.zeros((1, 4, 2), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rmsnorm.rmsnorm(q, torch.ones(8, device="meta"))
