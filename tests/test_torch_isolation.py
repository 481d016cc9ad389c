"""The port stands alone and never hides the device.

* Importing every ``repro_torch`` module and every module ``chip_smoke.py``
  imports leaves neither ``jax`` nor any ``repro`` module in
  ``sys.modules`` (checked in a fresh interpreter).
* Entry points default to CUDA and raise without it unless the caller
  passes ``device="cpu"``, the training pipeline and its CLI
  (``python -m repro_torch.pipeline run``) too, and the LM's
  (``init_model``, ``init_cache``, ``python -m repro_torch.launch.serve``); ``chip_smoke.py`` exits
  non-zero and prints no result without a GPU, and when the rest of the
  repository is absent.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device                         # noqa: E402
from repro_torch.pipeline import cli as pipeline_cli          # noqa: E402
from repro_torch.pipeline.pipeline import (PipelineConfig,     # noqa: E402
                                           run_inference, run_training)
from repro_torch.serving import cli                            # noqa: E402
from repro_torch.serving.store import EmbeddingStore           # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _smoke_imports():
    """Every module name chip_smoke.py imports, at any depth."""
    with open(SMOKE) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return sorted(names)


def test_port_imports_neither_jax_nor_the_reference():
    script = f"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{os.path.join(ROOT, 'src')!r}]
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods + {_smoke_imports()!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(json.dumps({{"imported": len(mods), "bad": bad, "mods": mods}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["imported"] >= 20
    assert got["bad"] == []
    assert {"repro_torch.optim.adamw", "repro_torch.gnn.train",
            "repro_torch.kernels.edge_dot", "repro_torch.pipeline.cli",
            "repro_torch.pipeline.__main__"} <= set(got["mods"])
    assert {"repro_torch.models.lm", "repro_torch.models.attention",
            "repro_torch.models.convert", "repro_torch.configs.qwen3_4b",
            "repro_torch.kernels.flash_decode",
            "repro_torch.launch.serve"} <= set(got["mods"])
    assert {"repro_torch.core.registry", "repro_torch.core.partitioners",
            "repro_torch.core.spec", "repro_torch.core.metrics",
            "repro_torch.pipeline.artifacts",
            "repro_torch.tools.training_parity"} <= set(got["mods"])
    assert {"repro_torch.gnn.halo",
            "repro_torch.kernels.exchange"} <= set(got["mods"])


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    cfg = PipelineConfig(dataset="karate", k=2, hidden_dim=8, embed_dim=8,
                         classifier_hidden=8, serving_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_inference(cfg)
    result = run_inference(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingStore.load(result.serving_path)
    assert EmbeddingStore.load(result.serving_path, device="cpu").n == 34
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--dataset", "karate", "--bundle-dir", str(tmp_path)])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    script = SMOKE
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=os.path.dirname(script))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_training_entry_points_raise_without_cuda(no_cuda):
    cfg = PipelineConfig(dataset="karate", k=2, hidden_dim=8, embed_dim=8,
                         classifier_hidden=8, epochs=2, classifier_epochs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline_cli.main(["run", "--dataset", "karate", "--k", "2"])
    assert run_training(cfg, device="cpu").embeddings.shape == (34, 8)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_pipeline_cli_needs_a_gpu_unless_told_cpu(device):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.pipeline", "run", "--dataset",
           "karate", "--k", "4", "--epochs", "3", "--classifier-epochs", "5"]
    if device:
        cmd += ["--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    if device is None:
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert "PipelineReport" in out.stdout
        assert "accuracy" in out.stdout


def test_lm_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_config("qwen3_4b").reduced()
    for call in (lambda: lm.init_model(cfg), lambda: lm.init_cache(cfg, 1, 8),
                 lambda: serve.main(["--reduced", "--requests", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert lm.init_cache(cfg, 1, 8, "cpu")["layers"]["k"].shape[2] == 8


@pytest.mark.parametrize("device", [None, "cpu"])
def test_serve_cli_needs_a_gpu_unless_told_cpu(device):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3_4b", "--reduced", "--requests", "2", "--max-new", "3"]
    if device:
        cmd += ["--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    if device is None:
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        report = json.loads(out.stdout)
        assert report["finite"] and report["device"] == "cpu"
