"""The port stands alone and never hides the device.

* Importing every ``repro_torch`` module and every module ``chip_smoke.py``
  imports leaves neither ``jax`` nor any ``repro`` module in
  ``sys.modules`` (checked in a fresh interpreter).
* ``python -m repro_torch.obs`` (summarize and validate) loads neither
  either.
* Entry points default to CUDA and raise without it unless the caller
  passes ``device="cpu"``, the training pipeline and its CLI
  (``python -m repro_torch.pipeline run``, with ``--torch-profile`` too:
  no profile is written on a fallback device) too, and the LM's
  (``init_model``, ``init_cache``, ``python -m repro_torch.launch.serve``),
  the training CLI (``python -m repro_torch.launch.train``, both
  workloads, which loads neither ``jax`` nor ``repro`` either), the LM's
  train step, the enc-dec and VLM families' paths (the encoder,
  cross-attention, the frontends' inputs in ``launch.serve`` and
  ``launch.train``, which load neither either),
  ``examples/long_context_serving_torch.py`` and
  ``examples/moe_expert_placement_torch.py`` (which load neither either);
  ``chip_smoke.py`` exits
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
    assert {"repro_torch.launch.train", "repro_torch.launch.steps",
            "repro_torch.optim.schedules"} <= set(got["mods"])
    assert {"repro_torch.models.moe",
            "repro_torch.configs.qwen2_moe_a2p7b"} <= set(got["mods"])
    assert {"repro_torch.models.ssm", "repro_torch.configs.xlstm_125m",
            "repro_torch.configs.zamba2_1p2b"} <= set(got["mods"])
    assert {"repro_torch.core.expert_placement",
            "repro_torch.configs.deepseek_v2_236b"} <= set(got["mods"])
    assert {"repro_torch.core.registry", "repro_torch.core.partitioners",
            "repro_torch.core.spec", "repro_torch.core.metrics",
            "repro_torch.pipeline.artifacts",
            "repro_torch.tools.training_parity"} <= set(got["mods"])
    assert {"repro_torch.gnn.halo",
            "repro_torch.kernels.exchange"} <= set(got["mods"])
    assert {"repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.obs.metrics", "repro_torch.obs.sampler",
            "repro_torch.obs.summarize", "repro_torch.obs.__main__",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.tools.obs_overhead"} <= set(got["mods"])


@pytest.mark.parametrize("cmd", ["summarize", "validate"])
def test_obs_cli_loads_neither_jax_nor_the_reference(tmp_path, cmd):
    from repro_torch import obs
    obs.reset()
    obs.enable()
    with obs.span("pipeline.train"):
        pass
    trace = obs.export_trace(str(tmp_path / "t.json"))
    obs.reset()
    script = f"""
import json, runpy, sys
sys.path[:0] = [{os.path.join(ROOT, 'src')!r}]
sys.argv = ["python -m repro_torch.obs", {cmd!r}, {trace!r}]
try:
    runpy.run_module("repro_torch.obs", run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(json.dumps({{"code": code, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"code": 0, "bad": []}


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


def test_torch_profile_on_the_cuda_default_raises_without_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    prof = tmp_path / "prof"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.pipeline", "run", "--dataset",
         "karate", "--k", "2", "--epochs", "1", "--classifier-epochs", "1",
         "--torch-profile", str(prof), "--trace", str(tmp_path / "t.json")],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert not prof.exists() and not (tmp_path / "t.json").exists()


def test_lm_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import lm
    cfg = get_config("qwen3_4b").reduced()
    moe_cfg = get_config("qwen2_moe_a2p7b").reduced()
    encdec = get_config("seamless_m4t_large_v2").reduced()
    vlm = get_config("phi3_vision_4p2b").reduced()
    for call in (lambda: lm.init_model(cfg), lambda: lm.init_cache(cfg, 1, 8),
                 lambda: lm.init_model(moe_cfg),
                 lambda: lm.init_model(encdec),
                 lambda: lm.init_cache(encdec, 1, 8, enc_len=8),
                 lambda: lm.init_model(vlm),
                 lambda: serve.main(["--reduced", "--requests", "1"]),
                 lambda: serve.main(["--arch", "seamless_m4t_large_v2",
                                     "--reduced", "--requests", "1"]),
                 lambda: serve.main(["--arch", "phi3_vision_4p2b",
                                     "--reduced", "--requests", "1"]),
                 lambda: steps.make_train_step(cfg),
                 lambda: train.main(["--workload", "lm", "--reduced",
                                     "--steps", "1"]),
                 lambda: train.main(["--workload", "gnn", "--nodes", "200",
                                     "--k", "2", "--epochs", "1"])):
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


TRAIN_RUNNER = """
import json, runpy, sys
sys.path[:0] = [{src!r}]
sys.argv = ["python -m repro_torch.launch.train"] + {argv!r}
code = None
try:
    runpy.run_module("repro_torch.launch.train", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print(json.dumps({{"code": code, "bad": bad}}), flush=True)
"""


@pytest.mark.parametrize("workload", ["gnn", "lm"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_train_cli_needs_a_gpu_unless_told_cpu_and_loads_no_reference(
        workload, device):
    """``python -m repro_torch.launch.train`` raises without a GPU unless
    given ``--device cpu``, runs with it, and loads neither ``jax`` nor
    ``repro``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    argv = (["--workload", "gnn", "--nodes", "300", "--k", "2", "--epochs",
             "2", "--hidden", "16"] if workload == "gnn" else
            ["--workload", "lm", "--reduced", "--steps", "2", "--seq", "32"])
    if device:
        argv += ["--device", device]
    out = subprocess.run(
        [sys.executable, "-c", TRAIN_RUNNER.format(
            src=os.path.join(ROOT, "src"), argv=argv)],
        capture_output=True, text=True, timeout=180, env=env, cwd=ROOT)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    if device is None:
        assert out.returncode != 0 and result["code"] is None
        assert "device='cpu'" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        report = json.loads(out.stdout[:out.stdout.rindex("\n{")])
        assert report["workload"] == workload


FAMILY_RUNNER = """
import json, runpy, sys
sys.path[:0] = [{src!r}]
codes = []
for mod, argv in {runs!r}:
    sys.argv = ["python -m " + mod] + argv
    try:
        runpy.run_module(mod, run_name="__main__", alter_sys=True)
        codes.append(0)
    except RuntimeError as e:
        codes.append(str(e))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(json.dumps({{"codes": codes, "bad": bad}}), flush=True)
"""


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2",
                                  "phi3_vision_4p2b"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_frontend_families_need_a_gpu_unless_told_cpu_and_load_no_reference(
        arch, device):
    """The enc-dec and VLM families through ``launch.serve`` and
    ``launch.train`` (the encoder and cross-attention, the frames and
    patches drawn for each bucket and batch): each raises without a GPU
    unless given ``--device cpu``, serves and trains with it, and neither
    loads ``jax`` or ``repro``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    tail = ["--device", device] if device else []
    runs = [("repro_torch.launch.serve",
             ["--arch", arch, "--reduced", "--requests", "2", "--max-new",
              "2"] + tail),
            ("repro_torch.launch.train",
             ["--workload", "lm", "--arch", arch, "--reduced", "--steps",
              "2", "--seq", "32"] + tail)]
    out = subprocess.run(
        [sys.executable, "-c", FAMILY_RUNNER.format(
            src=os.path.join(ROOT, "src"), runs=runs)],
        capture_output=True, text=True, timeout=180, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    if device is None:
        assert all("device='cpu'" in str(c) for c in result["codes"])
    else:
        assert result["codes"] == [0, 0]
        assert '"finite": true' in out.stdout
        assert '"workload": "lm"' in out.stdout


EXAMPLE_RUNNER = """
import json, runpy, sys
sys.path[:0] = [{src!r}]
sys.argv = [{path!r}] + {argv!r}
code = None
try:
    runpy.run_path({path!r}, run_name="__main__")
except SystemExit as e:
    code = e.code
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print(json.dumps({{"code": code, "bad": bad}}), flush=True)
"""


@pytest.mark.parametrize("device", [None, "cpu"])
def test_long_context_example_needs_a_gpu_unless_told_cpu(device):
    """``examples/long_context_serving_torch.py`` raises without a GPU
    unless given ``--device cpu``, then prints the reference example's
    three lines (reduced xlstm, reduced zamba2, qwen3 at a 128-token
    window; their caches 0.1, 0.1 and 2.2 MB, as the reference's), and
    loads neither ``jax`` nor ``repro``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    path = os.path.join(ROOT, "examples", "long_context_serving_torch.py")
    argv = ["--device", device] if device else []
    out = subprocess.run(
        [sys.executable, "-c", EXAMPLE_RUNNER.format(
            src=os.path.join(ROOT, "src"), path=path, argv=argv)],
        capture_output=True, text=True, timeout=180, env=env, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1])["bad"] == []
    if device is None:
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
        return
    assert out.returncode == 0, out.stderr
    rows = lines[:-1]
    assert [r[:28].strip() for r in rows] == [
        "xlstm-125m (reduced)", "zamba2-1.2b (reduced)",
        "qwen3-4b (reduced, sw128)"]
    assert all("prompt=512 +32 tok:" in r and r.endswith("finite=True")
               for r in rows)
    assert [r.split("cache=")[1].split("MB")[0].strip() for r in rows] == [
        "0.1", "0.1", "2.2"]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_placement_example_needs_a_gpu_unless_told_cpu(device):
    """``examples/moe_expert_placement_torch.py`` raises without a GPU
    unless given ``--device cpu``, then prints the reference example's
    lines (LF against contiguous on the synthetic trace, the same numbers
    as the reference's, the partner reduction, then on the real router
    trace), and loads neither ``jax`` nor ``repro``. One intra-op thread:
    the example trains for 25 steps (~20 s on one core), and beside other
    test workers a process of many threads runs far slower."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    path = os.path.join(ROOT, "examples", "moe_expert_placement_torch.py")
    argv = ["--device", device] if device else []
    out = subprocess.run(
        [sys.executable, "-c", EXAMPLE_RUNNER.format(
            src=os.path.join(ROOT, "src"), path=path, argv=argv)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1])["bad"] == []
    if device is None:
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
        return
    assert out.returncode == 0, out.stderr
    rows = [r for r in lines[:-1] if r]
    assert rows[0].startswith("== synthetic") and rows[4].startswith(
        "== REAL router trace")
    assert [r.split(":")[0].strip() for r in rows[1:4] + rows[5:]] == [
        "contiguous", "leiden_fusion", "all-to-all partner reduction",
        "contiguous", "leiden_fusion"]
    # the synthetic trace is the reference example's, draw for draw
    assert rows[1:4] == [
        "contiguous    : mean shards/token=2.853  single-shard "
        "tokens=0.8%  p90=4",
        "leiden_fusion : mean shards/token=2.238  single-shard "
        "tokens=16.7%  p90=3",
        "all-to-all partner reduction: 33.2% fewer cross-shard hops"]



# ``python -m repro_torch.serving`` in a fresh interpreter; it prints which
# ``jax`` and ``repro`` modules were loaded, whether the command returned
# or raised (SIGINT is the interpreter's default, so a server stops on it)
SERVING_RUNNER = """
import json, runpy, signal, sys
sys.path[:0] = [{src!r}]
signal.signal(signal.SIGINT, signal.default_int_handler)
sys.argv = ["python -m repro_torch.serving"] + {argv!r}
code = None
try:
    runpy.run_module("repro_torch.serving", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print(json.dumps({{"code": code, "bad": bad}}), flush=True)
"""
TINY_EXPORT = ["--dataset", "karate", "--k", "2", "--epochs", "1",
               "--classifier-epochs", "2", "--hidden-dim", "8",
               "--embed-dim", "8"]


def _serving_runner(argv):
    return [sys.executable, "-c",
            SERVING_RUNNER.format(src=os.path.join(ROOT, "src"), argv=argv)]


def _runner_result(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def _serve_until_answered(cmd, env, timeout=120):
    """Start a ``serve`` command, wait for its ``listening on host:port``
    line, ask it for ``meta``, stop it with SIGINT. Returns (meta, return
    code, the runner's result)."""
    import queue
    import signal
    import socket
    import threading
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        line = ""
        while not line.startswith("listening on "):
            line = lines.get(timeout=timeout)
        host, port = line.split()[2].rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(b'{"op": "meta"}\n')
            meta = json.loads(s.makefile("rb").readline())
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
        reader.join(timeout=30)
        rest = []
        while not lines.empty():
            rest.append(lines.get_nowait())
        return meta, proc.returncode, _runner_result("".join(rest))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("command", ["", "replay", "serve", "client"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_serving_cli_needs_a_gpu_unless_told_cpu_and_loads_no_reference(
        tmp_path, command, device):
    """Each serving command (and the bare module, which replays) raises
    without a GPU unless given ``--device cpu``, runs with it, and loads
    neither ``jax`` nor ``repro``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [command] if command else []
    if device is None:
        out = subprocess.run(_serving_runner(argv), capture_output=True,
                             text=True, timeout=120, env=env, cwd=ROOT)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
        assert _runner_result(out.stdout) == {"code": None, "bad": []}
        return
    argv += ["--device", "cpu"]
    if command == "serve":
        meta, rc, got = _serve_until_answered(_serving_runner(
            argv + TINY_EXPORT + ["--port", "0", "--bundle-dir",
                                  str(tmp_path)]), env)
        assert meta["n"] == 34 and meta["k"] == 2
        assert rc == 0 and got == {"code": 0, "bad": []}
        return
    if command == "client":
        import threading
        bundle = run_inference(PipelineConfig(
            dataset="karate", k=2, hidden_dim=8, embed_dim=8,
            classifier_hidden=8, serving_dir=str(tmp_path)),
            device="cpu").serving_path
        srv, state = cli.make_server(cli.build_parser().parse_args(
            ["serve", "--device", "cpu", "--port", "0", "--bundle", bundle]))
        thread = threading.Thread(target=srv.serve_forever,
                                  kwargs={"poll_interval": 0.05},
                                  daemon=True)
        thread.start()
        try:
            argv += ["--port", str(srv.server_address[1]), "--queries",
                     "50", "--concurrency", "2", "--json"]
            out = subprocess.run(_serving_runner(argv), capture_output=True,
                                 text=True, timeout=120, env=env, cwd=ROOT)
        finally:
            srv.shutdown()
            srv.server_close()
            state.close(30)
            thread.join(30)
        assert not thread.is_alive()
        assert out.returncode == 0, out.stderr
        row = json.loads(out.stdout[:out.stdout.rindex("\n{")])
        assert row["queries"] == 50
        assert sum(row["served_by_source"].values()) == 50
    else:                           # replay, and the bare module
        argv += TINY_EXPORT + ["--queries", "50", "--bundle-dir",
                               str(tmp_path), "--json"]
        out = subprocess.run(_serving_runner(argv), capture_output=True,
                             text=True, timeout=120, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        row = json.loads(out.stdout[:out.stdout.rindex("\n{")])
        assert row["label_mismatches"] == 0 and row["device"] == "cpu"
    assert _runner_result(out.stdout) == {"code": 0, "bad": []}
