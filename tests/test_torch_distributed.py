"""The port's process-per-partition plumbing without the reference: the mesh
and its backend rule, the collective counter, the checks that refuse a
wrong mesh or a captured collective, and the entry points with and
without ``torch.distributed.run``.

The training itself, distributed against in-process and against the
reference, is held in ``tests/test_torch_halo.py``, whose 4 ranks reuse
that file's one reference run. Here two cases start ranks, each bounded by
a timeout: the pipeline's CLI (karate, k = 2) and ``launch.train``'s gnn
workload under ``python -m torch.distributed.run --standalone
--nproc-per-node 2``.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist                               # noqa: E402

from repro_torch import core                                   # noqa: E402
from repro_torch.gnn.halo import train_stale, train_sync       # noqa: E402
from repro_torch.gnn.model import GNNConfig                    # noqa: E402
from repro_torch.gnn.train import train_local                  # noqa: E402
from repro_torch.graphs import CaptureError                    # noqa: E402
from repro_torch.launch import collectives, mesh               # noqa: E402
from repro_torch.pipeline import cli                           # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fake_mesh(data):
    """What the trainers read of a mesh before any collective: the
    ``data`` axis's size."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda dim: (data, 1)[dim])


# -- the mesh -----------------------------------------------------------------
@pytest.mark.parametrize("device_type,local_world,cards,requested,want", [
    ("cpu", 4, 0, None, "gloo"),
    ("cpu", 1, 0, "gloo", "gloo"),
    ("cuda", 8, 1, None, "gloo"),         # ranks share the card
    ("cuda", 2, 1, "gloo", "gloo"),
    ("cuda", 4, 4, None, "nccl"),         # a card per rank
    ("cuda", 2, 8, "nccl", "nccl"),
    ("cuda", 4, 4, "gloo", "gloo"),
])
def test_backend_rule(device_type, local_world, cards, requested, want):
    assert mesh.choose_backend(device_type, local_world, cards,
                               requested) == want


@pytest.mark.parametrize("device_type,local_world,cards", [
    ("cuda", 2, 1), ("cuda", 9, 8), ("cpu", 1, 0)])
def test_nccl_refused_where_ranks_share_a_card(device_type, local_world,
                                               cards):
    with pytest.raises(ValueError, match="nccl"):
        mesh.choose_backend(device_type, local_world, cards, "nccl")


def test_init_from_env_refuses_nccl_on_one_card(monkeypatch):
    """Two ranks on a host with one card: asking for nccl raises before
    any rendezvous."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                        ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match="share 1 card"):
        mesh.init_process_group_from_env("cuda", backend="nccl")
    assert not dist.is_initialized()


def test_make_local_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_local_mesh()


def test_batch_axes():
    assert mesh.batch_axes(fake_mesh(4)) == ("data",)
    assert mesh.batch_axes(types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model"))) == ("pod", "data")


# -- the trainers' checks -----------------------------------------------------
@pytest.fixture(scope="module")
def arxiv():
    ds = core.make_arxiv_like(n=200, feature_dim=8, num_classes=4, seed=3)
    labels = core.leiden_fusion(ds.graph, 4, alpha=0.3)
    batch = core.build_partition_batch(ds.graph, labels, scheme="repli")
    return ds, batch, core.build_halo_exchange(ds.graph, labels, batch)


def _small(dropout=0.0):
    return GNNConfig(kind="gcn", feature_dim=8, hidden_dim=8, embed_dim=8,
                     num_layers=2, dropout=dropout)


@pytest.mark.parametrize("train", [train_sync, train_stale])
@pytest.mark.parametrize("data", [2, 8])
def test_halo_modes_need_one_rank_per_partition(arxiv, train, data):
    ds, batch, halo = arxiv
    with pytest.raises(ValueError, match=f"data axis has {data} ranks but "
                                         f"k=4"):
        train(ds, batch, halo, _small(), epochs=1, device="cpu",
              mesh=fake_mesh(data), capture=False)


@pytest.mark.parametrize("train", [train_sync, train_stale])
def test_capturing_a_collective_raises(arxiv, train):
    """A step that holds a collective cannot be a CUDA graph: asking for
    one raises, on any device; nothing runs eagerly in its place."""
    ds, batch, halo = arxiv
    with pytest.raises(CaptureError, match="capture=False"):
        train(ds, batch, halo, _small(), epochs=1, device="cpu",
              mesh=fake_mesh(4))


def test_sequential_local_is_unsharded(arxiv):
    ds, batch, _ = arxiv
    with pytest.raises(ValueError, match="unsharded"):
        train_local(ds, batch, _small(), epochs=1, device="cpu",
                    sequential=True, mesh=fake_mesh(4))


# -- the counter --------------------------------------------------------------
@pytest.fixture
def counter(monkeypatch):
    """The counter over fake collectives (nothing crosses a process)."""
    calls = []

    def fake(name):
        def op(*args, **kwargs):
            calls.append(name)
        return op
    monkeypatch.setattr(collectives.dist, "all_gather_into_tensor",
                        fake("all_gather"))
    monkeypatch.setattr(collectives.dist, "reduce_scatter_tensor",
                        fake("reduce_scatter"))
    monkeypatch.setattr(collectives.dist, "all_reduce", fake("all_reduce"))
    collectives.reset()
    yield calls
    collectives.reset()


def test_counter_counts_result_bytes_by_phase(counter):
    """The reference's rule: a collective's result bytes, once a call."""
    out = torch.empty((4, 3, 5))                    # 240 bytes
    with collectives.phase("training steps"):
        collectives.all_gather_into_tensor(out, torch.empty((1, 3, 5)))
        collectives.reduce_scatter_tensor(torch.empty((1, 3, 5)), out)
        collectives.all_gather_into_tensor(out, torch.empty((1, 3, 5)))
    with collectives.phase("integration"):
        collectives.all_reduce(torch.empty(7, dtype=torch.float64))
    assert counter == ["all_gather", "reduce_scatter", "all_gather",
                       "all_reduce"]
    steps = collectives.counted("training steps")
    assert steps["all-gather"] == 480 and steps["n_all-gather"] == 2
    assert steps["reduce-scatter"] == 60 and steps["n_reduce-scatter"] == 1
    assert steps["total"] == 540 and steps["all-reduce"] == 0
    assert set(steps) == {*collectives.COLLECTIVE_OPS, "total",
                          *(f"n_{op}" for op in collectives.COLLECTIVE_OPS)}
    assert collectives.counted("integration")["all-reduce"] == 56
    assert collectives.counted("embedding gather")["total"] == 0
    assert collectives.counted()["total"] == 596
    before = collectives.counted("training steps")
    with collectives.phase("training steps"):
        collectives.reduce_scatter_tensor(torch.empty(2), torch.empty(8))
    step = collectives.delta(collectives.counted("training steps"), before)
    assert step["total"] == step["reduce-scatter"] == 8
    assert step["n_reduce-scatter"] == 1 and step["n_all-gather"] == 0
    collectives.reset()
    assert collectives.counted()["total"] == 0


def test_counter_refuses_uncounted_collectives(counter):
    with pytest.raises(RuntimeError, match="outside a counted phase"):
        collectives.all_reduce(torch.empty(3))
    with pytest.raises(ValueError, match="phase must be"):
        with collectives.phase("warmup"):
            pass
    assert counter == []


def test_counter_keeps_staging_apart(counter):
    with collectives.phase("training steps"):
        collectives.add_staging(0.25)
        collectives.all_reduce(torch.empty(3))
    secs = collectives.seconds("training steps")
    assert secs["staging_s"] == 0.25 and secs["collective_s"] >= 0.0
    assert collectives.seconds("integration")["staging_s"] == 0.0


# -- the entry points ---------------------------------------------------------
RUN = ["run", "--device", "cpu", "--dataset", "karate", "--k", "2",
       "--mode", "sync", "--epochs", "3", "--classifier-epochs", "5",
       "--hidden-dim", "16", "--embed-dim", "16", "--json"]


def test_cli_without_world_size_runs_in_one_process(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.main(RUN) == 0
    out, err = capsys.readouterr()
    report = json.loads(out)
    assert report["config"]["mode"] == "sync"
    assert report["collectives"]["total"] > 0
    assert "rank summary" not in err
    assert not dist.is_initialized()


def torchrun(module_args):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2``
    on ``module_args``, on the CPU; returns (stdout, stderr). The launcher
    and its ranks are one process group, killed if it outlives 240 s."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", *module_args]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return out, err


def test_cli_under_torchrun_writes_from_rank_zero_only(tmp_path):
    """Two ranks, one partition each: rank 0 alone prints the report and
    writes the bundle and the checkpoint; both print their summary, with
    the schedule's bytes on every step."""
    out, err = torchrun(["repro_torch.pipeline", *RUN, "--serving-dir",
                         str(tmp_path / "bundle"), "--checkpoint-dir",
                         str(tmp_path / "ckpt")])
    report = json.loads(out)             # one report: rank 0's
    summaries = [json.loads(line.split("rank summary: ", 1)[1])
                 for line in err.splitlines() if "rank summary: " in line]
    assert sorted(s["rank"] for s in summaries) == [0, 1]
    step = report["collectives"]["total"]
    assert step > 0
    for s in summaries:
        assert s["world"] == 2 and s["backend"] == "gloo"
        assert s["step_bytes"] == [step] * 3
        assert s["partitions"] == [s["rank"], s["rank"] + 1]
    assert report["serving_path"] and report["checkpoint_path"]
    assert len(os.listdir(tmp_path / "bundle")) == 1
    assert os.listdir(tmp_path / "ckpt") == ["step_00000003"]
    assert np.isfinite(report["accuracy"]["test"])


def test_launch_train_under_torchrun(tmp_path):
    """``python -m repro_torch.launch.train --workload gnn`` on two ranks:
    one report (rank 0's), no training-step bytes, the table and the
    models gathered once each, one checkpoint."""
    out, _ = torchrun(["repro_torch.launch.train", "--device", "cpu",
                       "--workload", "gnn", "--nodes", "300", "--k", "2",
                       "--epochs", "2", "--hidden", "16", "--ckpt-dir",
                       str(tmp_path / "ckpt")])
    report = json.loads(out)
    assert report["collectives"]["training steps"] == 0
    assert report["collectives"]["embedding gather"] > 0
    assert report["collectives"]["integration"] > 0
    assert os.listdir(tmp_path / "ckpt") == ["step_00000002"]
    assert np.isfinite(report["results"]["test"])


# -- a partition trains alike alone or in a stack -----------------------------
def _alone_and_stacked(device, epochs=3):
    """Every partition's losses and parameters after ``epochs`` captured
    stacked steps: the k stacked in one step, and each in a stack of its
    own (what a rank of a one-process-per-partition run holds), from the
    same parameters and dropout generators (dropout 0.3). Widths of 128
    make the clip norm's reductions long enough for the card's row
    reduction to pick its order by the stack's size."""
    from repro_torch.gnn.infer import (gather_partition_tensors,
                                       init_partition_models)
    from repro_torch.gnn.train import dropout_generators, make_stacked_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    ds = core.make_arxiv_like(n=200, feature_dim=8, num_classes=4, seed=3)
    labels = core.leiden_fusion(ds.graph, 4, alpha=0.3)
    batch = core.build_partition_batch(ds.graph, labels, scheme="repli")
    cfg = GNNConfig(kind="gcn", feature_dim=8, hidden_dim=128,
                    embed_dim=128, num_layers=2, dropout=0.3)

    def run(lo, hi):
        params = tree_map(lambda x: x[lo:hi].contiguous(),
                          init_partition_models(
                              cfg, ds.num_classes, batch.k,
                              torch.Generator().manual_seed(0), device))
        gens = dropout_generators(0, batch.k, device)[lo:hi]
        tensors = gather_partition_tensors(ds, batch, device,
                                           only=slice(lo, hi))
        step = make_stacked_step(tensors, cfg, ds.multilabel, 1e-2, device)
        opt, losses = adamw_init(params, stacked=True), []
        for _ in range(epochs):
            params, opt, loss = step(params, opt, gens)
            losses.append(loss.cpu())
        return torch.stack(losses), [x.cpu() for x in tree_leaves(params)]
    stacked = run(0, batch.k)
    alone = [run(p, p + 1) for p in range(batch.k)]
    return stacked, alone


def _assert_alike(stacked, alone):
    losses, params = stacked
    for p, (one_losses, one_params) in enumerate(alone):
        assert torch.equal(one_losses[:, 0], losses[:, p]), p
        assert all(torch.equal(a[0], b[p]) for a, b in zip(one_params,
                                                            params)), p


def test_a_partition_trains_alike_alone_or_stacked():
    _assert_alike(*_alone_and_stacked(torch.device("cpu")))


@pytest.fixture
def cuda(tmp_path, monkeypatch):
    """The card, with an empty autotune cache of the test's own."""
    from repro_torch.kernels import autotune
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_cache.json"))
    autotune.clear_memory_cache()
    yield torch.device("cuda")
    autotune.clear_memory_cache()


@pytest.mark.cuda
def test_cuda_a_partition_trains_alike_alone_or_stacked(cuda):
    """On the card, bitwise: the stacked clip norm reduces each partition
    alone (a ``[k, M]`` row reduction took its order from k there, and a
    rank's partition drifted from the one-process run's)."""
    _assert_alike(*_alone_and_stacked(cuda))


# -- a rank's exchange backward (kernel A) ------------------------------------
def _rank_backward(halo, batch, device, f=12):
    """Every rank's backward sum against the sum written out: each row the
    rank received zeroed, each row it sent plus the slots it fed."""
    from repro_torch.kernels import exchange
    rng = np.random.default_rng(7)
    recv, send = np.asarray(halo.recv_rows), np.asarray(halo.send_rows)
    k, h_pad = batch.k, int(halo.h_pad)
    for r in range(k):
        pl = exchange.rank_plan(halo, r, batch.n_pad, device)
        g = rng.standard_normal((batch.n_pad + k * h_pad, f),
                                dtype=np.float32)
        want = g[:batch.n_pad].copy()
        want[recv[r][recv[r] >= 0]] = 0.0
        for p, j in zip(*np.nonzero(recv[:, r, :] >= 0)):
            want[send[r, p, j]] += g[batch.n_pad + p * h_pad + j]
        x = torch.as_tensor(g, device=device)
        out = exchange.rank_backward_sum(x, pl)
        assert out.shape == (batch.n_pad, f)
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(out, exchange.rank_backward_sum(x, pl))


def test_rank_backward_sums_the_fed_back_slots(arxiv):
    _, batch, halo = arxiv
    _rank_backward(halo, batch, torch.device("cpu"))


@pytest.mark.cuda
def test_cuda_rank_backward_sums_the_fed_back_slots(arxiv, cuda):
    """Kernel A writes only the rank's N_pad rows, bitwise repeatable."""
    from repro_torch.kernels import exchange
    _, batch, halo = arxiv
    before = exchange.launches_rank
    _rank_backward(halo, batch, cuda)
    assert exchange.launches_rank - before == 2 * batch.k
