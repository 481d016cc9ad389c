"""The port's sync and stale training modes against the reference package.

The reference's sync and stale modes need one device per partition, so it
runs once, in a subprocess with 4 fake host devices (its own ``env=``),
which writes every result this file reads to an ``.npz``: the initial
parameters, the per-epoch losses, the parameters after 1 and 5 epochs and
the pooled table of sync and of stale(2) training, GCN and SAGE, and the
``collective_bytes`` report of the compiled steps at 2 and 3 layers. The
graph is ``tests/test_stale_mode.py``'s (arxiv-like at 400 nodes,
Leiden-Fusion k = 4, Repli), dropout 0. The same run adds the reference's
unsharded local training (3 epochs).

The port's process-per-partition runs (``torch.distributed``, gloo, one
partition per rank) start their 4 ranks once, in a module fixture, each a
subprocess with its own ``env=`` that meets the others through a
``FileStore`` under the test's temporary directory, and are held against
the port's one-process runs and against this file's reference results.

Tolerances (abs + rel):
* parameters after one step: 1e-5, the check that catches a missing
  cross-partition gradient (its terms are of the update's own size);
* per-epoch losses over 5 epochs: 1e-4, and the pooled table: 1e-3, as the
  local-mode parity tests (sums run in another order and the difference
  compounds through every AdamW step);
* the halo plan, the collective-byte report and the stale schedule: equal;
* the port against itself (stale(1) and sync, stale(0) and local): bitwise;
* the distributed runs against the one-process ones: bitwise, but for
  ``model_avg``, whose all-reduce sums in gloo's order (1e-6); against the
  reference as above, their counted bytes equal to its HLO count.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch import core                                   # noqa: E402
from repro_torch.gnn.halo import (exchange_collective_bytes,   # noqa: E402
                                  make_sync_train_step,
                                  stale_bytes_per_epoch,
                                  stale_exchange_epochs, train_stale,
                                  train_sync)
from repro_torch.gnn.infer import (gather_partition_tensors,   # noqa: E402
                                   init_partition_models, params_from_jax)
from repro_torch.gnn.model import GNNConfig                    # noqa: E402
from repro_torch.gnn.train import (dropout_generators,         # noqa: E402
                                   train_local)
from repro_torch.kernels import autotune, exchange, ops        # noqa: E402
from repro_torch.optim import adamw_init                       # noqa: E402
from repro_torch.pipeline import artifacts                     # noqa: E402
from repro_torch.pipeline.pipeline import (PipelineConfig,     # noqa: E402
                                           PipelineReport, run_training)
from repro_torch.tree import tree_leaves, tree_map             # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K, EPOCHS, LR, PERIOD = 4, 5, 1e-2, 2
LOCAL_EPOCHS = 3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
TABLE_TOL = dict(rtol=1e-3, atol=1e-3)
RUNS = [(kind, mode) for kind in ("gcn", "sage") for mode in ("sync", "stale")]

# The reference's runs. Each train_sync/train_stale run is also driven step
# by step with the same key schedule, for the per-epoch losses and the
# parameters after one step (and must end where train_* ends).
REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core import (make_arxiv_like, leiden_fusion,
                            build_partition_batch, build_halo_exchange)
    from repro.gnn import (GNNConfig, stale_bytes_per_epoch,
                           stale_exchange_epochs, train_local, train_stale,
                           train_sync)
    from repro.gnn.train import (_stale_cache_shapes, _tensors_dict,
                                 gather_partition_tensors,
                                 init_partition_models,
                                 make_local_train_step,
                                 make_stale_train_steps, make_sync_train_step)
    from repro.launch.hlo_analysis import collective_bytes
    from repro.optim import adamw_init

    K, EPOCHS, LR, PERIOD, LOCAL_EPOCHS = %d, %d, %r, %d, %d
    ds = make_arxiv_like(n=400, feature_dim=8, num_classes=4, seed=3)
    labels = leiden_fusion(ds.graph, K, alpha=0.3)
    batch = build_partition_batch(ds.graph, labels, scheme="repli")
    halo = build_halo_exchange(ds.graph, labels, batch)
    mesh = jax.make_mesh((K,), ("data",))
    tensors = {n: jnp.asarray(v) for n, v in
               _tensors_dict(gather_partition_tensors(ds, batch)).items()}
    out, dicts = {"labels": labels}, {}

    def leaves(tree):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]

    def report(hlo, mode):   # as the reference pipeline builds it
        d = collective_bytes(hlo["hlo"])
        if mode == "stale":
            per = stale_bytes_per_epoch(d["total"], EPOCHS, PERIOD)
            st = hlo.get("hlo_stale")
            d["stale_step_total"] = collective_bytes(st)["total"] if st else 0
            d["n_exchange_epochs"] = len(stale_exchange_epochs(EPOCHS,
                                                               PERIOD))
            d["per_epoch_avg"] = int(round(sum(per) / EPOCHS))
        else:
            d["per_epoch_avg"] = d["total"]
        return d

    for kind in ("gcn", "sage"):
        for layers in (2, 3):
            cfg = GNNConfig(kind=kind, feature_dim=8, hidden_dim=16,
                            embed_dim=16, num_layers=layers, dropout=0.0)
            key = jax.random.PRNGKey(0)
            params = init_partition_models(key, cfg, ds.num_classes, K)
            opt = jax.vmap(adamw_init)(params)
            keys = [jax.random.split(jax.random.fold_in(key, e), K)
                    for e in range(EPOCHS)]
            if layers == 2:
                for i, x in enumerate(leaves(params)):
                    out[f"{kind}_init_{i}"] = x
            for mode in ("sync", "stale"):
                tag, hlo = f"{kind}_{layers}_{mode}", {}
                if layers == 3:      # the collective report only
                    if mode == "sync":
                        step = make_sync_train_step(cfg, halo, False, mesh,
                                                    LR)
                        hlo["hlo"] = step.lower(params, opt, tensors,
                                                keys[0]).compile().as_text()
                    else:
                        steps = make_stale_train_steps(cfg, halo, False,
                                                       mesh, LR)
                        hlo["hlo"] = steps["exchange"].lower(
                            params, opt, tensors, keys[0]).compile().as_text()
                        caches = tuple(
                            jnp.zeros((K,) + s, jnp.float32)
                            for s in _stale_cache_shapes(cfg, batch.n_pad))
                        hlo["hlo_stale"] = steps["stale"].lower(
                            params, opt, tensors, keys[0],
                            caches).compile().as_text()
                    dicts[tag] = report(hlo, mode)
                    continue
                if mode == "sync":
                    p_end, table = train_sync(ds, batch, halo, cfg, mesh,
                                              epochs=EPOCHS, lr=LR, seed=0,
                                              hlo_out=hlo)
                    step = make_sync_train_step(cfg, halo, False, mesh, LR)

                    def run(p, o, e, c):
                        return step(p, o, tensors, keys[e]) + (None,)
                else:
                    p_end, table = train_stale(
                        ds, batch, halo, cfg, mesh, epochs=EPOCHS, lr=LR,
                        seed=0, sync_period=PERIOD, hlo_out=hlo)
                    steps = make_stale_train_steps(cfg, halo, False, mesh,
                                                   LR)
                    on = set(stale_exchange_epochs(EPOCHS, PERIOD))

                    def run(p, o, e, c):
                        if e in on:
                            return steps["exchange"](p, o, tensors, keys[e])
                        return steps["stale"](p, o, tensors, keys[e],
                                              c) + (c,)
                dicts[tag] = report(hlo, mode)
                p, o, c, losses = params, opt, None, []
                for e in range(EPOCHS):
                    p, o, loss, c = run(p, o, e, c)
                    losses.append(np.asarray(loss))
                    if e == 0:
                        for i, x in enumerate(leaves(p)):
                            out[f"{tag}_p1_{i}"] = x
                for a, b in zip(leaves(p), leaves(p_end)):
                    assert np.array_equal(a, b), tag
                out[f"{tag}_losses"] = np.stack(losses)
                out[f"{tag}_table"] = np.asarray(table)
    # the unsharded local run (the reference's sharded one fails under this
    # jax), driven step by step for its losses
    cfg = GNNConfig(kind="gcn", feature_dim=8, hidden_dim=16, embed_dim=16,
                    num_layers=2, dropout=0.0)
    p_end, table = train_local(ds, batch, cfg, epochs=LOCAL_EPOCHS, lr=LR,
                               seed=0)
    key = jax.random.PRNGKey(0)
    p = init_partition_models(key, cfg, ds.num_classes, K)
    o, losses = jax.vmap(adamw_init)(p), []
    step = jax.jit(make_local_train_step(cfg, False, LR))
    for e in range(LOCAL_EPOCHS):
        p, o, loss = step(p, o, tensors,
                          jax.random.split(jax.random.fold_in(key, e), K))
        losses.append(np.asarray(loss))
    for i, (a, b) in enumerate(zip(leaves(p), leaves(p_end))):
        assert np.array_equal(a, b), "local"
        out[f"gcn_2_local_p_{i}"] = a
    out["gcn_2_local_losses"] = np.stack(losses)
    out["gcn_2_local_table"] = np.asarray(table)
    out["dicts"] = np.array(json.dumps(dicts))
    np.savez(sys.argv[1], **out)
""") % (K, EPOCHS, LR, PERIOD, LOCAL_EPOCHS)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules this file calls in-process (numpy code and
    the artifact store); imported here, so the ``cuda`` tests need no
    JAX."""
    pytest.importorskip("jax")
    from repro import core as ref_core
    from repro.gnn import train as ref_train
    from repro.pipeline import artifacts as ref_artifacts
    return types.SimpleNamespace(core=ref_core, train=ref_train,
                                 artifacts=ref_artifacts)


@pytest.fixture(scope="module")
def reference(ref, tmp_path_factory):
    """Every reference result this file reads, from one subprocess."""
    path = tmp_path_factory.mktemp("halo_reference") / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={K}",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        data = {name: z[name] for name in z.files}
    data["dicts"] = json.loads(str(data["dicts"]))
    return data


@pytest.fixture(scope="module")
def graph():
    """The port's dataset, partition, batch and halo plan."""
    ds = core.make_arxiv_like(n=400, feature_dim=8, num_classes=4, seed=3)
    labels = core.leiden_fusion(ds.graph, K, alpha=0.3)
    batch = core.build_partition_batch(ds.graph, labels, scheme="repli")
    return ds, batch, core.build_halo_exchange(ds.graph, labels, batch)


def test_partition_equals_reference(graph, reference):
    _, batch, _ = graph
    labels = reference["labels"]
    ds = core.make_arxiv_like(n=400, feature_dim=8, num_classes=4, seed=3)
    assert np.array_equal(labels, core.leiden_fusion(ds.graph, K, alpha=0.3))
    assert np.array_equal(batch.node_ids, core.build_partition_batch(
        ds.graph, labels, scheme="repli").node_ids)


def _cfg(kind, layers=2, dropout=0.0):
    return GNNConfig(kind=kind, feature_dim=8, hidden_dim=16, embed_dim=16,
                     num_layers=layers, dropout=dropout)


def _init(reference, kind):
    """The reference's initial parameters as the port's tree."""
    template = init_partition_models(_cfg(kind), 4, K,
                                     torch.Generator().manual_seed(0), CPU)
    n = len(tree_leaves(template))
    leaves = iter([reference[f"{kind}_init_{i}"] for i in range(n)])
    return params_from_jax(tree_map(lambda _: next(leaves), template), CPU)


def _train(graph, reference, kind, mode, epochs, **kw):
    ds, batch, halo = graph
    common = dict(epochs=epochs, lr=LR, seed=0, device="cpu",
                  params=_init(reference, kind))
    if mode == "sync":
        return train_sync(ds, batch, halo, _cfg(kind), **common, **kw)
    return train_stale(ds, batch, halo, _cfg(kind), sync_period=PERIOD,
                       **common, **kw)


@pytest.fixture(scope="module")
def port_runs(graph, reference):
    """The port's run of each (kind, mode) for 1 and for 5 epochs."""
    memo = {}

    def run(kind, mode, epochs):
        if (kind, mode, epochs) not in memo:
            memo[kind, mode, epochs] = _train(graph, reference, kind, mode,
                                              epochs)
        return memo[kind, mode, epochs]
    return run


def _assert_leaves(params, reference, prefix, tol):
    mine = [x.detach().numpy() for x in tree_leaves(params)]
    for i, a in enumerate(mine):
        np.testing.assert_allclose(a, reference[f"{prefix}_{i}"], **tol)


# -- training against the reference ------------------------------------------
@pytest.mark.parametrize("kind,mode", RUNS)
def test_parameters_after_one_step_match_reference(port_runs, reference,
                                                   kind, mode):
    """The first step exchanges in both modes: the gradient that reaches a
    partition's parameters through the rows it sent must be there."""
    _assert_leaves(port_runs(kind, mode, 1).params, reference,
                   f"{kind}_2_{mode}_p1", STEP_TOL)


@pytest.mark.parametrize("kind,mode", RUNS)
def test_losses_match_reference(port_runs, reference, kind, mode):
    np.testing.assert_allclose(port_runs(kind, mode, EPOCHS).losses,
                               reference[f"{kind}_2_{mode}_losses"],
                               **LOSS_TOL)


@pytest.mark.parametrize("kind,mode", RUNS)
def test_pooled_table_matches_reference(port_runs, reference, kind, mode):
    run = port_runs(kind, mode, EPOCHS)
    np.testing.assert_allclose(run.embeddings.numpy(),
                               reference[f"{kind}_2_{mode}_table"],
                               **TABLE_TOL)
    expect = [2] * EPOCHS if mode == "sync" else \
        [2 if e % PERIOD == 0 else 0 for e in range(EPOCHS)]
    assert run.exchanges.tolist() == expect


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("kind,mode", RUNS)
def test_collective_bytes_equal_reference_hlo(graph, reference, kind, mode,
                                              layers):
    """The schedule's byte report equals the reference's count of its
    compiled step's collectives, key by key."""
    _, _, halo = graph
    mine = exchange_collective_bytes(_cfg(kind, layers), halo, K, mode,
                                     EPOCHS, PERIOD)
    assert mine == reference["dicts"][f"{kind}_{layers}_{mode}"]


@pytest.mark.parametrize("mode,period", [("local", None), ("stale", 0)])
def test_collective_bytes_zero_without_exchange(graph, mode, period):
    mine = exchange_collective_bytes(_cfg("gcn"), graph[2], K, mode, EPOCHS,
                                     period)
    assert mine["total"] == mine["per_epoch_avg"] == 0
    assert mine.get("n_exchange_epochs", 0) == 0


# -- one process per partition (torch.distributed, gloo) ---------------------
# Each rank runs every distributed case once, from the reference's initial
# parameters, and writes what it got to an .npz: local (3 epochs), sync and
# stale(2) (5 epochs, as the reference's runs), model_avg and ensemble
# (local, 3 epochs), and sync with dropout 0.3 (3 epochs).
RANKS = textwrap.dedent("""
    import json, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch import core
    from repro_torch.gnn.halo import train_stale, train_sync
    from repro_torch.gnn.infer import init_partition_models, params_from_jax
    from repro_torch.gnn.model import GNNConfig
    from repro_torch.gnn.train import train_local
    from repro_torch.launch.mesh import (init_process_group_from_env,
                                         make_local_mesh)
    from repro_torch.tree import tree_leaves, tree_map

    out_dir = sys.argv[1]
    K, EPOCHS, LR, PERIOD, LOCAL_EPOCHS = %d, %d, %r, %d, %d
    init_process_group_from_env(
        "cpu", init_method="file://" + os.path.join(out_dir, "store"),
        timeout_s=60)
    try:
        mesh = make_local_mesh()
        ds = core.make_arxiv_like(n=400, feature_dim=8, num_classes=4,
                                  seed=3)
        labels = core.leiden_fusion(ds.graph, K, alpha=0.3)
        batch = core.build_partition_batch(ds.graph, labels, scheme="repli")
        halo = core.build_halo_exchange(ds.graph, labels, batch)
        with np.load(os.path.join(out_dir, "init.npz")) as z:
            init = [z["p%%d" %% i] for i in range(len(z.files))]

        def cfg(dropout=0.0):
            return GNNConfig(kind="gcn", feature_dim=8, hidden_dim=16,
                             embed_dim=16, num_layers=2, dropout=dropout)

        def params():
            it = iter(init)
            template = init_partition_models(cfg(), ds.num_classes, K,
                                             torch.Generator(), "cpu")
            return params_from_jax(tree_map(lambda _: next(it), template),
                                   "cpu")
        common = dict(lr=LR, seed=0, device="cpu", mesh=mesh)
        runs = {
            "local": lambda: train_local(ds, batch, cfg(), params=params(),
                                         epochs=LOCAL_EPOCHS, **common),
            "sync": lambda: train_sync(ds, batch, halo, cfg(),
                                       params=params(), epochs=EPOCHS,
                                       capture=False, **common),
            "stale": lambda: train_stale(ds, batch, halo, cfg(),
                                         params=params(), epochs=EPOCHS,
                                         sync_period=PERIOD, capture=False,
                                         **common),
            "model_avg": lambda: train_local(
                ds, batch, cfg(), params=params(), epochs=LOCAL_EPOCHS,
                integrate="model_avg", **common),
            "ensemble": lambda: train_local(
                ds, batch, cfg(), params=params(), epochs=LOCAL_EPOCHS,
                integrate="ensemble", **common),
            "sync_dropout": lambda: train_sync(
                ds, batch, halo, cfg(0.3), params=params(),
                epochs=LOCAL_EPOCHS, capture=False, **common)}
        out = {}
        for name, run in runs.items():
            r = run()
            out[name + "_losses"] = r.losses
            out[name + "_table"] = r.embeddings.numpy()
            for i, x in enumerate(tree_leaves(r.params)):
                out["%%s_p_%%d" %% (name, i)] = x.numpy()
            out[name + "_counted"] = np.array(json.dumps(r.collectives))
        np.savez(os.path.join(out_dir, "rank%%d.npz" %% dist.get_rank()),
                 **out)
    finally:
        dist.destroy_process_group()
""") % (K, EPOCHS, LR, PERIOD, LOCAL_EPOCHS)
DIST_RUNS = ("local", "sync", "stale", "model_avg", "ensemble",
             "sync_dropout")
# model_avg's all-reduce sums in gloo's order, the stacked mean in its own:
# the averaged parameters differ by an f32 rounding
AVG_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results of :data:`RANKS`: 4 gloo ranks started once,
    each in its own subprocess (own ``env=``, one thread), meeting through
    a FileStore, every one killed at the end whatever happened."""
    d = tmp_path_factory.mktemp("ranks")
    np.savez(d / "init.npz", **{f"p{i}": reference[f"gcn_init_{i}"]
                                for i in range(6)})
    procs = []
    try:
        for r in range(K):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(K),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(K),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.path.join(ROOT, "src"))
            for name in ("MASTER_ADDR", "MASTER_PORT"):
                env.pop(name, None)
            with open(d / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", RANKS, str(d)], env=env,
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 300
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r}: {(d / f'rank{r}.log').read_text()[-4000:]}"
    data = []
    for r in range(K):
        with np.load(d / f"rank{r}.npz") as z:
            data.append({n: z[n] for n in z.files})
    for rank in data:
        for name in DIST_RUNS:
            rank[name + "_counted"] = json.loads(str(rank[name +
                                                          "_counted"]))
    return data


@pytest.fixture(scope="module")
def in_process(graph, reference):
    """The port's one-process runs of :data:`RANKS`' cases."""
    ds, batch, halo = graph
    common = dict(lr=LR, seed=0, device="cpu")
    init = functools.partial(_init, reference, "gcn")
    return {
        "local": train_local(ds, batch, _cfg("gcn"), params=init(),
                             epochs=LOCAL_EPOCHS, **common),
        "sync": train_sync(ds, batch, halo, _cfg("gcn"), params=init(),
                           epochs=EPOCHS, **common),
        "stale": train_stale(ds, batch, halo, _cfg("gcn"), params=init(),
                             epochs=EPOCHS, sync_period=PERIOD, **common),
        "model_avg": train_local(ds, batch, _cfg("gcn"), params=init(),
                                 epochs=LOCAL_EPOCHS, integrate="model_avg",
                                 **common),
        "ensemble": train_local(ds, batch, _cfg("gcn"), params=init(),
                                epochs=LOCAL_EPOCHS, integrate="ensemble",
                                **common),
        "sync_dropout": train_sync(ds, batch, halo, _cfg("gcn", dropout=0.3),
                                   params=init(), epochs=LOCAL_EPOCHS,
                                   **common)}


@pytest.mark.parametrize("name", DIST_RUNS)
def test_distributed_equals_in_process(ranks, in_process, name):
    """Rank r trains partition r as the one-process run trains it: the
    losses (rank r's column), the gathered parameters and the pooled table
    on every rank are bitwise the one-process run's (``model_avg``: within
    ``AVG_TOL``, the all-reduce's rounding)."""
    run = in_process[name]
    losses = np.concatenate([r[name + "_losses"] for r in ranks], axis=1)
    assert np.array_equal(losses, run.losses)
    want = [x.numpy() for x in tree_leaves(run.params)]
    for rank in ranks:
        got = [rank[f"{name}_p_{i}"] for i in range(len(want))]
        table = rank[name + "_table"]
        if name == "model_avg":
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, **AVG_TOL)
            np.testing.assert_allclose(table, run.embeddings.numpy(),
                                       **AVG_TOL)
        else:
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
            assert np.array_equal(table, run.embeddings.numpy())


@pytest.mark.parametrize("mode", ["sync", "stale"])
def test_distributed_matches_reference(ranks, reference, mode):
    """Against the reference's 4-device runs: losses at ``LOSS_TOL``, the
    pooled table at ``TABLE_TOL``, and each exchange step's counted bytes
    exactly its compiled step's HLO count."""
    losses = np.concatenate([r[mode + "_losses"] for r in ranks], axis=1)
    np.testing.assert_allclose(losses, reference[f"gcn_2_{mode}_losses"],
                               **LOSS_TOL)
    hlo = reference["dicts"][f"gcn_2_{mode}"]
    on = set(stale_exchange_epochs(EPOCHS, PERIOD if mode == "stale"
                                   else 1))
    for rank in ranks:
        np.testing.assert_allclose(rank[mode + "_table"],
                                   reference[f"gcn_2_{mode}_table"],
                                   **TABLE_TOL)
        for e, step in enumerate(rank[mode + "_counted"]["steps"]):
            assert step == ({key: hlo[key] for key in step} if e in on
                            else dict.fromkeys(step, 0)), (e, step)


def test_distributed_local_matches_reference_unsharded(ranks, reference):
    """The local run under a 4-rank mesh against the reference's unsharded
    local run (its sharded one fails under this jax): losses at
    ``LOSS_TOL``, parameters at ``STEP_TOL`` after 3 steps, the table at
    ``TABLE_TOL``."""
    losses = np.concatenate([r["local_losses"] for r in ranks], axis=1)
    np.testing.assert_allclose(losses, reference["gcn_2_local_losses"],
                               **LOSS_TOL)
    for rank in ranks:
        for i in range(6):
            np.testing.assert_allclose(rank[f"local_p_{i}"],
                                       reference[f"gcn_2_local_p_{i}"],
                                       **STEP_TOL)
        np.testing.assert_allclose(rank["local_table"],
                                   reference["gcn_2_local_table"],
                                   **TABLE_TOL)


@pytest.mark.parametrize("name", DIST_RUNS)
def test_distributed_counted_bytes(ranks, graph, name):
    """Per rank and step, the counted bytes are
    :func:`exchange_collective_bytes`' (the sync step's on exchange
    epochs); local steps and stale's between-exchange steps count 0; the
    table and the models move outside any step."""
    _, _, halo = graph
    mode = {"stale": "stale", "local": "local", "model_avg": "local",
            "ensemble": "local"}.get(name, "sync")
    epochs = EPOCHS if name in ("sync", "stale") else LOCAL_EPOCHS
    live = exchange_collective_bytes(_cfg("gcn"), halo, K, "sync")
    on = (range(epochs) if mode == "sync" else
          stale_exchange_epochs(epochs, PERIOD) if mode == "stale" else [])
    for rank in ranks:
        counted = rank[name + "_counted"]
        steps = counted["steps"]
        assert [s["total"] for s in steps] == [
            live["total"] if e in on else 0 for e in range(epochs)]
        assert all(s["n_reduce-scatter"] == (1 if e in on else 0)
                   for e, s in enumerate(steps))
        phases = counted["phases"]
        assert phases["training steps"]["total"] == live["total"] * len(on)
        assert phases["embedding gather"]["total"] > 0
        assert phases["integration"]["n_" + (
            "all-reduce" if name == "model_avg" else "all-gather")] == 1


# -- the halo plan ----------------------------------------------------------
@pytest.fixture(scope="module")
def halo_graphs(ref):
    """(port graph, reference graph, labels): karate, arxiv-like at 400
    nodes (Leiden-Fusion), and a random partition with isolated nodes."""
    ds = core.make_arxiv_like(n=400, feature_dim=8, num_classes=4, seed=3)
    rds = ref.core.make_arxiv_like(n=400, feature_dim=8, num_classes=4,
                                   seed=3)
    random_labels = core.random_partition(ds.graph, K, seed=1)
    return {"karate": (core.karate_club(), ref.core.karate_club(),
                       core.leiden_fusion(core.karate_club(), K, alpha=0.3)),
            "arxiv400": (ds.graph, rds.graph,
                         core.leiden_fusion(ds.graph, K, alpha=0.3)),
            "random": (ds.graph, rds.graph, random_labels)}


@pytest.mark.parametrize("name", ["karate", "arxiv400", "random"])
def test_halo_plan_byte_identical(ref, halo_graphs, name):
    g, rg, labels = halo_graphs[name]
    batch = core.build_partition_batch(g, labels, scheme="repli")
    ref_batch = ref.core.build_partition_batch(rg, labels, scheme="repli")
    mine = core.build_halo_exchange(g, labels, batch)
    theirs = ref.core.build_halo_exchange(rg, labels, ref_batch)
    assert mine.h_pad == theirs.h_pad
    for field in ("send_rows", "recv_rows"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), field
    if name == "random":
        report = core.evaluate_partition(g, labels)
        assert report.total_isolated > 0


@pytest.mark.parametrize("name", ["karate", "arxiv400", "random"])
def test_recv_rows_unique_within_each_partition(halo_graphs, name):
    """Every partition receives each halo row once (the copy has no write
    conflict), and only rows that hold another partition's node."""
    g, _, labels = halo_graphs[name]
    batch = core.build_partition_batch(g, labels, scheme="repli")
    halo = core.build_halo_exchange(g, labels, batch)
    for p in range(batch.k):
        rows = halo.recv_rows[p][halo.recv_rows[p] >= 0]
        assert np.unique(rows).size == rows.size
        halo_rows = np.nonzero(batch.node_mask[p] & ~batch.owned_mask[p])[0]
        assert np.array_equal(np.sort(rows), halo_rows)
        sent = halo.send_rows[:, p][halo.send_rows[:, p] >= 0]
        assert sent.size == rows.size
    for q in range(batch.k):
        sent = halo.send_rows[q][halo.send_rows[q] >= 0]
        assert batch.owned_mask[q][sent].all()


# -- the port's own limits, bitwise ------------------------------------------
def _same(a, b):
    return (all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                  tree_leaves(b.params)))
            and torch.equal(a.embeddings, b.embeddings)
            and np.array_equal(a.losses, b.losses))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_stale_period_one_is_sync_bitwise(graph, kind):
    ds, batch, halo = graph
    cfg = _cfg(kind, dropout=0.3)
    sync = train_sync(ds, batch, halo, cfg, epochs=4, device="cpu")
    stale = train_stale(ds, batch, halo, cfg, epochs=4, sync_period=1,
                        device="cpu")
    assert _same(sync, stale)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_stale_never_exchanging_is_local_bitwise(graph, dropout):
    ds, batch, halo = graph
    cfg = _cfg("gcn", dropout=dropout)
    local = train_local(ds, batch, cfg, epochs=4, device="cpu")
    stale = train_stale(ds, batch, halo, cfg, epochs=4, sync_period=0,
                        device="cpu")
    assert _same(local, stale)
    assert stale.exchanges.tolist() == [0] * 4


def test_stale_epochs_call_no_exchange(graph):
    ds, batch, halo = graph
    ops.reset_launch_counts()
    before = exchange.calls
    run = train_stale(ds, batch, halo, _cfg("gcn"), epochs=7, sync_period=3,
                      device="cpu")
    assert run.exchanges.tolist() == [2, 0, 0, 2, 0, 0, 2]
    # and the embedding pass exchanges once per layer
    assert exchange.calls - before == 3 * 2 + 2
    assert ops.launch_counts()["exchange_backward"] == 0      # the CPU


# -- the exchange Function ---------------------------------------------------
def _small_plan(dtype=torch.float64):
    g = core.karate_club()
    labels = core.leiden_fusion(g, K, alpha=0.3)
    batch = core.build_partition_batch(g, labels, scheme="repli")
    halo = core.build_halo_exchange(g, labels, batch)
    pl = exchange.plan(halo, batch.n_pad, CPU)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((batch.k, batch.n_pad, 3), generator=gen, dtype=dtype)
    return pl, h


def test_exchange_function_gradcheck():
    pl, h = _small_plan()
    assert pl.pairs > 0
    assert torch.autograd.gradcheck(lambda x: exchange.ExchangeFn.apply(x, pl),
                                    (h.requires_grad_(),))


def test_exchange_function_matches_plain_indexing():
    """Forward and backward against autograd of plain indexing; a row sent
    to several partitions gets the sum of what they fed back."""
    pl, h = _small_plan(torch.float32)
    send = pl.send.numpy()
    assert np.unique(send).size < send.size      # some row is sent twice
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(1))
    mine = h.clone().requires_grad_()
    ref = h.clone().requires_grad_()
    out = exchange.exchange(mine, pl)
    out_ref = exchange.plain(ref, pl)
    assert torch.equal(out, out_ref)
    (out * g).sum().backward()
    (out_ref * g).sum().backward()
    torch.testing.assert_close(mine.grad, ref.grad, rtol=1e-6, atol=1e-6)
    assert (mine.grad.reshape(-1, 3)[pl.recv] == 0).all()


def test_cached_refresh_reads_the_cache_and_passes_no_gradient():
    pl, h = _small_plan(torch.float32)
    cache = torch.randn(h.shape, generator=torch.Generator().manual_seed(2))
    x = h.clone().requires_grad_()
    out = exchange.refresh_from(x, cache, pl)
    flat, cflat = out.reshape(-1, 3), cache.reshape(-1, 3)
    assert torch.equal(flat[pl.recv], cflat[pl.recv])
    kept = ~pl.received.reshape(-1)
    assert torch.equal(flat[kept], h.reshape(-1, 3)[kept])
    out.sum().backward()
    assert torch.equal(x.grad.reshape(-1, 3)[pl.recv],
                       torch.zeros(pl.pairs, 3))


# -- the schedule -----------------------------------------------------------
@settings(database=None, derandomize=True, max_examples=60)
@given(epochs=st.integers(0, 40),
       period=st.one_of(st.none(), st.integers(-3, 12)),
       nbytes=st.integers(0, 10 ** 9))
def test_stale_schedule_matches_reference(ref, epochs, period, nbytes):
    assert stale_exchange_epochs(epochs, period) == \
        ref.train.stale_exchange_epochs(epochs, period)
    assert stale_bytes_per_epoch(nbytes, epochs, period) == \
        ref.train.stale_bytes_per_epoch(nbytes, epochs, period)


# -- the artifact cache ------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_halo_bundles_hit_across_packages(ref, halo_graphs, tmp_path,
                                         writer):
    """A batch bundle with its halo plan, written by either package, is a
    hit with the plan in the other; a hit without the plan gains it."""
    g, rg, _ = halo_graphs["arxiv400"]
    mine = artifacts.PartitionArtifactStore(str(tmp_path))
    theirs = ref.artifacts.PartitionArtifactStore(str(tmp_path))
    if writer == "port":
        plain = mine.load_or_compute(g, "metis+f", K, 0, "repli")
        assert plain.halo is None
        first = mine.load_or_compute(g, "metis+f", K, 0, "repli",
                                     with_halo=True)
        second = theirs.load_or_compute(rg, "metis+f", K, 0, "repli")
    else:
        theirs.load_or_compute(rg, "metis+f", K, 0, "repli")
        first = theirs.load_or_compute(rg, "metis+f", K, 0, "repli",
                                       with_halo=True)
        second = mine.load_or_compute(g, "metis+f", K, 0, "repli")
    assert first.batch_hit and second.batch_hit and second.labels_hit
    assert first.batch_path == second.batch_path
    assert second.halo is not None and second.halo.h_pad == first.halo.h_pad
    for field in ("send_rows", "recv_rows"):
        a = np.asarray(getattr(first.halo, field))
        b = np.asarray(getattr(second.halo, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field


# -- the pipeline and the CLI ------------------------------------------------
@pytest.mark.parametrize("mode", ["sync", "stale"])
def test_run_training_sync_and_stale_on_karate(mode):
    """Sync and stale train (they replace local's assembly with Repli) and
    fill the collective report; stale(2) over 4 epochs exchanges twice."""
    cfg = PipelineConfig(dataset="karate", k=2, mode=mode, sync_period=2,
                         scheme="inner", epochs=4, classifier_epochs=10,
                         hidden_dim=16, embed_dim=16, classifier_hidden=32)
    result = run_training(cfg, device="cpu")
    report = PipelineReport.of(cfg, result)
    assert report.config["scheme"] == "repli"
    assert result.bundle.halo is not None
    assert np.isfinite(result.losses).all() and result.losses.shape == (4, 2)
    col = report.collectives
    assert col == exchange_collective_bytes(
        result.gnn, result.bundle.halo, 2, mode, 4, 2)
    assert col["total"] > 0 and col["n_all-gather"] == 3
    per_epoch = col["total"] if mode == "sync" else col["total"] // 2
    assert col["per_epoch_avg"] == per_epoch
    assert "collectives" in report.summary()
    assert ("stale comm" in report.summary()) == (mode == "stale")
    assert set(report.accuracy) == {"train", "val", "test"}


def test_run_training_local_reports_zero_collectives():
    cfg = PipelineConfig(dataset="karate", k=2, epochs=2, classifier_epochs=0,
                         hidden_dim=16, embed_dim=16)
    report = PipelineReport.of(cfg, run_training(cfg, device="cpu"))
    assert report.collectives["total"] == 0
    assert report.collectives["per_epoch_avg"] == 0
    assert report.config["scheme"] == "repli"


def test_pipeline_rejects_a_negative_period():
    with pytest.raises(ValueError, match="sync_period"):
        run_training(PipelineConfig(dataset="karate", k=2, mode="stale",
                                    sync_period=-1), device="cpu")


def test_cli_runs_sync_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.pipeline", "run", "--device",
         "cpu", "--dataset", "karate", "--k", "4", "--mode", "sync",
         "--epochs", "3", "--classifier-epochs", "5", "--hidden-dim", "16",
         "--embed-dim", "16"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "mode=sync" in out.stdout
    line = next(x for x in out.stdout.splitlines() if "collectives" in x)
    assert int(line.split()[1]) > 0


# -- on the card -------------------------------------------------------------
@pytest.fixture
def cuda(tmp_path, monkeypatch):
    """The card, with an empty autotune cache of the test's own: the
    layers resolve the fallback whatever the machine's cache holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_cache.json"))
    autotune.clear_memory_cache()
    yield torch.device("cuda")
    autotune.clear_memory_cache()


@pytest.mark.cuda
def test_cuda_exchange_matches_plain(cuda, graph):
    """The exchange on the card (its backward on kernel A) against plain
    indexing, 3e-5 against the sum of absolute terms, and bitwise
    repeatable."""
    _, batch, halo = graph
    pl = exchange.plan(halo, batch.n_pad, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((K, batch.n_pad, 16), generator=gen, device=cuda)
    g = torch.randn(h.shape, generator=gen, device=cuda)

    def grads(fn, x, cot):
        x = x.clone().requires_grad_()
        out = fn(x, pl)
        (out * cot).sum().backward()
        return out.detach(), x.grad
    ops.reset_launch_counts()
    out, dh = grads(exchange.exchange, h, g)
    assert ops.launch_counts()["exchange_backward"] == 1
    out_ref, dh_ref = grads(exchange.plain, h, g)
    _, scale = grads(exchange.plain, h, g.abs())
    assert torch.equal(out, out_ref)
    assert ((dh - dh_ref).abs() <= 3e-5 + 3e-5 * scale).all()
    assert torch.equal(dh, grads(exchange.exchange, h, g)[1])


@pytest.mark.cuda
def test_cuda_two_sync_steps_bitwise_equal(cuda, graph):
    ds, batch, halo = graph
    cfg = _cfg("gcn", dropout=0.3)
    tensors = gather_partition_tensors(ds, batch, cuda)
    params = init_partition_models(cfg, ds.num_classes, K,
                                   torch.Generator().manual_seed(0), cuda)
    step = make_sync_train_step(cfg, exchange.plan(halo, batch.n_pad, cuda),
                                False, LR)
    runs = [step(params, adamw_init(params, stacked=True), tensors,
                 dropout_generators(0, K, cuda)) for _ in range(2)]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][2], runs[1][2])
