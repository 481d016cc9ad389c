"""The training main path of this tree and of another checkout, timed in
turns on one card: ``chip_smoke.py`` phase 5's configuration (arxiv-like
at 169,343 nodes, Leiden-Fusion k = 8, repli assembly, 60 epochs of the
captured stacked step), each turn in a process of its own.

    PYTHONPATH=src python -m repro_torch.tools.train_turns --other ROOT \
        [--pairs 4]

``ROOT`` is the root of another checkout of the repository (for example a
``git archive`` of the parent commit). Each tree first builds its kernels
(``kernels._build.build_all``, outside any timing); then the turns run in
pairs, the pairs alternating which tree goes first (other, this; this,
other; ...). Each turn imports the ``repro_torch`` of its own tree
(``<tree>/src``) and calls its ``pipeline.run_training`` without the
classifier stage, through one partition cache that the first turn fills.
Each turn prints one JSON line: ms per epoch (the train stage's epoch
seconds over the epochs, as phase 5 prints it), the partitions' mean loss
of the first and last epoch and the captured graphs. Then one line gives
each tree's turns, their medians, the pairs this tree won, and the card's
name and power limit (``nvidia-smi``). Exits non-zero when a turn fails,
when a loss is not finite, or without a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SCALE = 169343 / 40000

TURN = r"""
import json, sys
import numpy as np
import torch
from repro_torch.kernels import _build
from repro_torch.pipeline.pipeline import PipelineConfig, run_training
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
cfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                     classifier_epochs=0, cache_dir=sys.argv[1],
                     dataset_kwargs={"scale": float(sys.argv[2])})
r = run_training(cfg, device="cuda")
torch.cuda.synchronize()
losses = np.asarray(r.losses, dtype=np.float64)
print("turn: " + json.dumps({
    "ms_per_epoch": 1e3 * r.timings["train_epochs"] / cfg.epochs,
    "loss_first": float(losses[0].mean()),
    "loss_last": float(losses[-1].mean()),
    "finite": bool(np.isfinite(losses).all()),
    "compiles": r.compiles}), flush=True)
"""


def turn(root: str, cache_dir: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", TURN, cache_dir,
                           repr(SCALE)], env=env, capture_output=True,
                          text=True, timeout=900)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("turn: ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"the turn in {root} failed "
                         f"(exit {proc.returncode})")
    return json.loads(lines[-1][len("turn: "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=4,
                    help="pairs of turns (default 4)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_turns: no CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    ms = {"other": [], "this": []}
    with tempfile.TemporaryDirectory(prefix="train_turns-", dir=HERE) as tmp:
        for i in range(args.pairs):
            for name in (("other", "this") if i % 2 == 0 else
                         ("this", "other")):
                row = turn(trees[name], tmp)
                ms[name].append(row["ms_per_epoch"])
                print(json.dumps({"tree": name, "pair": i, **row}),
                      flush=True)
                if not row["finite"]:
                    raise SystemExit(f"a non-finite loss in {name}'s turn")
    print(json.dumps({
        "card": smi, "ms_per_epoch": ms,
        "median": {name: statistics.median(v) for name, v in ms.items()},
        "this_faster_pairs": sum(a < b for a, b in zip(ms["this"],
                                                       ms["other"])),
        "pairs": args.pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
