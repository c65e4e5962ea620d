"""Run the serve and train phases of ``chip_smoke.py`` from several trees,
one child process per tree, in the order given, on one CUDA card.

    python -m ddim_cold_torch.tools.ab_phases <tree> [<tree> ...] [--out FILE]

Each tree is a checkout of this repo (a ``git archive`` of another commit,
or the working tree). Its child builds the tree's kernels, then runs that
tree's own ``phase_forward``, ``phase_serve`` and ``phase_train``, so each
reading is what that commit's ``chip_smoke.py`` reports. To compare two
commits give them as parent, change, change, parent. The last line is one
JSON object: per run, the tree, the serve phase's img/s and the train
phase's ms/step on the flash and dense routes, and the card's name and
power limit. ``--out`` also writes every phase line of every child there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = """
import json, sys
from concurrent.futures import ThreadPoolExecutor
import torch
import chip_smoke as cs
from ddim_cold_torch import serve
from ddim_cold_torch.models import MODEL_CONFIGS, DiffusionViT
from ddim_cold_torch.ops import _build
from ddim_cold_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
with ThreadPoolExecutor(len(cs.SOURCES)) as pool:
    list(pool.map(_build.load_library, cs.SOURCES))
model = cs.phase_forward(torch, DiffusionViT, MODEL_CONFIGS)
eng = cs.phase_serve(torch, model, fa, serve)[0]
del eng, model
torch.cuda.empty_cache()
cs.phase_train(torch, fa)
sys.exit(1 if cs.FAILURES else 0)
"""


def run_tree(tree: str) -> tuple[dict, list]:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                          text=True, timeout=900, env=dict(os.environ, PYTHONPATH=tree))
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{") and '"phase"' in line]
    serve = [r for r in lines if r.get("phase") == "serve"]
    train = {r["path"].split()[0]: r for r in lines if r.get("phase") == "train"}
    out = {"tree": tree, "rc": proc.returncode,
           "serve_img_per_sec": serve[0]["img_per_sec"] if serve else None,
           "train_ms_per_step": {k: r["ms_per_step"] for k, r in train.items()},
           "train_peak_mem_gib": {k: r["peak_mem_gib"] for k, r in train.items()}}
    if proc.returncode:
        out["stderr_tail"] = proc.stderr[-2000:]
    return out, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_phases: torch.cuda.is_available() is False — the phases run on "
              "a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs, phases = [], []
    for tree in args.trees:
        got, lines = run_tree(os.path.abspath(tree))
        print(json.dumps(got), flush=True)
        runs.append(got)
        phases.append({"tree": got["tree"], "phases": lines})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(phases, f)
    print(json.dumps({"nvidia_smi": smi.strip(), "runs": runs}), flush=True)
    return 1 if any(r["rc"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
