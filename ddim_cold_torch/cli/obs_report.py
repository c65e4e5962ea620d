"""``python -m ddim_cold_torch obs-report``: export the span recorder, or
re-render a dumped span file (counterpart of the JAX package's
``scripts/obs_report.py``).

* ``--from-jsonl spans.jsonl --chrome trace.json`` — a JSONL span dump
  (``obs.spans.export_jsonl``) as Chrome trace-event JSON for
  chrome://tracing / Perfetto, and a per-trace text summary on stdout;
  host-only, byte for byte what JAX's script gives for the same file.
* ``--demo`` — a TINY traced serving drain (16 px, patch 8, C=32, depth 2)
  through the port's engine, then both exports; on the card, or the CPU
  with ``--device cpu`` (exit 3 without CUDA otherwise).

In-process users call ``obs.spans.export_chrome()`` directly; this command
is for the files they leave behind.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from ddim_cold_torch import cli


def _chrome_from_rows(rows):
    events = []
    for s in rows:
        t1 = s["t1"] if s["t1"] is not None else s["t0"]
        args = {"span_id": s["span_id"], "parent_id": s["parent_id"]}
        args.update(s.get("attrs") or {})
        if s["t1"] is None:
            args["open"] = True
        events.append({
            "name": s["name"], "cat": "serve", "ph": "X",
            "ts": round(s["t0"] * 1e6, 3),
            "dur": round((t1 - s["t0"]) * 1e6, 3),
            "pid": 0, "tid": s["trace_id"], "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _root_dur(spans_in_trace):
    tree = sorted(spans_in_trace, key=lambda s: (s["t0"], s["span_id"]))
    root = next((s for s in tree if s["parent_id"] is None), tree[0])
    dur = float("inf") if root["t1"] is None else root["t1"] - root["t0"]
    return dur, root, tree


def _summarize(rows):
    traces = {}
    for s in rows:
        traces.setdefault(s["trace_id"], []).append(s)
    print(f"{len(rows)} span(s) across {len(traces)} trace(s)")
    # slowest (or still-open) traces first: the p99 straggler is the one
    # being hunted, so it leads the report
    order = sorted(traces, key=lambda t: (-_root_dur(traces[t])[0], t))
    for tid in order:
        rdur, root, tree = _root_dur(traces[tid])
        dur = "open" if root["t1"] is None else f"{rdur:.4f}s"
        print(f"trace {tid}: {root['name']} ({dur}, {len(tree)} spans)")
        for s in tree:
            if s is root:
                continue
            sdur = "open" if s["t1"] is None else f"{s['t1'] - s['t0']:.4f}s"
            attrs = {k: v for k, v in (s.get("attrs") or {}).items()}
            print(f"  {s['name']:<12} {sdur:>10}  {attrs}")


def _demo(chrome_path: str, jsonl_path: str, dev):
    from ddim_cold_torch import serve
    from ddim_cold_torch.models import DiffusionViT
    from ddim_cold_torch.obs import spans

    model = DiffusionViT(img_size=(16, 16), patch_size=8, embed_dim=32, depth=2,
                         num_heads=4, total_steps=2000, device=dev)
    cfg = serve.SamplerConfig(k=500)
    engine = serve.Engine(model, buckets=(2,), device=dev)
    serve.warmup(engine, [cfg])
    with spans.tracing():
        for seed in (0, 1):
            engine.submit(seed=seed, n=2, config=cfg)
        engine.run()
    rows = spans.export_jsonl(jsonl_path)
    spans.export_chrome(chrome_path)
    return rows


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ddim_cold_torch obs-report",
                                 description=__doc__)
    ap.add_argument("--from-jsonl", metavar="PATH",
                    help="read spans from a JSONL dump instead of running")
    ap.add_argument("--chrome", metavar="PATH", default=None,
                    help="write Chrome trace-event JSON here")
    ap.add_argument("--jsonl", metavar="PATH", default=None,
                    help="write (or re-write) a JSONL span dump here")
    ap.add_argument("--demo", action="store_true",
                    help="run a TINY traced serving drain first")
    ap.add_argument("--device", default=device,
                    help="'cpu' to run --demo on the CPU (default: the card)")
    args = ap.parse_args(list(argv))

    if args.demo:
        dev = cli.device_or_exit(args.device, "obs-report")
        if dev is None:
            return cli.NO_ACCELERATOR
        rows = _demo(args.chrome or "obs_trace.json", args.jsonl or "obs_spans.jsonl", dev)
    elif args.from_jsonl:
        with open(args.from_jsonl) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if args.chrome:
            with open(args.chrome, "w") as f:
                json.dump(_chrome_from_rows(rows), f)
        if args.jsonl:
            with open(args.jsonl, "w") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
    else:
        ap.error("pass --from-jsonl PATH or --demo")
    _summarize(rows)
    return 0
