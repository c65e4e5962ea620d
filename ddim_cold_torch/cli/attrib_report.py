"""``python -m ddim_cold_torch attrib-report``: a profiler capture as a
slowest-scope-first attribution table (counterpart of the JAX package's
``scripts/attrib_report.py``).

Input: a directory that ``utils/profiling.trace`` wrote (its Kineto
``trace.json``), a ``.json[.gz]`` trace file, or ``--demo`` for the
synthetic Kineto fixture (``obs/attrib.demo_report``) — the same rendering
either way, so the format is testable without a card. ``--device-kind``
names the card for the FLOP/roofline columns (without scope costs they
stay ``-``); ``--json`` also writes the whole report. Host-only: it reads
files and builds no model.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from ddim_cold_torch.obs import attrib


def _fmt(v, spec="{}", none="-"):
    return none if v is None else spec.format(v)


def render(report: dict) -> str:
    """The table of JAX's ``_render``, rows in ``attrib.ranked_scopes`` order."""
    lines = [
        f"device: {report['device_kind'] or '?'} · "
        f"{report['device_lanes']} lane(s) · peak "
        f"{_fmt(report['peak_bf16_tflops'])} TFLOP/s · HBM "
        f"{_fmt(report['hbm_gb_s'])} GB/s · ridge "
        f"{_fmt(report['ridge_flops_per_byte'])} FLOP/byte",
        f"window {report['window_s']:.6f}s · busy "
        f"{report['device_busy_s']:.6f}s "
        f"({_fmt(report['busy_fraction'], '{:.1%}')}) · idle gaps "
        f"{report['idle_s']:.6f}s · coverage "
        f"{_fmt(report['coverage'], '{:.1%}')} of busy attributed "
        f"(floor {attrib.COVERAGE_FLOOR:.0%})",
        "",
        "| scope | self ms | total ms | share | TFLOP/s | MFU | bound |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, node in attrib.ranked_scopes(report):
        lines.append(
            f"| {name} | {1000 * node['self_s']:.3f} | "
            f"{1000 * node['total_s']:.3f} | "
            f"{_fmt(node['share_of_busy'], '{:.1%}')} | "
            f"{_fmt(node['achieved_tflops'])} | {_fmt(node['mfu'])} | "
            f"{_fmt(node['roofline'])} |")
    if report["tree"]:
        lines += ["", "scope nesting: " + " · ".join(
            f"{p} → {{{', '.join(kids)}}}"
            for p, kids in sorted(report["tree"].items()))]
    if report["fusion_candidates"]:
        lines += ["", "fusion candidates (adjacent scoped ops, launch gap "
                  f"≤ {attrib.DEFAULT_GAP_US:.0f}µs):"]
        for c in report["fusion_candidates"][:5]:
            lines.append(
                f"  {c['pair'][0]} → {c['pair'][1]}: {c['count']}× · "
                f"{c['total_gap_us']}µs reclaimable (mean "
                f"{c['mean_gap_us']}µs) over {c['combined_busy_us']}µs busy")
    return "\n".join(lines)


def main(argv: Sequence[str], base_dir: Optional[str] = None,
         device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ddim_cold_torch attrib-report",
        description="slowest-scope-first attribution table from a profiler trace")
    ap.add_argument("trace", nargs="?", default=None,
                    help="utils/profiling.trace output dir or .json[.gz] file")
    ap.add_argument("--demo", action="store_true",
                    help="render the synthetic Kineto fixture (no trace or card needed)")
    ap.add_argument("--device-kind", default=None,
                    help="card name for the flops/roofline join (e.g. 'NVIDIA H100 "
                         "80GB HBM3'); omit for time-only attribution")
    ap.add_argument("--gap-us", type=float, default=attrib.DEFAULT_GAP_US,
                    help="fusion-candidate launch-gap ceiling")
    ap.add_argument("--json", default=None, help="also write the full report to this path")
    args = ap.parse_args(list(argv))
    if args.demo:
        report = attrib.demo_report(gap_us=args.gap_us)
    elif args.trace:
        try:
            report = attrib.attribute(attrib.load_trace(args.trace),
                                      device_kind=args.device_kind, gap_us=args.gap_us)
        except attrib.AttribError as e:
            print(f"attrib-report: {e}", file=sys.stderr)
            return 1
        if not report["device_lanes"]:
            print("attrib-report: trace has no device lanes (a CPU capture records "
                  "host ranges only) — nothing to attribute; try --demo for the "
                  "fixture", file=sys.stderr)
            return 1
    else:
        ap.error("pass a trace path or --demo")
    print(render(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0
