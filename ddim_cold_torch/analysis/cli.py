"""graftcheck of the port — ``python -m ddim_cold_torch.analysis``.

Counterpart of ``ddim_cold_tpu/analysis/cli.py``. Runs the layers ported so
far over ``ddim_cold_torch/`` — AST lint (A), thread-safety lockset
analysis (T), RPC protocol proofs (R), SamplerConfig lattice coverage (X)
and Hopper kernel geometry (P) — subtracts the reviewed ``--baseline``
allowlist (by default the package's own ``baseline.txt``), prints the rest
and exits nonzero if any remain. ``--fix-baseline`` regenerates the
allowlist deterministically instead (sorted, deduped) so its diffs review
cleanly; combined with ``--only`` it refreshes ONLY the selected layers'
rule families, preserving the other layers' reviewed lines verbatim.

``--only`` takes layer names or rule-family letters, comma-separable:
``--only T,R`` ≡ ``--only threads --only protocol``.

The four trace layers of the JAX package (jaxpr J, memory M, collective C,
sharding S) walk traced programs; the port has no trace harness yet, so
asking for one raises :class:`UnportedLayerError` (ROADMAP Queue 1 item
19). There is no ``--platform`` flag: nothing here traces, and the kernel
layer reads the launch code's own Python, so the CLI runs the same on the
CPU and on the card's machine, with no JAX installed.

All five layers are host-side (no device, no trace), so they fan out onto
worker threads; each returns its own findings list, and the final
``sorted()`` merge keeps output order identical to a serial run.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

from ddim_cold_torch.analysis import findings as F

#: every layer of the JAX package's graftcheck, by name (the ids of its
#: rule families stay the same)
LAYERS = ("ast", "jaxpr", "kernels", "memory", "sharding", "threads",
          "collective", "protocol", "config")
#: the layers this package runs; the others raise UnportedLayerError
PORTED_LAYERS = ("ast", "threads", "protocol", "config", "kernels")
#: the trace layers still to port
UNPORTED_LAYERS = tuple(layer for layer in LAYERS if layer not in PORTED_LAYERS)

#: rule-family letters accepted by --only as layer aliases (--only T,R)
_ONLY_ALIASES = {"a": "ast", "j": "jaxpr", "s": "sharding",
                 "t": "threads", "c": "collective",
                 "p": "kernels", "m": "memory",
                 "r": "protocol", "x": "config"}

#: the reviewed allowlist of the port (the root ``graftcheck.baseline`` is
#: the JAX package's)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.txt")


class UnportedLayerError(ValueError):
    """A layer of the JAX package's graftcheck that the port does not run
    yet: the trace layers, ROADMAP Queue 1 item 19."""

    def __init__(self, layers):
        self.layers = tuple(layers)
        super().__init__(
            f"layer(s) {', '.join(self.layers)} walk traced programs and are "
            "not ported yet (ROADMAP Queue 1 item 19: the trace half of the "
            "analysis package, which needs a torch trace harness); the port "
            f"runs {', '.join(PORTED_LAYERS)}")


def parse_only(values) -> tuple:
    """Normalize repeatable/comma-separated ``--only`` tokens (layer names
    or family letters, any case) into an ordered layer tuple. Raises
    ``argparse.ArgumentTypeError`` for an unknown layer and
    :class:`UnportedLayerError` for a trace layer."""
    out = []
    for value in values:
        for tok in value.split(","):
            tok = tok.strip().lower()
            if not tok:
                continue
            layer = _ONLY_ALIASES.get(tok, tok)
            if layer not in LAYERS:
                raise argparse.ArgumentTypeError(
                    f"unknown layer {tok!r} (choose from "
                    f"{', '.join(LAYERS)} or letters "
                    f"{', '.join(sorted(_ONLY_ALIASES))})")
            if layer not in out:
                out.append(layer)
    unported = [layer for layer in out if layer in UNPORTED_LAYERS]
    if unported:
        raise UnportedLayerError(unported)
    return tuple(out)


def repo_root() -> str:
    """The directory holding the ``ddim_cold_torch`` package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _layer(layer: str, root: str) -> list:
    """One host-side layer's findings — no trace, no shared state, safe on
    a worker thread."""
    if layer == "ast":
        from ddim_cold_torch.analysis import ast_checks

        return ast_checks.lint_tree(root)
    if layer == "threads":
        from ddim_cold_torch.analysis import thread_checks

        return thread_checks.lint_tree(root)
    if layer == "protocol":
        from ddim_cold_torch.analysis import protocol_checks

        return protocol_checks.run_protocol_checks(root)
    if layer == "kernels":
        from ddim_cold_torch.analysis import kernel_checks

        return kernel_checks.run_kernel_checks()
    from ddim_cold_torch.analysis import config_checks

    return config_checks.run_config_checks(root)


def collect(root: str, only=PORTED_LAYERS) -> list[F.Finding]:
    """All findings from the requested layers, sorted for stable output.
    A worker's exception propagates exactly like a serial failure would."""
    unported = [layer for layer in only if layer in UNPORTED_LAYERS]
    if unported:
        raise UnportedLayerError(unported)
    out: list[F.Finding] = []
    with ThreadPoolExecutor(max_workers=max(1, len(only))) as pool:
        futures = [pool.submit(_layer, layer, root) for layer in only]
        for future in futures:
            out += future.result()
    return sorted(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ddim_cold_torch.analysis",
        description="static analysis of the ddim_cold_torch invariants "
                    "(host layers A, T, R, X and the Hopper kernel layer P)")
    ap.add_argument("--root", default=repo_root(),
                    help="repo root holding the ddim_cold_torch package")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE, metavar="FILE",
                    help="reviewed allowlist; listed findings don't fail "
                         "the run (default: the package's baseline.txt; a "
                         "missing file is an empty baseline)")
    ap.add_argument("--fix-baseline", default=None, metavar="FILE",
                    help="write the current findings as the new baseline "
                         "and exit 0; with --only, refresh ONLY the "
                         "selected layers' rule families and keep the "
                         "file's other lines verbatim")
    ap.add_argument("--only", action="append", default=None,
                    metavar="LAYER[,LAYER...]",
                    help="run a subset of layers (repeatable or "
                         "comma-separated; layer names or rule-family "
                         "letters: --only T,R)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(F.RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    try:
        only = parse_only(args.only) if args.only else PORTED_LAYERS
    except argparse.ArgumentTypeError as e:
        ap.error(str(e))
    all_findings = collect(args.root, only=only)

    if args.fix_baseline:
        extra: set[str] = set()
        if args.only:
            # partial refresh: the layers we did NOT run stay authoritative
            # in the existing file — carry their lines over verbatim
            extra = {k for k in F.load_baseline(args.fix_baseline)
                     if F.rule_layer(k.split(" ", 1)[0]) not in only}
        n = F.write_baseline(args.fix_baseline, all_findings,
                             extra_keys=extra)
        kept = f" ({len(extra)} kept from other layers)" if extra else ""
        print(f"graftcheck: wrote {n} baseline entr"
              f"{'y' if n == 1 else 'ies'} to {args.fix_baseline}{kept}")
        return 0

    baseline = F.load_baseline(args.baseline)
    fresh = [f for f in all_findings if f.key not in baseline]
    suppressed = len(all_findings) - len(fresh)
    for f in fresh:
        print(f.render())
    tail = f" ({suppressed} baselined)" if suppressed else ""
    unrun = "" if args.only else \
        f"; not ported yet: {', '.join(UNPORTED_LAYERS)} (ROADMAP Queue 1 item 19)"
    print(f"graftcheck: {len(fresh)} finding"
          f"{'' if len(fresh) == 1 else 's'}{tail} "
          f"[layers: {', '.join(only)}{unrun}]")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
