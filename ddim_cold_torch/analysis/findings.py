"""Finding records, the rule table, and the reviewed-baseline grammar.

Counterpart of ``ddim_cold_tpu/analysis/findings.py`` (the port keeps its
own copy: it imports nothing of the JAX package). A :class:`Finding` is one
rule violation at one place. The ``(rule, path, subject)`` triple is the
finding's identity: line numbers drift with every edit, so the baseline
(the reviewed allowlist ``--baseline`` consumes and ``--fix-baseline``
regenerates) keys on the stable triple and carries the line only for
display. ``subject`` is chosen per rule to survive unrelated edits: an
enclosing-function + callee pair, a fault site, a kernel entry name.

Baseline grammar (one finding per line, ``#`` comments and blanks ignored)::

    <RULE-ID> <path> :: <subject>
    GRAFT-A002 ddim_cold_torch/data/datasets.py :: _probe:Exception

``--fix-baseline`` writes the file sorted and de-duplicated so regenerated
baselines diff cleanly under review.

The rule ids are JAX's, never renumbered. The J, S, C and M rules walk
traced programs; their layers are still to be ported (ROADMAP Queue 1
item 19), so they stay in the table, marked so, and no layer here emits
them. The P rules keep their ids with the meaning re-worded for Hopper.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

#: the note the rules of the unported trace layers carry
_TRACE_LAYER = " [emitted by a trace layer still to port: ROADMAP Queue 1 item 19]"

#: rule id → one-line description. Stable ids: tests, baselines and CI grep
#: these — never renumber, only append.
RULES = {
    "GRAFT-J001": "low-precision (bf16/f16) accumulation in a matmul/conv — "
                  "violates the bf16-trunk/f32-accumulate dtype policy"
                  + _TRACE_LAYER,
    "GRAFT-J002": "weak-typed float output from a traced entry point — "
                  "promotion hazard and a recompile hazard" + _TRACE_LAYER,
    "GRAFT-J003": "donated buffer dropped: no output matches the donated "
                  "buffer's (shape, dtype), so donation frees nothing"
                  + _TRACE_LAYER,
    "GRAFT-J004": "oversized constant baked into a traced program"
                  + _TRACE_LAYER,
    "GRAFT-J005": "host callback inside a scanned sampler body — forces a "
                  "host sync every step" + _TRACE_LAYER,
    "GRAFT-J006": "unstable or colliding abstract trace signature across the "
                  "serve sweep — breaks the zero-programs-after-warmup "
                  "guarantee" + _TRACE_LAYER,
    "GRAFT-J007": "data-dependent loop in a served sampler program — the "
                  "adaptive drift gate must select branches inside one "
                  "static-trip loop" + _TRACE_LAYER,
    "GRAFT-A001": "wall-clock/stdlib-random/numpy-random call, or a torch "
                  "RNG draw without an explicit generator=, inside a function "
                  "on the device path (a torch.autograd.Function's "
                  "forward/backward, an nn.Module's forward, or a function "
                  "handed to checkpoint/vmap/grad/compile) — nondeterminism "
                  "the fault-replay and explicit-generator contracts forbid",
    "GRAFT-A002": "broad `except Exception`/bare `except` without a "
                  "`# noqa: BLE001` justification on the same line",
    "GRAFT-A003": "faults.fire() site violation: unregistered site name, "
                  "non-literal site, or duplicate (site, tag) pair",
    "GRAFT-A004": "torch call in a host-only module — a device import or "
                  "sync where routing, planning, metrics and reports must "
                  "stay on host types",
    "GRAFT-A005": "obs.metrics emit violation: unregistered metric name, "
                  "non-literal name, or duplicate (name, key) emit site",
    "GRAFT-S001": "trunk GEMM weight fell through to a replicated layout on "
                  "a model-axis mesh" + _TRACE_LAYER,
    "GRAFT-S002": "parameter without a usable layout (structure mismatch, "
                  "rank overflow, or unknown mesh axis)" + _TRACE_LAYER,
    "GRAFT-T001": "shared attribute with a declared `# guarded-by:` lock "
                  "written (outside __init__) without holding the guard — "
                  "a data race on the worker-thread/submit path",
    "GRAFT-T002": "lock acquired while holding a lock of equal or higher "
                  "rank in the declared hierarchy (router < engine/fleet < "
                  "batching < obs < kernel build < launch counters) — an "
                  "ordering inversion that can deadlock",
    "GRAFT-T003": "ticket resolution or user-visible callback invoked while "
                  "holding a lock — the callback can re-enter the serving "
                  "layer and deadlock (callbacks must fire outside locks)",
    "GRAFT-T004": "Event.wait()/Condition.wait() on one synchronizer while "
                  "holding a different lock — the notifier may need that "
                  "lock, wedging both threads",
    "GRAFT-T005": "unguarded lazy-init: check-then-set on a guarded shared "
                  "attribute without the lock (and without a re-check under "
                  "it) — double allocation under concurrent first use",
    "GRAFT-C001": "collective sequence diverges across the ranks of one "
                  "mesh — every rank must run the same collectives in the "
                  "same order" + _TRACE_LAYER,
    "GRAFT-C002": "collective over a mesh axis the program's mesh does not "
                  "define" + _TRACE_LAYER,
    "GRAFT-P001": "Hopper tile/launch illegality at a registered kernel "
                  "geometry: a wgmma tile off its shape rules (M a multiple "
                  "of 64 per warpgroup, N a multiple of 8 up to 256, K a "
                  "multiple of 16 bf16 / 32 int8), threads not a multiple of "
                  "128 (wgmma) or over 1,024, grid y/z over 65,535 or not "
                  "Python ints, an asynchronously copied row off 16 bytes, or "
                  "a padded extent not a whole number of the kernel's tile",
    "GRAFT-P002": "kernel's static + dynamic shared memory over the card's "
                  "per-block limit (utils/flops.smem_bytes), or, measured on "
                  "the card, registers × threads over 65,536 or spills",
    "GRAFT-P003": "padding inflates a kernel's compute beyond the waste "
                  "threshold over the registered logical extent",
    "GRAFT-M001": "traced program's peak live device-memory bound exceeds "
                  "the device kind's budget" + _TRACE_LAYER,
    "GRAFT-M002": "bucket/sequence padding inflates a traced program's "
                  "resident token axis beyond the threshold" + _TRACE_LAYER,
    "GRAFT-R001": "RPC frame-kind parity violation: a wire method/event "
                  "without a table entry, a table entry without a site, a "
                  "client/server table mismatch, or a health field missing "
                  "from a backend the fleet control plane reads",
    "GRAFT-R002": "exception-serialization hole: a serve/errors.py type "
                  "outside the wire codec (or failing round-trip), or a "
                  "protocol-module raise of an unregistered type that "
                  "would degrade to RequestFailedError on the wire",
    "GRAFT-R003": "rid lifecycle inversion: the client ticket registration "
                  "does not dominate the submit send — a done event racing "
                  "the response finds no ticket",
    "GRAFT-R004": "unbounded read/send on the RPC wire: a length-prefixed "
                  "read or frame send without a MAX_FRAME_BYTES check, an "
                  "uncapped recv chunk, or a socket going deadline-free "
                  "before its validated handshake read",
    "GRAFT-R005": "wire chaos-site gap: the frame-send/dispatch choke "
                  "points don't fire their registered rpc.*/replica.* "
                  "fault sites (or the sites aren't registered at all)",
    "GRAFT-X001": "legal SamplerConfig program class with no serve-sweep "
                  "witness — it would reach production unchecked and "
                  "unwarmed",
    "GRAFT-X002": "config validation inconsistency: construction-time and "
                  "program-build gates disagree, a distill-producible "
                  "student count is unservable, or a frozen config is "
                  "mutated past the gate via object.__setattr__",
    "GRAFT-X003": "warm-set/bench config outside the legal lattice (or "
                  "warmed without a sweep witness) — serving would warm or "
                  "benchmark a program the lattice proofs never saw",
}

#: rule-family letter (GRAFT-<X>NNN) → the CLI layer that emits it. The
#: partial --fix-baseline (--only) uses this to know which baseline lines a
#: layer run is authoritative for.
RULE_LAYERS = {"A": "ast", "J": "jaxpr", "S": "sharding",
               "T": "threads", "C": "collective",
               "P": "kernels", "M": "memory",
               "R": "protocol", "X": "config"}


def rule_layer(rule: str) -> str:
    """The CLI layer a rule id belongs to (``GRAFT-T001`` → ``threads``)."""
    return RULE_LAYERS[rule.split("-", 1)[1][0]]


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation. Identity (baseline key) is (rule, path, subject);
    ``line``/``message`` are display-only."""

    rule: str
    path: str          # repo-relative, '/'-separated
    subject: str       # stable short identifier within the file/check
    line: int = field(default=0, compare=True)
    message: str = field(default="", compare=False)

    @property
    def key(self) -> str:
        return f"{self.rule} {self.path} :: {self.subject}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule} {loc} [{self.subject}] {self.message}"


def load_baseline(path: str | None) -> set[str]:
    """Parse a baseline file into the set of suppressed finding keys. A
    missing file is an empty baseline (strict), never an error. A line may
    end in a ``#`` comment (the reason it was reviewed in)."""
    keys: set[str] = set()
    if not path or not os.path.isfile(path):
        return keys
    with open(path) as f:
        for raw in f:
            line = raw.split(" #", 1)[0].strip()
            if not line or line.startswith("#"):
                continue
            if " :: " not in line or not line.split(" ", 1)[0] in RULES:
                raise ValueError(
                    f"{path}: malformed baseline line {line!r} "
                    "(expected '<RULE-ID> <path> :: <subject>')")
            keys.add(line)
    return keys


def write_baseline(path: str, findings: list[Finding],
                   extra_keys: set[str] | frozenset = frozenset()) -> int:
    """Regenerate the allowlist deterministically: header, then the sorted,
    de-duplicated keys of ``findings``. ``extra_keys`` are preserved
    alongside the regenerated keys — the partial refresh
    (``--fix-baseline --only``) passes the lines of layers it did NOT run,
    so adopting one rule family never churns the others' reviewed
    entries."""
    keys = sorted({f.key for f in findings} | set(extra_keys))
    with open(path, "w") as f:
        f.write("# graftcheck baseline of the port — reviewed allowlist of "
                "known findings.\n")
        f.write("# One per line: <RULE-ID> <path> :: <subject>  # reason   "
                "(regenerate: python -m ddim_cold_torch.analysis "
                "--fix-baseline FILE)\n")
        for k in keys:
            f.write(k + "\n")
    return len(keys)
