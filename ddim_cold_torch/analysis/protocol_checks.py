"""R-rules: the fleet RPC protocol, statically proven (graftcheck layer R).

Counterpart of ``ddim_cold_tpu/analysis/protocol_checks.py`` over the
port's ``serve/remote.py``, ``replica_main.py``, ``backend.py``,
``errors.py`` and ``utils/faults.py``, which copy the JAX package's wire
protocol. The JAX package's review found the wire-protocol failure classes these rules now make
*provable* instead of reviewed-for: a ticket registered after its submit
frame left (a done event racing the response had no ticket to resolve), an
unbounded hello read (a wedged child blocking fleet supervision forever),
and frame limits enforced on one side only. Each is a RULE here, with a
violating fixture in tests/test_protocol_checks.py replaying the old code
shape.

Two halves, both cheap (no tracing, no sockets):

* **pure AST** over the protocol modules (``lint_source`` /
  ``lint_protocol_sources``) — frame-table/site parity, rid-lifecycle
  statement ordering, bounded-read discipline, raise-type wire coverage,
  chaos-site presence;
* **import-time introspection** (``run_protocol_checks``) — the literal
  frame tables on both sides of the wire are set-equal, every
  ``serve/errors.py`` type round-trips through the wire codec, the wire
  chaos sites are registered, and the ``health()`` field contract holds
  for every backend the fleet control plane reads.

Rules:

* **R001 frame-kind parity** — every client-sent method literal is in
  ``remote.CLIENT_METHODS`` and that table is set-equal to the server's
  ``replica_main.SERVER_METHODS`` (each pinned to its actual dispatch
  arms); every server-pushed event literal is in
  ``replica_main.SERVER_EVENTS`` and has a client dispatch arm
  (``remote.CLIENT_EVENT_ARMS``). Also the health-field half of the frame
  contract: every key in ``REQUIRED_HEALTH_KEYS`` (the set the router +
  autoscaler read) is provided by every health backend (Engine, StubEngine,
  the LocalReplica/RemoteReplica augmentations).
* **R002 exception-serialization totality** — every exception class
  ``serve/errors.py`` defines round-trips through
  ``encode_exception``/``decode_exception`` as its own type, and every
  ``raise SomeError(...)`` in the protocol modules names a registered wire
  type (anything else degrades to ``RequestFailedError`` — legal only for
  types the server cannot anticipate, never for its own raises).
* **R003 rid-lifecycle ordering** — in any function that both registers a
  ticket into a ``*tickets*`` table and sends a ``"submit"`` frame, the
  registration statement must dominate the send (the rid-after-send
  race: a fast done event must always find its ticket).
* **R004 bounded-read discipline** — length-prefixed reads check
  ``MAX_FRAME_BYTES`` before allocation, raw ``recv`` chunks are
  ``min()``-capped, sends re-check the limit before ``sendall``, and a
  socket may only go deadline-free (``settimeout(None)``) AFTER its
  validated handshake read.
* **R005 fault-site coverage** — the client's frame-send choke point fires
  ``rpc.drop``/``rpc.latency``, the server fires
  ``replica.kill``/``replica.hang`` on its work methods, all four sites
  are registered in ``faults.SITES``, and ``WORK_METHODS`` is a subset of
  the served method table.
"""

from __future__ import annotations

import ast
import os

from ddim_cold_torch.analysis.findings import Finding

#: the modules the R-layer walks (repo-relative)
PROTOCOL_MODULES = (
    "ddim_cold_torch/serve/remote.py",
    "ddim_cold_torch/serve/replica_main.py",
    "ddim_cold_torch/serve/backend.py",
    "ddim_cold_torch/serve/errors.py",
    "ddim_cold_torch/utils/faults.py",
)

#: health-dict keys the fleet control plane (serve/router.py +
#: serve/autoscale.py) reads off replica snapshots. R001 proves every
#: backend provides each of them, and that each is actually still read
#: (a stale pin would rot silently).
REQUIRED_HEALTH_KEYS = (
    "state", "queue_depth", "open_tickets", "latency_p95_s",
    "last_progress_s", "stalled", "closed", "quarantined",
    # JAX's compiles_after_warmup: the port builds programs, it compiles none
    "programs_after_warmup",
)

#: the providers of those keys: (path, class, method) triples whose dict
#: literals / ``h["key"] = ...`` augmentations together must cover
#: REQUIRED_HEALTH_KEYS. Engine and StubEngine each pair with the
#: LocalReplica augmentation (the handle every backend is served behind).
_HEALTH_PROVIDERS = (
    ("ddim_cold_torch/serve/engine.py", "Engine"),
    ("ddim_cold_torch/serve/replica_main.py", "StubEngine"),
)
_HEALTH_AUGMENTORS = (
    ("ddim_cold_torch/serve/fleet.py", "LocalReplica"),
    ("ddim_cold_torch/serve/remote.py", "RemoteReplica"),
)
_HEALTH_CONSUMERS = (
    "ddim_cold_torch/serve/router.py",
    "ddim_cold_torch/serve/autoscale.py",
)

#: the wire-level chaos sites R005 pins (client send path + server work
#: dispatch), the way A003 pins fire() sites generally
WIRE_FAULT_SITES = ("rpc.drop", "rpc.latency", "replica.kill",
                    "replica.hang")


# ---------------------------------------------------------------------------
# small AST helpers (same idiom as ast_checks)
# ---------------------------------------------------------------------------

def _dotted(node) -> str:
    """Best-effort dotted name of an expression (``a.b.c``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_name(call: ast.Call) -> str:
    """Trailing name of the called function (``self._call`` → ``_call``)."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _functions(tree: ast.AST):
    """(qualname, FunctionDef) for every function, class-qualified."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((f"{prefix}{child.name}", child))
                walk(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def _module_tables(tree: ast.AST) -> dict:
    """Module-level ``NAME = ("lit", ...)`` tuple assignments."""
    tables = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [_str_const(e) for e in node.value.elts]
            if all(v is not None for v in vals):
                tables[target.id] = (tuple(vals), node.lineno)
    return tables


def _fired_sites(tree: ast.AST) -> set:
    """String literals passed as the first arg of a ``*.fire(...)`` call."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) == "fire" \
                and node.args:
            lit = _str_const(node.args[0])
            if lit:
                out.add(lit)
    return out


# ---------------------------------------------------------------------------
# R001 — frame-kind parity (AST half: table ↔ site consistency per module)
# ---------------------------------------------------------------------------

def _client_method_literals(tree: ast.AST) -> set:
    """Method literals the client puts on the wire: first arg of
    ``self._call("m", ...)`` plus ``"method": "m"`` keys in dicts handed
    to ``_send``."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "_call" and node.args:
            lit = _str_const(node.args[0])
            if lit:
                out.add(lit)
        elif name == "_send":
            for arg in node.args:
                if isinstance(arg, ast.Dict):
                    for k, v in zip(arg.keys, arg.values):
                        if _str_const(k) == "method" and _str_const(v):
                            out.add(_str_const(v))
    return out


def _event_compare_arms(tree: ast.AST) -> set:
    """Event kinds the client-side code compares against: ``event ==
    "kind"`` / ``x.get("event") != "kind"`` anywhere in the module."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare) or len(node.comparators) != 1:
            continue
        sides = (node.left, node.comparators[0])
        lits = [_str_const(s) for s in sides]
        names = []
        for s in sides:
            if isinstance(s, ast.Name):
                names.append(s.id)
            elif isinstance(s, ast.Call) and _call_name(s) == "get" \
                    and s.args and _str_const(s.args[0]) == "event":
                names.append("event")
        if "event" in names:
            out.update(v for v in lits if v)
    return out


def _server_handler_methods(tree: ast.AST) -> set:
    """Method kinds a server ``handle`` function dispatches: ``method ==
    "m"`` comparisons and ``method in ("a", "b")`` memberships."""
    out = set()
    for qual, fn in _functions(tree):
        if not qual.endswith("handle"):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Compare) \
                    or len(node.comparators) != 1:
                continue
            left_is_method = (isinstance(node.left, ast.Name)
                              and node.left.id == "method") or \
                (isinstance(node.left, ast.Call)
                 and _call_name(node.left) == "get"
                 and node.left.args
                 and _str_const(node.left.args[0]) == "method")
            if not left_is_method:
                continue
            comp = node.comparators[0]
            if isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                lit = _str_const(comp)
                if lit:
                    out.add(lit)
            elif isinstance(node.ops[0], (ast.In, ast.NotIn)):
                if isinstance(comp, (ast.Tuple, ast.List)):
                    out.update(v for v in
                               (_str_const(e) for e in comp.elts) if v)
    return out


def _pushed_events(tree: ast.AST) -> set:
    """Event kinds a server pushes: ``send({"event": "kind", ...})``."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _call_name(node) != "send":
            continue
        for arg in node.args:
            if isinstance(arg, ast.Dict):
                for k, v in zip(arg.keys, arg.values):
                    if _str_const(k) == "event" and _str_const(v):
                        out.add(_str_const(v))
    return out


def _check_frame_tables(tree: ast.AST, rel: str) -> list:
    """R001 per-module half: every wire literal is in its declared table
    and every table entry has a site. Modules without wire sites (backend,
    errors, faults) pass through untouched."""
    findings = []
    tables = _module_tables(tree)

    def pin(table_name: str, sites: set, kind: str):
        if table_name not in tables:
            if sites:
                findings.append(Finding(
                    "GRAFT-R001", rel, f"missing-table:{table_name}", 1,
                    f"{kind} literals {sorted(sites)} on the wire but no "
                    f"{table_name} table pins them"))
            return
        declared, lineno = tables[table_name]
        for name in sorted(sites - set(declared)):
            findings.append(Finding(
                "GRAFT-R001", rel, f"{table_name}:{name}", lineno,
                f"{kind} {name!r} used on the wire but missing from "
                f"{table_name}"))
        for name in sorted(set(declared) - sites):
            findings.append(Finding(
                "GRAFT-R001", rel, f"{table_name}:{name}", lineno,
                f"{table_name} declares {name!r} but no {kind} site "
                "uses it"))

    client_methods = _client_method_literals(tree)
    if client_methods or "CLIENT_METHODS" in tables:
        pin("CLIENT_METHODS", client_methods, "client-sent method")
        pin("CLIENT_EVENT_ARMS", _event_compare_arms(tree),
            "client event dispatch arm")
    server_methods = _server_handler_methods(tree)
    if server_methods or "SERVER_METHODS" in tables:
        pin("SERVER_METHODS", server_methods, "server handler method")
        pin("SERVER_EVENTS", _pushed_events(tree), "server-pushed event")
    return findings


def _health_dict_keys(tree: ast.AST, cls: str) -> set:
    """Keys a class's ``health`` method provides: string keys of every
    dict literal it returns plus ``h["key"] = ...`` augmentations."""
    out = set()
    for qual, fn in _functions(tree):
        if qual != f"{cls}.health":
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                out.update(v for v in (_str_const(k) for k in node.keys
                                       if k is not None) if v)
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript):
                        lit = _str_const(target.slice)
                        if lit:
                            out.add(lit)
    return out


def _read_health_keys(tree: ast.AST) -> set:
    """Keys a consumer module reads off health snapshots: ``x.get("k")``
    and ``x["k"]`` literals (broad on purpose — freshness pin only)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) == "get" \
                and node.args:
            lit = _str_const(node.args[0])
            if lit:
                out.add(lit)
        elif isinstance(node, ast.Subscript):
            lit = _str_const(node.slice)
            if lit:
                out.add(lit)
    return out


def _check_health_parity(root: str) -> list:
    """R001 health half: every REQUIRED_HEALTH_KEYS key is provided by
    every backend (engine-level dict ∪ handle-level augmentation) and is
    still actually read by a consumer."""
    findings = []
    trees = {}
    for rel in {p for p, _ in _HEALTH_PROVIDERS} \
            | {p for p, _ in _HEALTH_AUGMENTORS} | set(_HEALTH_CONSUMERS):
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            return []  # partial checkout (fixture runs) — nothing to pin
        with open(path) as f:
            trees[rel] = ast.parse(f.read())
    augmented = set()
    for rel, cls in _HEALTH_AUGMENTORS:
        augmented |= _health_dict_keys(trees[rel], cls)
    for rel, cls in _HEALTH_PROVIDERS:
        provided = _health_dict_keys(trees[rel], cls) | augmented
        for key in REQUIRED_HEALTH_KEYS:
            if key not in provided:
                findings.append(Finding(
                    "GRAFT-R001", rel, f"health-key:{cls}:{key}", 0,
                    f"{cls}.health() (plus the replica-handle "
                    f"augmentations) never provides {key!r}, which the "
                    "fleet control plane reads — backends must share one "
                    "health field contract"))
    read = set()
    for rel in _HEALTH_CONSUMERS:
        read |= _read_health_keys(trees[rel])
    for key in REQUIRED_HEALTH_KEYS:
        if key not in read:
            findings.append(Finding(
                "GRAFT-R001", _HEALTH_CONSUMERS[0], f"health-key:{key}", 0,
                f"REQUIRED_HEALTH_KEYS pins {key!r} but no control-plane "
                "consumer reads it any more — drop it from the pin"))
    return findings


# ---------------------------------------------------------------------------
# R002 — exception-serialization totality (AST half: raise discipline)
# ---------------------------------------------------------------------------

def _check_raise_types(tree: ast.AST, rel: str, wire_names: frozenset
                       ) -> list:
    """Every ``raise SomeError(...)`` in a protocol module must name a
    registered wire type: the server encodes ITS OWN raises, and a type
    outside the table silently degrades to RequestFailedError — losing the
    retryable/terminal distinction the router keys on."""
    findings = []
    for qual, fn in _functions(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name) and exc.id[:1].isupper():
                name = exc.id
            if name is None or not name[:1].isupper():
                continue  # re-raise of a bound variable — typed upstream
            if name not in wire_names:
                findings.append(Finding(
                    "GRAFT-R002", rel, f"{qual}:{name}", node.lineno,
                    f"raise {name} in a protocol module but {name!r} is "
                    "not a registered wire type — it would cross the RPC "
                    "boundary degraded to RequestFailedError"))
    return findings


def _wire_type_names() -> frozenset:
    from ddim_cold_torch.serve import errors

    return frozenset(errors._wire_types())


def _check_wire_roundtrip() -> list:
    """R002 import half: every serve/errors.py exception class is in the
    wire table and decode(encode(exc)) restores the exact type."""
    import inspect

    from ddim_cold_torch.serve import errors

    findings = []
    rel = "ddim_cold_torch/serve/errors.py"
    table = errors._wire_types()
    for name, obj in vars(errors).items():
        if not (inspect.isclass(obj) and issubclass(obj, BaseException)):
            continue
        if obj.__module__ != errors.__name__:
            continue
        if name not in table:
            findings.append(Finding(
                "GRAFT-R002", rel, f"unregistered:{name}", 0,
                f"exception class {name} is defined in serve/errors.py "
                "but missing from _wire_types() — it cannot round-trip "
                "the RPC boundary as itself"))
    for name, cls in table.items():
        try:
            decoded = errors.decode_exception(
                errors.encode_exception(cls("probe")))
        except Exception as exc:  # noqa: BLE001 — the codec itself failing
            # IS the finding; anything it raises is the evidence
            findings.append(Finding(
                "GRAFT-R002", rel, f"codec:{name}", 0,
                f"encode/decode of {name} raised {type(exc).__name__}: "
                f"{exc}"))
            continue
        if type(decoded) is not cls:
            findings.append(Finding(
                "GRAFT-R002", rel, f"roundtrip:{name}", 0,
                f"{name} decodes as {type(decoded).__name__} — the wire "
                "codec loses the type"))
    return findings


# ---------------------------------------------------------------------------
# R003 — rid-lifecycle ordering
# ---------------------------------------------------------------------------

def _check_rid_ordering(tree: ast.AST, rel: str) -> list:
    """The rid-after-send race as a rule: in any function that sends a
    ``"submit"`` frame, the ticket-table registration (``...tickets[rid] =
    ticket``) must appear — and appear BEFORE the send. A done event from
    a fast replica races the submit response; registration-after-send
    loses that race and blocks ``result()`` forever."""
    findings = []
    for qual, fn in _functions(tree):
        submit_line = None
        register_line = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and _call_name(node) in ("_call", "_send", "call",
                                             "send_frame") \
                    and node.args and _str_const(node.args[0]) == "submit":
                if submit_line is None or node.lineno < submit_line:
                    submit_line = node.lineno
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript) \
                            and "tickets" in _dotted(target.value):
                        if register_line is None \
                                or node.lineno < register_line:
                            register_line = node.lineno
        if submit_line is None:
            continue
        if register_line is None:
            findings.append(Finding(
                "GRAFT-R003", rel, qual, submit_line,
                f"{qual} sends a 'submit' frame but never registers a "
                "ticket — a pushed done event has nothing to resolve"))
        elif register_line > submit_line:
            findings.append(Finding(
                "GRAFT-R003", rel, qual, register_line,
                f"{qual} registers its ticket at line {register_line}, "
                f"AFTER the submit frame leaves at line {submit_line} — "
                "a done event racing the response finds no ticket (the "
                "rid-after-send race)"))
    return findings


# ---------------------------------------------------------------------------
# R004 — bounded-read discipline
# ---------------------------------------------------------------------------

def _mentions_max_frame(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for side in (node.left, *node.comparators):
                if "MAX_FRAME_BYTES" in _dotted(side):
                    return True
    return False


def _check_bounded_reads(tree: ast.AST, rel: str) -> list:
    findings = []
    for qual, fn in _functions(tree):
        unpacks_len = False
        recv_lines = []          # calls whose name mentions recv
        raw_recv = []            # socket-level .recv(...) calls
        sendall_line = None
        timeout_none = []        # settimeout(None) statements
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "unpack" and node.args \
                    and _str_const(node.args[0]) == ">I":
                unpacks_len = True
            if "recv" in name:
                recv_lines.append(node.lineno)
                if name == "recv":
                    raw_recv.append(node)
            if name == "sendall":
                sendall_line = node.lineno
            if name == "settimeout" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value is None:
                timeout_none.append(node.lineno)
        guarded = _mentions_max_frame(fn)
        # (a) a length prefix feeding a read must be limit-checked first
        if unpacks_len and recv_lines and not guarded:
            findings.append(Finding(
                "GRAFT-R004", rel, f"{qual}:unchecked-length",
                min(recv_lines),
                f"{qual} unpacks a frame length and reads from it without "
                "checking MAX_FRAME_BYTES — a corrupt prefix becomes an "
                "arbitrary allocation"))
        # (b) frame sends re-check the limit on their own side
        if sendall_line is not None and not guarded:
            findings.append(Finding(
                "GRAFT-R004", rel, f"{qual}:unchecked-send", sendall_line,
                f"{qual} sends a frame without checking MAX_FRAME_BYTES — "
                "the peer's recv_frame would kill the connection instead "
                "of this side failing typed"))
        # (c) raw recv chunks are min()-capped
        for node in raw_recv:
            arg = node.args[0] if node.args else None
            capped = isinstance(arg, ast.Call) \
                and isinstance(arg.func, ast.Name) and arg.func.id == "min"
            if not capped:
                findings.append(Finding(
                    "GRAFT-R004", rel, f"{qual}:uncapped-recv",
                    node.lineno,
                    f"{qual} calls recv() without a min()-capped chunk "
                    "size — one call may allocate the whole (attacker-"
                    "chosen) length"))
        # (d) deadline-free sockets only after the validated read — the
        # unbounded-hello shape
        for lineno in timeout_none:
            if recv_lines and lineno < min(recv_lines):
                findings.append(Finding(
                    "GRAFT-R004", rel, f"{qual}:unbounded-read", lineno,
                    f"{qual} drops the socket deadline (settimeout(None)) "
                    "BEFORE its first read — a wedged peer blocks this "
                    "thread forever (the unbounded-hello shape)"))
    return findings


# ---------------------------------------------------------------------------
# R005 — fault-site coverage
# ---------------------------------------------------------------------------

def _check_fault_sites(tree: ast.AST, rel: str) -> list:
    """The wire chaos sites must actually fire on the paths they claim:
    a module with a frame-send choke point (``_send``) fires the rpc.*
    pair; a module with a server ``handle`` fires the replica.* pair."""
    findings = []
    fired = _fired_sites(tree)
    has_send = any(q.endswith("._send") or q == "_send"
                   for q, _ in _functions(tree))
    has_handle = any(q.endswith(".handle") for q, _ in _functions(tree))
    if has_send:
        for site in ("rpc.drop", "rpc.latency"):
            if site not in fired:
                findings.append(Finding(
                    "GRAFT-R005", rel, site, 1,
                    f"client frame-send path never fires {site!r} — the "
                    "chaos schedule cannot break this wire"))
    if has_handle:
        for site in ("replica.kill", "replica.hang"):
            if site not in fired:
                findings.append(Finding(
                    "GRAFT-R005", rel, site, 1,
                    f"server dispatch path never fires {site!r} — kill/"
                    "hang chaos cannot target this replica's work"))
    return findings


def _check_site_registration() -> list:
    from ddim_cold_torch.serve import remote, replica_main
    from ddim_cold_torch.utils import faults

    findings = []
    for site in WIRE_FAULT_SITES:
        if site not in faults.SITES:
            findings.append(Finding(
                "GRAFT-R005", "ddim_cold_torch/utils/faults.py", site, 0,
                f"wire chaos site {site!r} is not registered in "
                "faults.SITES — specs naming it would silently no-op"))
    for method in replica_main.ReplicaServer.WORK_METHODS:
        if method not in replica_main.SERVER_METHODS:
            findings.append(Finding(
                "GRAFT-R005", "ddim_cold_torch/serve/replica_main.py",
                f"work-method:{method}", 0,
                f"WORK_METHODS entry {method!r} is not a served RPC "
                "method — its kill/hang coverage is dead"))
    del remote  # imported for symmetry with R001's table checks
    return findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, rel: str, wire_names: frozenset | None = None
                ) -> list:
    """All AST-half R-rules over one module source (fixtures use this)."""
    tree = ast.parse(source)
    if wire_names is None:
        wire_names = _wire_type_names()
    findings = []
    findings += _check_frame_tables(tree, rel)
    findings += _check_raise_types(tree, rel, wire_names)
    findings += _check_rid_ordering(tree, rel)
    findings += _check_bounded_reads(tree, rel)
    findings += _check_fault_sites(tree, rel)
    return findings


def _table_parity() -> list:
    """R001 import half: the two sides' literal frame tables agree."""
    from ddim_cold_torch.serve import remote, replica_main

    findings = []
    client = set(remote.CLIENT_METHODS)
    server = set(replica_main.SERVER_METHODS)
    for method in sorted(client - server):
        findings.append(Finding(
            "GRAFT-R001", "ddim_cold_torch/serve/replica_main.py",
            f"unhandled-method:{method}", 0,
            f"client sends {method!r} but the server has no handler"))
    for method in sorted(server - client):
        findings.append(Finding(
            "GRAFT-R001", "ddim_cold_torch/serve/remote.py",
            f"unreachable-method:{method}", 0,
            f"server handles {method!r} but no client path sends it"))
    arms = set(remote.CLIENT_EVENT_ARMS)
    for event in sorted(set(replica_main.SERVER_EVENTS) - arms):
        findings.append(Finding(
            "GRAFT-R001", "ddim_cold_torch/serve/remote.py",
            f"undispatched-event:{event}", 0,
            f"server pushes {event!r} but the client reader has no "
            "dispatch arm — the event would be dropped on the floor"))
    return findings


def run_protocol_checks(root: str | None = None) -> list:
    """The full R-layer: AST over the protocol modules + the import-time
    parity/round-trip/registration checks."""
    if root is None:
        from ddim_cold_torch.analysis.cli import repo_root

        root = repo_root()
    wire_names = _wire_type_names()
    findings = []
    for rel in PROTOCOL_MODULES:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            findings += lint_source(f.read(), rel, wire_names)
    findings += _table_parity()
    findings += _check_health_parity(root)
    findings += _check_wire_roundtrip()
    findings += _check_site_registration()
    return findings
