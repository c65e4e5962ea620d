"""GRAFT-T001–T005 — lockset/lock-order analysis of the threaded host layer.

Counterpart of ``ddim_cold_tpu/analysis/thread_checks.py`` over the port's
modules. The serving stack's host side (engine/router/fleet/batching/obs/
watchdog/faults), the kernel loader and the kernels' launch counters are
lock-based: worker threads, a control loop, done-callbacks and a
watchdog all touch shared state. This pass proves the locking discipline
statically, from two in-code annotation grammars plus a declared hierarchy:

``# guarded-by: <lock>`` — written on the attribute's ``__init__`` (or
module-level) assignment, declares which lock protects the attribute. Every
write to the attribute outside ``__init__`` must then hold that lock
(**T001**), and lazy check-then-set must re-check under it (**T005**).
Un-annotated attributes are not checked: thread-confined state (the engine
run loop's program registry, the router control loop's bookkeeping) stays
annotation-free with a comment saying whose thread owns it.

``# requires: <lock>`` — written on a ``def`` line, declares a helper that
asserts nothing itself because its callers hold the lock. The analyzer
seeds the helper's lockset with it AND verifies every same-class call site
actually holds it.

The declared lock hierarchy (**T002**) is rank-based — a lock may only be
taken while holding strictly lower-ranked locks::

    router._lock(0) < fleet factory lock(5) < engine/fleet._lock(10)
      < engine._init_lock(15) < batching Ticket(20)
      < obs/watchdog/faults locks(30) < kernel build locks(40)
      < launch counter locks(50)

A lock may also live in a dict of locks (``_locks = {name: Lock() ...}``,
taken as ``with _locks[name]:``): the table is one lock for the analysis,
and ``# guarded-by: _locks[name]`` names it.

**T003** bans resolving tickets or firing user callbacks while holding any
lock (the callback re-enters the serving layer: router's done-callback
takes the router lock), and **T004** bans waiting on one synchronizer while
holding a different lock the notifier may need.

Pure-AST: no imports of the analyzed modules, sub-second over the
whole host layer.
"""

from __future__ import annotations

import ast
import os
import re

from ddim_cold_torch.analysis.findings import Finding

#: the threaded host modules this pass covers (repo-relative): JAX's ten,
#: and the port's kernel loader and the two modules whose kernel launch
#: counters are bumped from the fleet's replica threads
HOST_THREADED_MODULES = (
    "ddim_cold_torch/serve/batching.py",
    "ddim_cold_torch/serve/engine.py",
    "ddim_cold_torch/serve/fleet.py",
    "ddim_cold_torch/serve/router.py",
    "ddim_cold_torch/serve/remote.py",
    "ddim_cold_torch/serve/autoscale.py",
    "ddim_cold_torch/obs/metrics.py",
    "ddim_cold_torch/obs/spans.py",
    "ddim_cold_torch/utils/watchdog.py",
    "ddim_cold_torch/utils/faults.py",
    "ddim_cold_torch/ops/_build.py",
    "ddim_cold_torch/ops/flash_attention.py",
    "ddim_cold_torch/ops/quant.py",
)

#: declared lock hierarchy: ``<module>::<lock attr>`` → rank. Acquiring a
#: lock is legal only while every held lock has a strictly LOWER rank
#: (same-lock re-entry is legal for RLocks only). Locks not listed rank as
#: None and are exempt from T002 (but still count for T001/T003/T004).
LOCK_RANKS = {
    "ddim_cold_torch/serve/router.py::_lock": 0,
    # the factory of replicas across ranks: each lifecycle step of
    # a replica (spawn, warm, close) runs under it on rank 0, so that group
    # creation and destruction run in one order on every rank; the step
    # itself takes the replica's and its engine's locks (10) inside it,
    # and the router calls the factory without holding its own lock
    "ddim_cold_torch/serve/fleet.py::lock": 5,
    "ddim_cold_torch/serve/engine.py::_lock": 10,
    "ddim_cold_torch/serve/fleet.py::_lock": 10,
    # the engine's start draws: a request's lazily drawn start is
    # made once, under this lock, on the assembly or the dispatching
    # thread; the admission state (_lock) may be held around it, never
    # taken inside it
    "ddim_cold_torch/serve/engine.py::_init_lock": 15,
    # remote handle: registry lock, then the send lock (framed writes
    # serialize under it while the registry stays free for the reader)
    "ddim_cold_torch/serve/remote.py::_lock": 10,
    "ddim_cold_torch/serve/remote.py::_send_lock": 11,
    # the autoscaler only guards its own thread handle; router calls
    # (rank 0) always happen lock-free from the tick path
    "ddim_cold_torch/serve/autoscale.py::_lock": 10,
    "ddim_cold_torch/serve/batching.py::_lock": 20,
    "ddim_cold_torch/serve/batching.py::_pcond": 21,
    "ddim_cold_torch/obs/metrics.py::_lock": 30,
    "ddim_cold_torch/obs/spans.py::_lock": 30,
    "ddim_cold_torch/utils/watchdog.py::_lock": 30,
    "ddim_cold_torch/utils/faults.py::_lock": 30,
    # one lock per kernel library (ops/_build.py): held while nvcc builds
    # and ctypes loads that library, on whichever thread first launches
    # it (a replica's worker, the engine's warmup); it takes no other lock
    "ddim_cold_torch/ops/_build.py::_locks": 40,
    # the launch counters: a leaf taken for one increment, from any thread
    # that launches a kernel, whatever it holds
    "ddim_cold_torch/ops/flash_attention.py::_LAUNCH_LOCK": 50,
    "ddim_cold_torch/ops/quant.py::_LAUNCH_LOCK": 50,
}

#: cross-object callee summaries: a method name every module recognizes →
#: the minimum lock rank that callee acquires internally. Interprocedural
#: edges the AST cannot type-resolve (``req.ticket._fail`` from the engine,
#: ``self.metrics.inc`` from anywhere) are ranked by name — the names are
#: unique enough across the host layer that this is exact in practice.
XCALL_RANKS = {
    # batching.Ticket surface (rank 20)
    "_deliver": 20, "_fail": 20, "_preview": 20, "add_done_callback": 20,
    "add_preview_callback": 20,
    # obs/metrics + obs/spans + watchdog + faults surfaces (rank 30)
    "inc": 30, "gauge": 30, "observe": 30, "mark": 30, "fire": 30,
    # the kernel loader (40) and the launch counters (50)
    "load_library": 40, "count_launch": 50,
}

#: calls that BLOCK on another thread's progress — banned under any lock
#: (T004) unless passed a literal 0 timeout: ``exception(0)`` polls.
BLOCKING_CALLS = ("wait", "join", "result", "exception", "previews")

#: ticket-resolution / user-callback surfaces — banned under any lock
#: (T003): the callee runs arbitrary observer code (the router's
#: done-callback takes the router lock on the calling thread).
RESOLUTION_CALLS = ("_fail", "_deliver", "_resolve", "_run_callback",
                    "add_done_callback", "add_preview_callback")
CALLBACK_NAMES = ("fn", "cb", "callback", "on_abort", "hook")

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_REQUIRES_RE = re.compile(r"#\s*requires:\s*([A-Za-z_]\w*)")
_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock",
               "Condition": "condition", "Event": "event"}
_MUTATORS = frozenset({
    "append", "extend", "add", "remove", "discard", "pop", "popitem",
    "popleft", "appendleft", "clear", "update", "setdefault", "insert",
    "sort",
})


def _ctor_kind(node) -> str | None:
    """``threading.Lock()`` / ``Condition()`` → its lock kind, and a dict
    of them (``{k: threading.Lock() for k in ...}``) → the same kind (a
    lock table, one lock for the analysis); else None."""
    if isinstance(node, ast.DictComp):
        return _ctor_kind(node.value)
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    return _LOCK_CTORS.get(name)


def _own_target(node, selfname) -> str | None:
    """``self.X`` (class scope, selfname='self') or bare ``X`` (module
    scope, selfname=None) → the owned attribute/global name, else None."""
    if selfname is None:
        return node.id if isinstance(node, ast.Name) else None
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == selfname):
        return node.attr
    return None


def _comment_tag(lines, node, rx) -> str | None:
    ln = getattr(node, "lineno", 0)
    if 0 < ln <= len(lines):
        m = rx.search(lines[ln - 1])
        if m:
            return m.group(1)
    return None


class _Scope:
    """One analyzed lock domain: a class body, or the module top level
    (faults.py keeps its registry in module globals)."""

    def __init__(self, name: str, selfname: str | None):
        self.name = name            # "Ticket" / "<module>"
        self.selfname = selfname    # "self" / None
        self.locks: dict = {}       # lock attr -> kind
        self.guards: dict = {}      # data attr -> guarding lock attr
        self.funcs: dict = {}       # fn name -> ast.FunctionDef
        self.requires: dict = {}    # fn name -> lock the caller must hold


def _collect_scopes(tree, lines) -> list[_Scope]:
    scopes = []
    mod = _Scope("<module>", None)
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            cls = _Scope(stmt.name, "self")
            for item in stmt.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cls.funcs[item.name] = item
                    req = _comment_tag(lines, item, _REQUIRES_RE)
                    if req:
                        cls.requires[item.name] = req
                    for sub in ast.walk(item):
                        if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                            _note_decl(cls, sub, lines)
            scopes.append(cls)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.funcs[stmt.name] = stmt
            req = _comment_tag(lines, stmt, _REQUIRES_RE)
            if req:
                mod.requires[stmt.name] = req
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            _note_decl(mod, stmt, lines)
    scopes.append(mod)
    return scopes


def _note_decl(scope: _Scope, stmt, lines) -> None:
    """Record lock constructions and ``# guarded-by:`` declarations from one
    assignment (class scopes read them out of method bodies — __init__)."""
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    value = stmt.value
    for tgt in targets:
        attr = _own_target(tgt, scope.selfname)
        if attr is None:
            continue
        kind = _ctor_kind(value)
        if kind is not None:
            scope.locks.setdefault(attr, kind)
            continue
        guard = _comment_tag(lines, stmt, _GUARD_RE)
        if guard:
            scope.guards.setdefault(attr, guard)


# ---------------------------------------------------------------------------
# per-function lockset walk
# ---------------------------------------------------------------------------

class _FnAnalysis:
    """Shared state for one function walk (class method or module fn)."""

    def __init__(self, checker: "_Checker", fname: str, entry_locked: tuple):
        self.c = checker
        self.fname = fname
        self.subject_fn = (f"{checker.scope.name}.{fname}"
                          if checker.scope.selfname else fname)
        self.entry_locked = entry_locked


class _Checker:
    def __init__(self, scope: _Scope, rel: str, lines, ranks: dict,
                 findings: list):
        self.scope = scope
        self.rel = rel
        self.lines = lines
        self.ranks = ranks          # lock attr -> rank (may miss entries)
        self.findings = findings
        self._summaries: dict = {}  # fn name -> frozenset of acquired locks

    # -- summaries: which own locks does fn (transitively) acquire? --------
    def summary(self, fname: str, _stack=()) -> frozenset:
        if fname in self._summaries:
            return self._summaries[fname]
        if fname in _stack or fname not in self.scope.funcs:
            return frozenset()
        acquired = set()
        for node in ast.walk(self.scope.funcs[fname]):
            if isinstance(node, ast.withitem):
                lk = self._lock_of(node.context_expr)
                if lk:
                    acquired.add(lk)
            elif isinstance(node, ast.Call):
                callee = self._self_callee(node)
                if callee:
                    acquired |= self.summary(callee, _stack + (fname,))
        out = frozenset(acquired)
        self._summaries[fname] = out
        return out

    def _lock_of(self, expr) -> str | None:
        if isinstance(expr, ast.Subscript):  # one lock of a lock table
            expr = expr.value
        attr = _own_target(expr, self.scope.selfname)
        if attr is not None and attr in self.scope.locks:
            if self.scope.locks[attr] != "event":  # events aren't lockable
                return attr
        return None

    def _self_callee(self, call) -> str | None:
        attr = _own_target(call.func, self.scope.selfname)
        return attr if attr in self.scope.funcs else None

    def emit(self, rule, node, subject, msg) -> None:
        self.findings.append(Finding(
            rule, self.rel, subject, getattr(node, "lineno", 0), msg))

    # -- the walk ----------------------------------------------------------
    def check_all(self) -> None:
        for fname, fn in self.scope.funcs.items():
            if fname == "__init__":
                continue
            held = frozenset({self.scope.requires[fname]}
                             if fname in self.scope.requires else ())
            self._walk_body(fn.body, held, fname)

    # -- statement walk, threading the lockset -----------------------------
    def _walk_body(self, stmts, held: frozenset, fname: str) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt, held, fname)

    def _walk_stmt(self, stmt, held, fname) -> None:
        if isinstance(stmt, ast.With):
            inner = set(held)
            for item in stmt.items:
                self._scan_exprs([item.context_expr], held, fname)
                lk = self._lock_of(item.context_expr)
                if lk:
                    self._check_acquire(lk, held, stmt, fname)
                    inner.add(lk)
            self._walk_body(stmt.body, frozenset(inner), fname)
        elif isinstance(stmt, ast.If):
            self._scan_exprs([stmt.test], held, fname)
            self._check_lazy_init(stmt, held, fname)
            self._walk_body(stmt.body, held, fname)
            self._walk_body(stmt.orelse, held, fname)
        elif isinstance(stmt, (ast.For, ast.While)):
            head = [stmt.iter] if isinstance(stmt, ast.For) else [stmt.test]
            self._scan_exprs(head, held, fname)
            self._walk_body(stmt.body, held, fname)
            self._walk_body(stmt.orelse, held, fname)
        elif isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, held, fname)
            for h in stmt.handlers:
                self._walk_body(h.body, held, fname)
            self._walk_body(stmt.orelse, held, fname)
            self._walk_body(stmt.finalbody, held, fname)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs LATER on whatever thread calls it: analyze
            # its body as a lock-free callback context, not under `held`
            self._walk_body(stmt.body, frozenset(), f"{fname}.{stmt.name}")
        else:
            self._check_writes(stmt, held, fname)
            self._scan_exprs([stmt], held, fname)

    # -- rule bodies -------------------------------------------------------
    def _check_acquire(self, lock: str, held, node, fname) -> None:
        if lock in held and self.scope.locks.get(lock) not in (
                "rlock", "condition"):
            self.emit("GRAFT-T002", node,
                      f"{self._subj(fname)}:{lock}>{lock}",
                      f"non-reentrant lock {lock!r} re-acquired while "
                      "already held — self-deadlock")
            return
        rank = self.ranks.get(lock)
        if rank is None:
            return
        for h in held:
            if h == lock:
                continue
            hrank = self.ranks.get(h)
            if hrank is not None and hrank >= rank:
                self.emit("GRAFT-T002", node,
                          f"{self._subj(fname)}:{h}>{lock}",
                          f"acquires {lock!r} (rank {rank}) while holding "
                          f"{h!r} (rank {hrank}) — inverts the declared "
                          "lock hierarchy")

    def _check_writes(self, stmt, held, fname) -> None:
        for attr, node in self._stored_attrs(stmt):
            guard = self.scope.guards.get(attr)
            if guard and guard not in held:
                self.emit("GRAFT-T001", node,
                          f"{self._subj(fname)}:{attr}",
                          f"writes {attr!r} (guarded-by: {guard}) without "
                          f"holding {guard!r}")

    def _stored_attrs(self, stmt):
        """(attr, node) pairs this simple statement writes: assignment /
        augassign / del / subscript store / mutator-method calls."""
        out = []
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for tgt in targets:
                out += self._store_targets(tgt)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                out += self._store_targets(tgt)
        for call in self._calls_in(stmt):
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _MUTATORS:
                attr = _own_target(call.func.value, self.scope.selfname)
                if attr is not None:
                    out.append((attr, call))
        return out

    def _store_targets(self, tgt):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            out = []
            for el in tgt.elts:
                out += self._store_targets(el)
            return out
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        attr = _own_target(tgt, self.scope.selfname)
        return [(attr, tgt)] if attr is not None else []

    def _check_lazy_init(self, stmt: ast.If, held, fname) -> None:
        attr = self._lazy_tested_attr(stmt.test)
        if attr is None:
            return
        guard = self.scope.guards.get(attr)
        if guard is None or guard in held:
            return
        writes = any(a == attr
                     for sub in ast.walk(stmt)
                     for a, _ in self._stored_attrs(sub))
        if not writes:
            return
        # double-checked init is fine: a `with <guard>:` inside the body
        # that re-tests the same attribute before the write
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.With) and any(
                    self._lock_of(i.context_expr) == guard
                    for i in sub.items):
                if any(isinstance(s2, ast.If)
                       and self._lazy_tested_attr(s2.test) == attr
                       for s2 in ast.walk(sub)):
                    return
        self.emit("GRAFT-T005", stmt,
                  f"{self._subj(fname)}:{attr}",
                  f"lazy check-then-set of {attr!r} (guarded-by: {guard}) "
                  f"outside the lock and without a re-check under it")

    def _lazy_tested_attr(self, test) -> str | None:
        """``self.X is None`` / ``not self.X`` / ``k not in self.X``."""
        if (isinstance(test, ast.Compare) and len(test.ops) == 1):
            if isinstance(test.ops[0], ast.Is) and isinstance(
                    test.comparators[0], ast.Constant) \
                    and test.comparators[0].value is None:
                return _own_target(test.left, self.scope.selfname)
            if isinstance(test.ops[0], ast.NotIn):
                return _own_target(test.comparators[0], self.scope.selfname)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return _own_target(test.operand, self.scope.selfname)
        return None

    # -- expression-level checks (calls) -----------------------------------
    def _calls_in(self, node):
        """Call nodes reachable without entering deferred code (lambdas)."""
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    def _scan_exprs(self, nodes, held, fname) -> None:
        for node in nodes:
            for call in self._calls_in(node):
                self._check_call(call, held, fname)

    def _check_call(self, call, held, fname) -> None:
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name is None:
            return
        subj = self._subj(fname)
        # T003: resolution/callback surfaces under any lock
        if held and (name in RESOLUTION_CALLS or (
                isinstance(fn, ast.Name) and name in CALLBACK_NAMES) or (
                isinstance(fn, ast.Attribute) and name in CALLBACK_NAMES)):
            self.emit("GRAFT-T003", call, f"{subj}:{name}",
                      f"invokes {name!r} while holding "
                      f"{sorted(held)} — callbacks must fire outside locks")
            return
        # T004: blocking waits under a lock the notifier may need.
        # Condition.wait while holding ONLY that condition is the one legal
        # form (wait atomically releases it).
        if held and name in BLOCKING_CALLS and not self._poll_timeout(call):
            owner = (_own_target(fn.value, self.scope.selfname)
                     if isinstance(fn, ast.Attribute) else None)
            cond_self_wait = (
                name == "wait" and owner is not None
                and self.scope.locks.get(owner) == "condition"
                and held == frozenset({owner}))
            if not cond_self_wait:
                self.emit("GRAFT-T004", call, f"{subj}:{name}",
                          f"blocking {name!r} while holding "
                          f"{sorted(held)} — the notifier may need the "
                          "lock (wedge)")
            return
        # T002 interprocedural: same-class callees via summaries
        callee = self._self_callee(call)
        if callee:
            need = self.scope.requires.get(callee)
            if need and need not in held:
                self.emit("GRAFT-T001", call, f"{subj}:{callee}",
                          f"calls {callee!r} (# requires: {need}) without "
                          f"holding {need!r}")
            if held:
                for lk in self.summary(callee):
                    if lk not in held:  # re-entry checked at its own site
                        self._check_acquire(lk, held, call, fname)
            return
        # T002 cross-object: name-ranked callee summaries
        if held and name in XCALL_RANKS:
            rank = XCALL_RANKS[name]
            for h in held:
                hrank = self.ranks.get(h)
                if hrank is not None and hrank >= rank:
                    self.emit("GRAFT-T002", call, f"{subj}:{h}>{name}()",
                              f"calls {name!r} (acquires rank {rank}) while "
                              f"holding {h!r} (rank {hrank}) — inverts the "
                              "declared lock hierarchy")

    @staticmethod
    def _poll_timeout(call) -> bool:
        """True for a literal-0 timeout — a poll, not a blocking wait."""
        cands = list(call.args[:1]) + [kw.value for kw in call.keywords
                                       if kw.arg == "timeout"]
        return any(isinstance(a, ast.Constant) and a.value == 0
                   for a in cands)

    def _subj(self, fname: str) -> str:
        return (f"{self.scope.name}.{fname}" if self.scope.selfname
                else fname)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _ranks_for(rel: str) -> dict:
    pref = f"{rel}::"
    return {k[len(pref):]: v for k, v in LOCK_RANKS.items()
            if k.startswith(pref)}


def lint_source(source: str, rel: str,
                lock_ranks: dict | None = None) -> list[Finding]:
    """All T-rule findings for one module's source. ``lock_ranks`` maps the
    module's lock attributes to hierarchy ranks; by default the declared
    :data:`LOCK_RANKS` slice for ``rel`` (tests pass their own)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    ranks = _ranks_for(rel) if lock_ranks is None else dict(lock_ranks)
    findings: list[Finding] = []
    for scope in _collect_scopes(tree, lines):
        _Checker(scope, rel, lines, ranks, findings).check_all()
    return findings


def lint_tree(root: str) -> list[Finding]:
    """T001–T005 over every module in :data:`HOST_THREADED_MODULES`."""
    findings: list[Finding] = []
    for rel in HOST_THREADED_MODULES:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            findings += lint_source(f.read(), rel)
    return findings


def run_thread_checks(root: str) -> list[Finding]:
    return lint_tree(root)
