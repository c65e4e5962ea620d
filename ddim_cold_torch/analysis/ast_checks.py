"""AST lint — the repo-specific host-code rules (GRAFT-A001..A005).

Counterpart of ``ddim_cold_tpu/analysis/ast_checks.py`` over
``ddim_cold_torch/``. Pure ``ast`` walking, no imports of the checked
modules, so the lint runs on any tree state (including one that currently
fails to import). The dynamic inputs are the registered fault-site tuple
(``ddim_cold_torch.utils.faults.SITES``) and the metric registry
(``ddim_cold_torch.obs.metrics.METRICS``), read by :func:`lint_tree`.

Rule A001 keeps JAX's meaning, "nondeterminism in code that runs on the
device path", with the port's device path in place of JAX's traced code. A
function counts as on the device path when it is

* the ``forward``/``backward`` of a ``torch.autograd.Function`` subclass,
  or the ``forward`` of an ``nn.Module`` subclass (a class whose base is
  named ``Function`` or ``Module``, or a same-file class that is one),
* decorated with or passed as the function to ``torch.compile``,
  ``torch.utils.checkpoint.checkpoint``, ``torch.func.vmap`` / ``grad`` /
  ``grad_and_value`` (``functools.partial`` wrappers unwrapped), or
* defined inside, or called from, such a function: by name, or as
  ``self.<method>`` of the same class (transitive closure over the file).

In such a function the wall clock, the stdlib RNG and numpy's RNG are
findings, as in JAX; and so is a torch RNG draw (``torch.rand``/``randn``/
``randint``/``randperm``/``normal``/``bernoulli``/``multinomial``, or a
tensor's in-place ``normal_``/``uniform_``/``bernoulli_``/…) without an
explicit ``generator=``: the port's counterpart of JAX's PRNG-key contract
is that every draw names its ``torch.Generator``, so a replay (and a rank
of a mesh) draws the same numbers.

Rule A004 reads ``torch`` where JAX read ``jax``/``jax.numpy``: a host-only
module (:data:`HOST_ONLY_MODULES`) may not touch torch anywhere — a torch
attribute there is a device import on a path that must stay on host types.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional, Sequence

from ddim_cold_torch.analysis.findings import Finding

#: wrapper callables whose function-typed arguments run on the device path.
#: name → indices of the function args (None = "all positional args").
_TRACE_ARGS = {
    "compile": (0,), "checkpoint": (0,), "vmap": (0,), "grad": (0,),
    "grad_and_value": (0,),
}

#: base-class leaf names whose methods run on the device path (rule A001),
#: and which methods
_DEVICE_CLASSES = {"Function": ("forward", "backward"), "Module": ("forward",)}

#: modules whose use inside traced code is nondeterministic (rule A001).
#: maps canonical module name → reason fragment.
_NONDET_MODULES = {
    "time": "wall clock",
    "random": "stdlib RNG (unseeded per-trace)",
    "numpy.random": "host RNG outside the explicit-generator contract",
}

#: torch RNG draws that must name their ``generator=`` (rule A001): module
#: functions, and tensor methods (any receiver)
_TORCH_RNG = ("rand", "randn", "randint", "randperm", "normal", "bernoulli",
              "multinomial", "poisson")
_TENSOR_RNG = ("normal_", "uniform_", "bernoulli_", "random_", "exponential_",
               "geometric_", "log_normal_", "cauchy_")

#: modules that imply device interaction in host-only files (rule A004)
_DEVICE_MODULES = ("torch",)

#: modules that must never touch torch (repo-relative paths with '/'
#: separators): JAX's eleven — row planning (batching), fleet routing
#: (placement decisions read health dicts), the obs layer (it rides the
#: router's host threads; attribution and the trend gate parse artifacts on
#: machines that never saw the device), and the process boundary (the RPC
#: handle, the autoscaler and the replica server, which boots to its hello
#: without a device: engine construction hides behind serve/backend.py) —
#: and the host-only modules the port's hygiene test adds
#: (``tests/test_torch_port_hygiene.py`` HOST_ONLY): the fault and
#: watchdog utilities and the error codec the router imports, the FLOP and
#: record helpers the reports read, and the native data tier's C++ build.
#: ``serve/fleet.py`` is not here: the port's fleet also runs replicas
#: across ranks (``local_factory(mesh=)``), whose control group is a
#: ``torch.distributed`` group the fleet creates, imported where used.
HOST_ONLY_MODULES = ("ddim_cold_torch/serve/batching.py",
                     "ddim_cold_torch/serve/router.py",
                     "ddim_cold_torch/obs/metrics.py",
                     "ddim_cold_torch/obs/spans.py",
                     "ddim_cold_torch/obs/device.py",
                     "ddim_cold_torch/obs/attrib.py",
                     "ddim_cold_torch/obs/trend.py",
                     "ddim_cold_torch/serve/remote.py",
                     "ddim_cold_torch/serve/autoscale.py",
                     "ddim_cold_torch/serve/replica_main.py",
                     "ddim_cold_torch/utils/faults.py",
                     "ddim_cold_torch/utils/watchdog.py",
                     "ddim_cold_torch/serve/errors.py",
                     "ddim_cold_torch/utils/flops.py",
                     "ddim_cold_torch/utils/record.py",
                     "ddim_cold_torch/data/native.py")

#: obs.metrics emit methods (rule A005) → the registry kind they imply
_METRIC_EMITS = ("inc", "gauge", "observe")


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute/name chain → 'a.b.c' (None for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _import_aliases(tree: ast.AST) -> dict[str, str]:
    """Local name → canonical dotted module/object it binds."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _canonical(dotted: str, aliases: dict[str, str]) -> str:
    head, _, rest = dotted.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """``partial(f, ...)`` / ``functools.partial(f, ...)`` → ``f``."""
    if (isinstance(node, ast.Call) and node.args
            and (_dotted(node.func) or "").split(".")[-1] == "partial"):
        return _unwrap_partial(node.args[0])
    return node


class _FnIndex(ast.NodeVisitor):
    """Collect every function def (with parent chain) and call site."""

    def __init__(self):
        self.defs: list[ast.AST] = []
        self.parents: dict[ast.AST, Optional[ast.AST]] = {}
        self._stack: list[ast.AST] = []

    def _visit_fn(self, node):
        self.defs.append(node)
        self.parents[node] = self._stack[-1] if self._stack else None
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn
    visit_Lambda = _visit_fn


def _device_class_methods(tree: ast.AST) -> set[ast.AST]:
    """The ``forward``/``backward`` defs of ``torch.autograd.Function`` and
    ``nn.Module`` subclasses (by base leaf name, or through a same-file
    class that is one)."""
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    kind: dict[str, str] = {}
    changed = True
    while changed:
        changed = False
        for cls in classes:
            if cls.name in kind:
                continue
            for base in cls.bases:
                leaf = (_dotted(base) or "").split(".")[-1]
                found = leaf if leaf in _DEVICE_CLASSES else kind.get(leaf)
                if found:
                    kind[cls.name] = found
                    changed = True
                    break
    out = set()
    for cls in classes:
        methods = _DEVICE_CLASSES.get(kind.get(cls.name, ""), ())
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name in methods:
                out.add(item)
    return out


def _traced_functions(tree: ast.AST) -> set[ast.AST]:
    """The device-path function set per the module docstring's rules."""
    idx = _FnIndex()
    idx.visit(tree)
    by_name: dict[str, list[ast.AST]] = {}
    for d in idx.defs:
        if not isinstance(d, ast.Lambda):
            by_name.setdefault(d.name, []).append(d)
    # methods by enclosing class, for `self.<method>(...)` calls
    methods: dict[ast.AST, dict[str, ast.AST]] = {}
    owner: dict[ast.AST, ast.AST] = {}
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            table = {}
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    table[item.name] = item
                    owner[item] = cls
            methods[cls] = table

    traced: set[ast.AST] = set(_device_class_methods(tree))

    def mark_name(name: Optional[str]):
        for d in by_name.get(name or "", []):
            traced.add(d)

    def fn_arg_names(call: ast.Call, which) -> Iterable[Optional[str]]:
        args = call.args if which is None else [
            call.args[i] for i in which if i < len(call.args)]
        for a in args:
            a = _unwrap_partial(a)
            if isinstance(a, ast.Name):
                yield a.id
            elif isinstance(a, (ast.List, ast.Tuple)):
                for el in a.elts:
                    el = _unwrap_partial(el)
                    if isinstance(el, ast.Name):
                        yield el.id

    for node in ast.walk(tree):
        # decorators: @torch.compile / @torch.compile(mode=...) /
        # @partial(torch.compile, ...)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = _unwrap_partial(dec) if isinstance(dec, ast.Call) \
                    else dec
                if isinstance(target, ast.Call):  # @torch.compile(...)
                    target = target.func if not target.args else target
                name = _dotted(target if not isinstance(target, ast.Call)
                               else target.func)
                if name and name.split(".")[-1] in _TRACE_ARGS:
                    traced.add(node)
                if (isinstance(dec, ast.Call)
                        and (_dotted(dec.func) or "").split(".")[-1]
                        == "partial" and dec.args):
                    inner = _dotted(dec.args[0])
                    if inner and inner.split(".")[-1] in _TRACE_ARGS:
                        traced.add(node)
        if not isinstance(node, ast.Call):
            continue
        func = _unwrap_partial(node.func) if isinstance(node.func, ast.Call) \
            else node.func
        name = _dotted(func)
        if not name:
            continue
        leaf = name.split(".")[-1]
        if leaf in _TRACE_ARGS:
            for fn_name in fn_arg_names(node, _TRACE_ARGS[leaf]):
                mark_name(fn_name)
        # `partial(torch.compile, ...)(fn)` — func is a partial Call:
        if isinstance(node.func, ast.Call):
            inner = node.func
            if ((_dotted(inner.func) or "").split(".")[-1] == "partial"
                    and inner.args):
                wrapped = _dotted(inner.args[0])
                if wrapped and wrapped.split(".")[-1] in _TRACE_ARGS:
                    for a in node.args:
                        a = _unwrap_partial(a)
                        if isinstance(a, ast.Name):
                            mark_name(a.id)

    # transitive closure: defs nested in device-path fns, same-file
    # functions called by name, and same-class methods called on self
    changed = True
    while changed:
        changed = False
        for d in idx.defs:
            if d in traced:
                continue
            p = idx.parents.get(d)
            while p is not None:
                if p in traced:
                    traced.add(d)
                    changed = True
                    break
                p = idx.parents.get(p)
        for d in list(traced):
            table = methods.get(owner.get(d), {})
            for node in ast.walk(d):
                if not isinstance(node, ast.Call):
                    continue
                targets = []
                if isinstance(node.func, ast.Name):
                    targets = by_name.get(node.func.id, [])
                elif (isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id == "self"
                      and node.func.attr in table):
                    targets = [table[node.func.attr]]
                for target in targets:
                    if target not in traced:
                        traced.add(target)
                        changed = True
    return traced


def _enclosing_name(tree: ast.AST, lineno: int) -> str:
    """Name of the innermost def containing ``lineno`` (module scope → the
    file stem placeholder '<module>'). Used as the stable finding subject."""
    best, best_span = "<module>", None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= lineno <= end:
                span = end - node.lineno
                if best_span is None or span < best_span:
                    best, best_span = node.name, span
    return best


# ---------------------------------------------------------------------------
# per-rule checks (each takes a parsed file, returns findings)
# ---------------------------------------------------------------------------

def _rng_hit(node: ast.Call, canon: str) -> Optional[tuple[str, str]]:
    """(subject callee, reason) for a torch RNG draw without ``generator=``,
    else None."""
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    leaf = canon.rsplit(".", 1)[-1]
    if canon.startswith("torch.") and canon.count(".") == 1 \
            and leaf in _TORCH_RNG:
        return canon, "torch RNG draw without an explicit generator="
    if isinstance(node.func, ast.Attribute) and leaf in _TENSOR_RNG:
        return (f"<tensor>.{leaf}",
                "in-place torch RNG draw without an explicit generator=")
    return None


def _check_determinism(tree, rel: str, aliases) -> list[Finding]:
    out = []
    seen = set()
    for fn in _traced_functions(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if not name:
                continue
            canon = _canonical(name, aliases)
            mod = canon.rsplit(".", 1)[0] if "." in canon else canon
            hit = None
            for bad, why in _NONDET_MODULES.items():
                if mod == bad or mod.startswith(bad + "."):
                    hit = (canon, why)
            hit = hit or _rng_hit(node, canon)
            if hit and node.lineno not in seen:
                seen.add(node.lineno)
                fname = getattr(fn, "name", "<lambda>")
                out.append(Finding(
                    "GRAFT-A001", rel, f"{fname}:{hit[0]}", node.lineno,
                    f"`{name}()` inside device-path function `{fname}` — "
                    f"{hit[1]}; device-path code draws only from an "
                    "explicit torch.Generator"))
    return out


def _check_broad_except(tree, rel: str, lines: list[str]) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        names = []
        t = node.type
        for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
            names.append(_dotted(el) if el is not None else None)
        broad = any(n is None or (n or "").split(".")[-1]
                    in ("Exception", "BaseException") for n in names)
        if not broad:
            continue
        src = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        if "noqa: BLE001" in src:
            continue
        fn = _enclosing_name(tree, node.lineno)
        caught = "bare except" if node.type is None else \
            f"except {'/'.join(n or '?' for n in names)}"
        out.append(Finding(
            "GRAFT-A002", rel, f"{fn}:{caught}", node.lineno,
            f"{caught} without `# noqa: BLE001 — <why>` on the handler "
            "line; narrow the exception or justify the breadth"))
    return out


def _fire_calls(tree) -> list[tuple[ast.Call, object, object]]:
    """Every ``faults.fire(...)`` call → (node, site_arg, tag_arg)."""
    calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        if name.split(".")[-1] != "fire" or "." not in name:
            continue
        site = node.args[0] if node.args else None
        tag = node.args[1] if len(node.args) > 1 else None
        for kw in node.keywords:
            if kw.arg == "site":
                site = kw.value
            elif kw.arg == "tag":
                tag = kw.value
        calls.append((node, site, tag))
    return calls


def _check_fault_sites(tree, rel: str, sites: Sequence[str],
                       seen_pairs: dict) -> list[Finding]:
    out = []
    for node, site, tag in _fire_calls(tree):
        if not isinstance(site, ast.Constant) or not isinstance(site.value,
                                                                str):
            out.append(Finding(
                "GRAFT-A003", rel, "fire:<dynamic>", node.lineno,
                "faults.fire() site must be a string literal so the "
                "registry and the replay grammar can see it statically"))
            continue
        name = site.value
        if name not in sites:
            out.append(Finding(
                "GRAFT-A003", rel, f"fire:{name}", node.lineno,
                f"fault site {name!r} is not registered in "
                "utils/faults.SITES — specs targeting it would be rejected "
                "as typos"))
        tag_lit = (tag.value if isinstance(tag, ast.Constant)
                   and isinstance(tag.value, str) else None)
        if tag_lit is not None:
            pair = (name, tag_lit)
            if pair in seen_pairs:
                first = seen_pairs[pair]
                out.append(Finding(
                    "GRAFT-A003", rel, f"fire:{name}:{tag_lit}", node.lineno,
                    f"duplicate fire site ({name!r}, tag {tag_lit!r}) — "
                    f"first fired at {first}; replay cannot distinguish "
                    "the two call points"))
            else:
                seen_pairs[pair] = f"{rel}:{node.lineno}"
    return out


def _metric_calls(tree) -> list[tuple[ast.Call, object, object]]:
    """Every ``<scope>.inc/.gauge/.observe(...)`` emit → (node, name_arg,
    key_arg). Attribute calls only — a bare ``inc(...)`` is some other
    function, exactly as ``fire`` detection works in :func:`_fire_calls`."""
    calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        if name.split(".")[-1] not in _METRIC_EMITS or "." not in name:
            continue
        metric = node.args[0] if node.args else None
        key = None
        for kw in node.keywords:
            if kw.arg == "name":
                metric = kw.value
            elif kw.arg == "key":
                key = kw.value
        calls.append((node, metric, key))
    return calls


def _check_metric_sites(tree, rel: str, metric_names: Sequence[str],
                        seen_pairs: dict) -> list[Finding]:
    out = []
    for node, metric, key in _metric_calls(tree):
        if not isinstance(metric, ast.Constant) or not isinstance(
                metric.value, str):
            out.append(Finding(
                "GRAFT-A005", rel, "metric:<dynamic>", node.lineno,
                "obs.metrics emit (.inc/.gauge/.observe) must pass a "
                "string-literal metric name so the registry stays "
                "statically auditable"))
            continue
        name = metric.value
        if name not in metric_names:
            out.append(Finding(
                "GRAFT-A005", rel, f"metric:{name}", node.lineno,
                f"metric {name!r} is not registered in obs.metrics.METRICS "
                "— the registry would reject the emit at runtime"))
        key_lit = (key.value if isinstance(key, ast.Constant)
                   and isinstance(key.value, str) else None)
        if key is not None and key_lit is None:
            continue  # dynamic key= subdivides one site — uniqueness holds
        pair = (name, key_lit)
        if pair in seen_pairs:
            first = seen_pairs[pair]
            subj = f"metric:{name}" + (f":{key_lit}" if key_lit else "")
            out.append(Finding(
                "GRAFT-A005", rel, subj, node.lineno,
                f"duplicate emit site for metric ({name!r}, key "
                f"{key_lit!r}) — first emitted at {first}; give the second "
                "site a distinct literal key= (the A003 tag rule)"))
        else:
            seen_pairs[pair] = f"{rel}:{node.lineno}"
    return out


def _check_host_only(tree, rel: str, aliases) -> list[Finding]:
    out = []
    seen = set()
    for node in ast.walk(tree):
        name = _dotted(node) if isinstance(node, ast.Attribute) else None
        if not name or "." not in name:
            continue
        canon = _canonical(name, aliases)
        if canon.split(".")[0] not in _DEVICE_MODULES:
            continue
        if node.lineno in seen:
            continue
        seen.add(node.lineno)
        fn = _enclosing_name(tree, node.lineno)
        out.append(Finding(
            "GRAFT-A004", rel, f"{fn}:{name}", node.lineno,
            f"`{name}` in host-only module {rel} — routing, planning, "
            "metrics and reports stay on numpy/host types; a torch call "
            "here is a device import or sync"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, rel: str, *, sites: Sequence[str] = (),
                metric_names: Sequence[str] = (),
                host_only: bool = False,
                seen_fire_pairs: Optional[dict] = None,
                seen_metric_pairs: Optional[dict] = None) -> list[Finding]:
    """Lint one file's source (the unit tests feed violating snippets here).
    ``rel`` is the repo-relative path used in findings."""
    tree = ast.parse(source)
    aliases = _import_aliases(tree)
    lines = source.splitlines()
    findings = []
    findings += _check_determinism(tree, rel, aliases)
    findings += _check_broad_except(tree, rel, lines)
    findings += _check_fault_sites(tree, rel, sites,
                                   {} if seen_fire_pairs is None
                                   else seen_fire_pairs)
    findings += _check_metric_sites(tree, rel, metric_names,
                                    {} if seen_metric_pairs is None
                                    else seen_metric_pairs)
    if host_only:
        findings += _check_host_only(tree, rel, aliases)
    return findings


def lint_tree(root: str, package: str = "ddim_cold_torch",
              sites: Optional[Sequence[str]] = None,
              metric_names: Optional[Sequence[str]] = None) -> list[Finding]:
    """Lint every ``.py`` file under ``root/package``. ``sites`` defaults to
    the live ``utils.faults.SITES`` registry, ``metric_names`` to the live
    ``obs.metrics.METRICS`` registry."""
    if sites is None:
        from ddim_cold_torch.utils import faults

        sites = faults.SITES
        dupes = {s for s in sites if list(sites).count(s) > 1}
        if dupes:
            return [Finding("GRAFT-A003", f"{package}/utils/faults.py",
                            f"SITES:{s}", 0,
                            f"site {s!r} registered more than once in SITES")
                    for s in sorted(dupes)]
    if metric_names is None:
        from ddim_cold_torch.obs import metrics as obs_metrics

        metric_names = tuple(n for n, _, _ in obs_metrics.METRICS)
        dupes = {n for n in metric_names
                 if list(metric_names).count(n) > 1}
        if dupes:
            return [Finding("GRAFT-A005", f"{package}/obs/metrics.py",
                            f"METRICS:{n}", 0,
                            f"metric {n!r} registered more than once in "
                            "METRICS")
                    for n in sorted(dupes)]
    findings: list[Finding] = []
    seen_fire: dict = {}
    seen_metric: dict = {}
    base = os.path.join(root, package)
    for dirpath, _, files in sorted(os.walk(base)):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as f:
                src = f.read()
            findings += lint_source(
                src, rel, sites=sites, metric_names=metric_names,
                host_only=rel in HOST_ONLY_MODULES,
                seen_fire_pairs=seen_fire,
                seen_metric_pairs=seen_metric)
    return findings
