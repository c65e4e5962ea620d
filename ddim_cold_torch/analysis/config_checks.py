"""X-rules: the SamplerConfig lattice, abstractly enumerated (layer X).

Counterpart of ``ddim_cold_tpu/analysis/config_checks.py`` over the port's
lattice: its ``serve/batching.SamplerConfig`` gate (JAX's, copied),
``ops/step_cache.cache_spec`` and ``workloads/tasks.default_edit_configs``.
Two things differ by design. The sequence-parallel axis is gated on the
ranks an engine spans (``world``; the port's engine serves ``sp_degree > 1``
only on a mesh of ranks) where JAX gates on the process's device count. And
X003's literal construction sites are ``chip_smoke.py``'s, the script that
drives the port on the card until the port has a benchmark of its own; the
rule's id and meaning stay.

In JAX the J-layer proves every *swept* config traces, hashes stably, and (J006)
hashes *distinctly*. What nothing proved until now is the converse
direction: that the sweep actually COVERS the legal config space — a new
legal combination (say ``cache_mode="full"``, which shipped with zero
sweep entries) silently gets no trace/hash/compile coverage, and its first
trace happens in production. The X-layer closes that hole by enumerating
the lattice from the validation code itself and demanding sweep witnesses.

``SamplerConfig.__post_init__`` is the single construction-time gate, so
the legal space is *decidable by construction*: build every candidate in a
product grid over the declared axes and keep the ones that don't raise.
The grid is quotiented the same way JAX's ``program_fingerprint`` is
constant-blind: axes whose values are scan-trip constants or pure
param-routing (``k``, ``t_start``, thresholds, token counts, ``student``)
collapse to one representative each, because two values on such an axis
are *by design* the same compiled program class.

Rules:

* **X001 sweep completeness** — every legal program CLASS (the
  ``config_class`` quotient) is witnessed by the J-layer sweep:
  (D1) every legal (family, cached, telemetry, seq) projection at the
  base modifiers has a sweep entry; (D2) every legal cache mode has a
  cached witness; (D3) every CPU-traceable quant mode has a cached and an
  uncached witness (the Pallas-backed modes — ``pallas``/``w8a8``/
  ``fused`` — are documented exclusions certified by the P/M kernel
  layers instead, and the exclusion list is pinned against
  ``_QUANT_MODES`` so a new quant mode can't ship unclassified);
  (D4) the sequence-parallel family is witnessed at exactly the
  geometries the sweep's device gate admits in this world.
* **X002 validation consistency** — the lattice has ONE boundary:
  (a) the cache subspace accepted at SamplerConfig construction agrees
  with ``ops/step_cache.cache_spec`` (the program-build gate) combo by
  combo; (b) every step count the distillation trainer can produce a
  student at is servable (``steps=s, student=True`` constructs), and the
  ``steps=0`` student hole stays closed; (c) no code path bypasses the
  gate by ``object.__setattr__`` onto a frozen config (the dataclass is
  frozen precisely so construction is the only door).
* **X003 warmup-set soundness** — the configs serving actually warms are
  inside the lattice: every ``workloads.default_edit_configs`` member (at
  preview 0 and 2) constructs AND its D1 projection is sweep-witnessed;
  every literal ``SamplerConfig(...)`` call site in ``chip_smoke.py``
  constructs once non-literal kwargs are substituted from per-axis
  representatives.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
import os

from ddim_cold_torch.analysis.findings import Finding

_ENTRIES_PATH = "ddim_cold_torch/analysis/entries.py"
_BATCHING_PATH = "ddim_cold_torch/serve/batching.py"
_TASKS_PATH = "ddim_cold_torch/workloads/tasks.py"

#: quant modes the sweep covers vs the documented exclusions: the
#: kernel-backed modes (``pallas``/``w8a8``, the card's CUDA kernels) are
#: certified by the P layer's kernel entries instead, as JAX's Pallas-backed
#: modes are by its P/M layers. X001 pins COVERED ∪ EXCLUDED == _QUANT_MODES
#: so a new mode must be filed.
COVERED_QUANT = (None, "xla")
EXCLUDED_QUANT = ("pallas", "w8a8")

#: one cache-axis representative per mode: (interval, mode, threshold,
#: tokens). Values on the threshold/token axes are constant-blind
#: (fingerprint-equivalent) — one representative each is the quotient.
_CACHE_POINTS = (
    (1, "delta", None, 0),        # uncached
    (2, "delta", None, 0),
    (2, "full", None, 0),
    (2, "adaptive", 0.05, 0),
    (2, "token", None, 3),
)

#: (steps, student) representatives: stride family, two fewstep counts
#: (steps=1 lowers scan-free — structurally its own class), one student
#: (param-routing only: same program, so it adds no D1 class)
_STEP_POINTS = ((0, False), (1, False), (4, False), (2, True))

#: modules X002c scans for frozen-config bypasses
_BYPASS_SCAN = (
    "ddim_cold_torch/serve",
    "ddim_cold_torch/workloads",
    "ddim_cold_torch/train",
    "chip_smoke.py",
)

#: the file whose literal SamplerConfig(...) sites X003 constructs
_BENCH_PATH = "chip_smoke.py"

#: substitutes for non-literal kwargs at chip_smoke.py SamplerConfig sites —
#: one in-lattice representative per axis (X003's constant-blind quotient:
#: WHICH value a sweep variable takes never changes legality)
_BENCH_REPRESENTATIVES = {
    "k": 10, "t_start": 999, "levels": 4, "cache_interval": 2,
    "cache_threshold": 0.05, "cache_tokens": 3, "steps": 2,
    "sp_degree": 2, "preview_every": 2,
}


def _sampler_config():
    from ddim_cold_torch.serve.batching import SamplerConfig

    return SamplerConfig


def _sp_error():
    from ddim_cold_torch.serve.batching import SeqParallelConfigError

    return SeqParallelConfigError


def try_config(**kwargs):
    """Construct a SamplerConfig; the legality oracle. Returns the config
    or None when the validation gate rejects the combination."""
    SamplerConfig = _sampler_config()
    try:
        return SamplerConfig(**kwargs)
    except (ValueError, _sp_error()):  # noqa: BLE001 — the two documented
        # rejection types (sp errors are lazily imported, hence computed)
        return None


def config_class(cfg) -> tuple:
    """The program-class quotient of one config: the axes that select a
    DIFFERENT compiled program under JAX's constant-blind fingerprint.
    Constants (k, t_start, levels, thresholds, token/step counts) and pure
    param routing (student) are deliberately absent."""
    if cfg.task == "inpaint":
        family = "inpaint"
    elif cfg.sampler == "cold":
        family = "cold"
    elif cfg.steps > 0:
        family = "fewstep"
    else:
        family = "ddim"
    return (family, cfg.cached, cfg.telemetry, cfg.preview_every > 0,
            cfg.cache_mode if cfg.cached else None, cfg.quant, cfg.fused,
            cfg.sp_mode, cfg.sp_degree)


def projection(cls: tuple) -> tuple:
    """D1's coarse view of a class: (family, cached, telemetry, seq)."""
    return cls[:4]


def _sp_points(world: int = 1):
    """The sp geometries the sweep's gate admits for an engine over
    ``world`` ranks — X001's demands must mirror the gate exactly or the
    one-process CLI world would demand witnesses that cannot exist there."""
    pts = [("none", 1)]
    if world >= 2 and world % 2 == 0:
        pts += [("ulysses", 2), ("ring", 2)]
    if world >= 8 and world % 8 == 0:
        pts.append(("ulysses", 8))
    return pts


def enumerate_lattice(world: int = 1) -> list:
    """Every legal config class, as (class, config) pairs — the product
    grid over the quotiented axes, filtered by the construction gate."""
    from ddim_cold_torch.serve.batching import (_QUANT_MODES, _SAMPLERS,
                                              _TASKS)

    seen = {}
    for task, sampler, cache, quant, fused, preview, tel, steps_pt, sp in \
            itertools.product(_TASKS, _SAMPLERS, _CACHE_POINTS,
                              _QUANT_MODES, (False, True), (0, 2),
                              (False, True), _STEP_POINTS, _sp_points(world)):
        interval, mode, threshold, tokens = cache
        steps, student = steps_pt
        cfg = try_config(
            task=task, sampler=sampler, cache_interval=interval,
            cache_mode=mode, cache_threshold=threshold,
            cache_tokens=tokens, quant=quant, fused=fused,
            preview_every=preview, telemetry=tel, steps=steps,
            student=student, sp_mode=sp[0], sp_degree=sp[1],
            t_start=999 if task in ("draft", "interp") else None)
        if cfg is not None:
            seen.setdefault(config_class(cfg), cfg)
    return sorted(seen.items(), key=lambda kv: repr(kv[0]))


def _class_name(cls: tuple) -> str:
    family, cached, tel, seq, mode, quant, fused, sp_mode, sp_degree = cls
    bits = [family]
    if cached:
        bits.append(f"cached:{mode}")
    if tel:
        bits.append("tel")
    if seq:
        bits.append("seq")
    if quant:
        bits.append(f"quant:{quant}")
    if fused:
        bits.append("fused")
    if sp_mode != "none":
        bits.append(f"sp:{sp_mode}{sp_degree}")
    return "/".join(bits)


def check_sweep_completeness(sweep=None, world: int = 1) -> list:
    """X001: the serve sweep witnesses the legal lattice (D1–D4)."""
    if sweep is None:
        from ddim_cold_torch.analysis import entries

        sweep = entries.serve_sweep(world)
    findings = []
    witnesses = [config_class(cfg) for _, cfg, _ in sweep]
    lattice = enumerate_lattice(world)

    def base(cls):
        # quant=None, unfused, sp-off — the D1 plane
        return cls[5] is None and not cls[6] and cls[7] == "none"

    # D1 — every legal (family, cached, tel, seq) projection on the base
    # plane has a witness on the base plane
    legal_projs = sorted({projection(cls) for cls, _ in lattice
                          if base(cls)})
    witnessed_projs = {projection(c) for c in witnesses if base(c)}
    for proj in legal_projs:
        if proj not in witnessed_projs:
            family, cached, tel, seq = proj
            findings.append(Finding(
                "GRAFT-X001", _ENTRIES_PATH,
                f"class:{_class_name((*proj, None, None, False, 'none', 1))}",
                0,
                f"legal program class (family={family}, cached={cached}, "
                f"telemetry={tel}, seq={seq}) has no serve_sweep entry — "
                "it would reach production untraced, unhashed, and "
                "unwarmed (J006 proves nothing about it)"))

    # D2 — every legal cache mode has a cached witness
    legal_modes = sorted({cls[4] for cls, _ in lattice
                          if base(cls) and cls[1]})
    witnessed_modes = {c[4] for c in witnesses if c[1]}
    for mode in legal_modes:
        if mode not in witnessed_modes:
            findings.append(Finding(
                "GRAFT-X001", _ENTRIES_PATH, f"cache-mode:{mode}", 0,
                f"legal cache_mode={mode!r} has no cached sweep entry — "
                "a whole reuse-step program family with zero J-layer "
                "coverage"))

    # D3 — CPU-coverable quant modes need cached + uncached witnesses;
    # the exclusion list is pinned against the declared axis
    from ddim_cold_torch.serve.batching import _QUANT_MODES

    unclassified = set(_QUANT_MODES) - set(COVERED_QUANT) \
        - set(EXCLUDED_QUANT)
    for quant in sorted(unclassified, key=repr):
        findings.append(Finding(
            "GRAFT-X001", _BATCHING_PATH, f"unclassified-quant:{quant}", 0,
            f"quant mode {quant!r} is neither sweep-covered nor a "
            "documented kernel-layer exclusion — classify it in "
            "analysis/config_checks.py (COVERED_QUANT / EXCLUDED_QUANT)"))
    for quant in COVERED_QUANT:
        for cached in (False, True):
            hit = any(c[5] == quant and c[1] == cached for c in witnesses)
            if not hit:
                findings.append(Finding(
                    "GRAFT-X001", _ENTRIES_PATH,
                    f"quant:{quant}:{'cached' if cached else 'uncached'}",
                    0,
                    f"quant={quant!r} has no "
                    f"{'cached' if cached else 'uncached'} sweep witness"))

    # D4 — sp geometries the device gate admits must each be witnessed
    # (ulysses, ring, and — above the base pair — cached-sp composition)
    for sp_mode, sp_degree in _sp_points(world):
        if sp_mode == "none":
            continue
        if not any(c[7] == sp_mode and c[8] == sp_degree
                   for c in witnesses):
            findings.append(Finding(
                "GRAFT-X001", _ENTRIES_PATH,
                f"sp:{sp_mode}{sp_degree}", 0,
                f"sp_mode={sp_mode!r} sp_degree={sp_degree} is legal at "
                "this world's device count but unswept"))
    if any(p != ("none", 1) for p in _sp_points(world)):
        if not any(c[1] and c[7] != "none" for c in witnesses):
            findings.append(Finding(
                "GRAFT-X001", _ENTRIES_PATH, "sp:cached", 0,
                "static caching composes with sp but no cached sp entry "
                "exists in the sweep"))
    return findings


# ---------------------------------------------------------------------------
# X002 — validation consistency
# ---------------------------------------------------------------------------

def _default_spec_fn(interval, mode, threshold, tokens):
    """The program-build gate, probed at the sweep model's geometry
    (depth=4 blocks, 17 tokens, 4 reuse steps). Returns True when
    cache_spec accepts the combination."""
    from ddim_cold_torch.ops import step_cache

    kwargs = dict(depth=4, n_steps=4, cache_interval=interval,
                  cache_mode=mode, threshold=threshold,
                  token_k=tokens or None,
                  n_tokens=17 if mode == "token" else None)
    try:
        step_cache.cache_spec(**kwargs)
        return True
    except ValueError:
        return False


def check_validation_consistency(spec_fn=None) -> list:
    """X002 (a)+(b): one legality boundary, not two."""
    if spec_fn is None:
        spec_fn = _default_spec_fn
    findings = []

    # (a) cache subspace: construction gate vs program-build gate, combo
    # by combo over the representatives grid. cache_tokens' model-
    # dependent UPPER bound (≤ n_tokens) is the one documented exemption:
    # the host-only config never sees the model, so it defers that edge
    # to build — the grid stays under the probe geometry's bound.
    from ddim_cold_torch.serve.batching import _CACHE_MODES

    for interval, mode, threshold, tokens in itertools.product(
            (2,), _CACHE_MODES, (None, 0.05), (0, 3)):
        cfg_ok = try_config(cache_interval=interval, cache_mode=mode,
                            cache_threshold=threshold,
                            cache_tokens=tokens) is not None
        spec_ok = spec_fn(interval, mode, threshold, tokens)
        if cfg_ok != spec_ok:
            combo = (f"ci{interval}/{mode}/th={threshold}/tok={tokens}")
            gate = "construction accepts what build rejects" if cfg_ok \
                else "build accepts what construction rejects"
            findings.append(Finding(
                "GRAFT-X002", _BATCHING_PATH, f"cache:{combo}", 0,
                f"SamplerConfig and ops/step_cache.cache_spec disagree on "
                f"{combo}: {gate} — a config admitted at submit would "
                "fail (or silently differ) at program build"))

    # (b) distill ↔ serve: every halving-chain step count the trainer can
    # emit a student at must construct as a servable student config
    from ddim_cold_torch.train.distill import DistillConfig

    producible = []
    for start in (1, 2, 4, 8):
        try:
            DistillConfig(start_steps=start, target_steps=1)
        except ValueError:
            continue
        s = start
        while s >= 1:
            producible.append(s)
            if s == 1:
                break
            s //= 2
    for s in sorted(set(producible)):
        if try_config(steps=s, student=True) is None:
            findings.append(Finding(
                "GRAFT-X002", _BATCHING_PATH, f"student-steps:{s}", 0,
                f"distillation can produce a student at steps={s} but "
                "SamplerConfig(steps={s}, student=True) is rejected — "
                "the trained artifact would be unservable"))
    if try_config(steps=0, student=True) is not None:
        findings.append(Finding(
            "GRAFT-X002", _BATCHING_PATH, "student-steps:0", 0,
            "SamplerConfig(steps=0, student=True) constructs — the "
            "stride-family student hole (silently mis-serving a teacher "
            "schedule on student params) has reopened"))
    return findings


def lint_config_source(source: str, rel: str) -> list:
    """X002 (c): flag ``object.__setattr__(cfg, "<SamplerConfig field>",
    ...)`` — a post-construction mutation that skips the validation gate
    the frozen dataclass exists to enforce."""
    field_names = {f.name for f in dataclasses.fields(_sampler_config())}
    findings = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "__setattr__"
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "object"):
            continue
        if len(node.args) < 2:
            continue
        target, key = node.args[0], node.args[1]
        name = ""
        while isinstance(target, ast.Attribute):
            target = target.value
        if isinstance(target, ast.Name):
            name = target.id.lower()
        if not ("config" in name or "cfg" in name):
            continue
        if isinstance(key, ast.Constant) and key.value in field_names:
            findings.append(Finding(
                "GRAFT-X002", rel, f"bypass:{key.value}", node.lineno,
                f"object.__setattr__ writes SamplerConfig.{key.value} "
                "after construction — the frozen validation gate is "
                "bypassed; build a new config instead"))
    return findings


def _scan_bypasses(root: str) -> list:
    findings = []
    for target in _BYPASS_SCAN:
        path = os.path.join(root, target)
        if os.path.isfile(path):
            files = [(path, target)]
        elif os.path.isdir(path):
            files = []
            for dirpath, _, names in os.walk(path):
                for n in sorted(names):
                    if n.endswith(".py"):
                        full = os.path.join(dirpath, n)
                        files.append(
                            (full, os.path.relpath(full, root)
                             .replace(os.sep, "/")))
        else:
            continue
        for full, rel in files:
            with open(full) as f:
                findings += lint_config_source(f.read(), rel)
    return findings


# ---------------------------------------------------------------------------
# X003 — warmup-set soundness
# ---------------------------------------------------------------------------

def _literal(node):
    """Evaluate a (possibly negated) literal constant; None on anything
    dynamic. Returns (ok, value)."""
    if isinstance(node, ast.Constant):
        return True, node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and isinstance(node.operand, ast.Constant):
        return True, -node.operand.value
    return False, None


def _bench_config_sites(source: str) -> list:
    """(lineno, kwargs) for each evaluable ``SamplerConfig(...)`` call:
    literal kwargs kept, known sweep variables substituted from
    representatives, sites with splats/positional args skipped."""
    sites = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else ""
        if name != "SamplerConfig":
            continue
        if node.args or any(kw.arg is None for kw in node.keywords):
            continue  # positional/splat call — not statically evaluable
        kwargs = {}
        ok = True
        for kw in node.keywords:
            lit, value = _literal(kw.value)
            if lit:
                kwargs[kw.arg] = value
            elif kw.arg in _BENCH_REPRESENTATIVES:
                kwargs[kw.arg] = _BENCH_REPRESENTATIVES[kw.arg]
            else:
                ok = False
                break
        if ok:
            sites.append((node.lineno, kwargs))
    return sites


def check_warmup_soundness(root=None, sweep=None, world: int = 1) -> list:
    """X003: everything serving warms or chip_smoke.py constructs is
    in-lattice (and, for the edit set, sweep-witnessed on the D1 plane)."""
    if root is None:
        from ddim_cold_torch.analysis.cli import repo_root

        root = repo_root()
    if sweep is None:
        from ddim_cold_torch.analysis import entries

        sweep = entries.serve_sweep(world)
    findings = []
    witnessed_projs = {projection(config_class(cfg))
                       for _, cfg, _ in sweep}

    # (a) the default edit warm set, at both preview settings it serves
    from ddim_cold_torch.workloads.tasks import default_edit_configs

    for preview in (0, 2):
        try:
            configs = default_edit_configs(preview_every=preview)
        except (ValueError, _sp_error()) as exc:  # noqa: BLE001 — the
            # gate's two rejection types; the catch IS the finding
            findings.append(Finding(
                "GRAFT-X003", _TASKS_PATH, f"edit-set:pv{preview}", 0,
                f"default_edit_configs(preview_every={preview}) raised "
                f"{type(exc).__name__}: {exc} — the standard warm set "
                "is outside the legal lattice"))
            continue
        for cfg in configs:
            proj = projection(config_class(cfg))
            if proj not in witnessed_projs:
                findings.append(Finding(
                    "GRAFT-X003", _TASKS_PATH,
                    f"edit-unswept:{cfg.task}:pv{preview}", 0,
                    f"default_edit_configs warms task={cfg.task!r} at "
                    f"preview_every={preview} but its program class "
                    f"{proj} has no sweep witness"))

    # (b) chip_smoke.py's literal construction sites all build in-lattice
    # configs (excluded-quant/fused/sp sites still CONSTRUCT — only their
    # trace coverage lives elsewhere, so no coverage demand here)
    bench = os.path.join(root, _BENCH_PATH)
    if os.path.isfile(bench):
        with open(bench) as f:
            sites = _bench_config_sites(f.read())
        for lineno, kwargs in sites:
            if try_config(**kwargs) is None:
                findings.append(Finding(
                    "GRAFT-X003", _BENCH_PATH, f"{_BENCH_PATH}:{lineno}",
                    lineno,
                    f"{_BENCH_PATH} SamplerConfig site at line {lineno} "
                    f"(kwargs {kwargs}) is rejected by the validation "
                    "gate — the card run constructs an illegal config"))
    return findings


def run_config_checks(root=None) -> list:
    """The full X-layer."""
    if root is None:
        from ddim_cold_torch.analysis.cli import repo_root

        root = repo_root()
    findings = []
    findings += check_sweep_completeness()
    findings += check_validation_consistency()
    findings += _scan_bypasses(root)
    findings += check_warmup_soundness(root)
    return findings
