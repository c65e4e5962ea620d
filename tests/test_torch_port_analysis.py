"""The port's static analysis (``ddim_cold_torch/analysis/``) against the JAX
package's (``ddim_cold_tpu/analysis/``), on the CPU.

* Same input, same findings: every source fixture of the JAX package's own
  tests of the host layers (``tests/test_analysis.py``,
  ``test_obs.py``'s A005 cases, ``test_protocol_checks.py``,
  ``test_config_checks.py``), read out of those files, goes through JAX's
  ``lint_source`` / ``lint_config_source`` and the port's, and the two give
  the same ``(rule, subject)`` set. Two rules differ by design, and the
  test maps the fixture: A001 reads the port's device path (``torch.compile``
  and ``torch.utils.checkpoint.checkpoint`` where JAX's fixture has
  ``jax.jit`` and ``lax.scan``), A004 reads ``torch`` where JAX reads
  ``jax.numpy``. The port's own A001 form, a torch RNG draw without
  ``generator=`` in an ``nn.Module.forward`` or a ``torch.autograd.Function``,
  is checked on a torch fixture.
* The same lattice: ``config_checks.enumerate_lattice()`` gives the same
  program classes in both packages, and ``entries.serve_sweep()`` the same
  labelled configs and buckets, field for field. The port gates its
  sequence-parallel axis on the ranks an engine spans (``world``) where
  JAX gates on its device count, so the port is asked at JAX's count.
* The CLI: ``--only`` with names and letters, the trace layers refused
  with the typed error naming ROADMAP Queue 1 item 19, ``--fix-baseline``
  (partial under ``--only``), ``--list-rules``, and the clean tree with the
  port's reviewed baseline, in process and as ``python -m``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

from ddim_cold_torch.analysis import ast_checks as PA
from ddim_cold_torch.analysis import cli as pcli
from ddim_cold_torch.analysis import config_checks as PX
from ddim_cold_torch.analysis import entries as PE
from ddim_cold_torch.analysis import protocol_checks as PR
from ddim_cold_torch.analysis import thread_checks as PT
from ddim_cold_torch.analysis.findings import (
    RULES, Finding, load_baseline, rule_layer, write_baseline)
from ddim_cold_tpu.analysis import ast_checks as JA
from ddim_cold_tpu.analysis import config_checks as JX
from ddim_cold_tpu.analysis import entries as JE
from ddim_cold_tpu.analysis import findings as JF
from ddim_cold_tpu.analysis import protocol_checks as JR
from ddim_cold_tpu.analysis import thread_checks as JT

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

#: JAX's fixture registries (tests/test_analysis.py, test_obs.py,
#: test_protocol_checks.py)
SITES = ("serve.assemble", "ckpt.save")
NAMES = ("engine.compiles", "engine.failed_batches")
WIRE = frozenset({"ServeError", "RequestFailedError", "TimeoutError",
                  "ConnectionError", "ValueError", "RuntimeError"})

#: the lint helpers and dedents whose first argument is a fixture source
_FIXTURE_CALLS = {"dedent", "_lint", "_tlint"}


def _const_eval(node, local):
    """A string expression of constants (and names bound to them), or None."""
    if isinstance(node, ast.Name):
        return local.get(node.id)
    try:
        value = eval(compile(ast.Expression(node), "<fixture>", "eval"), {})  # noqa: S307
    except Exception:  # noqa: BLE001 — not a constant expression: no fixture
        return None
    return value if isinstance(value, str) else None


def _fixtures(test_file: str, function: str):
    """The fixture sources of one JAX test: the first argument of every
    ``textwrap.dedent`` / lint-helper call in it, with the literal keyword
    arguments of that call, dedented as the JAX test dedents them."""
    tree = ast.parse((TESTS / test_file).read_text())
    module = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = _const_eval(node.value, {})
            if value is not None:
                module[node.targets[0].id] = value
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    local = dict(module)
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            value = _const_eval(node.value, local)
            if value is not None:
                local[node.targets[0].id] = value
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        callee = node.func.attr if isinstance(node.func, ast.Attribute) else \
            getattr(node.func, "id", None)
        if callee not in _FIXTURE_CALLS:
            continue
        src = _const_eval(node.args[0], local)
        if src is None:
            continue
        kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
              if k.arg and isinstance(k.value, (ast.Dict, ast.Constant))}
        out.append((textwrap.dedent(src), kw))
    assert out, f"no fixture found in {test_file}::{function}"
    return out


def _pairs(findings):
    return sorted({(f.rule, f.subject) for f in findings})


# ------------------------------------------------ same input, same findings

def _tests_calling(test_file: str, helper: str):
    """The tests of a JAX test file that call its lint helper ``helper``."""
    tree = ast.parse((TESTS / test_file).read_text())
    return [fn.name for fn in tree.body
            if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")
            and any(isinstance(n, ast.Call) and getattr(n.func, "id", None) == helper
                    for n in ast.walk(fn))]


#: (JAX test file, test) → the layer its fixtures exercise: every test of
#: the host layers' rules that lints a source (A001 and A004 differ by
#: design, below)
SAME = {
    ("test_analysis.py", "test_a002_broad_except"): "ast",
    ("test_analysis.py", "test_a003_fault_sites"): "ast",
    **{("test_obs.py", name): "ast" for name in _tests_calling("test_obs.py", "_lint")},
    **{("test_analysis.py", name): "threads"
       for name in _tests_calling("test_analysis.py", "_tlint")},
    ("test_config_checks.py", "test_x002_frozen_config_bypass_lint"): "config",
    **{("test_protocol_checks.py", name): "protocol"
       for name in _tests_calling("test_protocol_checks.py", "_lint")},
}


def test_every_lint_fixture_of_the_host_layers_is_compared():
    rules = {name.split("_")[1] for _, name in SAME}
    assert rules >= {"a002", "a003", "a005", "t001", "t002", "t003", "t004", "t005",
                     "r001", "r002", "r003", "r004", "r005", "x002"}
    assert len(SAME) == 29


def _lint_both(layer, src, kw):
    if layer == "ast":
        kw = dict(sites=SITES, metric_names=NAMES, **kw)
        return (JA.lint_source(src, "fix.py", **kw), PA.lint_source(src, "fix.py", **kw))
    if layer == "threads":
        return (JT.lint_source(src, "fix.py", **kw), PT.lint_source(src, "fix.py", **kw))
    if layer == "protocol":
        return (JR.lint_source(src, "fix.py", wire_names=WIRE),
                PR.lint_source(src, "fix.py", wire_names=WIRE))
    return JX.lint_config_source(src, "fix.py"), PX.lint_config_source(src, "fix.py")


@pytest.mark.parametrize("case", sorted(SAME), ids=lambda c: c[1])
def test_same_fixture_same_findings(case):
    for src, kw in _fixtures(*case):
        jax_fs, port_fs = _lint_both(SAME[case], src, kw)
        assert _pairs(port_fs) == _pairs(jax_fs), src
        assert [f.line for f in sorted(port_fs)] == [f.line for f in sorted(jax_fs)]


#: A001: JAX's tracing wrappers, each mapped onto the port's device path
A001_MAP = (("import jax\n", "import torch\n"), ("@jax.jit", "@torch.compile"),
            ("jax.lax.scan(body, x, None, length=2)",
             "torch.utils.checkpoint.checkpoint(body, x, None)"),
            ("jax.jit(g,", "torch.compile(g,"), ("partial(jax.jit,", "partial(torch.compile,"))
#: A004: the device module, jax.numpy in JAX and torch in the port
A004_MAP = (("import jax.numpy as jnp", "import torch as jnp"),)


def _mapped(src, mapping):
    for old, new in mapping:
        src = src.replace(old, new)
    return src


@pytest.mark.parametrize("function,mapping,kw", [
    ("test_a001_nondeterminism_in_traced_fn", A001_MAP, {}),
    ("test_a001_jit_assignment_and_partial_forms", A001_MAP, {}),
    ("test_a004_device_calls_in_host_only_module", A004_MAP, {"host_only": True}),
    ("test_a004_device_calls_in_host_only_module", A004_MAP, {})])
def test_by_design_rules_give_jax_findings_on_the_mapped_fixture(function, mapping, kw):
    """JAX's A001/A004 fixtures name JAX's tracing wrappers and device
    module; on the port's forms of them the port gives JAX's findings, and
    on JAX's own forms none (they are not the port's device path)."""
    for src, _ in _fixtures("test_analysis.py", function):
        jax_fs = JA.lint_source(src, "fix.py", sites=SITES, **kw)
        port_fs = PA.lint_source(_mapped(src, mapping), "fix.py", sites=SITES, **kw)
        assert _pairs(port_fs) == _pairs(jax_fs)
        assert sorted(f.line for f in port_fs) == sorted(f.line for f in jax_fs)
        if jax_fs:
            assert PA.lint_source(src, "fix.py", sites=SITES, **kw) == []


TORCH_A001 = textwrap.dedent("""\
    import random
    import torch
    from torch import nn

    class Block(nn.Module):
        def forward(self, x, generator=None):
            noise = torch.randn(x.shape, generator=generator)
            return self.mix(x) + noise + torch.rand(1)

        def mix(self, x):
            y = x.normal_()
            return y * random.random()

        def describe(self):
            return torch.rand(1)  # not on the device path

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * torch.randint(0, 2, (1,))

        @staticmethod
        def backward(ctx, g):
            return g.bernoulli_(0.5, generator=torch.Generator())

    def host_draw():
        return torch.randn(3)  # host code: no device path
""")


def test_a001_port_form_flags_torch_rng_without_generator():
    fs = PA.lint_source(TORCH_A001, "fix.py", sites=SITES)
    assert {(f.rule, f.line, f.subject) for f in fs} == {
        ("GRAFT-A001", 8, "forward:torch.rand"),
        ("GRAFT-A001", 11, "mix:<tensor>.normal_"),
        ("GRAFT-A001", 12, "mix:random.random"),
        ("GRAFT-A001", 20, "forward:torch.randint")}


def test_a004_port_form_flags_torch_in_a_host_only_module():
    src = "import torch\n\ndef plan(rows):\n    return torch.zeros(rows)\n"
    fs = PA.lint_source(src, "fix.py", sites=SITES, host_only=True)
    assert [(f.rule, f.line, f.subject) for f in fs] == [("GRAFT-A004", 4, "plan:torch.zeros")]


# ---------------------------------------------------------- the same lattice


def test_lattice_has_jax_classes():
    jax_classes = [cls for cls, _ in JX.enumerate_lattice()]
    port_classes = [cls for cls, _ in PX.enumerate_lattice(jax.device_count())]
    assert len(port_classes) == len(set(port_classes)) > 50
    assert set(port_classes) == set(jax_classes)
    # at one rank the sequence-parallel axis holds only its off point
    assert {cls[-2:] for cls, _ in PX.enumerate_lattice(1)} == {("none", 1)}


def test_serve_sweep_is_jax_entry_for_entry():
    """Same labels in the same order, equal buckets, every SamplerConfig
    field equal (both packages' configs have the same fields)."""
    jax_sweep, port_sweep = JE.serve_sweep(), PE.serve_sweep(jax.device_count())
    assert [r[0] for r in port_sweep] == [r[0] for r in jax_sweep]
    for (label, jcfg, jb), (_, pcfg, pb) in zip(jax_sweep, port_sweep):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg), label
        assert pb == jb, label
    # the CLI's one-process world has no sequence-parallel entry
    assert all(cfg.sp_degree == 1 for _, cfg, _ in PE.serve_sweep())


def test_x_rules_clean_on_the_port_lattice():
    assert PX.check_sweep_completeness() == []
    assert PX.check_validation_consistency() == []
    assert PX.check_warmup_soundness() == []
    # JAX's X001 proof at its device count holds for the port's sweep there
    assert PX.check_sweep_completeness(PE.serve_sweep(jax.device_count()),
                                       world=jax.device_count()) == []


# -------------------------------------------------------- rules and the CLI


def test_rule_table_is_jax_ids_with_trace_rules_marked():
    assert set(RULES) == set(JF.RULES)
    assert {rule_layer(r) for r in RULES} == set(pcli.LAYERS)
    for rule, desc in RULES.items():
        traced = rule_layer(rule) in pcli.UNPORTED_LAYERS
        assert ("Queue 1 item 19" in desc) == traced, rule


def test_baseline_roundtrip_and_malformed(tmp_path):
    path = str(tmp_path / "base")
    fs = [Finding("GRAFT-T001", "ddim_cold_torch/serve/engine.py", "Engine.drain:_pending", 7),
          Finding("GRAFT-A002", "a.py", "f:except Exception", 3),
          Finding("GRAFT-A002", "a.py", "f:except Exception", 3)]
    assert write_baseline(path, fs) == 2  # sorted, deduped
    with open(path, "a") as f:
        f.write("GRAFT-P003 ddim_cold_torch/csrc/x.cu :: e:pad  # reviewed: a reason\n")
    assert load_baseline(path) == {f.key for f in fs} | {
        "GRAFT-P003 ddim_cold_torch/csrc/x.cu :: e:pad"}
    assert load_baseline(str(tmp_path / "missing")) == set()
    (tmp_path / "bad").write_text("NOT-A-RULE something :: else\n")
    with pytest.raises(ValueError):
        load_baseline(str(tmp_path / "bad"))


def test_only_accepts_names_and_letters_of_the_ported_layers():
    assert pcli.parse_only(["T,R"]) == ("threads", "protocol")
    assert pcli.parse_only(["P", "x"]) == ("kernels", "config")
    assert pcli.parse_only(["ast", "a", "threads,threads"]) == ("ast", "threads")
    with pytest.raises(Exception, match="unknown layer"):
        pcli.parse_only(["z"])


@pytest.mark.parametrize("only", ["jaxpr", "M", "C,T", "sharding"])
def test_trace_layers_raise_the_typed_error_naming_item_19(only):
    with pytest.raises(pcli.UnportedLayerError, match="ROADMAP Queue 1 item 19"):
        pcli.parse_only([only])
    with pytest.raises(pcli.UnportedLayerError, match="Queue 1 item 19"):
        pcli.main(["--only", only])
    with pytest.raises(pcli.UnportedLayerError):
        pcli.collect(pcli.repo_root(), only=("jaxpr",))


def test_fix_baseline_then_clean_and_partial_refresh(tmp_path, monkeypatch):
    """Findings exit 1; --fix-baseline captures them; with the baseline the
    run exits 0; --fix-baseline --only refreshes only those layers' rule
    families and keeps the other lines; a full one keeps nothing else."""
    base = str(tmp_path / "allow")
    ast_f = Finding("GRAFT-A002", "x.py", "f:except Exception", 1, "msg")
    t_old = Finding("GRAFT-T001", "y.py", "W.bad:_q", 5)
    t_new = Finding("GRAFT-T003", "y.py", "W.bad:_fail", 9)
    p_f = Finding("GRAFT-P003", "ddim_cold_torch/csrc/flash_fwd.cu", "e:pad", 0)
    monkeypatch.setattr(pcli, "collect", lambda *a, **k: [ast_f])
    assert pcli.main(["--only", "ast", "--baseline", base]) == 1
    assert pcli.main(["--only", "ast", "--fix-baseline", base]) == 0
    assert pcli.main(["--only", "ast", "--baseline", base]) == 0

    monkeypatch.setattr(pcli, "collect", lambda *a, **k: [ast_f, t_old, p_f])
    assert pcli.main(["--fix-baseline", base]) == 0
    assert load_baseline(base) == {ast_f.key, t_old.key, p_f.key}
    monkeypatch.setattr(pcli, "collect", lambda *a, **k: [t_new])
    assert pcli.main(["--only", "T", "--fix-baseline", base]) == 0
    assert load_baseline(base) == {ast_f.key, t_new.key, p_f.key}
    monkeypatch.setattr(pcli, "collect", lambda *a, **k: [])
    assert pcli.main(["--only", "P", "--fix-baseline", base]) == 0
    assert load_baseline(base) == {ast_f.key, t_new.key}
    monkeypatch.setattr(pcli, "collect", lambda *a, **k: [ast_f])
    assert pcli.main(["--fix-baseline", base]) == 0
    assert load_baseline(base) == {ast_f.key}


def test_list_rules_prints_every_rule(capsys):
    assert pcli.main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(" ", 1)[0] for line in lines] == sorted(RULES)


def test_clean_tree_in_process():
    """Every ported layer over ddim_cold_torch/ gives no finding outside the
    reviewed baseline, which holds R002's two rank errors and nothing else
    (``tests/test_torch_port_analysis_checks.py`` holds their reason)."""
    baseline = load_baseline(pcli.DEFAULT_BASELINE)
    assert [f.render() for f in pcli.collect(pcli.repo_root())
            if f.key not in baseline] == []
    assert baseline == {
        "GRAFT-R002 ddim_cold_torch/serve/errors.py :: unregistered:RankFailedError",
        "GRAFT-R002 ddim_cold_torch/serve/errors.py :: unregistered:RankLostError"}
    lines = [line for line in Path(pcli.DEFAULT_BASELINE).read_text().splitlines()
             if line.startswith("GRAFT-")]
    assert len(lines) == 2 and all(" # " in line for line in lines)


def test_cli_module_exits_zero_without_jax_and_names_the_unported_layers():
    """``python -m ddim_cold_torch.analysis`` as the card's phase runs it
    (``chip_smoke.ANALYSIS_WITHOUT_JAX``: JAX and the JAX package made
    unimportable): exit 0, the summary naming the five layers run and the
    four still to port."""
    import chip_smoke

    proc = subprocess.run([sys.executable, "-c", chip_smoke.ANALYSIS_WITHOUT_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == (
        "graftcheck: 0 findings (2 baselined) [layers: ast, threads, protocol, config, "
        "kernels; not "
        "ported yet: jaxpr, memory, sharding, collective (ROADMAP Queue 1 item 19)]")
    blocked = chip_smoke.ANALYSIS_WITHOUT_JAX.replace(
        'runpy.run_module("ddim_cold_torch.analysis", run_name="__main__", alter_sys=True)',
        "import ddim_cold_tpu.analysis")
    proc = subprocess.run([sys.executable, "-c", blocked], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0 and "not importable here" in proc.stderr
