"""The port stands alone and runs on the card unless told otherwise.

* no module of ``ddim_cold_torch`` (nor ``chip_smoke.py``) imports jax, flax
  or the JAX package — the training slice's modules included — and none
  imports PIL, PyYAML, TensorBoard, Triton or matplotlib at module level
  (the card's machine need not have them: they are imported where they
  are used);
* the entry points resolve ``device=None`` to CUDA and raise without it,
  instead of running on the CPU; the kernel loader raises likewise; every
  command of ``python -m ddim_cold_torch`` that builds a model exits 3
  without CUDA unless the CPU is asked for, writing nothing;
* ``chip_smoke.py`` exits non-zero, printing no result, without CUDA and
  when the port is not beside it.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddim_cold_torch import serve
from ddim_cold_torch.models import DiffusionViT
from ddim_cold_torch.ops import _build
from ddim_cold_torch.ops import sampling
from ddim_cold_torch.utils.platform import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ddim_cold_tpu")
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    return sorted((ROOT / "ddim_cold_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_training_slice_modules_are_checked():
    """The import check above walks every module of the training slice."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/{m}.py" for m in (
        "config", "ops/losses", "ops/degrade", "data/resize", "data/datasets",
        "data/loader", "data/native", "utils/logging", "utils/checkpoint", "train/step",
        "train/trainer", "__main__")} <= names


def test_quant_slice_modules_are_checked():
    """The import check walks the quantized trunk's modules too."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/{m}.py" for m in (
        "ops/quant", "ops/tiling", "ops/flash_attention", "models/vit", "models/moe",
        "serve/engine", "utils/weights")} <= names


def test_editing_slice_modules_are_checked():
    """The import check walks the samplers, the workloads and the backward
    fixture's tool too."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/{m}.py" for m in (
        "ops/sampling", "ops/schedule", "workloads/__init__", "workloads/tasks",
        "workloads/preview", "serve/warmup", "tools/bwd_fixture")} <= names


def _edit_entry_points():
    from ddim_cold_torch import workloads

    x, m = np.zeros((1, 16, 16, 3)), np.ones((16, 16))
    g = torch.Generator()
    return {
        "cold_sample": lambda model: sampling.cold_sample(model, x_init=x, levels=2),
        "ddim_sample_fewstep": lambda model: sampling.ddim_sample_fewstep(
            model, x_init=x, steps=2),
        "ddim_inpaint": lambda model: sampling.ddim_inpaint(model, x, x, m[None, ..., None]),
        "inpaint": lambda model: workloads.inpaint(model, g, x, m),
        "super_resolve": lambda model: workloads.super_resolve(model, x[:, :4, :4], level=2),
        "draft_to_drawing": lambda model: workloads.draft_to_drawing(model, g, x),
        "interpolate": lambda model: workloads.interpolate(model, g, x[0], x[0]),
    }


@pytest.mark.parametrize("name", ["cold_sample", "ddim_sample_fewstep", "ddim_inpaint",
                                  "inpaint", "super_resolve", "draft_to_drawing",
                                  "interpolate"])
def test_edit_entry_points_need_cuda_unless_told(no_cuda, name):
    model = DiffusionViT(**TINY, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        _edit_entry_points()[name](model)


def test_optional_packages_are_imported_lazily():
    """PIL, yaml, tensorboard, triton and matplotlib appear only inside
    functions."""
    lazy = ("PIL", "yaml", "tensorboard", "triton", "matplotlib")
    bad = []
    for f in _port_files():
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in tree.body:  # module level only
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module
                    else [])
            bad += [(f.name, m) for m in mods if m.split(".")[0] in lazy
                    or "tensorboard" in m]
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_none_means_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        DiffusionViT(**TINY)
    model = DiffusionViT(**TINY, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.Engine(model, buckets=(2,))
    with pytest.raises(RuntimeError, match="cuda"):
        sampling.ddim_sample(model, x_init=np.zeros((1, 16, 16, 3)), k=500)
    assert resolve_device("cpu") == torch.device("cpu")
    from ddim_cold_torch import __main__ as cli

    assert cli.main(["train", "any_experiment"]) == cli.NO_ACCELERATOR


def test_kernel_loader_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load_library("flash_fwd")


def test_backward_kernels_and_trainer_need_cuda_unless_told(no_cuda, tmp_path):
    from ddim_cold_torch.config import ExperimentConfig
    from ddim_cold_torch.train import trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load_library("flash_bwd")
    cfg = ExperimentConfig(exp_name="x", data_storage=(str(tmp_path), str(tmp_path)))
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.run(cfg, str(tmp_path))


def test_engine_refuses_a_model_on_another_device():
    model = DiffusionViT(**TINY, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        serve.Engine(model, buckets=(2,), device="meta")


@pytest.mark.parametrize("where,reason", [
    ("repo", "torch.cuda.is_available() is False"),
    ("alone", "No module named 'ddim_cold_torch'"),
])
def test_chip_smoke_fails_without_cuda_or_without_the_port(tmp_path, where, reason):
    """Beside the port and with no card, it stops at the CUDA check; alone,
    it stops importing the port."""
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=dict(env, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert reason in proc.stderr
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass


@pytest.mark.parametrize("name", ["dequant_mm", "mlp_fused", "fused_trunk"])
def test_quant_kernel_libraries_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load_library(name)


def _wrapper_calls(device):
    """Each new wrapper, called on tensors of ``device``."""
    from ddim_cold_torch.ops import flash_attention as fa
    from ddim_cold_torch.ops import quant

    x = torch.zeros((1, 4, 64), device=device)
    w = torch.zeros((64, 64), dtype=torch.int8, device=device)
    w3 = torch.zeros((192, 64), dtype=torch.int8, device=device)
    s, s3 = torch.ones(64, device=device), torch.ones(192, device=device)
    return {
        "dequant_mm": lambda: quant.dequant_mm(x[0], w, s),
        "mlp_fused": lambda: quant.mlp_fused(x, w, s, w, s, scale1=s, scale2=s,
                                             mode="pallas"),
        "fused_trunk": lambda: fa.fused_trunk_attention(
            x, w3, s3, None, w, s, None, num_heads=1, scale=1.0),
    }


@pytest.mark.parametrize("name", ["dequant_mm", "mlp_fused", "fused_trunk"])
def test_quant_wrappers_never_fall_back(no_cuda, name):
    """Off the CPU a wrapper launches its kernel or raises: a CUDA model
    request raises without CUDA, and a tensor on another device is refused
    rather than sent to the plain version."""
    with pytest.raises(RuntimeError, match="cuda"):
        DiffusionViT(**TINY, quant="pallas", fused=True)
    with pytest.raises(ValueError, match="runs on CUDA"):
        _wrapper_calls("meta")[name]()
    assert _wrapper_calls("cpu")[name]().device.type == "cpu"


# ------------------------------------------- fault sites and metric emits

#: the robustness layer's, the fleet's and the observability layer's
#: host-only modules: the fleet's router imports them in a process that
#: needs no device (of the fleet, only serve/backend.py touches torch, and
#: only inside a replica's child), and traces and bench series are read on
#: machines that never saw the device
HOST_ONLY = ("obs/metrics.py", "obs/spans.py", "utils/faults.py",
             "utils/watchdog.py", "serve/errors.py", "serve/router.py",
             "serve/fleet.py", "serve/remote.py", "serve/replica_main.py",
             "serve/autoscale.py", "utils/flops.py", "utils/record.py",
             "obs/attrib.py", "obs/trend.py", "data/native.py")


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _package_calls(attrs):
    """Every ``<obj>.<attr>(...)`` call in the package whose attribute is in
    ``attrs``: (relative path, line, attribute, first argument, key=)."""
    for f in sorted((ROOT / "ddim_cold_torch").rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func) or ""
            if "." not in name or name.split(".")[-1] not in attrs:
                continue
            first = node.args[0] if node.args else None
            key = next((kw.value for kw in node.keywords if kw.arg == "key"), None)
            yield (str(f.relative_to(ROOT)), node.lineno, name, first, key)


def test_fault_sites_are_registered_literals():
    """Every ``faults.fire`` site is a string literal in ``faults.SITES``,
    fired at one call site each: the engine's five ``serve.*`` sites, the
    router's placement, failover and spawn sites, the replica server's kill
    and hang, the RPC client's drop and latency, the loader's ``data.next``
    and the checkpoint writer's ``ckpt.save`` (one site, four windows)."""
    from ddim_cold_torch.utils import faults

    fired = []
    for rel, line, name, site, _ in _package_calls({"fire"}):
        if not name.endswith("faults.fire"):
            continue
        assert isinstance(site, ast.Constant) and isinstance(site.value, str), (rel, line)
        assert site.value in faults.SITES, (rel, line, site.value)
        fired.append(site.value)
    assert sorted(fired) == sorted(("serve.assemble", "serve.compile", "serve.dispatch",
                                    "serve.fetch", "serve.preview", "router.place",
                                    "router.failover", "replica.spawn", "replica.kill",
                                    "replica.hang", "rpc.drop", "rpc.latency",
                                    "data.next", "ckpt.save"))
    assert set(fired) == set(faults.SITES)


def test_metric_emits_are_registered_literals_at_one_site():
    """Every ``Scope.inc`` / ``gauge`` / ``observe`` passes a literal name
    registered in ``METRICS``; each (name, literal key) is emitted at one
    site (a dynamic key subdivides its one site); every registered name is
    emitted somewhere."""
    from ddim_cold_torch.obs import metrics

    registered = {name for name, _, _ in metrics.METRICS}
    assert len(registered) == len(metrics.METRICS)
    seen: dict = {}
    for rel, line, _, metric, key in _package_calls({"inc", "gauge", "observe"}):
        where = f"{rel}:{line}"
        assert isinstance(metric, ast.Constant) and isinstance(metric.value, str), where
        assert metric.value in registered, (where, metric.value)
        if key is not None and not isinstance(key, ast.Constant):
            pair = (metric.value, "<dynamic>")
        else:
            pair = (metric.value, None if key is None else key.value)
        assert pair not in seen, f"{pair} emitted at {seen.get(pair)} and {where}"
        seen[pair] = where
    assert {name for name, _ in seen} == registered


def test_host_only_modules_import_no_torch():
    """The host-only modules import no torch at module level, and importing
    those outside ``serve/`` loads no torch at all (a ``serve`` module
    loads the package's ``__init__``, which imports the engine; the
    ``data`` package's ``__init__`` imports the loader, so ``data/native.py``
    is loaded from its file)."""
    for rel in HOST_ONLY:
        tree = ast.parse((ROOT / "ddim_cold_torch" / rel).read_text())
        for node in tree.body:
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module
                    else [])
            assert not [m for m in mods if m.split(".")[0] == "torch"], rel
    code = ("import sys\nsys.path.insert(0, %r)\n" % str(ROOT)
            + "import importlib.util\n"
            + "".join(f"import ddim_cold_torch.{rel[:-3].replace('/', '.')}\n"
                      for rel in HOST_ONLY if not rel.startswith(("serve/", "data/")))
            + "".join(f"spec = importlib.util.spec_from_file_location('m', {str(ROOT / 'ddim_cold_torch' / rel)!r})\n"
                      "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
                      for rel in HOST_ONLY if rel.startswith("data/"))
            + "print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_robustness_slice_modules_are_checked():
    """The import checks walk the robustness layer's modules too."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/{m}" for m in HOST_ONLY} <= names


def test_fleet_slice_modules_are_checked():
    """The import checks walk the fleet's modules, ``serve/backend.py``
    (the one that imports torch) included."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/serve/{m}.py" for m in (
        "router", "fleet", "remote", "replica_main", "autoscale", "backend")} <= names
    assert "torch" in set(_imports(ROOT / "ddim_cold_torch/serve/backend.py"))


def test_replica_backend_needs_cuda_unless_told(no_cuda):
    """A replica spec without ``"device"`` builds its model on the card, and
    raises without one instead of serving on the CPU; ``"cpu"`` asks for
    the CPU."""
    from ddim_cold_torch.serve import backend

    spec = dict(TINY, img_size=[16, 16], dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        backend.build_model(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.build_local_replica("r0", {"backend": "engine", "model": spec})
    assert backend.build_model(dict(spec, device="cpu")).device.type == "cpu"


def test_engine_robustness_defaults_need_cuda(no_cuda, monkeypatch):
    """The new engine knobs keep ``device=None`` on the card: the engine
    raises without CUDA whatever they are set to."""
    monkeypatch.delenv("DDIM_COLD_SERVE_STALL_S", raising=False)
    model = DiffusionViT(**TINY, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.Engine(model, buckets=(2,), max_queue=4, stall_s=0.0, prefetch_depth=1)
    eng = serve.Engine(model, buckets=(2,), device="cpu")
    assert eng.stall_s == 0.0 and eng.inflight == 2 and eng.prefetch_depth == 2


# ------------------------------------------------------- profiler scopes

#: registered scopes the port plants nowhere, each with its reason
UNPLANTED_SCOPES = {
    # the JAX kernel writes f32 and casts under this scope; fused_trunk.cu
    # writes the compute dtype itself, so the scope would hold no device work
    "flash_attention/fused_proj": "no device work in the port",
}

#: the sequence-parallel scopes and the module that plants each
SP_SCOPES = {"sp/ring_exchange": "parallel/ring_attention.py",
             "sp/all_to_all_gather": "parallel/ulysses.py",
             "sp/all_to_all_scatter": "parallel/ulysses.py"}


def test_registered_scopes_are_planted_literals():
    """Every ``obs.attrib.REGISTERED_SCOPES`` entry but the unplanted one
    is the literal name of a ``profiling.scope("…")`` call in the port, and
    every planted name is registered: a renamed scope cannot drop out of
    attribution silently. The registry is JAX's, whole."""
    from ddim_cold_torch.obs import attrib
    from ddim_cold_tpu.obs import attrib as jax_attrib

    planted, where = set(), {}
    for rel, line, name, first, _ in _package_calls({"scope"}):
        if name.split(".")[-2:] != ["profiling", "scope"]:
            continue
        assert isinstance(first, ast.Constant) and isinstance(first.value, str), (rel, line)
        planted.add(first.value)
        where.setdefault(first.value, set()).add(rel)
    assert attrib.REGISTERED_SCOPES == jax_attrib.REGISTERED_SCOPES
    assert planted == set(attrib.REGISTERED_SCOPES) - set(UNPLANTED_SCOPES)
    assert set(UNPLANTED_SCOPES) <= set(attrib.REGISTERED_SCOPES)
    for scope, module in SP_SCOPES.items():
        assert where[scope] == {f"ddim_cold_torch/{module}"}, scope


def test_observability_modules_are_checked():
    """The import checks walk the observability layer's modules too."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/{m}" for m in (
        "utils/flops.py", "utils/record.py", "utils/profiling.py", "obs/attrib.py",
        "obs/trend.py")} <= names


# ------------------------------------------------------- parallel/


def test_parallel_slice_modules_are_checked():
    """The import checks walk ``parallel/`` and the rank cases' module."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/{m}.py" for m in (
        "parallel/__init__", "parallel/mesh", "parallel/ring_attention",
        "parallel/ulysses", "tools/dist_cases")} <= names


def test_parallel_never_changes_backend_or_device():
    """``parallel/`` holds no branch on the backend and no fallback: no
    ``get_backend`` call, no backend name outside ``initialize_distributed``
    (whose default is NCCL for a CUDA device, gloo for the CPU, and which
    otherwise takes the caller's), no copy through host memory (``.cpu()``
    or a ``"cpu"`` literal) and no ``except`` that could swallow a failed
    collective."""
    bad = []
    for f in sorted((ROOT / "ddim_cold_torch" / "parallel").rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        allowed = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == "initialize_distributed":
                allowed |= {id(n) for n in ast.walk(node)}
        for node in ast.walk(tree):
            if isinstance(node, ast.ExceptHandler):
                bad.append((f.name, node.lineno, "except"))
            elif isinstance(node, ast.Attribute) and node.attr in ("get_backend", "cpu"):
                bad.append((f.name, node.lineno, node.attr))
            elif isinstance(node, ast.Constant) and node.value in ("gloo", "nccl", "cpu"):
                if id(node) not in allowed or node.value == "cpu":
                    bad.append((f.name, node.lineno, node.value))
    assert bad == []


def test_initialize_distributed_needs_cuda_unless_told(no_cuda, tmp_path):
    """``device=None`` means the card: without CUDA the rendezvous is never
    attempted; a mesh in the trainer's config likewise."""
    from ddim_cold_torch.config import ExperimentConfig
    from ddim_cold_torch.parallel import initialize_distributed
    from ddim_cold_torch.train import trainer

    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed(init_method="tcp://localhost:9", world_size=2, rank=0)
    cfg = ExperimentConfig(exp_name="x", data_storage=(str(tmp_path), str(tmp_path)),
                           mesh={"data": 2})
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.run(cfg, str(tmp_path))


# ------------------------------------------------------------- commands

#: the commands that build a model, each with the arguments of a run that
#: asks for nothing but the default device
MODEL_COMMANDS = {
    "sample": ["--init-random", "--config", "vit_tiny", "--sample_n", "1"],
    "edit": ["--init-random", "--config", "vit_tiny", "--cold-n", "1"],
    "fid": ["--n-samples", "1"],
    "fid-trend": ["--n-samples", "1"],
    "publish": [],
    "obs-report": ["--demo"],
}
#: the commands that only read or write files (obs-report without --demo too)
HOST_COMMANDS = {"attrib-report", "make-dataset", "loader-check"}


def test_cli_slice_modules_are_checked():
    """The import checks walk every module of ``cli/`` and the new utils."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    cli_files = {str(f.relative_to(ROOT)) for f in (ROOT / "ddim_cold_torch/cli").glob("*.py")}
    assert len(cli_files) == 10 and cli_files <= names
    assert {"ddim_cold_torch/utils/image.py", "ddim_cold_torch/utils/run_io.py"} <= names


def test_tensor_and_pipeline_slice_modules_are_checked():
    """The import checks walk the tensor and pipeline parallelism modules:
    the shard plan, the pipeline executor and the layout selection."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    assert {f"ddim_cold_torch/parallel/{m}.py" for m in (
        "mesh", "sharding", "pipeline", "layout", "ring_attention", "ulysses")} <= names


def test_every_command_is_classified():
    from ddim_cold_torch import __main__ as cli

    assert set(cli.COMMANDS) == {"train"} | set(MODEL_COMMANDS) | HOST_COMMANDS


@pytest.mark.parametrize("name", sorted(MODEL_COMMANDS))
def test_model_commands_need_cuda_unless_told(no_cuda, name, tmp_path, monkeypatch, capsys):
    """Without CUDA and without the CPU flag a command that builds a model
    exits 3 with a message naming the flag, and writes nothing."""
    from ddim_cold_torch import __main__ as cli

    monkeypatch.chdir(tmp_path)
    assert cli.main([name] + MODEL_COMMANDS[name], base_dir=str(tmp_path)) == cli.NO_ACCELERATOR
    flag = "--cpu" if name in ("fid", "fid-trend", "publish") else "--device cpu"
    assert f"pass {flag}" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
