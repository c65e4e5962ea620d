"""The port's analysis layers on the port's own sources and kernels, on the
CPU.

* Seeded violations: for each rule of A, T, R and X, a real port module
  (``serve/router.py``, ``serve/remote.py``, ``serve/batching.py``,
  ``serve/engine.py``, ``models/vit.py``, ``ops/flash_attention.py``,
  ``chip_smoke.py``, the serve sweep) with one mutation gives exactly that
  rule, and the module as committed none. T005's mutation, a check-then-set
  moved out of its lock, is also a T001 (an unguarded write), as JAX's own
  T005 fixture pins.
* P on the CPU: every registered kernel entry (all six kernels at the main
  path's 200 px geometry and a small one each) passes P001–P003; the
  layer's own table agrees with the wgmma instructions and tile constants
  in ``csrc/`` and with the launch path's Python; its shared-memory
  arithmetic equals ``ops/tuning``'s at every entry; a regression in the
  launch path (a cluster of 6 in ``fused_geometry``, ``mlp_geometry``
  dropping the cluster) fires P001; and a deliberately illegal geometry
  fires each rule alone: an N tile of 264, a 4,096-key block at N = 2,501,
  a footprint of 232,449 B.
* The baseline's reviewed exception: R002's two rank errors, which no
  replica child can raise.
"""

import ast
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ddim_cold_torch.analysis import ast_checks as A
from ddim_cold_torch.analysis import config_checks as X
from ddim_cold_torch.analysis import entries as E
from ddim_cold_torch.analysis import kernel_checks as P
from ddim_cold_torch.analysis import protocol_checks as R
from ddim_cold_torch.analysis import thread_checks as T
from ddim_cold_torch.obs import metrics
from ddim_cold_torch.ops import flash_attention as fa
from ddim_cold_torch.ops import quant
from ddim_cold_torch.ops import tuning
from ddim_cold_torch.utils import faults

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "ddim_cold_torch" / "csrc"


def _lint(layer, src, rel):
    if layer == "ast":
        return A.lint_source(src, rel, sites=faults.SITES,
                             metric_names=[m[0] for m in metrics.METRICS],
                             host_only=rel in A.HOST_ONLY_MODULES)
    if layer == "threads":
        return T.lint_source(src, rel)
    if layer == "protocol":
        return R.lint_source(src, rel)
    return X.lint_config_source(src, rel)


#: rule → (layer, port module, text replaced, replacement, expected subject)
SEEDED = {
    "GRAFT-A001": ("ast", "ddim_cold_torch/models/vit.py",
                   "return F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))",
                   "return F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype)) "
                   "+ 0 * torch.rand(1)", "embed:torch.rand"),
    "GRAFT-A002": ("ast", "ddim_cold_torch/serve/router.py",
                   "        except Exception:  # noqa: BLE001 — a broken drain must not stop\n",
                   "        except Exception:\n", "_retire:except Exception"),
    "GRAFT-A003": ("ast", "ddim_cold_torch/serve/router.py",
                   'faults.fire("replica.spawn", tag=f"replica:{rid}|")',
                   'faults.fire("replica.spawned", tag=f"replica:{rid}|")',
                   "fire:replica.spawned"),
    "GRAFT-A004": ("ast", "ddim_cold_torch/serve/router.py",
                   '        self.metrics.inc("router.replicas_spawned")\n',
                   '        self.metrics.inc("router.replicas_spawned")\n'
                   "        import torch\n        torch.cuda.synchronize()\n",
                   "_spawn_replica:torch.cuda.synchronize"),
    "GRAFT-A005": ("ast", "ddim_cold_torch/serve/router.py",
                   'self.metrics.inc("router.replicas_retired")',
                   'self.metrics.inc("router.replicas_spawned")',
                   "metric:router.replicas_spawned"),
    # drop a lock
    "GRAFT-T001": ("threads", "ddim_cold_torch/serve/router.py",
                   "        with self._lock:\n            self._replicas[rid] = rep\n",
                   "        self._replicas[rid] = rep\n", "Router._spawn_replica:_replicas"),
    # the kernel loader (rank 40) called under a launch counter's lock (50)
    "GRAFT-T002": ("threads", "ddim_cold_torch/ops/flash_attention.py",
                   "    with _LAUNCH_LOCK:\n        LAUNCHES[name] += 1\n",
                   "    with _LAUNCH_LOCK:\n        LAUNCHES[name] += 1\n"
                   "        _build.load_library(name)\n",
                   "count_launch:_LAUNCH_LOCK>load_library()"),
    "GRAFT-T003": ("threads", "ddim_cold_torch/serve/router.py",
                   "            self._outstanding[freq.tenant] -= 1\n"
                   "        if freq.ticket._fail(exc):",
                   "            self._outstanding[freq.tenant] -= 1\n"
                   "            failed = freq.ticket._fail(exc)\n        if failed:",
                   "Router._fail_freq:_fail"),
    "GRAFT-T004": ("threads", "ddim_cold_torch/serve/router.py",
                   "        with self._lock:\n            self._closed = True\n        deadline",
                   "        with self._lock:\n            self._closed = True\n"
                   "            self._stop.wait(0.1)\n        deadline",
                   "Router.drain:wait"),
    "GRAFT-T005": ("threads", "ddim_cold_torch/serve/batching.py",
                   "        with self._lock:\n            if self._resolved:\n"
                   "                return False\n            if self._buf is None:\n"
                   "                self._buf = np.empty((self.n,) + rows.shape[1:], rows.dtype)\n",
                   "        if self._buf is None:\n"
                   "            self._buf = np.empty((self.n,) + rows.shape[1:], rows.dtype)\n"
                   "        with self._lock:\n            if self._resolved:\n"
                   "                return False\n", "Ticket._deliver:_buf"),
    # remove a table entry
    "GRAFT-R001": ("protocol", "ddim_cold_torch/serve/remote.py",
                   'CLIENT_METHODS = ("ping", "health", "start", "submit", "warm", "drain",',
                   'CLIENT_METHODS = ("ping", "health", "start", "submit", "drain",',
                   "CLIENT_METHODS:warm"),
    "GRAFT-R002": ("protocol", "ddim_cold_torch/serve/remote.py",
                   "                raise ReplicaCrashedError(\n                    "
                   'f"replica {self.replica_id} crashed: {self.crash_reason}")\n'
                   "            rid = self._next_rid",
                   "                raise BogusError(\n                    "
                   'f"replica {self.replica_id} crashed: {self.crash_reason}")\n'
                   "            rid = self._next_rid", "RemoteReplica.submit:BogusError"),
    # reorder the rid registration after the send
    "GRAFT-R003": ("protocol", "ddim_cold_torch/serve/remote.py",
                   '            self._tickets[rid] = ticket\n        params["rid"] = rid\n'
                   '        try:\n            self._call("submit", params)\n',
                   '        params["rid"] = rid\n        try:\n'
                   '            self._call("submit", params)\n'
                   "            self._tickets[rid] = ticket\n", "RemoteReplica.submit"),
    "GRAFT-R004": ("protocol", "ddim_cold_torch/serve/remote.py",
                   "    if length > MAX_FRAME_BYTES:\n"
                   '        raise RemoteRPCError(f"frame length {length} exceeds "\n'
                   '                             f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")\n',
                   "", "recv_frame:unchecked-length"),
    "GRAFT-R005": ("protocol", "ddim_cold_torch/serve/remote.py",
                   '        faults.fire("rpc.latency", tag=tag)\n', "", "rpc.latency"),
    "GRAFT-X002": ("config", "ddim_cold_torch/serve/engine.py",
                   "        if config is None:\n",
                   '        object.__setattr__(config, "quant", "xla")\n'
                   "        if config is None:\n", "bypass:quant"),
}


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_seeded_violation_in_a_port_module_fires_that_rule(rule, tmp_path):
    layer, rel, old, new, subject = SEEDED[rule]
    source = (ROOT / rel).read_text()
    assert source.count(old) == 1, (rel, old)
    copy = tmp_path / Path(rel).name
    copy.write_text(source.replace(old, new))
    assert _lint(layer, source, rel) == []
    found = {(f.rule, f.subject) for f in _lint(layer, copy.read_text(), rel)}
    also = {("GRAFT-T001", subject)} if rule == "GRAFT-T005" else set()
    assert found == {(rule, subject)} | also


def test_seeded_x001_a_sweep_without_its_cold_sequence_witness():
    sweep = [row for row in E.serve_sweep() if row[0] != "superres_l3_pv1"]
    assert X.check_sweep_completeness(E.serve_sweep()) == []
    fs = X.check_sweep_completeness(sweep)
    assert [(f.rule, f.path, f.subject) for f in fs] == [
        ("GRAFT-X001", "ddim_cold_torch/analysis/entries.py", "class:cold/seq")]


def test_seeded_x003_an_illegal_config_in_a_copy_of_chip_smoke(tmp_path):
    source = (ROOT / "chip_smoke.py").read_text()
    site = "config = serve.SamplerConfig(k=K)"
    line = source[:source.index(site)].count("\n") + 1
    (tmp_path / "chip_smoke.py").write_text(
        source.replace(site, "config = serve.SamplerConfig(k=K, sp_degree=3)", 1))
    assert X.check_warmup_soundness(root=str(ROOT)) == []
    fs = X.check_warmup_soundness(root=str(tmp_path))
    assert [(f.rule, f.subject) for f in fs] == [("GRAFT-X003", f"chip_smoke.py:{line}")]


def test_a004_list_reconciles_the_hygiene_tests_host_only_modules():
    """The A004 set is JAX's eleven modules' counterparts and the hygiene
    test's host-only ones; ``serve/fleet.py`` is the one exception: the
    hygiene test holds it to no torch at import, A004 would refuse the
    torch.distributed group it creates for replicas across ranks."""
    tree = ast.parse((ROOT / "tests" / "test_torch_port_hygiene.py").read_text())
    hygiene = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "HOST_ONLY")
    port = {m.removeprefix("ddim_cold_torch/") for m in A.HOST_ONLY_MODULES}
    jax_eleven = {"serve/batching.py", "serve/fleet.py", "serve/router.py", "obs/metrics.py",
                  "obs/spans.py", "obs/device.py", "obs/attrib.py", "obs/trend.py",
                  "serve/remote.py", "serve/autoscale.py", "serve/replica_main.py"}
    assert port == (jax_eleven | set(hygiene)) - {"serve/fleet.py"}
    assert "torch" in (ROOT / "ddim_cold_torch/serve/fleet.py").read_text()


def test_new_locks_are_ranked():
    """The port's locks beyond JAX's have ranks: the fleet's factory lock,
    the engine's start-draw lock, the kernel loader's per-library locks and
    the launch counters' locks, in that order after the router's."""
    ranks = T.LOCK_RANKS
    order = ["ddim_cold_torch/serve/router.py::_lock", "ddim_cold_torch/serve/fleet.py::lock",
             "ddim_cold_torch/serve/engine.py::_lock",
             "ddim_cold_torch/serve/engine.py::_init_lock",
             "ddim_cold_torch/ops/_build.py::_locks",
             "ddim_cold_torch/ops/flash_attention.py::_LAUNCH_LOCK"]
    assert [ranks[k] for k in order] == sorted(ranks[k] for k in order)
    assert ranks["ddim_cold_torch/ops/quant.py::_LAUNCH_LOCK"] == \
        ranks["ddim_cold_torch/ops/flash_attention.py::_LAUNCH_LOCK"]
    assert {"ddim_cold_torch/ops/_build.py", "ddim_cold_torch/ops/flash_attention.py",
            "ddim_cold_torch/ops/quant.py"} <= set(T.HOST_THREADED_MODULES)


# ------------------------------------------------------------------- P


ENTRIES = E.kernel_entries()


def _entry(name):
    return next(e for e in ENTRIES if e.name == name)


def test_entries_cover_every_kernel_at_the_main_path_and_small():
    kernels = {e.kernel for e in ENTRIES}
    assert kernels == set(E.KERNELS) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                         "fused_trunk", "dequant_mm", "mlp_fused"}
    for kernel in kernels:
        logical = {e.logical for e in ENTRIES if e.kernel == kernel}
        assert None in logical and logical - {None}, kernel
    assert {e.logical for e in ENTRIES if e.kernel.startswith(("flash", "fused"))} == \
        {2501, 626, None}
    assert {e.logical for e in ENTRIES if e.kernel in ("dequant_mm", "mlp_fused")} == \
        {8 * 2501, None}


@pytest.mark.parametrize("name", [e.name for e in ENTRIES])
def test_every_entry_passes_p001_to_p003(name):
    entry = _entry(name)
    launch = P.predict(entry)
    assert P.check_entry(entry, launch) == []
    assert all(type(g) is int for g in launch.grid)
    assert P.smem_budget() == 232_448 >= launch.smem


def _csrc_int(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())[1])


def test_tile_table_agrees_with_the_sources_and_the_launch_path():
    assert _csrc_int("attn_wgmma.cuh", "kThreads") == P.WARPGROUP
    assert [_csrc_int("gemm_wgmma.cuh", k) for k in ("kGroups", "kBN", "kBK", "kMaxStages")] \
        == [P.GM_THREADS // P.WARPGROUP, P.GM_BN, P.GM_BK, P.GM_MAX_STAGES]
    assert _csrc_int("fused_trunk.cu", "kGroups") * 64 == P.FUSED_ROWS
    assert _csrc_int("fused_trunk.cu", "kCluster") * fa.FUSED_ROWS == \
        P.FUSED_ROWS * P.FUSED_CLUSTER == fa.FUSED_ROWS * fa.FUSED_CLUSTER
    assert quant.MLP_ROWS[torch.bfloat16] == P.GM_ROWS
    assert tuning.DEQUANT_TILES[torch.bfloat16] == (P.GM_ROWS, P.GM_BN, P.GM_BK)
    assert tuning.ATTN_TILES[torch.bfloat16] == (P.FUSED_ROWS, P.FUSED_ROWS)


def _instruction_shapes():
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    found = re.findall(r"wgmma\.mma_async\.sync\.aligned\.m(\d+)n(\d+)k(\d+)\.\w+\.(\w+)\.",
                       text)
    names = {"bf16": "bfloat16", "s8": "int8"}
    return {(int(m), int(n), int(k), names[t]) for m, n, k, t in found}


def _every_instantiation():
    """An entry per kernel instantiation the launch path reaches in
    bfloat16: head dims 32 and 64, each mode."""
    out = []
    for D in (32, 64):
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            out.append(E.KernelEntry(f"{kernel}_d{D}", kernel, dict(B=1, N=300, H=2, D=D)))
        for mode in ("pallas", "w8a8"):
            out.append(E.KernelEntry(f"fused_{mode}_d{D}", "fused_trunk", dict(
                B=1, N=300, C=4 * D, H=4, block_q=128, mode=mode)))
    out.append(E.KernelEntry("dequant", "dequant_mm", dict(M=300, K=64, N=64)))
    for mode in (None, "pallas", "w8a8"):
        out.append(E.KernelEntry(f"mlp_{mode}", "mlp_fused", dict(
            M=300, K=64, hidden=64, Nout=64, mode=mode, block_m=64)))
    return out


def test_wgmma_tiles_are_the_instructions_in_the_sources():
    """Every wgmma shape the table says a kernel runs is an instruction
    the sources hold, and every instruction in the sources is one the
    table knows (over head dims 32 and 64 and every mode)."""
    tiles = {(t.m, t.n, t.k, t.dtype) for e in _every_instantiation()
             for t in P.predict(e).tiles}
    assert tiles == _instruction_shapes()
    assert all(P.check_legality(P.predict(e)) == [] for e in _every_instantiation())


@pytest.mark.parametrize("name", [e.name for e in ENTRIES
                                  if e.kernel in ("fused_trunk", "mlp_fused", "dequant_mm")])
def test_p002_arithmetic_is_tunings(name):
    entry = _entry(name)
    s, bf = entry.shape, torch.bfloat16
    launch = P.predict(entry)
    if entry.kernel == "fused_trunk":
        want = tuning.attn_smem_bytes(s["C"], s["H"], bf, s["mode"])
    elif entry.kernel == "mlp_fused":
        want = tuning.mlp_smem_bytes(s["K"], s["hidden"], s["Nout"], bf, s["mode"])
    else:
        want = tuning.dequant_smem_bytes(s["N"], quant.bf16_row_layout(s["K"], s["K"], 0)[0], bf)
    assert launch.smem == want


def test_p001_catches_a_regression_in_the_launch_paths_python(monkeypatch):
    """A cluster of 6 in fused_geometry pads 2,501 rows to 2,688, no whole
    number of the kernel's 512-row clusters; an mlp_geometry that forgets
    the cluster hands the w8a8 kernel rows that are no whole number of its
    requant tiles."""
    monkeypatch.setattr(fa, "FUSED_CLUSTER", 6)
    fs = P.check_entry(_entry("fused200_w8a16"))
    assert {(f.rule, f.subject) for f in fs} == {("GRAFT-P001", "fused200_w8a16:extent:queries")}
    monkeypatch.undo()
    monkeypatch.setattr(quant, "mlp_geometry", lambda M, bm, cta: (M, 1))
    fs = P.check_entry(_entry("mlp200_w8a8"))
    assert {(f.rule, f.subject) for f in fs} == {
        ("GRAFT-P001", "mlp200_w8a8:extent:rows"),
        ("GRAFT-P001", "mlp200_w8a8:extent:requant tiles")}


def test_p001_a_geometry_the_launch_path_refuses():
    entry = dataclasses.replace(_entry("fused200_w8a8"),
                                shape=dict(_entry("fused200_w8a8").shape, block_q=96))
    assert [(f.rule, f.subject) for f in P.check_entry(entry)] == [
        ("GRAFT-P001", "fused200_w8a8:refused")]


LAUNCH = P.predict(_entry("fused200_w8a16"))
BAD_TILE = P.Tile("x", 64, 264, 16, "bfloat16", 256)


@pytest.mark.parametrize("change,subject", [
    (dict(tiles=(BAD_TILE,)), "tile:x"),
    (dict(tiles=(dataclasses.replace(BAD_TILE, n=128, m=32),)), "tile:x"),
    (dict(tiles=(dataclasses.replace(BAD_TILE, n=128, k=32),)), "tile:x"),
    (dict(tiles=(dataclasses.replace(BAD_TILE, n=128, reduction=40),)), "tile:x"),
    (dict(threads=96), "threads"),
    (dict(threads=2048), "threads"),
    (dict(grid=(np.int64(20), 8, 1)), "grid"),
    (dict(grid=(20, 70_000, 1)), "grid"),
    (dict(async_rows=(("x row", 72),)), "async:x row"),
    (dict(extents=(P.Extent("queries", 2501, 2600, 512),)), "extent:queries")])
def test_p001_fires_alone_on_an_illegal_launch(change, subject):
    launch = dataclasses.replace(LAUNCH, **change)
    fs = P.check_legality(launch) + P.check_fit(launch) + P.check_padding_waste(launch, 2501)
    assert [(f.rule, f.subject) for f in fs] == [("GRAFT-P001", f"fused200_w8a16:{subject}")]


ATTRS = {"shared": 0, "regs": 128, "local": 0, "max_threads": 1024, "blocks_per_sm": 1}


@pytest.mark.parametrize("smem,attrs,subject", [
    (232_449, None, "smem"),
    (232_448, dict(ATTRS, shared=1), "smem"),
    (LAUNCH.smem, dict(ATTRS, regs=256), "regs"),
    (LAUNCH.smem, dict(ATTRS, local=16), "spill"),
    (LAUNCH.smem, dict(ATTRS, max_threads=128), "threads"),
    (LAUNCH.smem, dict(ATTRS, blocks_per_sm=0), "occupancy")])
def test_p002_fires_alone_on_an_illegal_fit(smem, attrs, subject):
    launch = dataclasses.replace(LAUNCH, smem=smem)
    fs = P.check_legality(launch) + P.check_fit(launch, attrs)
    assert [(f.rule, f.subject) for f in fs] == [("GRAFT-P002", f"fused200_w8a16:{subject}")]
    assert P.check_fit(dataclasses.replace(LAUNCH, threads=512), dict(ATTRS, regs=129)) \
        and not P.check_fit(dataclasses.replace(LAUNCH, threads=512), dict(ATTRS, regs=128))


def test_p003_reads_the_tile_the_kernel_uses_not_the_nominal_block():
    """The model's fused attention asks for JAX's (512, 4096) blocks; the
    card kernel streams 128-key slices, so 2,501 keys cost 2,560 (2.4%).
    A kernel that padded them to the 4,096 block would waste 64%: P003."""
    assert tuning.attn_blocks(2501, 256, 4, torch.int8, device_kind=P.DEVICE_KIND) == \
        fa.NS_FLASH_BLOCKS == (512, 4096)
    keys = {e.axis: e for e in LAUNCH.extents}["keys"]
    assert (keys.padded, keys.tile) == (2560, P.FUSED_ROWS)
    assert P.check_padding_waste(LAUNCH, 2501) == []
    nominal = dataclasses.replace(LAUNCH, extents=(P.Extent("keys", 2501, 4096, 4096),))
    fs = P.check_legality(nominal) + P.check_fit(nominal) + P.check_padding_waste(nominal, 2501)
    assert [(f.rule, f.subject) for f in fs] == [("GRAFT-P003", "fused200_w8a16:pad")]
    assert "64%" in fs[0].message and math.isclose(4096 / 2501, 1.6377, abs_tol=1e-4)
    # a test geometry registers no logical extent: its padding costs no serving time
    assert P.check_padding_waste(nominal, None) == []


def test_persistent_dequant_grid_follows_the_cards_sms():
    entry = _entry("dequant200_qkv")
    assert P.predict(entry).grid == (132, 1, 1)
    assert P.predict(entry, sms=114).grid == (114, 1, 1)  # an H100 PCIe's
    assert P.predict(_entry("dequant_small"), sms=114).grid == (1, 1, 1)
    assert P.blocks_per_sm(P.predict(entry).smem, P.GM_THREADS) == 1


def test_r002_rank_errors_are_the_reviewed_exception():
    """R002 finds two classes of ``serve/errors.py`` outside the wire codec,
    the engine across ranks' ``RankFailedError`` and ``RankLostError``, and
    the baseline holds exactly those two. They cannot reach the wire: only
    ``Engine(mesh=)`` raises them, and a replica child builds its engine
    from a JSON spec (``serve/backend.build_local_replica``), which holds
    no mesh; the table stays JAX's (``tests/test_torch_port_remote.py::
    test_wire_types_match_jax``). A class that could cross it would fire
    R002 the same way."""
    from ddim_cold_torch.analysis import cli
    from ddim_cold_torch.analysis.findings import load_baseline
    from ddim_cold_torch.serve import errors

    fs = R._check_wire_roundtrip()
    assert sorted(f.subject for f in fs) == ["unregistered:RankFailedError",
                                            "unregistered:RankLostError"]
    assert {f.key for f in fs} == load_baseline(cli.DEFAULT_BASELINE)
    assert type(errors.decode_exception(errors.encode_exception(
        errors.RankLostError("x")))) is errors.RequestFailedError
    backend = ast.parse((ROOT / "ddim_cold_torch/serve/backend.py").read_text())
    calls = [n for n in ast.walk(backend) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "Engine"]
    assert len(calls) == 1 and "mesh" not in {k.arg for k in calls[0].keywords}
