"""The port's out-of-process replicas (``serve/remote.py``,
``serve/replica_main.py``, ``serve/backend.py``) against the JAX package's.

The wire is held to JAX's byte for byte: ``encode_payload`` gives the same
bytes for the same message, a frame written by either package's
``send_frame`` is read by the other's ``recv_frame``, and the exception
codec gives the same dicts and decodes the other side's to the same class,
message and cause. ``stub_rows`` are JAX's; a tree JAX's
``save_params_npz`` wrote loads into a port replica whose forward is JAX's
within ``tests/test_torch_port_model.py``'s float32 tolerance.

The process tests lift ``tests/test_remote_replica.py``: stub children
(``StubEngine``: the replica surface without a model) for the protocol and
chaos cases — a real SIGKILL, a wedged reader, dropped frames — and one
ENGINE child on the CPU (``"device": "cpu"``) whose rows are bitwise the
parent's direct call at bucket 8. Children run one intra-op thread, as the
parent's direct calls here do. The ``reaper`` fixture kills every child a
test spawned.
"""

import ast
import json
import os
import socket
import struct
import subprocess
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import DiffusionViT
from ddim_cold_torch.ops import sampling
from ddim_cold_torch.serve import backend, errors, fleet, remote, replica_main
from ddim_cold_torch.serve.batching import SamplerConfig
from ddim_cold_torch.serve.errors import (DeadlineExceeded, EngineClosedError,
                                          RemoteRPCError, ReplicaCrashedError,
                                          ReplicaUnreachableError,
                                          RequestFailedError, decode_exception,
                                          encode_exception)
from ddim_cold_torch.serve.router import Router
from ddim_cold_torch.utils import faults
from ddim_cold_tpu.models import DiffusionViT as JaxViT
from ddim_cold_tpu.serve import errors as jax_errors
from ddim_cold_tpu.serve import remote as jax_remote
from ddim_cold_tpu.serve import replica_main as jax_replica_main
from ddim_cold_tpu.utils import faults as jax_faults

ROOT = Path(__file__).resolve().parents[1]
CFG = SamplerConfig(k=50)
STUB_SHAPE = (8, 8, 3)
TINY = dict(img_size=(16, 16), patch_size=8, embed_dim=32, depth=2, num_heads=4,
            total_steps=2000)
K = 500
#: children compute on one intra-op thread (the parent's direct calls too)
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def clean_state():
    for f in (faults, jax_faults):
        assert not f.active(), "a previous test leaked an armed fault scope"
    yield
    for f in (faults, jax_faults):
        assert not f.active(), "this test leaked an armed fault scope"


@pytest.fixture()
def reaper():
    """Track spawned handles; no child process outlives a test."""
    handles = []
    yield handles
    for rep in handles:
        try:
            rep.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        try:
            rep._proc.kill()
            rep._proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 — already gone is fine
            pass


def _spawn(reaper, spec=None, env=None, **kw):
    kw.setdefault("heartbeat_s", 0.3)
    kw.setdefault("miss_budget", 3)
    kw.setdefault("rpc_timeout_s", 10.0)
    factory = remote.remote_factory(dict({"backend": "stub"}, **(spec or {})),
                                    env=dict(CHILD_ENV, **(env or {})), **kw)
    rep = factory("rk")
    reaper.append(rep)
    return rep


def _poll(fn, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


# ------------------------------------------------------------ wire protocol

_MESSAGES = {
    "submit": {"id": 3, "method": "submit",
               "params": {"seed": 7, "n": 3, "rid": 0,
                          "x_init": np.arange(12, dtype=np.float32).reshape(3, 4),
                          "mask": np.ones((2, 2), dtype=bool),
                          "nested": {"w": np.float64(2.5), "k": np.int64(9),
                                     "b": np.bool_(True)},
                          "config": {"k": 20, "t_start": None, "task": "sample"},
                          "plain": [1, "two", None, 3.0, "ü"]}},
    "ticket": {"event": "ticket", "rid": 4, "status": "done",
               "result": np.linspace(0, 1, 2 * 8 * 8 * 3, dtype=np.float32)
               .reshape(2, 8, 8, 3)},
    "preview": {"event": "preview", "rid": 1, "step": 10,
                "rows": np.zeros((1, 4, 4, 3), np.float32)},
    "arrays": {"a": [np.zeros((0,), np.int32), np.arange(5, dtype=np.uint8),
                     np.full((2, 3), -1, np.int64), np.eye(2, dtype=np.float64)]},
    "error": {"id": 9, "ok": False,
              "error": {"type": "QueueFullError", "message": "full",
                        "causes": [{"type": "TimeoutError", "message": "t"}]}},
}


@pytest.mark.parametrize("name", sorted(_MESSAGES))
def test_payload_bytes_match_jax(name):
    """The same message encodes to the same bytes in both packages, and
    each decodes the other's payload to the same tree."""
    msg = _MESSAGES[name]
    got = remote.encode_payload(msg)
    assert got == jax_remote.encode_payload(msg)
    back, jback = remote.decode_payload(got), jax_remote.decode_payload(got)
    assert remote.encode_payload(back) == got == jax_remote.encode_payload(jback)


def test_frames_cross_packages_and_eof_is_connection_error():
    a, b = socket.socketpair()
    try:
        rows = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
        jax_remote.send_frame(a, {"event": "ticket", "rid": 1, "result": rows})
        msg = remote.recv_frame(b)
        assert msg["event"] == "ticket" and msg["rid"] == 1
        np.testing.assert_array_equal(msg["result"], rows)
        remote.send_frame(b, {"id": 2, "ok": True, "result": {"rows": rows}})
        back = jax_remote.recv_frame(a)
        assert back["id"] == 2 and back["ok"]
        np.testing.assert_array_equal(back["result"]["rows"], rows)
        a.close()
        with pytest.raises(ConnectionError):
            remote.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_payload_garbage_is_typed():
    with pytest.raises(RemoteRPCError, match="truncated"):
        remote.decode_payload(b"\x00")
    with pytest.raises(RemoteRPCError, match="exceeds payload"):
        remote.decode_payload(struct.pack(">I", 99) + b"{}")
    head = json.dumps({"msg": {"__nd__": 0},
                       "arrays": [{"shape": [4], "dtype": "float32"}]}).encode()
    with pytest.raises(RemoteRPCError, match="past payload end"):
        remote.decode_payload(struct.pack(">I", len(head)) + head + b"\x00" * 8)


def test_wire_types_match_jax():
    assert sorted(errors._wire_types()) == sorted(jax_errors._wire_types())
    assert issubclass(ReplicaUnreachableError, ConnectionError)
    assert issubclass(ReplicaCrashedError, EngineClosedError)
    assert isinstance(ReplicaUnreachableError("x"), errors.RETRYABLE_EXCEPTIONS)


@pytest.mark.parametrize("name", sorted(errors._wire_types()))
def test_exception_codec_matches_jax(name):
    """For every wire type: the same dict from both encoders (with a cause
    chain), and each package decodes the other's dict to the same class
    name, message and causes."""
    def chain(types):
        exc = types[name](f"{name} on replica 'r0'")
        exc.__cause__ = types["TimeoutError"]("socket timed out")
        exc.__cause__.__cause__ = types["TransientFault"]("injected")
        return exc

    port = encode_exception(chain(errors._wire_types()))
    assert port == jax_errors.encode_exception(chain(jax_errors._wire_types()))
    chains = []
    for decoded in (decode_exception(port), jax_errors.decode_exception(port)):
        names, node = [], decoded
        while node is not None:
            names.append((type(node).__name__, str(node)))
            node = node.__cause__
        chains.append(names)
    assert chains[0] == chains[1]
    assert [n for n, _ in chains[0]] == [name, "TimeoutError", "TransientFault"]
    # the decoded exception is built from the message (KeyError's str quotes it)
    assert chains[0][0][1] == str(errors._wire_types()[name](port["message"]))
    assert chains[0][1:] == [("TimeoutError", "socket timed out"),
                             ("TransientFault", "injected")]


def test_unknown_exception_type_decodes_typed():
    for decode in (decode_exception, jax_errors.decode_exception):
        back = decode({"type": "WeirdVendorError", "message": "boom"})
        assert type(back).__name__ == "RequestFailedError"
        assert "[WeirdVendorError]" in str(back) and "boom" in str(back)
    assert isinstance(decode_exception({"type": "Nope"}), RequestFailedError)


def test_protocol_tables_match_jax_and_the_code():
    """The method and event tables are JAX's, client and server agree, and
    every ``_call`` / ``send({"event": ...})`` literal is in its table."""
    assert remote.CLIENT_METHODS == jax_remote.CLIENT_METHODS
    assert replica_main.SERVER_METHODS == jax_replica_main.SERVER_METHODS
    assert set(remote.CLIENT_METHODS) == set(replica_main.SERVER_METHODS)
    assert set(replica_main.SERVER_EVENTS) <= set(remote.CLIENT_EVENT_ARMS)

    def literals(path, attr):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == attr and node.args):
                yield node.args[0]

    calls = {a.value for a in literals(ROOT / "ddim_cold_torch/serve/remote.py", "_call")
             if isinstance(a, ast.Constant)}
    assert calls == set(remote.CLIENT_METHODS)
    events = {v.value for d in literals(ROOT / "ddim_cold_torch/serve/replica_main.py", "send")
              if isinstance(d, ast.Dict)
              for k, v in zip(d.keys, d.values)
              if isinstance(k, ast.Constant) and k.value == "event"}
    assert events == set(replica_main.SERVER_EVENTS)


@pytest.mark.parametrize("seed,n,shape", [(7, 3, (8, 8, 3)), (None, 2, (4, 4, 3)),
                                          (2**31 + 5, 1, (2, 2, 1))])
def test_stub_rows_match_jax(seed, n, shape):
    np.testing.assert_array_equal(replica_main.stub_rows(seed, n, shape),
                                  jax_replica_main.stub_rows(seed, n, shape))


def test_params_npz_round_trip(tmp_path):
    params = {"encoder": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                          "b": np.zeros((3,), np.float32)},
              "head": {"scale": np.float32(0.5)}}
    path = remote.save_params_npz(str(tmp_path / "p.npz"), params)
    back = remote.load_params_npz(path)
    np.testing.assert_array_equal(back["encoder"]["w"], params["encoder"]["w"])
    np.testing.assert_array_equal(back["head"]["scale"], 0.5)
    jback = jax_remote.load_params_npz(path)
    np.testing.assert_array_equal(jback["encoder"]["b"], back["encoder"]["b"])


def test_jax_params_npz_loads_into_a_port_replica(tmp_path):
    """A TINY float tree saved by JAX's ``save_params_npz`` becomes a port
    replica whose forward is JAX's within the float32 forward tolerance of
    tests/test_torch_port_model.py (rtol 2e-4, atol 2e-5)."""
    jm = JaxViT(**TINY)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                                    jnp.zeros((2,), jnp.int32))["params"])
    path = jax_remote.save_params_npz(str(tmp_path / "params.npz"), params)
    spec = {"backend": "engine", "params_npz": path, "engine": {"buckets": [8]},
            "model": dict(TINY, img_size=[16, 16], dtype="float32", device="cpu")}
    rep = backend.build_local_replica("r0", spec)
    assert rep.replica_id == "r0" and rep.engine.buckets == (8,)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    t = rs.randint(0, 2000, size=(2,)).astype(np.int32)
    with torch.no_grad():
        got = rep.engine.model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_backend_seeded_init_is_the_port_models():
    """``init_seed`` draws the port's seeded init: the replica's weights
    are those of ``DiffusionViT(seed=...)``, bit for bit."""
    rep = backend.build_local_replica("r1", {
        "backend": "engine", "init_seed": 3, "engine": {"buckets": [8]},
        "model": dict(TINY, img_size=[16, 16], dtype="float32", device="cpu")})
    want = DiffusionViT(**TINY, device="cpu", seed=3).state_dict()
    got = rep.engine.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ----------------------------------------------------------- the stub child


def test_stub_subprocess_serves_bitwise_and_reports_health(reaper):
    rep = _spawn(reaper, spec={"stub": {"shape": list(STUB_SHAPE)}})
    rep.warm([CFG], buckets=(4, 8))
    rep.start()
    rows = rep.submit(seed=7, n=3).result(timeout=15)
    np.testing.assert_array_equal(rows, replica_main.stub_rows(7, 3, STUB_SHAPE))
    h = rep.health()
    assert h["state"] == fleet.READY and h["programs_after_warmup"] == 0
    assert h["programs"] == 2 and h["spawn_s"] > 0 and h["warm_s"] > 0
    rep.drain(timeout=10)
    assert rep.state == fleet.CLOSED
    assert rep._proc.poll() is not None, "drained child still running"


def test_kill_mid_batch_fails_queued_tickets_typed(reaper):
    """A real SIGKILL inside the child with two tickets queued: the
    in-flight RPC and both tickets resolve typed, naming the replica."""
    rep = _spawn(reaper, spec={"stub": {"delay_s": 0.5}},
                 env={"DDIM_COLD_FAULTS": "replica.kill:kill:at=2"})
    rep.warm([CFG], buckets=(4,))
    rep.start()
    t1 = rep.submit(seed=1, n=2)
    t2 = rep.submit(seed=2, n=2)
    with pytest.raises((ReplicaCrashedError, ReplicaUnreachableError)):
        rep.submit(seed=3, n=1)
    for e in (t1.exception(timeout=15), t2.exception(timeout=15)):
        assert isinstance(e, ReplicaCrashedError), e
        assert "rk" in str(e)
    assert _poll(lambda: rep.state == fleet.CLOSED)
    assert "exited" in rep.crash_reason or "connection lost" in rep.crash_reason
    assert rep.crashed_at is not None
    assert rep.drain(timeout=5).get("crashed") is True


def test_heartbeat_loss_retires_hung_replica(reaper):
    """``replica.hang`` wedges the child's reader: pings go unanswered, the
    miss budget empties, the handle closes and the live child is killed."""
    rep = _spawn(reaper, spec={"stub": {}},
                 env={"DDIM_COLD_FAULTS": "replica.hang:hang:at=0,hang_s=60"},
                 heartbeat_s=0.15, miss_budget=3)
    rep.warm([CFG], buckets=(4,))
    rep.start()
    with pytest.raises(ReplicaCrashedError, match="heartbeat"):
        rep.submit(seed=0, n=1)
    assert rep.state == fleet.CLOSED and "heartbeat lost" in rep.crash_reason
    assert _poll(lambda: rep._proc.poll() is not None), \
        "heartbeat-loss crash leaked a live child process"
    rep.drain(timeout=5)


def test_deadline_enforced_across_the_rpc_boundary(reaper):
    rep = _spawn(reaper, spec={"stub": {"delay_s": 0.5}})
    rep.warm([CFG], buckets=(4,))
    rep.start()
    exc = rep.submit(seed=0, n=1, deadline_s=0.05).exception(timeout=15)
    assert isinstance(exc, DeadlineExceeded), exc
    rep.drain(timeout=10)


def test_rpc_drop_turns_into_unreachable_at_the_deadline(reaper):
    rep = _spawn(reaper, spec={"stub": {}}, rpc_timeout_s=0.5)
    rep.warm([CFG], buckets=(4,))
    rep.start()
    with faults.inject(faults.FaultSpec(site="rpc.drop", kind="transient",
                                        match="method:health")) as plan:
        with pytest.raises(ReplicaUnreachableError, match="deadline"):
            rep.health()
    assert plan.by_site() == {"rpc.drop": 1}
    assert rep.health()["state"] == fleet.READY
    rep.drain(timeout=10)


def test_oversized_submit_rejected_locally_replica_survives(reaper, monkeypatch):
    rep = _spawn(reaper, spec={"stub": {"shape": list(STUB_SHAPE)}})
    rep.warm([CFG], buckets=(4,))
    rep.start()
    monkeypatch.setattr(remote, "MAX_FRAME_BYTES", 4096)
    with pytest.raises(RemoteRPCError, match="MAX_FRAME_BYTES"):
        rep.submit(seed=0, n=1, x_init=np.zeros((1, 64, 64, 3), np.float32))
    monkeypatch.setattr(remote, "MAX_FRAME_BYTES", 1 << 30)
    assert rep.health()["state"] == fleet.READY
    np.testing.assert_array_equal(rep.submit(seed=5, n=2).result(timeout=15),
                                  replica_main.stub_rows(5, 2, STUB_SHAPE))
    rep.drain(timeout=10)


class _FakeProc:
    """Popen lookalike for driving a RemoteReplica against a socketpair."""

    def __init__(self):
        self._dead = threading.Event()

    def wait(self, timeout=None):
        if not self._dead.wait(timeout):
            raise subprocess.TimeoutExpired("fake-replica", timeout)
        return 0

    def poll(self):
        return 0 if self._dead.is_set() else None

    def kill(self):
        self._dead.set()


def test_done_event_racing_ahead_of_submit_response_still_resolves():
    """The client registers the rid before the submit frame leaves, so a
    done event that beats the submit response still finds its ticket."""
    parent, child = socket.socketpair()
    proc = _FakeProc()
    rep = remote.RemoteReplica(parent, proc, replica_id="race", heartbeat_s=60.0)
    try:
        rep.state = fleet.READY
        rows = replica_main.stub_rows(3, 2, STUB_SHAPE)

        def server():
            msg = remote.recv_frame(child)
            rid = msg["params"]["rid"]
            remote.send_frame(child, {"event": "ticket", "rid": rid,
                                      "status": "done", "result": rows})
            remote.send_frame(child, {"id": msg["id"], "ok": True,
                                      "result": {"rid": rid, "n": 2}})

        th = threading.Thread(target=server, daemon=True)
        th.start()
        np.testing.assert_array_equal(rep.submit(seed=3, n=2).result(timeout=10), rows)
        th.join(5)
    finally:
        proc.kill()
        parent.close()
        child.close()


def test_server_drains_oversized_frame_and_keeps_serving(monkeypatch):
    parent, child = socket.socketpair()
    try:
        srv = replica_main.ReplicaServer(child, replica=None, replica_id="lim")
        monkeypatch.setattr(remote, "MAX_FRAME_BYTES", 1024)
        parent.sendall(struct.pack(">I", 2048) + b"\x00" * 2048)
        remote.send_frame(parent, {"id": 2, "method": "ping", "params": {}})

        def server_turn():
            srv.handle(srv._recv_request())

        th = threading.Thread(target=server_turn, daemon=True)
        th.start()
        err_evt = remote.recv_frame(parent)
        assert err_evt["event"] == "protocol_error"
        assert "MAX_FRAME_BYTES" in err_evt["error"]["message"]
        pong = remote.recv_frame(parent)
        assert pong["id"] == 2 and pong["ok"]
        th.join(5)
    finally:
        parent.close()
        child.close()


# ------------------------------------------------------- the engine child


def test_engine_child_rows_bitwise_the_parents_direct_call(reaper):
    """A child serving the port's engine on the CPU (``"device": "cpu"``),
    weights from the port's seeded init: its rows are the parent's direct
    ``ddim_sample`` over an 8-row batch holding the starts, bit for bit."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rep = _spawn(reaper, spec={
            "backend": "engine", "init_seed": 0, "engine": {"buckets": [8]},
            "model": dict(TINY, img_size=[16, 16], dtype="float32", use_flash=True,
                          device="cpu")}, spawn_timeout_s=120)
        cfg = SamplerConfig(k=K)
        report = rep.warm([cfg])
        assert report["new_programs"] == 1 and report["buckets"] == [8]
        rep.start()
        model = DiffusionViT(**TINY, use_flash=True, device="cpu", seed=0)
        for seed, n in ((5, 3), (6, 8)):
            got = rep.submit(seed=seed, n=n, config=cfg).result(timeout=60)
            x = torch.zeros((8, 16, 16, 3))
            x[:n] = sampling.fresh_start(model, torch.Generator().manual_seed(seed), n,
                                         "cpu")
            want = sampling.ddim_sample(model, x_init=x, k=K, device="cpu")[:n]
            np.testing.assert_array_equal(got, want.numpy())
        assert rep.health()["programs_after_warmup"] == 0
        rep.drain(timeout=30)
        assert rep._proc.poll() is not None
    finally:
        torch.set_num_threads(before)


def test_engine_child_without_device_refuses_to_spawn_without_a_card(reaper):
    """No ``"device"`` key means the card: a child without one raises while
    it builds its replica, and the spawn fails at once instead of serving on
    the CPU."""
    factory = remote.remote_factory(
        {"backend": "engine", "init_seed": 0,
         "model": dict(TINY, img_size=[16, 16], dtype="float32")},
        env=dict(CHILD_ENV, CUDA_VISIBLE_DEVICES=""), spawn_timeout_s=120)
    t0 = time.perf_counter()
    with pytest.raises(ReplicaUnreachableError, match="exited with code"):
        factory("nocard")
    assert time.perf_counter() - t0 < 60


# ------------------------------------------------------------ fleet failover


#: r0's stub requests outlast the test: whatever the pace of placement, r0
#: still holds its first ticket when its second work frame kills it. With
#: r0 at the survivors' 0.2 s, a second frame that reaches r0 after its first
#: request finished kills a replica that holds nothing; the router then
#: re-places only the cut submit (no failover owed) and ``failovers`` reads 0.
R0_HOLDS_S = 60.0


def _failover_fleet(reaper, r0_delay_s=R0_HOLDS_S):
    """Router over two stub children, r0 SIGKILLed at its second work frame."""
    killed = dict(CHILD_ENV, DDIM_COLD_FAULTS="replica.kill:kill:at=1,match=replica:r0|")
    factories = {delay: remote.remote_factory(
        {"backend": "stub", "stub": {"delay_s": delay}}, env=killed, heartbeat_s=0.3,
        miss_budget=3) for delay in {r0_delay_s, 0.2}}

    def tracking(rid):
        rep = factories[r0_delay_s if rid == "r0" else 0.2](rid)
        reaper.append(rep)
        return rep

    return Router(tracking, replicas=2, configs=(CFG,), buckets=(4, 8),
                  drain_timeout_s=10, tick_s=0.02)


def _assert_failover(router, reaper):
    tickets = [(seed, router.submit(seed=seed, n=2)) for seed in range(6)]
    for seed, t in tickets:
        np.testing.assert_array_equal(
            t.result(timeout=30), replica_main.stub_rows(seed, 2, STUB_SHAPE),
            err_msg=f"seed {seed} not bitwise after failover")
    assert _poll(lambda: router.health()["retired_replicas"] >= 1)
    assert _poll(lambda: router.health()["active_replicas"] == 2)
    h = router.health()
    assert h["failovers"] >= 1 and h["programs_after_warmup"] == 0
    assert reaper[0].replica_id == "r0" and reaper[0].crash_reason


def test_router_failover_after_kill_is_bitwise_and_respawns(reaper):
    """Two stub children, r0 SIGKILLed at its second work frame while it
    holds its first ticket: every ticket completes with its deterministic
    rows (failover re-placed the dead replica's work), a replacement spawns,
    and the fleet-wide programs_after_warmup stays 0."""
    router = _failover_fleet(reaper)
    try:
        _assert_failover(router, reaper)
    finally:
        router.drain(timeout=15)
    assert all(rep._proc.poll() is not None for rep in reaper)


def test_router_failover_holds_when_r0_is_placed_slowly(reaper):
    """The same fleet with every submit to r0 held 0.3 s in the parent
    (``rpc.latency``), longer than a 0.2 s request: r0's second work frame
    then comes after its first request would have finished. The failover is
    still owed and counted, because r0 holds that request until the kill."""
    router = _failover_fleet(reaper)
    try:
        with faults.inject(faults.FaultSpec("rpc.latency", "latency", latency_s=0.3,
                                            match="replica:r0|method:submit|")):
            _assert_failover(router, reaper)
    finally:
        router.drain(timeout=15)
    assert all(rep._proc.poll() is not None for rep in reaper)


def test_spawner_exports_the_package_root(reaper, tmp_path, monkeypatch):
    """A parent driven from outside the repository still spawns children
    that import the port: the factory puts the package root on the child's
    PYTHONPATH."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYTHONPATH", raising=False)
    rep = _spawn(reaper, spec={"stub": {}})
    assert rep.state == fleet.NEW and rep._proc.poll() is None
    assert os.path.samefile(Path(remote.__file__).parents[2], ROOT)
    rep.close()
