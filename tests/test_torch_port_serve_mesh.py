"""The serving engine across ranks against the JAX engine's mesh and
sequence-parallel serving, on the CPU.

One module-scoped gloo world of four CPU ranks (``tools/dist_cases.run_world``:
one intra-op thread a rank, a deadline well under two minutes) runs every
engine case: every rank builds the engine on the case's mesh and warms it,
rank 0 submits, runs and drains while the others ``follow()``, and rank 0
then serves the same requests on a one-process engine (``mesh=None``, each
config at degree 1) for the reference. The JAX engines run in this process
on the first four virtual devices (``make_mesh(..., devices=jax.devices()[:4])``),
fed the same ``x_init`` (the port cannot draw JAX's seeds), through JAX's
dense attention (the port runs the flash kernels' plain versions: the same
function, and no interpret-mode compile).

Tolerances: against JAX's engine atol 1e-4 (as ``test_mesh_sampling_matches_jax``,
``tests/test_torch_port_parallel.py``: two frameworks summing in another
order); against the port's one-process engine at the same bucket rtol =
atol = 2e-5 (JAX's own sp engine tests, ``tests/test_serve.py:686``: a mesh
reduces in another order than one process); fused × sp against unfused ×
sp bit for bit (JAX's ``test_engine_fused_sp2_composition``: the fused
attention is gated off under sp and the w8a16 Mlp is per token).

* ``Engine(mesh={data: 4})`` against JAX's ``Engine(mesh=...)``, and JAX's
  "divide" error for buckets that do not divide the data axis; an inpaint
  request on the same engine (its known image and mask ride the broadcast
  batch) against the one-process engine;
* ``sp_degree=2`` Ulysses at buckets (2, 4) on an engine mesh ``{data: 2,
  seq: 2}`` (its sp mesh ``(data 2, seq 2)``) against JAX's engine on the
  same four devices, zero programs after warmup on every rank; ``quant=
  "pallas"`` fused × sp2 against unfused sp2; a cached full-mode sp config
  whose spare cache is keyed ``(bucket, ("pair", "ulysses", 2))``; bucket 1
  refused with "data axis";
* an engine ``{data: 4}`` whose only config is a cached sp one (its
  ``(data 2, seq 2)`` mesh is built on every rank before rank 0 allocates
  the spare cache): served within the tolerance;
* the Ulysses → ring fallback of a 2-head model at ``sp_degree=4``;
* a transient ``serve.dispatch`` fault and a poisoned request on rank 0:
  retried and bisected, the survivors within the tolerance, the followers'
  program counts rank 0's;
* every case's drain releases every ``follow()``, whose batches are rank
  0's dispatches;

and, in a second world of two ranks, a follower that fails: one that cannot
ready a program fails that batch on rank 0 as ``RankFailedError`` (no rank
ran it) and bisection serves the requests; one whose forward raises inside
a running program costs the engine (rank 0 waits in the program's gather
until ``stall_s``, then its tickets fail typed and it closes); one that
exits mid-drain fails rank 0's open tickets with ``RankLostError`` well
within ``stall_s``. Nothing hangs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddim_cold_torch.tools import dist_cases
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu import serve as jserve
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.parallel import make_mesh

WORLD = 4
DEADLINE_S = 100.0
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=1, num_heads=4,
            total_steps=8)
K = 2
DP4, DP2SP2 = {"data": 4}, {"data": 2, "seq": 2}
ONE = dict(rtol=2e-5, atol=2e-5)
JAX = dict(rtol=0, atol=1e-4)

SP2 = dict(k=K, sp_mode="ulysses", sp_degree=2)
#: the sp engine's configs, by index in its table
SP_CONFIGS = [SP2, dict(SP2, cache_interval=2, cache_mode="full"),
              dict(SP2, quant="pallas"), dict(SP2, quant="pallas", fused=True)]
STALL_S = 5.0


def _params(cfg):
    model = DiffusionViT(**cfg)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32))["params"])


def _sd(params):
    return {k: v.numpy() for k, v in state_dict_from_flax(params, 4).items()}


def _starts(seed, *ns):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, 16, 16, 3).astype(np.float32) for n in ns]


@pytest.fixture(scope="module")
def world():
    """Every engine case, run once in one world of four gloo ranks: id →
    every rank's result; with the JAX parameters and the starts used."""
    params = {"dp": _params(TINY), "sp": _params(dict(TINY, depth=2)),
              "heads2": _params(dict(TINY, num_heads=2))}
    dp = _starts(1, 3, 1, 2)
    mask = np.zeros((2, 16, 16, 1), np.float32)
    mask[:, :, :8] = 1.0
    sp = _starts(2, 4, 2, 4)
    chaos = _starts(3, 1, 1, 1, 1)
    cases = {
        "dp4": ("serve_engine", dict(
            spec=DP4, cfg=dict(TINY, use_flash=True), state_dict=_sd(params["dp"]),
            buckets=(4,), configs=[dict(k=K), dict(task="inpaint", k=K)],
            requests=[(0, dp[0]), (0, dp[1]), (1, dp[2], dict(seed=5, mask=mask))])),
        "divide": ("bucket_error", dict(
            spec=DP4, cfg=dict(TINY, use_flash=True), state_dict=_sd(params["dp"]),
            buckets=(2, 4))),
        "sp2": ("serve_engine", dict(
            spec=DP2SP2, cfg=dict(TINY, depth=2, use_flash=True),
            state_dict=_sd(params["sp"]), buckets=(2, 4), configs=SP_CONFIGS,
            requests=[(0, sp[0]), (0, sp[1]), (1, sp[2]), (2, sp[2]), (3, sp[2])],
            probe_buckets=((0, 1),))),
        "sp_cached_only": ("serve_engine", dict(
            spec=DP4, cfg=dict(TINY, depth=2, use_flash=True), state_dict=_sd(params["sp"]),
            buckets=(4,), configs=[SP_CONFIGS[1]], requests=[(0, sp[1])])),
        "fallback": ("serve_engine", dict(
            spec=DP4, cfg=dict(TINY, num_heads=2, use_flash=True),
            state_dict=_sd(params["heads2"]), buckets=(4,),
            configs=[dict(k=K, sp_mode="ulysses", sp_degree=4)],
            requests=[(0, sp[0])])),
        "chaos": ("serve_engine", dict(
            spec=DP2SP2, cfg=dict(TINY, use_flash=True), state_dict=_sd(params["dp"]),
            buckets=(4,), configs=[SP2], requests=[(0, x) for x in chaos],
            faults=(dict(site="serve.dispatch", kind="transient", at=(0,)),
                    dict(site="serve.dispatch", kind="permanent", match="req:2|")))),
    }
    results = dist_cases.run_world(list(cases.values()), WORLD, device="cpu",
                                   timeout_s=DEADLINE_S)
    return {"by_id": dict(zip(cases, results)), "params": params,
            "starts": {"dp": dp, "sp": sp, "chaos": chaos}}


def _jax_engine(model, params, spec, buckets, config, starts):
    """JAX's engine on the first four virtual devices: each start's rows."""
    mesh = make_mesh(dict(spec), devices=jax.devices()[:4])
    eng = jserve.Engine(model, params, mesh=mesh, buckets=buckets)
    jserve.warmup(eng, [config], persistent_cache=False)
    tickets = [eng.submit(x_init=x, config=config) for x in starts]
    eng.run()
    return [t.result(timeout=30) for t in tickets]


def _followers_agree(ranks):
    """Every follower built no program after warmup, ran rank 0's
    dispatches and failed none; rank 0 built none either."""
    lead = ranks[0]
    assert lead["programs_after_warmup"] == 0
    for r in ranks[1:]:
        assert r["programs_after_warmup"] == 0
        follow = r["follow"]
        assert follow["new_programs"] == 0
        assert follow["programs"] == lead["stats"]["programs"]
        assert follow["batches"] == lead["stats"]["dispatches"]
        assert follow["failed_batches"] == 0 and follow["errors"] == []


def test_engine_on_a_data_mesh_matches_jax(world):
    ranks = world["by_id"]["dp4"]
    lead = ranks[0]
    starts = world["starts"]["dp"]
    want = _jax_engine(DiffusionViT(**TINY), world["params"]["dp"], DP4, (4,),
                       jserve.SamplerConfig(k=K), starts[:2])
    assert lead["report"]["batches"] == 2 and lead["report"]["failed_tickets"] == 0
    for got, one, ref, x in zip(lead["rows"], lead["one_process"], want, starts):
        assert got.shape == x.shape
        np.testing.assert_allclose(got, one, **ONE)
        np.testing.assert_allclose(got, np.asarray(ref), **JAX)
    _followers_agree(ranks)


def test_inpaint_on_a_data_mesh(world):
    """An inpaint request across ranks: its known image and mask ride the
    broadcast batch and are split over the data axis with x; the rows are
    the one-process engine's, and the known pixels exact."""
    lead = world["by_id"]["dp4"][0]
    got, known = lead["rows"][2], world["starts"]["dp"][2]
    np.testing.assert_allclose(got, lead["one_process"][2], **ONE)
    np.testing.assert_array_equal(got[:, :, :8], (known[:, :, :8] + 1.0) / 2.0)


def test_buckets_must_divide_the_data_axis(world):
    """JAX's message, raised on every rank before any collective."""
    with pytest.raises(ValueError, match="divide") as want:
        jserve.Engine(DiffusionViT(**TINY), world["params"]["dp"],
                      mesh=make_mesh(dict(DP4), devices=jax.devices()[:4]),
                      buckets=(2, 4))
    assert world["by_id"]["divide"] == [str(want.value)] * WORLD


def test_sp2_engine_matches_jax_at_both_buckets(world):
    """Ulysses at sp_degree=2 serves buckets 4 and 2 on the (data 2, seq 2)
    mesh, zero programs after warmup, JAX's rows."""
    ranks = world["by_id"]["sp2"]
    lead = ranks[0]
    sp = world["starts"]["sp"]
    want = _jax_engine(DiffusionViT(**dict(TINY, depth=2)), world["params"]["sp"],
                       DP2SP2, (2, 4), jserve.SamplerConfig(**SP2), sp[:2])
    assert lead["sp_meshes"] == {2: {"data": 2, "seq": 2}}
    assert lead["sp_modes"] == ["ulysses"] * len(SP_CONFIGS)
    assert lead["report"]["failed_tickets"] == 0 and lead["report"]["programs"] == 0
    for got, one, ref, x in zip(lead["rows"][:2], lead["one_process"][:2], want, sp):
        assert got.shape == x.shape
        np.testing.assert_allclose(got, one, **ONE)
        np.testing.assert_allclose(got, np.asarray(ref), **JAX)
    _followers_agree(ranks)


def test_sp2_cached_config_prewarms_its_spare_pool(world):
    """A cached full-mode sp config warms a spare cache of its own kind
    (JAX ``test_sp_cached_config_prewarms_spare_pool``) and serves within
    the tolerance of the one-process cached engine."""
    lead = world["by_id"]["sp2"][0]
    assert repr((4, ("pair", "ulysses", 2))) in lead["spare"]
    assert repr((2, ("pair", "ulysses", 2))) in lead["spare"]
    np.testing.assert_allclose(lead["rows"][2], lead["one_process"][2], **ONE)


def test_fused_sp2_is_bitwise_unfused_sp2(world):
    """quant="pallas" × sp2: the fused attention is gated off under sp and
    the fused Mlp is per token, so fused × sp2 is unfused sp2 bit for bit
    (JAX ``test_engine_fused_sp2_composition``)."""
    lead = world["by_id"]["sp2"][0]
    unfused, fused = lead["rows"][3], lead["rows"][4]
    assert unfused.shape == (4, 16, 16, 3)
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_allclose(unfused, lead["one_process"][3], **ONE)


def test_bucket_must_tile_the_sp_data_axis(world):
    """Bucket 1 cannot tile sp_degree=2's data axis (4 ranks → data 2):
    ``ensure_program`` refuses with JAX's words."""
    (msg,) = world["by_id"]["sp2"][0]["probe_errors"]
    assert "data axis" in msg and "bucket 1" in msg


def test_a_cached_sp_config_alone_warms_across_ranks(world):
    """An engine whose only config is a cached sp one: every rank builds
    the sp mesh before rank 0 allocates the config's spare cache, so
    warmup does not wait on a group the followers never create."""
    ranks = world["by_id"]["sp_cached_only"]
    lead = ranks[0]
    assert lead["sp_meshes"] == {2: {"data": 2, "seq": 2}}
    assert lead["spare"] == [repr((4, ("pair", "ulysses", 2)))]
    np.testing.assert_allclose(lead["rows"][0], lead["one_process"][0], **ONE)
    _followers_agree(ranks)


def test_ulysses_falls_back_to_the_ring(world):
    """4 ranks at sp_degree=4 with 2 heads cannot run Ulysses: the engine
    resolves the model to the ring (JAX ``test_sp_ring_fallback_serves``)
    and serves within the tolerance."""
    ranks = world["by_id"]["fallback"]
    lead = ranks[0]
    assert lead["sp_modes"] == ["ring"]
    assert lead["sp_meshes"] == {4: {"data": 1, "seq": 4}}
    np.testing.assert_allclose(lead["rows"][0], lead["one_process"][0], **ONE)
    _followers_agree(ranks)


def test_faults_retry_and_bisect_across_ranks(world):
    """A transient dispatch fault is retried and a poisoned request is
    bisected out on rank 0; its batchmates are served within the tolerance
    and every follower ran exactly the batches that reached the device."""
    ranks = world["by_id"]["chaos"]
    lead = ranks[0]
    assert lead["quarantined"] == [2]
    assert lead["rows"][2] == "RequestQuarantinedError"
    assert lead["stats"]["retries"] == 1 and lead["stats"]["quarantined"] == 1
    for i in (0, 1, 3):
        np.testing.assert_allclose(lead["rows"][i], lead["one_process"][i], **ONE)
    _followers_agree(ranks)


@pytest.fixture(scope="module")
def follower_faults():
    """Three follower faults, in order, in one world of two gloo ranks on
    ``{data: 2}``: id → every rank's result, and the starts served."""
    params = _params(TINY)
    one, two = _starts(4, 1, 1), _starts(5, 2, 2, 2, 2)
    base = dict(spec={"data": 2}, cfg=dict(TINY, use_flash=True), state_dict=_sd(params),
                buckets=(2,), config=dict(k=K), stall_s=STALL_S)
    cases = {
        "prepare": dict(base, requests=one, where="prepare", after=0, reference=True),
        "forward": dict(base, requests=one, where="forward", after=0),
        "exit": dict(base, requests=two, where="exit", after=1),
    }
    results = dist_cases.run_world(
        [("serve_follower_fault", kw) for kw in cases.values()], 2, device="cpu",
        timeout_s=90, may_exit=(1,))
    return {"by_id": dict(zip(cases, results)), "one": one}


def test_a_follower_that_cannot_ready_a_program_fails_the_batch_typed(follower_faults):
    """The follower cannot ready its part of the first batch: the ranks
    agree before any of them runs it, rank 0 fails the batch as
    ``RankFailedError``, bisection re-dispatches each request alone at the
    same bucket, and both are served within the tolerance."""
    lead, follower = follower_faults["by_id"]["prepare"]
    assert lead["stats"] == {"failed_batches": 1, "quarantined": 0, "dispatches": 2}
    assert not lead["stalled"] and not lead["health"]["closed"]
    for got, one, x in zip(lead["rows"], lead["one_process"], follower_faults["one"]):
        assert got.shape == x.shape
        np.testing.assert_allclose(got, one, **ONE)
    report = follower["follow"]
    assert report["failed_batches"] == 1 and report["batches"] == 2
    assert report["new_programs"] == 0
    assert report["errors"] == ["RuntimeError('injected: this rank cannot ready its program')"]


def test_a_follower_that_raises_inside_a_program_costs_the_engine(follower_faults):
    """The follower's forward raises inside a running program: rank 0 waits
    in the program's gather until ``stall_s``, then every open ticket fails
    typed (the watchdog's ``EngineStalledError`` or the protocol's
    ``RankLostError``, which subclasses it) and the engine closes; the
    follower's ``follow()`` raises ``RankLostError``."""
    lead, follower = follower_faults["by_id"]["forward"]
    assert set(lead["rows"]) <= {"EngineStalledError", "RankLostError"}
    assert len(lead["rows"]) == 2
    assert STALL_S <= lead["wall_s"] < 3 * STALL_S
    assert lead["stalled"] and lead["health"]["closed"]
    assert lead["submit_after"] == "EngineClosedError"
    assert follower["raised"] == "RankLostError"
    assert follower["errors"] == ["RuntimeError(\"injected: this rank's forward raised\")"]


def test_a_follower_that_exits_fails_the_tickets_typed(follower_faults):
    """A follower leaves its process after one batch: rank 0's open tickets
    fail with ``RankLostError`` (an ``EngineStalledError``) within
    ``stall_s``, the engine closes and refuses work, and both processes are
    gone when the world returns."""
    lead, follower = follower_faults["by_id"]["exit"]
    assert follower is None
    outcomes = [r if isinstance(r, str) else "rows" for r in lead["rows"]]
    assert set(outcomes) <= {"rows", "RankLostError"} and "RankLostError" in outcomes
    assert lead["wall_s"] < STALL_S
    assert lead["stalled"] and lead["health"]["closed"] and lead["health"]["stalls"] == 1
    assert lead["submit_after"] == "EngineClosedError"
