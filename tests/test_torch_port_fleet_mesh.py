"""The fleet across ranks (``serve.local_factory(model, mesh=...)`` on rank
0, ``serve.follow_replicas`` on the others) against the JAX package's fleet,
on the CPU.

One module-scoped gloo world of two CPU ranks (``tools/dist_cases.run_world``:
one intra-op thread a rank, a deadline well under two minutes) runs two
fleets in turn over ``{data: 2}``, the mesh tests' TINY model (16 px, patch
4, depth 1, k=2: four forwards), buckets (2, 4):

* two replicas warmed with a float config and ``ulysses sp_degree=2`` (its
  mesh ``(data 1, seq 2)``), an sp ticket hedged off r0 by one transient
  ``serve.assemble`` fault onto r1, whose sp program is already built:
  JAX's ``tests/test_fleet.py::test_sp_ticket_failover_reuses_warmed_programs``
  on the port, its realized faults and hedges JAX's fleet's (the same
  config set, fault and start, on two virtual devices), its rows within
  JAX's own 2e-5 of JAX's direct ``ddim_sample`` on the same ``x_init``
  (the port cannot draw JAX's seeds); then r0 retired and its replacement
  spawned and warmed on both ranks, the fleet serving on; no program after warmup on
  any replica of either rank; after the drain no fleet thread and no
  process group the fleet made is left on either rank;
* one replica whose follower rank leaves the process at its first program:
  the ticket fails with ``RankLostError`` naming the replica within
  ``stall_s`` (no failover, so the router passes the replica's error on),
  the supervisor's replacement spawns fail, a spawn raises within
  ``stall_s`` (it never reaches group creation), and the drain leaves
  nothing on rank 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddim_cold_torch.tools import dist_cases
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu import serve as jserve
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.parallel import make_mesh
from ddim_cold_tpu.serve.router import Router as JaxRouter
from ddim_cold_tpu.utils import faults as jax_faults

WORLD = 2
DEADLINE_S = 100.0
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=1, num_heads=4,
            total_steps=8)
K = 2
DP2 = {"data": 2}
BUCKETS = (2, 4)
CFG = dict(k=K)
SP_CFG = dict(k=K, sp_mode="ulysses", sp_degree=2)
#: JAX's fleet test's fault: the first assembly on r0 fails, once
FAULT = dict(site="serve.assemble", kind="transient", rate=1.0, match="replica:r0|",
             max_fires=1)
#: JAX's fleet test's tolerance against its direct call
TOL = dict(rtol=2e-5, atol=2e-5)
STALL_S = 20.0
LOST_STALL_S = 3.0


def _params():
    model = DiffusionViT(**TINY)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32))["params"])


@pytest.fixture(scope="module")
def world():
    params = _params()
    sd = {k: v.numpy() for k, v in state_dict_from_flax(params, 4).items()}
    rs = np.random.RandomState(13)
    x4, x2 = (rs.randn(n, 16, 16, 3).astype(np.float32) for n in (4, 2))
    cfg = dict(TINY, use_flash=True)
    cases = [
        ("serve_fleet", dict(spec=DP2, cfg=cfg, state_dict=sd, buckets=BUCKETS,
                             configs=[CFG, SP_CFG], requests=[(1, x4)], fault=FAULT,
                             after=[(0, x2), (1, x4)], stall_s=STALL_S)),
        ("serve_fleet_lost", dict(spec=DP2, cfg=cfg, state_dict=sd, buckets=BUCKETS,
                                  config=CFG, x_init=x2, stall_s=LOST_STALL_S)),
    ]
    fleet, lost = dist_cases.run_world(cases, WORLD, device="cpu", timeout_s=DEADLINE_S,
                                       may_exit=(1,))
    return {"fleet": fleet, "lost": lost, "params": params, "x4": x4, "x2": x2}


def _direct(world, x):
    return np.asarray(sampling.ddim_sample(DiffusionViT(**TINY), world["params"],
                                           x_init=jnp.asarray(x), k=K))


def test_sp_ticket_failover_reuses_warmed_programs(world):
    params = world["params"]
    router = JaxRouter(
        jserve.local_factory(DiffusionViT(**TINY), params, buckets=BUCKETS,
                             mesh=make_mesh(dict(DP2), devices=jax.devices()[:2])),
        replicas=2, configs=[jserve.SamplerConfig(**CFG), jserve.SamplerConfig(**SP_CFG)],
        warm_kwargs=dict(persistent_cache=False), drain_timeout_s=10.0)
    with jax_faults.inject(jax_faults.FaultSpec(**FAULT)) as plan:
        jax_rows = router.submit(x_init=world["x4"], config=jserve.SamplerConfig(**SP_CFG)
                                 ).result(timeout=60)
    want = {"realized": len(plan.realized), "hedges": router.stats["hedges"]}
    assert router.drain(timeout=10)["compiles_after_warmup"] == 0
    lead, follower = world["fleet"]
    assert want == {"realized": 1, "hedges": 1}
    assert {"realized": lead["realized"], "hedges": lead["hedges"]} == want
    direct = _direct(world, world["x4"])
    np.testing.assert_allclose(jax_rows, direct, **TOL)
    (got,) = lead["rows"]
    assert got.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got, direct, **TOL)
    assert lead["health"]["programs_after_warmup"] == 0
    for rid, rep in follower["follow"]["replicas"].items():
        assert rep["error"] is None, (rid, rep)
        assert rep["follow"]["new_programs"] == 0 and rep["follow"]["failed_batches"] == 0


def test_retired_replica_is_replaced_on_both_ranks(world):
    """r0 retired: the replacement r2 is spawned and warmed on both ranks
    (in rank 0's order), the fleet serves on, and the follower's report of
    every replica matches rank 0's batches."""
    lead, follower = world["fleet"]
    report = follower["follow"]
    assert lead["replaced"] and lead["replicas"] == ["r0", "r1", "r2"]
    assert report["order"] == [("spawn", "r0"), ("warm", "r0"), ("spawn", "r1"),
                               ("warm", "r1"), ("close", "r0"), ("spawn", "r2"),
                               ("warm", "r2"), ("close", "r1"), ("close", "r2"),
                               ("stop", "")]
    assert report["replicas"]["r2"]["warm"]["programs"] == 2 * len(BUCKETS)
    assert lead["retired"] == 1 and lead["health"]["stats"]["replicas_spawned"] == 3
    for rid, n in lead["dispatches"].items():
        assert report["replicas"][rid]["follow"]["batches"] == n, rid
    for got, x in zip(lead["rows_after"], (world["x2"], world["x4"])):
        np.testing.assert_allclose(got, _direct(world, x), **TOL)


def test_lost_follower_fails_typed_and_spawns_raise(world):
    lead = world["lost"][0]
    kind, msg, seconds = lead["ticket"]
    assert kind == "RankLostError" and "replica 'r0'" in msg
    assert seconds < LOST_STALL_S
    assert lead["spawn_failures"]
    kind, msg, seconds = lead["spawn"]
    assert kind == "RankLostError" and seconds < LOST_STALL_S


def test_drain_leaves_no_thread_or_group(world):
    for rank, res in enumerate(world["fleet"]):
        assert res["threads_after"] == [], rank
        assert res["groups_after"] == res["groups_before"], rank
    lost = world["lost"][0]
    assert lost["threads_after"] == [] and lost["groups_after"] == lost["groups_before"]
