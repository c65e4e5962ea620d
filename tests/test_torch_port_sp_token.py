"""The token cache and the attention probe under sequence parallelism
against the JAX package's, on the CPU.

One module-scoped gloo world of four CPU ranks (``tools/dist_cases.run_world``:
one intra-op thread a rank, a deadline well under two minutes) runs every
rank case; a ``{seq: 2}`` case runs on both halves of the world at once.
The geometry is the mesh tests' TINY (16 px, patch 4: N+1 = 17 tokens, so
at ``seq: 2`` the blocks hold 9 and 8 real tokens and the second is
padded), at depth 2 (the step cache needs two blocks). JAX's side runs in
this process on the suite's virtual CPU devices through ``sp_clone`` on a
``{data: 1, seq: 2}`` mesh (``{data: 2, seq: 2}`` for the four-rank case)
and its dense attention, fed the same ``x_init``; the port's through the
flash kernels' plain versions.

* the global selection: each rank's blocks of a stream and its reference
  give the live positions of the one-process ``_live_tokens`` bit for bit
  on every rank (random scores; exact ties across the block boundary; k =
  1, N+1 and more than a block's real tokens), and a padding row is never
  live, even at the largest would-be score;
* ``ddim_sample`` and ``cold_sample`` in token mode on ``{seq: 2}``
  (Ulysses and the ring) and on ``{data: 2, seq: 2}``, and a w8a8 model's
  ``ddim_sample`` on ``{seq: 2}`` (the scale of a reuse step its live
  tokens'): against JAX's cached sampler on ``sp_clone`` atol 1e-4 (as
  ``tests/test_torch_port_parallel.py``: two frameworks summing in another
  order), against the port's one-process call rtol = atol = 2e-5 (JAX's own
  sp tests: a mesh reduces in another order than one process; the w8a8
  twin is the ``sp_clone`` over a mesh of one rank, as the parallel tests'
  is);
* ``SamplerConfig(cache_mode="token", sp_degree=2)`` through
  ``Engine(mesh={data: 2})`` (its sp mesh ``(data 1, seq 2)``) at buckets 2
  and 4 against JAX's engine on two devices (atol 1e-4) and the port's
  one-process engine (2e-5), zero programs after warmup on both ranks;
* the probe at layers 0 and −1 on ``{seq: 2}`` (Ulysses and the ring)
  against JAX's probe on ``sp_clone`` (rtol 2e-4, atol 2e-5: the f32
  forward's tolerance, ``tests/test_torch_port_model.py``) and the port's
  one-process probe (2e-5), every rank returning the whole (B, H, N+1,
  N+1); with attention dropout active a training forward raises JAX's
  ValueError. The probe under ``head_axis`` runs in the four-rank world of
  ``tests/test_torch_port_tp_pp.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.models import vit as port_vit
from ddim_cold_torch.ops import sampling as port_sampling
from ddim_cold_torch.tools import dist_cases
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu import serve as jserve
from ddim_cold_tpu.models import DiffusionViT, sp_clone
from ddim_cold_tpu.ops import quant as jax_quant
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.parallel import make_mesh

WORLD = 4
DEADLINE_S = 100.0
TINY = dict(img_size=(16, 16), patch_size=4, embed_dim=32, depth=2, num_heads=4,
            total_steps=8)
SEQ2, DP2SP2, DP2 = {"seq": 2}, {"data": 2, "seq": 2}, {"data": 2}
#: the JAX mesh of each port mesh (JAX's samplers shard the batch over 'data')
JAX_MESH = {"seq2": {"data": 1, "seq": 2}, "dp2sp2": DP2SP2}
ONE = dict(rtol=2e-5, atol=2e-5)
JAX = dict(rtol=0, atol=1e-4)
PROBE_JAX = dict(rtol=2e-4, atol=2e-5)
TOKEN = dict(cache_interval=2, cache_mode="token")

#: the selection cases: id → (stream name, k, pad_score)
SELECT = {"random-k1": ("random", 1, False), "random-k5": ("random", 5, False),
          "random-k12": ("random", 12, False), "random-k17": ("random", 17, False),
          "ties-k3": ("ties", 3, False), "ties-k5": ("ties", 5, False),
          "padding-k16": ("random", 16, True)}

#: the token-cached sampler cases: id → (mesh, JAX mesh, sp_mode, sampler,
#: its options); 12 live tokens is more than either block's real tokens
SAMPLE = {
    "ddim-ulysses-seq2": (SEQ2, "seq2", "ulysses", "ddim_sample", dict(k=1, cache_tokens=12)),
    "ddim-ring-seq2": (SEQ2, "seq2", "ring", "ddim_sample", dict(k=1, cache_tokens=5)),
    "ddim-ulysses-dp2sp2": (DP2SP2, "dp2sp2", "ulysses", "ddim_sample",
                            dict(k=1, cache_tokens=7)),
    "cold-ulysses-seq2": (SEQ2, "seq2", "ulysses", "cold_sample",
                          dict(levels=4, cache_tokens=5)),
    "cold-ring-seq2": (SEQ2, "seq2", "ring", "cold_sample", dict(levels=4, cache_tokens=12)),
}
W8A8 = dict(k=1, cache_tokens=6)
ENGINE_CFG = dict(k=2, sp_mode="ulysses", sp_degree=2, cache_tokens=5, **TOKEN)
PROBE_LAYERS = (0, -1)


def _params(cfg):
    model = DiffusionViT(**cfg)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32))["params"])


def _sd(params):
    return {k: v.numpy() for k, v in state_dict_from_flax(params, 4).items()}


def _streams():
    """(B, N+1, E) reference and two streams: random changes, and equal
    changes at positions 6–11 (across the block boundary 8 | 9) only."""
    rs = np.random.RandomState(7)
    # eighths: ``ref + 1`` and its difference are exact, so the ties are
    ref = (np.round(rs.randn(3, 17, 8) * 8) / 8).astype(np.float32)
    ties = ref.copy()
    ties[:, 6:12] += 1.0
    return ref, {"random": ref + rs.randn(3, 17, 8).astype(np.float32), "ties": ties}


def _jax_mesh(key):
    spec = JAX_MESH[key]
    return make_mesh(dict(spec), devices=jax.devices()[:int(np.prod(list(spec.values())))])


@pytest.fixture(scope="module")
def world():
    """Every rank case, run once in one world of four gloo ranks."""
    params = _params(TINY)
    sd = _sd(params)
    cfg = dict(TINY, use_flash=True)
    rs = np.random.RandomState(11)
    x = rs.randn(4, 16, 16, 3).astype(np.float32)
    t = np.array([0, 3, 5, 7], np.int32)
    ref, streams = _streams()
    cases = {"select": ("token_selection", dict(spec=SEQ2, cases=[
        dict(stream=streams[name], ref=ref, k=k, pad_score=pad)
        for name, k, pad in SELECT.values()]))}
    for key, (spec, _, mode, fn, kw) in SAMPLE.items():
        cases[key] = ("sample", dict(spec=spec, cfg=cfg, state_dict=sd, x_init=x, fn=fn,
                                     sp_mode=mode, **TOKEN, **kw))
    cases["w8a8"] = ("quant_sample", dict(spec=SEQ2, cfg=cfg, state_dict=sd, x_init=x,
                                          quant="w8a8", sp_mode="ulysses", **TOKEN, **W8A8))
    cases["engine"] = ("serve_engine", dict(
        spec=DP2, cfg=cfg, state_dict=sd, buckets=(2, 4), configs=[ENGINE_CFG],
        requests=[(0, x[:2]), (0, x)]))
    for mode in ("ulysses", "ring"):
        cases[f"probe-{mode}"] = ("sp_probe", dict(spec=SEQ2, cfg=cfg, state_dict=sd, x=x,
                                                   t=t, sp_mode=mode, layers=PROBE_LAYERS))
    results = dist_cases.run_world(list(cases.values()), WORLD, device="cpu",
                                   timeout_s=DEADLINE_S)
    return {"by_id": dict(zip(cases, results)), "params": params, "sd": sd,
            "x": x, "t": t, "ref": ref, "streams": streams}


def _port_model(world, **kw):
    model = PortViT(**TINY, use_flash=True, device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in world["sd"].items()})
    return model


@pytest.mark.parametrize("case", list(SELECT))
def test_selection_is_the_one_process_one(world, case):
    """Every rank's live positions are the one-process ``_live_tokens``'s,
    bit for bit (a block's padding never among them)."""
    name, k, _ = SELECT[case]
    want = port_vit._live_tokens(torch.from_numpy(world["streams"][name]),
                                 torch.from_numpy(world["ref"]), k).numpy()
    assert want.shape == (3, k) and (want < 17).all()
    for rank, got in enumerate(world["by_id"]["select"]):
        np.testing.assert_array_equal(got[list(SELECT).index(case)], want,
                                      err_msg=f"rank {rank}")


def test_padding_is_never_live(world):
    """Rank 1's padding row (position 17) moved far from the reference
    would outscore every real token; it stays out, and the ties take the
    lower positions across the block boundary."""
    got = world["by_id"]["select"][1]
    pad = got[list(SELECT).index("padding-k16")]
    assert (pad < 17).all() and (pad[:, 0] == 0).all()
    ties = got[list(SELECT).index("ties-k5")]
    np.testing.assert_array_equal(ties, np.tile([0, 6, 7, 8, 9], (3, 1)))


@pytest.mark.parametrize("case", list(SAMPLE))
def test_token_cached_sampler_matches_jax(world, case):
    spec, jkey, mode, fn, kw = SAMPLE[case]
    x = world["x"]
    mesh = _jax_mesh(jkey)
    jmodel = sp_clone(DiffusionViT(**TINY), mesh, sp_mode=mode)
    want = np.asarray(getattr(sampling, fn)(jmodel, world["params"], x_init=jnp.asarray(x),
                                            mesh=mesh, **TOKEN, **kw))
    one = getattr(port_sampling, fn)(_port_model(world), x_init=x, device="cpu",
                                     **TOKEN, **kw).numpy()
    assert not np.array_equal(one, getattr(port_sampling, fn)(
        _port_model(world), x_init=x, device="cpu", **kw).numpy()), "the cache did nothing"
    for rank, got in enumerate(world["by_id"][case]):
        assert got["images"].shape == (4, 16, 16, 3)
        np.testing.assert_allclose(got["images"], one, **ONE, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["images"], want, **JAX, err_msg=f"rank {rank}")


def test_w8a8_token_cache_takes_the_live_tokens_scale(world):
    """A w8a8 model's token-cached sampler on ``{seq: 2}``: a reuse step's
    activation scale is its live tokens' across both ranks, so the rows are
    the one-rank twin's and JAX's."""
    mesh = _jax_mesh("seq2")
    jmodel = sp_clone(DiffusionViT(**TINY).clone(quant="w8a8"), mesh, sp_mode="ulysses")
    want = np.asarray(sampling.ddim_sample(
        jmodel, jax_quant.quantize_params(world["params"]), x_init=jnp.asarray(world["x"]),
        mesh=mesh, **TOKEN, **W8A8))
    for rank, got in enumerate(world["by_id"]["w8a8"]):
        np.testing.assert_allclose(got["mesh"], got["one"], **ONE, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["mesh"], want, **JAX, err_msg=f"rank {rank}")


def test_token_config_across_ranks_matches_jax_at_both_buckets(world):
    """``SamplerConfig(cache_mode="token", sp_degree=2)`` served across the
    ranks: warmed in lockstep, its spare cache keyed by the sp kind, rows
    at buckets 4 and 2 JAX's engine's and the one-process engine's, no
    program after warmup on either rank (the first case of the refusal
    this slice removed)."""
    ranks = world["by_id"]["engine"]
    lead = ranks[0]
    x = world["x"]
    eng = jserve.Engine(DiffusionViT(**TINY), world["params"],
                        mesh=make_mesh(dict(DP2), devices=jax.devices()[:2]), buckets=(2, 4))
    config = jserve.SamplerConfig(**ENGINE_CFG)
    jserve.warmup(eng, [config], persistent_cache=False)
    tickets = [eng.submit(x_init=a, config=config) for a in (x[:2], x)]
    eng.run()
    want = [t.result(timeout=30) for t in tickets]
    assert lead["report"]["failed_tickets"] == 0 and lead["report"]["batches"] >= 2
    assert lead["sp_modes"] == ["ulysses"]
    assert lead["spare"] == ["(2, ('pair', 'ulysses', 2))", "(4, ('pair', 'ulysses', 2))"]
    for got, one, ref in zip(lead["rows"], lead["one_process"], want):
        np.testing.assert_allclose(got, one, **ONE)
        np.testing.assert_allclose(got, np.asarray(ref), **JAX)
    follow = ranks[1]["follow"]
    assert lead["programs_after_warmup"] == ranks[1]["programs_after_warmup"] == 0
    assert follow["new_programs"] == 0 and follow["failed_batches"] == 0
    assert follow["batches"] == lead["stats"]["dispatches"]


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_probe_under_sequence_parallelism(world, mode):
    """Every rank returns the whole (B, H, N+1, N+1) weights of layers 0
    and −1: JAX's probe on ``sp_clone`` and the one-process probe."""
    x, t = world["x"], world["t"]
    jmodel = sp_clone(DiffusionViT(**TINY), _jax_mesh("seq2"), sp_mode=mode)
    port = _port_model(world)
    for layer in PROBE_LAYERS:
        want = np.asarray(jmodel.apply({"params": world["params"]}, jnp.asarray(x),
                                       jnp.asarray(t), return_attention_layer=layer))
        with torch.no_grad():
            one = port(torch.from_numpy(x), torch.from_numpy(t),
                       return_attention_layer=layer).numpy()
        for rank, res in enumerate(world["by_id"][f"probe-{mode}"]):
            got = res["weights"][layer]
            assert got.shape == (4, 4, 17, 17)
            np.testing.assert_allclose(got, one, **ONE, err_msg=f"layer {layer} rank {rank}")
            np.testing.assert_allclose(got, want, **PROBE_JAX,
                                       err_msg=f"layer {layer} rank {rank}")


def test_probe_keeps_the_dropout_error(world):
    """A training forward with attention dropout active raises JAX's
    sequence-parallel ValueError before the probed layer."""
    for mode in ("ulysses", "ring"):
        for res in world["by_id"][f"probe-{mode}"]:
            assert "sequence-parallel attention cannot apply attention-dropout" in (
                res["dropout_error"])
