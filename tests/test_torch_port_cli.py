"""The port's commands (``python -m ddim_cold_torch sample``, ``edit``,
``fid``, ``fid-trend``, ``publish``, ``attrib-report``, ``obs-report``,
``make-dataset``, ``loader-check``) and ``utils/image.py`` /
``utils/run_io.py`` against the JAX package's entry points, on the CPU.

The model is TINY (16 px, patch 8, C=32, depth 2, 4 heads, as JAX's
``tests/test_cli.py``): one JAX parameter tree carried into the port by
``state_dict_from_flax``; the JAX side is held to direct function calls in
module-scoped fixtures (its samplers, ``compute_fid``, the scripts'
functions), never a click run. Starts come from the JAX side (the two RNGs
differ). JAX runs on the CPU at float32 matmul precision
(tests/conftest.py).

Tolerances and why:
* PNG bytes, grid shapes, paths, dataset files, the Chrome JSON and the
  summary text of ``obs-report``, the ``attrib-report`` table: equal;
* sampler arrays (``sample``'s sequence and samples, ``edit``'s cold
  sequence and grid, draft variants and interpolation): atol 1e-4, the
  forward tolerance of tests/test_torch_port_samplers.py, over their
  4-200 steps;
* ``img2tensor``: 1e-6 (the same numpy resize; JPEG decoded by PIL on both
  sides);
* FID from the same real folder, Inception weights and sample images:
  relative 1e-6 (float64 statistics; float32 features of two libraries);
* the run-directory commands: files and JSON keys as JAX's scripts write
  them; ``load_run``'s params bitwise the trainer's ``bestloss.ckpt``.
"""

import ast
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ddim_cold_torch import __main__ as cli
from ddim_cold_torch.cli import attrib_report, compute_fid, edit, fid_trend, obs_report, sample
from ddim_cold_torch.eval import fid as port_fid
from ddim_cold_torch.eval import inception as port_inception
from ddim_cold_torch.models import MODEL_CONFIGS as PORT_CONFIGS
from ddim_cold_torch.models import DiffusionViT as PortViT
from ddim_cold_torch.obs import attrib as port_attrib
from ddim_cold_torch.utils import checkpoint as port_ckpt
from ddim_cold_torch.utils import image as port_image
from ddim_cold_torch.utils import run_io as port_run_io
from ddim_cold_torch.utils.weights import state_dict_from_flax
from ddim_cold_tpu.models import DiffusionViT
from ddim_cold_tpu.ops import sampling
from ddim_cold_tpu.utils import image as jax_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=(16, 16), patch_size=8, embed_dim=32, depth=2, num_heads=4)
ATOL = 1e-4


def _script(path: str):
    """A JAX entry point loaded from its file (nothing of it runs)."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(path: str, target: str) -> set:
    """The keys of the dict literal assigned to ``target`` in a JAX script."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == target for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no {target} = {{...}} in {path}")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """TINY forwards at one intra-op thread: beside JAX's thread pool, eight
    made the draft restarts' 1,600 forwards take minutes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    jmodel = DiffusionViT(**TINY, total_steps=2000)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32))["params"])
    pmodel = PortViT(**TINY, total_steps=2000, device="cpu")
    pmodel.load_state_dict(state_dict_from_flax(params, TINY["patch_size"]), strict=True)
    return jmodel, params, pmodel


@pytest.fixture
def tiny_config(monkeypatch):
    monkeypatch.setitem(PORT_CONFIGS, "test_tiny", TINY)
    return "test_tiny"


# ------------------------------------------------------------------ image


def test_save_grid_writes_jaxs_png_bytes(tmp_path):
    imgs = np.random.RandomState(0).uniform(-0.1, 1.1, (5, 7, 9, 3)).astype(np.float32)
    want = jax_image.save_grid(imgs, str(tmp_path / "jax.png"), nrows=2, ncols=3)
    got = port_image.save_grid(imgs, str(tmp_path / "port.png"), nrows=2, ncols=3)
    tensor = port_image.save_grid(torch.from_numpy(imgs), str(tmp_path / "t.png"),
                                  nrows=2, ncols=3)
    data = [open(p, "rb").read() for p in (want, got, tensor)]
    assert data[0] == data[1] == data[2]
    tiles = port_image.grid_tiles(got, 5, nrows=2, ncols=3)
    np.testing.assert_array_equal(tiles, port_image.to_uint8(imgs))


def test_grid_shape_matches_jax():
    assert [port_image.grid_shape(n) for n in range(1, 301)] == [
        jax_image.grid_shape(n) for n in range(1, 301)]


def test_get_next_path_matches_jax(tmp_path):
    target = str(tmp_path / "samples.png")
    seen = []
    for _ in range(4):
        want, got = jax_image.get_next_path(target), port_image.get_next_path(target)
        assert got == want
        seen.append(got)
        open(got, "w").close()
    assert [os.path.basename(p) for p in seen] == [
        "samples.png", "samples_1.png", "samples_2.png", "samples_3.png"]


# ----------------------------------------------------------------- sample


def test_sample_arrays_match_jax(models):
    """The denoise sequence (k=100) and the samples (k=500) from JAX's
    starts, eta 0."""
    jmodel, params, pmodel = models
    x_seq = jax.random.normal(jax.random.PRNGKey(0), (sample.N_SEQ, 16, 16, 3))
    seq = sampling.ddim_sample(jmodel, params, jax.random.PRNGKey(0), k=100,
                               x_init=x_seq, return_sequence=True)
    want = jnp.swapaxes(seq, 0, 1).reshape(-1, *seq.shape[2:])
    frames, n_frames = sample.denoise_sequence(pmodel, np.asarray(x_seq))
    assert n_frames == seq.shape[0] == 21
    _close(frames, want)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 16, 3))
    _close(sample.samples(pmodel, np.asarray(x), acc_k=500),
           sampling.ddim_sample(jmodel, params, jax.random.PRNGKey(1), k=500, x_init=x))


def test_sample_command_writes_both_pngs(tiny_config, tmp_path, capsys):
    rc = cli.main(["sample", "--device", "cpu", "--config", tiny_config, "--init-random",
                   "--sample_n", "4", "--acc_k", "500", "--seed", "3"], base_dir=str(tmp_path))
    assert rc == 0
    saved = tmp_path / "Saved_Models"
    out = capsys.readouterr().out
    for name in ("denoise_sequence.png", "samples.png"):
        assert (saved / name).is_file() and f"wrote {saved / name}" in out
    model = PortViT(**TINY, total_steps=2000, device="cpu", seed=3)
    x_seq, x = sample.starts(model, 3, 4)
    want = port_image.to_uint8(sample.samples(model, x, acc_k=500).numpy())
    np.testing.assert_array_equal(
        port_image.grid_tiles(str(saved / "samples.png"), 4, nrows=2, ncols=2), want)
    assert cli.main(["sample", "--device", "cpu", "--config", tiny_config, "--init-random",
                     "--sample_n", "1", "--acc_k", "1000"], base_dir=str(tmp_path)) == 0
    assert (saved / "samples_1.png").is_file()  # get_next_path: nothing overwritten


def test_sample_reads_pkl_and_ckpt_and_refuses_orbax(models, tiny_config, tmp_path):
    _, _, pmodel = models
    sd = pmodel.state_dict()
    port_ckpt.save_torch_pkl(sd, str(tmp_path / "w.pkl"))
    port_ckpt.save_checkpoint(str(tmp_path / "w.ckpt"), {"params": sd, "opt_state": {}})
    for path in ("w.pkl", "w.ckpt"):
        model = sample.build_model(tiny_config, str(tmp_path / path), False, 0,
                                   str(tmp_path), "cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), (path, k)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        sample.build_model(tiny_config, str(tmp_path / "orbax"), False, 0, str(tmp_path), "cpu")


# ------------------------------------------------------------------- edit


@pytest.fixture(scope="module")
def d2d():
    return _script("ViT_draft2drawing.py")


def test_img2tensor_matches_jax(d2d, synthetic_image_dir):
    path = os.path.join(synthetic_image_dir, "0.jpg")
    got = edit.img2tensor(path, (16, 16))
    assert got.shape == (1, 16, 16, 3) and got.dtype == torch.float32
    _close(got, d2d.img2tensor(path, (16, 16)), atol=1e-6)


def test_cold_arrays_match_jax(models):
    """Both cold figures from JAX's starts (one colour per sample), at
    log2(16) = 4 levels."""
    jmodel, params, pmodel = models
    starts = [np.broadcast_to(np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), (3, 1, 1, 3))), (3, 16, 16, 3)).copy() for s in (5, 6)]
    frames, n_frames, grid = edit.cold_arrays(pmodel, *starts)
    seq = sampling.cold_sample(jmodel, params, jax.random.PRNGKey(5), n=3, levels=4,
                               return_sequence=True)
    assert edit.levels_of(pmodel) == 4 and n_frames == seq.shape[0] == 5
    _close(frames, jnp.swapaxes(seq, 0, 1).reshape(-1, *seq.shape[2:]))
    _close(grid, sampling.cold_sample(jmodel, params, jax.random.PRNGKey(6), n=3, levels=4))


@pytest.fixture(scope="module")
def draft(d2d, synthetic_image_dir):
    path = os.path.join(synthetic_image_dir, "2.jpg")
    return path, d2d.img2tensor(path, (16, 16))


def test_draft_tiles_match_jax(models, draft):
    """The nine restarts from JAX's ``forward_noise`` states."""
    jmodel, params, pmodel = models
    _, x = draft
    states = [sampling.forward_noise(jax.random.PRNGKey(100 + i), x, t, 2000)
              for i, t in enumerate(edit.T_STARTS)]
    want = [(x[0] + 1.0) / 2.0] + [
        sampling.sample_from(jmodel, params, s, t_start=t, k=10,
                             rng=jax.random.PRNGKey(200 + i))[0]
        for i, (t, s) in enumerate(zip(edit.T_STARTS, states))]
    got = edit.draft_tiles(pmodel, torch.from_numpy(np.array(x)),
                           [torch.from_numpy(np.array(s)) for s in states])
    assert got.shape == (10, 16, 16, 3)
    _close(got, jnp.stack(want))


def test_interp_frames_match_jax(models, d2d, synthetic_image_dir):
    """JAX's slerp_interpolate against the port's decode of JAX's
    ``interp_states``."""
    jmodel, params, pmodel = models
    a, b = (d2d.img2tensor(os.path.join(synthetic_image_dir, f"{i}.jpg"), (16, 16))[0]
            for i in (3, 4))
    rng = jax.random.PRNGKey(500)
    mixed = sampling.interp_states(rng, a, b, edit.N_INTERP, edit.INTERP_T, 2000)
    want = sampling.slerp_interpolate(jmodel, params, rng, a, b, n_interp=8, t_start=1800,
                                      k=10)
    _close(edit.interp_frames(pmodel, np.asarray(mixed)), want)


def test_edit_command_writes_four_pngs(tiny_config, tmp_path, draft, synthetic_image_dir,
                                       capsys):
    path, x = draft
    rc = cli.main(["edit", "--device", "cpu", "--config", tiny_config, "--init-random",
                   "--cold-n", "2", "--draft", path, "--interpolate",
                   os.path.join(synthetic_image_dir, "3.jpg"),
                   os.path.join(synthetic_image_dir, "4.jpg")], base_dir=str(tmp_path))
    assert rc == 0
    saved = tmp_path / "Saved_Models"
    for name in ("cold_sequence.png", "cold_samples.png", "draft2img.png",
                 "interpolation.png"):
        assert (saved / name).is_file(), name
    tiles = port_image.grid_tiles(str(saved / "draft2img.png"), 10, nrows=2, ncols=5)
    np.testing.assert_array_equal(tiles[0], port_image.to_uint8((np.asarray(x[0]) + 1) / 2))
    seq = port_image.grid_tiles(str(saved / "cold_sequence.png"), 10, nrows=2, ncols=5)
    assert seq.shape == (10, 16, 16, 3)  # 2 samples × (start + 4 levels)


# ---------------------------------------------------------------- run dirs


def _run_yaml(path, data, **over):
    """JAX tests/test_cli.py's launcher YAML (16 px, patch 8, depth 2)."""
    cfg = dict(initializing="none", resume="none", AMP=False, framework="smoke",
               num_gpus=1, batch_size=2, epoch=[0, 3], base_lr=0.005,
               dataStorage=[data, data], image_size=[16, 16], diff_step=4,
               patch_size=8, embed_dim=32, depth=2, head=4, snapshot_epochs=1)
    cfg.update(over)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, synthetic_image_dir):
    """A finished run of ``python -m ddim_cold_torch train exp --device
    cpu``: three epochs, a snapshot each (TensorBoard off: its import pulls
    TensorFlow in here)."""
    tmp = tmp_path_factory.mktemp("port_run")
    _run_yaml(tmp / "exp.yaml", synthetic_image_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.chdir(tmp)
        assert cli.main(["train", "exp"], base_dir=str(tmp), device="cpu") == 0
    return tmp, tmp / "Saved_Models" / "expsmoke"


def test_load_run_gives_the_trainers_best_params(run_dir):
    _, run = run_dir
    config, model, params = port_run_io.load_run(str(run), device="cpu")
    assert config.run_name == "expsmoke" and model.dtype == torch.bfloat16
    assert model.use_flash is False and tuple(model.img_size) == (16, 16)
    best = port_ckpt.load_checkpoint(str(run / "bestloss.ckpt"))
    assert set(params) == set(best)
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k].to(v.dtype)), k
    _, _, template = port_run_io.load_run_template(str(run), device="cpu")
    seeded = PortViT(**TINY, total_steps=2000, dtype=torch.bfloat16, device="cpu").state_dict()
    for k, v in template.items():  # the seed-0 init, whatever the device
        assert torch.equal(v, seeded[k]), k


def test_default_val_dir_matches_jax(tmp_path, synthetic_image_dir):
    from ddim_cold_tpu.config import load_config as jax_load_config
    from ddim_cold_tpu.utils import run_io as jax_run_io

    from ddim_cold_torch.config import load_config

    for i, data in enumerate((synthetic_image_dir, "OxfordFlowers/val")):
        _run_yaml(tmp_path / f"e{i}.yaml", data)
        got = port_run_io.default_val_dir(load_config(str(tmp_path / f"e{i}.yaml")), "/r")
        want = jax_run_io.default_val_dir(jax_load_config(str(tmp_path / f"e{i}.yaml")), "/r")
        assert got == want
    _run_yaml(tmp_path / "none.yaml", "")
    with pytest.raises(ValueError, match="--val-dir"):
        port_run_io.default_val_dir(load_config(str(tmp_path / "none.yaml")), "/r")


def test_fid_trend_points_are_random_snapshots_best(run_dir, tmp_path):
    _, run = run_dir
    assert sorted(os.listdir(run / "snapshots")) == [
        "epoch_0.ckpt", "epoch_1.ckpt", "epoch_2.ckpt"]
    pts = fid_trend.collect_points(str(run), max_points=2)
    assert [p[0] for p in pts] == ["random", "epoch_0", "epoch_2", "best"]
    assert [p[1] for p in pts] == [-1, 0, 2, None] and pts[0][2] is None
    assert pts[-1][2].endswith("bestloss.ckpt")
    assert [p[0] for p in fid_trend.collect_points(str(tmp_path), 4)] == ["random"]


def _proxy_features(monkeypatch, dim=64):
    """A fixed 64-dim linear projection in place of the 299 px InceptionV3
    (the command's plumbing is under test here, not the extractor)."""
    proj = torch.from_numpy(np.random.RandomState(1).randn(16 * 16 * 3, dim)
                            .astype(np.float32))

    def make_feature_fn(model=None, variables=None, *, device=None):
        return (lambda imgs: torch.as_tensor(np.asarray(imgs, np.float32))
                .reshape(len(imgs), -1) @ proj), dim

    monkeypatch.setattr(port_fid, "make_feature_fn", make_feature_fn)


def test_fid_and_fid_trend_commands_write_jaxs_keys(run_dir, monkeypatch, capsys):
    """``fid`` (cold and ddim) and ``fid-trend`` end to end on the run, with
    the extractor reduced to a projection: JAX's file names and keys,
    finite values, ``n_real`` what was read."""
    base, run = run_dir
    _proxy_features(monkeypatch)
    for sampler, metric in (("cold", "fid_cold"), ("ddim", "fid_ddim_k500")):
        assert cli.main(["fid", str(run), "--cpu", "--n-samples", "4", "--batch", "2",
                         "--n-real", "6", "--sampler", sampler, "--k", "500"],
                        base_dir=str(base)) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(out) == _dict_keys("scripts/compute_fid.py", "out")
        assert out["metric"] == metric and np.isfinite(out["value"])
        assert (out["n_samples"], out["n_real"], out["run"]) == (4, 6, "expsmoke")
        assert json.load(open(base / "results" / "expsmoke" / "fid.json")) == out
    assert cli.main(["fid-trend", str(run), "--cpu", "--n-samples", "2", "--batch", "2",
                     "--n-real", "4", "--max-points", "2"], base_dir=str(base)) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == _dict_keys("scripts/fid_trend.py", "out")
    assert [p["ckpt"] for p in out["points"]] == ["random", "epoch_0", "epoch_2", "best"]
    assert all(np.isfinite(p["fid"]) for p in out["points"])
    assert "delta_rel" in out["points"][1] and out["run_meta"]["device_kind"] == "cpu"
    assert (base / "results" / "expsmoke" / "fid_trend.json").is_file()


def test_publish_writes_artifacts_at_the_runs_levels(run_dir, monkeypatch):
    """JAX tests/test_cli.py's check: the five artifacts, and both cold
    grids at the run's log2(16) = 4 levels."""
    from ddim_cold_torch.ops import sampling as port_sampling

    base, run = run_dir
    seen = []
    real = port_sampling.cold_sample

    def spy(model, generator=None, **kw):
        seen.append(kw.get("levels", 6))
        return real(model, generator, **kw)

    monkeypatch.setattr(port_sampling, "cold_sample", spy)
    assert cli.main(["publish", str(run), "--cpu"], base_dir=str(base)) == 0
    out = base / "results" / "expsmoke"
    for name in ("val_curve.png", "samples.png", "cold_sequence.png", "summary.json",
                 "train.log"):
        assert (out / name).is_file(), name
    assert seen == [4, 4]
    summary = json.load(open(out / "summary.json"))
    assert set(summary) == _dict_keys("scripts/publish_run.py", "summary")
    assert summary["epochs"] == 3


# -------------------------------------------------------------------- fid


def test_fid_matches_jax(models, synthetic_image_dir, monkeypatch):
    """JAX's ``compute_fid`` and the command's measurement on the same val
    folder, JAX's Inception weights and the same injected sample images:
    the feature statistics within float32 noise (rtol 1e-4 of each entry,
    atol 1e-5 of the largest: covariance entries near 0 are differences of
    large products), the distance of JAX's own statistics
    recomputed by the port in float64 (rtol 1e-12), and the two FIDs within
    rtol 1e-5 — with 4 + 4 images the 2048² covariances have rank ≤ 3, and
    the square root of their product turns the extractors' float32
    differences into a few 1e-6 of the distance."""
    from ddim_cold_tpu.data import ColdDownSampleDataset, ShardedLoader
    from ddim_cold_tpu.eval import fid as jax_fid
    from ddim_cold_tpu.eval import inception as jax_inception

    stats = {}
    for name, mod in (("jax", jax_fid), ("port", port_fid)):
        def spy(a, b, _real=mod.fid_from_stats, _name=name):
            stats[_name] = (a, b)
            return _real(a, b)

        monkeypatch.setattr(mod, "fid_from_stats", spy)
    jmodel, params, pmodel = models
    inc_model, inc_vars = jax_inception.init_variables(jax.random.PRNGKey(0))
    fakes = np.random.RandomState(2).rand(4, 16, 16, 3).astype(np.float32)

    def feeder():
        batches = iter((fakes[:2], fakes[2:]))
        return lambda rng, n: next(batches)

    ds = ColdDownSampleDataset(synthetic_image_dir, imgSize=(16, 16), target_mode="direct")
    real = ((clean + 1.0) / 2.0 for _, clean, _ in
            ShardedLoader(ds, 2, shuffle=False, drop_last=True))
    want = jax_fid.compute_fid(
        jmodel, params, (b for _, b in zip(range(2), real)), rng=jax.random.PRNGKey(1),
        n_samples=4, sample_batch=2, inception_model=inc_model,
        inception_variables=inc_vars, sampler=feeder())
    port_real, seen = compute_fid.real_stream(synthetic_image_dir, (16, 16), 2, 4)
    got = compute_fid.fid_value(
        pmodel, port_real, feeder(), n_samples=4, batch=2, k=20,
        inception_model=port_inception.InceptionV3Features(),
        inception_variables=port_inception.inception_state_dict_from_flax(
            jax.device_get(inc_vars)))
    assert seen == [4]
    for (a, b) in zip(stats["port"], stats["jax"]):
        assert a.count == b.count == 4
        for x, y in ((a.mean, b.mean), (a.cov, b.cov)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5 * np.abs(y).max())
    np.testing.assert_allclose(port_fid.frechet_distance(
        stats["jax"][0].mean, stats["jax"][0].cov, stats["jax"][1].mean,
        stats["jax"][1].cov), float(want), rtol=1e-12)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


# ---------------------------------------------------------- observability


def test_obs_report_from_jsonl_matches_jax_bytes(tmp_path, capsys):
    """A span dump of the port's TINY demo drain: the Chrome JSON and the
    summary of JAX's script's functions, byte for byte."""
    jax_obs = _script("scripts/obs_report.py")
    chrome, spans = tmp_path / "demo.json", tmp_path / "spans.jsonl"
    assert cli.main(["obs-report", "--demo", "--device", "cpu", "--chrome", str(chrome),
                     "--jsonl", str(spans)]) == 0
    capsys.readouterr()
    out = tmp_path / "again.json"
    assert cli.main(["obs-report", "--from-jsonl", str(spans), "--chrome", str(out)]) == 0
    text = capsys.readouterr().out
    rows = [json.loads(line) for line in open(spans) if line.strip()]
    assert len(rows) == 10 and {r["name"] for r in rows} >= {"engine.request", "dispatch"}
    want = io.StringIO()
    jax_obs._summarize(rows, out=want)
    assert text == want.getvalue()
    assert open(out).read() == json.dumps(jax_obs._chrome_from_rows(rows))
    # the recorder's own export, from unrounded times: the same events
    assert [(e["name"], e["args"]) for e in json.load(open(out))["traceEvents"]] == [
        (e["name"], e["args"]) for e in json.load(open(chrome))["traceEvents"]]


def test_attrib_report_demo_matches_jaxs_render(tmp_path, capsys):
    jax_attrib = _script("scripts/attrib_report.py")
    report = port_attrib.demo_report()
    assert attrib_report.render(report) == jax_attrib._render(report)
    assert cli.main(["attrib-report", "--demo", "--json", str(tmp_path / "r.json")]) == 0
    text = capsys.readouterr().out
    assert text == attrib_report.render(report) + "\n"
    rows = [line.split(" | ")[0].lstrip("| ") for line in text.splitlines()
            if line.startswith("| ") and not line.startswith("| scope")]
    assert rows == [name for name, _ in port_attrib.ranked_scopes(report)]
    assert json.load(open(tmp_path / "r.json"))["scopes"].keys() == report["scopes"].keys()


# ----------------------------------------------------------- data commands


def test_make_dataset_files_match_jax_bytes(tmp_path):
    jax_make = _script("scripts/make_dataset.py")
    args = ["--train", "4", "--val", "2", "--size", "32"]
    jax_make.main(["--out", str(tmp_path / "jax")] + args)
    assert cli.main(["make-dataset", "--out", "port"] + args, base_dir=str(tmp_path)) == 0
    for split, n in (("train", 4), ("val", 2)):
        names = sorted(os.listdir(tmp_path / "jax" / split))
        assert names == sorted(os.listdir(tmp_path / "port" / split))
        assert len(names) == n
        for name in names:
            assert ((tmp_path / "jax" / split / name).read_bytes()
                    == (tmp_path / "port" / split / name).read_bytes()), name


def test_loader_check_writes_the_degradation_pairs(tmp_path, capsys):
    assert cli.main(["loader-check"], base_dir=str(tmp_path)) == 0
    assert (tmp_path / "degradation_pairs.png").is_file()
    assert "t=1..6" in capsys.readouterr().out
