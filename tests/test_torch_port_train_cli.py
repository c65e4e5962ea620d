"""The trainer as users start it, and its crash-safe checkpoints, on the CPU.

* ``python -m ddim_cold_torch train <ExpName>`` (``ddim_cold_torch.__main__.
  main``) on the 16 px, depth-2 YAML of JAX's ``tests/test_cli.py``: the
  launcher's run-dir surface (the YAML copy, ``train.log`` with its
  ``TrainSet batchs:`` and ``epoch:`` lines, ``bestloss.ckpt``,
  ``bestloss.pkl``, ``lastepoch.ckpt`` — a file here, a directory in JAX);
  without CUDA and without ``--device cpu`` it exits 3 and writes no run
  dir; a resume from its ``lastepoch.ckpt`` restores the epoch, the step
  count, the EMA loss and the best metric.
* ``utils/checkpoint.save_checkpoint`` under the ``ckpt.save`` fault site:
  for each of JAX's four crash windows a permanent fault leaves the version
  JAX's ``save_checkpoint`` + ``recover_swap`` leave (each package run on
  the same windows; JAX's orbax writer reduced to a pickle, its swap
  protocol unchanged), the next save succeeds and leaves no temp file; a
  transient mid-swap fault heals on the retry in both packages; a
  ``<path>.<pid>.writing`` left by a dead writer is removed by the next
  save of that path.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from ddim_cold_torch import __main__ as cli
from ddim_cold_torch.utils import checkpoint as port_ckpt
from ddim_cold_torch.utils import faults as port_faults
from ddim_cold_tpu.utils import faults as jax_faults

WINDOWS = ("pre-write", "post-write", "mid-swap", "post-swap")


def _exp_yaml(tmp_path, images, name="exp", **over):
    """JAX tests/test_cli.py's launcher YAML (16 px, patch 8, depth 2)."""
    cfg = dict(initializing="none", resume="none", AMP=False, framework="smoke",
               num_gpus=1, batch_size=2, epoch=[0, 1], base_lr=0.005,
               dataStorage=[images, images], image_size=[16, 16], diff_step=4,
               patch_size=8, embed_dim=32, depth=2, head=4)
    cfg.update(over)
    with open(tmp_path / f"{name}.yaml", "w") as f:
        yaml.safe_dump(cfg, f)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, synthetic_image_dir):
    """One ``train exp`` run at the working directory, TensorBoard off (its
    import pulls in TensorFlow here; metrics.jsonl is written either way)."""
    tmp = tmp_path_factory.mktemp("port_cli")
    _exp_yaml(tmp, synthetic_image_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.chdir(tmp)
        rc = cli.main(["train", "exp"], base_dir=str(tmp), device="cpu")
    return tmp, rc


def test_train_writes_the_launchers_run_dir(cli_run):
    tmp, rc = cli_run
    assert rc == 0
    run_dir = tmp / "Saved_Models" / "expsmoke"
    assert {"exp.yaml", "train.log", "bestloss.ckpt", "bestloss.pkl",
            "lastepoch.ckpt"} <= set(os.listdir(run_dir))
    assert (run_dir / "lastepoch.ckpt").is_file()
    log = (run_dir / "train.log").read_text()
    assert "TrainSet batchs:5" in log and "epoch:    0" in log
    last = port_ckpt.load_checkpoint(str(run_dir / "lastepoch.ckpt"))
    assert (last["epoch"], last["steps"]) == (0, 5)
    assert not [n for n in os.listdir(run_dir) if n.endswith(".writing")]


def test_train_needs_cuda_unless_told(tmp_path, synthetic_image_dir, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _exp_yaml(tmp_path, synthetic_image_dir)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "exp"], base_dir=str(tmp_path)) == cli.NO_ACCELERATOR
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "Saved_Models").exists()
    assert cli.main(["no-such-command"]) == 2 and set(cli.COMMANDS) == {
        "train", "sample", "edit", "fid", "fid-trend", "publish", "attrib-report",
        "obs-report", "make-dataset", "loader-check"}


def test_resume_restores_epoch_steps_loss_and_metric(cli_run, synthetic_image_dir,
                                                     monkeypatch, capsys):
    """A second run of the same experiment name resumes from the first's
    lastepoch.ckpt (``--device cpu`` on the command line this time)."""
    tmp, _ = cli_run
    run_dir = tmp / "Saved_Models" / "expsmoke"
    last = port_ckpt.load_checkpoint(str(run_dir / "lastepoch.ckpt"))
    _exp_yaml(tmp, synthetic_image_dir, epoch=[0, 2],
              resume=str(run_dir / "lastepoch.ckpt"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp)
    assert cli.main(["train", "exp", "--device", "cpu"], base_dir=str(tmp)) == 0
    out = capsys.readouterr().out
    assert "Warning!Current folder already exist!" in out
    assert "best val loss" in out and "after 10 steps" in out
    log = (run_dir / "train.log").read_text()
    assert "resuming from epoch        1 of" in log
    assert f"recovering best_loss {last['metric']:4f}" in log and "epoch:    1" in log
    after = port_ckpt.load_checkpoint(str(run_dir / "lastepoch.ckpt"))
    assert (after["epoch"], after["steps"]) == (1, 10)
    assert after["opt_state"]["count"] == 10
    assert after["metric"] <= last["metric"]
    assert after["loss_rec"] != last["loss_rec"]  # the EMA went on from the saved one


# ------------------------------------------------------------- crash windows


class _PickleDirCheckpointer:
    """orbax's ``PyTreeCheckpointer`` reduced to one pickle in the checkpoint
    directory: what is held here is JAX's swap protocol (its renames,
    windows and ``recover_swap``), which is JAX's own code either way, and
    a real orbax save costs ~2 s on this machine."""

    def save(self, path, tree, force=False):
        os.makedirs(path, exist_ok=force)
        with open(os.path.join(path, "tree.pkl"), "wb") as f:
            pickle.dump(tree, f)

    def restore(self, path, *args, **kwargs):
        with open(os.path.join(path, "tree.pkl"), "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def jax_outcomes(tmp_path_factory):
    """JAX's surviving epoch after a permanent fault in each window (then
    ``recover_swap``), and the transient mid-swap retry's epoch. The
    stand-in module also spares the 5 s import of ``orbax.checkpoint``."""
    import orbax

    from ddim_cold_tpu.utils import checkpoint as ckpt

    stand_in = types.ModuleType("orbax.checkpoint")
    stand_in.PyTreeCheckpointer = _PickleDirCheckpointer
    root = tmp_path_factory.mktemp("jax_windows")
    v2 = {"a": np.arange(3) + 10, "epoch": np.asarray(2)}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax.checkpoint", stand_in)
        mp.setattr(orbax, "checkpoint", stand_in, raising=False)
        for window in WINDOWS + ("transient",):
            p = str(root / f"{window}.ckpt")
            ckpt.save_checkpoint(p, {"a": np.arange(3), "epoch": np.asarray(1)})
            kind, where = (("transient", "mid-swap") if window == "transient"
                           else ("permanent", window))
            with jax_faults.inject(jax_faults.FaultSpec(
                    "ckpt.save", kind, match=f"window:{where}|", max_fires=1)):
                with pytest.raises(jax_faults.FaultError):
                    ckpt.save_checkpoint(p, v2)
                if window == "transient":
                    ckpt.save_checkpoint(p, {"a": np.arange(3) + 20,
                                             "epoch": np.asarray(3)})
            ckpt.recover_swap(p)
            out[window] = int(ckpt.restore_checkpoint(p)["epoch"])
    return out


def _temps(path):
    folder, name = os.path.split(path)
    return [n for n in os.listdir(folder) if n.startswith(name + ".")]


@pytest.mark.parametrize("window", WINDOWS)
def test_crash_window_leaves_jaxs_surviving_version(tmp_path, jax_outcomes, window):
    p = str(tmp_path / "state.ckpt")
    port_ckpt.save_checkpoint(p, {"a": torch.arange(3), "epoch": 1})
    spec = port_faults.FaultSpec("ckpt.save", "permanent", match=f"window:{window}|")
    with port_faults.inject(spec) as plan:
        with pytest.raises(port_faults.PermanentFault):
            port_ckpt.save_checkpoint(p, {"a": torch.arange(3) + 10, "epoch": 2})
        assert [r["tag"] for r in plan.realized] == [f"window:{window}|"]
    got = port_ckpt.load_checkpoint(p)
    assert got["epoch"] == jax_outcomes[window] == (2 if window == "post-swap" else 1)
    assert torch.equal(got["a"], torch.arange(3) + (10 if got["epoch"] == 2 else 0))
    assert _temps(p) == []
    port_ckpt.save_checkpoint(p, {"a": torch.arange(3) + 20, "epoch": 3})
    assert port_ckpt.load_checkpoint(p)["epoch"] == 3 and _temps(p) == []


def test_windows_fire_in_jaxs_order(tmp_path):
    """One save fires the four windows in JAX's order; the reference pkl
    fires none, as JAX's ``save_torch_pkl`` fires none."""
    with port_faults.inject(port_faults.FaultSpec("ckpt.save", "latency",
                                                  latency_s=0.0)) as plan:
        port_ckpt.save_checkpoint(str(tmp_path / "x.ckpt"), {"e": 1})
        port_ckpt.save_torch_pkl({"w": torch.ones(2)}, str(tmp_path / "x.pkl"))
        tags = [r["tag"] for r in plan.realized]
    assert tags == [f"window:{w}|" for w in WINDOWS]


def test_transient_mid_swap_heals_on_retry(tmp_path, jax_outcomes):
    p = str(tmp_path / "state.ckpt")
    port_ckpt.save_checkpoint(p, {"a": torch.arange(3), "epoch": 1})
    with port_faults.inject(port_faults.FaultSpec(
            "ckpt.save", "transient", match="window:mid-swap|", max_fires=1)):
        with pytest.raises(port_faults.TransientFault):
            port_ckpt.save_checkpoint(p, {"a": torch.arange(3) + 10, "epoch": 2})
        port_ckpt.save_checkpoint(p, {"a": torch.arange(3) + 20, "epoch": 3})
    assert port_ckpt.load_checkpoint(p)["epoch"] == jax_outcomes["transient"] == 3
    assert _temps(p) == []


def test_dead_writers_temp_file_is_removed_by_the_next_save(tmp_path):
    """What a SIGKILLed writer leaves (``<path>.<pid>.writing``) goes at the
    next save of that path; a live writer's and another path's stay."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    p = str(tmp_path / "lastepoch.ckpt")
    stray = f"{p}.{dead.pid}.writing"
    live = f"{p}.{os.getppid()}.writing"
    other = str(tmp_path / f"bestloss.ckpt.{dead.pid}.writing")
    for f in (stray, live, other):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
    port_ckpt.save_checkpoint(p, {"epoch": 0})
    assert not os.path.exists(stray)
    assert os.path.exists(live) and os.path.exists(other)
    assert port_ckpt.load_checkpoint(p) == {"epoch": 0}


def test_two_ranks_on_the_cpu_write_once_and_resume(tmp_path, synthetic_image_dir,
                                                    monkeypatch, capsys):
    """``num_gpus: 2`` with ``--device cpu``: two gloo ranks spawned over a
    local rendezvous (global batch 2 × 2, each rank its data shard of the
    10 images: 2 steps an epoch). Rank 0 alone writes: one ``Date:`` line,
    one line per epoch, one scalar per epoch, the checkpoints; the other
    rank prints nothing. A second run resumes from its lastepoch.ckpt."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' intra-op threads
    # TensorBoard off in the ranks too (its import pulls in TensorFlow here,
    # ~17 s): spawned processes take this process's sys.path, where a stub
    # ``tensorboard`` that refuses to import comes first
    stub = tmp_path / "stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("TensorBoard is off here")\n')
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    monkeypatch.chdir(tmp_path)
    _exp_yaml(tmp_path, synthetic_image_dir, name="dp", num_gpus=2)
    assert cli.main(["train", "dp"], base_dir=str(tmp_path), device="cpu") == 0
    run_dir = tmp_path / "Saved_Models" / "dpsmoke"
    log = (run_dir / "train.log").read_text()
    assert log.count("Date: ") == 1 and log.count("epoch:    0") == 1
    assert "TrainSet batchs:2" in log
    assert "process group: gloo, 2 ranks, mesh {'data': 2}" in log
    assert len((run_dir / "metrics.jsonl").read_text().splitlines()) == 1
    assert {"dp.yaml", "train.log", "metrics.jsonl", "bestloss.ckpt", "bestloss.pkl",
            "lastepoch.ckpt"} <= set(os.listdir(run_dir))
    assert not [n for n in os.listdir(run_dir) if n.endswith((".writing", ".tmp"))]
    last = port_ckpt.load_checkpoint(str(run_dir / "lastepoch.ckpt"))
    assert (last["epoch"], last["steps"]) == (0, 2)
    assert capsys.readouterr().out.count("best val loss") == 1

    _exp_yaml(tmp_path, synthetic_image_dir, name="dp", num_gpus=2, epoch=[0, 2],
              resume=str(run_dir / "lastepoch.ckpt"))
    assert cli.main(["train", "dp"], base_dir=str(tmp_path), device="cpu") == 0
    log = (run_dir / "train.log").read_text()
    assert log.count("resuming from epoch        1 of") == 1 and log.count("epoch:    1") == 1
    after = port_ckpt.load_checkpoint(str(run_dir / "lastepoch.ckpt"))
    assert (after["epoch"], after["steps"], after["opt_state"]["count"]) == (1, 4, 4)
