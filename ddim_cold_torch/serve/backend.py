"""Child-process engine construction — the torch-touching half of
serve/replica_main.py.

Counterpart of ``ddim_cold_tpu/serve/backend.py``. replica_main stays
host-only, but an ``"engine"``-backend replica needs a model on the card
and an Engine over it. That construction lives HERE, behind one deferred
import, so everything the parent process imports for the fleet
(router.py, fleet.py, remote.py, replica_main.py, autoscale.py) stays
host-only and torch loads its device state only inside the child that
serves on it.

Spec fields consumed (see :func:`~ddim_cold_torch.serve.remote.remote_factory`
for the full grammar):

* ``model`` — ``DiffusionViT`` kwargs with ``dtype`` as a string and
  ``img_size`` as a list, plus the port's own key ``"device"``: absent, the
  model goes to ``"cuda"`` and the child raises without a card, as every
  entry point does (it never serves on the CPU by itself); the CPU tests
  pass ``"cpu"``.
* ``params_npz`` — a JAX ``DiffusionViT`` parameter tree saved by
  :func:`~ddim_cold_torch.serve.remote.save_params_npz` (either package's):
  converted by ``utils/weights.state_dict_from_flax`` and loaded strict,
  the path on which a port replica computes what a JAX replica computes;
* ``init_seed`` — otherwise, the port's own seeded init
  (``DiffusionViT(seed=...)``): two port replicas built from one seed hold
  bitwise-equal weights (and the rows of a parent built from that seed). A
  JAX replica built from the same seed does NOT hold the same weights: the
  two packages draw their inits from different generators.
* ``engine`` — Engine kwargs (``buckets``, ``max_queue``, ...); the
  engine's device is the model's.

JAX's ``cache_dir`` is not read: there is no compiler cache; the kernel
libraries are built once into ``build/`` and every process loads them.
"""

from __future__ import annotations

import torch

from ddim_cold_torch.models.vit import DiffusionViT
from ddim_cold_torch.serve.engine import Engine
from ddim_cold_torch.serve.fleet import LocalReplica
from ddim_cold_torch.serve.remote import load_params_npz
from ddim_cold_torch.utils.weights import state_dict_from_flax

#: spec-string → torch dtype (specs are JSON; a dtype object does not travel)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def build_model(model_spec: dict, seed: int = 0) -> DiffusionViT:
    """The spec's model, with the seeded init of ``seed``, on the spec's
    ``"device"`` (absent: ``"cuda"``, which raises without a card)."""
    kw = dict(model_spec or {})
    dtype = _DTYPES[kw.pop("dtype", "float32")]
    if "img_size" in kw:
        kw["img_size"] = tuple(kw["img_size"])
    device = kw.pop("device", "cuda")
    return DiffusionViT(dtype=dtype, device=device, seed=int(seed), **kw)


def build_local_replica(replica_id: str, spec: dict) -> LocalReplica:
    model = build_model(spec.get("model"), spec.get("init_seed", 0))
    if spec.get("params_npz"):
        tree = load_params_npz(spec["params_npz"])
        model.load_state_dict(state_dict_from_flax(tree, model.patch_size),
                              strict=True)
    engine = Engine(model, replica_id=replica_id, device=model.device,
                    **(spec.get("engine") or {}))
    return LocalReplica(engine)
