"""JAX parameter tree → the port's state_dict.

The port's own copy of ``ddim_cold_tpu/utils/checkpoint.py``'s
``torch_state_dict_from_flax`` (and the ``scan_blocks`` unstack it relies
on): it takes the JAX model's parameter tree as nested dicts of numpy
arrays — ``jax.device_get(params)`` gives exactly that — and returns float32
tensors under the reference torch key names, which
:class:`ddim_cold_torch.models.vit.DiffusionViT` loads with ``strict=True``.
A tree from JAX's ``quantize_params`` carries each trunk linear as
``w_int8`` + ``scale`` leaves; they become ``….w_int8`` (int8, transposed to
torch's ``(out, in)``) and ``….scale`` entries, which a ``quant`` model loads:
the same state_dict as ``quantize_state_dict(state_dict_from_flax(float
tree))``. A Switch-MoE tree (``num_experts`` > 1) carries each block's
expert bank as ``blocks.{i}.moe.{router,w1,b1,w2,b2}`` in JAX's own layout
(the bank's parameters are not linears: nothing is transposed); a
``scan_blocks`` tree's stacked ``w1`` (depth, E, D, H) is unstacked on its
leading layer axis like every other block leaf.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_block_params(params: dict) -> dict:
    """A ``scan_blocks`` tree's stacked ``blocks`` subtree (leading layer
    axis) → per-layer ``blocks_{i}`` subtrees; other trees pass through."""
    if "blocks" not in params:
        return dict(params)
    out = {k: v for k, v in params.items() if k != "blocks"}
    stacked = params["blocks"]
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    for i in range(np.asarray(leaf).shape[0]):
        out[f"blocks_{i}"] = _map(lambda a, _i=i: np.asarray(a)[_i], stacked)
    return out


def state_dict_from_flax(params, patch_size: int) -> dict:
    """The JAX ``DiffusionViT`` parameter tree (either block layout, dense
    or with expert banks) as the port's state_dict."""
    params = unstack_block_params(params)

    def g(*keys):
        node = params
        for key in keys:
            node = node[key]
        return np.asarray(node, dtype=np.float32)

    p = patch_size
    pk = g("patch_embed", "proj", "kernel")  # (p²C, E), (row, col, channel) rows
    e = pk.shape[1]
    c = pk.shape[0] // (p * p)
    sd = {
        "cls_token": g("cls_token"),
        **({"pos_embed": g("pos_embed")} if "pos_embed" in params else {}),
        "time_embed.weight": g("time_embed", "embedding"),
        "patch_embed.proj.weight": pk.reshape(p, p, c, e).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": g("patch_embed", "proj", "bias"),
        "norm.weight": g("norm", "scale"),
        "norm.bias": g("norm", "bias"),
        "head.weight": g("head", "kernel").T,
        "head.bias": g("head", "bias"),
    }
    i = 0
    while f"blocks_{i}" in params:
        b, t = f"blocks_{i}", f"blocks.{i}."
        sd[t + "norm1.weight"] = g(b, "norm1", "scale")
        sd[t + "norm1.bias"] = g(b, "norm1", "bias")
        sd[t + "norm2.weight"] = g(b, "norm2", "scale")
        sd[t + "norm2.bias"] = g(b, "norm2", "bias")
        linears = (("attn", "qkv"), ("attn", "proj"))
        if "moe" in params[b]:
            for leaf in ("router", "w1", "b1", "w2", "b2"):
                sd[f"{t}moe.{leaf}"] = g(b, "moe", leaf)
        else:
            linears += (("mlp", "fc1"), ("mlp", "fc2"))
        for parent, name in linears:
            mod, key = params[b][parent][name], f"{t}{parent}.{name}."
            if "w_int8" in mod:  # a quantize_params tree: codes (in, out) int8
                sd[key + "w_int8"] = np.ascontiguousarray(
                    np.asarray(mod["w_int8"], dtype=np.int8).T)
                sd[key + "scale"] = g(b, parent, name, "scale")
            else:
                sd[key + "weight"] = g(b, parent, name, "kernel").T
            if "bias" in mod:
                sd[key + "bias"] = g(b, parent, name, "bias")
        i += 1
    return {k: torch.tensor(v) for k, v in sd.items()}
