"""Path-based sharding rules: FSDP ("data") + Megatron TP ("model"), as
in ``repro.models.sharding``.

Model code is mesh-agnostic; these rules attach a partition spec
(:class:`~repro_torch.nn.constrain.P`) to every parameter /
optimizer-state / cache leaf by matching its tree path and shape.  The
engine is *divisibility-greedy*: each dimension lists candidate mesh-axis
groups in preference order and gets the first group that (a) divides the
dimension and (b) is not already used by another dimension of the same
leaf.  Architectures whose dimensions don't divide the mesh (qwen2-moe's
60 experts, mamba2's 50280 vocab) degrade to the next candidate or to
replication.

Scheme (single-pod ("data", "model") and multi-pod ("pod", "data",
"model")):

* batch            -> ("pod", "data")      (DP across pods and data axis)
* parameters       -> FSDP over "data" on one dim, TP over "model" on the
                      other; the "pod" axis does NOT shard parameters, so
                      FSDP all-gathers stay inside a pod and only the
                      gradient all-reduce crosses pods.
* KV caches        -> batch over ("pod","data"), kv-heads (or head_dim)
                      over "model"; long_500k (batch=1) shards the
                      sequence dimension over "data" instead.

Where the reference attaches a ``NamedSharding`` to each leaf, the port
attaches its DTensor placements (:func:`~repro_torch.nn.constrain.
placements`): ``param_shardings`` and ``cache_shardings`` map a tree to a
tree of placement tuples.  The rules read axis sizes through
:func:`~repro_torch.nn.constrain.axis_sizes`, so ``mesh`` may be a
``DeviceMesh``, an object whose ``shape`` maps axis names to sizes, or
such a mapping.
"""
from __future__ import annotations

import fnmatch
import re
from typing import Any, Optional, Sequence

from repro_torch.nn.constrain import (P, activation_sharding,  # noqa: F401
                                      axis_sizes, constrain, constrain_act,
                                      data_axes, placements)

Axes = tuple[str, ...]            # one axis group, e.g. ("pod", "data")
DimPrefs = Sequence[Axes]         # candidates for one dim, in pref. order
Rule = Sequence[DimPrefs]         # one entry per *logical* dim of the leaf

# ---------------------------------------------------------------------------
# Parameter rules, matched right-to-left on the leaf path.  Leaves with more
# dims than the rule (scan-stacked layers, stacked experts) get leading None.
# ---------------------------------------------------------------------------

DATA = (("data",),)
MODEL = (("model",),)
NONE: DimPrefs = ()

PARAM_RULES: list[tuple[str, Rule]] = [
    # embeddings: vocab TP for the logits matmul, d_model FSDP
    ("*embed/embedding", (MODEL, DATA)),
    ("*dec_pos/embedding", (NONE, DATA)),
    ("*lm_head/kernel", (DATA, MODEL)),
    # attention
    ("*/wq/kernel", (DATA, MODEL)),
    ("*/wk/kernel", (DATA, MODEL)),
    ("*/wv/kernel", (DATA, MODEL)),
    ("*/wo/kernel", (MODEL, DATA)),
    ("*/wq/bias", (MODEL,)),
    ("*/wk/bias", (MODEL,)),
    ("*/wv/bias", (MODEL,)),
    # moe (BEFORE the dense-mlp rules: first match wins and the generic
    # "*/gate/kernel" would shadow the expert paths): experts (E, D, F),
    # the expert dim FSDP over "data" where E divides, the expert FFN
    # width TP over "model".  param_mode="ep_model" flips the expert dim
    # to "model", so each model shard owns E/16 experts
    ("*/experts/gate/kernel", (DATA, DATA, MODEL)),
    ("*/experts/up/kernel", (DATA, DATA, MODEL)),
    ("*/experts/down/kernel", (DATA, MODEL, DATA)),
    ("*/router/kernel", (NONE, NONE)),
    # dense mlp (also matches the fused shared-expert SwiGLU)
    ("*/gate/kernel", (DATA, MODEL)),
    ("*/up/kernel", (DATA, MODEL)),
    ("*/down/kernel", (MODEL, DATA)),
    # ssm
    ("*/ssm/in_proj/kernel", (DATA, MODEL)),
    ("*/ssm/out_proj/kernel", (MODEL, DATA)),
    # rg-lru
    ("*/rglru/in_x/kernel", (DATA, MODEL)),
    ("*/rglru/in_gate/kernel", (DATA, MODEL)),
    ("*/rglru/w_a/kernel", (DATA, MODEL)),
    ("*/rglru/w_i/kernel", (DATA, MODEL)),
    ("*/rglru/out/kernel", (MODEL, DATA)),
]


def _choose(shape: Sequence[int], rule: Rule, mesh) -> P:
    """Greedy divisibility-checked assignment of axis groups to dims."""
    extra = len(shape) - len(rule)
    assert extra >= 0, (shape, rule)
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    parts: list[Any] = [None] * extra
    for dim, prefs in zip(shape[extra:], rule):
        pick = None
        for axes in prefs:
            size = 1
            for a in axes:
                size *= sizes[a]
            if dim % size == 0 and not (set(axes) & used):
                pick = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        parts.append(pick)
    return P(*parts)


def _strip_data(rule: Rule) -> Rule:
    """tp_only mode: drop FSDP ("data") candidates — params replicate over
    the data axes.  Right for decode, where a per-step FSDP all-gather of
    the full parameter set dwarfs the one token's compute."""
    return tuple(tuple(axes for axes in prefs
                       if "data" not in axes) for prefs in rule)


def param_spec(path: str, shape: Sequence[int], mesh, *,
               mode: str = "fsdp_tp") -> P:
    for pat, rule in PARAM_RULES:
        if fnmatch.fnmatch(path, pat):
            if len(shape) < len(rule):   # e.g. unexpected rank; replicate
                return P()
            if mode == "tp_only":
                rule = _strip_data(rule)
            elif mode == "ep_model" and "/experts/" in path:
                rule = (MODEL,) + tuple(rule[1:])
            return _choose(shape, rule, mesh)
    return P()  # norms, biases, scalars: replicated


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` at every leaf of a nested dict, with the path
    strings of ``tree_paths``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_shardings(param_shapes: Any, mesh, *,
                    mode: str = "fsdp_tp") -> Any:
    """Tree of tensors (meta or real) -> tree of DTensor placements."""
    return _map_with_path(lambda p, v: placements(
        param_spec(p, v.shape, mesh, mode=mode), mesh), param_shapes)


# ---------------------------------------------------------------------------
# Batch / cache / state specs
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> Axes:
    return data_axes(mesh)


def cache_spec(path: str, shape: Sequence[int], mesh, batch: int) -> P:
    """KV caches (…, B, S, KV, D), SSM states (…, B, H, P, N), conv
    states, RG-LRU states (…, B, W).

    batch-shardable => dim holding ``batch`` gets the data axes; for
    batch=1 (long_500k) the sequence dim of KV caches gets "data".
    """
    sizes = axis_sizes(mesh)
    daxes = batch_axes(sizes)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]

    shape = tuple(shape)
    parts: list[Any] = [None] * len(shape)
    used: set[str] = set()

    # locate the batch dim: first dim equal to `batch` (skipping stacked
    # leading layer dims which equal n_pattern/L, usually != batch)
    b_dim = None
    for i, d in enumerate(shape):
        if d == batch:
            b_dim = i
            break
    if b_dim is not None and batch % dsize == 0 and batch >= dsize:
        parts[b_dim] = daxes if len(daxes) > 1 else daxes[0]
        used.update(daxes)

    is_kv = path.endswith("/k") or path.endswith("/v") \
        or re.search(r"/(k|v)$", path) is not None
    if is_kv and len(shape) >= 4:
        s_dim, kv_dim, hd_dim = len(shape) - 3, len(shape) - 2, len(shape) - 1
        # sequence over "data" only if batch didn't take it (long_500k)
        if "data" not in used and shape[s_dim] % sizes["data"] == 0:
            parts[s_dim] = "data"
            used.add("data")
        if shape[kv_dim] % sizes["model"] == 0:
            parts[kv_dim] = "model"
        elif parts[s_dim] is None and \
                shape[s_dim] % sizes["model"] == 0:
            # GQA kv-head count doesn't divide the model axis: shard the
            # SEQUENCE over "model" instead (sharding head_dim would
            # regather the whole cache every decoded token)
            parts[s_dim] = "model"
        elif shape[hd_dim] % sizes["model"] == 0:
            parts[hd_dim] = "model"
    else:
        # recurrent states: shard the widest trailing dim over "model"
        cand = max(range(1 if b_dim is None else b_dim + 1, len(shape)),
                   key=lambda i: shape[i], default=None) \
            if len(shape) > 1 else None
        if cand is not None and shape[cand] % sizes["model"] == 0 \
                and shape[cand] >= sizes["model"]:
            parts[cand] = "model"
    return P(*parts)


def cache_shardings(cache_shapes: Any, mesh, batch: int) -> Any:
    return _map_with_path(lambda p, v: placements(
        cache_spec(p, v.shape, mesh, batch), mesh), cache_shapes)


def data_spec(mesh, rank: int, batch: Optional[int] = None) -> P:
    """Plain batch-major input: (B, ...), falling back to fewer (or no)
    axes when the batch does not divide (long_500k has batch=1)."""
    sizes = axis_sizes(mesh)
    candidates: list[Axes] = [batch_axes(sizes), ("data",), ("pod",)]
    for ax in candidates:
        if not all(a in sizes for a in ax):
            continue
        size = 1
        for a in ax:
            size *= sizes[a]
        if batch is None or (batch % size == 0 and batch >= size):
            return P(ax if len(ax) > 1 else ax[0], *([None] * (rank - 1)))
    return P(*([None] * rank))


def replicated(mesh) -> tuple:
    """Placements of a replicated leaf (the reference's ``P()``)."""
    return placements(P(), mesh)


__all__ = ["DATA", "MODEL", "NONE", "P", "PARAM_RULES", "activation_sharding",
           "batch_axes", "cache_shardings", "cache_spec", "constrain",
           "constrain_act", "data_spec", "param_shardings", "param_spec",
           "placements", "replicated"]
