"""Logical-axis -> mesh-axis rules, a copy of ``repro/sharding/rules.py``.

Every parameter, optimizer-state and cache leaf of the model zoo carries a
tuple of LOGICAL axis names ("embed", "heads", "mlp", ...).  A
``LogicalRules`` maps those names onto PHYSICAL mesh axes ("pod", "data",
"model").  The four rule sets and ``resolve_spec`` are the reference's, so
the port shards every leaf over the same mesh axes as the JAX package,
including the divisibility fallback to replication.

What differs is what a spec drives.  JAX hands the spec to GSPMD, which
places each array and inserts the collectives.  The port runs one explicit
program per rank (``models/layers.py``): a spec cuts each leaf into this
rank's local shard (``local_slice``), and the layers issue their own
collectives (``sharding/collectives.py``).  So ``with_constraint``, the
reference's activation constraint, is the identity here: the layers'
activations already have the layout their collectives made.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.tree import leaves_with_paths

# mesh axis name(s) each logical axis maps to; entries may be a single mesh
# axis, a tuple of mesh axes (sharded over both), or None (replicated).
Rule = str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per leading
    dimension (a mesh axis, a tuple of mesh axes or None), trailing Nones
    dropped, so ``tuple(spec)`` equals ``tuple(jax P)`` entry for entry."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    rules: Mapping[str, Rule]
    name: str = "custom"
    # logical axes sharded even when not divisible by the mesh axis (the
    # reference's: intermediates only; parameters pad instead)
    allow_uneven: frozenset[str] = frozenset()

    def get(self, logical: str) -> Rule:
        return self.rules.get(logical)

    def override(self, name: str = "override", **changes: Rule) -> "LogicalRules":
        merged = dict(self.rules)
        merged.update(changes)
        return LogicalRules(rules=merged, name=name,
                            allow_uneven=self.allow_uneven)


# Default: DP over (pod, data); TP over model for vocab/heads/mlp/experts.
DEFAULT_RULES = LogicalRules(name="default", rules={
    # ---- parameter axes ----
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv_flat": "model",     # flattened (heads*head_dim) projection columns
    "kv_flat": "model",      # flattened (kv_heads*head_dim) columns
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "ssm_inner": "model",    # mamba d_inner / conv channels / in_proj columns
    "ssm_heads": "model",
    "state": None,           # SSM state dim
    "conv": None,
    "layers": None,          # stacked leading axis: never sharded
    "frontend": None,
    "lora": None,
    # ---- activation axes ----
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_kv_seq": "model",   # decode-time KV-cache sequence dim
    "act_embed": None,
    "act_mlp": "model",
    "act_vocab": "model",
    "act_expert": "model",
    "act_ssm": "model",
})

# FSDP-style: additionally shard the big weight matrices' embed dim over the
# data axis (ZeRO-3-like)
FSDP_RULES = DEFAULT_RULES.override(name="fsdp", embed=("pod", "data"))

# Sequence-parallel attention: activations shard over seq instead of heads
SEQPAR_RULES = DEFAULT_RULES.override(
    name="seqparallel", act_heads=None, act_kv_heads=None, act_seq="model")

RULE_SETS = {"default": DEFAULT_RULES, "fsdp": FSDP_RULES,
             "seqparallel": SEQPAR_RULES,
             "fsdp_seqparallel": FSDP_RULES.override(
                 name="fsdp_seqparallel", act_heads=None, act_kv_heads=None,
                 act_seq="model")}

#: the rule sets the explicit per-rank program executes: all four
#: (``models/layers.py``: the Megatron program under ``default`` and
#: ``fsdp``, the sequence-parallel one under the other two; ``fsdp``'s
#: weights gathered at use)
EXECUTED_RULE_SETS = tuple(RULE_SETS)


def executed_rules(name: str) -> LogicalRules:
    """``RULE_SETS[name]``; a name that is none of them raises."""
    if name not in EXECUTED_RULE_SETS:
        raise NotImplementedError(
            f"rule set {name!r} is none of {EXECUTED_RULE_SETS}")
    return RULE_SETS[name]


def _axis_size(mesh, rule: Rule) -> int:
    if rule is None:
        return 1
    if isinstance(rule, str):
        return mesh.shape.get(rule, 1)
    size = 1
    for r in rule:
        size *= mesh.shape.get(r, 1)
    return size


def _present(mesh, rule: Rule) -> Rule:
    """Drop mesh axes the current mesh does not have (e.g. 'pod' on the
    single-pod mesh), preserving single-axis vs tuple structure."""
    if rule is None:
        return None
    if isinstance(rule, str):
        return rule if rule in mesh.shape else None
    kept = tuple(r for r in rule if r in mesh.shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def resolve_spec(rules: LogicalRules, mesh,
                 logical_axes: Sequence[str | None],
                 dims: Sequence[int] | None = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec, checking divisibility.
    ``mesh`` needs only ``.shape`` (a dict of axis sizes)."""
    parts: list[Rule] = []
    used: set[str] = set()
    for i, ax in enumerate(logical_axes):
        rule = _present(mesh, rules.get(ax)) if ax is not None else None
        if rule is not None and dims is not None and \
                ax not in rules.allow_uneven:
            if dims[i] % _axis_size(mesh, rule) != 0:
                rule = None  # replicate instead of padding
        # a mesh axis may appear at most once in a PartitionSpec
        flat = (rule,) if isinstance(rule, str) else (rule or ())
        if any(r in used for r in flat):
            rule = None
        else:
            used.update(flat)
        parts.append(rule)
    while parts and parts[-1] is None:
        parts.pop()  # trailing Nones are implicit
    return P(*parts)


def spec_axes(spec: PartitionSpec) -> tuple[str, ...]:
    """Every mesh axis a spec shards over, in order."""
    out: list[str] = []
    for part in spec:
        if part is not None:
            out.extend((part,) if isinstance(part, str) else part)
    return tuple(out)


def _index_and_count(mesh, part: Rule) -> tuple[int, int]:
    """This rank's index along ``part`` (one axis or several, major first)
    and the number of shards."""
    if part is None:
        return 0, 1
    axes = (part,) if isinstance(part, str) else part
    idx, n = 0, 1
    for a in axes:
        size = mesh.shape[a]
        idx = idx * size + mesh.coord(a)
        n *= size
    return idx, n


def shard_shape(mesh, spec: PartitionSpec, shape) -> tuple[int, ...]:
    """The local shard's shape of a leaf of global ``shape``."""
    out = list(shape)
    for d, part in enumerate(spec):
        out[d] //= _axis_size(mesh, part)
    return tuple(out)


def local_slice(mesh, spec: PartitionSpec, full: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a full tensor, as a view (callers that keep it
    copy it)."""
    t = full
    for d, part in enumerate(spec):
        idx, n = _index_and_count(mesh, part)
        if n > 1:
            size = full.shape[d] // n
            t = t.narrow(d, idx * size, size)
    return t


def tree_shardings(rules: LogicalRules, mesh, axes_tree, shape_tree=None):
    """A tree of logical-axis tuples (and optionally the matching tree of
    tensors or shapes) to the tree of per-leaf ``PartitionSpec``s."""
    specs: dict = {}
    shapes = ({"/".join(p): leaf for p, leaf in
               leaves_with_paths(shape_tree)}
              if shape_tree is not None else None)
    for path, axes in leaves_with_paths(axes_tree):
        dims = None
        if shapes is not None:
            leaf = shapes["/".join(path)]
            dims = tuple(getattr(leaf, "shape", leaf))
        node = specs
        for k in path[:-1]:
            node = node.setdefault(k, {})
        spec = resolve_spec(rules, mesh, axes, dims)
        if path:
            node[path[-1]] = spec
        else:
            return spec
    return specs


def with_constraint(x, rules: LogicalRules, mesh, *logical_axes):
    """The reference's activation constraint.  The identity on the port's
    explicit per-rank path: each activation already holds the layout the
    layer's own collectives gave it, and nothing propagates a layout."""
    return x
