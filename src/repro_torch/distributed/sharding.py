"""Mesh axis names, and the LM's logical-axis sharding rules with their
fallback chains.

The counterpart of the JAX package's ``distributed/sharding.py``.  The
production mesh is (16, 16) ["data", "model"] per pod (plus a leading
"pod" axis multi-pod), but head counts like 40, 24 and 56 do not divide
16, so each parameter kind carries a fallback chain: attention QKV
projections are column-parallel over heads when ``H % tp == 0`` and fall
back to row-parallel over d_model (a sum over the model axis after) or
to replicated.  The rules are name-based over the parameter tree's
paths, leaf for leaf the JAX package's (``param_pspec``).

A spec is a tuple with one entry per tensor dimension: ``None``, an axis
name, or a tuple of two or more axis names (the dimension split
row-major over them), as ``jax.sharding.PartitionSpec`` holds it.

torch has no partitioner to carry hand-written kernels through a
sharded program, so the port runs each rank's part explicitly (the
models' ``rules=`` keyword, ``distributed/_tp.py``): :func:`shard_params`
cuts every leaf to this rank's block (``jax.device_put(params,
param_shardings(...))``), and the model gathers what the FSDP axes shard
and sums partial products over the model axis.  :func:`param_shardings`
gives the same layout as ``DTensor`` placements.

Institutions (the paper's parties) map to the ``POD_AXIS`` ("pod") axis;
all data-parallel batch axes are ("pod", "data") in multi-pod meshes.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MeshRules", "POD_AXIS", "SHARE_AXIS", "param_pspec",
           "param_shardings", "param_specs", "shard_params", "split_axes",
           "train_state_specs", "tree_bytes"]

# The institution axis: one paper party per pod.  secure_psum's share
# reductions (and the sharded reveal's reduce-scatter) run over this axis.
POD_AXIS = "pod"

# The computation-center axis of the 2D (pod, share) mesh
# (``distributed.multihost``): reveal point j lives on mesh column j, so a
# center-device only ever holds its own share slice and reconstruction is
# a sum of Lagrange-weighted slices over this axis.  Orthogonal to
# POD_AXIS.
SHARE_AXIS = "share"


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """The mesh and its axis naming; everything is a no-op when ``mesh``
    is None.

    ``mesh`` is a ``DeviceMesh`` from ``compat.make_mesh`` with named
    dimensions ``("data", "model")`` or ``("pod", "data", "model")``.
    The JAX package's ``constrain`` (``with_sharding_constraint``) has no
    meaning without a partitioner: the explicit program cuts and gathers
    each activation itself (``_tp.cut``, ``_tp.gather``, ``_tp.TP.relayout``).
    Its ``sharding`` (a ``NamedSharding``) is :meth:`sharding`, the
    ``DTensor`` placements of a spec.
    """

    mesh: object = None
    tp_axis: str = "model"
    fsdp: bool = True
    pod_axis: str = POD_AXIS

    @property
    def axis_names(self) -> tuple:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()

    @property
    def dp_axes(self):
        if self.mesh is None:
            return ("data",)
        return tuple(n for n in self.axis_names if n != self.tp_axis)

    def axis_size(self, name: str) -> int:
        return int(self.mesh.size(self.axis_names.index(name)))

    @property
    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.axis_size(self.tp_axis)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        s = 1
        for a in self.dp_axes:
            s *= self.axis_size(a)
        return s

    @property
    def size(self) -> int:
        """Ranks in the mesh (1 without one)."""
        return self.dp_size * self.tp_size

    def fsdp_axes(self):
        return self.dp_axes if self.fsdp else None

    def batch_spec(self):
        """Leading-axis data parallelism for activations."""
        return self.dp_axes

    def sharding(self, *spec):
        """The ``DTensor`` placements of ``spec`` on this mesh, one per
        mesh dimension (``NamedSharding``); None without a mesh."""
        if self.mesh is None:
            return None
        return placements(spec, self.axis_names)


def placements(spec, axis_names) -> tuple:
    """``Shard(dim)`` for each mesh dimension some tensor dimension of
    ``spec`` is split over, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names:
        dims = [d for d, axes in enumerate(spec) if axes is not None
                and name in ((axes,) if isinstance(axes, str) else axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def param_pspec(path: str, shape: tuple[int, ...], rules, cfg) -> tuple:
    """Name-based parameter partition spec with divisibility fallbacks.

    ``path`` is a '/'-joined tree path (its last part, the leaf's name,
    decides); cfg is the ModelConfig (for head counts).  Returned specs
    only ever shard axes that divide evenly.  The JAX package's function
    branch for branch.
    """
    tp, fsdp = rules.tp_axis, rules.fsdp_axes()
    tpn = rules.tp_size

    def fs(dim: int):
        """fsdp axes if they divide dim, else None."""
        if fsdp is None:
            return None
        return fsdp if _divisible(dim, rules.dp_size) else None

    def P(*entries):
        # a one-axis tuple is that axis, as PartitionSpec stores it
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in entries)

    name = path.split("/")[-1]
    # ---- FSDP-only (ZeRO-3) mode: block weights row-sharded over the
    # full mesh, no TP.  Activations are batch-sharded over every axis
    # (the block's layout); embed/lm_head keep their usual specs.
    if (
        (getattr(cfg, "fsdp_only", False)
         or getattr(cfg, "seq_parallel_prefill", False))
        and len(shape) >= 2
        and name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3",
                     "wq_mla", "wkv_a", "wk_up", "wv_up")
    ):
        full = rules.dp_axes + (tp,) if rules.mesh is not None else None
        sz = rules.dp_size * rules.tp_size
        if full:
            for dim in range(len(shape)):
                if _divisible(shape[dim], sz):
                    spec = [None] * len(shape)
                    spec[dim] = full
                    return P(*spec)
        return P(fs(shape[0]), None)
    # ---- embeddings / unembedding
    if name == "embed":  # (V, d)
        return P(tp if _divisible(shape[0], tpn) else None, fs(shape[1]))
    if name == "lm_head":  # (d, V)
        return P(fs(shape[0]), tp if _divisible(shape[1], tpn) else None)
    # ---- norms / scalars / biases over d
    if name.startswith(("ln", "norm")) or len(shape) <= 1:
        return P(*([None] * len(shape)))
    # ---- attention projections
    if name in ("wq", "wk", "wv", "wkv_b"):  # (d, H*Dh) fused out axis
        heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads,
                 "wv": cfg.num_kv_heads, "wkv_b": cfg.num_heads}[name]
        if _divisible(heads, tpn):
            return P(fs(shape[0]), tp)  # column-parallel over heads
        if _divisible(shape[0], tpn):
            return P(tp, None)  # row-parallel fallback (psum after)
        return P(None, None)
    if name == "wo":  # (H*Dh, d)
        if _divisible(cfg.num_heads, tpn):
            return P(tp, fs(shape[1]))  # row-parallel (Megatron pair)
        if _divisible(shape[1], tpn):
            return P(None, tp)
        return P(None, None)
    # ---- MLA projections
    if name in ("wkv_a", "wq_mla"):  # (d, small) down-projections
        return P(fs(shape[0]) if name == "wkv_a" else None, None) \
            if not _divisible(cfg.num_heads, tpn) else P(fs(shape[0]),
                                                         None)
    if name in ("wk_up", "wv_up"):  # (lora, H*dim)
        return P(None, tp if _divisible(cfg.num_heads, tpn) else None)
    # ---- dense MLP
    if name in ("w1", "w3"):  # (d, ff)
        if _divisible(shape[1], tpn):
            return P(fs(shape[0]), tp)
        return P(fs(shape[0]), None)
    if name == "w2":  # (ff, d)
        if _divisible(shape[0], tpn):
            return P(tp, fs(shape[1]))
        return P(None, fs(shape[1]))
    # ---- MoE
    if name == "router":  # (d, E)
        return P(None, None)
    if name.startswith("experts_"):  # (E, d, h) / (E, h, d)
        return P(tp if _divisible(shape[0], tpn) else None, None, None)
    if name.startswith("shared_"):  # shared expert, shard like dense mlp
        if name.endswith(("w1", "w3")):
            return P(fs(shape[0]),
                     tp if _divisible(shape[1], tpn) else None)
        return P(tp if _divisible(shape[0], tpn) else None, fs(shape[1]))
    # ---- RWKV6 (heads rarely divide tp)
    if name.startswith("rwkv_w_"):  # (d, d) / channel-mix projections
        if getattr(cfg, "rwkv_batch_parallel", False):
            # batch-parallel mode: weights FSDP-sharded over the FULL mesh,
            # no TP — activations are batch-sharded over (data x model)
            # instead, so no per-projection sums
            full = rules.dp_axes + (tp,) if rules.mesh is not None else None
            sz = rules.dp_size * rules.tp_size
            if full and _divisible(shape[0], sz):
                return P(full, None)
            return P(fs(shape[0]), None)
        if _divisible(shape[0], tpn):
            return P(tp, None)  # row-parallel (psum after)
        return P(None, None)
    # ---- RG-LRU / Griffin
    if name in ("lru_in", "lru_gate"):  # (d, lru)
        return P(fs(shape[0]), tp if _divisible(shape[1], tpn) else None)
    if name == "lru_out":  # (lru, d)
        return P(tp if _divisible(shape[0], tpn) else None, fs(shape[1]))
    if name.startswith("lru_"):  # per-channel vectors (lru,)
        return P(*([None] * len(shape)))
    # default: replicate
    return P(*([None] * len(shape)))


def _leaves(params, prefix=""):
    """(path, leaf) of the port's parameter tree: ``embed``,
    ``final_norm``, ``lm_head`` and ``segments/<i>/<name>``."""
    for key, val in params.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        elif isinstance(val, (list, tuple)):
            for i, seg in enumerate(val):
                yield from _leaves(seg, f"{prefix}{key}/{i}/")
        else:
            yield f"{prefix}{key}", val


def _map(params, fn):
    """``params``' tree with each leaf replaced by ``fn(path, leaf)``."""
    def go(tree, prefix):
        if isinstance(tree, dict):
            return {k: go(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [go(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return fn(prefix[:-1], tree)

    return go(params, "")


def leaf_spec(path: str, shape, rules, cfg) -> tuple:
    """A leaf's spec over its whole shape: a stacked ``segments`` leaf
    (L_seg, *per-layer) keeps its layer axis unsharded and the rules apply
    to the per-layer shape."""
    shape = tuple(shape)
    if "segments" in path and len(shape) >= 1:
        return (None,) + param_pspec(path, shape[1:], rules, cfg)
    return param_pspec(path, shape, rules, cfg)


def param_shardings(params, rules, cfg):
    """Map a parameter tree (real, or on the ``meta`` device) to each
    leaf's ``DTensor`` placements (:meth:`MeshRules.sharding`)."""
    return _map(params, lambda path, leaf: rules.sharding(
        *leaf_spec(path, leaf.shape, rules, cfg)))


def param_specs(cfg, rules) -> list:
    """The spec of every leaf of ``cfg``'s parameter tree on ``rules``, in
    ``core.flatbuf.tree_flatten``'s order (dict keys sorted)."""
    from ..models.transformer import param_shapes

    return [leaf_spec(path, shape, rules, cfg)
            for path, shape in param_shapes(cfg)]


def split_axes(cfg, rules) -> list:
    """For each leaf of ``cfg``'s parameter tree, in ``param_specs``'
    order, the axes of more than one rank its block is split across, in
    ``rules.axis_names`` order: ``adamw_update``'s ``split_axes``."""
    out = []
    for spec in param_specs(cfg, rules):
        split = {a for axes in spec if axes is not None
                 for a in ((axes,) if isinstance(axes, str) else axes)}
        out.append(tuple(a for a in rules.axis_names
                         if a in split and rules.axis_size(a) > 1))
    return out


def train_state_specs(cfg, rules):
    """(abstract params, their placements, abstract AdamW state, its
    placements) on the ``meta`` device: the JAX package's
    ``launch/specs.train_state_specs``.  The moments are laid out like
    the parameters (``adamw_init`` of a rank's blocks makes its blocks of
    them) and the step is replicated; every placement is None without a
    mesh."""
    from ..models.transformer import abstract_params
    from ..optim.adamw import AdamWState, adamw_init

    params_abs = abstract_params(cfg)
    p_sh = param_shardings(params_abs, rules, cfg)
    opt_abs = adamw_init(params_abs)
    opt_sh = AdamWState(step=rules.sharding(),
                        mu=param_shardings(opt_abs.mu, rules, cfg),
                        nu=param_shardings(opt_abs.nu, rules, cfg))
    return params_abs, p_sh, opt_abs, opt_sh


def shard_params(params, rules, cfg):
    """Each leaf of ``params`` cut to this rank's block of its spec on
    ``rules.mesh``: the counterpart of ``jax.device_put(params,
    param_shardings(...))``.  The blocks are views of the leaves; clone
    them to free the whole tree.  Without a mesh the tree comes back as it
    is.
    """
    if rules.mesh is None:
        return params
    sizes = {n: rules.axis_size(n) for n in rules.axis_names}
    coords = {n: int(rules.mesh.get_local_rank(n))
              for n in rules.axis_names}

    def cut(path, leaf):
        for dim, axes in enumerate(leaf_spec(path, leaf.shape, rules, cfg)):
            if axes is None:
                continue
            idx, n = 0, 1
            for a in ((axes,) if isinstance(axes, str) else axes):
                idx, n = idx * sizes[a] + coords[a], n * sizes[a]
            step = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, idx * step, step)
        return leaf

    return _map(params, cut)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter or cache tree."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _leaves({"t": tree} if not isinstance(
                   tree, dict) else tree))
