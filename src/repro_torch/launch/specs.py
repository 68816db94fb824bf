"""Sharding specs and abstract inputs for every (arch × shape × mesh) combo.

The port of ``repro/launch/specs.py``.  ``param_specs`` walks the abstract
parameter tree and assigns a spec per leaf from path-based rules, rule for
rule the reference's:

* Megatron TP over ``model``: attention head projections (iff head counts
  divide the axis), MLP d_ff, MoE experts, vocab;
* FSDP over the data axes for large configs (``policy.fsdp_params``): the
  ``d_model`` sides of weight matrices also shard over ``("pod", "data")``;
* serving without FSDP: contraction-dim TP for attention whose heads do not
  divide the axis; serving with FSDP: the 2-D EP decode layout of the
  experts over ``(model, *data)``;
* Mamba's ``in_proj`` keeps its fused output dim replicated;
* a stacked leaf (under ``segments``, or MTP's ``layer``) gets ``None`` for
  its leading repeats axis.

**Specs.**  A spec is the port's stand-in for ``PartitionSpec``: a tuple
whose entries are ``None``, an axis name, or a tuple of names, a one-name
tuple read back as the name, as ``PartitionSpec`` reads it (the form of
``ShardingPolicy.batch_spec``).  Leaf paths are
``repro_torch/tree.flatten_with_path``'s, the reference's ``keystr`` form.

**Abstract inputs.**  Where the reference returns a ``ShapeDtypeStruct``
with a ``NamedSharding`` attached, the port returns a ``meta`` tensor (shape
and dtype, no storage) whose ``spec`` attribute holds the spec;
``input_specs`` also returns the spec trees under the reference's sibling
keys (``param_specs``, ``opt_specs``, ``cache_specs``).  Specs are
arithmetic: nothing is placed per slot, as the reference's specs place
nothing (``jit`` does that there).  Under no policy (``mesh=None``) every
axis counts as one slot.  Token ids and positions are int64, torch's index
dtype, where the reference's are int32.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models import kvcache, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.tree import Structure, flatten_with_path, unflatten

__all__ = ["param_specs", "opt_state_specs", "input_specs", "batch_specs", "cache_specs"]


class Spec(tuple):
    """A spec (``PartitionSpec``'s stand-in): a tuple that spec trees hold as
    a leaf, where a plain tuple is a container."""

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def P(*entries) -> Spec:
    """``PartitionSpec(*entries)`` as a :class:`Spec` (a one-name tuple
    entry reads back as the name)."""
    return Spec(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _abstract(shape, dtype: torch.dtype, spec: Spec) -> torch.Tensor:
    """A ``meta`` tensor with its spec attached (a ``ShapeDtypeStruct`` with
    a sharding)."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.spec = spec
    return t


def _axes_size(pol: ShardingPolicy, axes: tuple[str, ...]) -> int:
    size = 1
    if pol.mesh is not None:
        for a in axes:
            size *= pol.mesh.shape[a]
    return size


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _leaf_spec(path: str, leaf, cfg: ModelConfig, pol: ShardingPolicy) -> Spec:
    ndim = len(leaf.shape)
    m = pol.model_axis
    f = pol.data_axes if pol.fsdp_params else None
    stacked = "segments" in path or "'layer'" in path  # leading repeats dim

    def pad(spec: tuple) -> Spec:
        """Left-pad with None for the stacked repeats dimension."""
        if stacked:
            return P(None, *spec)
        return P(*spec)

    def dims(spec: tuple, want: int) -> Spec:
        assert len(spec) == want, (path, leaf.shape, spec)
        return pad(spec)

    name = path.rsplit("'", 2)[-2] if "'" in path else path

    base = ndim - (1 if stacked else 0)

    if name in ("embed",):
        return P(m, f)
    if name == "lm_head":
        return P(f, m)
    if name == "frontend_proj":
        return P(None, f)
    if name == "proj":  # mtp 2D->D projection
        return P(f, None)
    if name in ("wq",):
        if pol.serving and not pol.fsdp_params and not pol.shard_q_heads:
            return dims((m, None), 2)  # contraction-dim TP (psum'd matmul)
        return dims((f, m if pol.shard_q_heads else None), 2)
    if name in ("wk", "wv"):
        if pol.serving and not pol.fsdp_params and not pol.shard_kv_heads:
            return dims((m, None), 2)
        return dims((f, m if pol.shard_kv_heads else None), 2)
    if name == "wo":
        if pol.serving and not pol.fsdp_params and not pol.shard_q_heads:
            return dims((None, m), 2)
        return dims((m if pol.shard_q_heads else None, f), 2)
    if name in ("bq",):
        return dims((m if pol.shard_q_heads else None,), 1)
    if name in ("bk", "bv"):
        return dims((m if pol.shard_kv_heads else None,), 1)
    # MLA
    if name in ("wq_a", "wkv_a"):
        return dims((f, None), 2)
    if name in ("wq_b", "wk_b", "wv_b"):
        return dims((None, m), 2)  # head-major output dim
    # MLP
    if name in ("w_gate", "w_up"):
        return dims((f, m), 2)
    if name == "w_down":
        return dims((m, f), 2)
    if name == "b_up":
        return dims((m,), 1)
    if name == "b_down":
        return dims((None,), 1)
    # MoE
    if name == "router":
        return dims((None, None), 2)
    if name in ("we_gate", "we_up", "we_down"):
        if pol.serving and pol.fsdp_params:
            # weights-stationary 2-D EP decode layout
            return dims(((m, *pol.data_axes), None, None), 3)
        if name == "we_down":
            return dims((m, None, f), 3)
        return dims((m, f, None), 3)
    # Mamba
    if name == "in_proj":
        return dims((f, None), 2)
    if name == "out_proj":
        return dims((None, f), 2)
    if name in ("conv_w", "conv_b", "A_log", "D_skip", "dt_bias"):
        return pad(tuple([None] * base))
    # norms / scales / everything small: replicated (the repeats dim unsharded)
    return pad(tuple([None] * base))


def param_specs(cfg: ModelConfig, pol: ShardingPolicy, abstract=None):
    """The spec tree matching ``transformer.abstract_params(cfg)``."""
    if abstract is None:
        abstract = transformer.abstract_params(cfg)
    flat, structure = flatten_with_path(abstract)
    return unflatten(structure, [_leaf_spec(path, leaf, cfg, pol) for path, leaf in flat])


def _walk_specs(node, out: list[Spec]) -> Structure:
    if isinstance(node, Spec):
        out.append(node)
        return Structure("leaf")
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return Structure("dict", keys, tuple(_walk_specs(node[k], out) for k in keys))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return Structure("namedtuple", (type(node),), tuple(_walk_specs(v, out) for v in node))
    if isinstance(node, (list, tuple)):
        return Structure("list" if isinstance(node, list) else "tuple", (),
                         tuple(_walk_specs(v, out) for v in node))
    raise TypeError(f"not a spec tree node: {node!r}")


def _spec_leaves(tree) -> tuple[list[Spec], Structure]:
    """A spec tree's specs in walk order and its structure (a :class:`Spec`
    is a leaf; dicts, lists, tuples and named tuples are containers, as in
    ``repro_torch/tree``)."""
    leaves: list[Spec] = []
    structure = _walk_specs(tree, leaves)
    return leaves, structure


def _map_specs(fn, p_specs, abstract_params):
    """``fn(spec, leaf)`` over a spec tree and the params tree of its shape."""
    specs, structure = _spec_leaves(p_specs)
    leaves, _ = flatten_with_path(abstract_params)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return unflatten(structure, [fn(s, leaf) for s, (_, leaf) in zip(specs, leaves)])


def opt_state_specs(optimizer_name: str, p_specs, abstract_params):
    """Optimizer-state specs derived from the param specs."""
    from repro_torch.optim import AdafactorState, AdamState

    if optimizer_name == "sgd":
        return ()
    if optimizer_name in ("adam", "adamw"):
        return AdamState(step=P(), m=p_specs, v=p_specs)
    if optimizer_name == "momentum":
        return p_specs
    if optimizer_name == "adafactor":
        def padded(spec, leaf):
            t = tuple(spec) if spec is not None else (None,) * len(leaf.shape)
            return t + (None,) * (len(leaf.shape) - len(t))

        def drop_last(spec, leaf):
            return P(*padded(spec, leaf)[:-1]) if len(leaf.shape) >= 2 else P()

        def drop_second_last(spec, leaf):
            t = padded(spec, leaf)
            return P(*t[:-2], t[-1]) if len(leaf.shape) >= 2 else P()

        def full(spec, leaf):
            return P() if len(leaf.shape) >= 2 else (spec or P())

        return AdafactorState(
            step=P(),
            vr=_map_specs(drop_last, p_specs, abstract_params),
            vc=_map_specs(drop_second_last, p_specs, abstract_params),
            v=_map_specs(full, p_specs, abstract_params),
        )
    raise ValueError(optimizer_name)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, pol: ShardingPolicy, shape_name: str) -> dict:
    """The abstract train/prefill batch, each tensor with its spec."""
    info = INPUT_SHAPES[shape_name]
    B, S = info["global_batch"], info["seq_len"]
    da = pol.data_axes
    out: dict[str, Any] = {}
    n_text = S
    if cfg.frontend == "vision_stub":
        n_text = S - cfg.num_prefix_tokens
        out["prefix_embeds"] = _abstract((B, cfg.num_prefix_tokens, cfg.frontend_dim),
                                         torch.bfloat16, P(da, None, None))
    if cfg.is_encoder_decoder:
        out["frames"] = _abstract((B, cfg.encoder_seq_len, cfg.frontend_dim), torch.bfloat16,
                                  P(da, None, None))
    out["tokens"] = _abstract((B, n_text), torch.int64, P(da, None))
    out["labels"] = _abstract((B, n_text), torch.int64, P(da, None))
    return out


def _batch_axes(pol: ShardingPolicy, batch: int):
    """The data axes when they divide ``batch`` (and it fills them), else None."""
    dsize = _axes_size(pol, pol.data_axes)
    return pol.data_axes if batch % dsize == 0 and batch >= dsize else None


def _cache_leaf_spec(path: str, leaf, cfg: ModelConfig, pol: ShardingPolicy,
                     batch: int) -> Spec:
    """Cache leaves: (repeats, B, ...) — B over data when divisible, then
    heads over model when divisible else sequence over model."""
    m = pol.model_axis
    bspec = _batch_axes(pol, batch)

    name = path.rsplit("'", 2)[-2]
    if name in ("k", "v"):  # (rep, B, L, KVH, hd)
        if pol.shard_kv_heads:
            return P(None, bspec, None, m, None)
        return P(None, bspec, m, None, None)  # sequence-sharded cache
    if name in ("ckv", "kpe"):  # (rep, B, L, r)
        return P(None, bspec, m, None)
    if name == "conv":  # (rep, B, W-1, ch)
        return P(None, bspec, None, None)
    if name == "ssm":  # (rep, B, H, P, N)
        if pol.shard_ssm_heads:
            return P(None, bspec, m, None, None)
        return P(None, bspec, None, None, None)
    return P(*([None] * len(leaf.shape)))


def cache_specs(cfg: ModelConfig, pol: ShardingPolicy, batch: int, max_len: int):
    """``(abstract_cache_with_specs, spec_tree)``."""
    flat, structure = flatten_with_path(kvcache.abstract_cache(cfg, batch, max_len))
    specs, structs = [], []
    for path, leaf in flat:
        spec = _cache_leaf_spec(path, leaf, cfg, pol, batch)
        specs.append(spec)
        structs.append(_abstract(leaf.shape, leaf.dtype, spec))
    return unflatten(structure, structs), unflatten(structure, specs)


# ---------------------------------------------------------------------------
# full dry-run input assembly
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, pol: ShardingPolicy, shape_name: str,
                optimizer_name: str = "adamw") -> dict:
    """Everything a step function needs, as ``meta`` tensors with specs."""
    info = INPUT_SHAPES[shape_name]
    kind = info["kind"]
    abstract = transformer.abstract_params(cfg)
    p_specs = param_specs(cfg, pol, abstract)
    leaves, structure = flatten_with_path(abstract)
    specs, _ = _spec_leaves(p_specs)
    params = unflatten(structure, [_abstract(l.shape, l.dtype, s)
                                   for (_, l), s in zip(leaves, specs)])
    out = {"params": params, "param_specs": p_specs}

    if kind == "train":
        from repro_torch import optim as optim_mod

        opt = getattr(optim_mod, optimizer_name)(1e-4)
        o_abstract = opt.init(abstract)
        o_specs = opt_state_specs(optimizer_name, p_specs, abstract)
        o_leaves, o_structure = flatten_with_path(o_abstract)
        o_spec_leaves, _ = _spec_leaves(o_specs)
        if len(o_spec_leaves) != len(o_leaves):
            raise ValueError(f"{len(o_spec_leaves)} optimizer specs for {len(o_leaves)} leaves")
        out["opt_state"] = unflatten(o_structure, [
            _abstract(l.shape, l.dtype, s) for (_, l), s in zip(o_leaves, o_spec_leaves)])
        out["opt_specs"] = o_specs
        out["batch"] = batch_specs(cfg, pol, shape_name)
        out["optimizer"] = opt
    elif kind == "prefill":
        out["batch"] = batch_specs(cfg, pol, shape_name)
    else:  # decode
        B, L = info["global_batch"], info["seq_len"]
        caches, c_specs = cache_specs(cfg, pol, B, L)
        out["caches"] = caches
        out["cache_specs"] = c_specs
        bspec = _batch_axes(pol, B)
        out["tokens"] = _abstract((B, 1), torch.int64, P(bspec, None))
        out["pos"] = _abstract((), torch.int64, P())
        if cfg.is_encoder_decoder:
            out["memory"] = _abstract((B, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16,
                                      P(bspec, None, None))
    return out
