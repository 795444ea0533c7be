"""Partition rules (the port's copy of the reference's
``repro.sharding.specs``): the production rules of the dry run, then the
lane-axis rules of sharded serving.

Production rules, on the mesh (pod?, data, model): the batch over
("pod", "data"); tensor parallel over "model" on attention heads, the FFN
hidden and MoE experts; vocab-parallel embeddings and head when divisible;
decode caches batch over the data axes when divisible, else (long_500k,
batch 1) the cache sequence over every mesh axis; optimizer moments follow
their parameter; scalars replicate. Every rule is divisibility-guarded as
the reference's code writes it (``wq`` shards when its last dim divides,
not when its head count does). A spec is the reference's
``PartitionSpec`` as a tuple: one entry per leading tensor dim, each None,
an axis name or a tuple of axis names (major to minor), and ``()`` for
``P()``. :class:`NamedSharding` pairs a spec with a mesh and turns it into
DTensor placements.

Lane rules:

The serving engine packs W concurrent requests into a lane batch; every
per-lane computation (draft, verify, refresh, advance) is lane-independent,
so the lane axis splits over the mesh's ``"data"`` axis and one engine
serves W lanes as D blocks of W/D. What splits and what replicates:

  array                  | layout               | lane axis
  -----------------------|----------------------|----------
  latents ``x``          | [W, (F,) H, W, C]    | 0
  difference table       | [m+1, L, 2, W, T, D] | 3
  per-lane vectors       | [W]                  | 0
  conditioning values    | [W, ...]             | 0
  decode caches          | [L, W, ...]          | 1
  model params           | (tree)               | replicated per device

Shard i owns lanes [i·W/D, (i+1)·W/D) as its own contiguous tensors on
``mesh.devices[i]``: a lane block of the table is not a contiguous view
of a whole table (its lane axis is position 3), and the kernels take
contiguous operands only, so the port never keeps one global table.

CFG pair rule: a guided request occupies the lane pair (2k, 2k+1), and
the guided combination and the pair verify are cross-lane operations
within a pair. Whenever guided requests can be admitted the lane width is
a multiple of ``2·D`` (:func:`lane_width_multiple` with ``streams=2``),
so every pair lies inside one shard.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ModelConfig

Spec = Tuple[Any, ...]


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a mesh whose ``shape``
    is that dict already (``LaneMesh``, the reference's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(_axis_sizes(mesh))


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= sizes[a]
        return n
    return sizes[name]


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a in ("pod", "data"))


def param_spec(cfg: ModelConfig, mesh, path: str, shape: Tuple[int, ...]
               ) -> Spec:
    """Partition spec for one parameter leaf (path in the params tree)."""
    ms = _axis_sizes(mesh)["model"]

    def last_if(dim: int) -> Spec:
        """Shard the last axis over 'model' if divisible, else replicate."""
        nones = (None,) * (len(shape) - 1)
        return nones + ("model",) if dim % ms == 0 else ()

    name = path.split("/")[-1]

    # --- embeddings & heads ---
    if path.startswith("embed/tok") or path.startswith("embed/codebooks"):
        v = shape[-2]
        lead = (None,) * (len(shape) - 2)
        if v % ms == 0:
            return lead + ("model", None)
        # a sharded D would make the tied head a contracting-dim matmul
        # whose f32 logits get all-reduced; the table replicates instead
        return ()
    if path.startswith("embed/"):
        return ()
    if path == "final_norm":
        return ()
    if path.startswith("head/"):
        if name == "w" and len(shape) >= 2 and cfg.vocab_size \
                and shape[-1] == cfg.padded_vocab:
            return last_if(shape[-1])
        return ()

    # --- stacked blocks (leading L axis) ---
    if path.startswith("blocks/"):
        if name in ("ln1", "ln2", "mod_b"):
            return ()
        if name in ("wq", "wk", "wv"):
            return (None, None, "model") if shape[-1] % ms == 0 else ()
        if name in ("bq", "bk", "bv"):
            return (None, "model") if shape[-1] % ms == 0 else ()
        if name == "wo":
            return (None, "model", None) if shape[-2] % ms == 0 else ()
        if name == "mod_w":
            return (None, None, "model") if shape[-1] % ms == 0 else ()
        if "moe" in path:
            if name == "router":
                return ()
            e = shape[1]
            if name in ("w_gate", "w_up"):       # [L, E, D, F]
                if e % ms == 0:
                    return (None, "model", None, None)
                return (None, None, None, "model") \
                    if shape[-1] % ms == 0 else ()
            if name == "w_down":                  # [L, E, F, D]
                if e % ms == 0:
                    return (None, "model", None, None)
                return (None, None, "model", None) \
                    if shape[-2] % ms == 0 else ()
        if "mlp" in path:
            if name in ("w_gate", "w_up"):
                return (None, None, "model") if shape[-1] % ms == 0 else ()
            if name == "w_down":
                return (None, "model", None) if shape[-2] % ms == 0 else ()
        if "ssm" in path:
            return ()                    # recurrent mixer params replicate
        return ()
    return ()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``;
    ``mesh`` a ``DeviceMesh``)."""

    mesh: Any
    spec: Spec

    def __post_init__(self):
        # as ``PartitionSpec``: a one-axis tuple entry is that axis
        object.__setattr__(self, "spec", tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in self.spec))

    @property
    def placements(self):
        """DTensor placements, one per mesh dim: ``Shard(d)`` where tensor
        dim d names the axis (and the axis has more than one device),
        else ``Replicate()``. A dim split over several axes splits them in
        mesh order, major to minor, which is the reference's order for a
        tuple in mesh order; any other order raises."""
        from torch.distributed.tensor import Replicate, Shard

        sizes = _axis_sizes(self.mesh)
        names = tuple(sizes)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                if sizes[names[i]] > 1:
                    out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's local shape of a global ``shape`` (every split
        here divides)."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = _axis_size(self.mesh, entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {entry}")
            out[d] //= n
        return tuple(out)


def params_shardings(cfg: ModelConfig, mesh, params_shape) -> Any:
    """A :class:`NamedSharding` tree matching a params (or moments) tree
    whose leaves have ``.shape``."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        return NamedSharding(mesh, param_spec(cfg, mesh, path,
                                              tuple(tree.shape)))
    return walk(params_shape, "")


def opt_state_shardings(cfg: ModelConfig, mesh, params_shape) -> Dict:
    psh = params_shardings(cfg, mesh, params_shape)
    return {"mu": psh, "nu": psh,
            "count": NamedSharding(mesh, ())}


def train_state_shardings(cfg: ModelConfig, mesh, params_shape) -> Dict:
    return {"params": params_shardings(cfg, mesh, params_shape),
            "opt": opt_state_shardings(cfg, mesh, params_shape),
            "step": NamedSharding(mesh, ())}


def batch_sharding(mesh, batch: int, ndim: int) -> NamedSharding:
    """Shard the leading batch dim over the data axes when divisible."""
    dp = data_axes(mesh)
    if batch % _axis_size(mesh, dp) == 0:
        return NamedSharding(mesh, (dp,) + (None,) * (ndim - 1))
    return NamedSharding(mesh, ())


def cache_shardings(cfg: ModelConfig, mesh, batch: int,
                    cache_shape) -> Dict:
    """KV/SSM cache specs: [L, B, S, KV, hd] / [L, B, nh, hp, ns] /
    [L, B, W, C]."""
    dp = data_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    ms = _axis_sizes(mesh)["model"]
    batch_ok = batch % dp_size == 0

    def kv_spec(shape):
        if batch_ok:
            if shape[3] % ms == 0:
                return (None, dp, None, "model", None)
            return (None, dp, "model", None, None)    # shard the sequence
        # batch 1, long context: the sequence over EVERY axis
        return (None, None, _axis_names(mesh), None, None)

    def ssm_spec(shape):
        if batch_ok:
            if shape[2] % ms == 0:
                return (None, dp, "model", None, None)
            return (None, dp, None, None, None)
        if shape[2] % ms == 0:
            return (None, None, "model", None, None)
        return ()

    def conv_spec(shape):
        if batch_ok:
            return (None, dp, None, None)
        return ()

    out = {}
    for key, leaf in cache_shape.items():
        if key in ("k", "v"):
            out[key] = NamedSharding(mesh, kv_spec(leaf.shape))
        elif key == "ssm_state":
            out[key] = NamedSharding(mesh, ssm_spec(leaf.shape))
        else:
            out[key] = NamedSharding(mesh, conv_spec(leaf.shape))
    return out


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# DTensor steps of the layers
# ---------------------------------------------------------------------------
# The dry run hands the layers DTensors. Where DTensor cannot follow the
# plain code (a reshape to heads that would split a shard unevenly, an
# attention on a 2-D mesh, a write into a sharded cache row, a
# vocab-sharded lookup, the MoE dispatch), a layer calls one of these
# helpers, and only when handed DTensors: the plain path is untouched.
# Each places its operands as the rules imply (the reshard XLA's SPMD
# partitioner would insert at the same spot), computes on the local
# shards and issues the collectives that the recorder then counts.

def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor: no tensor
    is one before its module is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _replicated_like(x: torch.Tensor, mesh):
    """A plain tensor as a replicated DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    if x is None or is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _redistribute(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _batch_only(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import Replicate, Shard

    return _redistribute(x, [p if p == Shard(0) else Replicate()
                             for p in x.placements])


class _Residual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _batch_only(x)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return _batch_only(grad)


def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout for a DTensor activation [B, ...], in
    the forward and in the backward: the batch split over the mesh dims
    that split it, whole on every other dim (a pending sum is
    all-reduced, a sequence split gathered). Plain tensors pass
    through."""
    if not is_dtensor(x):
        return x
    if x.requires_grad:
        return _Residual.apply(x)
    return _batch_only(x)


class _WholeWeight(torch.autograd.Function):
    """A DTensor weight as its whole local copy for a computation on the
    batch shards; its gradient is a pending sum over the mesh dims that
    split the batch (each rank saw only its own rows)."""

    @staticmethod
    def forward(ctx, w, batch_dims):
        from torch.distributed.tensor import Replicate

        ctx.mesh, ctx.batch_dims = w.device_mesh, batch_dims
        ctx.shape, ctx.stride = w.shape, w.stride()
        return _redistribute(w, [Replicate()] * w.device_mesh.ndim) \
            .to_local()

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        part = [Partial() if i in ctx.batch_dims else Replicate()
                for i in range(ctx.mesh.ndim)]
        return DTensor.from_local(grad, ctx.mesh, part, run_check=False,
                                  shape=ctx.shape, stride=ctx.stride), None


def local_rows(fn, weights, *rows):
    """``fn(weights, *rows)`` on each rank's batch shard, for a DTensor
    computation that is row by row over a leading batch dim [B, ...] with
    replicated weights (RMSNorm, the SSD mixer): every DTensor of ``rows``
    is laid out with its batch split kept and all else whole (the first
    one's split sets it), every DTensor leaf of ``weights`` (a tensor or a
    dict) taken whole; the plain ``fn`` runs on the local tensors and each
    tensor it returns [B, ...] comes back as a DTensor in that layout. No
    DTensor rule is asked for the ops inside ``fn``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    first = next(r for r in rows if is_dtensor(r))
    mesh = first.device_mesh
    bp = [p if p == Shard(0) else Replicate() for p in first.placements]
    batch_dims = tuple(i for i, p in enumerate(bp) if p == Shard(0))

    def local(r):
        return _redistribute(_replicated_like(r, mesh), bp).to_local() \
            if isinstance(r, torch.Tensor) else r

    def whole(w):
        if isinstance(w, dict):
            return {k: whole(v) for k, v in w.items()}
        if not is_dtensor(w):
            return w
        if w.requires_grad:
            return _WholeWeight.apply(w, batch_dims)
        return _redistribute(w, [Replicate()] * mesh.ndim).to_local()

    out = fn(whole(weights), *(local(r) for r in rows))

    def wrap(o):
        if isinstance(o, tuple):
            return tuple(wrap(x) for x in o)
        return DTensor.from_local(o, mesh, bp, run_check=False)
    return wrap(out)


class _Index0(torch.autograd.Function):
    """``stacked[index]`` of a DTensor [N, ...] whose gradient is built on
    each rank's shard (DTensor's own rule for the select's backward cannot
    take the pending-sum gradient of a data-parallel weight)."""

    @staticmethod
    def forward(ctx, stacked, index):
        ctx.index = index
        ctx.mesh, ctx.placements = stacked.device_mesh, stacked.placements
        ctx.shape, ctx.stride = stacked.shape, stacked.stride()
        ctx.local_shape = stacked.to_local().shape
        return stacked[index]

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Shard

        # the slice's placements: dims after the stacked axis shift down
        sl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
              for p in ctx.placements]
        g = _redistribute(grad, sl).to_local()
        full = torch.zeros(ctx.local_shape, dtype=g.dtype, device=g.device)
        full[ctx.index] = g
        return DTensor.from_local(full, ctx.mesh, ctx.placements,
                                  run_check=False, shape=ctx.shape,
                                  stride=ctx.stride), None


def index0(stacked: torch.Tensor, index: int) -> torch.Tensor:
    """``stacked[index]`` of a DTensor parameter stacked on dim 0 (block
    layers, codebooks), with its gradient built shard by shard."""
    if stacked.requires_grad:
        return _Index0.apply(stacked, index)
    return stacked[index]


class _HeadsGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient [..., heads·head_dim]
    on the mesh dims that do not divide ``heads``, so that the reshape's
    backward can unflatten it."""

    @staticmethod
    def forward(ctx, x, heads):
        ctx.heads = heads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _even_heads(grad, ctx.heads), None


def _even_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``t`` [..., heads·head_dim] gathered on the mesh dims that split
    its last dim unevenly by heads."""
    from torch.distributed.tensor import Replicate, Shard

    last, mesh = t.ndim - 1, t.device_mesh
    ways = 1
    placements = list(t.placements)
    for i, p in enumerate(placements):
        if p == Shard(last):
            if heads % (ways * mesh.size(i)):
                placements[i] = Replicate()
            else:
                ways *= mesh.size(i)
    return _redistribute(t, placements)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """DTensor [..., heads, head_dim] -> [..., heads·head_dim], with a
    gradient that unflattens however the heads split."""
    heads, hd = t.shape[-2:]
    return _HeadsGrad.apply(t.reshape(tuple(t.shape[:-2]) + (heads * hd,)),
                            heads)


def _shard_box(shape: Sequence[int], mesh, placements
               ) -> Tuple[List[int], List[int]]:
    """(local shape, global offset) of this rank's shard of an evenly
    split tensor; several mesh dims on one tensor dim split it in mesh
    order, major to minor."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    size, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            size[p.dim] //= n
            offset[p.dim] += coord[i] * size[p.dim]
    return size, offset


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """DTensor ``t`` [..., heads·head_dim] -> [..., heads, head_dim], first
    gathered on the mesh dims that would split the heads unevenly
    (DTensor cannot unflatten an uneven split; XLA reshards at the same
    reshape)."""
    return _even_heads(t, heads).reshape(tuple(t.shape[:-1])
                                         + (heads, head_dim))


def attention(q, k, v, bias, core):
    """``core(q, k, v, bias)`` (the plain attention of
    ``layers.attention``) on DTensors q [B, Sq, H, hd], k/v [B, Sk, H, hd]
    and an additive bias [Bb, 1, Sq, Sk] (plain or DTensor), without
    DTensor's strategy search. Per mesh dim: the keys' sequence split
    stays split and the softmax is distributed (flash-decoding: the max,
    the sum and the output all-reduced over those dims); else the batch,
    else the heads where they divide, else replicated. Returns a DTensor
    laid out as q's local computation."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    k, v = _replicated_like(k, mesh), _replicated_like(v, mesh)
    bias = _replicated_like(bias, mesh)
    qp, kp, bp, seq = [], [], [], []
    for i in range(mesh.ndim):
        pq, pk = q.placements[i], k.placements[i]
        if pk == Shard(1):
            qp.append(Replicate())
            kp.append(Shard(1))
            bp.append(Shard(3))
            seq.append(i)
        elif Shard(0) in (pq, pk):
            qp.append(Shard(0))
            kp.append(Shard(0))
            bp.append(Shard(0) if bias is not None and bias.shape[0] > 1
                      else Replicate())
        elif Shard(2) in (pq, pk) and q.shape[2] % mesh.size(i) == 0:
            qp.append(Shard(2))
            kp.append(Shard(2))
            bp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            bp.append(Replicate())
    ql = _redistribute(q, qp).to_local()
    kl = _redistribute(k, kp).to_local()
    vl = _redistribute(v, kp).to_local()
    bl = None if bias is None else _redistribute(bias, bp).to_local()
    if not seq:
        out = core(ql, kl, vl, bl)
        return DTensor.from_local(out, mesh, qp, run_check=False)

    def reduce(x, op):
        part = [Partial(op) if i in seq else p for i, p in enumerate(qp)]
        d = DTensor.from_local(x, mesh, part, run_check=False)
        return d.redistribute(mesh, qp).to_local()

    f32 = torch.float32
    qt, kt, vt = (x.to(f32).transpose(1, 2) for x in (ql, kl, vl))
    scores = (qt @ kt.transpose(-1, -2)) / (qt.shape[-1] ** 0.5)
    if bl is not None:
        scores = scores + bl
    m = reduce(torch.amax(scores, dim=-1, keepdim=True), "max")
    p = torch.exp(scores - m)
    denom = reduce(torch.sum(p, dim=-1, keepdim=True), "sum")
    out = reduce(p @ vt, "sum") / denom
    out = out.transpose(1, 2).to(q.dtype)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def write_rows(cache: torch.Tensor, new: torch.Tensor, start: int
               ) -> torch.Tensor:
    """``cache`` [B, S, ...] (a DTensor the caller has copied) with ``new``
    [B, n, ...] written in place at rows start..start+n−1 of dim 1. Each
    rank writes the rows of its own shard of dim 1, so a sequence-sharded
    cache is never gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, placements = cache.device_mesh, cache.placements
    local = cache.to_local()
    shape, offset = _shard_box(cache.shape, mesh, placements)
    # ``new`` whole along dim 1, split as the cache elsewhere
    new = _redistribute(_replicated_like(new, mesh),
                        [Replicate() if p == Shard(1) else p
                         for p in placements]).to_local()
    lo = max(start, offset[1])
    hi = min(start + new.shape[1], offset[1] + shape[1])
    if lo < hi:
        local[:, lo - offset[1]:hi - offset[1]] = \
            new[:, lo - start:hi - start].to(local.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=cache.shape, stride=cache.stride())


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table [V, D]: each rank looks up the
    rows of its own vocab shard, zeroes the others and the partial rows
    are all-reduced over the mesh dims that split the vocab (the
    vocab-parallel lookup; the table is never gathered). The result is
    laid out as ``tokens`` is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    tokens = _replicated_like(tokens, mesh)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table = _redistribute(table, [p if i in vocab else Replicate()
                                  for i, p in enumerate(table.placements)])
    tok_p = [Replicate() if i in vocab else p
             for i, p in enumerate(tokens.placements)]
    idx = _redistribute(tokens, tok_p).to_local().long()
    shape, offset = _shard_box(table.shape, mesh, table.placements)
    idx = idx - offset[0]
    inside = (idx >= 0) & (idx < shape[0])
    local = table.to_local()
    rows = local[torch.clamp(idx, 0, shape[0] - 1)] \
        * inside[..., None].to(local.dtype)
    out = DTensor.from_local(rows, mesh, [Partial() if i in vocab else p
                                          for i, p in enumerate(tok_p)],
                             run_check=False)
    return out.redistribute(mesh, tok_p)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` for a DTensor x [..., V] and integer idx [...]: the
    ranks that split V each gather from their own columns, zero the rest,
    and the partial values are all-reduced (the vocab-parallel gold
    logit). The result is laid out as x without the split of V."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    vocab = [i for i, p in enumerate(x.placements) if p == Shard(last)]
    other = [Replicate() if i in vocab else p
             for i, p in enumerate(x.placements)]
    il = _redistribute(_replicated_like(idx, mesh), other).to_local().long()
    shape, offset = _shard_box(x.shape, mesh, x.placements)
    il = il - offset[last]
    inside = (il >= 0) & (il < shape[last])
    xl = x.to_local()
    g = torch.gather(xl, -1, torch.clamp(il, 0, shape[last] - 1)[..., None])
    g = g[..., 0] * inside.to(xl.dtype)
    out = DTensor.from_local(g, mesh, [Partial() if i in vocab else p
                                       for i, p in enumerate(other)],
                             run_check=False)
    return out.redistribute(mesh, other)


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``logsumexp(x, -1)`` for a DTensor x [..., V]: the ranks that split
    V each reduce their own columns, and the max and the sum are
    all-reduced over those mesh dims (the logits are never gathered).
    Laid out as x without the split of V."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    vocab = [i for i, p in enumerate(x.placements) if p == Shard(last)]
    if not vocab:
        return torch.logsumexp(x, dim=-1)
    other = [Replicate() if i in vocab else p
             for i, p in enumerate(x.placements)]

    def reduce(v, op):
        part = [Partial(op) if i in vocab else p for i, p in enumerate(other)]
        return DTensor.from_local(v, mesh, part, run_check=False) \
            .redistribute(mesh, other).to_local()

    xl = x.to_local()
    m = reduce(torch.amax(xl, dim=-1).detach(), "max")
    total = reduce(torch.sum(torch.exp(xl - m[..., None]), dim=-1), "sum")
    return DTensor.from_local(torch.log(total) + m, mesh, other,
                              run_check=False)


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The row-major stride of ``shape`` (computed, not allocated: a
    tensor made here would count as the step's memory)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def stacked_empty(lead: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor [*lead, *like.shape] of ``like``'s dtype and
    device. For a DTensor ``like`` it is laid out as ``like`` on its
    trailing dims, the leading ones whole: each rank holds only its own
    shard, where a plain ``torch.empty`` of the global shape would be
    whole on every rank. A layer loop writes its ``like``-shaped values
    into it."""
    from torch.distributed.tensor import DTensor, Shard

    if not is_dtensor(like):
        return torch.empty(tuple(lead) + tuple(like.shape), dtype=like.dtype,
                           device=like.device)
    n = len(lead)
    local = like.to_local()
    shape = torch.Size(tuple(lead) + tuple(like.shape))
    return DTensor.from_local(
        torch.empty(tuple(lead) + tuple(local.shape), dtype=like.dtype,
                    device=local.device), like.device_mesh,
        [Shard(p.dim + n) if isinstance(p, Shard) else p
         for p in like.placements], run_check=False, shape=shape,
        stride=_contiguous_stride(shape))


def contract_leading(w: torch.Tensor, t: torch.Tensor,
                     contract: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]) -> torch.Tensor:
    """``contract(w, t)``, a contraction over the leading dim such as
    ``tensordot(w, t, ([0], [0]))``, for a DTensor t [N, ...] and w [N]
    (plain or DTensor): each rank contracts its own shard of ``t`` with
    the whole ``w`` (DTensor would flatten ``t``'s split dims into one and
    could not place the product). The result is laid out as ``t`` without
    its leading dim, which no rule splits."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = t.device_mesh
    kept = [Replicate() if p == Shard(0) else p for p in t.placements]
    wl = _redistribute(_replicated_like(w, mesh),
                       [Replicate()] * mesh.ndim).to_local()
    out = contract(wl, _redistribute(t, kept).to_local())
    shape = t.shape[1:]
    return DTensor.from_local(
        out, mesh, [Shard(p.dim - 1) if isinstance(p, Shard) else p
                    for p in kept], run_check=False, shape=shape,
        stride=_contiguous_stride(shape))


# ---------------------------------------------------------------------------
# Lane-axis rules (sharded serving)
# ---------------------------------------------------------------------------

LANE_AXIS = "data"

# lane-state key -> lane axis (the reference's table, key by key):
# ``diffs`` [m+1, L, 2, W, T, D] at 3; decode's caches [L, W, ...] at 1;
# every other entry, the controller's ``ctl_*`` vectors included, at 0
LANE_STATE_AXES = {
    "x": 0, "since": 0, "step": 0, "active": 0,
    "diffs": 3, "n_anchors": 0, "anchor_step": 0, "gap": 0,
    "gscale": 0, "paired": 0, "tau0": 0,
    "draft_k": 0, "max_step": 0,
    "tok": 0, "tokens": 0, "pos0": 0,
    "k": 1, "v": 1, "ssm_state": 1, "conv_state": 1,
    "ctl_on": 0, "ctl_dl": 0, "ctl_rate": 0, "ctl_adv": 0,
    "ctl_target": 0, "ctl_gain": 0, "ctl_ema": 0,
    "ctl_tau_lo": 0, "ctl_tau_hi": 0, "ctl_tau_base": 0,
    "ctl_k_lo": 0, "ctl_k_hi": 0,
    "ctl_order": 0, "ctl_order_lo": 0, "ctl_order_hi": 0,
    "ctl_ticks": 0, "ctl_deadline": 0,
}


def lane_shard_count(mesh: Optional[Any], axis: str = LANE_AXIS) -> int:
    """How many ways the lane axis splits on ``mesh`` (1 for no mesh)."""
    if mesh is None:
        return 1
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis (axes "
                         f"{mesh.axis_names})")
    return mesh.shape[axis]


def lane_width_multiple(mesh: Optional[Any], *, streams: int = 1,
                        axis: str = LANE_AXIS) -> int:
    """The serving lane width must be a multiple of this: ``streams``
    (lanes a request occupies: 1, or 2 for a CFG pair) times the shard
    count, so every shard owns an equal block and no request's lanes
    straddle a shard boundary."""
    return streams * lane_shard_count(mesh, axis)


def lane_block(lanes: int, shards: int) -> int:
    """Lanes a shard owns: ``lanes / shards``, which must divide."""
    if lanes % shards:
        raise ValueError(f"lanes={lanes} not divisible by the lane-shard "
                         f"count {shards}")
    return lanes // shards


def split_lanes(t: torch.Tensor, mesh, lane_axis: int = 0
                ) -> List[torch.Tensor]:
    """``t``'s lane axis in D contiguous blocks, block i a contiguous copy
    on ``mesh.devices[i]``."""
    n = lane_block(t.shape[lane_axis], mesh.size)
    return [t.narrow(lane_axis, i * n, n).to(dev, copy=True)
            .contiguous() for i, dev in enumerate(mesh.devices)]


def gather_lanes(blocks: Sequence[torch.Tensor], lane_axis: int = 0,
                 device=None) -> torch.Tensor:
    """The blocks joined along their lane axis on ``device`` (default: the
    first block's)."""
    dev = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in blocks], dim=lane_axis)


def split_lane_state(state: Dict[str, Any], mesh) -> List[Dict[str, Any]]:
    """A lane-state dict as D per-shard dicts (the counterpart of the
    reference's ``lane_state_shardings`` + ``device_put``): every key of
    :data:`LANE_STATE_AXES` splits its lane axis, ``cond`` splits each
    value's axis 0, unknown keys replicate (copied to each shard)."""
    out: List[Dict[str, Any]] = [{} for _ in mesh.devices]
    for key, leaf in state.items():
        if key == "cond":
            parts = {k: split_lanes(v, mesh, 0) for k, v in leaf.items()}
            for i, shard in enumerate(out):
                shard[key] = {k: p[i] for k, p in parts.items()}
        elif key in LANE_STATE_AXES:
            for shard, block in zip(out, split_lanes(
                    leaf, mesh, LANE_STATE_AXES[key])):
                shard[key] = block
        else:
            for shard, dev in zip(out, mesh.devices):
                shard[key] = leaf.to(dev, copy=True) \
                    if isinstance(leaf, torch.Tensor) else leaf
    return out


def gather_lane_state(shards: Sequence[Dict[str, Any]],
                      device=None) -> Dict[str, Any]:
    """The inverse of :func:`split_lane_state`, on ``device`` (default:
    shard 0's): lane keys joined in shard order, unknown keys from shard
    0. For tests and host reads; the engine never gathers its state."""
    out: Dict[str, Any] = {}
    for key, leaf in shards[0].items():
        if key == "cond":
            out[key] = {k: gather_lanes([s[key][k] for s in shards], 0,
                                        device) for k in leaf}
        elif key in LANE_STATE_AXES:
            out[key] = gather_lanes([s[key] for s in shards],
                                    LANE_STATE_AXES[key], device)
        else:
            out[key] = leaf.to(device or leaf.device) \
                if isinstance(leaf, torch.Tensor) else leaf
    return out
