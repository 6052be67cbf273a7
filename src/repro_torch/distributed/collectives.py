"""Collectives over a mesh axis (port of ``repro/distributed/collectives.py``,
and the gathers and sums that sharded training and the sharded engine
advance make).

A collective runs over the process group of one axis of a ``DeviceMesh``
(``mesh.get_group(axis)``), in that group's rank order, which is the
mesh's order along the axis.

* ``gather_cat`` / ``gather_rows``: every rank's tensor, or tree of
  tensors, concatenated along one dimension in rank order (the
  reference's tiled ``lax.all_gather``).
* ``sum_disjoint``: the sum over the ranks of trees in which each element
  is nonzero on at most one rank (the reference's ``lax.psum`` of the
  sharded replay sample).  The ranks add the bits, as int32 words, so
  each element comes back exactly as its owner holds it, ``-0.0``
  included.

Both pack every leaf into int32 words (float32 bits as they are, bool
widened), so a tree costs one collective.  ``gather_blocks`` gathers a
list of tensors split along one dimension (the sharded engine's experts)
the same way.  With ``reader=`` these count the bytes each rank receives
(the collective's output) in ``BYTES[reader]``, per call: a CUDA graph's
replay adds nothing there, so a caller counts an eager step.

* ``compressed_allreduce``: the mean over the ranks, sent as int8 with a
  scale per block of 256 taken from the global maximum (``all_reduce``
  MAX), the codes summed in int32, and error feedback: the quantisation
  error of each rank's input comes back as a residual for its next call.
* ``ring_allreduce``: the sum over the ranks by a ring, reduce-scatter
  then all-gather in ``2(n - 1)`` rounds of ``batch_isend_irecv``, in the
  reference's schedule.

The LM mesh's (each on the sub-groups of named mesh axes, one collective
per axis, so a spec's ``("pod", "data")`` is two; each counts its bytes
in ``BYTES[reader]``; none waits for the host, so each runs inside a CUDA
graph):

* ``sum_over``: the SUM all-reduce, in place (gradients; the loss's
  normaliser); ``gather_cat`` above also gathers the data-parallel MoE's
  routing counts;
* ``gather_spec``: a tensor whole from this rank's block by its spec,
  minor axis first; ``reduce_scatter_spec`` the other way (a sum, major
  axis first); ``max_over``: the MAX all-reduce (the vocab-parallel
  loss's maximum);
* ``at_use``: a parameter as a layer computes with it.  A block that
  ``models.io.ShardedLM`` split over the data axes (its ``gather_spec``
  attribute) is gathered over them by an autograd function, reader
  ``"lm_params"``, whose backward reduce-scatters the gradient into the
  block's shape (a sum), reader ``"lm_grads"``; the ``model`` axis stays
  split.  ``regathered()`` keeps such a gathered weight out of autograd's
  saved tensors: a product that saves it (every einsum does) saves the
  block instead and gathers it again when the backward reads it, so no
  gathered weight outlives the layer's forward or backward
  (``live_gathers`` counts those alive);
* autograd functions: ``sum_forward`` (the MoE combine: forward the sum
  over ``model``, backward the gradient unchanged, since every model rank
  computes what follows alike; also the data-parallel MoE's router
  probabilities summed over the data axes, each rank's share reaching its
  own loss once), ``sum_backward`` (forward the tensor,
  backward the sum over ``model``: an input that the model ranks use for
  parts of one sum), ``data_mean`` (the MoE's ``aux``: forward the mean
  over the data axes, backward the gradient over their size, each data
  rank's loss holding its share).  A layer split over ``model`` (Megatron
  style, ``models/transformer.py``) ends in ``sum_forward`` (the
  row-parallel output's all-reduce) and starts from ``sum_backward`` (its
  input's gradient summed over the ranks that each used it for a part);
* ``model_gather`` and ``model_scatter``: an activation split by channel
  over ``model`` (RecurrentGemma's conv output, RWKV6's gated channel
  mix), gathered whole (backward a reduce-scatter, reader
  ``"tp_grads"``, or the rank's own block where every rank computes
  alike from the whole) or partial sums reduce-scattered into the rank's
  channels (backward an all-gather, ``"tp_grads"``); forward readers
  ``"tp_gather"`` and ``"tp_sum"``.

Under ``cfg.seq_parallel`` the residual stream of a whole-sequence pass
lives split by sequence over ``model`` between the layers
(``SeqSplit``, the reference's ``("batch", "seq", None)``): a rank holds
rows ``[r n/m, (r+1) n/m)`` of every sequence (``n`` padded up to a
multiple of ``m``, the padded rows zero).  Its autograd functions:

* ``SeqSplit.gather``: forward an all-gather along the sequence, the pad
  dropped; backward a reduce-scatter (the gradients of a layer split over
  ``model``, each rank's partial, summed into each rank's rows), or, with
  ``whole=True`` for a layer every rank computes alike, the rank's rows of
  the gradient, with no collective;
* ``SeqSplit.scatter``: forward a reduce-scatter (a split layer's partial
  outputs summed into each rank's rows, in place of the all-reduce);
  backward an all-gather;
* ``SeqSplit.rows``: a tensor whole and alike on every rank cut to the
  rank's rows; backward an all-gather, so what computed it alike gets
  the whole gradient on every rank;
* ``SeqSplit.own_grads``: forward the tensor; backward its gradient kept
  in the rank's rows only (zeros elsewhere): a computation every rank
  makes alike from a gathered input (the MoE's routing) hands the
  reduce-scatter its whole gradient once.

The all-gathers count their bytes under reader ``"sp_gather"``, the
reduce-scatters under ``"sp_scatter"`` (forward or backward alike).  A
weight that acts on the rank's rows (a norm's) takes its gradient
through ``sum_backward`` (reader ``"sp_norms"``).

A serving cache split by sequence over ``model`` (``sharding.serve_cache_spec``)
decodes with two more, both forward-only:

* ``gather_heads``: a rank's query heads (B, H/m, dh) whole over ``model``
  (one all-gather, reader ``"kv_query"``), so that it reads every head
  against its own slots;
* ``softmax_merge``: each rank's decode output over its slots and its
  log-sum-exp merged into the output over the whole cache (flash
  decoding): an all-reduce MAX of the log-sum-exp, then one all-reduce
  SUM of ``exp(lse - max)·o`` beside ``exp(lse - max)``, then the
  quotient (reader ``"kv_merge"``); a rank with no valid slot adds
  nothing, and where no rank has one the output is 0, as the
  decode-attention kernel gives over an empty cache.
"""
from __future__ import annotations

import contextlib
import types
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import local_shard, spec_axes
from repro_torch.kernels.decode_attn.ref import merge_quotient

_WORD = torch.int32
_TO_WORDS = (torch.float32, torch.int32, torch.bool)

# reader -> bytes received by this rank for it (gather_cat, gather_blocks
# and sum_disjoint with ``reader=``)
BYTES: Dict[str, int] = {}


def _count(reader: Optional[str], x: torch.Tensor) -> None:
    if reader is not None:
        BYTES[reader] = BYTES.get(reader, 0) + x.numel() * x.element_size()


def _leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [leaf for k, x in tree.items() for leaf in _leaves(x, prefix + (k,))]


def _build(pairs) -> object:
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    out: Dict = {}
    for path, x in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def to_words(xs, lead: int) -> torch.Tensor:
    """``xs`` side by side as int32 words: each tensor's first ``lead``
    dimensions kept (alike in all), the rest flattened into words."""
    cols = []
    for x in xs:
        if x.dtype not in _TO_WORDS:
            raise TypeError(f"no 32-bit word form for {x.dtype}")
        w = x.view(_WORD) if x.dtype == torch.float32 else x.to(_WORD)
        cols.append(w.reshape(tuple(x.shape[:lead]) + (-1,)))
    return torch.cat(cols, dim=-1)


def from_words(words: torch.Tensor, like) -> list:
    """Split ``to_words``'s words back into tensors shaped like ``like``
    past their leading dimensions (which come from ``words``), in their
    dtypes."""
    lead = tuple(words.shape[:-1])
    out, col = [], 0
    for x in like:
        tail = tuple(x.shape[len(lead):])
        n = 1
        for d in tail:
            n *= d
        w = words[..., col:col + n].reshape(lead + tail)
        col += n
        out.append(w.view(torch.float32) if x.dtype == torch.float32
                   else w.to(x.dtype))
    return out


def gather_cat(x: torch.Tensor, group, dim: int = 0,
               reader: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` (alike in shape) concatenated along ``dim`` in the
    group's rank order: one ``all_gather_into_tensor``."""
    k = dist.get_world_size(group)
    out = torch.empty((k * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.detach().contiguous(), group=group)
    _count(reader, out)
    out = out.reshape((k,) + tuple(x.shape)).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= k
    return out.reshape(shape)


def gather_rows(tree, group):
    """A tree of tensors with a leading batch axis (each rank's rows)
    gathered into the whole batch, rank-order rows: one collective."""
    pairs = _leaves(tree)
    xs = [x for _, x in pairs]
    words = gather_cat(to_words(xs, 1), group)
    full = [x.new_empty((words.shape[0],) + tuple(x.shape[1:])) for x in xs]
    return _build([(p, y) for (p, _), y in
                   zip(pairs, from_words(words, full))])


def gather_blocks(xs, group, dim: int = 1, reader: Optional[str] = None
                  ) -> list:
    """Tensors split along ``dim`` over the group (each rank's block, alike
    in shape) -> the whole tensors, blocks in rank order: one collective
    of their int32 words."""
    lead = dim + 1
    words = gather_cat(to_words(xs, lead), group, dim=dim, reader=reader)
    full = [x.new_empty(tuple(words.shape[:lead]) + tuple(x.shape[lead:]))
            for x in xs]
    return from_words(words, full)


def sum_disjoint(tree, group, reader: Optional[str] = None):
    """The sum over the group of trees in which every element is nonzero
    on one rank at most, bit-exact: one ``all_reduce`` of the int32 words
    (a zero word elsewhere adds nothing)."""
    pairs = _leaves(tree)
    xs = [x for _, x in pairs]
    words = to_words(xs, 0)
    dist.all_reduce(words, op=dist.ReduceOp.SUM, group=group)
    _count(reader, words)
    return _build([(p, y) for (p, _), y in zip(pairs, from_words(words, xs))])


def compressed_allreduce(tree, mesh, axis: str = "data", *,
                         residual: Optional[torch.Tensor] = None,
                         block: int = 256):
    """Mean-all-reduce ``tree`` over ``axis`` of ``mesh`` with int8
    compression and error feedback.  Returns (the averaged tree, the new
    residual: this rank's flat float32 quantisation error)."""
    group = mesh.get_group(axis)
    pairs = _leaves(tree)
    flat = torch.cat([x.to(torch.float32).reshape(-1) for _, x in pairs])
    v = flat + (torch.zeros_like(flat) if residual is None else residual)
    n = v.shape[0]
    vp = torch.nn.functional.pad(v, (0, (-n) % block)).reshape(-1, block)
    # quantise against the global-max scale of each block (one extra
    # small all_reduce), so the int32 sum of the codes decodes exactly
    # under a shared scale
    scale = torch.amax(torch.abs(vp), dim=1, keepdim=True)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(scale / 127.0, min=1e-12)
    q = torch.clamp(torch.round(vp / scale), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale).reshape(-1)[:n]
    new_res = v - deq
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    n_dev = float(dist.get_world_size(group))
    avg = (q_sum.to(torch.float32) * scale).reshape(-1)[:n] / n_dev
    out, off = [], 0
    for path, x in pairs:
        out.append((path, avg[off:off + x.numel()].reshape(x.shape)
                    .to(x.dtype)))
        off += x.numel()
    return _build(out), new_res


def ring_allreduce(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (m,) over ``axis`` of
    ``mesh``, by a ring: ``n - 1`` rounds of reduce-scatter, each rank
    sending one chunk to the next rank and adding the one it receives,
    then ``n - 1`` rounds of all-gather, in the reference's schedule."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    m = x.shape[0]
    if n == 1:
        return x.clone()
    chunk = -(-m // n)
    acc = torch.nn.functional.pad(x, (0, chunk * n - m)).reshape(n, chunk)
    idx = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)

    def shift(block: torch.Tensor) -> torch.Tensor:
        recv = torch.empty_like(block)
        ops = [dist.P2POp(dist.isend, block.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    for step in range(n - 1):
        recv = shift(acc[(idx - step) % n])
        tgt = (idx - step - 1) % n
        acc[tgt] = acc[tgt] + recv
    for step in range(n - 1):
        recv = shift(acc[(idx + 1 - step) % n])
        acc[(idx - step) % n] = recv
    return acc.reshape(-1)[:m]


# ---------------------------------------------------------------------------
# The LM mesh
# ---------------------------------------------------------------------------


def sum_over(x: torch.Tensor, mesh, axes, reader: Optional[str] = None
             ) -> torch.Tensor:
    """``x`` summed over the ranks of the mesh ``axes``, in place: one
    all-reduce per axis."""
    for a in axes:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
        _count(reader, x)
    return x


def gather_spec(x: torch.Tensor, spec, mesh, keep=(),
                reader: Optional[str] = None) -> torch.Tensor:
    """The tensor whose block by ``spec`` this rank holds in ``x``, whole
    but for the axes ``keep``: along each split dim, one all-gather per
    axis, the minor first (a block's index is row-major over its axes)."""
    for dim, entry in enumerate(spec):
        for a in reversed([a for a in spec_axes(entry) if a not in keep]):
            x = gather_cat(x, mesh.get_group(a), dim=dim, reader=reader)
    return x


def reduce_scatter_spec(x: torch.Tensor, spec, mesh, keep=(),
                        reader: Optional[str] = None) -> torch.Tensor:
    """The sum over the ranks of the axes that ``spec`` splits (but
    ``keep``) of ``x``, a tensor of the whole shape, cut to this rank's
    block: along each split dim, one reduce-scatter per axis, the major
    first (``gather_spec``'s inverse)."""
    for dim, entry in enumerate(spec):
        for a in [a for a in spec_axes(entry) if a not in keep]:
            group = mesh.get_group(a)
            k = dist.get_world_size(group)
            inp = x.movedim(dim, 0).contiguous()
            out = inp.new_empty((inp.shape[0] // k,) + tuple(inp.shape[1:]))
            dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM,
                                       group=group)
            _count(reader, out)
            x = out.movedim(0, dim)
    return x


def max_over(x: torch.Tensor, mesh, axes, reader: Optional[str] = None
             ) -> torch.Tensor:
    """``x`` maximised over the ranks of the mesh ``axes``, in place."""
    for a in axes:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
        _count(reader, x)
    return x


def gather_heads(q: torch.Tensor, mesh, reader: Optional[str] = "kv_query"
                 ) -> torch.Tensor:
    """Every ``model`` rank's heads of ``q`` (B, H/m, dh), in rank order:
    the whole (B, H, dh), contiguous."""
    return gather_cat(q, mesh.get_group("model"), dim=1,
                      reader=reader).contiguous()


def softmax_merge(o: torch.Tensor, lse: torch.Tensor, mesh,
                  reader: Optional[str] = "kv_merge") -> torch.Tensor:
    """Each ``model`` rank's decode output ``o`` (B, H, dh) over its
    slots of a cache and its log-sum-exp ``lse`` (B, H) merged over
    ``model`` into the output over the whole cache, in ``o``'s dtype
    (module docstring; ``kernels.decode_attn.ref.merge_partials`` in one
    process)."""
    big = max_over(lse.clone(), mesh, ("model",), reader)
    w = torch.exp(lse - torch.where(big == float("-inf"), 0.0, big))
    part = torch.cat([o.float() * w[..., None], w[..., None]], dim=-1)
    sum_over(part, mesh, ("model",), reader)
    return merge_quotient(part[..., :-1], part[..., -1]).to(o.dtype)


# storage address of a gathered weight -> (a weak reference to it, the
# block, its spec, the mesh): what ``regathered``'s hooks need to gather it
# again
_GATHERED: Dict[int, tuple] = {}


def live_gathers() -> int:
    """How many weights gathered at their use are alive."""
    return sum(ref() is not None for ref, *_ in _GATHERED.values())


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, mesh):
        ctx.args = (spec, mesh)
        return gather_spec(block, spec, mesh, ("model",), reader="lm_params")

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.args
        return (reduce_scatter_spec(g, spec, mesh, ("model",),
                                    reader="lm_grads"), None, None)


def at_use(p: torch.Tensor) -> torch.Tensor:
    """``p`` as a layer computes with it: gathered over the data axes that
    split it when it carries a ``gather_spec`` (module docstring), under
    the current policy's mesh; else ``p`` itself."""
    spec = getattr(p, "gather_spec", None)
    if spec is None:
        return p
    from repro_torch.distributed.api import current_policy

    policy = current_policy()
    if policy is None:
        raise RuntimeError("a parameter split over the data axes is "
                           "gathered at its use under a mesh policy only")
    full = _GatherAtUse.apply(p, spec, policy.mesh)
    for k in [k for k, v in _GATHERED.items() if v[0]() is None]:
        del _GATHERED[k]
    _GATHERED[full.untyped_storage().data_ptr()] = (
        weakref.ref(full), p, spec, policy.mesh)
    return full


def layer_weights(mod, names):
    """``mod``'s parameters ``names`` as a layer computes with them
    (``at_use``), in a namespace; a missing one is None."""
    return types.SimpleNamespace(**{
        n: None if getattr(mod, n) is None else at_use(getattr(mod, n))
        for n in names})


def _pack(t: torch.Tensor):
    entry = _GATHERED.get(t.untyped_storage().data_ptr())
    if entry is None or entry[0]() is None:
        return t
    _, block, spec, mesh = entry
    return block, spec, mesh, tuple(t.shape), t.stride(), t.storage_offset()


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    block, spec, mesh, shape, stride, offset = packed
    with torch.no_grad():
        full = gather_spec(block, spec, mesh, ("model",), reader="lm_params")
    return full.as_strided(shape, stride, offset)


@contextlib.contextmanager
def regathered():
    """Inside the block, a tensor that autograd saves and that is (a view
    of) a weight gathered at its use is saved as its block and gathered
    again when the backward reads it (module docstring)."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


def mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others: a one-word all-reduce
    over each axis in turn."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    sum_over(torch.zeros(1, device=dev), mesh, mesh.mesh_dim_names)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, reader):
        return sum_over(x.clone(), mesh, axes, reader)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, reader):
        ctx.args = (mesh, axes, reader)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.clone(), *ctx.args), None, None, None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, n, reader):
        ctx.n = n
        return sum_over(x.clone(), mesh, axes, reader) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None, None, None


def sum_forward(x, mesh, axes, reader: Optional[str] = None):
    """Forward the sum over ``axes``; backward the gradient unchanged."""
    return _SumForward.apply(x, mesh, tuple(axes), reader)


def sum_backward(x, mesh, axes, reader: Optional[str] = None):
    """Forward ``x``; backward the gradient summed over ``axes``."""
    return _SumBackward.apply(x, mesh, tuple(axes), reader)


def data_mean(x, mesh, axes, reader: Optional[str] = None):
    """The mean over the ranks of ``axes``; the gradient comes back
    divided by their number."""
    n = 1
    for a in axes:
        n *= dist.get_world_size(mesh.get_group(a))
    return _DataMean.apply(x, mesh, tuple(axes), n, reader)


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, whole, reader):
        ctx.args = (spec, mesh, whole)
        return gather_spec(x, spec, mesh, reader=reader)

    @staticmethod
    def backward(ctx, g):
        spec, mesh, whole = ctx.args
        if whole:
            g = local_shard(g, spec, mesh).contiguous()
        else:
            g = reduce_scatter_spec(g, spec, mesh, reader="tp_grads")
        return g, None, None, None, None


class _ModelScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, reader):
        ctx.args = (spec, mesh)
        return reduce_scatter_spec(x, spec, mesh, reader=reader)

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.args
        return (gather_spec(g, spec, mesh, reader="tp_grads"), None, None,
                None)


def model_gather(x, spec, mesh, whole: bool = False,
                 reader: Optional[str] = "tp_gather"):
    """A rank's block of an activation split over ``model`` by ``spec``
    (its channels) gathered whole: forward an all-gather.  Backward a
    reduce-scatter (reader ``"tp_grads"``): the ranks' column-parallel
    products each give a partial gradient of the whole tensor, summed
    into each rank's block; or, with ``whole=True`` for a tensor that
    every rank goes on to compute with alike, the rank's block of the
    gradient, with no collective."""
    return _ModelGather.apply(x, spec, mesh, whole, reader)


def model_scatter(x, spec, mesh, reader: Optional[str] = "tp_sum"):
    """Partial sums of a whole activation, one on each ``model`` rank,
    summed into the rank's block by ``spec``: forward a reduce-scatter;
    backward an all-gather (reader ``"tp_grads"``), each rank's partial
    taking the gradient of the whole sum."""
    return _ModelScatter.apply(x, spec, mesh, reader)


# ---------------------------------------------------------------------------
# The sequence split of the residual stream (``cfg.seq_parallel``)
# ---------------------------------------------------------------------------


def _seq_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows (B, r, ...) along dim 1 in rank order: (B, k r,
    ...)."""
    return gather_cat(x, group, dim=1, reader="sp_gather")


def _seq_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """(B, k r, ...) summed over the ranks, this rank's block of r rows
    along dim 1."""
    k = dist.get_world_size(group)
    b, n = x.shape[:2]
    rest = (n // k,) + tuple(x.shape[2:])
    inp = x.reshape((b, k) + rest).movedim(1, 0).reshape((k * b,) + rest)
    out = inp.new_empty((b,) + rest)
    dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, group=group)
    _count("sp_scatter", out)
    return out


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, s, ...) with zero rows appended along dim 1 up to ``n``."""
    if x.shape[1] == n:
        return x
    pad = x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, whole):
        ctx.split, ctx.whole = split, whole
        return _seq_all_gather(x, split.group).narrow(1, 0, split.n)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        g = _pad_rows(g, s.m * s.n_own)
        if ctx.whole:
            return g.narrow(1, s.lo, s.n_own).contiguous(), None, None
        return _seq_reduce_scatter(g, s.group), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _seq_reduce_scatter(_pad_rows(x, split.m * split.n_own),
                                   split.group)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return _seq_all_gather(g, s.group).narrow(1, 0, s.n), None


class _SeqRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _pad_rows(x, split.m * split.n_own).narrow(
            1, split.lo, split.n_own).contiguous()

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return _seq_all_gather(g, s.group).narrow(1, 0, s.n), None


class _OwnGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        pos = torch.arange(g.shape[1], device=g.device)
        own = (pos >= s.lo) & (pos < s.lo + s.n_own)
        shape = (1, -1) + (1,) * (g.dim() - 2)
        return torch.where(own.reshape(shape), g, 0.0), None


class SeqSplit:
    """The sequence split over ``model`` of a whole-sequence pass of ``n``
    positions (module docstring): ``tp`` is the policy's ``(mesh, m,
    index)`` (``api.model_parallel``).  A rank holds ``n_own = ceil(n /
    m)`` rows from ``lo = index * n_own``; the last ranks' rows past ``n``
    are padding."""

    def __init__(self, tp, n: int):
        self.mesh, self.m, self.idx = tp
        self.group = self.mesh.get_group("model")
        self.n = n
        self.n_own = -(-n // self.m)
        self.lo = self.idx * self.n_own

    def gather(self, x, whole: bool = False):
        """The rank's rows (B, n_own, ...) -> the whole (B, n, ...)."""
        return _SeqGather.apply(x, self, whole)

    def scatter(self, x):
        """Partial outputs (B, n, ...) -> their sum's rows of this rank."""
        return _SeqScatter.apply(x, self)

    def rows(self, x):
        """A tensor (B, n, ...) alike on every rank -> its rows here."""
        return _SeqRows.apply(x, self)

    def own_grads(self, x):
        """``x`` (B, n, ...), its gradient kept in this rank's rows."""
        return _OwnGrads.apply(x, self)
