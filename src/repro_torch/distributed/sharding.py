"""Where tensors live on a mesh (port of ``repro/distributed/sharding.py``).

A mesh is a ``DeviceMesh`` of ``launch.mesh``.  The reference names a
``PartitionSpec`` for each array and lets XLA place the shards; here each
rank holds its own shard, and these helpers say which part is its own.

Router training (an ``expert`` axis and perhaps a ``data`` axis):

  * the engine's expert axis: a ``(B, N, ...)`` queue tensor splits on N
    into one block of ``N / k`` experts per rank of the ``expert`` axis
    (``expert_rows``);
  * the replay buffer: every transition tensor splits on its capacity
    axis over ``expert``; ``ptr``, ``size`` and ``capacity`` are global
    on every rank (``replay_specs``, ``shard_replay_buffer``);
  * the collect batch: on a 2-D mesh the envs split over ``data``
    (``data_shards``).

The LMs (a ``("data", "model")`` or ``("pod", "data", "model")`` mesh),
by the reference's rules and names: FSDP over ``data`` (and ``pod``) on
the widest non-tensor-parallel dim of every weight when training, tensor
parallelism over ``model`` on heads, ff, vocab and experts
(``param_spec``, ``shard_params_specs``); serving caches over batch and
sequence (``cache_spec``, ``shard_cache_specs``); the batch over the data
axes (``batch_axes``, ``data_spec``); activation rules for a
``MeshPolicy`` (``activation_rules``).  A spec is a tuple with one entry
per dim: ``None``, an axis name, or a tuple of names (the first the
major), as a ``PartitionSpec`` holds them.  The rules read a mesh only
through ``mesh_shape``, so a stand-in with a ``.shape`` dict (the
production meshes' 256 and 512 ranks) gives the same specs.
``local_shard`` is this rank's part of a tensor by its spec;
``block_spec`` the block a rank holds (``param_spec``'s, but RWKV6's
``wk``, ``wv`` and ``wo`` split by head where the reference's rule splits
other dims, for serving and training alike); ``compute_spec`` the part a
layer computes with (the ``model`` split kept, the data axes gathered at
the use).
``serve_cache_spec`` is the port's serving cache layout beside the
reference's ``cache_spec``: K/V by KV head where the heads divide
``model``, else by sequence where the length divides, else whole; the
recurrent states by head or channel.
"""
from __future__ import annotations

import math
import types
from typing import Dict, Optional, Sequence, Tuple

import torch

EXPERT = "expert"  # scheduling-engine expert axis (edge-expert fleet)
DATA = "data"      # collect-batch (env) axis of the 2-D training mesh


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh or the axis)."""
    return 1 if mesh is None else mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh or the axis,
    and on a stand-in with a ``.shape`` alone, which has no ranks: rank 0's
    blocks are as large as any)."""
    if axis_size(mesh, axis) == 1 or not hasattr(mesh, "get_local_rank"):
        return 0
    return mesh.get_local_rank(axis)


def expert_rows(mesh, n_experts: int) -> slice:
    """This rank's block of the engine's N experts: the ``expert`` axis
    splits them when it is larger than 1 and divides N, else every rank
    holds all N (the reference's ``expert_spec``)."""
    k = axis_size(mesh, EXPERT)
    if k > 1 and n_experts % k == 0:
        per = n_experts // k
        i = axis_index(mesh, EXPERT)
        return slice(i * per, (i + 1) * per)
    return slice(0, n_experts)


def replay_shards(mesh, capacity: int) -> int:
    """Number of capacity-axis shards the replay buffer splits into on this
    mesh: the size of the ``expert`` axis.  Raises when the capacity does
    not divide evenly; silent padding would break the ring-pointer
    arithmetic's bit-identity with the single-device buffer."""
    if mesh is None or EXPERT not in (mesh.mesh_dim_names or ()):
        return 1
    n = axis_size(mesh, EXPERT)
    if capacity % n != 0:
        raise ValueError(
            f"buffer_capacity={capacity} not divisible by mesh axis "
            f"'{EXPERT}'={n}")
    return n


def data_shards(mesh, n_envs: int) -> int:
    """Number of collect-batch shards on this mesh: the size of the
    ``data`` axis of a 2-D training mesh, 1 without it.  Raises when the
    env count does not divide evenly."""
    if mesh is None or DATA not in (mesh.mesh_dim_names or ()):
        return 1
    n = axis_size(mesh, DATA)
    if n_envs % n != 0:
        raise ValueError(
            f"n_envs={n_envs} not divisible by mesh axis '{DATA}'={n}")
    return n


def replay_specs() -> dict:
    """The axis each replay-buffer entry's first dimension splits over:
    every transition tensor (each ``obs``/``next_obs`` leaf too) on the
    capacity axis over ``expert``; ``None`` for the ring scalars, which
    every rank holds whole so that all agree on the global cursor."""
    return {"obs": EXPERT, "next_obs": EXPERT, "action": EXPERT,
            "reward": EXPERT, "discount": EXPERT,
            "ptr": None, "size": None, "capacity": None}


def shard_replay_buffer(buf: dict, mesh) -> dict:
    """This rank's part of a fresh buffer of ``replay.init``: rows
    ``[i * cap / n, (i + 1) * cap / n)`` of every transition tensor for
    shard ``i``, this rank's ``expert`` coordinate, copied into storage of
    their own, and copies of the ring scalars.  ``capacity`` stays the
    global capacity."""
    n = replay_shards(mesh, int(buf["capacity"]))
    if n == 1:
        return buf
    i = axis_index(mesh, EXPERT)
    per = buf["capacity"] // n
    rows = lambda x: x[i * per:(i + 1) * per].clone()
    out = {}
    for k, axis in replay_specs().items():
        x = buf[k]
        if axis is None:
            out[k] = x.clone() if isinstance(x, torch.Tensor) else x
        elif isinstance(x, dict):
            out[k] = {name: rows(leaf) for name, leaf in x.items()}
        else:
            out[k] = rows(x)
    return out


# ---------------------------------------------------------------------------
# The LM rules
# ---------------------------------------------------------------------------

# logical axes of the LM rules
FSDP = "fsdp"   # data(+pod) sharding of params
TP = "tp"       # model axis

# name -> logical spec of the trailing dims (longest match wins)
_PARAM_RULES = {
    # embeddings / heads
    "embed": (TP, FSDP),          # (vocab, d)
    "lm_head": (FSDP, TP),        # (d, vocab)
    # attention
    "wq": (FSDP, TP, None),       # (d, H, dh)
    "wk": (FSDP, TP, None),       # (d, KV, dh)
    "wv": (FSDP, TP, None),
    "wo": (TP, None, FSDP),       # (H, dh, d)
    "bq": (TP, None),
    "bk": (TP, None),
    "bv": (TP, None),
    # dense mlp
    "w_gate": (FSDP, TP),         # (d, f)
    "w_up": (FSDP, TP),
    "w_down": (TP, FSDP),         # (f, d)
    "w1": (FSDP, TP),
    "b1": (TP,),
    "w2": (TP, FSDP),
    "b2": (None,),
    # moe (stacked expert dim first)
    "router": (None, None),
    # rwkv time mix
    "wr": (FSDP, TP),
    "wg": (FSDP, TP),
    "wA": (FSDP, None),
    "wB": (None, FSDP),
    "u": (TP, None),              # (H, dh)
    "wk_c": (FSDP, TP),
    "wv_c": (TP, FSDP),
    "wr_c": (FSDP, TP),
    # rglru
    "w_x": (FSDP, TP),            # (d, rnn)
    "conv_w": (None, TP),         # (cw, rnn)
    "conv_b": (TP,),
    "w_r": (FSDP, TP),
    "w_i": (FSDP, TP),
    "b_r": (TP,),
    "b_i": (TP,),
    "lam": (TP,),
    "w_out": (TP, FSDP),          # (rnn, d)
}

# MoE expert-stacked weights: (E, d, f) / (E, f, d) — expert dim -> TP (EP)
_MOE_RULES = {
    "w_gate": (TP, FSDP, None),
    "w_up": (TP, FSDP, None),
    "w_down": (TP, None, FSDP),
}


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size: a ``DeviceMesh`` by its ``mesh_dim_names``, or
    anything with a ``.shape`` mapping (the reference's ``Mesh``, a test's
    stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return {a: int(mesh.size(i)) for i, a in enumerate(names)}
    return {a: int(n) for a, n in dict(mesh.shape).items()}


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entry(axes):
    """A spec entry as a ``PartitionSpec`` holds it: ``None``, a name for
    one axis, a tuple for several."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _names(path) -> list:
    return path.split("/") if isinstance(path, str) else list(path)


def _axes_for(mesh, logical: Optional[str], fsdp_axes: Tuple[str, ...],
              dim: int) -> Optional[Tuple[str, ...]]:
    if logical is None:
        return None
    shape = mesh_shape(mesh)
    axes = fsdp_axes if logical == FSDP else ("model",)
    axes = tuple(a for a in axes if a in shape)
    if not axes:
        return None
    size = math.prod(shape[a] for a in axes)
    if size == 1 or dim % size != 0:
        # try a prefix of the axes (e.g. only "pod" when (pod,data) doesn't divide)
        for k in range(len(axes) - 1, 0, -1):
            sz = math.prod(shape[a] for a in axes[:k])
            if sz > 1 and dim % sz == 0:
                return axes[:k]
        return None
    return axes


def fsdp_axes_for(mesh, train: bool) -> Tuple[str, ...]:
    if not train:
        return ()  # serving: replicate params over data for read-only weights
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, ``pod`` first."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def is_expert_weight(path) -> bool:
    """An MoE layer's expert-stacked weight (``_MOE_RULES``)."""
    names = _names(path)
    return "moe" in names and names[-1] in _MOE_RULES


def param_spec(path: Sequence, arr_shape: Tuple[int, ...], mesh, *,
               train: bool) -> tuple:
    """The spec of the parameter at ``path`` (its names, or a
    ``/``-joined string) of shape ``arr_shape``: the rule of its last name
    (``_MOE_RULES`` inside a ``moe`` component) on its trailing dims,
    leading (stacked) dims unsharded."""
    names = _names(path)
    name = names[-1]
    rules = _MOE_RULES if is_expert_weight(names) else _PARAM_RULES
    logical = rules.get(name)
    fsdp = fsdp_axes_for(mesh, train)
    if logical is None:
        # norms / scalars / unknown small params: replicate
        return (None,) * len(arr_shape)
    n_lead = len(arr_shape) - len(logical)
    if n_lead < 0:  # e.g. adafactor factored moments with a reduced dim
        return (None,) * len(arr_shape)
    spec = [None] * n_lead
    for dim, lg in zip(arr_shape[n_lead:], logical):
        axes = _axes_for(mesh, lg, fsdp, dim)
        spec.append(None if axes is None else (axes if len(axes) > 1 else axes[0]))
    return tuple(spec)


def shard_params_specs(param_shapes: dict, mesh, *, train: bool) -> dict:
    """``path -> spec`` for a flat ``path -> shape`` (or tensor) dict with
    ``/``-joined paths."""
    return {k: param_spec(k, tuple(getattr(x, "shape", x)), mesh, train=train)
            for k, x in param_shapes.items()}


def batch_axes(mesh, batch_size: int) -> Optional[Tuple[str, ...]]:
    """Axes to shard the batch dim over: the largest divisible subset of
    (pod, data) — preferring full, then data alone, then pod alone."""
    shape = mesh_shape(mesh)
    axes = data_axes(mesh)
    candidates = [axes] + [(a,) for a in sorted(axes, key=lambda a: -shape[a])]
    for cand in candidates:
        size = math.prod(shape[a] for a in cand)
        if size > 1 and batch_size % size == 0:
            return cand
    return None


def data_spec(mesh, batch_size: int, ndim: int) -> tuple:
    """Shard dim 0 (batch) over pod+data, rest replicated."""
    ax = batch_axes(mesh, batch_size)
    spec = [None] * ndim
    if ax is not None:
        spec[0] = ax if len(ax) > 1 else ax[0]
    return tuple(spec)


def batch_spec(mesh, global_batch: int, microbatches: int = 1) -> tuple:
    """The spec of a (B, S) token batch, or (M, B/M, S) with ``M =
    microbatches > 1`` and dim 1 over the data axes (the reference's
    ``batch_specs``).  Rows that do not split over every data axis split
    over ``batch_axes``' fallback, or over none: the data ranks outside it
    hold the same rows, and a step under a policy whose ``"batch"`` rule
    names the axes that split them (``distributed.api.batch_axes``)
    scales its loss so that the gradients summed over every data axis are
    the one-process run's (``models.model.lm_loss``)."""
    m = max(1, microbatches)
    rows = global_batch // m if m > 1 else global_batch
    spec = data_spec(mesh, rows, 2)
    return spec if m == 1 else (None,) + spec


def cache_spec(path: Sequence, arr_shape: Tuple[int, ...], mesh,
               batch_size: int) -> tuple:
    """Serving cache sharding: batch dim over data(+pod), kv-heads/state
    channels over model when divisible.

    This is the reference's layout, whose K/V split their SEQUENCE over
    ``model`` (flash-decoding: each rank's partial softmax merged by a
    psum).  The port's steps keep another (``launch/steps.py``): a rank's
    batch rows and the KV heads its column-parallel ``wk``/``wv`` give it,
    the KV heads over ``model`` where they divide and whole on every
    ``model`` rank where they do not, so a step reshards nothing."""
    name = _names(path)[-1]
    shape = mesh_shape(mesh)
    bax = spec_entry(batch_axes(mesh, batch_size))
    model_ok = lambda d: (d % shape["model"] == 0 and shape["model"] > 1)

    if name in ("pos", "enc_len"):
        if len(arr_shape) == 1:  # per-sequence positions (B,)
            return (bax,)
        return (None,) * len(arr_shape)
    if name in ("kv_pos",):
        lead = [None] * (len(arr_shape) - 2)
        return tuple(lead + [bax, None]) if len(arr_shape) >= 2 else (None,)
    if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
        # (L?, B, S, KV, dh): batch over data, SEQUENCE over model
        spec = [None] * len(arr_shape)
        spec[-4] = bax
        if model_ok(arr_shape[-3]):
            spec[-3] = "model"
        elif model_ok(arr_shape[-2]):
            spec[-2] = "model"
        return tuple(spec)
    if name == "S":  # rwkv state (L, B, H, dk, dv)
        spec = [None] * len(arr_shape)
        spec[-4] = bax
        if model_ok(arr_shape[-3]):
            spec[-3] = "model"
        return tuple(spec)
    if name in ("tm_prev", "cm_prev"):  # (L, B, d)
        spec = [None] * len(arr_shape)
        spec[-2] = bax
        if model_ok(arr_shape[-1]):
            spec[-1] = "model"
        return tuple(spec)
    if name == "h":  # rglru (n, B, rnn)
        spec = [None] * len(arr_shape)
        spec[-2] = bax
        if model_ok(arr_shape[-1]):
            spec[-1] = "model"
        return tuple(spec)
    if name == "conv":  # (n, B, cw-1, rnn)
        spec = [None] * len(arr_shape)
        spec[-3] = bax
        if model_ok(arr_shape[-1]):
            spec[-1] = "model"
        return tuple(spec)
    spec = [None] * len(arr_shape)
    if len(arr_shape) >= 2:
        spec[-2] = bax
    return tuple(spec)


def shard_cache_specs(cache, mesh, batch_size: int, _path=()):
    """The spec of every tensor of a cache (dicts and lists of tensors),
    by the name of the dict key above it; the same structure."""
    if isinstance(cache, dict):
        return {k: shard_cache_specs(x, mesh, batch_size, _path + (k,))
                for k, x in cache.items()}
    if isinstance(cache, (list, tuple)):
        return [shard_cache_specs(x, mesh, batch_size, _path) for x in cache]
    return cache_spec(_path, tuple(cache.shape), mesh, batch_size)


def activation_rules(mesh, *, train: bool) -> dict:
    """Logical activation axes -> mesh axes for api.constrain()."""
    bax = data_axes(mesh)
    return {
        "batch": bax or None,
        "tokens": bax or None,       # flattened token dim
        "experts": ("model",),
        "capacity": bax or None,
        "heads": ("model",),
        "seq": ("model",),           # sequence parallelism segments
        "embed": None,
        "ff": ("model",),
        "vocab": ("model",),
    }


# ---------------------------------------------------------------------------
# A rank's part of a tensor by its spec
# ---------------------------------------------------------------------------


def block_index(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim split over
    ``axes``, the first the major."""
    shape = mesh_shape(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * shape[a] + axis_index(mesh, a)
        n *= shape[a]
    return idx, n


def local_shard(x: torch.Tensor, spec: Sequence, mesh,
                keep: Sequence = ()) -> torch.Tensor:
    """This rank's block of ``x`` (a view) along every dim its spec splits,
    leaving out the axes ``keep`` (which ``x`` is already split over)."""
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in spec_axes(entry) if a not in keep)
        if not axes:
            continue
        i, n = block_index(mesh, axes)
        per = x.shape[dim] // n
        x = x.narrow(dim, i * per, per)
    return x


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shape of a rank's block of a tensor of ``shape``."""
    sizes = mesh_shape(mesh)
    return tuple(n // math.prod(sizes[a] for a in spec_axes(e))
                 for n, e in zip(shape, spec))


# RWKV6's time-mix leaves (d, d) that the reference's 3-D attention rules
# ("wk", "wv", "wo") reach: the port's layout (block_spec), the logical
# rules of wr (column-parallel) and wv_c (row-parallel)
_RWKV_TIME_MIX = {"wk": (FSDP, TP), "wv": (FSDP, TP), "wo": (TP, FSDP)}


def _rwkv_time_mix(names) -> bool:
    """An RWKV6 ``wk``, ``wv`` or ``wo``: directly under ``layers`` (the
    attention weights of the other families sit under an attention
    module)."""
    return (len(names) >= 2 and names[-2] == "layers"
            and names[-1] in _RWKV_TIME_MIX)


def block_spec(path, shape: Sequence[int], mesh, *, train: bool) -> tuple:
    """The spec of the block a rank holds of the leaf at ``path`` of
    ``shape`` (``models.io.ShardedLM``): ``param_spec``'s, with one
    departure.  RWKV6's ``wk``, ``wv`` and ``wo`` (each (d, d) a layer)
    take the reference's 3-D attention rules, which on the stacked (L, d,
    d) leaf split ``wk``/``wv`` by input rows and ``wo`` by the layer axis
    (training gives ``('data', 'model', None)`` and ``('model', None,
    'data')``).  The port splits them by head for serving and training
    alike: ``wk`` and ``wv`` column-parallel as ``wr`` is, ``(data,
    model)`` on a layer's (d, d), and ``wo`` row-parallel as ``wv_c`` is,
    ``(model, data)`` (the data axes only with ``train``).  So each rank's
    time mix runs on its ``H/m`` heads, as it does when served, and no
    layer's ``wo`` moves between ranks (a whole ``wo`` a rank per layer,
    as the layer-axis split would need, is 32 MiB of rwkv6-7b a layer a
    step).  ``models.io.sharded_params_to_numpy`` gathers by these specs,
    so it still returns the reference's tree."""
    names = _names(path)
    if not _rwkv_time_mix(names):
        return param_spec(path, shape, mesh, train=train)
    fsdp = fsdp_axes_for(mesh, train)
    spec = [None] * (len(shape) - 2)
    for dim, lg in zip(shape[-2:], _RWKV_TIME_MIX[names[-1]]):
        axes = _axes_for(mesh, lg, fsdp, dim)
        spec.append(None if axes is None else spec_entry(axes))
    return tuple(spec)


def compute_spec(path, shape: Sequence[int], mesh, *, train: bool) -> tuple:
    """The spec of the tensor a layer computes with for the leaf at
    ``path`` of ``shape``: ``block_spec``'s ``model`` entries (tensor
    parallelism), the data axes gathered at the use (FSDP).  A dim that
    ``model`` does not divide stays whole, and the layer computes that
    part whole on every ``model`` rank."""
    return tuple(e if "model" in spec_axes(e) else None
                 for e in block_spec(path, shape, mesh, train=train))


_KV_NAMES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v")


def serve_cache_spec(path: Sequence, arr_shape: Tuple[int, ...], mesh,
                     batch_size: int) -> tuple:
    """The port's serving cache layout (``cache_spec`` is the
    reference's): the batch over the data axes as there; over ``model``,

      * K/V ``(L?, B, S, KV, dh)``: the KV heads where they divide
        ``model`` (a rank's ``wk``/``wv`` blocks give its heads), else the
        sequence ``S`` where it divides (each rank its ``S/m`` slots: the
        decode merges the ranks' partial softmaxes,
        ``collectives.softmax_merge``), else whole on every rank;
      * ``kv_pos (B, S)``: whole (4 bytes a slot: each rank reads the
        positions of its slots and writes every slot's, so the ranks agree
        on which slot the next token takes);
      * RWKV6's ``S (L, B, H, dk, dv)`` by head; RG-LRU's ``h (B, rnn)``
        and ``conv (B, cw-1, rnn)`` (the port's per-layer states) by
        channel;
      * ``tm_prev``, ``cm_prev (L, B, d)`` whole: the token shift's input
        feeds the column-parallel products, which need it whole."""
    name = _names(path)[-1]
    shape = mesh_shape(mesh)
    m = shape.get("model", 1)
    bax = spec_entry(batch_axes(mesh, batch_size))
    divides = lambda d: m > 1 and d % m == 0
    spec = [None] * len(arr_shape)
    if name in ("pos", "enc_len"):
        return (bax,) if len(arr_shape) == 1 else tuple(spec)
    if name in _KV_NAMES:
        spec[-4] = bax
        if divides(arr_shape[-2]):
            spec[-2] = "model"
        elif divides(arr_shape[-3]):
            spec[-3] = "model"
        return tuple(spec)
    if name == "S":
        spec[-4] = bax
        if divides(arr_shape[-3]):
            spec[-3] = "model"
        return tuple(spec)
    if name in ("h", "conv"):
        spec[0] = bax
        if divides(arr_shape[-1]):
            spec[-1] = "model"
        return tuple(spec)
    if name in ("tm_prev", "cm_prev"):
        spec[-2] = bax
        return tuple(spec)
    if len(arr_shape) >= 2:                   # kv_pos
        spec[-2] = bax
    return tuple(spec)


def serve_step_bytes(cfg, m: int, rows: int, tokens: int, cache_len: int,
                     decode: bool) -> dict:
    """The bytes a rank of a ``model`` axis of ``m`` receives, by
    ``collectives.BYTES`` reader, in one serving step (a prefill of
    ``rows`` x ``tokens``, or a decode of ``rows`` tokens over caches of
    ``cache_len`` slots) of a transformer, RWKV6 or RecurrentGemma model,
    from the specs: an all-reduce or a gather counts its output, a
    reduce-scatter its rank's block.  Activations in the compute dtype,
    the RG-LRU's gathered conv output and the merge's sums in float32:

      * ``tp_sum``: the embedding's and each row-parallel product's sum
        (B T d), RWKV6's channel-mix reduce-scatter (B T d/m);
      * ``tp_gather``: RWKV6's gated channels (B T d), the RG-LRU's conv
        output (B T rnn, float32);
      * ``kv_query``, ``kv_merge``: a decode over a cache split by
        sequence, the query heads gathered where they split (B H dh),
        and the merge's MAX (B H) and SUM (B H (dh + 1)) in float32;
      * ``lm_logits``: the logits gathered (B Vp)."""
    elt = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                      ).element_size()
    f32, d, h = 4, cfg.d_model, cfg.n_heads
    n = rows * (1 if decode else tokens)
    splits = lambda k: m > 1 and k % m == 0
    got = dict.fromkeys(("tp_sum", "tp_gather", "lm_logits", "kv_query",
                         "kv_merge"), 0)
    if splits(cfg.vocab_padded):
        got["tp_sum"] += n * d * elt                        # the embedding
        got["lm_logits"] += rows * cfg.vocab_padded * elt
    if cfg.family == "ssm":
        if splits(cfg.n_heads) and splits(d):
            got["tp_sum"] += cfg.n_layers * n * d * elt     # the time mix
        if splits(d):                                       # the channel mix
            got["tp_sum"] += cfg.n_layers * n * (d // m if splits(cfg.d_ff)
                                                 else 0) * elt
            got["tp_gather"] += cfg.n_layers * n * d * elt
        elif splits(cfg.d_ff):
            got["tp_sum"] += cfg.n_layers * n * d * elt
        return {k: v for k, v in got.items() if v}
    if cfg.family == "hybrid":
        from repro_torch.models import rglru

        kinds = rglru.layer_kinds(cfg)
    else:
        kinds = ["attn"] * cfg.n_layers
    for kind in kinds:
        if kind == "rec":
            if splits(cfg.rnn_width):
                got["tp_gather"] += n * cfg.rnn_width * f32
                got["tp_sum"] += n * d * elt
        else:
            if splits(h):
                got["tp_sum"] += n * d * elt
            if (decode and not splits(cfg.n_kv_heads)
                    and splits(cache_len)):
                if splits(h):
                    got["kv_query"] += rows * h * cfg.d_head * elt
                got["kv_merge"] += rows * h * (cfg.d_head + 2) * f32
        if splits(cfg.d_ff):
            got["tp_sum"] += n * d * elt                    # the MLP
    return {k: v for k, v in got.items() if v}


def seq_split_bytes(cfg, m: int, rows: int, n: int, train: bool) -> dict:
    """The bytes a rank of a ``model`` axis of ``m`` > 1 receives, by
    ``collectives.BYTES`` reader, from the sequence split
    (``collectives.SeqSplit``, ``cfg.seq_parallel``) of a dense or MoE
    model in one pass of ``rows`` sequences of ``n`` positions a rank: a
    forward, and with ``train`` its backward (under ``cfg.remat`` each
    layer's forward collectives again but its last, the FFN's
    reduce-scatter: the recompute stops once it has remade the tensors the
    backward saved, and nothing after that reduce-scatter saves one).  A
    rank holds ``r = ceil(n / m)`` rows of a sequence; an all-gather
    counts its output (``rows m r d``), a reduce-scatter its rank's block
    (``rows r d``):

      * the embedding: a reduce-scatter where ``model`` splits the vocab
        (its backward an all-gather), else its rows (backward an
        all-gather), in the parameter dtype;
      * each attention, MLP and MoE layer: its input gathered (backward a
        reduce-scatter where ``model`` splits the layer, else nothing) and
        its output reduce-scattered (the MoE's in ``cfg.moe_psum_dtype``),
        or its rows taken where ``model`` does not split it (backward an
        all-gather each way), in the compute dtype;
      * the final norm's output gathered before the head;
      * ``sp_norms``: each norm weight's gradient summed (``d``, in the
        parameter dtype), in the backward."""
    size = lambda name: torch.empty((), dtype=getattr(torch, name)
                                    ).element_size()
    e, ep, d = size(cfg.compute_dtype), size(cfg.param_dtype), cfg.d_model
    r = -(-n // m)
    gather = lambda elt: rows * m * r * d * elt
    scatter = lambda elt: rows * r * d * elt
    splits = lambda k: k % m == 0
    fwd = {"sp_gather": 0, "sp_scatter": 0}
    bwd = {"sp_gather": 0, "sp_scatter": 0, "sp_norms": 0}

    def layer(split: bool, out_elt: int, add: dict, grads: dict,
              again: dict) -> None:
        for acc in (add, again):
            acc["sp_gather"] += gather(e)
        grads["sp_scatter"] += scatter(e) if split else 0
        add["sp_scatter"] += scatter(out_elt) if split else 0
        grads["sp_gather"] += gather(out_elt)

    if splits(cfg.vocab_padded):
        fwd["sp_scatter"] += scatter(ep)
    bwd["sp_gather"] += gather(ep)
    again = {"sp_gather": 0, "sp_scatter": 0}     # the recompute's
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0
    moe_split = splits(cfg.n_experts)       # else _moe_data_parallel
    for i in range(cfg.n_layers):
        attn = splits(cfg.n_heads)
        layer(attn, e, fwd, bwd, again)
        again["sp_scatter"] += scatter(e) if attn else 0
        if i < cfg.n_layers - n_moe:
            layer(splits(cfg.d_ff), e, fwd, bwd, again)
        else:
            layer(moe_split, size(cfg.moe_psum_dtype), fwd, bwd, again)
        bwd["sp_norms"] += 2 * d * ep
    fwd["sp_gather"] += gather(e)                   # before the head
    bwd["sp_scatter"] += (scatter(e) if splits(cfg.vocab_padded) else 0)
    bwd["sp_norms"] += d * ep
    out = dict(fwd)
    if train:
        for part in (bwd, again if cfg.remat else {}):
            for k, v in part.items():
                out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def serve_cache_shape(name: str, shape: Sequence[int], mesh) -> tuple:
    """The shape a rank holds over ``model`` of the cache tensor ``name``
    whose whole shape is ``shape`` (the rank's rows: the data axes'
    split is the caller's), by ``serve_cache_spec``; ``shape`` itself
    without a mesh."""
    if mesh is None:
        return tuple(shape)
    spec = tuple(e if e == "model" else None for e in
                 serve_cache_spec((name,), tuple(shape), mesh, 1))
    return local_shape(shape, spec, mesh)


class Coord:
    """One rank of a mesh without a process group: axis sizes and this
    rank's coordinate on each (what the rules and ``local_shard`` read of
    a ``DeviceMesh``), so one process can cut every rank's blocks."""

    def __init__(self, sizes: Dict[str, int], at: Dict[str, int]):
        self.mesh_dim_names = tuple(sizes)
        self.sizes, self.at = dict(sizes), dict(at)

    def size(self, i=None):
        return self.sizes[self.mesh_dim_names[i]]

    def get_local_rank(self, axis):
        return self.at[axis]


def model_rank(m: int, m_idx: int) -> Coord:
    """Rank ``m_idx`` of a ``(data 1, model m)`` mesh."""
    return Coord({"data": 1, "model": m}, {"data": 0, "model": m_idx})


def rank_blocks(mod, path: str, names, m: int, m_idx: int):
    """Model rank ``m_idx``'s blocks of ``mod``'s whole parameters
    ``names`` (each the leaf at ``path/name``) on a ``(data 1, model m)``
    mesh, by ``compute_spec``: what that rank's layer body computes with,
    in a namespace (a missing one is None)."""
    coord = model_rank(m, m_idx)
    out = {}
    for n in names:
        p = getattr(mod, n)
        out[n] = None if p is None else local_shard(
            p, compute_spec(f"{path}/{n}", tuple(p.shape), coord,
                            train=False), coord)
    return types.SimpleNamespace(**out)


def is_split(spec: Sequence, keep: Sequence = ()) -> bool:
    """Whether the spec splits any dim over an axis outside ``keep``."""
    return any(a not in keep for e in spec for a in spec_axes(e))
