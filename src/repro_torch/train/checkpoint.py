"""Atomic, manifest-based checkpoints (port of
``repro/train/checkpoint.py``) in the reference's layout:

    <dir>/step_<N:08d>/
        manifest.json      {step, format, leaves: {path: {shape, dtype, name}}}
        shard_<host>.npz   every leaf (one host)

A state is a tree of dicts whose leaves are tensors, or lists of tensors
that the reference stacks over layers (``models.io.reference_groups``);
leaves are keyed by their ``/``-joined paths, stacked leaves stored
stacked, so a float32 checkpoint written by the reference restores here
and one written here loads there.  A bfloat16 leaf is stored as its 16-bit
words with ``"bfloat16"`` in the manifest (numpy has no bfloat16, and the
port needs no ``ml_dtypes``).  Writes go to a temp directory, are fsynced
and renamed into place, so a preempted save never corrupts the latest
checkpoint; ``keep_last`` prunes older steps.  ``restore`` copies into the
tensors of a like-shaped tree, in place.

A sharded state (``mesh=`` and ``specs=``: each leaf's spec by its path)
holds each rank's blocks: ``save`` gathers every leaf whole to every rank
(a collective, in path order) and rank 0 writes ``shard_0.npz``, as the
reference's single-host save does; ``restore`` gives each rank its block
of the whole arrays by the target mesh's specs, so a checkpoint saved on
one mesh restores on another (the reference's elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives, sharding

BF16 = "bfloat16"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _to_numpy(leaf) -> np.ndarray:
    x = (leaf if isinstance(leaf, torch.Tensor)
         else torch.stack([t.detach() for t in leaf]))
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _whole(leaf, spec, mesh):
    """A leaf (a tensor or a stack's list) whole from this rank's blocks."""
    if spec is None:
        return leaf
    if isinstance(leaf, torch.Tensor):
        return collectives.gather_spec(leaf, spec, mesh)
    return [collectives.gather_spec(x, spec[1:], mesh) for x in leaf]


def save(ckpt_dir: str, step: int, state: dict, *, keep_last: int = 3,
         host_id: int = 0, mesh=None, specs: Optional[dict] = None) -> str:
    """Atomic checkpoint write. Returns the checkpoint path.  With ``mesh``
    every rank calls it; rank 0 writes (module docstring)."""
    flat = _flatten(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if mesh is not None:
        flat = {k: _whole(flat[k], specs.get(k), mesh) for k in sorted(flat)}
        if dist.get_rank() != 0:
            collectives.mesh_barrier(mesh)
            return final
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    manifest = {"step": step, "leaves": {}, "format": 1}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        name = f"a{i}"
        arr = _to_numpy(leaf)
        bf16 = (leaf if isinstance(leaf, torch.Tensor)
                else leaf[0]).dtype == torch.bfloat16
        arrays[name] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": BF16 if bf16 else str(arr.dtype),
                                   "name": name}
    with open(os.path.join(tmp, f"shard_{host_id}.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    if mesh is not None:
        collectives.mesh_barrier(mesh)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


@torch.no_grad()
def restore(ckpt_dir: str, like: dict, *, step: Optional[int] = None,
            host_id: int = 0, mesh=None, specs: Optional[dict] = None
            ) -> dict:
    """Copy the checkpoint at ``step`` (the latest by default) into the
    tensors of ``like``, a tree of the saved structure, in place, and
    return it; with ``mesh`` this rank's block of each leaf by ``specs``.
    Raises ``FileNotFoundError`` without a checkpoint, ``ValueError`` for
    a corrupt one or a leaf missing or misshapen."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, f"shard_{host_id}.npz"))
    except FileNotFoundError:
        raise
    except Exception as e:  # truncated json / corrupt npz / bad zip
        raise ValueError(
            f"corrupt or truncated checkpoint {path!r}: {e} — writes are "
            "atomic (temp dir + rename), so this usually means a partial "
            "copy or disk fault; delete the step directory and restore an "
            "earlier step") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise ValueError(
            f"corrupt checkpoint manifest {path!r}: missing 'leaves' table")
    for key, leaf in _flatten(like).items():
        if key not in manifest["leaves"]:
            raise ValueError(f"checkpoint {path!r} has no leaf {key!r}")
        meta = manifest["leaves"][key]
        src = _from_numpy(data[meta["name"]], meta["dtype"])
        spec = None if mesh is None else specs.get(key)
        if spec is not None:
            src = sharding.local_shard(src, spec, mesh)
        members = [leaf] if isinstance(leaf, torch.Tensor) else list(leaf)
        want = (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
                else (len(members),) + tuple(members[0].shape))
        if tuple(src.shape) != want:
            raise ValueError(f"leaf {key!r}: checkpoint shape "
                             f"{tuple(src.shape)}, expected {want}")
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(src)
        else:
            for i, t in enumerate(members):
                t.copy_(src[i])
    return like
