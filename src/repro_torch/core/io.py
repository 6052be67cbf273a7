"""Flat npz (de)serialization of parameter trees, and the bridge that turns
the reference's SAC parameter tree into the port's modules (port of
``repro/core/io.py``).

The npz format is the reference's: nested dict keys joined by ``/``, list
items as ``#<i>``.  A router checkpoint written by ``repro.core.io.
save_pytree`` therefore loads here with ``load_pytree`` and becomes a
``core.sac.SAC`` through ``sac_params_from_numpy``; ``sac_params_to_numpy``
turns a ``SAC`` back into the reference's tree, so a router the port
trains loads in the reference.  ``adamw_from_numpy``/``adamw_to_numpy``
carry the AdamW moments (``{"m": tree, "v": tree}`` over the trainable
parameters, the reference's optimizer state) across the same way, and
``predictor_params_from_numpy`` the request predictor's weights.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.core import features
from repro_torch.core.sac import SAC, SACConfig
from repro_torch.device import resolve


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_pytree(path: str, tree) -> None:
    """Crash-safe save: write a temp file beside ``path``, fsync, then
    rename it over ``path`` atomically."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_pytree(path: str):
    """The nested dict/list tree of numpy arrays stored at ``path``."""
    try:
        with np.load(path) as z:
            data = dict(z)
    except FileNotFoundError:
        raise
    except (OSError, ValueError) as e:
        raise ValueError(f"corrupt or truncated checkpoint {path!r}: {e}") \
            from e
    root: dict = {}
    for key, val in data.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def router_ckpt_compatible(params) -> bool:
    """True when a saved router's HAN expects the current obs feature
    counts (a stale checkpoint would otherwise fail mid-eval)."""
    if not isinstance(params, dict) or "han" not in params:
        return True
    han = params["han"]
    return (np.shape(han["proj_expert"])[0] == features.EXP_FEATS
            and np.shape(han["proj_req"])[0] == features.REQ_FEATS)


def _state_dict_of(tree, prefix=""):
    """Reference tree -> ``state_dict`` keys: dict keys and list indices
    joined by ``.`` (an MLP's list of layers lives under ``layers``)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_state_dict_of(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_state_dict_of(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = torch.tensor(np.asarray(tree, np.float32))
    return out


_MLP_KEYS = ("actor", "q1", "q2", "q1_target", "q2_target")


def sac_params_from_numpy(tree: dict, cfg: SACConfig, device=None) -> SAC:
    """The reference's SAC parameter tree (numpy arrays, e.g. from
    ``load_pytree`` or ``jax.tree.map(np.asarray, params)``) -> ``SAC`` on
    ``device`` (the CUDA device by default).  Weights keep their (in, out)
    orientation; only names change."""
    device = resolve(device)
    tree = dict(tree)
    for k in _MLP_KEYS:
        tree[k] = {"layers": tree[k]}
    sac = SAC(cfg, torch.Generator().manual_seed(0))
    sd = _state_dict_of(tree)
    sac.load_state_dict(sd, strict=True)
    return sac.to(device)


def predictor_params_from_numpy(tree: dict, cfg, n_experts: int,
                                device=None):
    """The reference's predictor parameter tree (``core/predictors.py
    init_params``, leaves numpy arrays) -> the port's ``Predictor`` on
    ``device`` (the CUDA device by default)."""
    from repro_torch.core.predictors import Predictor

    model = Predictor(cfg, n_experts, resolve(device))
    with torch.no_grad():
        model.load_state_dict(_state_dict_of(tree), strict=True)
    return model


def _tree_of_state_dict(sd: dict) -> dict:
    """``state_dict`` names -> the reference's nested tree (numeric parts
    become list indices; an MLP's ``layers`` level is dropped)."""
    root: dict = {}
    for name, val in sd.items():
        parts = name.split(".")
        if parts[0] in _MLP_KEYS:
            parts = [parts[0]] + parts[2:]
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val.detach().cpu().numpy()

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def sac_params_to_numpy(sac: SAC) -> dict:
    """A ``SAC`` -> the reference's parameter tree of numpy arrays (the
    inverse of ``sac_params_from_numpy``): ``repro.core.io.save_pytree``
    of it, or this module's, is a checkpoint the reference loads."""
    return _tree_of_state_dict(sac.state_dict())


def adamw_to_numpy(opt) -> dict:
    """An ``AdamW``'s moments as the reference's ``{"m", "v"}`` trees over
    the trainable parameters."""
    return {"m": _tree_of_state_dict(opt.m), "v": _tree_of_state_dict(opt.v)}


def adamw_from_numpy(opt, tree: dict) -> None:
    """Load the reference's AdamW state ``{"m": tree, "v": tree}`` into
    ``opt``'s moments, in place (names checked both ways)."""
    for side in ("m", "v"):
        t = dict(tree[side])
        for k in _MLP_KEYS:
            if k in t:
                t[k] = {"layers": t[k]}
        sd = _state_dict_of(t)
        dst = getattr(opt, side)
        if set(sd) != set(dst):
            raise ValueError(f"AdamW {side}: names differ: "
                             f"{sorted(set(sd) ^ set(dst))}")
        for k, v in sd.items():
            dst[k].copy_(v.reshape(dst[k].shape))
