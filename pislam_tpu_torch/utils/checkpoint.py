"""Checkpoint / resume for SLAM state, as torch state dicts.

The port of ``pislam_tpu/utils/checkpoint.py``, which saves a JAX pytree
with orbax. Here a state is nested NamedTuples and dicts whose leaves are
tensors, ``torch.Generator`` objects and Python ints (``SlamState``, or the
runner's ``{"state": ..., "steps_done": ...}``). ``save`` flattens it to a
dict of CPU tensors keyed by field path (``state.lmap.xyz``) and writes it
with ``torch.save`` to a temporary file in the target's directory, synced to
disk, then renamed over the target: the same atomic rename orbax does, so a
save that fails part-way leaves the previous checkpoint as it was.
``restore`` loads with ``weights_only=True`` (no pickled code runs) and puts
each tensor on the device of the matching leaf of ``like``.

Generators. A generator is stored as its state and its device type. A CPU
generator's state (mt19937, 5056 bytes) and a CUDA generator's (Philox seed
and offset) are not interchangeable, so a generator is restored exactly only
onto its own device type. Onto another type, ``restore`` raises unless it is
given ``strict_generator=False``; then the tables are restored and the
generator of ``like`` is kept as it is (a freshly seeded one, where ``like``
is a new state). Resuming a run uses the strict rule: its draws must continue
where the checkpoint left them. Loading a map to start from (the service's
``--map-in``) may reseed.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any

import torch

FORMAT = "pislam_tpu_torch.checkpoint/1"


def _join(prefix: str, name) -> str:
    return f"{prefix}.{name}" if prefix else str(name)


def _children(node):
    """The named children of a NamedTuple or a dict, else None."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return node._asdict().items()
    if isinstance(node, dict):
        return node.items()
    return None


def _flatten(node, prefix: str, out: dict):
    children = _children(node)
    if children is not None:
        for name, child in children:
            _flatten(child, _join(prefix, name), out)
    elif isinstance(node, torch.Tensor):
        out[prefix] = node.detach().to("cpu", copy=True)
    elif isinstance(node, torch.Generator):
        out[prefix] = {"generator": node.device.type, "state": node.get_state()}
    elif isinstance(node, int) and not isinstance(node, bool):
        out[prefix] = node
    else:
        raise TypeError(f"{prefix or 'state'}: cannot checkpoint a {type(node).__name__}")


def leaves(state: Any) -> dict:
    """The leaves of ``state`` by field path, as ``save`` stores them: CPU
    copies of the tensors, the ints, and each generator as
    ``{"generator": device type, "state": uint8 tensor}``."""
    out: dict = {}
    _flatten(state, "", out)
    return out


def save(path: str, state: Any):
    """Save ``state`` to the file ``path`` (overwrites, atomically)."""
    stored = leaves(state)
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=f".{os.path.basename(path)}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"format": FORMAT, "leaves": stored}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise


def _load(path: str) -> dict:
    blob = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    return blob["leaves"]


def _generator(name: str, stored: dict, like: torch.Generator, strict: bool):
    if stored["generator"] != like.device.type:
        if strict:
            raise ValueError(
                f"{name}: a {stored['generator']} generator cannot be restored onto "
                f"{like.device.type}: its draws would not continue "
                "(pass strict_generator=False to keep a fresh generator)")
        return like
    gen = torch.Generator(device=like.device)
    gen.set_state(stored["state"])
    return gen


def _rebuild(node, prefix: str, leaves: dict, strict: bool, used: set):
    children = _children(node)
    if children is not None:
        rebuilt = {name: _rebuild(child, _join(prefix, name), leaves, strict, used)
                   for name, child in children}
        return type(node)(**rebuilt) if isinstance(node, tuple) else rebuilt
    name = prefix or "state"
    if prefix not in leaves:
        raise ValueError(f"{name}: missing from the checkpoint")
    used.add(prefix)
    stored = leaves[prefix]
    if isinstance(node, torch.Tensor):
        if not isinstance(stored, torch.Tensor):
            raise ValueError(f"{name}: the checkpoint holds no tensor here")
        if stored.shape != node.shape or stored.dtype != node.dtype:
            raise ValueError(
                f"{name}: the checkpoint has {tuple(stored.shape)} {stored.dtype}, "
                f"expected {tuple(node.shape)} {node.dtype} (another config?)")
        return stored.to(node.device)
    if isinstance(node, torch.Generator):
        if not isinstance(stored, dict) or "generator" not in stored:
            raise ValueError(f"{name}: the checkpoint holds no generator here")
        return _generator(name, stored, node, strict)
    if isinstance(node, int) and not isinstance(node, bool):
        if not isinstance(stored, int) or isinstance(stored, bool):
            raise ValueError(f"{name}: the checkpoint holds no integer here")
        return stored
    raise TypeError(f"{name}: cannot restore into a {type(node).__name__}")


def restore(path: str, like: Any = None, strict_generator: bool = True) -> Any:
    """Restore a checkpoint written by ``save``.

    With ``like`` (a state of the same structure), returns that structure:
    each tensor on the device of ``like``'s tensor, after checking its shape
    and dtype (a mismatch raises ``ValueError`` naming the field, e.g. a
    checkpoint from another ``MapConfig``), each generator by the rule in
    the module docstring. Without ``like``, returns the stored leaves by
    field path, as ``leaves`` gives them.
    """
    stored = _load(path)
    if like is None:
        return stored
    used: set = set()
    out = _rebuild(like, "", stored, strict_generator, used)
    extra = sorted(set(stored) - used)
    if extra:
        raise ValueError(f"{path}: fields not in the target state: {', '.join(extra)}")
    return out
