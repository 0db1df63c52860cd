"""Checkpoint/resume for host arrays and nested containers of tensors.

A copy of the reference's ``utils/checkpoint.py``, over torch in place of
jax.  Two surfaces:

- :func:`save_arrays` / :func:`load_arrays` — ClArray/numpy dict → one
  ``.npz`` (the compute-framework tier: user arrays are the state), as
  the reference has them.
- :func:`save_pytree` / :func:`load_pytree` — a nested ``dict`` /
  ``OrderedDict`` / ``list`` / ``tuple`` of tensors, numpy arrays and
  Python scalars (a model's ``state_dict()``, an optimizer's
  ``state_dict()``), one ``.npy`` per leaf plus a json manifest.  Leaves
  are flattened in ``jax.tree_util``'s order — a ``dict``'s keys sorted,
  an ``OrderedDict``'s in insertion order, ``None`` an empty node and not
  a leaf — so a directory written by either package loads in the other
  with the same leaf numbering.

A bfloat16 leaf is written as the reference writes one (``np.save`` of an
ml_dtypes array): its raw two-byte words under the descriptor ``'<V2'``.
``np.load`` gives such a file back as a ``V2`` array (in the reference
too, which then loses the dtype); :func:`load_pytree` reinterprets the
words as ``torch.bfloat16`` where ``like``'s leaf is a bfloat16 tensor.
Neither direction needs jax or ml_dtypes.

Writes are atomic: a temp directory renamed into place, so a killed run
never leaves a half checkpoint.  The NEWEST step can still be torn (disk
faults, manual copies), so :func:`load_arrays` / :func:`load_pytree` with
``step=None`` fall back to the previous COMPLETE step when the newest
fails to parse, recording a ``checkpoint-fallback`` flight event; an
EXPLICIT step still raises (the caller pinned exactness), and so does a
complete directory whose leaf count, or a tensor leaf's dtype, disagrees
with ``like`` (the reference casts nothing either: it returns the stored
array).  Stale ``.ckpt_tmp_*`` dirs abandoned by a crashed writer are
swept on the next save (age-gated so a concurrent writer's live tmp
survives).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np

__all__ = [
    "save_arrays",
    "load_arrays",
    "save_pytree",
    "load_pytree",
    "latest_step",
]

#: A ``.ckpt_tmp_*`` dir older than this at save time belongs to a
#: crashed writer and is swept (a live concurrent writer's tmp is
#: seconds old; single-writer-per-root is the supported pattern).
TMP_SWEEP_AGE_S = 60.0

#: The ``.npy`` descriptor of a bfloat16 leaf (what ``np.save`` writes for
#: an ml_dtypes bfloat16 array).
BF16_DESCR = "<V2"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:012d}")


def _steps_desc(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    return sorted((
        int(name[5:]) for name in os.listdir(root)
        if name.startswith("step_") and name[5:].isdigit()
    ), reverse=True)


def latest_step(root: str) -> int | None:
    """Highest checkpoint step under ``root`` (None if empty)."""
    steps = _steps_desc(root)
    return steps[0] if steps else None


def _note_fallback(root: str, bad_step: int, exc: BaseException,
                   to_step: int | None) -> None:
    from ..obs.flight import FLIGHT

    FLIGHT.event(
        "checkpoint-fallback", root=root, bad_step=bad_step,
        fell_back_to=to_step,
        error=f"{type(exc).__name__}: {exc}"[:200])


def _sweep_stale_tmps(root: str) -> int:
    """Remove crashed writers' abandoned tmp dirs (age-gated).
    Returns how many were swept; never raises."""
    swept = 0
    try:
        now = time.time()
        for name in os.listdir(root):
            if not name.startswith(".ckpt_tmp_"):
                continue
            path = os.path.join(root, name)
            try:
                if now - os.path.getmtime(path) > TMP_SWEEP_AGE_S:
                    shutil.rmtree(path, ignore_errors=True)
                    swept += 1
            except OSError:
                continue
        if swept:
            from ..obs.flight import FLIGHT

            FLIGHT.event("checkpoint-sweep", root=root, swept=swept)
    except Exception:  # noqa: BLE001 - sweeping is best-effort hygiene
        pass
    return swept


def _atomic_write(root: str, step: int, write_fn: Callable[[str], None]) -> str:
    os.makedirs(root, exist_ok=True)
    _sweep_stale_tmps(root)
    final = _step_dir(root, step)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=root)
    try:
        write_fn(tmp)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


# -- array-dict surface ------------------------------------------------------

def save_arrays(root: str, step: int, arrays: Mapping[str, Any]) -> str:
    """Checkpoint named host arrays (ClArray or numpy) at ``step``."""
    host = {}
    for name, arr in arrays.items():
        host[name] = np.asarray(arr.host() if hasattr(arr, "host") else arr)

    def write(tmp: str) -> None:
        np.savez(os.path.join(tmp, "arrays.npz"), **host)

    return _atomic_write(root, step, write)


def _load_arrays_step(root: str, step: int) -> dict[str, np.ndarray]:
    with np.load(os.path.join(_step_dir(root, step), "arrays.npz")) as z:
        return {k: z[k].copy() for k in z.files}


def load_arrays(root: str, step: int | None = None) -> dict[str, np.ndarray]:
    """Load the arrays of ``step`` (default: latest COMPLETE step — a
    torn/corrupt newest falls back to the previous one with a
    ``checkpoint-fallback`` flight event; an explicit ``step`` raises
    on corruption, the caller pinned exactness)."""
    if step is not None:
        return _load_arrays_step(root, step)
    steps = _steps_desc(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    last_exc: BaseException | None = None
    for i, s in enumerate(steps):
        try:
            return _load_arrays_step(root, s)
        except Exception as e:  # noqa: BLE001 - torn newest, try previous
            _note_fallback(root, s, e,
                           steps[i + 1] if i + 1 < len(steps) else None)
            last_exc = e
    raise last_exc


# -- pytree surface ----------------------------------------------------------

def _flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)`` in ``jax.tree_util``'s order.  The treedef is
    a nested tuple :func:`_unflatten` rebuilds from."""
    leaves: list = []

    def walk(x):
        if x is None:
            return ("none",)
        if type(x) is OrderedDict:
            keys = list(x.keys())
            return ("map", type(x), keys, [walk(x[k]) for k in keys])
        if isinstance(x, Mapping):
            keys = sorted(x.keys())
            return ("map", type(x), keys, [walk(x[k]) for k in keys])
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("namedtuple", type(x), None, [walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return ("seq", type(x), None, [walk(v) for v in x])
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def _unflatten(treedef, leaves: list) -> Any:
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        _, typ, keys, children = node
        vals = [build(c) for c in children]
        if kind == "map":
            out = OrderedDict(zip(keys, vals)) if typ is OrderedDict else dict(zip(keys, vals))
            return out if typ in (dict, OrderedDict) else typ(out)
        if kind == "namedtuple":
            return typ(*vals)
        return typ(vals)

    return build(treedef)


def _treedef_str(node) -> str:
    """A readable rendering of the structure for the manifest (the
    reference stores ``str(treedef)`` there and never reads it back)."""
    kind = node[0]
    if kind == "none":
        return "None"
    if kind == "leaf":
        return "*"
    _, typ, keys, children = node
    inner = [_treedef_str(c) for c in children]
    if kind == "map":
        return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(keys, inner)) + "}"
    if kind == "namedtuple":
        return f"{typ.__name__}(" + ", ".join(inner) + ")"
    if typ is list:
        return "[" + ", ".join(inner) + "]"
    return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"


def _save_leaf(path: str, leaf: Any) -> None:
    """One leaf as a ``.npy``: a tensor from the host, a bfloat16 one as
    its raw words under :data:`BF16_DESCR`."""
    if hasattr(leaf, "detach") and hasattr(leaf, "dtype"):
        import torch

        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": tuple(words.shape)})
                f.write(words.tobytes())
            return
        np.save(path, t.numpy())
        return
    np.save(path, np.asarray(leaf))


class _LeafMismatch(ValueError):
    """A COMPLETE dir disagreeing with ``like`` (its leaf count, a leaf's
    dtype) — a caller error the fallback must NOT absorb
    (json.JSONDecodeError is also a ValueError, so the sentinel keeps
    torn manifests fallable)."""


def _restore_leaf(x: np.ndarray, like_leaf: Any) -> Any:
    """A loaded array as ``like``'s leaf would have it: a tensor on the
    like leaf's device (a ``V2`` file reinterpreted as bfloat16 words), a
    Python scalar as that scalar's type, else the array as loaded.  A
    tensor leaf whose file holds another dtype raises: a resume that
    casts its state is not the run it resumes."""
    if hasattr(like_leaf, "detach") and hasattr(like_leaf, "dtype"):
        import torch

        x = x if x.flags.c_contiguous else x.copy()
        if x.dtype.kind == "V" and x.dtype.itemsize == 2:
            t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(x)
        if t.dtype != like_leaf.dtype:
            raise _LeafMismatch(f"a {t.dtype} leaf cannot load into {like_leaf.dtype}")
        return t.to(device=like_leaf.device)
    if isinstance(like_leaf, (bool, int, float, complex, str)):
        return type(like_leaf)(x.item())
    return x


def save_pytree(root: str, step: int, tree: Any) -> str:
    """Checkpoint a nested container of tensors / numpy arrays / Python
    scalars (params, optimizer state)."""
    leaves, treedef = _flatten(tree)

    def write(tmp: str) -> None:
        manifest = {"treedef": _treedef_str(treedef), "n_leaves": len(leaves), "step": step}
        for i, leaf in enumerate(leaves):
            _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            from .jsonsafe import json_safe

            # step may arrive as a numpy scalar from a training loop;
            # the manifest must stay loadable by strict parsers
            json.dump(json_safe(manifest), f, allow_nan=False)

    return _atomic_write(root, step, write)


def load_pytree(root: str, like: Any, step: int | None = None) -> Any:
    """Restore a tree saved by :func:`save_pytree` (or by the reference's).

    ``like`` supplies the structure (e.g. a fresh model's ``state_dict()``)
    and each tensor leaf's device and dtype, which the file's must equal.
    The reference's ``sharding_fn`` hook is not kept: ``like`` is the one
    placement rule until a caller over several devices needs another.
    """
    like_leaves, treedef = _flatten(like)

    def load_step(d: str):
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["n_leaves"] != len(like_leaves):
            raise _LeafMismatch(
                f"checkpoint has {manifest['n_leaves']} leaves, 'like' tree has {len(like_leaves)}"
            )
        loaded = []
        for i, like_leaf in enumerate(like_leaves):
            x = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            loaded.append(_restore_leaf(x, like_leaf))
        return _unflatten(treedef, loaded)

    if step is not None:
        return load_step(_step_dir(root, step))
    steps = _steps_desc(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    last_exc: BaseException | None = None
    for i, s in enumerate(steps):
        try:
            return load_step(_step_dir(root, s))
        except _LeafMismatch:
            # a complete dir whose leaves disagree with `like` is a
            # CALLER error (wrong tree), not a torn checkpoint — an
            # older step would silently load the wrong model
            raise
        except Exception as e:  # noqa: BLE001 - torn newest, try previous
            _note_fallback(root, s, e,
                           steps[i + 1] if i + 1 < len(steps) else None)
            last_exc = e
    raise last_exc
