"""Checkpoints in the JAX package's on-disk format, with atomic commits; the
port's own copy of ``repro.checkpoint.store``.

* A state (nested dicts, lists, tuples and named tuples of tensors, numpy
  arrays or numbers) is flattened to one array per leaf, keyed by its path
  as JAX spells it (``['params']['embed']``, ``[0]``, ``.wq``); ``None``
  leaves are empty subtrees, as in JAX.
* ``step_XXXXXXXX.tmp/`` receives ``host0.npz`` (bf16 stored as
  ``uint16`` views, flagged in the manifest) and ``manifest.json``, then is
  renamed to ``step_XXXXXXXX/``: a torn write is never taken for a complete
  checkpoint.  A ``latest`` pointer and ``keep_last`` garbage collection
  follow.
* The archive is the one ``numpy.savez`` writes (stored ``.npy``
  members).  Each array is written in one piece, and read in one piece
  straight into its buffer with its CRC checked, while a second thread
  moves the next array between the card and the host (or reads it):
  saving or restoring holds two leaves in host memory, not the state.

Either package restores the other's checkpoints of the same structure.

Over a training mesh (``mesh`` and ``specs``, ``{path: spec}`` as
:func:`repro_torch.train.step.state_specs` gives them) the format stays
the JAX package's, global arrays in ``host0.npz``: saving gathers one
leaf at a time over the mesh (every rank calls it) and rank 0 writes it;
restoring reads each global leaf and cuts this rank's shard, on any mesh,
also one other than the mesh that saved it (an elastic reshard).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..parallel.collectives import all_reduce
from ..parallel.mesh import local_shape, shard, unshard


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(type(t), "_fields")


def _paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in JAX's flattening order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for name in tree._fields
                for kv in _paths(getattr(tree, name), f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves,
                                     f"{prefix}.{n}") for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves, f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return leaves[prefix]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host array to store and its dtype's name (bf16 as a ``uint16``
    view)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 arrays
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _prefetched(fn, items):
    """``fn(item)`` for each item in order, the next one computed in a
    second thread while the caller works on the current one."""
    if not items:
        return
    with ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(fn, items[0])
        for i in range(len(items)):
            out = nxt.result()
            if i + 1 < len(items):
                nxt = pool.submit(fn, items[i + 1])
            yield out


def _write_npy(f, arr: np.ndarray) -> None:
    """``arr`` as a ``.npy`` stream (``numpy.save``'s version 1.0 header),
    its bytes in one write."""
    np.lib.format.write_array_header_1_0(
        f, np.lib.format.header_data_from_array_1_0(arr))
    f.write(memoryview(arr.reshape(-1)).cast("B"))


def _read_member(path: Path, info: zipfile.ZipInfo) -> np.ndarray:
    """A stored ``.npy`` member (version 1.0 or 2.0 header) read in one
    piece straight into its array, its CRC checked."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{info.filename}: compressed members are not read")
    with open(path, "rb") as fh:
        fh.seek(info.header_offset)
        head = fh.read(30)                    # the local file header
        if head[:4] != b"PK\x03\x04":
            raise ValueError(f"{info.filename}: bad local header")
        start = info.header_offset + 30 + sum(struct.unpack("<HH",
                                                            head[26:30]))
        fh.seek(start)
        version = np.lib.format.read_magic(fh)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0
                       }.get(version)
        if read_header is None:
            raise ValueError(f"{info.filename}: .npy version {version}")
        shape, fortran, dtype = read_header(fh)
        n_head = fh.tell() - start
        arr = np.empty(shape, dtype, order="F" if fortran else "C")
        data = memoryview(arr.reshape(-1, order="A")).cast("B")
        if fh.readinto(data) != len(data) \
                or n_head + len(data) != info.file_size:
            raise ValueError(f"{info.filename}: truncated")
        fh.seek(start)
        if zlib.crc32(data, zlib.crc32(fh.read(n_head))) != info.CRC:
            raise ValueError(f"{info.filename}: CRC mismatch")
    return arr


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` has come here (a sum over each axis's
    group in turn)."""
    token = torch.zeros((), device=mesh.device)
    for axis in mesh.axis_names:
        if mesh.shape[axis] > 1:
            all_reduce(token, mesh.group(axis))


def save_checkpoint(ckpt_dir: str | Path, step: int, tree,
                    keep_last: int = 3, host_id: int = 0, mesh=None,
                    specs: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``; returns its
    directory.  Over ``mesh`` the leaves are shards laid out by ``specs``
    (path -> spec; a missing path is replicated): every rank calls this,
    each leaf is gathered whole and rank 0 writes it; the call returns on
    every rank once the checkpoint is committed."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    paths = _paths(tree)
    host = lambda kv: _to_numpy(kv[1])                      # noqa: E731
    if mesh is not None:
        def whole(kv):
            key, leaf = kv
            if not torch.is_tensor(leaf):
                return leaf
            return unshard(leaf, (specs or {}).get(key), mesh)
        if mesh.rank != 0:
            for kv in paths:                   # rank 0's gathers, in order
                whole(kv)
            _barrier(mesh)
            return final
        host = lambda kv: _to_numpy(whole(kv))              # noqa: E731
    tmp.mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "time": time.time(), "arrays": {}}
    with zipfile.ZipFile(tmp / f"host{host_id}.npz", "w",
                         zipfile.ZIP_STORED, allowZip64=True) as zf:
        for (key, _), (arr, dtype) in zip(paths, _prefetched(host, paths)):
            blob = key.replace("/", "_")
            manifest["arrays"][key] = {"shape": list(arr.shape),
                                       "dtype": dtype, "blob": blob,
                                       "bf16": dtype == "bfloat16"}
            with zf.open(blob + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, np.ascontiguousarray(arr))
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    (ckpt_dir / "latest").write_text(str(step))

    # GC
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    if mesh is not None:
        _barrier(mesh)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The step of the newest complete checkpoint, or ``None``."""
    p = Path(ckpt_dir) / "latest"
    if not p.exists():
        return None
    step = int(p.read_text().strip())
    if not (Path(ckpt_dir) / f"step_{step:08d}").exists():
        # fall back to scanning (the pointer may be ahead of a GC'd dir)
        steps = sorted(int(q.name.split("_")[1])
                       for q in Path(ckpt_dir).glob("step_*")
                       if not q.name.endswith(".tmp"))
        return steps[-1] if steps else None
    return step


def restore_checkpoint(ckpt_dir: str | Path, step: int, like,
                       device=None, mesh=None,
                       specs: Optional[Dict[str, Any]] = None):
    """Checkpoint ``step`` in the structure of ``like`` (whose leaves may be
    tensors, arrays or anything else: only the structure is read), as new
    tensors on ``device`` (``None``: the CUDA card), each of the stored
    dtype and shape.  Over ``mesh`` each leaf is this rank's shard of the
    stored array as ``specs`` lays it out (``like``'s leaves are shards
    too).  Raises ``KeyError`` for a leaf the checkpoint lacks and
    ``ValueError`` where a stored shape differs from ``like``'s."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    paths = _paths(like)
    specs = specs or {}
    infos = []
    for key, like_leaf in paths:
        info = manifest["arrays"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing {key}")
        stored = tuple(info["shape"])
        if mesh is not None:
            stored = local_shape(stored, specs.get(key), mesh)
        want = tuple(getattr(like_leaf, "shape", stored))
        if stored != want:
            raise ValueError(f"{key}: stored {tuple(info['shape'])}, like "
                             f"{want}")
        infos.append(info)
    members = {}
    for path in sorted(d.glob("host*.npz")):
        with zipfile.ZipFile(path) as zf:
            members.update((i.filename, (path, i)) for i in zf.infolist())

    def read(info):
        return _read_member(*members[info["blob"] + ".npy"]).reshape(
            info["shape"])

    leaves = {}
    for (key, _), info, arr in zip(paths, infos, _prefetched(read, infos)):
        t = torch.from_numpy(arr.view(np.int16) if info.get("bf16") else arr)
        if info.get("bf16"):
            t = t.view(torch.bfloat16)
        if mesh is not None:
            t = shard(t, specs.get(key), mesh).contiguous()
        leaves[key] = t.to(dev)
    return _rebuild(like, leaves)
