"""Async, fault-tolerant pytree checkpoints in the JAX package's format.

Counterpart of ``repro.checkpoint.manager``, writing and reading its
``repro-ckpt-v1`` layout leaf for leaf, so either package restores what
the other saved:

* ``data.bin``, every leaf's raw bytes back to back, and
  ``manifest.msgpack`` (tree string, per-leaf shape, dtype, offset, byte
  counts, crc32, ``compressed``, and the saver's ``extra`` metadata),
  plus ``structure.json`` for people.  Leaves go in the order of JAX's
  flatten: dict keys sorted at every level (the port's trees keep
  insertion order), NamedTuple fields in order, None an empty subtree.
  The port's Python-int ``OptState.step`` / ``n_updates`` are stored as
  int32 () arrays, as the JAX package's are.
* bf16 without ``ml_dtypes``: the dtype name ``bfloat16`` and the raw
  bytes through an int16 view, read back the same way (never through
  fp32).
* The port writes leaves uncompressed (``compressed: false``); it reads
  a zstd leaf through ``zstandard`` only when that leaf says so, and
  raises the JAX package's ``IOError`` when the package is missing.
* Atomic: written into ``<dir>.tmp``, then ``os.replace``; a tag file
  (``KNOWN_GOOD``) goes into the tmp dir first, atomic with the data.
* Async: ``save`` snapshots every device tensor to host on the calling
  thread, then a worker thread writes it; one save outstanding at a
  time, transient ``OSError`` retried with backoff, the last failure
  raised on the next ``wait``.  Restores verify the crc32 and length of
  every leaf, fall back past damaged steps, and place each leaf on the
  device of the matching leaf of ``like``.

The manifest is read and written by ``msgpack_codec``: the port needs no
``msgpack``, ``ml_dtypes`` or ``zstandard`` to save and restore.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_codec

FORMAT = "repro-ckpt-v1"

# manifest dtype name -> (numpy storage dtype, torch dtype); bf16 is stored
# through int16, whose bytes it shares
_DTYPES = {
    "float64": (np.float64, torch.float64),
    "float32": (np.float32, torch.float32),
    "float16": (np.float16, torch.float16),
    "bfloat16": (np.int16, torch.bfloat16),
    "int64": (np.int64, torch.int64),
    "int32": (np.int32, torch.int32),
    "int16": (np.int16, torch.int16),
    "int8": (np.int8, torch.int8),
    "uint8": (np.uint8, torch.uint8),
    "bool": (np.bool_, torch.bool),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


# ---------------------------------------------------------------------------
# JAX's flatten order
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """``like``'s structure (dicts in ``like``'s own key order) holding
    ``leaves``, given in :func:`tree_flatten`'s order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}
            return {k: built[k] for k in x}
        if _is_namedtuple(x):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_str(tree) -> str:
    """A readable structure string for the manifest (``*`` per leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={tree_str(v)}"
                            for f, v in zip(tree._fields, tree)) + ")")
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(tree_str(v) for v in tree) + "]"
    return "*"


# ---------------------------------------------------------------------------
# Host snapshot and leaf bytes
# ---------------------------------------------------------------------------


class HostSnapshot(NamedTuple):
    """A tree's leaves copied to host: (dtype name, C-contiguous array
    holding the leaf's bytes) in flatten order, and the tree string."""

    treedef: str
    leaves: list


def _host_leaf(x) -> tuple[str, np.ndarray]:
    """A leaf's dtype name and host bytes: a tensor, or a Python int
    (``OptState.step``, ``n_updates``: int32 () as the JAX package's)."""
    if isinstance(x, int) and not isinstance(x, bool):
        return "int32", np.asarray(x, np.int32)
    if not isinstance(x, torch.Tensor) or x.dtype not in _NAMES:
        raise TypeError(f"cannot checkpoint {type(x).__name__} "
                        f"{getattr(x, 'dtype', '')}")
    t = x.detach().contiguous().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return _NAMES[x.dtype], t.numpy()


def snapshot(tree) -> HostSnapshot:
    """Copy every leaf of ``tree`` to host now (a device tensor through
    one device-to-host copy); the copies do not change when the tree's
    tensors are updated in place afterwards."""
    if isinstance(tree, HostSnapshot):
        return tree
    return HostSnapshot(tree_str(tree),
                        [_host_leaf(x) for x in tree_flatten(tree)])


def snapshot_bytes(snap: HostSnapshot) -> int:
    return sum(a.nbytes for _, a in snap.leaves)


def load_manifest(path: str | os.PathLike) -> dict:
    """The checkpoint's manifest (tree, per-leaf shapes / dtypes / offsets
    / crcs, and the saver's ``extra`` metadata)."""
    return msgpack_codec.unpackb(
        (Path(path) / "manifest.msgpack").read_bytes())


def save_pytree(path: str | os.PathLike, tree: Any,
                extra_meta: dict | None = None,
                marker: str | None = None) -> None:
    """Synchronous atomic write of one tree (or a :func:`snapshot` of
    one).  ``marker`` names an empty tag file written into the tmp dir
    before the ``os.replace``, atomic with the checkpoint."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    snap = snapshot(tree)
    manifest = {"treedef": snap.treedef, "n_leaves": len(snap.leaves),
                "leaves": [], "extra": extra_meta or {}, "format": FORMAT}
    offset = 0
    with open(tmp / "data.bin", "wb") as f:
        for name, arr in snap.leaves:
            buf = memoryview(arr.reshape(-1).view(np.uint8))
            f.write(buf)
            manifest["leaves"].append({
                "shape": list(arr.shape), "dtype": name, "offset": offset,
                "nbytes": arr.nbytes, "raw_nbytes": arr.nbytes,
                "crc32": zlib.crc32(buf), "compressed": False})
            offset += arr.nbytes
    (tmp / "manifest.msgpack").write_bytes(msgpack_codec.packb(manifest))
    (tmp / "structure.json").write_text(json.dumps(
        {"treedef": snap.treedef, "extra": extra_meta or {}}, indent=2))
    if marker:
        (tmp / marker).touch()
    if path.exists():
        _rmtree(path)
    os.replace(tmp, path)


def _decompressor(path: Path):
    try:
        import zstandard
    except ImportError:
        raise IOError(
            f"{path} was written zstd-compressed but zstandard is not "
            "installed in this environment — cannot decompress") from None
    return zstandard.ZstdDecompressor()


def _read_leaf(f, meta: dict, path: Path, i: int, dctx):
    """One leaf's verified bytes as a host tensor of the stored dtype."""
    name = meta["dtype"]
    if name not in _DTYPES:
        raise IOError(f"{path} leaf {i}: dtype {name!r} is not supported")
    f.seek(meta["offset"])
    raw = bytearray(meta["nbytes"])
    got = f.readinto(raw)
    if got < meta["nbytes"]:
        raise IOError(f"truncated data.bin in {path}: leaf {i} needs "
                      f"{meta['nbytes']} B, got {got}")
    if meta["compressed"]:
        if dctx[0] is None:
            dctx[0] = _decompressor(path)
        raw = bytearray(dctx[0].decompress(
            bytes(raw), max_output_size=meta["raw_nbytes"]))
    if zlib.crc32(raw) != meta["crc32"]:
        raise IOError(f"checksum mismatch in {path} leaf {i} — corrupt "
                      "checkpoint")
    store, dtype = _DTYPES[name]
    arr = np.frombuffer(raw, dtype=store).reshape(meta["shape"])
    t = torch.from_numpy(arr)
    return t.view(dtype) if dtype == torch.bfloat16 else t


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _place(t: torch.Tensor, ref, host: bool):
    """A loaded host tensor as ``ref``'s kind: a Python int for an int,
    else a tensor on ``ref``'s device (kept on the host when ``host``)."""
    if isinstance(ref, int):
        return int(t.item())
    return t if host else t.to(ref.device)


def load_pytree(path: str | os.PathLike, like: Any, *,
                strict_shapes: bool = True, host: bool = False) -> Any:
    """Restore into the structure of ``like``, each leaf on the device of
    ``like``'s matching leaf, in its stored dtype, bit for bit.

    ``strict_shapes=False`` skips the per-leaf shape check (the leaf
    count still applies): the elastic restore loads state whose rank
    differs and reconciles it in the transpose pass.  ``host=True``
    leaves every tensor on the CPU."""
    path = Path(path)
    manifest = load_manifest(path)
    leaves_like = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves_like)} — structure mismatch")
    out = []
    dctx = [None]
    with open(path / "data.bin", "rb") as f:
        for i, (meta, ref) in enumerate(zip(manifest["leaves"],
                                            leaves_like)):
            t = _read_leaf(f, meta, path, i, dctx)
            if strict_shapes and tuple(t.shape) != _shape(ref):
                raise ValueError(f"leaf shape {tuple(t.shape)} != expected "
                                 f"{_shape(ref)}")
            out.append(_place(t, ref, host))
    return tree_unflatten(like, out)


def _rmtree(p: Path) -> None:
    for child in sorted(p.rglob("*"), reverse=True):
        child.unlink() if child.is_file() else child.rmdir()
    p.rmdir()


class CheckpointManager:
    """Step-indexed checkpoint directory with async save and keep-N GC.

    * **I/O retry**: a save attempt that dies on an ``OSError`` is
      retried up to ``retries`` times with exponential backoff and jitter;
      only exhaustion surfaces the error, on the next ``wait()``.
      ``fail_next_saves(n)`` makes the next ``n`` attempts raise before
      touching disk, ``hang_next_save(s)`` stalls the next one.
    * **Known-good tagging**: ``save(..., known_good=True)`` writes the
      ``KNOWN_GOOD`` tag atomically with the checkpoint; ``rollback()``
      restores the newest tagged step and the GC always keeps it.
    * **Resume marker**: the preemption drain's ``RESUME`` record in the
      root, consumed once by the restarted run.

    ``last_save`` holds the last save's snapshot seconds, write seconds
    and bytes (the write's once the worker finished)."""

    STEP_RE = re.compile(r"^step_(\d+)$")
    KNOWN_GOOD_MARKER = "KNOWN_GOOD"
    RESUME_MARKER = "RESUME"

    def __init__(self, root: str | os.PathLike, keep: int = 3,
                 retries: int = 3, backoff_s: float = 0.05):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.retries = retries
        self.backoff_s = backoff_s
        self._worker: threading.Thread | None = None
        self._last_error: BaseException | None = None
        self._fail_saves = 0
        self._hang_next_save_s = 0.0
        self.last_save: dict = {}

    # ---------------- save ----------------

    def fail_next_saves(self, n: int) -> None:
        """Fault injection: the next ``n`` save attempts raise OSError
        before touching the filesystem."""
        self._fail_saves = n

    def hang_next_save(self, seconds: float) -> None:
        """Fault injection: the next save attempt stalls ``seconds``
        before touching disk (a hung filesystem)."""
        self._hang_next_save_s = seconds

    def _save_once(self, step: int, snap: HostSnapshot, meta: dict,
                   known_good: bool) -> None:
        if self._hang_next_save_s > 0:
            hang, self._hang_next_save_s = self._hang_next_save_s, 0.0
            time.sleep(hang)
        if self._fail_saves > 0:
            self._fail_saves -= 1
            raise OSError("injected checkpoint I/O failure")
        save_pytree(self.root / f"step_{step:010d}", snap, meta,
                    marker=self.KNOWN_GOOD_MARKER if known_good else None)

    def save(self, step: int, tree: Any, blocking: bool = False,
             extra_meta: dict | None = None,
             known_good: bool = False) -> None:
        self.wait()   # backpressure: one outstanding save
        t0 = time.perf_counter()
        snap = snapshot(tree)                      # on this thread, now
        info = {"step": step, "bytes": snapshot_bytes(snap),
                "snapshot_s": time.perf_counter() - t0}
        self.last_save = info
        meta = dict(extra_meta or {}, step=step, time=time.time(),
                    known_good=bool(known_good))

        def work():
            import random
            t1 = time.perf_counter()
            for attempt in range(self.retries + 1):
                try:
                    self._save_once(step, snap, meta, known_good)
                    self._gc()
                    info["write_s"] = time.perf_counter() - t1
                    return
                except OSError as e:
                    if attempt == self.retries:
                        self._last_error = e   # surfaced on next wait()
                        return
                    delay = (self.backoff_s * (2 ** attempt)
                             * (1.0 + random.random()))
                    print(f"[ckpt] save step {step} attempt "
                          f"{attempt + 1} failed ({e}) — retrying in "
                          f"{delay:.3f}s", flush=True)
                    time.sleep(delay)
                except BaseException as e:  # non-I/O: no point retrying
                    self._last_error = e
                    return

        if blocking:
            work()
            self.wait()
        else:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()

    def wait(self, timeout: float | None = None) -> None:
        """Join the in-flight save, then raise its failure if it failed.
        ``timeout`` bounds the join: on expiry a ``TimeoutError`` (an
        ``OSError``) is raised and the worker is left running; a later
        ``wait()`` joins it again."""
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise TimeoutError(
                    f"checkpoint save still running after {timeout:.1f}s — "
                    "filesystem presumed hung")
            self._worker = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ---------------- resume marker ----------------

    def write_resume_marker(self, step: int, reason: str) -> None:
        """The preemption drain's ``RESUME`` record: the newest checkpoint
        is a clean auto-resume point."""
        (self.root / self.RESUME_MARKER).write_text(json.dumps(
            {"step": int(step), "reason": reason, "time": time.time()}))

    def consume_resume_marker(self) -> dict | None:
        """Pop the resume marker (its record; {} if unreadable), once."""
        p = self.root / self.RESUME_MARKER
        if not p.exists():
            return None
        try:
            rec = json.loads(p.read_text())
        except (OSError, ValueError):
            rec = {}
        p.unlink(missing_ok=True)
        return rec

    # ---------------- restore ----------------

    def steps(self) -> list[int]:
        out = []
        for child in self.root.iterdir() if self.root.exists() else []:
            m = self.STEP_RE.match(child.name)
            if m and (child / "manifest.msgpack").exists() \
                    and (child / "data.bin").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def known_good_steps(self) -> list[int]:
        """Complete checkpoints carrying the KNOWN_GOOD tag, ascending."""
        return [s for s in self.steps()
                if (self.root / f"step_{s:010d}"
                    / self.KNOWN_GOOD_MARKER).exists()]

    def rollback(self, like: Any, loader: Callable | None = None,
                 before: int | None = None) -> tuple[Any, int] | None:
        """Restore the newest known-good checkpoint (only steps below
        ``before`` when given), falling back past damaged tagged steps;
        (tree, step), or None when no tagged step restores.  Waits out an
        in-flight save first."""
        self.wait()
        load = loader if loader is not None else load_pytree
        for s in reversed(self.known_good_steps()):
            if before is not None and s >= before:
                continue
            try:
                return load(self.root / f"step_{s:010d}", like), s
            except Exception as e:
                print(f"[ckpt] known-good step {s} not restorable "
                      f"({type(e).__name__}: {e}) — falling back to the "
                      "previous tagged checkpoint", flush=True)
        return None

    def restore(self, like: Any, step: int | None = None,
                loader: Callable | None = None) -> tuple[Any, int] | None:
        """(tree, step), or None if no checkpoint restores.  Without
        ``step`` the candidates are tried newest first, and a damaged or
        incompatible one is skipped with a logged line; an explicit
        ``step`` is tried alone and raises.  ``loader(path, like)``
        replaces the plain load (the elastic restore hooks in here)."""
        load = loader if loader is not None else load_pytree
        if step is not None:
            return load(self.root / f"step_{step:010d}", like), step
        last_err: Exception | None = None
        for s in reversed(self.steps()):
            try:
                return load(self.root / f"step_{s:010d}", like), s
            except Exception as e:
                last_err = e
                print(f"[ckpt] step {s} not restorable "
                      f"({type(e).__name__}: {e}) — falling back to the "
                      "previous checkpoint", flush=True)
        if last_err is not None:
            print("[ckpt] no restorable checkpoint found "
                  f"(last error: {last_err}) — starting fresh", flush=True)
        return None

    def _gc(self) -> None:
        if not self.keep:
            return
        steps = self.steps()
        preserve = set(steps[-self.keep:])
        kg = self.known_good_steps()
        if kg:
            preserve.add(kg[-1])      # the rollback anchor outlives keep-N
        for s in steps:
            if s not in preserve:
                _rmtree(self.root / f"step_{s:010d}")
