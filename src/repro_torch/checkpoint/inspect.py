"""Checkpoint inspector: steps, manifest schema, embedded StepPrograms.

    PYTHONPATH=src python -m repro_torch.checkpoint.inspect CKPT_DIR
    PYTHONPATH=src python -m repro_torch.checkpoint.inspect CKPT_DIR \
        --step 50 --leaves --verify --target-mesh 4

Counterpart of the JAX package's ``tools/dump_ckpt.py``, with the same
output, on this package's manager: the step directories a
``CheckpointManager`` root holds (orphaned ``.tmp`` directories of
crashed saves flagged, known-good steps, the rollback targets, marked
``*``), then for the chosen step (the newest by default) the manifest's
format and extras, the embedded per-leaf StepProgram descriptors
(``state_programs``: regime, shards, state layout, rank, method: what
the elastic restore transposes from) and, with ``--leaves``, the per-leaf
table.  ``--verify`` re-reads ``data.bin`` and recomputes every crc32
(which leaf is damaged, if any); ``--target-mesh G`` lists the sharded
regimes each low-rank leaf could restore onto at G ranks
(``transpose.restore_targets``).  The exit code is 1 when a verified leaf
is damaged or the step cannot be read.
"""

from __future__ import annotations

import argparse
import sys
import zlib
from pathlib import Path

from repro_torch.checkpoint.manager import (CheckpointManager, _decompressor,
                                            load_manifest)
from repro_torch.checkpoint.transpose import restore_targets


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


def _verify(path: Path, manifest: dict) -> int:
    """Print and count the damaged leaves of one step."""
    data = (path / "data.bin").read_bytes()
    bad = 0
    for i, meta in enumerate(manifest["leaves"]):
        blob = data[meta["offset"]:meta["offset"] + meta["nbytes"]]
        try:
            if len(blob) < meta["nbytes"]:
                raise IOError(f"truncated ({len(blob)}/{meta['nbytes']} B)")
            if meta["compressed"]:
                blob = _decompressor(path).decompress(
                    blob, max_output_size=meta["raw_nbytes"])
            if zlib.crc32(blob) != meta["crc32"]:
                raise IOError("crc32 mismatch")
        except Exception as e:
            print(f"  LEAF {i} DAMAGED: {e}")
            bad += 1
    print(f"  verify: {len(manifest['leaves']) - bad} ok, {bad} damaged")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", help="CheckpointManager root directory")
    ap.add_argument("--step", type=int, default=None,
                    help="inspect this step (default: newest)")
    ap.add_argument("--leaves", action="store_true",
                    help="print the full per-leaf manifest table")
    ap.add_argument("--verify", action="store_true",
                    help="recompute every leaf crc32 against data.bin")
    ap.add_argument("--target-mesh", action="append", type=int,
                    default=None, metavar="N",
                    help="elastic-restore admissibility report: for each "
                         "given rank count (repeatable), the StepProgram "
                         "regimes every low-rank leaf can restore onto")
    args = ap.parse_args(argv)

    root = Path(args.root)
    if not root.exists():
        print(f"no such directory: {root}")
        return 1
    mgr = CheckpointManager(root)
    steps = mgr.steps()
    good = set(mgr.known_good_steps())
    tmps = sorted(p.name for p in root.iterdir()
                  if p.is_dir() and p.name.endswith(".tmp"))
    tagged = [f"{s}*" if s in good else str(s) for s in steps]
    print(f"{root}: {len(steps)} complete step(s) "
          f"[{', '.join(tagged)}]{'  (* = known-good)' if good else ''}")
    for t in tmps:
        print(f"  orphaned partial write (crashed save): {t}/")
    if not steps:
        return 0 if not args.verify else 1

    step = args.step if args.step is not None else steps[-1]
    path = root / f"step_{step:010d}"
    if not (path / "manifest.msgpack").exists():
        print(f"step {step}: no manifest at {path}")
        return 1
    manifest = load_manifest(path)
    extra = manifest.get("extra", {})
    total_raw = sum(m["raw_nbytes"] for m in manifest["leaves"])
    total_disk = sum(m["nbytes"] for m in manifest["leaves"])
    print(f"\nstep {step} ({path.name}): format {manifest['format']}, "
          f"{manifest['n_leaves']} leaves, "
          f"{_fmt_bytes(total_raw)} logical / {_fmt_bytes(total_disk)} "
          "on disk")
    print("  known-good: "
          + ("yes (sentinel-validated; rollback target)" if step in good
             else "no"))
    for k in ("step", "time"):
        if k in extra:
            print(f"  extra.{k}: {extra[k]}")

    programs = extra.get("state_programs")
    if programs:
        print(f"\n  state programs ({len(programs)} optimizer-state "
              "nodes):")
        for rec in programs:
            if rec["kind"] == "dense":
                print(f"    {rec['path']:40s} dense")
                continue
            print(f"    {rec['path']:40s} {rec['regime']:10s} "
                  f"g={rec['shards']} axes={tuple(rec['axes']) or '-'} "
                  f"state={rec['state_layout']:10s} "
                  f"m={rec['m']} n={rec['n']} r={rec['rank']} "
                  f"method={rec['method']}")
    else:
        print("\n  no embedded state programs (pre-elastic checkpoint: "
              "restores strict-shape only)")

    if args.target_mesh:
        if not programs:
            print("\n  --target-mesh: no embedded state programs — "
                  "elastic restore (and this report) needs them")
            return 1
        for g in args.target_mesh:
            print(f"\n  restore onto {g} device(s) — admissible regimes "
                  "per leaf (restore itself is always admissible: layout "
                  "changes are identity; this lists the sharded hot "
                  "paths the gates admit):")
            for rec in programs:
                rep = restore_targets(rec, g)
                line = f"    {rec['path']:40s} {', '.join(rep['regimes'])}"
                if rep["notes"]:
                    line += f"   [{'; '.join(rep['notes'])}]"
                print(line)

    if args.leaves:
        print("\n  leaves:")
        for i, m in enumerate(manifest["leaves"]):
            print(f"    [{i:3d}] shape={tuple(m['shape'])!s:20s} "
                  f"{m['dtype']:10s} {_fmt_bytes(m['raw_nbytes']):>12s} "
                  f"crc32={m['crc32']:#010x}"
                  f"{' zstd' if m['compressed'] else ''}")

    if args.verify:
        print()
        return 1 if _verify(path, manifest) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
