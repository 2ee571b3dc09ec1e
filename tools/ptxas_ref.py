"""The ``ptxas`` report of a copy of the port's kernels as a table, the
reference that ``chip_smoke.py``'s phase 55 holds a build's entries to:

    python tools/ptxas_ref.py ROOT OUT [--drop-arg NAME:I:V ...]

ROOT is the root of a copy of the package (its parent directory, e.g. a
commit unpacked with ``git archive HEAD markovmodels_tpu_torch | tar -x -C
build/vP``); the copy builds its own library under ``ROOT/build/``, so
nvcc must be there (run it on the card's machine).  OUT receives
``{"nvcc": the last line of nvcc --version, "entries": {key: {registers,
stack, spill_stores, spill_loads, smem}}}``, keyed by
``chip_smoke.ptxas_key`` (a kernel's name and template arguments without
the anonymous namespace).  ``--drop-arg NAME:I:V`` (repeatable) takes
template argument I out of NAME's keys and drops NAME's entries where that
argument is not V: for a ROOT whose kernel had an argument that the tree
reading the table no longer has (``sweep_kernel:3:Lb0E``: the TROP flag the
dense sweep lost when K6t became a kernel of its own).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path


def main(argv) -> int:
    root, out, rules = argv[0], Path(argv[1]), []
    rest = argv[2:]
    while rest:
        flag, rule, *rest = rest
        assert flag == "--drop-arg", flag
        name, i, v = rule.split(":")
        rules.append((name, int(i), v))
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build

    if not mt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mt.__file__}, not the copy at {root}")
    _build.library()
    if not _build.PTXAS_LOG:
        raise RuntimeError(f"{_build.build_dir()} held a library already: "
                           "no ptxas report (remove it to rebuild)")
    entries = {}
    for key, v in chip_smoke.ptxas_table(_build.PTXAS_LOG).items():
        for name, i, want in rules:
            if key.startswith(name + "<"):
                args = key[len(name) + 1:-1].split(",")
                if args[i] != want:
                    key = None
                    break
                key = f"{name}<{','.join(args[:i] + args[i + 1:])}>"
        if key is not None:
            entries[key] = v
    table = {"nvcc": chip_smoke.nvcc_version(), "entries": entries}
    out.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    print(f"{len(entries)} entries ({table['nvcc']}) into {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
