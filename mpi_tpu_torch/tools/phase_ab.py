"""Time some of ``chip_smoke.py``'s phases of two trees in one call.

    python -m mpi_tpu_torch.tools.phase_ab --tree PARENT --tag parent \\
        --out chiprun_out
    python -m mpi_tpu_torch.tools.phase_ab --tree . --tag change --out chiprun_out

Each run imports the ``chip_smoke.py`` and ``mpi_tpu_torch`` of ``--tree``
(one process a tree: the two packages share their names), builds its
kernels, then runs its ring-attention phases (``attention_phases``: 9-12,
and 12a where the tree has it) and its host-local phase 13, and writes
``<out>/phase_ab_<tag>.json``: each group's seconds, the phase walls the
script printed, the launches of every path, the attention timings and
the record of phase 13.  Run the trees in turns (parent, change, change,
parent) on one card, so that a chip script's change of seconds is
measured on one host.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="root of the tree to run")
    ap.add_argument("--tag", required=True, help="name of this run in the output")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out)
    root = os.path.abspath(args.tree)
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "mpi_tpu_torch"]:
        del sys.modules[name]  # the tree's own package, not this one
    import torch

    import chip_smoke
    from mpi_tpu_torch import _build

    if not torch.cuda.is_available():
        print("phase_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    record, paths = {}, {}
    lines = []
    printed = chip_smoke.log
    chip_smoke.log = lambda msg: (lines.append(msg), printed(msg))  # lap() logs too
    chip_smoke.lap("set-up")
    t0 = time.perf_counter()
    chip_smoke.attention_phases(torch, dev, gen, record, paths)
    t1 = time.perf_counter()
    chip_smoke.host_local_phase(torch, record)
    t2 = time.perf_counter()
    walls = {m.group(1): float(m.group(2)) for line in lines
             for m in [re.match(r"\[phase (.+?): ([\d.]+) s wall\]", line)] if m}
    res = {"tag": args.tag, "card": chip_smoke.card_line(),
           "attention_phases_s": t1 - t0, "host_local_s": t2 - t1, "phase_walls_s": walls,
           "launches_by_path": paths, "attention_timing": record.get("attention_timing"),
           "wide_attention": record.get("wide_attention"),
           "attention_parity_wide": record.get("attention_parity_wide"),
           "allowance_used": record.get("allowance_used"),
           "host_local": record.get("host_local")}
    with open(os.path.join(out_dir, f"phase_ab_{args.tag}.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(json.dumps({"tag": args.tag, "attention_phases_s": t1 - t0,
                      "host_local_s": t2 - t1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
