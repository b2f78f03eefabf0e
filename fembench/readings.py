"""The readings that a cell's limits are set from, in one process on the
card: the program's compared numbers on a dozen seeds or more, then the
control's, the program in float32 (the nearest precision below the
configuration's float64, the program's own path), on three or more.

    python3 fembench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s>

The program is built and warmed once per precision; each seed runs a
window of ``--seconds`` through the benchmark's own window and is judged
by the benchmark's own comparison, as a run is.  One JSON line a seed,
then one line with the lower reading (the largest of the program's) and
the upper reading (the smallest of the control's) of each number.  The
benchmark's runs never run this.
"""

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(spec, seeds, seconds, device, dtype, mesh=None):
    """One dict of compared numbers a seed, with the program in ``dtype``."""
    import torch

    from fembench.harness import bench

    p = bench.build(spec, device, mesh, dtype)
    out = []
    for seed in seeds:
        w = bench.window(p, spec, seed, seconds)
        values, lims = bench.compare(torch, spec, p.mesh, w.samples, p.device)
        out.append({"seed": seed, "dtype": dtype or spec.config["dtype"],
                    "analyses": len(w.analyses), "failed": w.failed,
                    "compared": len(w.samples), "numbers": values,
                    "walls": [a.wall_s for a in w.analyses[:30]],
                    "evals": [len(a.spans.get("newton_eval", []))
                              for a in w.analyses[:30]],
                    "correct": w.failed == 0 and bench.checks.judge(values, lims)})
        print(json.dumps(out[-1]), flush=True)
    p.close()
    return out


def span(program, control):
    """name -> (lower reading, upper reading)."""
    names = program[0]["numbers"].keys() if program else []
    out = {}
    for k in names:
        lo = max(r["numbers"][k] for r in program)
        up = [r["numbers"].get(k, math.nan) for r in control]
        out[k] = (lo, min(up) if up else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from fembench.harness import bench

    spec = bench.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    prog = readings(spec, seeds, args.seconds, "cuda", None)
    ctrl = readings(spec, control, args.seconds, "cuda", "float32")
    print(json.dumps({"workload": args.workload, "readings": span(prog, ctrl)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
