"""The benchmark of femcy_tpu_torch on the card.

    python3 fembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Builds the cell's model from its files,
warms up, runs analyses back to back for ``--seconds``, judges a sample of
them against the plain reference, and prints one JSON line last on
standard output; the compared numbers and their limits are the last lines
on standard error.  With ``--trace 1`` it reports the per-layer metrics
and traces a bounded stretch after the window.  Exits with a code other
than 0, printing no result, without enough CUDA cards, or when JAX or the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from fembench.harness import bench

    spec = bench.load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"fembench: {args.workload} needs {spec.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, overhead, analyses = bench.run(spec, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"fembench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    if overhead is not None:
        print(f"tracing overhead: an analysis in the traced stretch took "
              f"{overhead!r} x the window's solve_s")
    walls = sorted(a.wall_s for a in analyses)
    half = len(analyses) // 2
    halves = [sum(a.wall_s for a in part) / len(part)
              for part in (analyses[:half], analyses[half:]) if part]
    print(f"window: {len(walls)} analyses, walls {walls[0]!r} (least) "
          f"{walls[len(walls) // 2]!r} (median) {walls[-1]!r} (most) s; "
          f"mean wall of each half {halves!r} s; "
          f"first ones {[round(a.wall_s, 4) for a in analyses[:12]]}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
