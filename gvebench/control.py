#!/usr/bin/env python3
"""Runs of a cell with something else in the program's place, to show that
the check fails them: the control and the planted faults.  The benchmark's
own runs never come here.

    python3 gvebench/control.py --workload <cell> --seed <n> --seconds <s> \
        --as {control,unchanged,half_batch,altered} [--device cuda]

* ``control``: the reference put in the program's place, scoring Eq. 2 in
  bfloat16, the precision below the configuration's float32 (the
  configuration states no precision of its own; its weights are integers,
  which every float type holds).
* ``unchanged``: the program's step returns its state unchanged (a cold
  call the singleton start it begins from; a stream call the graph and
  membership it was given).
* ``half_batch``: half of every batch left out of what the program applies.
* ``altered``: one label of every answer altered where it is produced.

Prints the result line as ``run.py`` does; ``correct`` must come out false.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]

from gvebench.standins import STAND_INS  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--as", dest="stand_in", choices=sorted(STAND_INS),
                    required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gvebench import harness

    harness.cache_dirs(ROOT)
    result = harness.run_cell(harness.Bench(ROOT), args.workload, args.seed,
                              args.seconds, False, t_start=T_START,
                              device=args.device,
                              system_factory=STAND_INS[args.stand_in])
    found = harness.forbidden_modules()
    if found:
        print(f"gvebench: modules that must not load in this process were "
              f"loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
