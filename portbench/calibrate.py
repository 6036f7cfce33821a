"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--faults 3] [--out F]

For every seed: the program's first iterations, as a benchmark run's set-up
drives them, against the reference's from that seed (the sound readings).
For the first ``--faults`` seeds also the control, the reference computed
with its float32 products in TF32 and put in the program's place, and the
program with each fault the configuration names (``faults/<name>.py``;
``unchanged`` reads 1 by the change's measure and is not run: the captured
sweep refuses a sweep that steps Adam no times). Every reading is a JSON line on standard output
and in ``--out``. A benchmark run never runs this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 portbench/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from benchlib import compare, files, harness, program

    if not torch.cuda.is_available():
        harness.log("calibrate needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    cell = files.cell(files.benchmark(ROOT), args.workload)
    conf, cfg = files.config(cell["config"]), files.run_config(cell)
    plants = files.obj(conf["faults"])
    harness.log(f"card: {harness.card_line()}")
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps({"cell": cell["name"], **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ref = compare.reference_summary(conf, cfg, seed, device)
        emit({"seed": seed, "side": "reference", "s": time.perf_counter() - t0,
              "episodes": ref["episodes"]})
        sides = [("program", None)]
        if i < args.faults:
            sides += [(name, plant) for name, plant in plants.items() if name != "unchanged"]
        for side, plant in sides:
            t0 = time.perf_counter()
            trainer, ts, prog = program.run_setup(conf, cfg, seed, device, plant)
            del trainer, ts
            torch.cuda.empty_cache()
            emit({"seed": seed, "side": side, "s": time.perf_counter() - t0,
                  **compare.numbers(prog, ref, conf, cfg, seed, device)})
        if i < args.faults:
            t0 = time.perf_counter()
            ctl = compare.reference_summary(conf, cfg, seed, device, "tf32")
            emit({"seed": seed, "side": "control_tf32", "s": time.perf_counter() - t0,
                  **compare.numbers(ctl, ref, conf, cfg, seed, device)})
    harness.log(f"peak memory {torch.cuda.max_memory_allocated(device)} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
