"""The benchmark of the PyTorch and CUDA port (``gymrl_tpu_torch``) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It reads ``BENCHMARK.json`` there and the
cell's files under ``portbench/``, builds the cell's trainer on the card
with its weights and draws from ``--seed``, drives it through its first
iterations (set-up: the eager sweep, the capture of the sweep's CUDA graph,
a replay), then measures ``--seconds`` of iterations, each a
``train_iter`` and the host fetch of its episode statistics. ``--trace 1``
adds three profiled iterations after the window and reports the per-layer
metrics in place of the end-to-end ones. Then the plain reference
(``portbench/reference``) follows the same first iterations from the same
seed and the comparison decides ``correct``. The last line of standard
output is the result's JSON object; the numbers compared, beside their
limits, are the last lines of standard error.

It exits with 2, printing no result, without a CUDA device, and with 3 when
the process holds a module of JAX or of the JAX package (``gymrl_tpu``).
Caches go to ``.portbench_cache/`` in the checkout; the kernels' libraries
to the program's own ``gymrl_tpu_torch/kernels/_build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchlib import files, harness

    cell = files.cell(files.benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"no run: {cell['name']} needs {cell['chips']} CUDA device(s), "
                    f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    harness.log(f"card: {harness.card_line()}")
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: this process holds {found}")
        return 3
    harness.log(f"correct: {result['correct']}")
    for name, c in result["compared"].items():
        harness.log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
