"""Run one cell of the benchmark once and print its result line.

    python3 obbbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: it reads ``BENCHMARK.json`` there and the
cell's files in this folder, needs as many CUDA cards as the cell asks
for, and prints one JSON object as the last line of standard output
(with ``--trace 1`` the per-layer metrics and the breakdown) and the
numbers compared with the reference, each beside its limit, as the last
lines of standard error. Exits non-zero, printing no result, when the
cards are missing, when the program cannot be imported, or when a JAX
module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".obbbench_cache")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every compile cache of the run at a fixed place inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    # one host thread for torch's own CPU work: no pool of workers to
    # compete with the thread that launches the kernels
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from obbbench.harness import runner, spec

    cell = spec.load_cell(args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[obbbench] {args.workload} needs {chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[obbbench] {args.workload} seed {args.seed} on {card_power()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), T_START, log)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
