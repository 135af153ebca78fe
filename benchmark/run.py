"""Run one cell of the benchmark once, on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and the compared numbers on standard error, and as the
last line of standard output one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the numbers that
decided `correct`, each beside its limit.  Exits non-zero, printing no
result, without enough CUDA cards, when the program cannot be imported,
or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or its libraries keep stays inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


CARD_STATE = ("power_limit_w", "power.limit"), ("sm_clock_mhz", "clocks.sm"), \
    ("temperature_c", "temperature.gpu"), ("power_draw_w", "power.draw")


def card_state() -> dict:
    """The card's power limit, and its clock, temperature and draw at the
    moment of reading (the window's close): what a rate is read beside."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--format=csv,noheader,nounits",
                              "--query-gpu=" + ",".join(q for _, q in CARD_STATE)],
                             capture_output=True, text=True, timeout=20)
        vals = out.stdout.strip().splitlines()[0].split(",")
        return {k: float(v) for (k, _), v in zip(CARD_STATE, vals)}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    from benchmark import port  # noqa: F401  (the program itself: no result without it)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"needs {cell.chips} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    harness.log(f"torch and the program imported, CUDA context made: "
                f"{time.perf_counter() - T_START:.3f} s")
    peak = {}

    def window_closed():
        torch.cuda.synchronize(dev)
        peak["bytes"] = torch.cuda.max_memory_reserved(dev)
        peak["card"] = card_state()

    result, rec = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                                 T_START, window_closed)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": peak["bytes"], **peak["card"]}
    if args.trace:
        device["busy_s"], device["window_s"] = rec.trace.busy_s, rec.trace.window_s
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    checks = result.pop("checks")
    for name, c in checks.items():
        harness.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    out = {**result, "device": device, "checks": checks}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
