"""The readings that a cell's limits are set from, on the CUDA card at the
cell's own size, in one process:

  program  the window's answers against the float32 reference, on each of
           --seeds (the lower readings);
  control  the reference computed in bfloat16, put in the program's place,
           on the first three seeds (an upper reading);
  ulp      the float32 reference with its camera row one ulp off, put in
           the program's place, on the first three seeds: what an
           implementation reads that is sound but rounds otherwise;
  faults   with --faults, each fault of faults.py planted in the program,
           on the first three seeds.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --seconds 3 [--faults] [--out calibrate_<cell>.json]

Prints one JSON line per reading and writes them all to --out.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import faults, harness, tracing  # noqa: E402
from benchmark.reference import camera as ref_camera  # noqa: E402


@contextlib.contextmanager
def camera_row_one_ulp_up():
    real = ref_camera.camera_row

    def nudged(cam):
        row = real(cam)
        return torch.nextafter(row, torch.full_like(row, float("inf")))

    ref_camera.camera_row = nudged
    try:
        yield
    finally:
        ref_camera.camera_row = real


def reading(cell, seed: int, seconds: float, device, control: bool = False,
            fault: str = "") -> dict:
    t0 = time.perf_counter()
    drv = harness.make_driver(cell, seed, device)
    if fault:
        with faults.planted(fault):
            drv.setup()
            lp = harness.closed_loop(drv, seconds, tracing.Window(False))
    else:
        drv.setup()
        lp = harness.closed_loop(drv, seconds, tracing.Window(False))
    drv.release()
    out = {"seed": seed, "requests": len(lp.times), "failed": lp.failed,
           "what": "fault:" + fault if fault else "program"}
    if lp.times:
        out["readings"] = drv.check(torch.float32)
        out.update(getattr(drv, "detail", {}))
        if control:
            with camera_row_one_ulp_up():
                drv.put_reference(torch.float32)
            out["ulp"] = drv.check(torch.float32)
            drv.put_reference(torch.bfloat16)
            out["control"] = drv.check(torch.float32)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for k, seed in enumerate(seeds):
        rows.append(reading(cell, seed, args.seconds, dev, control=k < 3))
        print(json.dumps(rows[-1]), flush=True)
    if args.faults:
        for kind in faults.FAULTS:
            for seed in seeds[:3]:
                rows.append(reading(cell, seed, args.seconds, dev, fault=kind))
                print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(dev),
               "rows": rows}
    for key in ("readings", "ulp", "control"):
        vals = [r[key] for r in rows if key in r and r["what"] == "program"]
        if vals:
            summary[key + "_min"] = {n: min(v[n] for v in vals) for n in vals[0]}
            summary[key + "_max"] = {n: max(v[n] for v in vals) for n in vals[0]}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
