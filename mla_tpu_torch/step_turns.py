"""The trainer's step time on one card for two trees of this repository, in
turns: this tree (A) and another (B, e.g. the parent commit unpacked with
`git archive`), run A, B, B, A, each turn a process of its own.

    python -m mla_tpu_torch.step_turns --other DIR [--steps 8]
        [--out chiprun_out/step_turns.json]

A turn runs its tree's `mla_tpu_torch.train.main` as chip_smoke.py's
trainer phase runs it (mla-2b at full width, fp32 masters, AdamW, 2 rows
a micro-batch, gradient accumulation 2, 4 diffusion repeats, synthetic
data) for --steps steps with its checkpoint writes skipped, and reports
the trainer's own step times (VLAMetrics' wall between two commits,
the host batch included), their median after the first step, and the
card's peak allocated GiB. Each tree builds its own kernels at first use.
Runs on the card; prints one JSON object per turn and writes them all,
with the card's name and power limit, to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ARGS = ["--vla.type", "prism-dinosiglip-224px+oxe+diffusion", "--model", "mla-2b", "--per_device_batch_size", "2",
        "--global_batch_size", "4", "--run_id", "turn"]


def turn(root: Path, steps: int) -> dict:
    """One turn, in this process: `root`'s trainer for `steps` steps."""
    import tempfile

    sys.path[0] = str(root)  # this tree's package dir (the script's) out, `root`'s package in
    os.chdir(root)
    import torch

    from mla_tpu_torch import train
    from mla_tpu_torch.training import checkpointing

    checkpointing.save_checkpoint = lambda run_dir, state, *, step, **_: Path(run_dir) / f"skipped-{step}"
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        out = train.main(ARGS + ["--max_steps", str(steps), "--save_interval", str(10 * steps), "--run_root_dir", d])
    torch.cuda.synchronize()
    ms = [s * 1e3 for s in out["metrics"].windows["step_time"]]
    return {"tree": str(root), "step_ms": ms, "median_ms": statistics.median(ms[1:]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/step_turns.json")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(Path(args.turn).resolve(), args.steps)))
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    here = Path(__file__).resolve().parents[1]
    other = Path(args.other).resolve()
    (other / "build").mkdir(exist_ok=True)
    (here / "build").mkdir(exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    turns = []
    for root in (here, other, other, here):
        got = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", str(root), "--steps",
                              str(args.steps)], capture_output=True, text=True)
        if got.returncode:
            sys.stderr.write(got.stderr[-4000:])
            raise SystemExit(f"the turn in {root} failed ({got.returncode})")
        turns.append(json.loads(got.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "turns": turns}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
