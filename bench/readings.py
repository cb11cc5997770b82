"""The readings a cell's limits are set from, on the card, in one process.

    python3 bench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out <file.json>]

For every seed of ``--seeds``: a sound run of the cell (``run.py``'s path,
a short window), its numbers.  For every seed of ``--control-seeds``: the
control, the plain reference computed with fp8 products in the program's
place, judged as the program is; for a training cell also the faults
planted in the reference (half of each batch left out; one element of
the answer, the updated parameters, altered; a state left unchanged reads
1 by the measure and needs no run).  The limits themselves are written by
hand into ``bench/limits/<cell>.json`` from these readings.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(bench_run.ENV)
    sys.path.insert(0, str(bench_run.ROOT / "src"))

    import torch
    from benchkit import cells, compare, manifest, prefill, train
    from benchkit import weights as W
    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    man = manifest.manifest()
    c = manifest.cell(man, args.workload)
    cfg = manifest.config(man, c["config"])
    traffic = manifest.traffic(c["traffic"])
    ref = manifest.reference(c["config"])
    huge = {k: float("inf") for k in manifest.limits(args.workload)["limits"]}
    out = {"cell": args.workload, "device": torch.cuda.get_device_name(),
           "program": {}, "control": {}, "faults": {}}

    def save():
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.perf_counter()
        line, res = cells.measure(args.workload, s, args.seconds, False,
                                  time.perf_counter(), man=man, limits=huge)
        out["program"][s] = dict(res.numbers, setup_s=res.setup_s,
                                 steps=res.steps)
        del line, res
        print(f"program seed {s}: {out['program'][s]} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        torch.cuda.empty_cache()
        save()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        if traffic["kind"] == "prefill":
            w = W.make(cfg, s, "cuda", ref)
            g = torch.Generator("cuda").manual_seed(s * 2 + 1)
            pool = torch.randint(0, cfg["vocab_size"],
                                 (traffic["pool"], traffic["batch"],
                                  traffic["seq_len"]),
                                 generator=g, device="cuda",
                                 dtype=torch.int32)
            got = {}
            for b in range(traffic["sampled_steps"]):
                one = prefill.control_step(cfg, ref, w, pool[b])
                got = {k: max(v, got.get(k, 0.0)) for k, v in one.items()}
            out["control"][s] = got
            del w, pool
        else:
            want = train.follow(ref, cfg, traffic, s, "cuda", "f32")
            low = train.follow(ref, cfg, traffic, s, "cuda", "fp8")
            out["control"][s] = compare.train_numbers(low, want)
            half = train.follow(ref, cfg, traffic, s, "cuda", "f32",
                                rows=lambda bt: {k: v[:v.shape[0] // 2]
                                                 for k, v in bt.items()})
            altered = dict(want, change=dict(want["change"]))
            altered["change"]["embed.weight"] = float(torch.linalg.norm(
                torch.tensor([want["change"]["embed.weight"], 1.0])))
            out["faults"][s] = {
                "half_batch": compare.train_numbers(half, want),
                "altered": compare.train_numbers(altered, want)}
        print(f"control seed {s}: {out['control'][s]} "
              f"{out['faults'].get(s, '')} ({time.perf_counter() - t:.1f} s)",
              flush=True)
        torch.cuda.empty_cache()
        save()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
