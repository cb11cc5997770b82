"""Where a cell's step goes by the program's own spans, on the card.

    python3 bench/span_report.py --workload <cell> --seed <n> \
        [--seconds 51] [--out <file.json>]

Runs the cell's traced window (``run.py --trace 1``'s path, with the
entry points its readers declare and the program's tracer on, but for the
profiled steps, which come last) with each window step inside a span
``window_step``, and prints one JSON object:

* ``steps``, ``profiled`` (the window's steps the profiler recorded),
  ``timed_mean_s`` (the mean host-clock seconds of the unprofiled steps),
  the cell's end-to-end rate and ``correct``;
* ``span_ms``: by span name, the mean over the unprofiled window steps
  of the step's summed span seconds (the tracer's clock), ms;
  ``profiled_span_ms`` the same over the profiled steps, and
  ``step_span_ms`` each window step's own;
* ``idle``: the profiled steps' window, busy and idle seconds, and the
  idle split by the innermost ``repro::`` range around it
  (``benchkit.spans.idle_by_span``);
* ``idle_inside_pct``: by span name, the idle share of the time inside
  its ranges, %;
* ``device_ms``: by span name, the device seconds of the operations
  launched inside its ranges, a profiled step, ms;
* ``per_layer``: the cell's per-layer metrics, read by their readers from
  this window (null where a reader finds nothing to read).

The spans inside a step time the host's issue of the work: the program
synchronizes only at a step's end.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench_run  # noqa: E402

#: the span the window opens around each of its steps
STEP = "window_step"


def report(cell: str, seed: int, seconds: float, device="cuda",
           cfg: dict = None, traffic: dict = None) -> dict:
    """The report of one traced window of ``cell``; ``cfg`` / ``traffic``
    replace the cell's files (a rehearsal at a small size)."""
    import torch
    from benchkit import cells, compare, entries, manifest, spans
    from benchkit.window import Window
    from repro_torch.obs import trace as obs_trace

    class SpanWindow(Window):
        """The window with a span around each step, its profiled steps
        last."""
        tracer = None
        profiled = range(0)

        def run(self, one, seconds, profiled):
            # the tracer the cell's run function set for its window
            self.tracer = tracer = obs_trace.get_tracer()
            tracer.clear()
            self.deadline = time.perf_counter() + seconds

            def step():
                with tracer.span(STEP):
                    return one()

            return super().run(step, seconds, profiled)

        def _due(self, res, profiled):
            # the profiled steps close the window: reduced inside it, a
            # training profile would leave two timed steps before them
            return super()._due(res, profiled) \
                and time.perf_counter() >= self.deadline

        def _profile(self, one, profiled, res):
            self.profiled = range(res.steps, res.steps + profiled)
            super()._profile(one, profiled, res)

    man = manifest.manifest()
    c = manifest.cell(man, cell)
    cfg = cfg or manifest.config(man, c["config"])
    traffic = traffic or manifest.traffic(c["traffic"])
    ref = manifest.reference(c["config"])
    read = cells.readers(man, cell)
    win = SpanWindow(device, T0, True, entries.union(read.values()))
    try:
        res = cells.DRIVERS[traffic["kind"]](cfg, traffic, ref, seed,
                                             seconds, win, device)
    finally:
        win.close()
    correct, _ = compare.judge(res.numbers, manifest.limits(cell)["limits"])
    steps = spans.per_step(win.tracer.spans, STEP)

    def mean_ms(idx):
        idx = [i for i in idx if i < len(steps)]
        names = sorted({n for i in idx for n in steps[i]})
        return {n: 1e3 * statistics.fmean(steps[i].get(n, 0.0) for i in idx)
                for n in names} if idx else {}

    r, n_prof = res.spans, len(win.profiled)
    dev = torch.device(device)
    out = {"cell": cell, "seed": seed,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else dev.type,
           "steps": res.steps, "profiled": list(win.profiled),
           "timed_mean_s": statistics.fmean(res.timed_s),
           "timed_s": res.timed_s, "metrics": res.metrics,
           "correct": bool(correct and res.failed == 0),
           "span_ms": mean_ms([i for i in range(len(steps))
                               if i not in win.profiled]),
           "profiled_span_ms": mean_ms(win.profiled),
           "step_span_ms": [{n: 1e3 * v for n, v in st.items()}
                            for st in steps]}
    if r is not None:
        busy = sum(e - s for s, e in r["busy"]) / 1e9
        window = (r["window"][1] - r["window"][0]) / 1e9
        out["idle"] = {"window_s": window, "busy_s": busy,
                       "idle_s": window - busy,
                       "idle_pct": 100.0 * (1.0 - busy / window),
                       "by_span": spans.idle_by_span(r)}
        inside = {}
        for name in sorted({h[2] for h in r["host"]}):
            idle, wall = spans.idle_inside(r, name)
            inside[name] = 100.0 * idle / wall if wall else None
        out["idle_inside_pct"] = inside
        out["device_ms"] = {n: 1e3 * spans.device_s(r, [n]) / n_prof
                            for n in sorted(r["device"])}
    ctx = cells.Context(c, cfg, traffic, res, ref)
    out["per_layer"] = {m: reader.read(ctx) for m, reader in read.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(bench_run.ENV)
    sys.path.insert(0, str(bench_run.ROOT / "src"))

    import torch
    if not torch.cuda.is_available():
        print("span_report.py: no CUDA device", file=sys.stderr)
        return 2
    out = report(args.workload, args.seed, args.seconds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
