"""Streaming telemetry — the live-samples side of online calibration.

The trainer (``runtime/trainer.py``, its ``time.perf_counter`` step loop,
timed to ``torch.cuda.synchronize``) and the decode server
(``runtime/server.py``, timed to the sampled tokens' copy to the host) feed
a ``TelemetrySink`` with (property-vector, measured seconds) samples as real
steps execute.
The sink is a bounded ring buffer with the property vectors stored ONCE
per distinct fingerprint — a training run emits thousands of samples that
all share one step vector, so samples are (fingerprint, seconds, step)
records over a small deduplicated vector table.

Consumers: ``calibration/online.py`` (RLS refit windows, drift residuals)
and the telemetry JSON artifact (``save`` / ``load``).

A copy of the reference's ``calibration/telemetry.py`` (numpy only): the
same fingerprints, the same JSON schema, so a file written by either
package loads in the other.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Mapping, Optional, Tuple

from repro_torch.obs import metrics as _obs_metrics

_SAMPLES = _obs_metrics.REGISTRY.counter(
    "repro_telemetry_samples_total",
    "timing samples accepted into telemetry sinks, by phase")
_DROPPED = _obs_metrics.REGISTRY.counter(
    "repro_telemetry_dropped_total",
    "non-positive timings rejected by telemetry sinks")
_OCCUPANCY = _obs_metrics.REGISTRY.gauge(
    "repro_telemetry_ring_occupancy",
    "buffered samples in the most recently touched telemetry ring")
_UNIQUE_PVS = _obs_metrics.REGISTRY.gauge(
    "repro_telemetry_unique_pvs",
    "distinct property vectors in the most recently touched sink's table")


def pv_fingerprint(pv: Mapping[str, float], phase: str = "") -> str:
    """Stable content hash of a property vector (zero entries ignored, so
    a finalized and a sparse form of the same vector agree).  A truthy
    ``phase`` is hashed in: a train step and a decode iteration whose
    vectors happen to collide numerically must still never share a table
    entry, because refit windows select by phase."""
    h = hashlib.blake2b(digest_size=12)
    if phase:
        h.update(f"phase={phase};".encode())
    for k in sorted(pv):
        v = float(pv[k])
        if v:
            h.update(f"{k}={v!r};".encode())
    return h.hexdigest()


@dataclass(frozen=True)
class TelemetrySample:
    seq: int                 # global monotone sample index (never reused)
    fingerprint: str         # key into the sink's vector table
    seconds: float           # measured wall seconds
    step: Optional[int]      # producer's step counter, if any
    tag: str                 # producer label, free-form
    phase: str = "train"     # workload phase: "train" | "prefill" | "decode"


class TelemetrySink:
    """Bounded ring buffer of timing samples + deduplicated vector table.

    ``record`` assigns each sample a monotone ``seq``; eviction drops the
    oldest sample and garbage-collects its property vector when no buffered
    sample references it anymore.  Non-positive timings are counted and
    dropped — they carry no fit information and would poison the
    relative-error system downstream.
    """

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = capacity
        self._buf: Deque[TelemetrySample] = deque()
        self._pvs: Dict[str, Dict[str, float]] = {}
        self._refs: Dict[str, int] = {}
        self.n_recorded = 0      # accepted samples, including evicted ones
        self.n_dropped = 0       # rejected non-positive timings

    # ------------------------------------------------------------------
    def record(self, pv: Mapping[str, float], seconds: float, *,
               step: Optional[int] = None, tag: str = "",
               phase: str = "train") -> Optional[int]:
        """Append one sample; returns its ``seq`` (None when dropped).
        ``phase`` keys the sample (and its vector-table entry) by workload
        phase, so refit windows never mix prefill/decode rows into a train
        fit."""
        # `not seconds > 0` alone already rejects NaN (NaN > 0 is False)
        # but would let +inf through into the ring — and a non-finite pv
        # entry would poison any refit window that selects it
        if not (math.isfinite(seconds) and seconds > 0) or \
                any(not math.isfinite(float(v)) for v in pv.values()):
            self.n_dropped += 1
            _DROPPED.inc()
            return None
        fp = pv_fingerprint(pv, phase)
        if fp not in self._pvs:
            self._pvs[fp] = {k: float(v) for k, v in pv.items() if v}
            self._refs[fp] = 0
        self._refs[fp] += 1
        seq = self.n_recorded
        self._buf.append(TelemetrySample(seq, fp, float(seconds), step, tag,
                                         phase))
        self.n_recorded += 1
        while len(self._buf) > self.capacity:
            old = self._buf.popleft()
            self._refs[old.fingerprint] -= 1
            if self._refs[old.fingerprint] == 0:
                del self._refs[old.fingerprint]
                del self._pvs[old.fingerprint]
        _SAMPLES.inc(1, phase=phase)
        _OCCUPANCY.set(len(self._buf))
        _UNIQUE_PVS.set(len(self._pvs))
        return seq

    def pv(self, fingerprint: str) -> Dict[str, float]:
        return self._pvs[fingerprint]

    # ------------------------------------------------------------------
    def samples(self, *, n: Optional[int] = None,
                since_seq: Optional[int] = None,
                tag: Optional[str] = None,
                phase: Optional[str] = None) -> List[TelemetrySample]:
        """Buffered samples, oldest first, filtered by window/tag/phase
        (None = no filtering on that key)."""
        out = [s for s in self._buf
               if (since_seq is None or s.seq >= since_seq)
               and (tag is None or s.tag == tag)
               and (phase is None or s.phase == phase)]
        if n is not None:
            out = out[-n:]
        return out

    def window(self, *, n: Optional[int] = None,
               since_seq: Optional[int] = None, tag: Optional[str] = None,
               phase: Optional[str] = None
               ) -> Tuple[List[Dict[str, float]], List[float]]:
        """(property vectors, times) for a sample window — the exact
        argument pair ``fit_relative`` / ``RLSState.observe_many`` take."""
        sel = self.samples(n=n, since_seq=since_seq, tag=tag, phase=phase)
        return [self._pvs[s.fingerprint] for s in sel], \
               [s.seconds for s in sel]

    def __len__(self) -> int:
        return len(self._buf)

    def stats(self) -> Dict[str, int]:
        return {"n_recorded": self.n_recorded, "n_buffered": len(self._buf),
                "n_dropped": self.n_dropped, "n_unique_pvs": len(self._pvs)}

    def clear(self) -> None:
        self._buf.clear()
        self._pvs.clear()
        self._refs.clear()

    # ------------------------------------------------------------------
    def to_json_dict(self) -> Dict[str, object]:
        return {
            "schema": 2,          # 2 adds the per-sample phase column
            "kind": "telemetry",
            "capacity": self.capacity,
            "n_recorded": self.n_recorded,
            "n_dropped": self.n_dropped,
            "pvs": self._pvs,
            "samples": [[s.seq, s.fingerprint, s.seconds, s.step, s.tag,
                         s.phase]
                        for s in self._buf],
        }

    def save(self, path: str) -> None:
        """Atomic write (temp file + ``os.replace``): a crash or kill mid-
        save leaves the previous artifact intact instead of a truncated
        JSON the next ``load`` would choke on."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json_dict(), f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def from_json_dict(cls, d: Mapping[str, object]) -> "TelemetrySink":
        if d.get("kind") != "telemetry":
            raise ValueError(f"not a telemetry record: {d.get('kind')!r}")
        sink = cls(capacity=int(d["capacity"]))
        sink.n_dropped = int(d.get("n_dropped", 0))
        for fp, pv in dict(d["pvs"]).items():
            sink._pvs[fp] = {k: float(v) for k, v in pv.items()}
            sink._refs[fp] = 0
        for row in d["samples"]:
            # schema-1 rows carry no phase column: every pre-phase sample
            # came from the trainer, so they migrate as phase="train"
            seq, fp, seconds, step, tag = row[:5]
            phase = row[5] if len(row) > 5 else "train"
            sink._buf.append(TelemetrySample(int(seq), fp, float(seconds),
                                             None if step is None
                                             else int(step), tag, phase))
            sink._refs[fp] += 1
        sink.n_recorded = int(d["n_recorded"])
        return sink

    @classmethod
    def load(cls, path: str) -> "TelemetrySink":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))
