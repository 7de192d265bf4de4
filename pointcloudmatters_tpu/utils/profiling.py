"""Profiling hooks (reference SURVEY §5.1 equivalent).

The reference exposes Lightning's ``trainer.profiler: simple`` via
``debug=profiler`` (`configs/debug/profiler.yaml:8-11`). Here ``profiler:
"jax"`` on the Trainer wraps the fit loop in a ``jax.profiler`` trace whose
artifacts open in TensorBoard / Perfetto, plus per-device memory stats.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from typing import Iterable, Optional

import jax

from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


class JaxProfiler:
    def __init__(self, log_dir: str):
        self.log_dir = os.path.join(log_dir, "jax_trace")
        self._active = False

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        jax.profiler.start_trace(self.log_dir)
        self._active = True
        log.info(f"jax profiler trace -> {self.log_dir}")

    def stop(self) -> None:
        if self._active:
            jax.profiler.stop_trace()
            self._active = False
            log.info(f"jax profiler trace saved to {self.log_dir}")


def device_memory_stats() -> dict:
    stats = {}
    for d in jax.local_devices():
        mem = getattr(d, "memory_stats", lambda: None)()
        if mem:
            stats[f"device{d.id}"] = {
                "bytes_in_use": mem.get("bytes_in_use"),
                "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
                "bytes_limit": mem.get("bytes_limit"),
            }
    return stats


def make_profiler(kind: Optional[str], log_dir: str):
    if kind in (None, False, "", "none"):
        return None
    if kind in ("jax", "simple", "advanced", "pytorch", True):
        return JaxProfiler(log_dir)
    raise ValueError(f"unknown profiler {kind!r}")


# Trace lines that repeat device work already listed per stream (XLA's
# derived module/op summaries) and would double-count it.
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source code")


def device_events(trace_dir: str) -> list[tuple[str, str, int, int]]:
    """(line, op name, start ns, duration ns) of every device event in the
    newest ``jax.profiler`` trace under ``trace_dir``."""
    paths = sorted(glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    ))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:") or "CPU" in plane.name:
            continue
        for line in plane.lines:
            if line.name.startswith(_DERIVED_LINES):
                continue
            for ev in line.events:
                out.append((f"{plane.name}/{line.name}", ev.name,
                            int(ev.start_ns), int(ev.duration_ns)))
    return out


def summarize_device_events(
    events: Iterable[tuple[str, str, int, int]], top: int = 15
) -> dict:
    """Top ops by summed device time, plus busy time and idle share of the
    window from the first event's start to the last event's end."""
    events = sorted(events, key=lambda e: e[2])
    if not events:
        return {"window_ns": 0, "busy_ns": 0, "idle_share": None, "top": []}
    per_op: dict = defaultdict(lambda: [0, 0])
    busy, cur_start, cur_end = 0, None, None
    for _, name, start, dur in events:
        per_op[name][0] += dur
        per_op[name][1] += 1
        end = start + dur
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(e[2] + e[3] for e in events) - events[0][2]
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else None,
        "top": [{"op": k, "ns": v[0], "count": v[1]} for k, v in ranked],
    }
