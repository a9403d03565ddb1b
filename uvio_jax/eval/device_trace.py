"""Device time per named scope, from a `jax.profiler` trace.

A jitted step whose stages run under `jax.named_scope` carries the scope
path in each HLO instruction's `op_name` metadata. The profiler records
one event per kernel (or per thunk on the CPU) with the instruction it
ran (`hlo_op`) and its module (`hlo_module`). Joining the two gives
device time per stage, the stage's share of the step, and the device's
busy and idle time over the traced window.
"""

from __future__ import annotations

import glob
import os
import re

_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")


def scope_of_instructions(hlo_text: str, scopes) -> dict:
    """{instruction name: scope} for a compiled module's text
    (`compiled.as_text()`): the first of `scopes` on the instruction's
    own op_name path, else the most frequent scope among the
    instructions of the computation it calls (a fusion's metadata is
    often missing or names only its root)."""
    wanted = set(scopes)
    own, calls, comp_instrs = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        c = _COMP.match(line)
        if c is not None and "=" not in line.split("{")[0]:
            comp = c.group(1)
            comp_instrs.setdefault(comp, [])
            continue
        m = _INSTR.match(line)
        if m is None:
            continue
        name = m.group(1)
        comp_instrs.setdefault(comp, []).append(name)
        op = _OP_NAME.search(line)
        if op is not None:
            hit = next((p for p in op.group(1).split("/") if p in wanted), None)
            if hit is not None:
                own[name] = hit
        calls[name] = _CALLS.findall(line)

    memo = {}

    def resolve(name, depth=0):
        if name in own:
            return own[name]
        if name in memo or depth > 8:
            return memo.get(name)
        votes = {}
        for callee in calls.get(name, ()):
            for inner in comp_instrs.get(callee, ()):
                sc = resolve(inner, depth + 1)
                if sc is not None:
                    votes[sc] = votes.get(sc, 0) + 1
        memo[name] = max(votes, key=votes.get) if votes else None
        return memo[name]

    out = {}
    for name in calls:
        sc = resolve(name)
        if sc is not None:
            out[name] = sc
    return out


def _xplane(trace_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return paths[-1]


def device_events(trace_dir: str):
    """(start_ns, duration_ns, hlo_op, hlo_module) of every device event:
    the GPU planes' kernels, or on the CPU backend the host thunks that
    carry an `hlo_op`."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_xplane(trace_dir))
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        planes = [p for p in pd.planes if p.name == "/host:CPU"]
    out = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                out.append((int(ev.start_ns), int(ev.duration_ns), str(op),
                            str(stats.get("hlo_module", ""))))
    return out


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def time_by_scope(trace_dir: str, hlo_text: str, module: str, scopes) -> dict:
    """Device time of module `module` split by scope, over the trace.

    Kernels that XLA:GPU launches inside a CUDA graph are reported under
    the graph's thunk (`hlo_op` "command_buffer") and cannot be told
    apart; their time is `graph_ns` (part of `other_ns`). Trace with
    `XLA_FLAGS=--xla_gpu_enable_command_buffer=` for a full split.

    Returns {"scopes": {scope: ns}, "other_ns", "graph_ns", "module_ns"
    (summed kernel time of the module), "busy_ns" (union of all device
    events), "window_ns" (first start to last end), "idle_share"}."""
    owner = scope_of_instructions(hlo_text, scopes)
    evs = device_events(trace_dir)
    per = {s: 0 for s in scopes}
    other = graph = module_ns = 0
    for start, dur, op, mod in evs:
        if module not in mod:
            continue
        module_ns += dur
        sc = owner.get(op)
        if sc is None:
            other += dur
            graph += dur if op == "command_buffer" else 0
        else:
            per[sc] += dur
    iv = [(s, s + d) for s, d, _, _ in evs]
    busy = _union_ns(iv)
    window = (max(e for _, e in iv) - min(s for s, _ in iv)) if iv else 0
    return {
        "scopes": per,
        "other_ns": other,
        "graph_ns": graph,
        "module_ns": module_ns,
        "busy_ns": busy,
        "window_ns": window,
        "idle_share": 1.0 - busy / window if window else None,
    }
