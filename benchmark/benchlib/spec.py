"""BENCHMARK.json and the files it names, found by name.

A configuration is `configs/<name>.json`, a traffic mix
`traffic/<name>.json`, a per-layer metric `metrics/<name>.py` (a module
with `read(obs)`), all under the benchmark's folder.  Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
names any of them.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def by_name(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(name)


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, as run."""
    with open(os.path.join(root, by_name(spec["configs"], name)["file"])) as f:
        return json.load(f)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The traffic mix's data file."""
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as f:
        mix = json.load(f)
    mix.setdefault("name", name)
    return mix


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """`read(obs)` of metrics/<name>.py: the metric's value, or None where
    the run holds nothing for it to read."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The metric entries of one section ("end_to_end" or "per_layer")
    that this cell reports: those without a `workloads` key, and those
    whose key lists it."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def problems(spec: dict, root: str = ROOT) -> list:
    """What in `spec` breaks the rules this harness relies on (names,
    units, sources, files found by name); empty when it is sound."""
    out = []
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in spec["configs"]:
        if not NAME.match(c["name"]):
            out.append(f"config name {c['name']!r}")
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"reduced key {k!r}")
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"config file {c['file']} missing")
        names["configs"].add(c["name"])
    for w in spec["workloads"]:
        for key in ("name", "config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"workload {key} {w[key]!r}")
        if w["config"] not in names["configs"]:
            out.append(f"workload {w['name']} names no config")
        if not os.path.exists(os.path.join(
                root, "benchmark", "traffic", w["traffic"] + ".json")):
            out.append(f"traffic {w['traffic']} has no file")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} chips {w['chips']}")
        names["workloads"].add(w["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if not NAME.match(m["name"]) or m["name"] in names["metrics"]:
                out.append(f"metric name {m['name']!r}")
            names["metrics"].add(m["name"])
            if not UNIT.match(m["unit"]):
                out.append(f"unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"better {m['better']!r}")
            if m["source"] not in SOURCES or (
                    kind == "end_to_end"
                    and m["source"] not in ("host_clock", "device_trace")):
                out.append(f"source {m['source']!r} of {m['name']}")
            for w in m.get("workloads", []):
                if w not in names["workloads"]:
                    out.append(f"{m['name']} lists unknown cell {w}")
    for m in spec["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"{m['name']} moves unknown {m['moves']}")
            continue
        for w in m.get("workloads", sorted(names["workloads"])):
            if w not in moved.get("workloads", [w]):
                out.append(f"{m['name']} in {w}, which lacks {m['moves']}")
        if not os.path.exists(os.path.join(
                root, "benchmark", "metrics", m["name"] + ".py")):
            out.append(f"metric {m['name']} has no reader")
    for w in names["workloads"]:
        if not [m for m in cell_metrics(spec, w, "per_layer")]:
            out.append(f"cell {w} reports no per-layer metric")
        if len(cell_metrics(spec, w, "end_to_end")) < 2:
            out.append(f"cell {w} reports too few end-to-end metrics")
    return out
