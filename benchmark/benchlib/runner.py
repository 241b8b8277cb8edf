"""One run of one cell on one chip: the driver, then the result line.

The harness drives cells of one chip; a cell of several chips (one
process per card, a process group over a free localhost port) comes with
the benchmark change that proves it on the cards (PERF.md, Open
questions).
"""
from __future__ import annotations

from . import cells, check, spec as spec_mod


def drive(payload: dict) -> dict:
    import torch
    dev = (torch.device("cuda", 0) if payload["device_type"] == "cuda"
           else torch.device("cpu"))
    driver = cells.DRIVERS[payload["mix"]["kind"]]
    part = driver(payload["conf"], payload["mix"], payload["seed"],
                  payload["seconds"], payload["trace"], dev)
    if dev.type == "cuda":
        part["kind"] = torch.cuda.get_device_name(dev)
    return part


def assemble(spec: dict, wl: dict, part: dict, trace: bool,
             t_start: float, bench_dir: str = spec_mod.BENCH_DIR) -> dict:
    """The result line of one run."""
    checks = part["checks"]
    ok = check.verdict(checks)
    metrics = {}
    if trace:
        obs = dict(part["obs"], device_kind=part.get("kind", "cpu"))
        for m in spec_mod.cell_metrics(spec, wl["name"], "per_layer"):
            v = spec_mod.metric_reader(m["name"], bench_dir)(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec_mod.cell_metrics(spec, wl["name"], "end_to_end"):
            v = (part["setup_end"] - t_start if m["name"] == "setup_s"
                 else part["e2e"][m["name"]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if "kind" in part else "cpu",
              "kind": part.get("kind", "cpu"), "count": 1,
              "memory_peak_bytes": part["device"].get("memory_peak_bytes",
                                                      0)}
    out = {"correct": ok, "attempted": part["outputs"],
           "failed": 0 if ok else max(1, checks.get("outputs_differ", 0)),
           "metrics": metrics, "device": device}
    if trace and "busy_s" in part["device"]:
        device["busy_s"] = part["device"]["busy_s"]
        device["window_s"] = part["device"]["window_s"]
        out["breakdown"] = part["breakdown"]
    out["checks"] = check.table(checks)
    return out


def run_cell(spec: dict, wl: dict, conf: dict, mix: dict, seed: int,
             seconds: float, trace: bool, t_start: float,
             device_type: str = "cuda") -> tuple:
    """(result line, modules of the JAX stack found loaded)."""
    if wl["chips"] != 1:
        raise ValueError(f"{wl['name']}: this harness drives one chip")
    payload = {"conf": conf, "mix": mix, "seed": seed, "seconds": seconds,
               "trace": trace, "device_type": device_type}
    part = drive(payload)
    jax = sorted(set(cells.forbidden_modules()) | set(part["jax"]))
    return assemble(spec, wl, part, trace, t_start), jax
