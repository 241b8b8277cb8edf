"""What the scale runners (tools/run_*_torch.py) share: the recorded
1 MiB corpus's hash, the liblzma and gzip columns, and the end of a run
(write the output, print one JSON line, raise if it did not decode)."""
from __future__ import annotations

import gzip
import json
import lzma

import torch

# PERF_1MIB.json's corpus_sha256: the first 1 MiB of tools/corpus/libc.so
SHA256_1MIB = ("36432546d5f0133325d669fb760d58095df616e6"
               "e07bda5feb842490156b8db6")


def baselines(data: bytes) -> dict:
    """The sizes of `data` under liblzma's preset 9 | extreme (.lzma
    format) and gzip -9."""
    xz = lzma.compress(data, format=lzma.FORMAT_ALONE,
                       preset=9 | lzma.PRESET_EXTREME)
    return {"liblzma_9e_bytes": len(xz),
            "gzip9_bytes": len(gzip.compress(data, 9))}


def finish(out: dict, blob: bytes, path: str | None, device: str) -> dict:
    """Write `blob` to `path` (if given), add the device's name (and on
    the card the peak device memory) to `out`, print `out` as one JSON
    line and return it; raise if out["decode_ok"] is false."""
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    if device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    else:
        out["device"] = "cpu"
    print(json.dumps(out), flush=True)
    if not out["decode_ok"]:
        raise RuntimeError("the output does not decode to its input")
    return out
