"""Device ms per profiled iteration of the collectives (device
operations whose name holds `nccl`: the capture position's all-reduce,
the best's all-gather, the best parse's broadcast when it improves) on
rank 0's card.  An NCCL kernel runs from its launch until every rank of
the group has joined, so its time holds the wait for the slowest rank
as well as the exchange itself."""
from benchlib import devtrace


def read(obs):
    prof = obs.get("profile")
    if not prof or prof["scope"] != "iterations" or not prof["iters"]:
        return None
    if not devtrace.count(prof["dev"], "nccl"):
        return None
    return devtrace.device_seconds(prof["dev"], "nccl") * 1e3 \
        / prof["iters"]
