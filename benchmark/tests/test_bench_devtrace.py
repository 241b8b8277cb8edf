"""The reduction of a traced stretch, on made-up events (us)."""
import pytest

from benchconf import S  # noqa: F401
from benchlib import devtrace

DEV = [("repair_kernel", 10, 50), ("propose_kernel", 5, 9),
       ("Memset", 40, 45), ("repair_kernel", 70, 90)]
HOST = [("aten::where", 50, 60), ("aten::add", 55, 56),
        ("meg_repair", 60, 69)]


def test_sums_and_counts():
    assert devtrace.device_seconds(DEV, "repair") == pytest.approx(60e-6)
    assert devtrace.device_seconds(DEV) == pytest.approx(69e-6)
    assert devtrace.count(DEV) == 4 and devtrace.count(DEV, "repair") == 2


def test_busy_is_a_union():
    # [5,9] + [10,50] (the memset inside) + [70,90] = 4 + 40 + 20
    assert devtrace.busy_union_seconds(DEV) == pytest.approx(64e-6)


def test_top_ops():
    top = devtrace.top_ops(DEV, 2)
    assert [t[0] for t in top] == ["repair_kernel", "Memset"]
    assert top[0][1] == pytest.approx(60e-6)


def test_idle_gaps_by_host_activity():
    gaps = dict(devtrace.idle_gaps(DEV, HOST, 0, 100))
    # 0-5 nothing, 9-10 nothing, 50-70 split at its middle 60 -> meg_repair
    # owns [60,69]; 90-100 nothing
    assert gaps["meg_repair"] == pytest.approx(20e-6)
    assert gaps["host: between operations"] == pytest.approx(16e-6)


def test_busy_share_uses_the_unprofiled_wall_time():
    # 69 us of device work over 2 iterations, 50 us per iteration
    # unprofiled: 69 percent busy
    assert devtrace.busy_share(DEV, 2, 50e-6) == pytest.approx(0.69)


def test_device_annotations_are_no_operations():
    """cells._reduce keeps the device's operations only: not the device
    copies of host annotations (a harness span, the process group's
    "nccl:all_gather" range around its kernel)."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType
    from benchlib import cells

    def ev(name, t0, t1, dev, note=False):
        return NS(name=name, time_range=NS(start=t0, end=t1), thread=1,
                  device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                  is_user_annotation=note)
    prof = NS(events=lambda: [
        ev(cells.STRETCH, 0, 100, False),
        ev("nccl:all_gather", 10, 20, True, note=True),
        ev("ncclDevKernel_AllGather_RING_LL", 11, 19, True),
        ev(cells.SPAN + "emit", 30, 40, True),
        ev("repair_kernel", 40, 90, True)])
    red = cells._reduce(prof, 1e-4, "iterations", 1)
    assert [d[0] for d in red["dev"]] == ["ncclDevKernel_AllGather_RING_LL",
                                         "repair_kernel"]
    assert devtrace.device_seconds(red["dev"], "nccl") == pytest.approx(8e-6)
