"""k1_roofline_pct: K1 (ops/flat_scan.py -> csrc/flat_scan.cu): the least
time of the sub-window's list scans (bytes over 3.35 TB/s, roofline.py)
over K1's summed profiler time there."""

from portbench import readings


def read(ctx):
    return readings.roofline_pct(ctx, "K1", "flat_scan_kernel", "flat_list_scan")
