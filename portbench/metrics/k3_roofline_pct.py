"""k3_roofline_pct: K3 over the probed lists (ops/adc_scan.py ->
csrc/adc_scan.cu ``adc_scan_lists_kernel``): the least time of the
sub-window's scans (roofline.py) over K3's summed profiler time there."""

from portbench import readings


def read(ctx):
    return readings.roofline_pct(ctx, "K3", "adc_scan_lists_kernel", "adc_scan_lists")
