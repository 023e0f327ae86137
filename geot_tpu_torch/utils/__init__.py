from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.utils.roofline import (
    hbm_bandwidth_gbps,
    roofline_fraction,
    sddmm_bytes,
    spmm_bytes,
)
from geot_tpu_torch.utils.timing import timeit
from geot_tpu_torch.utils.trace import setup_phase, setup_record, span

__all__ = ["resolve_device", "timeit", "spmm_bytes", "sddmm_bytes", "hbm_bandwidth_gbps",
           "roofline_fraction", "span", "setup_phase", "setup_record"]
