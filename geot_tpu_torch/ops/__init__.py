from geot_tpu_torch.ops.api import dispatch_path, segment_counts, segment_spmm
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain

__all__ = [
    "dispatch_path",
    "segment_counts",
    "segment_spmm",
    "bat_segment_sum",
    "bat_segment_sum_plain",
]
