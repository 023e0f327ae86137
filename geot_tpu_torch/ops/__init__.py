from geot_tpu_torch.ops.api import (
    dispatch_path,
    gather_scatter,
    gather_weight_scatter,
    index_scatter,
    sddmm_coo,
    segment_counts,
    segment_spmm,
)
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain
from geot_tpu_torch.ops.reference import (
    plan_segment_sum_pr_plain,
    plan_segment_sum_sr_packed_plain,
    plan_segment_sum_sr_plain,
)
from geot_tpu_torch.ops.sddmm_kernels import sddmm_bat, sddmm_bat_plain
from geot_tpu_torch.ops.slot_kernels import (
    plan_segment_sum_pr,
    plan_segment_sum_sr,
    plan_segment_sum_sr_packed,
)
from geot_tpu_torch.ops.stream_kernels import (
    stream_segment_acc,
    stream_segment_acc_plain,
    stream_segment_sum,
    stream_segment_sum_plain,
)

__all__ = [
    "dispatch_path",
    "segment_counts",
    "segment_spmm",
    "gather_scatter",
    "gather_weight_scatter",
    "index_scatter",
    "sddmm_coo",
    "bat_segment_sum",
    "bat_segment_sum_plain",
    "sddmm_bat",
    "sddmm_bat_plain",
    "stream_segment_acc",
    "stream_segment_acc_plain",
    "stream_segment_sum",
    "stream_segment_sum_plain",
    "plan_segment_sum_sr",
    "plan_segment_sum_sr_plain",
    "plan_segment_sum_sr_packed",
    "plan_segment_sum_sr_packed_plain",
    "plan_segment_sum_pr",
    "plan_segment_sum_pr_plain",
]
