from geot_tpu_torch.ops import reference
from geot_tpu_torch.ops.api import (
    csr_gws,
    dispatch_path,
    gat_attention_spmm,
    gather_scatter,
    gather_weight_scatter,
    index_scatter,
    mh_spmm,
    mh_spmm_transposed,
    sddmm_coo,
    segment_counts,
    segment_softmax,
    segment_spmm,
)
from geot_tpu_torch.ops.bat_kernels import (
    bat_segment_sum,
    bat_segment_sum_packed,
    bat_segment_sum_plain,
    bucketed_sum,
    bucketed_sum_plain,
)
from geot_tpu_torch.ops.reference import (
    bat_segment_sum_packed_plain,
    plan_segment_sum_mh_plain,
    plan_segment_sum_packed2_plain,
    plan_segment_sum_pr_plain,
    plan_segment_sum_sr2_plain,
    plan_segment_sum_sr_packed_plain,
    plan_segment_sum_sr_plain,
)
from geot_tpu_torch.ops.sddmm_kernels import (
    edge_dots,
    edge_dots_plain,
    sddmm_bat,
    sddmm_bat_plain,
)
from geot_tpu_torch.ops.slot_kernels import (
    plan_segment_sum_mh,
    plan_segment_sum_packed2,
    plan_segment_sum_pr,
    plan_segment_sum_sr,
    plan_segment_sum_sr2,
    plan_segment_sum_sr_packed,
)
from geot_tpu_torch.ops.softmax_kernels import (
    edge_softmax,
    edge_softmax_grad,
    edge_softmax_grad_plain,
    edge_softmax_plain,
)
from geot_tpu_torch.ops.stream_kernels import (
    stream_segment_acc,
    stream_segment_acc_plain,
    stream_segment_sum,
    stream_segment_sum_plain,
)

# the kernel wrappers that count their launches (`<wrapper>.launches`, one
# a launch of the kernel and nowhere else; `bucketed_sum` counts under
# `bat_segment_sum`, the kernel it launches)
COUNTED_KERNELS = {
    f.__name__: f for f in (
        bat_segment_sum, bat_segment_sum_packed, sddmm_bat, edge_dots, stream_segment_sum,
        stream_segment_acc, plan_segment_sum_sr, plan_segment_sum_sr_packed,
        plan_segment_sum_pr, plan_segment_sum_mh, plan_segment_sum_sr2,
        plan_segment_sum_packed2, edge_softmax, edge_softmax_grad)
}


def launch_counts() -> dict:
    """{kernel: its launches so far in this process}, of every counted
    wrapper (`COUNTED_KERNELS`); the difference of two readings is what ran
    between them."""
    return {name: f.launches for name, f in COUNTED_KERNELS.items()}


__all__ = [
    "COUNTED_KERNELS",
    "launch_counts",
    "reference",
    "csr_gws",
    "dispatch_path",
    "segment_counts",
    "segment_spmm",
    "gather_scatter",
    "gather_weight_scatter",
    "index_scatter",
    "sddmm_coo",
    "mh_spmm",
    "mh_spmm_transposed",
    "segment_softmax",
    "gat_attention_spmm",
    "bat_segment_sum",
    "bat_segment_sum_plain",
    "bat_segment_sum_packed",
    "bat_segment_sum_packed_plain",
    "bucketed_sum",
    "bucketed_sum_plain",
    "sddmm_bat",
    "sddmm_bat_plain",
    "edge_dots",
    "edge_dots_plain",
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
    "plan_segment_sum_sr2",
    "plan_segment_sum_sr2_plain",
    "plan_segment_sum_packed2",
    "plan_segment_sum_packed2_plain",
    "plan_segment_sum_mh",
    "plan_segment_sum_mh_plain",
    "edge_softmax",
    "edge_softmax_plain",
    "edge_softmax_grad",
    "edge_softmax_grad_plain",
]
