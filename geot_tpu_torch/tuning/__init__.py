"""The port's tuning layer: knob selection from a measured table
(`heuristics`), the sweep that measures it (`sweep`), its report
(`report`) and the index augmentation the sweep can add (`augment`)."""

from geot_tpu_torch.tuning.heuristics import (
    KernelConfig,
    load_table,
    select_config,
    select_config_ex,
    table_fingerprint,
)

__all__ = ["KernelConfig", "select_config", "select_config_ex", "load_table",
           "table_fingerprint"]
