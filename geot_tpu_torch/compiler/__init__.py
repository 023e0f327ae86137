from geot_tpu_torch.compiler.match_replace import count_matches, pattern_transform

__all__ = ["pattern_transform", "count_matches"]
