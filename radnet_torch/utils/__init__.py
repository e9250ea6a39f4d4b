"""Cross-cutting utilities: profiling."""

from radnet_torch.utils.profiling import Timer, profile_trace, stage_timer

__all__ = ["Timer", "profile_trace", "stage_timer"]
