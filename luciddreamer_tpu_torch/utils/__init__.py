from luciddreamer_tpu_torch.utils.profiling import PhaseTimer, trace_to
from luciddreamer_tpu_torch.utils.visibility import mark_visible

__all__ = ["PhaseTimer", "trace_to", "mark_visible"]
